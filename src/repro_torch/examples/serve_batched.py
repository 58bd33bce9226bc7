"""Batched serving with any ported arch at its reduced config: prefill +
greedy decode, then the GQA flash-decode kernel against its plain
version on the arch's attention geometry.  The port of the reference's
``examples/serve_batched.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      --arch mixtral-8x22b                       # the card
  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      --arch pixtral-12b --device cpu

Every arch runs: a VLM's prompt is its patch embeddings then
prompt-len − P tokens, an audio arch's its frame embeddings then
prompt-len tokens; an arch with no attention (rwkv6-3b) skips the
kernel check, as the reference does.  Weights come from a generator on
the device seeded 0, prompts and the kernel check's q/K/V from
``np.random.default_rng(0)``.  On the CPU the kernel check holds the
plain version against itself (0).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.backend import resolve_device, set_precision
from repro_torch.configs import get_config
from repro_torch.launch.serve import (decode_kernel_check, generate,
                                      kernel_check_line, make_batch)
from repro_torch.models import get_model


def serve_batched(api, params, rng, batch: int, prompt_len: int, gen: int,
                  device) -> dict:
    """Prefill a batch drawn from ``rng`` and decode ``gen`` tokens,
    then the decode kernel check on the next draws of ``rng``: the
    result of :func:`repro_torch.launch.serve.generate` with
    ``kernel_max_abs_err`` (None for an arch with no attention)."""
    res = generate(api, params,
                   make_batch(api.cfg, rng, batch, prompt_len, device), gen)
    res["kernel_max_abs_err"] = (
        decode_kernel_check(api.cfg, batch, rng, device)
        if api.cfg.num_heads else None)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_precision()
    cfg = get_config(args.arch).reduced()
    api = get_model(cfg)
    params = api.init(0, device=device)
    rng = np.random.default_rng(0)
    b, s = args.batch, args.prompt_len
    res = serve_batched(api, params, rng, b, s, args.gen, device)
    print(f"{cfg.name}: batch={b} prompt={s} -> {args.gen} tokens, "
          f"{res['decode_ms_per_token']:.1f} ms/token ({device.type}, "
          "reduced config)")
    print("sample:", res["tokens"][0][:12].tolist())
    print(kernel_check_line(cfg, res["kernel_max_abs_err"]))
    res.update(cfg=cfg, params=params)
    return res


if __name__ == "__main__":
    main()
