"""Batched serving entry point: prefill a batch of prompts, then greedy-decode
against the bf16 KV cache; afterwards hold the GQA flash-decode kernel
against its plain version on the arch's attention geometry, as the
reference's serve example does.

Usage (flags as the reference's ``repro.launch.serve``, plus --device):
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --batch 4 --prompt-len 32 --gen 16          # reduced config, CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --full   # the card

The default device is ``cuda``: without a card it raises.  Weights come
from a generator on the device seeded by --seed; prompts from numpy's
``default_rng(seed)``, as in the reference.  A VLM's prompt is its
``num_patches`` patch embeddings then prompt-len − P tokens; an audio
(encoder-decoder) arch's is min(max_source_frames, prompt-len) frame
embeddings then prompt-len tokens.  rwkv6-3b has no attention: no
decode kernel check runs for it, and the driver says so.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.backend import resolve_device, set_precision
from repro_torch.configs import get_config
from repro_torch.kernels import gqa_decode_attention
from repro_torch.kernels.ref import decode_attention_ref
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import get_model

KERNEL_CHECK_S = 512      # cache length of the kernel check


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_batch(cfg, rng, batch: int, prompt_len: int, device) -> dict:
    """A prompt batch as the reference's serve driver draws it from
    ``rng``: tokens (B, S); for a VLM patch embeddings (B, P,
    patch_embed_dim) then tokens (B, S − P); for an audio arch frame
    embeddings (B, min(max_source_frames, S), d_model) then tokens
    (B, S)."""
    def ints(*shape):
        return torch.tensor(rng.integers(0, cfg.vocab_size, shape),
                            dtype=torch.int32, device=device)

    if cfg.kind == "vlm":
        p = cfg.vlm.num_patches
        patches = torch.tensor(
            rng.normal(size=(batch, p, cfg.vlm.patch_embed_dim)),
            dtype=torch.float32, device=device)
        return {"patches": patches, "tokens": ints(batch, prompt_len - p)}
    if cfg.kind == "audio":
        f = min(cfg.encdec.max_source_frames, prompt_len)
        frames = torch.tensor(rng.normal(size=(batch, f, cfg.d_model)),
                              dtype=torch.float32, device=device)
        return {"frames": frames, "tokens": ints(batch, prompt_len)}
    return {"tokens": ints(batch, prompt_len)}


def generate(api, params, batch: dict, gen: int) -> dict:
    """Prefill ``batch`` ({'tokens': (B, S)}, a VLM's with 'patches',
    an audio arch's with 'frames') and decode greedily to ``gen`` tokens
    a request.  Returns the tokens (B, gen), the cache, its valid length
    (the positions decoded so far) and host-clock times that end in a
    device synchronize."""
    dev = batch["tokens"].device
    prefill = make_prefill_step(api, dtype=torch.float32, cache_extra=gen)
    serve = make_serve_step(api, dtype=torch.float32)
    _sync(dev)
    t0 = time.perf_counter()
    token, cache = prefill(params, batch)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out = [token]
    # the prompt's positions: P + S (S for a recurrent cache, which has
    # no sequence axis)
    pos = (cache["k"].shape[2] - gen if "k" in cache
           else batch["tokens"].shape[1])
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        token, cache = serve(params, cache, {"token": token, "pos": pos})
        out.append(token)
        pos += 1
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "cache": cache, "length": pos,
            "prefill_ms": t_prefill * 1e3,
            "decode_ms_per_token": t_decode / max(1, gen - 1) * 1e3}


def decode_kernel_check(cfg, batch: int, rng, device) -> float:
    """The flash-decode kernel (the plain version on the CPU) against
    the plain version on random q/K/V of the arch's GQA geometry;
    returns the max abs difference.  An arch with no attention heads
    (rwkv6-3b) has no geometry to check: ``ValueError``."""
    if not cfg.num_heads:
        raise ValueError(f"{cfg.name} has no attention heads: no decode "
                         "kernel geometry to check")
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    s = KERNEL_CHECK_S

    def normal(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)

    q, k, v = normal(batch, h, dh), normal(batch, s, kv, dh), \
        normal(batch, s, kv, dh)
    got = gqa_decode_attention(q, k, v, s, device=device)
    want = decode_attention_ref(q, k, v, s)
    return float((got - want).abs().max())


def kernel_check_line(cfg, err) -> str:
    """The drivers' report of the decode kernel check (None: skipped,
    the arch has no attention)."""
    if err is None:
        return (f"flash-decode kernel: not checked ({cfg.name} has no "
                "attention heads)")
    return (f"flash-decode kernel (H={cfg.num_heads} KV={cfg.num_kv_heads} "
            f"dh={cfg.resolved_head_dim()} S={KERNEL_CHECK_S}): max|Δ| vs "
            f"plain = {err:.2e}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_precision()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    params = api.init(args.seed, device=device)
    _sync(device)
    init_s = time.perf_counter() - t0

    b, s = args.batch, args.prompt_len
    res = generate(api, params, make_batch(cfg, rng, b, s, device),
                   args.gen)
    res.update(cfg=cfg, params=params, init_s=init_s,
               kernel_max_abs_err=(decode_kernel_check(cfg, b, rng, device)
                                   if cfg.num_heads else None))
    dev_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu")
    print(f"arch={cfg.name} batch={b} prompt={s} gen={args.gen} "
          f"device={dev_name}")
    print(f"prefill: {res['prefill_ms']:.1f} ms   "
          f"decode: {res['decode_ms_per_token']:.1f} ms/token")
    print("generated token ids (first request):",
          res["tokens"][0][:16].tolist())
    print(kernel_check_line(cfg, res["kernel_max_abs_err"]))
    return res


if __name__ == "__main__":
    main()
