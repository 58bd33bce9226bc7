"""The reference's multi-host entry point, in its ``--local`` mode: one
process on one card.

The reference's ``launch/multihost.py`` runs one process a TPU host
over a 256- or 512-chip mesh.  The port runs on one card, so only the
reference's single-host smoke mode is here, on the card unless
``--device cpu``:

  PYTHONPATH=src python -m repro_torch.launch.multihost --local \\
      --task train --arch qwen3-8b --steps 2
  PYTHONPATH=src python -m repro_torch.launch.multihost --local \\
      --task dryrun --arch qwen3-8b --shape train_4k

``--task train`` runs ``--steps`` bf16 train steps (adam 1e-4, the
global-norm clip) of the arch's reduced config on a batch of 2 × 64
tokens; ``--task dryrun`` prints the one-card dry run's record of the
reduced config at ``--shape`` (``launch/dryrun.py``).  Without
``--local`` it raises ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.steps import make_init_state, make_train_step
from repro_torch.models import get_model
from repro_torch.optim import adam


def train(cfg, steps: int, device, batch: int = 2, seq: int = 64) -> list:
    """``steps`` bf16 train steps of ``cfg`` on one fixed batch of
    random tokens; returns each step's metrics as floats."""
    dev = resolve_device(device)
    api = get_model(cfg)
    opt = adam(1e-4)
    state = make_init_state(api, opt)(0, device=dev)
    step = make_train_step(api, opt, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)

    def ints():
        return torch.tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                            dtype=torch.int32, device=dev)

    data = {"tokens": ints(), "targets": ints(),
            "loss_mask": torch.ones((batch, seq), device=dev)}
    out = []
    for i in range(steps):
        state, metrics = step(state, data)
        out.append({k: float(v) for k, v in metrics.items()})
        print(f"step {i}: loss={out[-1]['ce_loss']:.4f}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["train", "dryrun"], default="dryrun",
                    help="train or dryrun; serving runs through "
                    "repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local", action="store_true",
                    help="single-host mode: the only one the port runs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.local:
        raise NotImplementedError(
            "the port runs on one card: multi-host meshes, "
            "jax.distributed and the production sharding policies are not "
            "ported; pass --local")
    cfg = get_config(args.arch).reduced()
    dev = resolve_device(args.device)
    print(f"[host 0/1] 1 local / 1 global device ({dev})", flush=True)
    if args.task == "dryrun":
        from repro_torch.launch.dryrun import run_combo
        rec = run_combo(args.arch, args.shape, cfg=cfg)
        print(json.dumps(rec), flush=True)
        return rec
    return train(cfg, args.steps, dev)


if __name__ == "__main__":
    main()
