"""The reference's multi-host entry point: one process a card over the
production mesh, or ``--local`` on one card.

Every process runs this same module under ``torchrun``, which sets the
rendezvous (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``);
``torch.distributed`` starts from it (NCCL on ``cuda``, gloo on
``cpu``), the mesh is the production one (``launch/mesh.py``: 16×16,
or 2×16×16 with ``--multi-pod``) and the steps run under ``--policy``
(``sharding.py``) on DTensor state, as the dry run counts them:

  torchrun --nnodes 32 --nproc-per-node 8 ... -m \\
      repro_torch.launch.multihost --task train --arch qwen3-8b \\
      --shape train_4k --policy fsdp [--multi-pod]

``--task train`` runs ``--steps`` bf16 train steps (adam 1e-4, the
global-norm clip) of the full config at the shape's batch and length;
a world that is not the mesh's size raises, naming both.  ``--task
dryrun`` needs no rendezvous: it starts a fake world of the mesh's size
in this process (``planning_world``) and prints the mesh dry run's
record of the full config (``launch/dryrun.py``).

``--local`` is one process on one card, on the card unless ``--device
cpu``, with the arch's reduced config:

  PYTHONPATH=src python -m repro_torch.launch.multihost --local \\
      --task train --arch qwen3-8b --steps 2
  PYTHONPATH=src python -m repro_torch.launch.multihost --local \\
      --task dryrun --arch qwen3-8b --shape train_4k

where ``--task train`` takes a batch of 2 × 64 tokens and ``--task
dryrun`` prints the one-card dry run's record at ``--shape``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import sharding
from repro_torch.backend import resolve_device
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as meshes
from repro_torch.launch.steps import (make_init_state, make_train_step,
                                      shard_batch, shard_state)
from repro_torch.models import get_model
from repro_torch.optim import adam


def train(cfg, steps: int, device, batch: int = 2, seq: int = 64,
          policy=None) -> list:
    """``steps`` bf16 train steps of ``cfg`` on one fixed batch of
    random tokens (the same on every rank); under ``policy`` on DTensor
    state and batch.  Returns each step's metrics as floats."""
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
    if policy is not None:
        state, data = shard_state(state, policy), shard_batch(data, policy)
    out = []
    with sharding.use_policy(policy):
        for i in range(steps):
            state, metrics = step(state, data)
            out.append({k: float(v) for k, v in metrics.items()})
            if policy is None or dist.get_rank() == 0:
                print(f"step {i}: loss={out[-1]['ce_loss']:.4f}", flush=True)
    return out


def _meshed(args):
    """The run on the production mesh: a fake world for the dry run, the
    torchrun world for training."""
    mesh_name = "pod2" if args.multi_pod else "pod1"
    n = meshes.mesh_size(args.multi_pod)
    if args.task == "dryrun":
        from repro_torch.launch.dryrun import run_mesh_combo
        with meshes.planning_world(n):
            print(f"[host 0/1] planning: {n} ranks on the fake backend",
                  flush=True)
            rec = run_mesh_combo(args.arch, args.shape, mesh_name,
                                 args.policy)
        print(json.dumps(rec), flush=True)
        return rec
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        print(f"[host {dist.get_rank()}/{dist.get_world_size()}] {dev}",
              flush=True)
        mesh = meshes.make_production_mesh(multi_pod=args.multi_pod,
                                           device_type=dev.type)
        policy = sharding.ShardingPolicy(mesh, args.policy)
        shape = SHAPES[args.shape]
        return train(get_config(args.arch), args.steps, dev,
                     shape.global_batch, shape.seq_len, policy)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["train", "dryrun"], default="dryrun",
                    help="train or dryrun; serving runs through "
                    "repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--policy", default="2d", choices=["2d", "fsdp"])
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh (512 ranks); 16x16 without")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local", action="store_true",
                    help="one process on one card, the reduced config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not args.local:
        return _meshed(args)
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
