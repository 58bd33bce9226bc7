"""Multi-seed, multi-scenario sweep driver: the batched-evaluation
entry point over ``repro_torch.scenarios``, the port of the reference's
``launch/sweep.py``.

Crosses scenarios × selectors, runs the seeds of every cell as one CUDA
graph a round (``scenarios.run_sweep``), and writes:

  * ``--out``       full results: per-seed and mean ± std accuracy and
                    entropy trajectories per (scenario, selector) cell;
  * ``--bench``     ``BENCH_torch_sweep.json`` by default: the sweep
                    against one seed at a time (and, with ``--host``,
                    the ``FederatedServer`` host loop), seconds a cell
                    (``scenarios.bench_sweep``);
  * ``--telemetry`` the selection, training and fairness metric groups
                    of every seed and round, as JSONL.

The entry points run on the card unless ``--device cpu``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.sweep --quick
  PYTHONPATH=src python -m repro_torch.launch.sweep \\
      --scenarios mixed_80_20 dir_severe shards2 --selectors hics random \\
      --seeds 8 --rounds 40 --out SWEEP.json --bench BENCH_torch_sweep.json
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from repro_torch.data import SyntheticSpec
from repro_torch.fed import LocalSpec
from repro_torch.scenarios import SCENARIOS, SweepSpec, bench_sweep, run_sweep


def _sanitize(obj):
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def specs(args, groups=()):
    """(the sweep's spec, the bench's spec) of the parsed flags."""
    if args.quick:
        quick = dict(
            scenarios=("mixed_80_20", "dir_mild"),
            selectors=("hics", "random"),
            num_clients=10, num_select=3, rounds=6,
            samples_train=400, samples_test=120,
            data=SyntheticSpec(dim=16, rank=2, noise=0.5),
            local=LocalSpec(algo="fedavg", optimizer="sgd", lr=0.1,
                            epochs=1, batch_size=32))
        return (SweepSpec(seeds=(0, 1), telemetry=groups, **quick),
                SweepSpec(seeds=(0, 1, 2, 3), **quick))
    spec = SweepSpec(
        scenarios=tuple(args.scenarios), selectors=tuple(args.selectors),
        seeds=tuple(range(args.seeds)),
        num_clients=args.clients, num_select=args.select,
        rounds=args.rounds, samples_train=args.samples,
        samples_test=max(64, args.samples // 5), cap=args.cap or None,
        data=SyntheticSpec(dim=args.dim, noise=0.5),
        local=LocalSpec(algo="fedavg", optimizer="sgd", lr=args.lr,
                        epochs=args.epochs, batch_size=32),
        telemetry=groups)
    return spec, spec


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenarios", nargs="+",
                    default=["mixed_80_20", "dir_mild"],
                    choices=sorted(SCENARIOS))
    ap.add_argument("--selectors", nargs="+", default=["hics", "random"])
    ap.add_argument("--seeds", type=int, default=4,
                    help="number of seeds (0..n-1)")
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--select", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--cap", type=int, default=0,
                    help="per-client capacity (0 → 4·S/N)")
    ap.add_argument("--dim", type=int, default=64,
                    help="synthetic feature dim")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="CI preset: 2 seeds × 2 scenarios × 2 selectors"
                         ", 6 rounds")
    ap.add_argument("--host", action="store_true",
                    help="also time the FederatedServer host loop")
    ap.add_argument("--telemetry", default="",
                    help="write per-round telemetry to this JSONL path "
                         "(the selection/training/fairness metric groups)")
    ap.add_argument("--out", default="")
    ap.add_argument("--bench", default="BENCH_torch_sweep.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    groups = ("selection", "training", "fairness") if args.telemetry else ()
    spec, bench_spec = specs(args, groups)

    print(f"== sweep: {len(spec.scenarios)} scenarios × "
          f"{len(spec.selectors)} selectors × {len(spec.seeds)} seeds "
          f"(one graph a round) ==", flush=True)
    res = run_sweep(spec, progress=True, device=args.device)
    if args.telemetry:
        from repro_torch.telemetry import write_sweep
        cells = {name: cell["telemetry"]
                 for name, cell in res["grid"].items()}
        write_sweep(args.telemetry, cells,
                    meta={"driver": "launch.sweep",
                          "groups": list(groups),
                          "rounds": spec.rounds,
                          "seeds": list(spec.seeds)})
        print(f"wrote telemetry {args.telemetry}", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(_sanitize(res), indent=1))
        print(f"wrote {args.out}", flush=True)

    print(f"== bench: the sweep vs one seed at a time on "
          f"{len(bench_spec.seeds)} seeds ==", flush=True)
    bench = bench_sweep(bench_spec, include_host=args.host or args.quick,
                        device=args.device)
    if args.bench:
        Path(args.bench).write_text(json.dumps(_sanitize(bench), indent=1))
        print(f"wrote {args.bench}", flush=True)
    return res, bench


if __name__ == "__main__":
    main()
