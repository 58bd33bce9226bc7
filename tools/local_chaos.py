"""How far paper-cnn's local training carries a rounding difference.

    python3 tools/local_chaos.py [--device cpu|cuda] [ALGO ...]

For each local update (default fedavg, fedprox, feddyn and moon, with
sgd) at the full width of ``chip_smoke.py``'s slice (50 clients, K = 5,
10,000 samples, 2 epochs of batch 32: 62 steps), one round-0 cohort
update in f32 and the same update in f64 from the same params, ids and
permutations, on one device.  Prints one JSON line per algorithm: the
train loss's relative difference, and for each leaf the largest
difference of the trained params over the leaf's largest magnitude and
over the leaf's largest move (trained minus initial), and the largest
difference over the largest magnitude of the whole tree.  This is the
yardstick for comparing a card's round with a CPU's: a difference of
this size is f32 rounding carried through the round's steps, not a
fault of either device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.fed import build  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + "/")
        else:
            yield prefix + k, v


def chaos(algo: str, device: str) -> dict:
    spec = dataclasses.replace(chip_smoke.SPEC,
                               local=chip_smoke._local(algo))
    f32 = build(spec, device=device)[0]
    rd = f32.draw_round(0)
    ids, _ = f32.selector.select(f32.state, 0, rd.select)
    p32, _, m32 = f32.local_update(0, ids, rd.perms)
    f64 = build(spec, device=device)[0]
    f64.params = tree_map(lambda a: a.double(), f32.params)
    f64.extras = tree_map(lambda a: a.double(), f32.extras)
    f64.x, f64.mask = f64.x.double(), f64.mask.double()
    p64, _, m64 = f64.local_update(0, ids, rd.perms)
    before = dict(_flat(f32.params))
    leaves, worst, scale = {}, 0.0, 0.0
    for (name, a), (_, b) in zip(_flat(p32), _flat(p64)):
        diff = float((a.double() - b).abs().max())
        move = float((b - before[name].double()).abs().max())
        size = float(b.abs().max())
        leaves[name] = {"of_magnitude": diff / size, "of_move": diff / move}
        worst, scale = max(worst, diff), max(scale, size)
    loss = float(((m32["train_loss"].double() - m64["train_loss"]).abs()
                  / m64["train_loss"].abs()).max())
    return {"algo": algo, "device": device, "steps": 62,
            "train_loss_rel_diff": loss, "of_tree_magnitude": worst / scale,
            "leaves": leaves}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("algos", nargs="*",
                    default=["fedavg", "fedprox", "feddyn", "moon"])
    args = ap.parse_args(argv)
    for algo in args.algos:
        print(json.dumps(chaos(algo, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
