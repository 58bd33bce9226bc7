"""Where the strip kernel's time goes on the card, and how it compares
with another checkout's.

    python3 tools/strip_profile.py [--against DIR]

At the baselines' shape (K5×N50×F158,570, x cycled past the 50 MB L2),
for f32 and bf16 operands and several slice counts S, prints one JSON
line each with the device time a call spends in the strip kernel and
in the merge pass (``torch.profiler``'s CUDA spans) and the idle gap
between them, every case held against its plain version.  With
``--against DIR`` (a checkout of another commit, e.g. unpacked with
``git archive``), then times ``chip_smoke.feature_strip_case`` of that
checkout and of this one at the same shape, each in a process of its
own, in turns (other, this, this, other), and prints one JSON line a
turn.  Needs a CUDA device; builds the kernels at first use.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K, N, C = 5, 50, 158_570
SPLITS = (33, 66, 99, 132)
#: one process of a checkout: its chip_smoke's timed cosine and l2 cases
TURN = ("import sys, json; sys.path.insert(0, '.'); import chip_smoke as cs, "
        "torch; d = torch.device('cuda', 0); print(json.dumps([{k: c.get(k) "
        "for k in ('case', 'ms', 'device_ms', 'splits', 'cdist_ms')} for c in "
        "(cs.feature_strip_case(%d, %d, %d, e, d, timed=True) for e in "
        "('cosine', 'l2'))]))" % (K, N, C))


def breakdown(dev) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.gram_update import gram_strip
    x = cs.rows(N, C, seed=1, dev=dev)
    norms = torch.linalg.vector_norm(x, dim=-1)
    stats = torch.stack([norms, torch.zeros_like(norms)], -1).contiguous()
    ids = torch.arange(0, N, N // K, device=dev)[:K]
    ids32, s_r = ids.to(torch.int32), stats[ids].contiguous()
    copies = [(xc, xc[ids].contiguous())
              for xc in [x] + [x.clone() for _ in range(2)]]
    for bf16 in (False, True):
        want = ref.distance_strip_ref(x, stats, ids, 0.0, epilogue="cosine",
                                      gram_in_bf16=bf16)
        for splits in SPLITS:
            fns = [lambda xc=xc, rc=rc: gram_strip(
                rc, xc, s_r, stats, ids32, 0.0, epilogue="cosine",
                gram_in_bf16=bf16, splits=splits) for xc, rc in copies]
            err = cs.check(f"strip S={splits} bf16={bf16}", fns[0](), want,
                           1e-5, 1e-5)
            for fn in fns:
                fn()
            torch.cuda.synchronize()
            iters = 30
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for i in range(iters):
                    fns[i % len(fns)]()
                torch.cuda.synchronize()
            spans = sorted(
                (e.time_range.start, e.time_range.end,
                 "merge" if "merge" in e.name else "strip")
                for e in prof.events() if e.device_type == DeviceType.CUDA)
            by_kernel: dict = {}
            for start, end, name in spans:
                by_kernel[name] = by_kernel.get(name, 0.0) + (end - start)
            gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])
                    if (a[2], b[2]) == ("strip", "merge")]
            print(json.dumps({
                "shape": f"K{K}xN{N}xF{C}", "bf16": bf16, "splits": splits,
                "blocks": -(-N // 16) * -(-K // 8) * splits,
                "device_us_per_call": {k: v / iters
                                       for k, v in by_kernel.items()},
                "strip_to_merge_gap_us": float(np.median(gaps)),
                "max_abs_err": err}), flush=True)
    if cs.failures:
        raise SystemExit("FAILED: " + "; ".join(cs.failures))


def turns(other: Path) -> None:
    for who, cwd in (("other", other), ("this", ROOT), ("this", ROOT),
                     ("other", other)):
        out = subprocess.run([sys.executable, "-c", TURN], cwd=cwd,
                             capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise SystemExit(f"turn in {cwd} failed:\n{out.stderr[-2000:]}")
        print(json.dumps({"turn": who, "checkout": str(cwd),
                          "cases": json.loads(out.stdout.strip()
                                              .splitlines()[-1])}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout to time in turns with this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("strip_profile: no CUDA device", file=sys.stderr)
        return 2
    breakdown(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    if args.against is not None:
        turns(args.against.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
