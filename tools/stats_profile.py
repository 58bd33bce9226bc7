"""Where the stats kernels' time goes on the card (fused_stats and
hetero_entropy), and how it compares with another checkout's.

    python3 tools/stats_profile.py [--against DIR]

At each shape the selection and serving paths give these kernels
(64×151,936 f32 at T 0.63 and 0.0025 and under normalize; 2×151,936
f32 at T 0.01, the LM fine-tune's K-row refresh; the slice's 5×10
under normalize; hetero_entropy at 64×151,936 f32 and bf16), inputs
cycled past the 50 MB L2, prints one JSON line with the device time a
call spends in the card's kernels (``torch.profiler``'s CUDA spans
summed over the run and divided by the calls, so a caller's second
launch and its torch ops count), the spans a call, the split count P
and the bound share, and at 64×151,936 the device time at every P of
1, 2, 4 and 8.  With ``--against DIR`` (a checkout of another commit,
e.g. unpacked with ``git archive``) it then times the stats work of
that checkout and of this one at the same shapes, each through its own
entry points (under normalize: this checkout's one launch, or an older
one's two launches and the torch ops between them, as its selection
steps make them), each in a process of its own, in turns (other, this,
this, other), and prints one JSON line a turn.  Needs a CUDA device;
builds the kernels at first use.
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

import torch  # noqa: E402

#: (kernel, rows, columns, dtype, temperature, normalize)
SHAPES = (("fused_stats", 64, 151_936, "float32", 0.63, False),
          ("fused_stats", 64, 151_936, "float32", 0.0025, False),
          ("fused_stats", 64, 151_936, "float32", 0.63, True),
          ("fused_stats", 2, 151_936, "float32", 0.01, False),
          ("fused_stats", 5, 10, "float32", 0.63, True),
          ("hetero_entropy", 64, 151_936, "float32", 0.0025, False),
          ("hetero_entropy", 64, 151_936, "bfloat16", 0.0025, False))

#: one checkout's stats work at SHAPES through its own entry points,
#: timed by the same code in every checkout
TURN = """
import inspect, json, sys
sys.path.insert(0, 'src')
import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.fused_stats import fused_stats_rows as fsr
from repro_torch.kernels.hetero_entropy import entropy_rows
one_launch = 'normalize' in inspect.signature(fsr).parameters
d = torch.device('cuda', 0)

def stats_call(x, t, normalize):
    if one_launch:
        return fsr(x, t, normalize=normalize)
    n = x.shape[0]
    inv_t = torch.full((n,), 1.0 / t, dtype=torch.float32, device=d)
    ent, norm, rms = fsr(x, inv_t)
    if normalize:
        ent, _, _ = fsr(x, 1.0 / (torch.clamp(rms, min=1e-12) * t))
    return ent, norm, rms

out = []
for kern, n, c, dt, t, normalize in %r:
    g = torch.Generator(device=d).manual_seed(n + c)
    x = (torch.randn((n, c), generator=g, device=d) * 0.02).to(
        getattr(torch, dt))
    xs = [x] + [x.clone() for _ in range(
        int(np.ceil(60e6 / x.nbytes)) if x.nbytes > 1e6 else 0)]
    if kern == 'fused_stats':
        fns = [lambda xc=xc: stats_call(xc, t, normalize) for xc in xs]
    else:
        fns = [lambda xc=xc: entropy_rows(xc, t) for xc in xs]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    iters = 48
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for i in range(iters):
        fns[i %% len(fns)]()
    end.record()
    torch.cuda.synchronize()
    for _ in range(3):   # a window in which the profiler dropped all
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i %% len(fns)]()
            torch.cuda.synchronize()
        spans = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            break
    assert spans, 'torch.profiler recorded no CUDA span'
    out.append({'case': f'{kern}({n}x{c},{dt},T={t},normalize={normalize})',
                'ms': start.elapsed_time(end) / iters,
                'device_ms': sum(spans) / iters / 1e3,
                'spans_per_call': len(spans) / iters})
    del x, xs, fns
    torch.cuda.empty_cache()
print(json.dumps(out))
""" % (SHAPES,)


def device_ms_per_call(fns, iters: int = 48):
    """(device ms a call, spans a call): every CUDA span the profiler
    recorded over ``iters`` calls cycling through ``fns``
    (``chip_smoke.cuda_spans``), summed and divided by the calls."""
    import chip_smoke as cs
    spans = [us for _, us in cs.cuda_spans(fns, iters)]
    if not spans:
        raise SystemExit("torch.profiler recorded no CUDA span")
    return sum(spans) / iters / 1e3, len(spans) / iters


def breakdown(dev) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.fused_stats import fused_stats_rows, stats_splits
    from repro_torch.kernels.hetero_entropy import entropy_rows
    sms = build.sm_count(dev.index)
    for kern, n, c, dt_name, t, normalize in SHAPES:
        dt = getattr(torch, dt_name)
        gen = torch.Generator(device=dev).manual_seed(n + c)
        x = (torch.randn((n, c), generator=gen, device=dev) * 0.02).to(dt)
        xs = [x] + [x.clone() for _ in range(
            -(-int(60e6) // x.nbytes) if x.nbytes > 1e6 else 0)]
        elt = x.element_size()
        if kern == "fused_stats":
            def call(xc, p=None):
                return fused_stats_rows(xc, t, normalize=normalize,
                                        splits=p)
            want = ref.fused_stats_split_ref(x, t, stats_splits(n, c, sms),
                                             normalize=normalize)[0]
            nbytes, flops = elt * n * c + 12 * n, 8 * n * c
        else:
            def call(xc, p=None):
                return (entropy_rows(xc, t, p),)
            want = ref.entropy_split_ref(x, t, stats_splits(n, c, sms))
            nbytes, flops = elt * n * c + 4 * n, 6 * n * c
        err = cs.check(f"{kern} {n}x{c} {dt_name}", call(x)[0], want,
                       1e-3 if t < 0.01 else 5e-5)
        bound_ms, bound_by = cs.bound(nbytes, flops)
        ms, spans = device_ms_per_call([lambda xc=xc: call(xc) for xc in xs])
        line = {"shape": f"{kern} {n}x{c} {dt_name} T={t}"
                         f"{' normalize' if normalize else ''}",
                "splits": stats_splits(n, c, sms), "device_ms": ms,
                "spans_per_call": spans, "bound_ms": bound_ms,
                "bound_by": bound_by, "bound_share": bound_ms / ms,
                "max_abs_err": err}
        if c > 100_000 and n == 64:
            line["device_ms_by_splits"] = {
                p: device_ms_per_call([lambda xc=xc, p=p: call(xc, p)
                                       for xc in xs])[0]
                for p in (1, 2, 4, 8)}
        print(json.dumps(line), flush=True)
        del x, xs
        torch.cuda.empty_cache()
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
        print("stats_profile: no CUDA device", file=sys.stderr)
        return 2
    breakdown(torch.device("cuda", 0))
    if args.against is not None:
        turns(args.against.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
