"""Where the pairwise kernel's time goes on the card, and how it
compares with another checkout's.

    python3 tools/pairwise_profile.py [--against DIR]

At the reference's full-size ``bench_kernels`` shape (N 256, C 151,936),
its ``incremental_vs_full`` shape (N 512, C 1024) and the HiCS slice's
(N 50, C 10), for f32 and bf16
operands and several slice counts S (the plan's among them), prints one
JSON line each with the device time a call spends in the kernel
(``torch.profiler``'s CUDA spans; the slices' merge runs inside the
same launch), its bound and bound share, and ``x @ x.T``'s device time
on the same x (cuBLAS SGEMM with TF32 off, or its bf16 GEMM on the
rounded operands: both halves of the products, a yardstick and not the
same function), every case held against the plain version of its
split (``ref.pairwise_split_ref``); at 256×151,936 also the SM clock
and power that ``nvidia-smi`` reads while the kernel runs back to
back.  With ``--against DIR`` (a
checkout of another commit, e.g. unpacked with ``git archive``), then
times each checkout's ``pairwise`` wrapper at the same shapes and
modes, each in a process of its own, in turns (other, this, this,
other), and prints one JSON line a turn.  Needs a CUDA device; builds
the kernels at first use.
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

#: (N, C, the slice counts S timed besides the plan's)
SHAPES = ((256, 151_936, (13, 26, 52)), (512, 1024, (1, 4, 11)),
          (50, 10, ()))
#: one process of a checkout: its pairwise wrapper at every shape and
#: mode, timed by events (back-to-back calls), by the profiler, and on
#: the host's clock for the enqueue alone (calls without a synchronize)
TURN = """
import json, sys, time
sys.path.insert(0, 'src'); sys.path.insert(0, '.')
import torch
import chip_smoke as cs
from repro_torch.kernels.pairwise import pairwise
d = torch.device('cuda', 0)
out = []
for n, c in %r:
    x = cs.rows(n, c, seed=1, dev=d)
    stats = cs.stats_of(x, cs.T_SLICE, True).contiguous()
    for bf16 in (False, True):
        fn = lambda: pairwise(x, stats, cs.LAM, gram_in_bf16=bf16)
        calls = 20 if c > 100_000 else 200
        ms = cs.time_ms(fn, calls)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        out.append({'shape': f'{n}x{n}x{c}', 'bf16': bf16, 'ms': ms,
                    'host_us': host_us, 'device_ms': cs.device_ms([fn])})
print(json.dumps(out))
""" % ([(n, c) for n, c, _ in SHAPES],)


def clocks_while(fn, seconds: float = 1.0) -> dict:
    """Median SM clock (MHz), its maximum and the power draw (W) that
    ``nvidia-smi`` samples every 100 ms while ``fn`` runs back to back
    for ``seconds``."""
    import time
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    rows = [[float(v) for v in ln.split(",")] for ln in out.splitlines()
            if ln.strip()]
    if not rows:
        return {}
    mid = len(rows) // 2
    col = [sorted(r[k] for r in rows) for k in range(3)]
    return {"sm_clock_mhz": col[0][mid], "max_sm_clock_mhz": col[1][mid],
            "power_w": col[2][mid], "samples": len(rows)}


def short(name: str) -> str:
    """A kernel's name without its return type, namespace and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "").split("(")[0]
    return name[5:] if name.startswith("void ") else name


def breakdown(dev) -> None:
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.pairwise import pairwise, pairwise_plan
    sms = build.sm_count(dev.index or 0)
    for n, c, others in SHAPES:
        x = cs.rows(n, c, seed=1, dev=dev)
        stats = cs.stats_of(x, cs.T_SLICE, True).contiguous()
        plan = pairwise_plan(n, c, sms)
        pairs = n * (n - 1) // 2
        for bf16 in (False, True):
            xo = ref.gram_operand(x, bf16)
            xg = xo.bfloat16() if bf16 else xo
            gemm_ms = cs.device_ms([lambda: xg @ xg.T])
            for splits in sorted({plan.splits, *others}):
                fn = lambda sp=splits: pairwise(x, stats, cs.LAM,  # noqa
                                                gram_in_bf16=bf16, splits=sp)
                want = ref.pairwise_split_ref(x, stats, cs.LAM, splits, bf16)
                got = fn()
                err = cs.check(f"pairwise {n}x{c} S={splits} bf16={bf16}",
                               got, want, 1e-5, 1e-5)
                cs.require(f"pairwise {n}x{c} S={splits}: not symmetric",
                           bool(torch.equal(got, got.T)))
                spans: dict = {}
                for name, us in cs.cuda_spans([fn], 20):
                    spans.setdefault(name, []).append(us)
                per_call = {short(name): sum(t) / len(t) / 1e3
                            for name, t in spans.items()}
                device = sum(per_call.values())
                bound_ms, bound_by = cs.bound(
                    4 * (n * c + 2 * n + n * n), 2 * c * pairs + 10 * pairs,
                    build.OPERANDS[bf16])
                clocks = (clocks_while(fn) if c > 100_000 and
                          splits == plan.splits else None)
                print(json.dumps({
                    "shape": f"{n}x{n}x{c}", "bf16": bf16, "splits": splits,
                    "clocks": clocks,
                    "plan": splits == plan.splits,
                    "blocks": len(plan.tiles) * splits,
                    "device_ms_by_kernel": per_call, "device_ms": device,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "bound_share": bound_ms / device if device else None,
                    "gemm_device_ms": gemm_ms, "max_abs_err": err}),
                    flush=True)
        del x, stats
        torch.cuda.empty_cache()
    if cs.failures:
        raise SystemExit("FAILED: " + "; ".join(cs.failures))


def turns(other: Path) -> None:
    for who, cwd in (("other", other), ("this", ROOT), ("this", ROOT),
                     ("other", other)):
        out = subprocess.run([sys.executable, "-c", TURN], cwd=cwd,
                             capture_output=True, text=True, timeout=900)
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
        print("pairwise_profile: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.backend import set_precision
    set_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    breakdown(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    if args.against is not None:
        turns(args.against.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
