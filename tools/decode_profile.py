"""Where the decode_attention kernel's time goes on the card, and how it
compares with another checkout's.

    python3 tools/decode_profile.py [--against DIR]

At one decode_32k layer (B 128, S 32,768, qwen2.5-3b's H 16, KV 2, dh
128, bf16 cache) and at the serve shape (B 4, S 512, f32 and bf16,
inputs cycled past the 50 MB L2), prints one JSON line each with the
device time a call spends in the attention kernel and in the merge of
its splits (``torch.profiler``'s CUDA spans), the gap between the two,
the splits and the bound share, every case held against its plain
version.  With ``--against DIR`` (a checkout of another commit, e.g.
unpacked with ``git archive``), then times ``chip_smoke.decode_case``
of that checkout and of this one at the same shapes, with the kernel's
device time, each in a process of its own, in turns (other, this,
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

H, KV, DH = 16, 2, 128
#: (batch, cache length, cache dtype): the serve shape, one decode_32k layer
SHAPES = ((4, 512, "float32"), (4, 512, "bfloat16"), (128, 32_768, "bfloat16"))
#: one process of a checkout: its chip_smoke's timed decode cases, and
#: the device time of the same kernel call on the same inputs, counted
#: here (per kernel the mean of the spans the profiler recorded) so
#: that both checkouts are timed alike
TURN = """
import json, sys
sys.path.insert(0, '.')
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from repro_torch.kernels.decode_attention import decode_attention_kernel
d = torch.device('cuda', 0)
cases = []
for b, s, dt in %r:
    dt = getattr(torch, dt)
    c = cs.decode_case(b, %d, %d, %d, s, dt, d, timed=True)
    gen = torch.Generator(device=d).manual_seed(1)
    q = torch.randn((b, %d, %d), generator=gen, device=d)
    k, v = (torch.randn((b, s, %d, %d), generator=gen, device=d, dtype=dt)
            for _ in range(2))
    lens = torch.full((b,), s, dtype=torch.int32, device=d)
    for _ in range(3):
        decode_attention_kernel(q, k, v, lens, %d ** -0.5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(24):
            decode_attention_kernel(q, k, v, lens, %d ** -0.5)
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.name, []).append(e.time_range.elapsed_us())
    c['kernel_device_ms'] = sum(sum(t) / len(t) for t in spans.values()) / 1e3
    c['spans_recorded'] = sum(len(t) for t in spans.values())
    cases.append({key: c.get(key) for key in (
        'case', 'ms', 'kernel_device_ms', 'spans_recorded', 'plain_ms',
        'library_ms', 'bound_ms', 'max_abs_err')})
    del q, k, v
    torch.cuda.empty_cache()
print(json.dumps(cases))
""" % (SHAPES, H, KV, DH, H, DH, KV, DH, DH, DH)


def breakdown(dev) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (decode_attention_kernel,
                                                      kernel_splits)
    for b, s, dt_name in SHAPES:
        dt = getattr(torch, dt_name)
        gen = torch.Generator(device=dev).manual_seed(b + s)
        q = torch.randn((b, H, DH), generator=gen, device=dev)
        k, v = (torch.randn((b, s, KV, DH), generator=gen, device=dev,
                            dtype=dt) for _ in range(2))
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        splits = kernel_splits(q, k)
        err = cs.check(f"decode B{b} S{s} {dt_name}",
                       decode_attention_kernel(q, k, v, lens, DH ** -0.5),
                       ref.decode_attention_split_ref(q, k, v, lens, splits),
                       5e-5, 5e-5)
        # the serve shape's inputs cycled past the L2, as a caller finds
        # them; one decode_32k layer is 4.3 GB by itself
        kv = [(k, v)] + [(k.clone(), v.clone()) for _ in range(
            int(np.ceil(60e6 / (2 * k.nbytes))) if s < 32_768 else 0)]
        fns = [lambda kc=kc, vc=vc: decode_attention_kernel(
            q, kc, vc, lens, DH ** -0.5) for kc, vc in kv]
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        iters = 24
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        spans = sorted(
            (e.time_range.start, e.time_range.end,
             "merge" if "merge" in e.name else "attention")
            for e in prof.events() if e.device_type == DeviceType.CUDA)
        # per kernel the mean of the spans recorded (the profiler can
        # drop records), as chip_smoke.device_ms
        by_kernel: dict = {}
        for start, end, name in spans:
            by_kernel.setdefault(name, []).append((end - start) / 1e3)
        gaps = [y[0] - x[1] for x, y in zip(spans, spans[1:])
                if (x[2], y[2]) == ("attention", "merge")]
        per_call = {name: sum(t) / len(t) for name, t in by_kernel.items()}
        device_ms = sum(per_call.values())
        valid = b * s
        bound_ms, bound_by = cs.bound(
            8 * b * H * DH + 4 * b + 2 * valid * KV * DH * k.element_size(),
            valid * H * (4 * DH + 5))
        print(json.dumps({
            "shape": f"B{b} H{H} KV{KV} dh{DH} S{s} {dt_name}",
            "splits": splits, "blocks": b * KV * splits,
            "device_ms_per_call": per_call,
            "spans_recorded": {name: len(t) for name, t in by_kernel.items()},
            "calls": iters,
            "attention_to_merge_gap_us": (float(np.median(gaps))
                                          if gaps else None),
            "device_ms": device_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bound_share": bound_ms / device_ms,
            "max_abs_err": err}), flush=True)
        del q, k, v, kv, fns
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
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 2
    breakdown(torch.device("cuda", 0))
    if args.against is not None:
        turns(args.against.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
