"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the five CUDA kernels of ``src/repro_torch/kernels/csrc`` with
nvcc, holds each against its plain PyTorch version on the card at the
slice's shapes and at wider ones (the Gram kernels in both operand
modes, the strip split across C and unsplit, the two stats kernels
split across a thread-block cluster and unsplit, at the slice's shape
and at C = 151,936, and ``pairwise`` against the plain version of its
split and unsplit, at forced S, N off its 64-row tile, C = 4,099, a
zero row and the reference's 256×151,936, timed beside ``x @ x.T``),
runs the slice (one
14-round HiCS-FL run of paper-cnn at full width: 50 clients, K=5,
10,000 samples) on the card and holds its first rounds against the
port's own CPU run,
then checks the incremental cache on the run's final Δb against the
pairwise kernel and the plain version, drives the from-scratch path
(pairwise kernel) in a second run, and holds one more clustered select
of each run against the plain versions on the CPU.  Then the paper's
five baseline selectors (phase ``baselines``): six 14-round runs of
the same spec (random, pow-d, cs, divfl, divfl with
refresh="selected", fedcor), each's first rounds against the port's CPU
run, the cs and divfl-selected caches (the strip kernel's cosine and
l2 epilogues) against a plain from-scratch build, and one more select
of each against the plain select on the CPU.  Phase ``hics_bf16``
runs the slice's spec with ``gram_in_bf16=True`` (bf16 Gram operands,
f32 sums): its cache against the plain bf16 build and the pairwise
kernel, one more select against the plain bf16 select on the CPU, and
an ``incremental=False`` run (pairwise in bf16).  Phase
``graph_rounds`` runs those nine runs again through the scanned round
driver (``jit_rounds=True``: one CUDA graph a round): no synchronizing
call in an eager round of the round step, one capture each, the host
loop's participants and, for HiCS, its cache bit for bit, the kernels'
launches on the graph path, rounds/s beside the host loop's, device ms
a replay and the device's busy share of the HiCS run's segments
(``python3 chip_smoke.py graph_rounds`` runs that phase alone, with
host-loop runs of its own).  Phase ``local_algos`` (alone: ``python3
chip_smoke.py local_algos``) runs the slice's spec with the paper's
other local updates (fedprox, feddyn and moon with sgd, fedavg with
sgd-momentum, fedprox with adam) and HiCS's other clusterings (average
linkage at M = 10, complete at M = 3 from scratch through pairwise,
single at M = K): each run's kernels, rounds/s and round split, its
first rounds against the CPU (teacher-forced loss and, for FedDyn and
Moon, per-client extras), for the linkage runs every select of the 14
rounds against the plain select on the card's state, and the FedDyn
and Moon runs again through the scanned driver, bit-equal to the host
loop.  Then the serving
slice: the two LM kernels (hetero_entropy, decode_attention) against
their plain versions, the entropy kernel's path through
``ops.estimate_entropies``, qwen2.5-3b at full width and depth through
the serve entry point (batch 4, prompt 64, 32 greedy tokens, beside
its byte bound), the decode kernel on the live bf16 cache, and the same
weights cut to two layers on the card against the port's CPU run.
Then phase ``transformer_family`` (``python3 chip_smoke.py
transformer_family`` runs it after ``serve_kernels``, whose decode
cases include dh 256): gemma-7b, pixtral-12b and granite-moe-1b-a400m
at published width and depth, mixtral-8x22b (2 layers) and
deepseek-coder-33b (8 layers) at published width through the serve
entry point's functions (batch 4, 16 greedy tokens, the decode kernel
at each arch's geometry and on its live cache), mixtral (1 layer) and
granite fine-tuned through ``train.train_rounds`` with the selection
replayed on the CPU, two-layer cuts of granite, gemma and pixtral on
the card against the port's CPU run (the MoE router's ids among
them), and ``repro_torch.examples.serve_batched`` with mixtral.
Then phase ``model_families`` (``python3 chip_smoke.py model_families``
runs it after ``serve_kernels``, whose decode cases include zamba2's
dh 112): rwkv6-3b, zamba2-7b and seamless-m4t-medium at published
width and depth through the serve entry point's functions (batch 4,
prompt 64, seamless's after 64 frames, 16 greedy tokens; the decode
kernel at zamba2's and seamless's geometry and on their live caches,
seamless's cross cache among them; rwkv has no attention), rwkv (8
layers) and zamba2 (36 layers, six sites) fine-tuned through
``train.train_rounds`` with the selection replayed on the CPU,
two-layer cuts of the three on the card against the port's CPU run
with equal greedy tokens, and ``serve_batched`` with seamless.
Then phase ``lm_train`` (``python3 chip_smoke.py lm_train`` alone):
federated fine-tuning of qwen2.5-3b at full width and depth through
``repro_torch.launch.train`` (8 clients, K = 2, 6 rounds), its peak
memory and ms a local step, the selection replayed on the CPU from the
card's Δb, the final cache against the plain versions, a profile of one
local step, and a two-layer cut's local update on the card against the
port's CPU run.  Last, phase ``finetune_example`` (alone: ``python3
chip_smoke.py finetune_example``): ``repro_torch.examples.
federated_finetune`` at its ~100M default, cut to 6 rounds.  Last,
phase ``scenarios`` (alone: ``python3 chip_smoke.py scenarios``) at
the slice's spec: the five partition kinds built on the card from CPU
draws (bit-equal to the CPU's), ``run_sweep`` over four scenarios ×
hics and cs × two seeds × 14 rounds (one CUDA graph a round for the
two seeds; each seed bit-equal to its scanned run, picks available,
each cell's first rounds against the CPU), the async server at identity
latency (bit-equal to the sync scanned run), under stragglers and
flash crowds (arrivals accounted, versions counted) and at M = 2K
(``stale_slots`` = 2: the strip over 2K rows with repeated ids, the
cache against from-scratch builds), and ``run_async_sweep`` over three
traffic shapes.  Then phase ``telemetry`` (alone: ``python3
chip_smoke.py telemetry``) at the slice's spec: the graph driver, the
host loop, the async server at identity latency and ``run_sweep`` over
two scenarios × hics × two seeds, each with telemetry off and on
(bit-equal, one capture each), the fields against the host's
recomputation from each run's history, ms a replay with and without
telemetry in turns, each sweep seed's fields bit-equal to its scanned
run's, one field set from all four drivers, the JSONL round trip, the
env stamp, and the ``kernels/*`` profiler ranges of a host-loop round
with ``REPRO_TRACE=1`` (a subprocess) and without.  Last, phase
``substrate`` (alone: ``python3 chip_smoke.py substrate``): the sweep
CLI (``repro_torch.launch.sweep --quick --host --telemetry``) into a
temporary directory with its launches counted, its --out bit-equal to
``run_sweep``; the one-card dry run (``repro_torch.launch.dryrun``, on
``meta`` in worker processes) of one arch a family × the four shapes,
and qwen2.5-3b's batch that fits 70 GB at each shape it runs;
qwen2.5-3b at published width and depth through a bf16 train step
(train_4k's length), a bf16 prefill_32k and a bf16 decode_32k step at
those batches (cut for time), each's peak memory beside the dry run's
bytes and its ms beside the roofline bound; and ``launch.multihost
--local --task train`` for 2 steps.  Then phase ``sharded`` (alone:
``python3 chip_smoke.py sharded``): qwen2.5-3b at published width and
depth on a real one-card mesh (NCCL, world 1, mesh (1, 1)) through a
bf16 train step at train_4k's length, a prefill and a decode step,
unsharded and on DTensors under 2d and fsdp, held bit for bit to the
unsharded steps with no collective byte, and timed; and, in worker
processes on ``meta``, the production dry run of four combos on the
16×16 mesh (``launch.dryrun.run_mesh_combo``).  ``serve_kernels`` also
holds the decode kernel at the shapes no registered config has: dh 8,
40, 80, 96, 192, 264, 320 and 512 (the runtime row width), dh 1, 4,
36, 37, 100 and 260 (off the 16-byte rows) and G 16 at dh 128, G 24 at
dh 64, G 3 at dh 512 (the group split into chunks).  Phase
``lm_train``
also writes ``--telemetry`` and reads it back.
Prints one JSON line per phase, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": ...}``.  Exits non-zero, with no result
line, without a CUDA device or when any check fails.

Tolerances (kernel vs plain version, and cache vs from scratch): Ĥ to
5e-5 at T = 0.63 and 1e-3 at T = 0.0025 (1/T amplifies f32 rounding),
against the unsplit plain version and the plain version of the
kernel's split alike (only the order of the sums differs);
norms and distances to 1e-5 absolute plus 1e-5 relative (the λ = 10
entropy term carries Ĥ's last-bit rounding into distances near 4);
Euclidean (l2) distances to 1e-5 times the largest row norm absolute
plus 1e-5 relative: √(|a|² + |b|² − 2⟨a, b⟩) cancels near 0, where the
f32 rounding of the sum, relative to the squared norms, is what
remains.  The bf16 cases (``gram_in_bf16``) are held against the plain
bf16 versions at the same tolerances: both read the same bf16-rounded
operands, whose products are exact in f32, so only the order of the
sums differs, as in f32.
The serving kernels and the parity phase state theirs beside each
check, at the reference's own kernel tolerances.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import json
import multiprocessing
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.core import (SelectNoise, SelectorState,  # noqa: E402
                              agglomerate_device, hics_functional,
                              make_functional)
from repro_torch.core.selectors.baselines import (  # noqa: E402
    _l2_scratch, facility_location)
from repro_torch.data import SyntheticSpec  # noqa: E402
from repro_torch.fed import (ExperimentSpec, LocalSpec, build,  # noqa: E402
                             flatten_params, make_local_update)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_stats import (  # noqa: E402
    fused_stats_rows, stats_splits)
from repro_torch.kernels.gram_update import (  # noqa: E402
    gram_strip, strip_splits)
from repro_torch.kernels.pairwise import (  # noqa: E402
    pairwise, pairwise_plan)
from repro_torch.kernels.hetero_entropy import entropy_rows  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_kernel, decode_plan, kernel_splits)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import make_selector  # noqa: E402
from repro_torch.core import head_num_classes  # noqa: E402
from repro_torch.data import make_lm_streams  # noqa: E402
from repro_torch.examples import federated_finetune  # noqa: E402
from repro_torch.examples import serve_batched  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.launch import dryrun, multihost, serve, train  # noqa: E402
from repro_torch.launch import sweep as sweep_cli  # noqa: E402
from repro_torch.launch.steps import (make_init_state,  # noqa: E402
                                      make_prefill_step, make_serve_step,
                                      make_train_step, shard_batch,
                                      shard_cache, shard_params,
                                      shard_state)
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.roofline.cost import CollectiveCounter  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.models import get_model, make_classifier  # noqa: E402
from repro_torch.optim import tree_map  # noqa: E402
from repro_torch.fed import (AsyncConfig, AsyncFederatedServer,  # noqa: E402
                             FederatedServer)
from repro_torch.scenarios import (SweepSpec,  # noqa: E402
                                   availability_mask, build_pair,
                                   make_dataset, run_async_sweep,
                                   run_host_reference, run_sweep,
                                   serial_seconds)
from repro_torch.scenarios.registry import (  # noqa: E402
    partition_generator)
from repro_torch.scenarios import sweep as sweep_mod  # noqa: E402
from repro_torch.telemetry import (GROUPS, client_true_entropy,  # noqa: E402
                                   env_stamp, read_jsonl,
                                   telemetry_from_records, write_run,
                                   write_sweep)

LAM = 10.0
T_SLICE = 0.63
ROUNDS = 14
CPU_ROUNDS = 3
T_LM = 0.01                    # the LM fine-tune's HiCS temperature
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 on the tensor cores, dense
SELECTOR_KW = dict(temperature=T_SLICE, gamma0=4.0, normalize=True,
                   incremental=True)
SPEC = ExperimentSpec(
    arch="paper-cnn", num_clients=50, num_select=5, rounds=ROUNDS,
    alphas=(0.001, 0.002, 0.005, 0.01, 0.5), selector="hics",
    selector_kw=SELECTOR_KW,
    data=SyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
    local=LocalSpec(lr=0.05, epochs=2, batch_size=32),
    samples_train=10_000, samples_test=2_000, eval_every=5, seed=0)

KERNELS = {
    "fused_stats": ("src/repro_torch/kernels/csrc/fused_stats.cu",
                    "src/repro/kernels/fused_stats.py:41"),
    "gram_update": ("src/repro_torch/kernels/csrc/gram_update.cu",
                    "src/repro/kernels/gram_update.py:61"),
    "pairwise": ("src/repro_torch/kernels/csrc/pairwise.cu",
                 "src/repro/kernels/pairwise.py:34"),
    "hetero_entropy": ("src/repro_torch/kernels/csrc/hetero_entropy.cu",
                       "src/repro/kernels/hetero_entropy.py:32"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:30"),
}

failures: list = []
#: the card's name and power limit, as nvidia-smi reads them
CARD = None


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(name: str, got, want, atol, rtol: float = 0.0) -> float:
    """Record whether ``got`` is within tolerance of ``want`` (``atol``
    a number, or a tensor of one per entry); returns the max absolute
    error."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool(((got - want).abs() <= atol + rtol * want.abs()).all()))
    if not ok:
        if isinstance(atol, torch.Tensor):     # a tolerance per entry
            atol = f"[{float(atol.min())}, {float(atol.max())}]"
        failures.append(f"{name}: max abs err {err} > {atol} + {rtol}|x|")
    return err


def require(name: str, ok: bool) -> None:
    if not ok:
        failures.append(name)


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after a warm-up,
    by CUDA events (L2 warm: the inputs stay resident)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_rotating(fns, iters: int = 48) -> float:
    """Mean device time of a call cycling through ``fns``, closures
    over distinct input copies that together exceed the 50 MB L2, so
    each call finds its input in device memory, as a caller would."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cuda_spans(fns, iters: int, tries: int = 3) -> list:
    """(name, µs) of every CUDA span ``torch.profiler`` recorded over
    ``iters`` calls cycling through ``fns``, after one warm call each.
    The profiler can drop records, once all of a window's: a window
    with no span is profiled again, up to ``tries`` times, and an empty
    list returned if none recorded one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        if spans:
            return spans
    return []


def device_ms(fns, iters: int = 24) -> float:
    """Mean device time of a call cycling through ``fns``, each call
    launching each of its kernels once: per kernel, the mean of its own
    spans in ``torch.profiler`` over ``iters`` calls, summed over the
    kernels, without the host's time between them.  The mean is over
    the spans the profiler recorded, not over ``iters``: the profiler
    can drop records (it once reported under half of decode_32k's
    byte bound when divided by the calls).  A run in which it records
    none is a failure, and the time NaN."""
    spans: dict = {}
    for name, us in cuda_spans(fns, iters):
        spans.setdefault(name, []).append(us)
    if not spans:
        failures.append("torch.profiler recorded no CUDA span in 3 tries")
        return float("nan")
    return sum(sum(t) / len(t) for t in spans.values()) / 1e3


def bound(nbytes: float, flops: float, operands: str = "f32"):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the peak of the work's operand mode: f32 on the
    CUDA cores, or the Gram kernels' bf16 operands (``gram_in_bf16``)
    on the tensor cores.  The callers count the least work the
    function needs: each distinct input read once, each output written
    once, and one dot product per distinct off-diagonal pair of the
    (symmetric) Eq. 9 matrix, 2·C operations each, plus ~10 for the
    epilogue."""
    peak = {"f32": F32_FLOPS_PER_S, "bf16": BF16_FLOPS_PER_S}[operands]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rows(n: int, c: int, seed: int, dev) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((n, c), generator=g) * 0.02).to(dev)


def stats_of(x: torch.Tensor, temperature: float, normalize: bool):
    """[norm, Ĥ] of every row by the plain version."""
    h = ref.row_entropy(x, temperature, normalize)
    return torch.stack([torch.linalg.vector_norm(x, dim=-1), h], -1)


# ---------------------------------------------------------------------------
# per-kernel checks: kernel vs plain version on the card
# ---------------------------------------------------------------------------


def plain_stats(x, temperature, scale, normalize):
    """The unsplit plain version of fused_stats: (Ĥ, norm, RMS), Ĥ of
    the RMS-normalized rows under ``normalize``."""
    ent, norm, rms = ref.fused_stats_ref(x, temperature, scale)
    if normalize:
        ent = ref.row_entropy(x, temperature, True)
    return ent, norm, rms


def rotating_copies(x: torch.Tensor) -> list:
    """``x`` and enough copies of it to pass 60 MB, past the 50 MB L2."""
    return [x] + [x.clone() for _ in range(int(np.ceil(60e6 / x.nbytes)))]


def fused_stats_case(n, c, temperature, mode, dev, timed=False,
                     splits=None, zero_row=False):
    """fused_stats on (n, c) in ``mode`` ("unscaled": 1/T, "scaled": a
    per-row scale, "normalized": 1/(RMS·T) in the same launch) against
    both plain versions: the split one at the kernel's P
    (``ref.fused_stats_split_ref``, default the plan for this card) and
    the unsplit one; where P > 1 the kernel also runs unsplit (P = 1).
    Tolerances in the module docstring; two calls must agree bit for
    bit.  ``zero_row`` zeroes row 0 (RMS 0: Ĥ = ln C under
    normalize)."""
    x = rows(n, c, seed=n + c, dev=dev)
    if zero_row:
        x[0] = 0.0
    scale = (torch.rand(n, generator=torch.Generator().manual_seed(1))
             .to(dev) + 0.5) if mode == "scaled" else None
    kscale = None if scale is None else (scale / temperature).contiguous()
    normalize = mode == "normalized"
    p = splits or stats_splits(n, c, kbuild.sm_count(dev.index or 0))

    def call(xc=x, sp=p):
        return fused_stats_rows(xc, temperature, row_scale=kscale,
                                normalize=normalize, splits=sp)

    got, again = call(), call()
    want = plain_stats(x, temperature, scale, normalize)
    want_split = ref.fused_stats_split_ref(x, temperature, p, scale,
                                           normalize)
    h_tol = 5e-5 if temperature >= 0.01 else 1e-3
    tag = f"fused_stats({n},{c},T={temperature},{mode},P={p}" + (
        ",zero_row)" if zero_row else ")")

    def errs(name, got):
        return max(max(check(f"{name}.ent", got[0], w[0], h_tol),
                       check(f"{name}.norm", got[1], w[1], 1e-5, 1e-5),
                       check(f"{name}.rms", got[2], w[2], 1e-5, 1e-5))
                   for w in (want, want_split))

    err = errs(tag, got)
    if zero_row and normalize:
        err = max(err, check(tag + ".ln_C", got[0][:1],
                             torch.full((1,), float(np.log(c)), device=dev),
                             h_tol))
    bit_equal = all(torch.equal(a, b) for a, b in zip(got, again))
    require(f"{tag}: two calls on the same input differ", bit_equal)
    out = {"case": tag, "splits": p, "max_abs_err": err,
           "bit_equal": bit_equal}
    if p > 1:
        one = call(sp=1)
        out["unsplit_max_abs_err"] = max(
            check(f"{tag} unsplit (P = 1).ent", one[0], want[0], h_tol),
            check(f"{tag} unsplit (P = 1).norm", one[1], want[1], 1e-5, 1e-5),
            check(f"{tag} unsplit (P = 1).rms", one[2], want[2], 1e-5, 1e-5))
    if timed:
        # a wide x cycled through copies past the 50 MB L2, as a
        # caller finds Δb after a round; the slice's 5 x 10 stays warm
        copies = rotating_copies(x) if x.nbytes > 1e6 else [x]
        kern = [lambda xc=xc: call(xc) for xc in copies]
        plain = [lambda xc=xc: plain_stats(xc, temperature, scale, normalize)
                 for xc in copies]
        out["ms"] = time_ms_rotating(kern)
        out["plain_ms"] = time_ms_rotating(plain)
        out["device_ms"] = device_ms(kern)
        # x read once, the scale if any, three outputs written; per
        # element a multiply, a max, a subtract, an exp, an add and two
        # fmas.  Under normalize the kernel reads its slice twice (the
        # second time mostly from L2), which the bound does not count
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + (n if mode == "scaled" else 0) + 3 * n), 8 * n * c)
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        out["library_ms"] = None
    return out


def _mode(bf16: bool) -> str:
    return ",bf16" if bf16 else ""


def strip_case(k, n, c, temperature, normalize, dev, timed=False,
               bf16=False, cold=False):
    """The arccos strip against its plain version; where C is split
    (S > 1) also unsplit (S = 1).  A timed case is warm in L2 and
    host-paced, or with ``cold`` cycles x through copies past the 50 MB
    L2 (as the selector's refresh after an LM round finds Δb) and adds
    the kernels' device time."""
    x = rows(n, c, seed=k + n + c, dev=dev)
    stats = stats_of(x, temperature, normalize).contiguous()
    ids = torch.arange(0, n, max(1, n // k), device=dev)[:k]
    ids32 = ids.to(torch.int32)
    r, s_r = x[ids].contiguous(), stats[ids].contiguous()
    got = gram_strip(r, x, s_r, stats, ids32, LAM, gram_in_bf16=bf16)
    want = ref.distance_strip_ref(x, stats, ids, LAM, gram_in_bf16=bf16)
    tag = f"gram_update({k}x{n},{c},normalize={normalize}{_mode(bf16)})"
    err = check(tag, got, want, 1e-5, 1e-5)
    # bit-symmetry of the K x K block, as the cache scatter needs it
    kk = got[:, ids]
    require(tag + ": K x K block not bit-symmetric",
            bool(torch.equal(kk, kk.T)))
    require(tag + ": true diagonal not zero",
            bool((kk.diagonal() == 0).all()))
    splits = strip_splits(k, n, c)
    out = {"case": tag, "max_abs_err": err, "splits": splits}
    if splits > 1:
        one = gram_strip(r, x, s_r, stats, ids32, LAM, gram_in_bf16=bf16,
                         splits=1)
        out["unsplit_max_abs_err"] = check(tag + " unsplit (S = 1)", one,
                                           want, 1e-5, 1e-5)
    if timed:
        # the K rows and their stats are a gather of x and stats_all;
        # the K x K block is symmetric and its diagonal zero
        pairs = k * n - k * (k + 1) // 2
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + 2 * n + k + k * n), 2 * c * pairs + 10 * pairs,
            kbuild.OPERANDS[bf16])
        if not cold:
            out["ms"] = time_ms(lambda: gram_strip(r, x, s_r, stats, ids32,
                                                   LAM, gram_in_bf16=bf16))
            out["plain_ms"] = time_ms(
                lambda: ref.distance_strip_ref(x, stats, ids, LAM,
                                               gram_in_bf16=bf16))
            out["bound_share"] = out["bound_ms"] / out["ms"]
            return out
        copies = [(xc, xc[ids].contiguous()) for xc in rotating_copies(x)]
        kern = [lambda xc=xc, rc=rc: gram_strip(rc, xc, s_r, stats, ids32,
                                                LAM, gram_in_bf16=bf16)
                for xc, rc in copies]
        plain = [lambda xc=xc: ref.distance_strip_ref(xc, stats, ids, LAM,
                                                      gram_in_bf16=bf16)
                 for xc, _ in copies]
        out["ms"] = time_ms_rotating(kern)
        out["plain_ms"] = time_ms_rotating(plain)
        out["device_ms"] = device_ms(kern)
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        out["library_ms"] = None   # no single PyTorch call computes it
    return out


def feature_strip_case(k, n, c, epilogue, dev, timed=False, bf16=False):
    """The strip kernel's cosine or l2 epilogue against its plain version
    (tolerances in the module docstring).  The entropy lane of the stats
    holds random values that neither epilogue may read.  Where C is
    split (S > 1), the strip is also computed unsplit (S = 1): the two
    sum in other orders and agree within the same tolerance."""
    x = rows(n, c, seed=k + n + c + 7, dev=dev)
    norms = torch.linalg.vector_norm(x, dim=-1)
    gen = torch.Generator().manual_seed(n)
    stats = torch.stack([norms, torch.rand(n, generator=gen).to(dev)],
                        -1).contiguous()
    ids = torch.arange(0, n, max(1, n // k), device=dev)[:k]
    ids32 = ids.to(torch.int32)
    r, s_r = x[ids].contiguous(), stats[ids].contiguous()
    got = gram_strip(r, x, s_r, stats, ids32, 0.0, epilogue=epilogue,
                     gram_in_bf16=bf16)
    want = ref.distance_strip_ref(x, stats, ids, 0.0, epilogue=epilogue,
                                  gram_in_bf16=bf16)
    tag = f"gram_update.{epilogue}({k}x{n},{c}{_mode(bf16)})"
    atol = 1e-5 if epilogue == "cosine" else 1e-5 * float(norms.max())
    err = check(tag, got, want, atol, 1e-5)
    kk = got[:, ids]
    require(tag + ": K x K block not bit-symmetric",
            bool(torch.equal(kk, kk.T)))
    require(tag + ": true diagonal not zero",
            bool((kk.diagonal() == 0).all()))
    splits = strip_splits(k, n, c)
    out = {"case": tag, "max_abs_err": err, "atol": atol, "splits": splits}
    if splits > 1:
        one = gram_strip(r, x, s_r, stats, ids32, 0.0, epilogue=epilogue,
                         gram_in_bf16=bf16, splits=1)
        out["unsplit_max_abs_diff"] = check(tag + " unsplit (S = 1)", one,
                                            want, atol, 1e-5)
    if timed:
        # copies of x past the 50 MB L2, so each call reads device
        # memory, as the selector's refresh after a round does
        copies = [(xc, xc[ids].contiguous()) for xc in rotating_copies(x)]
        kern = [lambda xc=xc, rc=rc: gram_strip(rc, xc, s_r, stats, ids32,
                                                0.0, epilogue=epilogue,
                                                gram_in_bf16=bf16)
                for xc, rc in copies]
        plain = [lambda xc=xc: ref.distance_strip_ref(xc, stats, ids, 0.0,
                                                      epilogue=epilogue,
                                                      gram_in_bf16=bf16)
                 for xc, _ in copies]
        cdist = [lambda xc=xc, rc=rc: torch.cdist(rc, xc)
                 for xc, rc in copies]
        out["ms"] = time_ms_rotating(kern)
        out["plain_ms"] = time_ms_rotating(plain)
        # the kernels' own device time (both launches), beside the
        # host-paced time of back-to-back calls above
        out["device_ms"] = device_ms(kern)
        out["plain_device_ms"] = device_ms(plain)
        out["cdist_device_ms"] = device_ms(cdist)
        # rows and x read once, their norms, the ids and the strip;
        # one dot product per distinct off-diagonal pair (the K x K
        # block is symmetric with a zero diagonal), ~10 epilogue ops
        pairs = k * n - k * (k + 1) // 2
        out["bound_ms"], out["bound_by"] = bound(
            4 * (k * c + n * c + k + n + k + k * n),
            2 * c * pairs + 10 * pairs, kbuild.OPERANDS[bf16])
        out["bound_share"] = out["bound_ms"] / out["ms"]
        out["device_bound_share"] = out["bound_ms"] / out["device_ms"]
        # torch.cdist: f32 Euclidean distances of the same rows, timed
        # beside every epilogue as the yardstick of one library call
        out["cdist_ms"] = time_ms_rotating(cdist)
        if epilogue == "l2" and not bf16:
            # the same distances but for the zeroed diagonal
            cd = torch.cdist(r, x)
            off = torch.ones_like(cd, dtype=torch.bool)
            off[torch.arange(k), ids] = False
            out["library_ms"] = out["cdist_ms"]
            out["library_max_abs_err"] = float((cd - want)[off].abs().max())
        elif epilogue == "l2":
            out["library_ms"] = None
            out["library_note"] = ("no single PyTorch call computes the "
                                   "distances of bf16-rounded operands")
        else:
            out["library_ms"] = None
            out["library_note"] = ("no single PyTorch call computes the "
                                   "clipped arccos of the cosine")
    return out


def pairwise_case(n, c, temperature, normalize, dev, timed=False,
                  bf16=False, splits=None, zero_row=False):
    """pairwise on (n, c) against both plain versions: the split one at
    the kernel's S (``ref.pairwise_split_ref``, default the plan for
    this card) and the unsplit one; where S > 1 the kernel also runs
    unsplit (S = 1).  Every case must be bit-symmetric, zero on the
    diagonal and bit-equal call to call.  ``zero_row`` zeroes row 0
    (its cosines are 0: distances π/2 + λ|ΔĤ|).  Timed: events over
    back-to-back calls, the kernel's device time, and ``x @ x.T``'s
    (cuBLAS SGEMM with TF32 off, both halves of the products, a
    yardstick and not the same function: ``library_ms`` stays null)."""
    x = rows(n, c, seed=3 * n + c, dev=dev)
    if zero_row:
        x[0] = 0.0
    stats = stats_of(x, temperature, normalize).contiguous()
    p = pairwise_plan(n, c, kbuild.sm_count(dev.index or 0), splits).splits

    def call(sp=p):
        return pairwise(x, stats, LAM, gram_in_bf16=bf16, splits=sp)

    got, again = call(), call()
    want = ref.pairwise_distance_ref(x, stats[:, 1], LAM, gram_in_bf16=bf16)
    want_split = ref.pairwise_split_ref(x, stats, LAM, p, bf16)
    tag = f"pairwise({n},{c},normalize={normalize}{_mode(bf16)},S={p}" + (
        ",zero_row)" if zero_row else ")")
    err = max(check(tag, got, want, 1e-5, 1e-5),
              check(tag + " vs split plain", got, want_split, 1e-5, 1e-5))
    bit_equal = bool(torch.equal(got, again))
    require(tag + ": not bit-symmetric", bool(torch.equal(got, got.T)))
    require(tag + ": diagonal not zero",
            bool((torch.diagonal(got) == 0).all()))
    require(tag + ": two calls on the same input differ", bit_equal)
    out = {"case": tag, "splits": p, "max_abs_err": err,
           "bit_equal": bit_equal}
    if p > 1:
        one = call(sp=1)
        out["unsplit_max_abs_err"] = check(tag + " unsplit (S = 1)", one,
                                           want, 1e-5, 1e-5)
        require(tag + " unsplit: not bit-symmetric",
                bool(torch.equal(one, one.T)))
    if timed:
        # x stays in L2 below 50 MB, as the selector finds Δb right
        # after it wrote it; 256×151,936 is 3× the L2
        out["ms"] = time_ms(call)
        out["plain_ms"] = time_ms(
            lambda: ref.pairwise_distance_ref(x, stats[:, 1], LAM,
                                              gram_in_bf16=bf16))
        out["device_ms"] = device_ms([call])
        gemm = lambda: x @ x.T  # noqa: E731
        out["gemm_ms"] = time_ms(gemm)
        out["gemm_device_ms"] = device_ms([gemm])
        pairs = n * (n - 1) // 2        # symmetric, zero diagonal
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + 2 * n + n * n), 2 * c * pairs + 10 * pairs,
            kbuild.OPERANDS[bf16])
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        out["library_ms"] = None
    return out


def cached_step_case(n, k, c, normalize, dev):
    """The whole incremental step (kernel path vs plain) and the exact
    symmetry of the scattered cache."""
    x_old = rows(n, c, seed=11, dev=dev)
    _, dist0, stats0 = ref.cached_selection_step_ref(
        x_old, torch.zeros(n, n, device=dev), torch.zeros(n, 2, device=dev),
        torch.arange(n, device=dev), T_SLICE, LAM, normalize=normalize)
    ids = torch.tensor([1, n - 1, n // 2, 1][:k], device=dev)  # dup 1
    x = x_old.clone()
    x[ids] = rows(len(ids), c, seed=12, dev=dev)
    ent, dist, stats = ops.hics_selection_step_cached(
        x, dist0, stats0, ids, T_SLICE, LAM, normalize=normalize,
        device=dev)
    w_ent, w_dist, w_stats = ref.cached_selection_step_ref(
        x, dist0, stats0, ids, T_SLICE, LAM, normalize=normalize)
    tag = f"cached_step({n},{k},{c},normalize={normalize})"
    err = max(check(tag + ".ent", ent, w_ent, 5e-5),
              check(tag + ".dist", dist, w_dist, 1e-5, 1e-5),
              check(tag + ".norm", stats[:, 0], w_stats[:, 0], 1e-5, 1e-5))
    require(tag + ": cache not bit-symmetric", bool(torch.equal(dist,
                                                                dist.T)))
    return {"case": tag, "max_abs_err": err}


def kernel_phase(dev):
    """Each kernel against its plain version.  Returns the cases by
    kernel, the strip's timed cases on the baselines' path by epilogue
    (f32 and bf16), the Gram kernels' timed case at the slice's shape by
    operand mode, the stats kernels' and pairwise's timed wide cases,
    and the arccos strip's timed case on the LM fine-tune's path."""
    t0 = time.perf_counter()
    slice_cases = {
        "fused_stats": [fused_stats_case(5, 10, T_SLICE, "normalized", dev,
                                         True),
                        fused_stats_case(5, 10, T_SLICE, "scaled", dev),
                        fused_stats_case(50, 10, T_SLICE, "unscaled", dev),
                        fused_stats_case(50, 10, T_SLICE, "normalized",
                                         dev)],
        "gram_update": [strip_case(5, 50, 10, T_SLICE, True, dev, True)],
        "pairwise": [pairwise_case(50, 10, T_SLICE, True, dev, True)],
    }
    # the baselines' path: K = 5 refreshed rows of 50 clients' full
    # paper-cnn updates, F = 158,570
    path_strip = {}
    for epilogue in ("cosine", "l2"):
        path_strip[epilogue] = feature_strip_case(5, 50, 158_570, epilogue,
                                                  dev, timed=True)
        slice_cases["gram_update"] += [path_strip[epilogue],
                                       feature_strip_case(
                                           10, 512, 1024, epilogue, dev,
                                           timed=True)]
    # gram_in_bf16: every epilogue at the slice's shape and at
    # K10×N512×C1024, cosine and l2 on the baselines' path; pairwise at
    # the slice's shape and at 512×512×1024
    modes = {"gram_update": {"f32": slice_cases["gram_update"][0]},
             "pairwise": {"f32": slice_cases["pairwise"][0]}}
    strip16 = [strip_case(5, 50, 10, T_SLICE, True, dev, True, bf16=True),
               strip_case(10, 512, 1024, T_SLICE, True, dev, True,
                          bf16=True)]
    modes["gram_update"]["bf16"] = strip16[0]
    for epilogue in ("cosine", "l2"):
        path_strip[epilogue + ",bf16"] = feature_strip_case(
            5, 50, 158_570, epilogue, dev, timed=True, bf16=True)
        strip16 += [feature_strip_case(5, 50, 10, epilogue, dev, bf16=True),
                    feature_strip_case(10, 512, 1024, epilogue, dev,
                                       timed=True, bf16=True),
                    path_strip[epilogue + ",bf16"]]
    pair16 = [pairwise_case(50, 10, T_SLICE, True, dev, True, bf16=True),
              pairwise_case(512, 1024, T_SLICE, True, dev, True, bf16=True)]
    modes["pairwise"]["bf16"] = pair16[0]
    slice_cases["gram_update"] += strip16
    slice_cases["pairwise"] += pair16
    wide = [cached_step_case(50, 5, 10, True, dev)]
    pair_timed = [pair16[1]]
    for normalize in (False, True):
        wide.append(strip_case(10, 512, 1024, T_SLICE, normalize, dev, True))
        wide.append(pairwise_case(512, 1024, T_SLICE, normalize, dev, True))
        wide.append(cached_step_case(512, 4, 1024, normalize, dev))
    pair_timed.insert(0, wide[-2])
    # pairwise at the reference's full-size bench_kernels shape (N 256,
    # C = qwen2.5-3b's vocabulary); then S forced past the plan, N off
    # the 64-row tile, C not a multiple of 4 (rows at 4-byte offsets,
    # copied value by value), empty slices (S > chunks) and a zero row
    for bf16 in (False, True):
        pair_timed.append(pairwise_case(256, 151_936, T_SLICE, True, dev,
                                        True, bf16=bf16))
        wide.append(pair_timed[-1])
        for n in (50, 65, 257):
            wide.append(pairwise_case(n, 4099, T_SLICE, True, dev,
                                      bf16=bf16, zero_row=True))
        for splits in (1, 3, 8):
            wide.append(pairwise_case(65, 4099, T_SLICE, True, dev,
                                      bf16=bf16, splits=splits))
        wide.append(pairwise_case(50, 10, T_SLICE, True, dev, bf16=bf16,
                                  splits=8))
        # the same through the TMA path (C a multiple of 4): N off the
        # tile, and 8 of 40 slices empty
        wide.append(pairwise_case(257, 4096, T_SLICE, True, dev, bf16=bf16,
                                  zero_row=True))
        wide.append(pairwise_case(64, 1024, T_SLICE, True, dev, bf16=bf16,
                                  splits=40))
    # fused_stats at vocab width (qwen2.5-3b's C = 151,936): 64 rows, and
    # the LM fine-tune's K = 2 refreshed rows at T = 0.01; then P forced
    # past the plan at small C (C not a multiple of 4: rows at 4-byte
    # offsets), empty slices (C < P x 32) and a zero row under normalize
    stats_timed = []
    for temperature in (T_SLICE, 0.0025):
        for mode in ("unscaled", "scaled", "normalized"):
            timed = mode == "unscaled" or (mode == "normalized"
                                           and temperature == T_SLICE)
            wide.append(fused_stats_case(64, 151_936, temperature, mode, dev,
                                         timed=timed))
            if timed:
                stats_timed.append(wide[-1])
    for mode in ("unscaled", "scaled", "normalized"):
        wide.append(fused_stats_case(2, 151_936, 0.01, mode, dev,
                                     timed=mode == "unscaled"))
        if mode == "unscaled":
            stats_timed.append(wide[-1])
    # the arccos strip of the LM fine-tune's refresh: K = 2 rows against
    # N = 8 clients at vocab width, T = 0.01, split across C
    lm_strip = strip_case(2, 8, 151_936, T_LM, False, dev, timed=True,
                          cold=True)
    wide.append(lm_strip)
    for mode in ("unscaled", "normalized"):
        for splits in (3, 8):
            wide.append(fused_stats_case(17, 4099, T_SLICE, mode, dev,
                                         splits=splits))
        wide.append(fused_stats_case(3, 40, 0.0025, mode, dev, splits=8))
    for splits in (None, 3):
        wide.append(fused_stats_case(4, 1000, T_SLICE, "normalized", dev,
                                     splits=splits, zero_row=True))
    emit({"phase": "kernels", "slice_shapes": slice_cases,
          "wider_shapes": wide,
          "seconds": time.perf_counter() - t0})
    return slice_cases, path_strip, modes, stats_timed, pair_timed, lm_strip


# ---------------------------------------------------------------------------
# the slice: 14 rounds of paper-cnn on the card
# ---------------------------------------------------------------------------


def host_ms(fn, reps: int = 5) -> float:
    """Mean host-clock ms of ``fn`` ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def round_split(server) -> dict:
    """Host-clock ms of a round's three parts on the run's final state:
    one select (with its pending cache refresh), one cohort local
    update, and the observations the selector requires (Δb, the loss
    poll, the all-clients update or the participants' flattened
    updates)."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    new_params, _, _ = server.local_update(t, ids, draws.perms)
    return {
        "select_ms": host_ms(lambda: server.selector.select(
            server.state, t, draws.select)),
        "local_update_ms": host_ms(lambda: server.local_update(
            t, ids, draws.perms), reps=2),
        "observe_ms": host_ms(lambda: server.observe(
            server.params, new_params, draws.grad_perms), reps=2),
        "observes": sorted(server.requires),
        "s_max": int(server.x.shape[1]),
    }


def first_rounds_vs_cpu(spec, dev, hist, tag: str,
                        horizon: int = CPU_ROUNDS,
                        select_rounds: int = CPU_ROUNDS,
                        one_step: bool = False, make=None,
                        cpu_rounds: int = CPU_ROUNDS) -> dict:
    """The card run's first ``cpu_rounds`` rounds against the port's own
    CPU run of the same spec.

    Participants, free-running: the CPU run picks the card run's clients
    in each of the first ``horizon`` rounds.  Then, teacher-forced, a
    second card run takes the rounds one at a time, and in each of the
    first ``select_rounds`` the plain select on the CPU, given the card's
    selector state and noise, must pick the card's clients (past the
    coverage sweep, the clustered selects on the card's own cache); in
    each of the first ``cpu_rounds`` the cohort's update on the CPU from
    the card's params and per-client extras at the round's start, with
    the same ids and permutations, must give the card's train loss
    within 1e-3 relative.  Where the run keeps per-client extras, the
    card's extras after the round must be its own cohort update's
    written into the cohort's rows, bit for bit, and the CPU's
    teacher-forced extras are printed beside the card's.  With
    ``one_step``, the cohort's first sgd step (its first batch) on the
    CPU from the card's round-start params and extras must move each
    leaf of the params and of the extras as the card's does, within
    1e-3 of the leaf's largest move.  ``make(rounds, device)``, when
    given, makes the servers in place of ``build`` of ``spec`` with
    ``rounds`` rounds (the sweep's seeds: a server over a partition).
    The free-running train losses and the whole round's params and
    extras are printed, not held to a tolerance: paper-cnn's local
    training grows a last-bit difference to ~1e-3 of the loss within
    two rounds and to ~1e-2 of the params within one round's 62 steps
    (on the CPU alone, params perturbed by 1e-6 relative move round 1's
    loss by 1.5e-3; a round's update in f32 is 2e-2 of the params' scale
    from the same update in f64: ``tools/local_chaos.py``), so those
    comparisons measure the chaos of training rather than the port."""
    t0 = time.perf_counter()
    if make is None:
        make = lambda rounds, d: build(
            dataclasses.replace(spec, rounds=rounds), device=d)[0]
    cpu_hist = make(cpu_rounds, "cpu").run()
    require(f"{tag}: selected differs from the CPU run",
            cpu_hist["selected"][:horizon] == hist["selected"][:horizon])
    free = [abs(a - b) / abs(b) for a, b in
            zip(hist["train_loss"], cpu_hist["train_loss"])]
    forced_rounds = max(select_rounds, cpu_rounds)
    card, cpu = make(forced_rounds, dev), make(forced_rounds, "cpu")
    forced, forced_ids, extras_err, step_err = [], [], [], []
    writeback, clustered = [], 0
    for t in range(select_rounds):
        rd = card.draw_round(t)
        p0, e0 = card.params, card.extras      # replaced, never written
        params, extras = _tree_cpu(p0), _tree_cpu(e0)
        clustered += int(card.state.unseen_count) == 0
        ids_cpu, _ = cpu.select(_cpu(card.state), t, _tree_cpu(rd))
        ids, metrics = card.step(t, rd)
        forced_ids.append(ids_cpu.tolist() == ids.tolist())
        if t >= cpu_rounds:
            continue
        cpu.params = params
        _, ex_cpu, m_cpu = cpu.local_update(t, ids.cpu(), rd.perms.cpu(),
                                            extras=extras)
        a = float(metrics["train_loss"].mean())
        b = float(m_cpu["train_loss"].mean())
        forced.append(abs(a - b) / abs(b))
        idx = ids.long()
        if e0:
            _, ex_card, _ = card.local_update(t, ids, rd.perms, p0, e0)
            want = tree_map(lambda e, v: e.index_copy(0, idx, v), e0,
                            ex_card)
            writeback.append(all(torch.equal(x, y) for x, y in zip(
                _leaves(card.extras), _leaves(want))))
            after = tree_map(lambda e, v: e.index_copy(0, idx.cpu(), v),
                             extras, ex_cpu)
            extras_err.append(_leaf_rel_err(_tree_cpu(card.extras), after))
        if one_step:
            step_err.append(one_step_vs_cpu(card, cpu, idx, rd, p0, e0))
    require(f"{tag}: the CPU's select on the card's state differs",
            all(forced_ids))
    require(f"{tag}: train loss differs from the CPU's on the card's params "
            f"by {max(forced)}", max(forced) <= 1e-3)
    require(f"{tag}: extras not written back as the cohort's update",
            all(writeback))
    worst = max((max(e.values()) for e in step_err), default=0.0)
    require(f"{tag}: one step moves the params or extras otherwise than "
            f"on the CPU, by {worst} of the largest move", worst <= 1e-3)
    out = {"rounds": cpu_rounds, "participants_horizon": horizon,
           "cpu_selected": cpu_hist["selected"],
           "cpu_train_loss": cpu_hist["train_loss"],
           "free_running_rel_loss_diff": free,
           "teacher_forced_rel_loss_diff": forced,
           "teacher_forced_same_ids": forced_ids,
           "seconds": time.perf_counter() - t0}
    if card.extras:
        out["extras_written_back"] = writeback
        out["teacher_forced_round_extras_rel_err"] = extras_err
    if one_step:
        out["one_step_rel_err"] = step_err
    if select_rounds > cpu_rounds:
        out["clustered_selects_vs_plain"] = clustered
    return out


def one_step_vs_cpu(card, cpu, idx, rd, p0, e0) -> dict:
    """The cohort's first step of the round (its first batch of epoch
    0) from the card's round-start params ``p0`` and extras ``e0``, on
    the card and on the CPU: the largest over the leaves of the params'
    and of the extras' moves' difference, each over the leaf's largest
    move on the CPU."""
    local = dataclasses.replace(card.cfg.local, epochs=1)
    bs = min(local.batch_size, card.x.shape[1])
    perm = rd.perms[:, 0, :bs]
    k = idx.shape[0]
    ar = torch.arange(k, device=idx.device)[:, None]
    x = card.x[idx][ar, perm]
    y = card.y[idx][ar, perm]
    mask = card.mask[idx][ar, perm]
    one = torch.arange(bs, device=idx.device).expand(k, 1, bs)
    lr = torch.ones((), device=idx.device)
    moves = {}
    for side, srv in (("card", card), ("cpu", cpu)):
        lu = make_local_update(srv.apply_fn, local, srv.features_fn)
        dev = srv.device
        p, e = _tree_to(p0, dev), tree_map(
            lambda a: a.index_select(0, idx.to(dev)), _tree_to(e0, dev))
        new_p, new_e, _ = lu(p, e, x.to(dev), y.to(dev), mask.to(dev),
                             one.to(dev), lr.to(dev))
        moves[side] = (tree_map(lambda a, b: (a - b).cpu(), new_p,
                                _tree_to(p, dev)),
                       tree_map(lambda a, b: (a - b).cpu(), new_e, e))
    return {"params": _leaf_rel_err(moves["card"][0], moves["cpu"][0]),
            "extras": _leaf_rel_err(moves["card"][1], moves["cpu"][1])}


def _tree_to(tree, dev):
    return tree_map(lambda a: a.to(dev), tree)


def _tree_cpu(tree):
    return tree_map(lambda a: a.cpu(), tree)


def _leaf_rel_err(got, want) -> float:
    """The largest over the leaves of max |got − want| / max |want|."""
    errs = [float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(_leaves(got), _leaves(want))]
    return max(errs, default=0.0)


def _cpu(tup):
    return type(tup)(*(a.cpu() for a in tup))


def host_record(hist, state=None, extras=None) -> dict:
    """What a host-loop run's graph twin is held to: its participants,
    train loss and rounds/s, an incremental HiCS run's final cache and
    the final per-client extras of FedDyn and Moon."""
    rec = {"selected": hist["selected"][:ROUNDS],
           "train_loss": hist["train_loss"][:ROUNDS],
           "rounds_per_s": hist["rounds_per_s"]}
    if state is not None and state.dist_cache.numel():
        rec["cache"] = (state.dist_cache, state.row_stats)
    if extras:
        rec["extras"] = extras
    return rec


def slice_phase(dev):
    server, _ = build(SPEC, device=dev)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    for name in ("fused_stats", "gram_update"):
        require(f"slice: {name} was not launched", launches[name] > 0)
    # one stats launch a refresh, normalize included
    require("slice: fused_stats launches differ from the strip's",
            launches["fused_stats"] == launches["gram_update"])
    require("slice: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require("slice: bad test accuracy",
            all(0.0 <= a <= 1.0 for a in hist["test_acc"]))
    require("slice: Ĥ shape", len(hist["bias_entropy"][-1]) == 50
            and bool(np.isfinite(hist["bias_entropy"][-1]).all()))
    require("slice: participants not distinct",
            all(len(set(s)) == 5 for s in hist["selected"]))

    emit({"phase": "slice", "rounds": ROUNDS, "seconds": seconds,
          "rounds_per_s": hist["rounds_per_s"], "wall_s": hist["wall_s"],
          "launches": launches,
          "selected": hist["selected"], "train_loss": hist["train_loss"],
          "test_round": hist["test_round"], "test_acc": hist["test_acc"],
          "vs_cpu": first_rounds_vs_cpu(SPEC, dev, hist, "slice"),
          "round_split": round_split(server)})
    return server, hist, launches


def select_vs_plain(server, incremental: bool, tag: str,
                    kw=SELECTOR_KW) -> dict:
    """One more clustered select on the run's final state, by the
    kernels on the card and by the plain versions on the CPU with the
    same noise: the participants must be identical."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    plain = hics_functional(SPEC.num_clients, SPEC.num_select, ROUNDS,
                            device="cpu",
                            **dict(kw, incremental=incremental))

    ids_p, _ = plain.select(_cpu(server.state), t, _cpu(draws.select))
    require(f"{tag}: clustered select differs from the plain versions",
            ids.tolist() == ids_p.tolist())
    return {"card": ids.tolist(), "plain": ids_p.tolist()}


def from_scratch_phase(server, hist, dev):
    """The cache on the incremental run's final Δb against the pairwise
    kernel and the plain version, and a second run with
    incremental=False."""
    st = server.state
    # the last update staled K rows; refresh them as the next select
    # would, then rebuild the whole matrix from scratch, by the kernels
    # and by the plain version
    _, dist_c, stats_c = ops.hics_selection_step_cached(
        st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, T_SLICE,
        LAM, normalize=True, device=dev)
    ent, dist = ops.hics_selection_step(st.delta_b, T_SLICE, LAM,
                                        normalize=True, device=dev)
    ent_p, dist_p = ref.selection_step_ref(st.delta_b, T_SLICE, LAM,
                                           normalize=True)
    errs = {
        "dist_vs_cache": check("from_scratch: dist vs cache", dist,
                               dist_c, 1e-5, 1e-5),
        "entropy_vs_cache": check("from_scratch: Ĥ vs cache", ent,
                                  stats_c[:, 1], 1e-5),
        "cache_vs_plain": check("from_scratch: cache vs plain", dist_c,
                                dist_p, 1e-5, 1e-5),
        "cached_entropy_vs_plain": check(
            "from_scratch: cached Ĥ vs plain", stats_c[:, 1], ent_p, 5e-5),
        "cached_norm_vs_plain": check(
            "from_scratch: cached norm vs plain", stats_c[:, 0],
            torch.linalg.vector_norm(st.delta_b, dim=-1), 1e-5, 1e-5),
    }
    k = SPEC.num_select
    labels_c = agglomerate_device(dist_c, k, precomputed=True)
    labels_s = agglomerate_device(dist, k, precomputed=True)
    labels_p = agglomerate_device(dist_p, k)   # plain: symmetrized
    require("from_scratch: ward labels on the pairwise matrix differ",
            bool(torch.equal(labels_c, labels_s)))
    require("from_scratch: ward labels on the plain matrix differ",
            bool(torch.equal(labels_c, labels_p)))
    select_inc = select_vs_plain(server, True, "slice")

    scratch_spec = dataclasses.replace(
        SPEC, selector_kw=dict(SELECTOR_KW, incremental=False))
    server2, _ = build(scratch_spec, device=dev)
    kbuild.reset_launches()
    hist2 = server2.run()
    torch.cuda.synchronize()
    launches = dict(kbuild.launches)
    require("from_scratch: pairwise was not launched",
            launches["pairwise"] > 0)
    require("from_scratch: fused_stats launches differ from pairwise's",
            launches["fused_stats"] == launches["pairwise"])
    select_scratch = select_vs_plain(server2, False, "from_scratch")
    emit({"phase": "from_scratch", "max_abs_err": errs,
          "labels_identical": {
              "cache_vs_pairwise": bool(torch.equal(labels_c, labels_s)),
              "cache_vs_plain": bool(torch.equal(labels_c, labels_p))},
          "select_vs_plain": {"incremental": select_inc,
                              "from_scratch": select_scratch},
          "launches": launches,
          "same_participants_as_incremental":
              hist2["selected"] == hist["selected"],
          "selected": hist2["selected"]})
    return launches, host_record(hist2)


# ---------------------------------------------------------------------------
# the slice with gram_in_bf16=True: bf16 Gram operands, f32 sums
# ---------------------------------------------------------------------------

BF16_KW = dict(SELECTOR_KW, gram_in_bf16=True)


def _variants() -> dict:
    return {name: {axis: dict(counts) for axis, counts in axes.items()}
            for name, axes in kbuild.variant_launches.items()}


def bf16_select_vs_plain(server) -> dict:
    """One more clustered select on the bf16 run's final state, by the
    kernels on the card and by the plain versions on the CPU with the
    same noise: the CPU refreshes the staled rows with the plain bf16
    step (its own dispatch would stay f32, as the reference's CPU
    oracle), then selects on that cache.  The ids must be identical."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    st = _cpu(server.state)
    if int(st.stale_fill) > 0:
        _, dist, stats = ref.cached_selection_step_ref(
            st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, T_SLICE,
            LAM, normalize=True, gram_in_bf16=True)
        st = st._replace(dist_cache=dist, row_stats=stats,
                         stale_fill=torch.zeros_like(st.stale_fill))
    plain = hics_functional(SPEC.num_clients, SPEC.num_select, ROUNDS,
                            device="cpu", **SELECTOR_KW)
    ids_p, _ = plain.select(st, t, _cpu(draws.select))
    require("hics_bf16: clustered select differs from the plain bf16 "
            "select", ids.tolist() == ids_p.tolist())
    return {"card": ids.tolist(), "plain": ids_p.tolist()}


def hics_bf16_phase(dev):
    """The slice's spec with ``gram_in_bf16=True``, 14 rounds at full
    width, the counts set to 0 just before and read just after: the
    cache on the final Δb against the plain bf16 from-scratch build and
    the pairwise kernel in bf16, one more clustered select against the
    plain bf16 select on the CPU; then the same spec with
    ``incremental=False`` (pairwise in bf16) with its counts of its own.
    Returns both runs' launches by variant."""
    spec = dataclasses.replace(SPEC, selector_kw=BF16_KW)
    server, _ = build(spec, device=dev)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variants = dict(kbuild.launches), _variants()
    ops16 = variants["gram_update"]["operands"]
    require("hics_bf16: the bf16 strip was not launched", ops16["bf16"] > 0)
    require("hics_bf16: an f32 strip was launched", ops16["f32"] == 0)
    require("hics_bf16: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require("hics_bf16: participants not distinct",
            all(len(set(s)) == 5 for s in hist["selected"]))

    st = server.state
    _, dist_c, stats_c = ops.hics_selection_step_cached(
        st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, T_SLICE,
        LAM, normalize=True, gram_in_bf16=True, device=dev)
    _, dist = ops.hics_selection_step(st.delta_b, T_SLICE, LAM,
                                      normalize=True, gram_in_bf16=True,
                                      device=dev)
    ent_p, dist_p = ref.selection_step_ref(st.delta_b, T_SLICE, LAM,
                                           normalize=True, gram_in_bf16=True)
    _, dist_f32 = ref.selection_step_ref(st.delta_b, T_SLICE, LAM,
                                         normalize=True)
    require("hics_bf16: cache not bit-symmetric",
            bool(torch.equal(dist_c, dist_c.T)))
    errs = {
        "cache_vs_plain": check("hics_bf16: cache vs plain bf16", dist_c,
                                dist_p, 1e-5, 1e-5),
        "pairwise_vs_plain": check("hics_bf16: pairwise vs plain bf16",
                                   dist, dist_p, 1e-5, 1e-5),
        "cached_entropy_vs_plain": check(
            "hics_bf16: cached Ĥ vs plain", stats_c[:, 1], ent_p, 5e-5),
        "cached_norm_vs_plain": check(
            "hics_bf16: cached norm vs plain", stats_c[:, 0],
            torch.linalg.vector_norm(st.delta_b, dim=-1), 1e-5, 1e-5),
        # printed, not held: how far bf16 operands move the distances
        "bf16_cache_vs_plain_f32": float((dist_c - dist_f32).abs().max()),
    }
    select = bf16_select_vs_plain(server)
    split = round_split(server)
    records = {"hics-bf16": host_record(hist, server.state)}
    del server

    scratch = dataclasses.replace(
        spec, selector_kw=dict(BF16_KW, incremental=False))
    server2, _ = build(scratch, device=dev)
    kbuild.reset_launches()
    hist2 = server2.run()
    torch.cuda.synchronize()
    launches2, variants2 = dict(kbuild.launches), _variants()
    require("hics_bf16: pairwise was not launched in bf16",
            variants2["pairwise"]["operands"]["bf16"] > 0)
    require("hics_bf16: pairwise was launched in f32",
            variants2["pairwise"]["operands"]["f32"] == 0)
    emit({"phase": "hics_bf16", "selector_kw": BF16_KW, "rounds": ROUNDS,
          "seconds": seconds, "rounds_per_s": hist["rounds_per_s"],
          "wall_s": hist["wall_s"], "round_split": split,
          "launches": launches, "launches_by_variant": variants,
          "selected": hist["selected"], "train_loss": hist["train_loss"],
          "test_acc": hist["test_acc"], "max_abs_err": errs,
          "select_vs_plain": select,
          "from_scratch": {"launches": launches2,
                           "launches_by_variant": variants2,
                           "selected": hist2["selected"],
                           "same_participants_as_incremental":
                               hist2["selected"] == hist["selected"]}})
    records["hics-bf16-scratch"] = host_record(hist2)
    return variants, variants2, records


# ---------------------------------------------------------------------------
# the paper's five baselines: 14 rounds each of the slice's spec
# ---------------------------------------------------------------------------

BASELINES = [("random", "random", None), ("pow-d", "pow-d", None),
             ("cs", "cs", None), ("divfl", "divfl", None),
             ("divfl-selected", "divfl", {"refresh": "selected"}),
             ("fedcor", "fedcor", None)]
#: the cached selectors' distance, by run
CACHE_METRIC = {"cs": "cosine", "divfl-selected": "l2"}
#: rounds over which DivFL's ideal mode picks the CPU run's clients,
#: free-running: its features are a one-epoch update of all 50 clients,
#: which the card's and the CPU's summation orders part by up to ~30% of
#: the largest coordinate by round 2, where two of its quantized greedy
#: gains are 7 quanta apart (measured on an H100; PERF.md)
DIVFL_IDEAL_CARD_HORIZON = 2
#: the rounds each baseline run is held to the CPU in, fewer than
#: CPU_ROUNDS to keep the whole script in its time (3 before phase
#: ``sharded`` joined it)
BASELINE_CPU_ROUNDS = 1


def feature_cache_check(server, metric: str, dev) -> dict:
    """The cache on the run's final features, its pending rows refreshed
    as the next select would, against the plain version built from
    scratch on the same buffer: bit-symmetric, within tolerance."""
    st = server.state
    dist, stats = ops.cached_feature_step(st.feats, st.dist_cache,
                                          st.row_stats, st.stale_ids,
                                          metric, device=dev)
    n = st.feats.shape[0]
    plain, plain_stats = ref.cached_feature_step_ref(
        st.feats, torch.zeros(n, n, device=dev),
        torch.zeros(n, 2, device=dev), torch.arange(n, device=dev), metric)
    atol = 1e-5 if metric == "cosine" else 1e-5 * float(
        plain_stats[:, 0].max())
    tag = f"baselines: {metric} cache"
    require(tag + " not bit-symmetric", bool(torch.equal(dist, dist.T)))
    require(tag + ": diagonal not zero", bool((dist.diagonal() == 0).all()))
    return {"max_abs_err": check(tag + " vs plain from scratch", dist,
                                 plain, atol, 1e-5),
            "atol": atol,
            "norm_max_abs_err": check(tag + " norms", stats[:, 0],
                                      plain_stats[:, 0], 1e-5, 1e-5),
            "bit_symmetric": bool(torch.equal(dist, dist.T))}


def baseline_select_vs_plain(server, label: str, selector: str,
                             kw) -> dict:
    """One more select on the run's final state, on the card and by the
    plain select on the CPU with the same noise.  The ids must be
    identical, except for DivFL, whose agreement is counted and, where
    the two differ, the quantized gains of the first differing greedy
    step are printed."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    kw = dict(kw or {})
    kw.setdefault("feat_dim", int(flatten_params(server.params).numel()))
    plain = make_functional(
        selector, device="cpu", num_clients=SPEC.num_clients,
        num_select=SPEC.num_select, total_rounds=ROUNDS,
        weights=server.mask.sum(dim=1).cpu().numpy(), **kw)
    cpu_state = _cpu(server.state)
    ids_p, _ = plain.select(cpu_state, t, _cpu(draws.select))
    card, cpu = ids.tolist(), ids_p.tolist()
    out = {"card": card, "plain": cpu,
           "agree": sum(a == b for a, b in zip(card, cpu))}
    if selector != "divfl":
        require(f"baselines {label}: select differs from the plain select",
                card == cpu)
    elif card != cpu:
        out["first_differing_step"] = _divfl_gaps(server, cpu_state,
                                                  card, cpu)
    return out


def _divfl_gaps(server, cpu_state, card, cpu) -> dict:
    """DivFL's quantized gains of the card's and the CPU's picks at the
    first greedy step where they differ, each side on its own distances
    (the refreshed cache, or the from-scratch matrix of ideal mode)."""
    def dists(state, device):
        if state.dist_cache.numel():
            return ops.cached_feature_step(
                state.feats, state.dist_cache, state.row_stats,
                state.stale_ids, "l2", device=device)[0]
        return _l2_scratch(state.feats)

    gains_card, gains_cpu = [], []
    facility_location(dists(server.state, server.device), SPEC.num_select,
                      1e-5, gains_card)
    facility_location(dists(cpu_state, "cpu"), SPEC.num_select, 1e-5,
                      gains_cpu)
    i = next(j for j, (a, b) in enumerate(zip(card, cpu)) if a != b)
    return {"step": i, "ids": [card[i], cpu[i]],
            "card_gains": [float(gains_card[i][card[i]]),
                           float(gains_card[i][cpu[i]])],
            "plain_gains": [float(gains_cpu[i][card[i]]),
                            float(gains_cpu[i][cpu[i]])]}


def baseline_run(label: str, selector: str, kw, dev) -> dict:
    spec = dataclasses.replace(SPEC, selector=selector, selector_kw=kw)
    server, _ = build(spec, device=dev)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    epilogues = dict(kbuild.variant_launches["gram_update"]["epilogue"])
    require(f"baselines {label}: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require(f"baselines {label}: bad test accuracy",
            all(0.0 <= a <= 1.0 for a in hist["test_acc"]))
    require(f"baselines {label}: participants not distinct",
            all(len(set(s)) == SPEC.num_select for s in hist["selected"]))
    metric = CACHE_METRIC.get(label)
    if metric:
        require(f"baselines {label}: the {metric} strip was not launched",
                epilogues[metric] > 0)
    out = {"run": label, "selector": selector, "selector_kw": kw,
           "rounds": ROUNDS, "seconds": seconds,
           "rounds_per_s": hist["rounds_per_s"], "wall_s": hist["wall_s"],
           "round_split": round_split(server),
           "launches": launches, "gram_update_epilogues": epilogues,
           "selected": hist["selected"], "train_loss": hist["train_loss"],
           "test_acc": hist["test_acc"],
           "vs_cpu": first_rounds_vs_cpu(
               spec, dev, hist, f"baselines {label}",
               min(DIVFL_IDEAL_CARD_HORIZON if label == "divfl" else
                   CPU_ROUNDS, BASELINE_CPU_ROUNDS),
               select_rounds=BASELINE_CPU_ROUNDS,
               cpu_rounds=BASELINE_CPU_ROUNDS)}
    if metric:
        out["cache_vs_plain"] = feature_cache_check(server, metric, dev)
    out["select_vs_plain"] = baseline_select_vs_plain(server, label,
                                                      selector, kw)
    return out, host_record(hist, server.state)


def baselines_phase(dev):
    """Each baseline run with the launch counts set to 0 just before it
    and read just after; returns the epilogue counts of the cs and
    divfl-selected runs and every run's :func:`host_record`."""
    t0 = time.perf_counter()
    runs, records = [], {}
    for label, sel, kw in BASELINES:
        out, records[label] = baseline_run(label, sel, kw, dev)
        runs.append(out)
    emit({"phase": "baselines", "runs": runs,
          "seconds": time.perf_counter() - t0})
    by_run = {r["run"]: r["gram_update_epilogues"] for r in runs}
    return {"cosine": by_run["cs"]["cosine"],
            "l2": by_run["divfl-selected"]["l2"]}, records


# ---------------------------------------------------------------------------
# the scanned round driver: one CUDA graph a round, every selector
# ---------------------------------------------------------------------------

#: the nine host-loop runs of the earlier phases, by label: (selector,
#: selector_kw)
GRAPH_RUNS = [("hics", "hics", SELECTOR_KW),
              ("hics-scratch", "hics", dict(SELECTOR_KW, incremental=False)),
              ("hics-bf16", "hics", BF16_KW),
              ("hics-bf16-scratch", "hics",
               dict(BF16_KW, incremental=False)),
              *BASELINES]


def index_syncs(dev) -> dict:
    """Whether each way of reading one element by a 0-d device index
    synchronizes with the host: the forms the selectors used before
    (``d[i, j]``, ``d[i]``, ``d[:, j]``) and the gathers that replace
    them, each under ``torch.cuda.set_sync_debug_mode("error")``, where
    a synchronizing call raises."""
    d = torch.rand(50, 50, device=dev)
    flat = torch.argmin(d)
    i, j = flat // 50, flat % 50
    forms = {"d[i, j]": lambda: d[i, j], "d[i]": lambda: d[i],
             "d[:, j]": lambda: d[:, j],
             "index_select": lambda: d.index_select(0, i[None]),
             "flat index_select": lambda: d.view(-1).index_select(
                 0, flat[None])}
    out = {}
    torch.cuda.synchronize()
    for name, fn in forms.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            out[name] = False
        except RuntimeError:
            out[name] = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for name in ("index_select", "flat index_select"):
        require(f"graph_rounds: {name} synchronizes", not out[name])
    return out


def round_step_syncs(server):
    """One eager round of the server's round step from its initial
    state under ``set_sync_debug_mode("error")``: None, or the error of
    the first call that synchronized.  The server's generator is put
    back, so the run that follows draws what it would have."""
    gen_state = server.gen.get_state()
    rd = server.draw_round(0)
    server.gen.set_state(gen_state)
    carry = server._initial_carry()
    step = server._make_round_step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(carry, rd)
        return None
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def replay_ms(round_graph, iters: int = 10) -> float:
    """Device ms of one replay of a captured ``RoundGraph`` (CUDA events
    over ``iters`` back-to-back replays after two warm ones; each
    replay advances the graph's own copy of the state)."""
    graph = round_graph.graph
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _union_us(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def busy_shares(server) -> dict:
    """The device's busy share of each segment of one more run through
    the server's graph: under ``torch.profiler`` (CPU and CUDA
    activity), the union of the CUDA spans (kernels, copies) inside each
    ``fed/scan_segment`` range over the range's length, the draws and
    the one read of the outputs included."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        server.run()
        torch.cuda.synchronize()
    events = prof.events()
    segs = [(e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith("fed/scan_segment")
            and e.device_type == DeviceType.CPU]
    # device spans: kernels and copies, not the ranges' own annotations
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith("fed/")
             and not getattr(e, "is_user_annotation", False)]
    out, by_name = [], {}
    for a, b in sorted(segs):
        inside = [(max(x, a), min(y, b)) for x, y, _ in spans
                  if y > a and x < b]
        out.append({"segment_ms": (b - a) / 1e3,
                    "busy_ms": _union_us(inside) / 1e3,
                    "busy_share": _union_us(inside) / (b - a)
                    if b > a else None, "cuda_spans": len(inside)})
        for x, y, name in spans:
            if a <= x < b:
                tot = by_name.setdefault(name[:80], [0.0, 0])
                tot[0] += (y - x) / 1e3
                tot[1] += 1
    rounds = sum(server.history["segment_rounds"][-len(segs):]) or 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return {"method": "torch.profiler: union of CUDA spans (kernels, "
                      "copies) inside each CPU fed/scan_segment range / "
                      "the range",
            "segments": out,
            "device_ms_per_round": sum(v[0] for v in by_name.values())
            / rounds,
            "kernels_per_round": sum(v[1] for v in by_name.values())
            / rounds,
            "top_per_round": [{"name": k, "ms": v[0] / rounds,
                               "count": v[1] / rounds} for k, v in top]}


def host_busy_share(spec, dev) -> dict:
    """The device's busy share of a host-loop run of ``spec``: under
    ``torch.profiler`` with CUDA activity only, the union of the CUDA
    spans over the host-clock wall of ``run()`` (tracing adds a few µs
    of host time to each launch, so this reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    server, _ = build(spec, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        server.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    busy = _union_us(spans) / 1e6
    return {"method": "torch.profiler (CUDA only): union of CUDA spans "
                      "over the run's host wall",
            "wall_s": wall, "busy_s": busy,
            "busy_share": busy / wall if spans else None,
            "cuda_spans": len(spans)}


def graph_run(label: str, selector: str, kw, host: dict, dev,
              spec=None) -> dict:
    """The run of ``host`` again with ``jit_rounds=True``: no
    synchronizing call in an eager round of its round step, one
    capture, the host loop's participants (DivFL's ideal mode to
    ``DIVFL_IDEAL_CARD_HORIZON``), an incremental HiCS cache bit-equal
    to the host run's and, where the host run kept per-client extras,
    its train loss and extras bit-equal too, its launches on the graph
    path (counts set to 0 just before the run, read just after), then a
    second run through the same graph for rounds/s without the capture,
    and the device time of a replay.  ``spec`` (default the slice's
    with ``selector`` and ``kw``) is the host run's."""
    spec = dataclasses.replace(
        spec or dataclasses.replace(SPEC, selector=selector,
                                    selector_kw=kw), jit_rounds=True)
    server, _ = build(spec, device=dev)
    tag = f"graph_rounds {label}"
    syncs = round_step_syncs(server)
    require(f"{tag}: the round step synchronized: {syncs}", syncs is None)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, variants = dict(kbuild.launches), _variants()
    selected = hist["selected"][:ROUNDS]
    agree = next((t for t, (a, b) in enumerate(zip(selected,
                                                   host["selected"]))
                  if a != b), ROUNDS)
    horizon = DIVFL_IDEAL_CARD_HORIZON if label == "divfl" else ROUNDS
    require(f"{tag}: {server.captures} captures", server.captures == 1)
    require(f"{tag}: participants differ from the host loop's from round "
            f"{agree}", agree >= horizon)
    require(f"{tag}: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require(f"{tag}: bad test accuracy",
            all(0.0 <= a <= 1.0 for a in hist["test_acc"]))
    out = {"run": label, "selector": selector, "selector_kw": kw,
           "rounds": ROUNDS, "seconds": seconds, "syncs": syncs,
           "captures": server.captures,
           "segment_rounds": list(hist["segment_rounds"]),
           "segment_wall_s": list(hist["segment_wall_s"]),
           "rounds_per_s": hist["rounds_per_s"],
           "rounds_per_s_after_capture": sum(hist["segment_rounds"][1:])
           / sum(hist["segment_wall_s"][1:]),
           "host_rounds_per_s": host["rounds_per_s"],
           "same_participants_rounds": agree,
           "train_loss_max_abs_diff": float(np.max(np.abs(
               np.asarray(hist["train_loss"]) - host["train_loss"]))),
           "launches": launches, "launches_by_variant": variants,
           "captured_launches": server._graph.launches["launches"]}
    if "cache" in host:
        st = server.state
        same = {"dist_cache": bool(torch.equal(st.dist_cache,
                                               host["cache"][0])),
                "row_stats": bool(torch.equal(st.row_stats,
                                              host["cache"][1]))}
        require(f"{tag}: cache not bit-equal to the host run's {same}",
                all(same.values()))
        out["cache_bit_equal"] = same
    if "extras" in host:
        same_loss = hist["train_loss"][:ROUNDS] == host["train_loss"]
        same_extras = all(torch.equal(a, b) for a, b in zip(
            _leaves(server.extras), _leaves(host["extras"])))
        require(f"{tag}: train loss not bit-equal to the host run's",
                same_loss)
        require(f"{tag}: extras not bit-equal to the host run's",
                same_extras)
        out["train_loss_bit_equal"] = same_loss
        out["extras_bit_equal"] = same_extras
    server.run()                               # the same graph again
    torch.cuda.synchronize()
    require(f"{tag}: a second run captured again", server.captures == 1)
    second = server.history
    out["second_run_rounds_per_s"] = (sum(second["segment_rounds"][3:])
                                      / sum(second["segment_wall_s"][3:]))
    out["replay_ms"] = replay_ms(server._graph)
    if label == "hics":
        out["busy"] = busy_shares(server)
        out["host_busy"] = host_busy_share(
            dataclasses.replace(spec, jit_rounds=False), dev)
    return out


def graph_rounds_phase(dev, host_runs: dict):
    """Each of :data:`GRAPH_RUNS` through the scanned driver, held to
    the earlier phases' host-loop run (made here when the phase runs
    alone).  Returns the launches on the graph path, by kernel and by
    variant, summed over the runs."""
    t0 = time.perf_counter()
    probe = index_syncs(dev)
    runs = []
    for label, sel, kw in GRAPH_RUNS:
        host = host_runs.get(label)
        if host is None:
            spec = dataclasses.replace(SPEC, selector=sel, selector_kw=kw)
            server, _ = build(spec, device=dev)
            host = host_record(server.run(), server.state)
            del server
        runs.append(graph_run(label, sel, kw, host, dev))
        torch.cuda.empty_cache()
    totals = {name: sum(r["launches"][name] for r in runs)
              for name in kbuild.launches}
    by_variant = {name: {axis: {v: sum(r["launches_by_variant"][name][axis][v]
                                       for r in runs) for v in counts}
                         for axis, counts in axes.items()}
                  for name, axes in kbuild.variant_launches.items()}
    for name in ("fused_stats", "gram_update", "pairwise"):
        require(f"graph_rounds: {name} was not launched on the graph path",
                totals[name] > 0)
    for epi, n in by_variant["gram_update"]["epilogue"].items():
        require(f"graph_rounds: no {epi} strip on the graph path", n > 0)
    for name in ("gram_update", "pairwise"):
        for mode, n in by_variant[name]["operands"].items():
            require(f"graph_rounds: no {mode} {name} on the graph path",
                    n > 0)
    emit({"phase": "graph_rounds", "index_syncs": probe, "runs": runs,
          "launches": totals, "launches_by_variant": by_variant,
          "seconds": time.perf_counter() - t0})
    return totals, by_variant


# ---------------------------------------------------------------------------
# the paper's other local updates and HiCS's other linkages, 14 rounds each
# ---------------------------------------------------------------------------

def _local(algo="fedavg", optimizer="sgd"):
    return LocalSpec(algo=algo, optimizer=optimizer, lr=0.05, epochs=2,
                     batch_size=32, mu=0.1, moon_tau=0.5)


#: phase local_algos' runs, by label: the slice's spec with another
#: local update or another clustering
LOCAL_RUNS = [
    ("fedprox", dict(local=_local("fedprox"))),
    ("feddyn", dict(local=_local("feddyn"))),
    ("moon", dict(local=_local("moon"))),
    ("fedavg-momentum", dict(local=_local(optimizer="momentum"))),
    ("fedprox-adam", dict(local=_local("fedprox", "adam"))),
    ("hics-average-m10", dict(selector_kw=dict(
        SELECTOR_KW, linkage="average", num_clusters=10))),
    ("hics-complete-m3-scratch", dict(selector_kw=dict(
        SELECTOR_KW, linkage="complete", num_clusters=3,
        incremental=False))),
    ("hics-single", dict(selector_kw=dict(SELECTOR_KW, linkage="single"))),
]
#: the runs with per-client extras, run again through the graph driver
LOCAL_GRAPH_RUNS = ("feddyn", "moon")
#: the rounds each run is held to the CPU in, fewer than the other
#: phases' CPU_ROUNDS to keep the whole script in its time (2 before
#: phase ``sharded`` joined it)
LOCAL_CPU_ROUNDS = 1


def local_run(label: str, changes: dict, dev):
    """One run of :data:`LOCAL_RUNS` with the launch counts set to 0
    just before it and read just after: its kernels launched (the strip
    or, from scratch, pairwise, and fused_stats), finite loss, distinct
    participants, rounds/s and the round split, its first rounds against
    the CPU (for the linkage runs every select of the 14 rounds against
    the plain select on the card's state), and one more select on the
    final state against the plain one.  Returns its output and its
    :func:`host_record`."""
    spec = dataclasses.replace(SPEC, **changes)
    tag = f"local_algos {label}"
    server, _ = build(spec, device=dev)
    kbuild.reset_launches()
    t0 = time.perf_counter()
    hist = server.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    kw = spec.selector_kw
    incremental = kw.get("incremental", True)
    refresh = "gram_update" if incremental else "pairwise"
    require(f"{tag}: {refresh} was not launched", launches[refresh] > 0)
    require(f"{tag}: fused_stats launches differ from {refresh}'s",
            launches["fused_stats"] == launches[refresh])
    require(f"{tag}: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require(f"{tag}: bad test accuracy",
            all(0.0 <= a <= 1.0 for a in hist["test_acc"]))
    require(f"{tag}: participants not distinct",
            all(len(set(ids)) == SPEC.num_select for ids in hist["selected"]))
    clustering = "linkage" in kw
    out = {"run": label, "algo": spec.local.algo,
           "optimizer": spec.local.optimizer, "selector_kw": kw,
           "rounds": ROUNDS, "seconds": seconds,
           "rounds_per_s": hist["rounds_per_s"], "wall_s": hist["wall_s"],
           "round_split": round_split(server), "launches": launches,
           "selected": hist["selected"], "train_loss": hist["train_loss"],
           "test_acc": hist["test_acc"],
           "vs_cpu": first_rounds_vs_cpu(
               spec, dev, hist, tag, horizon=LOCAL_CPU_ROUNDS,
               select_rounds=ROUNDS if clustering else LOCAL_CPU_ROUNDS,
               one_step=not clustering and spec.local.optimizer != "adam",
               cpu_rounds=LOCAL_CPU_ROUNDS),
           "select_vs_plain": select_vs_plain(server, incremental, tag, kw)}
    if server.extras:
        out["extras_max_abs"] = {key: max(float(a.abs().max())
                                          for a in _leaves(tree))
                                 for key, tree in server.extras.items()}
    return out, host_record(hist, server.state, server.extras), spec


def local_algos_phase(dev):
    """Each of :data:`LOCAL_RUNS`, then the FedDyn and Moon runs again
    through the scanned driver, held to their host runs bit for bit.
    Returns the launches summed over the host runs and over the graph
    runs."""
    t0 = time.perf_counter()
    runs, graph = [], []
    for label, changes in LOCAL_RUNS:
        out, record, spec = local_run(label, changes, dev)
        runs.append(out)
        if label in LOCAL_GRAPH_RUNS:
            graph.append(graph_run(label, "hics", spec.selector_kw, record,
                                   dev, spec=spec))
        del record
        torch.cuda.empty_cache()
    totals = {name: sum(r["launches"][name] for r in runs)
              for name in kbuild.launches}
    graph_totals = {name: sum(r["launches"][name] for r in graph)
                    for name in kbuild.launches}
    emit({"phase": "local_algos", "card": CARD, "runs": runs,
          "graph_runs": graph, "launches": totals,
          "launches_graph": graph_totals,
          "seconds": time.perf_counter() - t0})
    return totals, graph_totals


# ---------------------------------------------------------------------------
# serving: the two LM kernels, qwen2.5-3b at full width, and parity
# ---------------------------------------------------------------------------

T_ENT = 0.0025
SERVE_ARGV = ["--arch", "qwen2.5-3b", "--full", "--batch", "4",
              "--prompt-len", "64", "--gen", "32", "--seed", "0"]
PARITY_LAYERS = 2
PARITY_PREFILL_TOL = 1e-3
PARITY_DECODE_TOL = 5e-2


def entropy_case(n, c, dtype, dev, scale=0.02, timed=False, splits=None):
    """hetero_entropy on (n, c) at T = 0.0025 against both plain
    versions: the split one at the kernel's P (``ref.entropy_split_ref``,
    default the plan for this card) and the unsplit one; where P > 1 the
    kernel also runs unsplit (P = 1).  5e-5 absolute and relative for
    f32, 5e-3 for bf16; 0.05 absolute at magnitude 500 (f32 rounding of
    u - m at |u| ~ 2e5).  Two calls must agree bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(n + c)
    x = (torch.randn((n, c), generator=gen, device=dev) * scale).to(dtype)
    p = splits or stats_splits(n, c, kbuild.sm_count(dev.index or 0))
    got, again = entropy_rows(x, T_ENT, p), entropy_rows(x, T_ENT, p)
    want = ref.entropy_ref(x, T_ENT)
    want_split = ref.entropy_split_ref(x, T_ENT, p)
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    tag = f"hetero_entropy({n},{c},{dt},scale={scale},P={p})"
    if scale >= 100:
        tol = (0.05, 0.0)
    else:
        tol = (5e-5, 5e-5) if dtype == torch.float32 else (5e-3, 5e-3)
    err = max(check(tag, got, want, *tol),
              check(tag + ".split", got, want_split, *tol))
    bit_equal = torch.equal(got, again)
    require(f"{tag}: two calls on the same input differ", bit_equal)
    out = {"case": tag, "splits": p, "max_abs_err": err,
           "bit_equal": bit_equal}
    if p > 1:
        out["unsplit_max_abs_err"] = check(
            tag + " unsplit (P = 1)", entropy_rows(x, T_ENT, 1), want, *tol)
    if timed:
        elt = x.element_size()
        copies = rotating_copies(x)
        kern = [lambda x=x: entropy_rows(x, T_ENT) for x in copies]
        out["ms"] = time_ms_rotating(kern)
        out["plain_ms"] = time_ms_rotating(
            [lambda x=x: ref.entropy_ref(x, T_ENT) for x in copies])
        out["device_ms"] = device_ms(kern)
        # read x once, write n floats; per element a divide, a max, a
        # subtract, an exp, an add and an fma
        out["bound_ms"], out["bound_by"] = bound(elt * n * c + 4 * n,
                                                 6 * n * c)
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        out["library_ms"] = None   # no single PyTorch call computes it
    return out


def decode_case(b, h, kv, dh, s, kv_dtype, dev, lengths=None, timed=False):
    """decode_attention on q (b, h, dh) f32 and a (b, s, kv, dh) cache
    against its plain versions: the split one at the kernel's own split
    plan (``ref.decode_attention_split_ref``) and the unsplit one (the
    reference for the result; rows of length 0 left out, where it is
    NaN and the kernel must return exactly 0).  5e-5 absolute and
    relative for f32 and bf16 K/V alike (both sides widen the same bf16
    bits exactly and compute in f32, so only the order of the sums
    differs); ragged lengths 1e-4 absolute, and a length-1 row equal to
    v[:, 0] of its KV head.  Two calls on the same input must agree bit
    for bit (the splits merge in a fixed order)."""
    gen = torch.Generator(device=dev).manual_seed(b * s + h + dh)
    q = torch.randn((b, h, dh), generator=gen, device=dev)
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev,
                    dtype=kv_dtype)
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev,
                    dtype=kv_dtype)
    lens_list = lengths or [s] * b
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    scale = dh ** -0.5
    splits = kernel_splits(q, k)
    plan = decode_plan(h // kv, dh, k.element_size())
    got = decode_attention_kernel(q, k, v, lens, scale)
    again = decode_attention_kernel(q, k, v, lens, scale)
    want = ref.decode_attention_ref(q, k, v, lens)
    want_split = ref.decode_attention_split_ref(q, k, v, lens, splits,
                                                gc=plan.gc)
    dt = "bf16" if kv_dtype == torch.bfloat16 else "f32"
    tag = f"decode_attention(B{b},H{h},KV{kv},dh{dh},S{s},{dt}" + (
        f",lengths={lengths})" if lengths else ")")
    tol = (1e-4, 0.0) if lengths else (5e-5, 5e-5)
    live = lens > 0
    err = max(check(tag, got[live], want[live], *tol),
              check(tag + ".split", got, want_split, *tol))
    g = h // kv
    for i, n in enumerate(lens_list):
        if n == 1:
            first = v[i, 0].float()[:, None, :].expand(kv, g, dh)
            err = max(err, check(tag + f".row{i}=v0",
                                 got[i].reshape(kv, g, dh), first, 1e-4))
        if n == 0:
            require(f"{tag}.row{i}: length 0 is not 0", not got[i].any())
    bit_equal = torch.equal(got, again)
    require(f"{tag}: two calls on the same input differ", bit_equal)
    out = {"case": tag, "splits": splits, "max_abs_err": err,
           "bit_equal": bit_equal,
           "plan": {key: getattr(plan, key) for key in (
               "gc", "chunks", "gp", "e", "stages", "fixed", "copy_bytes")}}
    if timed:
        call = lambda k=k, v=v: decode_attention_kernel(q, k, v, lens, scale)
        out["ms"] = time_ms(call, 20)
        # the kernels' own spans; a cache under 60 MB cycled through
        # copies past the 50 MB L2, as the serve loop finds it
        copies = [(k, v)] + [(k.clone(), v.clone()) for _ in range(
            int(np.ceil(60e6 / (2 * k.nbytes))) if 2 * k.nbytes < 60e6
            else 0)]
        out["device_ms"] = device_ms([lambda kc=kc, vc=vc: call(kc, vc)
                                      for kc, vc in copies])
        del copies
        out["plain_ms"] = time_ms(
            lambda: ref.decode_attention_ref(q, k, v, lens), 5)
        valid = sum(min(n, s) for n in lens_list)
        # q and out once, the valid K/V rows once; per valid position
        # and query head a dh-long dot product and a dh-long p·v, plus
        # ~5 operations of softmax
        out["bound_ms"], out["bound_by"] = bound(
            8 * b * h * dh + 4 * b + 2 * valid * kv * dh * k.element_size(),
            valid * h * (4 * dh + 5))
        out["bound_share"] = out["bound_ms"] / out["device_ms"]
        # at decode_32k in f32 SDPA's math backend would expand K/V to
        # all H heads (68 GB): only a fused backend is timed there
        out.update(library_case(q, k, v, lens, want, kv_dtype,
                                fused_only=k.nbytes > 2e9
                                and kv_dtype == torch.float32))
    return out


#: (B, H, KV, dh, S) of each registered row width's compile-time path
#: timed against the runtime width on the same inputs: qwen2.5-3b's
#: heads at dh 128 (G 8), granite-moe's at dh 64 (G 2), zamba2's at dh
#: 112 (G 1), gemma-7b's at dh 256 (G 1), each about 1 GB of bf16 K/V
#: (2 of f32), so that a call reads device memory for 0.3-0.6 ms and
#: the kernel, not the host, sets its time
WIDTH_PATH_CASES = ((32, 16, 2, 128, 32768), (16, 16, 8, 64, 32768),
                    (8, 32, 32, 112, 8192), (8, 16, 16, 256, 8192))


def decode_width_paths(dev, rounds: int = 4) -> list:
    """The decode kernel at each registered width with its compile-time
    row width (the plan's) and with the runtime width forced (the plan
    with ``fixed`` off), on the same inputs: their outputs compared, and
    each timed by CUDA events (:func:`time_ms`, 10 calls) in
    alternation, ``rounds`` times each, so that both see the same card
    state."""
    out = []
    for b, h, kv, dh, s in WIDTH_PATH_CASES:
        for dt in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=dev).manual_seed(dh * 7 + b)
            q = torch.randn((b, h, dh), generator=gen, device=dev)
            k, v = (torch.randn((b, s, kv, dh), generator=gen,
                                device=dev).to(dt) for _ in "kv")
            lens = torch.full((b,), s, dtype=torch.int32, device=dev)
            fixed = decode_plan(h // kv, dh, k.element_size())
            runtime = dataclasses.replace(fixed, fixed=False)
            a = decode_attention_kernel(q, k, v, lens, dh ** -0.5, fixed)
            r = decode_attention_kernel(q, k, v, lens, dh ** -0.5, runtime)
            err = float((a - r).abs().max())
            tag = (f"decode width paths (B{b},H{h},KV{kv},dh{dh},S{s},"
                   f"{'bf16' if dt == torch.bfloat16 else 'f32'})")
            require(f"{tag}: the runtime width differs by {err}",
                    err <= 5e-5)
            times = {"fixed": [], "runtime": []}
            for _ in range(rounds):
                for name, plan in (("fixed", fixed), ("runtime", runtime)):
                    times[name].append(time_ms(
                        lambda plan=plan: decode_attention_kernel(
                            q, k, v, lens, dh ** -0.5, plan), 10))
            fixed_ms = float(np.median(times["fixed"]))
            runtime_ms = float(np.median(times["runtime"]))
            out.append({"case": tag, "fixed_ms": times["fixed"],
                        "runtime_ms": times["runtime"],
                        "runtime_over_fixed": runtime_ms / fixed_ms,
                        "bit_equal": bool(torch.equal(a, r)),
                        "max_abs_err": err})
            del k, v, a, r
            torch.cuda.empty_cache()
    return out


def library_case(q, k, v, lens, want, dtype, fused_only=False) -> dict:
    """One ``scaled_dot_product_attention(..., enable_gqa=True)`` call
    with a length mask, all operands in ``dtype``, the cache already in
    its (B, KV, S, dh) layout: the library yardstick, used nowhere in
    the port.  ``fused_only`` leaves the math backend out; if no fused
    backend takes the call, ``library_ms`` is null with the reason."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    s = k.shape[1]
    q4 = q.to(dtype)[:, :, None, :]
    kt = k.to(dtype).transpose(1, 2).contiguous()
    vt = v.to(dtype).transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True)

    def call():
        if not fused_only:
            return sdpa()
        with sdpa_kernel(fused):
            return sdpa()

    try:
        err = float((call()[:, :, 0].float() - want).abs().max())
    except RuntimeError as e:
        return {"library_ms": None,
                "library_note": f"no fused SDPA backend: {str(e)[:160]}"}
    return {"library_ms": time_ms(call, 20), "library_max_abs_err": err}


def serve_kernels_phase(dev):
    """Each LM kernel against its plain version; the entropy kernel's
    own path (``ops.estimate_entropies``) with the counts set to 0."""
    t0 = time.perf_counter()
    entropy = [entropy_case(5, 10, torch.float32, dev),
               entropy_case(5, 10, torch.bfloat16, dev),
               entropy_case(64, 151_936, torch.float32, dev, timed=True),
               entropy_case(64, 151_936, torch.bfloat16, dev, timed=True),
               entropy_case(4, 600, torch.float32, dev, scale=500.0),
               entropy_case(4, 600, torch.float32, dev, scale=500.0,
                            splits=3)]
    # P forced past the plan: C not a multiple of 4 or 8 (rows at 4- and
    # 2-byte offsets), empty slices (C < P x 32), and the K = 2 rows
    for dt in (torch.float32, torch.bfloat16):
        for splits in (3, 8):
            entropy.append(entropy_case(17, 4099, dt, dev, splits=splits))
        entropy.append(entropy_case(3, 40, dt, dev, splits=8))
        entropy.append(entropy_case(2, 151_936, dt, dev))
    cfg = get_model("qwen2.5-3b").cfg
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim()
    decode = [decode_case(4, h, kv, dh, 512, dt, dev, timed=True)
              for dt in (torch.float32, torch.bfloat16)]
    for dt in (torch.bfloat16, torch.float32):
        decode.append(decode_case(3, h, kv, dh, 512, dt, dev,
                                  lengths=[1, 512, 259]))
        # whole splits past the length (P = 8 of 64 positions), a
        # length-0 row, and one split (P = 1: the block writes the output)
        decode.append(decode_case(4, h, kv, dh, 512, dt, dev,
                                  lengths=[1, 64, 65, 512]))
        decode.append(decode_case(3, h, kv, dh, 512, dt, dev,
                                  lengths=[0, 300, 512]))
        decode.append(decode_case(3, h, kv, dh, 96, dt, dev,
                                  lengths=[1, 50, 96]))
        # other group sizes and head widths the kernel compiles for
        for g in (2, 8):
            for width in (64, 128):
                decode.append(decode_case(4, 2 * g, 2, width, 512, dt, dev))
    # dh 256: the reference's own case (B2 H4 KV4 S128, G 1), gemma's
    # serve shape (B4 H16 KV16 S512, timed), G 4 (GP 4, the widest at
    # dh 256) and ragged lengths with a length-0 row
    for dt in (torch.float32, torch.bfloat16):
        decode.append(decode_case(2, 4, 4, 256, 128, dt, dev))
        decode.append(decode_case(4, 16, 16, 256, 512, dt, dev, timed=True))
        decode.append(decode_case(4, 8, 2, 256, 512, dt, dev))
        decode.append(decode_case(3, 16, 16, 256, 512, dt, dev,
                                  lengths=[0, 1, 300]))
    # dh 112 (E = 4 on 28 lanes): zamba2's serve shape (B4 H32 KV32
    # S512, G 1, timed), G 2 and 8 (GP 8, the widest at dh 112), ragged
    # lengths with a length-0 row, and one split (S 96)
    for dt in (torch.float32, torch.bfloat16):
        decode.append(decode_case(4, 32, 32, 112, 512, dt, dev, timed=True))
        for g in (2, 8):
            decode.append(decode_case(4, 2 * g, 2, 112, 512, dt, dev))
        decode.append(decode_case(3, 32, 32, 112, 512, dt, dev,
                                  lengths=[0, 1, 300]))
        decode.append(decode_case(3, 4, 2, 112, 96, dt, dev,
                                  lengths=[1, 50, 96]))
    # the shapes no registered config has (the runtime row width, the
    # group split into chunks): dh 80, 96, 192 and 512 at G 4, with
    # ragged lengths; dh 8, 40, 264 (the last lane 8 of E 16) and 320
    # (2 f32 stages); G 16 at dh 128 (two chunks of 8), G 24 at dh 64
    # (two of 12), G 3 at dh 512 (of 2 and 1); timed at B4 S512 beside
    # SDPA: dh 96 G 4, dh 512 G 2, G 16 at dh 128
    for dt in (torch.float32, torch.bfloat16):
        for width in (80, 96, 192, 512):
            decode.append(decode_case(3, 8, 2, width, 512, dt, dev,
                                      lengths=[0, 1, 300]))
        for width in (8, 40, 264, 320):
            decode.append(decode_case(2, 4, 2, width, 200, dt, dev))
        decode.append(decode_case(2, 32, 2, 128, 512, dt, dev,
                                  lengths=[1, 400]))
        decode.append(decode_case(2, 48, 2, 64, 256, dt, dev))
        decode.append(decode_case(2, 6, 2, 512, 160, dt, dev,
                                  lengths=[33, 160]))
        for shape in ((4, 16, 4, 96), (4, 4, 2, 512), (4, 32, 2, 128)):
            decode.append(decode_case(*shape, 512, dt, dev, timed=True))
    # a dh off the 16-byte rows (ring rows padded to 8 values, 4-byte
    # copies of f32, 2-byte loads of bf16): dh 4, 36, 100,
    # 260 and the odd 1 and 37, G 1 and 8, whole lengths within 5e-5,
    # and ragged lengths with a length-0 row at G 8; timed at dh 100 G 8
    for dt in (torch.float32, torch.bfloat16):
        for width in (4, 36, 100, 260, 1, 37):
            for g in (1, 8):
                decode.append(decode_case(2, 2 * g, 2, width, 200, dt, dev))
            decode.append(decode_case(3, 16, 2, width, 300, dt, dev,
                                      lengths=[0, 1, 300]))
        decode.append(decode_case(4, 16, 2, 100, 512, dt, dev, timed=True))
    d32k = SHAPES["decode_32k"]
    for dt in (torch.float32, torch.bfloat16):   # the bf16 layer last
        decode.append(decode_case(d32k.global_batch, h, kv, dh,
                                  d32k.seq_len, dt, dev, timed=True))
        torch.cuda.empty_cache()

    widths = decode_width_paths(dev)

    x = torch.randn((64, 151_936), device=dev) * 0.02
    kbuild.reset_launches()
    ent = ops.estimate_entropies(x, T_ENT, device=dev)
    torch.cuda.synchronize()
    launches = dict(kbuild.launches)
    require("entropy path: hetero_entropy was not launched",
            launches["hetero_entropy"] > 0)
    require("entropy path: Ĥ not finite or of the wrong shape",
            ent.shape == (64,) and bool(torch.isfinite(ent).all()))
    emit({"phase": "serve_kernels", "hetero_entropy": entropy,
          "decode_attention": decode, "decode_width_paths": widths,
          "entropy_path_launches": launches,
          "seconds": time.perf_counter() - t0})
    return {"hetero_entropy": entropy, "decode_attention": decode}, launches


def decode_bound_ms(params, cfg, batch: int, mean_len: float) -> float:
    """A decode step's byte bound: every weight but the embedding table
    read once (the embedding gives only B rows), plus the K and V of
    the mean valid cache length, over the HBM rate."""
    weights = sum(t.numel() * t.element_size() for t in _leaves(params))
    weights -= params["embed"].numel() * params["embed"].element_size()
    cache = (2 * cfg.num_layers * batch * mean_len * cfg.num_kv_heads
             * cfg.resolved_head_dim() * 2)
    return (weights + cache) / HBM_BYTES_PER_S * 1e3


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def serve_phase(dev):
    """qwen2.5-3b at full width and depth through the serve entry
    point: a cold call, then the counted call with the counts set to 0
    just before it; the flash-decode kernel then on the live bf16 cache
    of the first and last layer."""
    cold = serve.main(SERVE_ARGV)
    cold_times = {k: cold[k] for k in ("init_s", "prefill_ms",
                                       "decode_ms_per_token")}
    del cold
    torch.cuda.empty_cache()
    kbuild.reset_launches()
    res = serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    launches = dict(kbuild.launches)
    require("serve: decode_attention was not launched",
            launches["decode_attention"] > 0)
    cfg, params, tokens = res["cfg"], res["params"], res["tokens"]
    b, gen = tokens.shape
    prompt = int(SERVE_ARGV[SERVE_ARGV.index("--prompt-len") + 1])
    require("serve: tokens of the wrong shape or out of range",
            tokens.shape == (4, 32) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size)
    require(f"serve: kernel check {res['kernel_max_abs_err']} > 5e-5",
            res["kernel_max_abs_err"] <= 5e-5)
    n_params = sum(t.numel() for t in _leaves(params))
    mean_len = prompt + gen / 2
    non_embed = n_params - params["embed"].numel()
    head = params["lm_head"]["w"].numel()
    # prefill: the f32 weights' operations on every prompt token, the
    # head's on the last one, or reading the weights once
    prefill_flops = 2 * (non_embed - head) * b * prompt + 2 * head * b
    prefill_bound = max(prefill_flops / F32_FLOPS_PER_S,
                        4 * non_embed / HBM_BYTES_PER_S) * 1e3

    cache, length = res["cache"], res["length"]
    live = {}
    gq = torch.Generator(device=dev).manual_seed(7)
    for layer in (0, cfg.num_layers - 1):
        k, v = cache["k"][layer], cache["v"][layer]
        q = torch.randn((b, cfg.num_heads, cfg.resolved_head_dim()),
                        generator=gq, device=dev)
        got = ops.gqa_decode_attention(q, k, v, length, device=dev)
        want = ref.decode_attention_ref(q, k, v, length)
        live[f"layer{layer}"] = check(f"serve: live cache layer {layer}",
                                      got, want, 5e-5, 5e-5)
    profile = decode_profile(res, dev)
    profile["device_busy_share"] = (profile["device_ms_per_step"]
                                    / res["decode_ms_per_token"])
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
          "d_model": cfg.d_model, "batch": b, "prompt": prompt,
          "gen": gen, "params": n_params, "init_s": res["init_s"],
          "prefill_ms": res["prefill_ms"],
          "prefill_bound_ms": prefill_bound,
          "decode_ms_per_token": res["decode_ms_per_token"],
          "decode_bound_ms_per_token": decode_bound_ms(params, cfg, b,
                                                       mean_len),
          "cold_call": cold_times,
          "first_request_tokens": tokens[0].tolist(),
          "kernel_check_max_abs_err": res["kernel_max_abs_err"],
          "live_cache_length": length, "live_cache_max_abs_err": live,
          "decode_profile": profile, "launches": launches,
          "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    return res, launches


def decode_profile(res, dev, steps: int = 2) -> dict:
    """Device time of ``steps`` decode steps by ``torch.profiler``: the
    sum of the kernels' own spans, the share in matrix products (cuBLAS
    gemm/gemv kernels) and the kernels a step launches.  The steps
    rewrite the cache's last two slots, after every check has read it;
    the profiler's host cost leaves the device spans as they are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    api = get_model(res["cfg"])
    params, cache = res["params"], res["cache"]
    token = res["tokens"][:, -1:]
    pos0 = cache["k"].shape[2] - steps
    api.decode_step(params, cache, {"token": token, "pos": pos0})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            api.decode_step(params, cache, {"token": token, "pos": pos0 + i})
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    gemm = sum(t for n, t in by_name.items()
               if "gemm" in n.lower() or "gemv" in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": steps, "device_ms_per_step": total / steps / 1e3,
            "matmul_ms_per_step": gemm / steps / 1e3,
            "kernels_per_step": len(kernels) / steps,
            "top_kernels_ms_per_step": {n[:80]: t / steps / 1e3
                                        for n, t in top}}


def serve_parity_phase(res, dev):
    """The same weights cut to the first two layers at full width, on
    the card and in the port's CPU run, both fed the CPU run's greedy
    tokens: prefill logits within 1e-3 (all f32, summed in another
    order), every decode step's within 5e-2 (the bf16 cache: a last-bit
    f32 difference at a bf16 rounding boundary moves a cached entry by
    one bf16 step, 2**-8 relative); greedy agreement counted."""
    cfg = dataclasses.replace(res["cfg"], num_layers=PARITY_LAYERS,
                              name=res["cfg"].name + "-2layers")
    full = res["params"]
    card = dict(full, layers=_map(lambda t: t[:PARITY_LAYERS],
                                  full["layers"]))
    cpu = _map(lambda t: t.cpu(), card)
    api = get_model(cfg)
    b, gen = res["tokens"].shape
    rng = np.random.default_rng(1)
    prompt = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size,
                                                  (b, 64)),
                                     dtype=torch.int32)}
    t0 = time.perf_counter()
    cpu_logits, cpu_tokens = _teacher_forced(api, cpu, prompt, gen, None)
    cpu_s = time.perf_counter() - t0
    card_logits, card_tokens = _teacher_forced(api, card, prompt, gen,
                                               cpu_tokens, dev)
    errs = [check("serve_parity: prefill logits", card_logits[0],
                  cpu_logits[0], PARITY_PREFILL_TOL)]
    for i in range(1, gen):
        errs.append(check(f"serve_parity: decode step {i} logits",
                          card_logits[i], cpu_logits[i], PARITY_DECODE_TOL))
    agree = int((card_tokens == cpu_tokens).sum())
    # where the greedy picks differ: the CPU run's gap between its top
    # two logits, against the logit error the tolerance allows
    gaps = []
    for i, j in (card_tokens != cpu_tokens).nonzero().tolist():
        top2 = torch.topk(cpu_logits[j][i], 2).values
        gaps.append(float(top2[0] - top2[1]))
    emit({"phase": "serve_parity", "layers": PARITY_LAYERS,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": b,
          "steps": gen, "prefill_max_abs_err": errs[0],
          "decode_max_abs_err": max(errs[1:]),
          "decode_max_abs_err_per_step": errs[1:],
          "greedy_tokens_agree": agree,
          "greedy_tokens_total": int(cpu_tokens.numel()),
          "disagreeing_top2_gaps": gaps,
          "cpu_seconds": cpu_s})


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _teacher_forced(api, params, prompt, gen, forced, dev="cpu"):
    """Prefill ``prompt`` (a batch dict of CPU tensors: tokens (B, S),
    a VLM's with its patches), then ``gen - 1`` decode steps,
    each fed the greedy token of ``forced`` (the run's own greedy tokens
    when None).  Returns ([logits (B, V) of the prefill and of every
    step] on the CPU, the greedy tokens (B, gen))."""
    batch = {k: v.to(dev) for k, v in prompt.items()}
    logits, cache = api.prefill(params, batch, cache_extra=gen)
    out, picks = [logits[:, -1].cpu()], []
    # the prompt's positions (a recurrent cache has no sequence axis)
    pos = (cache["k"].shape[2] - gen if "k" in cache
           else batch["tokens"].shape[1])
    for i in range(gen):
        pick = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        picks.append(pick.cpu())
        if i == gen - 1:
            break
        feed = pick if forced is None else forced[:, i].to(dev)
        logits, cache = api.decode_step(params, cache,
                                        {"token": feed[:, None],
                                         "pos": pos})
        out.append(logits[:, -1].cpu())
        pos += 1
    return out, torch.stack(picks, dim=1)


# ---------------------------------------------------------------------------
# the rest of the transformer family: gemma-7b, deepseek-coder-33b,
# granite-moe-1b-a400m, mixtral-8x22b, pixtral-12b
# ---------------------------------------------------------------------------

#: (arch, layers kept): published widths, the depth cut where the f32
#: weights of the whole model would not fit the card
FAMILY_SERVE = (("granite-moe-1b-a400m", None), ("gemma-7b", None),
                ("pixtral-12b", None), ("mixtral-8x22b", 2),
                ("deepseek-coder-33b", 8))
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_VLM_TEXT, FAMILY_GEN = 4, 64, 128, 16
FAMILY_PARITY = ("granite-moe-1b-a400m", "gemma-7b", "pixtral-12b")
#: (arch, layers kept, rounds) of the fine-tunes
FAMILY_FT = (("mixtral-8x22b", 1, 3), ("granite-moe-1b-a400m", None, 2))
FT_CLIENTS, FT_SELECT, FT_SEQS, FT_SEQ_LEN = 4, 2, 4, 128


def family_cfg(arch: str, layers=None):
    """The arch's config, cut to ``layers`` (an encoder-decoder's
    encoder too)."""
    cfg = get_config(arch)
    if layers is None:
        return cfg
    encdec = (None if cfg.encdec is None else dataclasses.replace(
        cfg.encdec, encoder_layers=layers))
    return dataclasses.replace(cfg, num_layers=layers, encdec=encdec,
                               name=f"{arch}-{layers}layers")


def family_prompt(cfg) -> int:
    """The serve prompt's positions: 64 text tokens, or a VLM's P
    patches then 128 tokens (the prefill attends in query chunks of
    128, so P + S must be at most 128 or a multiple of it, as in the
    reference: 256 + 64 is neither)."""
    if cfg.vlm is None:
        return FAMILY_PROMPT
    return cfg.vlm.num_patches + FAMILY_VLM_TEXT


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def family_bounds(params, cfg, b: int, positions: int, gen: int) -> dict:
    """Least times of a prefill over ``positions`` (P + S) and of a
    decode step, f32 weights: the larger of the weights read once (the
    embedding table gives only B·T rows, unless it is the tied head,
    which reads it whole) plus, in decode, the bf16 K/V of the mean
    valid cache length, over the HBM rate, and 2 operations a weight a
    token over the f32 peak (a MoE layer's experts at K/E, the head on
    the last position only in prefill).  Every expert is counted as
    read: at B·K >= E (mixtral 8 of 8, granite 32 of 32) a step's
    tokens can route to all of them."""
    embed = params["embed"]
    n_head = cfg.vocab_size * cfg.d_model
    n_proj = (cfg.vlm.patch_embed_dim * cfg.d_model if cfg.vlm else 0)
    n_body = sum(t.numel() for t in _leaves(params["layers"]))
    if cfg.moe is not None:
        moe = params["layers"]["moe"]
        experts = sum(moe[k].numel() for k in ("wi0", "wi1", "wo"))
        n_body -= experts * (1 - cfg.moe.top_k / cfg.moe.num_experts)
    read = _nbytes(params) - (0 if cfg.tie_embeddings
                              else embed.numel() * embed.element_size())
    patches = cfg.vlm.num_patches if cfg.vlm else 0
    prefill_flops = (2 * n_body * b * positions + 2 * n_head * b
                     + 2 * n_proj * b * patches)
    mean_len = positions + gen / 2
    cache = (2 * cfg.num_layers * b * mean_len * cfg.num_kv_heads
             * cfg.resolved_head_dim() * 2)
    decode_flops = 2 * (n_body + n_head) * b
    return {"prefill_bound_ms": max(prefill_flops / F32_FLOPS_PER_S,
                                    read / HBM_BYTES_PER_S) * 1e3,
            "decode_bound_ms_per_token": max(
                decode_flops / F32_FLOPS_PER_S,
                (read + cache) / HBM_BYTES_PER_S) * 1e3}


def model_family_bounds(params, cfg, b: int, positions: int, gen: int,
                        cache) -> dict:
    """Least times of a prefill and a decode step of rwkv, the hybrid and
    the encoder-decoder, f32 weights: the larger of the bytes (every
    weight but the embedding read once; in decode also the cache: the
    mean valid length of the self-attention K/V, the cross K/V whole,
    the recurrent states read and written, the conv and token-shift
    rows read) over the HBM rate, and 2 operations a weight a token
    over the f32 peak: the hybrid's shared block counted once a site,
    the encoder on the frames, the head on the last prompt position."""
    n_head = sum(t.numel() for t in _leaves(params["lm_head"]))
    if cfg.kind == "ssm":
        body, enc = sum(t.numel() for t in _leaves(params["layers"])), 0
    elif cfg.kind == "hybrid":
        from repro_torch.models.hybrid import num_attn_sites
        shared = sum(t.numel() for t in _leaves(params["shared"]))
        body = (sum(t.numel() for t in _leaves(params["mamba"]))
                + num_attn_sites(cfg) * shared
                // cfg.hybrid.num_shared_blocks)
        enc = 0
    else:
        body = sum(t.numel() for t in _leaves(params["decoder"]))
        enc = sum(t.numel() for t in _leaves(params["encoder"]))
    frames = cache["xk"].shape[2] if "xk" in cache else 0
    read = _nbytes(params) - params["embed"].numel() * 4
    mean_len = positions + gen / 2
    cache_bytes = 0.0
    for path in _paths(cache):
        t = _at(cache, "/".join(path))
        if path[-1] in ("k", "v"):
            cache_bytes += t.numel() * t.element_size() * mean_len / t.shape[2]
        else:
            cache_bytes += (2 if path[-1] == "state" else 1) * (
                t.numel() * t.element_size())
    prefill_flops = 2 * (body * b * positions + enc * b * frames
                         + n_head * b)
    decode_flops = 2 * (body + n_head) * b
    return {"prefill_bound_ms": max(prefill_flops / F32_FLOPS_PER_S,
                                    read / HBM_BYTES_PER_S) * 1e3,
            "decode_bound_ms_per_token": max(
                decode_flops / F32_FLOPS_PER_S,
                (read + cache_bytes) / HBM_BYTES_PER_S) * 1e3}


def family_serve(arch: str, layers, dev,
                 phase="transformer_family") -> tuple:
    """One arch through ``serve.generate`` and ``serve.decode_kernel_check``
    (the serve entry point's own functions) at published width, the
    counts set to 0 just before and read just after: batch 4, prompt 64
    text tokens (pixtral: 128 after its 256 patches; seamless: 64
    tokens after 64 frames), 16 greedy tokens; then the decode kernel
    on the live bf16 cache of the first and last layer (zamba2: site),
    and an encoder-decoder's on its first and last layer's cross cache
    at its length F.  An arch with no attention (rwkv6-3b) has no
    kernel check and no K/V cache: its decode_attention launches are
    recorded, not required.  Returns (its record, its launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = family_cfg(arch, layers)
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    b, prompt = FAMILY_BATCH, family_prompt(cfg)
    batch = serve.make_batch(cfg, rng, b, prompt, dev)
    kbuild.reset_launches()
    res = serve.generate(api, params, batch, FAMILY_GEN)
    kernel_err = (serve.decode_kernel_check(cfg, b, rng, dev)
                  if cfg.num_heads else None)
    torch.cuda.synchronize()
    launches = dict(kbuild.launches)
    tag = f"{phase} serve {cfg.name}"
    if cfg.num_heads:
        require(f"{tag}: decode_attention was not launched",
                launches["decode_attention"] > 0)
        require(f"{tag}: kernel check {kernel_err} > 5e-5",
                kernel_err <= 5e-5)
    tokens = res["tokens"]
    require(f"{tag}: tokens of the wrong shape or out of range",
            tokens.shape == (b, FAMILY_GEN) and int(tokens.min()) >= 0
            and int(tokens.max()) < cfg.vocab_size)
    require(f"{tag}: cache length {res['length']}",
            res["length"] == prompt + FAMILY_GEN - 1)
    cache, length = res["cache"], res["length"]
    live = {}
    gq = torch.Generator(device=dev).manual_seed(7)
    unit = "site" if cfg.hybrid is not None else "layer"
    caches = [("", "k", "v", length)]
    if "xk" in cache:           # the cross caches, valid at their length F
        caches.append(("cross_", "xk", "xv", cache["xk"].shape[2]))
    for prefix, kn, vn, n in caches if "k" in cache else []:
        for layer in (0, cache[kn].shape[0] - 1):
            k, v = cache[kn][layer], cache[vn][layer]
            q = torch.randn((b, cfg.num_heads, cfg.resolved_head_dim()),
                            generator=gq, device=dev)
            got = ops.gqa_decode_attention(q, k, v, n, device=dev)
            live[f"{prefix}{unit}{layer}"] = check(
                f"{tag}: live {prefix}cache {unit} {layer}", got,
                ref.decode_attention_ref(q, k, v, n), 5e-5, 5e-5)
    bounds = (family_bounds(params, cfg, b, prompt, FAMILY_GEN)
              if cfg.kind in ("dense", "moe", "vlm") else
              model_family_bounds(params, cfg, b, prompt, FAMILY_GEN, cache))
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "published_layers": get_config(arch).num_layers,
           "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim()],
           "batch": b, "prompt_positions": prompt, "gen": FAMILY_GEN,
           "params": sum(t.numel() for t in _leaves(params)),
           "weights_gb": _nbytes(params) / 1e9, "init_s": init_s,
           "prefill_ms": res["prefill_ms"],
           "decode_ms_per_token": res["decode_ms_per_token"],
           **bounds, "kernel_check_max_abs_err": kernel_err,
           "live_cache_length": length, "live_cache_max_abs_err": live,
           "first_request_tokens": tokens[0].tolist(),
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    del params, res, cache
    return out, launches


class route_recorder:
    """Records each MoE ``route`` call's probabilities and top-k ids (on
    the CPU) while it is active: ``moe_block`` looks ``route`` up in its
    module at every call."""

    def __enter__(self):
        self.calls, self._route = [], MOE.route

        def rec(p, x, moe_cfg):
            out = self._route(p, x, moe_cfg)
            self.calls.append((out[1].detach().cpu(), out[3].cpu()))
            return out
        MOE.route = rec
        return self

    def __exit__(self, *exc):
        MOE.route = self._route


def family_parity(arch: str, dev, phase="transformer_family") -> dict:
    """The arch cut to two layers at published width, weights from seed
    0 on the card, copied to the CPU: prefill and 15 decode steps on
    the card and in the port's CPU run, both fed the CPU run's greedy
    tokens, at serve_parity's tolerances.  On a MoE cut the prefill's
    top-k expert ids of every layer on the card against the CPU's; a
    disagreement is printed with the CPU's router-probability margin
    between its k-th and (k+1)-th expert."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = family_cfg(arch, PARITY_LAYERS)
    api = get_model(cfg)
    card = api.init(0, device=dev)
    cpu = _map(lambda t: t.cpu(), card)
    b, gen = FAMILY_BATCH, FAMILY_GEN
    batch = serve.make_batch(cfg, np.random.default_rng(1), b,
                             family_prompt(cfg), "cpu")
    tag = f"{phase} parity {cfg.name}"
    t0 = time.perf_counter()
    with route_recorder() as cpu_routes:
        cpu_logits, cpu_tokens = _teacher_forced(api, cpu, batch, gen, None)
    cpu_s = time.perf_counter() - t0
    with route_recorder() as card_routes:
        card_logits, card_tokens = _teacher_forced(api, card, batch, gen,
                                                   cpu_tokens, dev)
    errs = [check(f"{tag}: prefill logits", card_logits[0], cpu_logits[0],
                  PARITY_PREFILL_TOL)]
    for i in range(1, gen):
        errs.append(check(f"{tag}: decode step {i} logits", card_logits[i],
                          cpu_logits[i], PARITY_DECODE_TOL))
    out = {"arch": cfg.name, "layers": PARITY_LAYERS, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "batch": b, "steps": gen,
           "prefill_max_abs_err": errs[0],
           "decode_max_abs_err": max(errs[1:]),
           "greedy_tokens_agree": int((card_tokens == cpu_tokens).sum()),
           "greedy_tokens_total": int(cpu_tokens.numel()),
           "cpu_seconds": cpu_s}
    if cfg.moe is not None:
        # the prefill's calls, one a layer, then one a layer a step
        k = cfg.moe.top_k
        pairs = list(zip(cpu_routes.calls, card_routes.calls))
        require(f"{tag}: {len(pairs)} router calls",
                len(pairs) == PARITY_LAYERS * gen)
        prefill, differ = pairs[:PARITY_LAYERS], []
        for layer, ((probs, ids), (_, card_ids)) in enumerate(prefill):
            for pos in (ids != card_ids).any(-1).nonzero().tolist():
                top = torch.sort(probs[tuple(pos)], descending=True,
                                 stable=True).values
                differ.append({"layer": layer, "position": pos,
                               "margin": float(top[k - 1] - top[k])})
        require(f"{tag}: router top-k ids differ on the card: {differ}",
                not differ)
        out["router_ids_equal"] = not differ
        out["router_disagreements"] = differ
        out["router_choices_compared"] = sum(ids.numel()
                                             for (_, ids), _ in prefill)
    del card, cpu
    return out


def family_finetune(arch: str, layers, rounds: int, dev,
                    phase="transformer_family") -> tuple:
    """``train.train_rounds`` (the fine-tuning entry point's round loop)
    at published width with ``layers`` kept: 4 clients of 4 × 128
    tokens, K = 2, HiCS at T = 0.01, sgd lr 0.05, 1 epoch, the counts
    set to 0 just before and read just after.  The selects after round
    0 refresh the cache through fused_stats and the arccos strip.  Then
    the share of dropped (token, expert) pairs of one client's loss on
    the final params, and the selection replayed on the CPU from the
    card's Δb (the same participants every round).  Returns (its
    record, its launches)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = family_cfg(arch, layers)
    api = get_model(cfg)
    toks, _ = make_lm_streams(np.random.default_rng(0), cfg.vocab_size,
                              FT_SEQ_LEN + 1, FT_CLIENTS, FT_SEQS,
                              [0.05, 0.05, 0.05, 5.0])
    toks = torch.as_tensor(toks, device=dev)
    params = api.init(0, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    classes = head_num_classes(params) or 1
    sel = make_selector("hics", num_clients=FT_CLIENTS,
                        num_select=FT_SELECT, total_rounds=rounds,
                        temperature=T_LM, num_classes=classes, seed=0,
                        device=dev)
    rec: list = []
    kbuild.reset_launches()
    t0 = time.perf_counter()
    params, hist = train.train_rounds(api, params, toks, sel, rounds=rounds,
                                      lr=0.05, epochs=1, record=rec)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    tag = f"{phase} finetune {cfg.name}"
    for name in ("fused_stats", "gram_update"):
        require(f"{tag}: {name} was not launched", launches[name] > 0)
    require(f"{tag}: fused_stats launches differ from the strip's",
            launches["fused_stats"] == launches["gram_update"] == rounds - 1)
    require(f"{tag}: non-finite loss", bool(np.isfinite(hist["loss"]).all()))
    seq = toks[0, 0]
    with torch.no_grad():
        _, metrics = api.loss(params, {"tokens": seq[None, :-1],
                                       "targets": seq[None, 1:]})
    steps = FT_SELECT * FT_SEQS
    out = {"arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": n_params, "weights_gb": 4 * n_params / 1e9,
           "clients": FT_CLIENTS, "select": FT_SELECT, "rounds": rounds,
           "seq_len": FT_SEQ_LEN, "seconds": seconds,
           "ms_per_local_step": [r["local_s"] / steps * 1e3 for r in rec],
           "selected": hist["selected"], "loss": hist["loss"],
           "delta_b_shape": list(rec[0]["delta_b"].shape),
           "moe_frac_dropped": (float(metrics["moe_frac_dropped"])
                                if "moe_frac_dropped" in metrics else None),
           "peak_memory_gb": peak / 1e9, "launches": launches,
           "cpu_replay": lm_replay(rec, sel, FT_CLIENTS, FT_SELECT, rounds,
                                   classes, tag)}
    del params, sel, rec
    return out, launches


def family_serve_batched(arch="mixtral-8x22b",
                         phase="transformer_family") -> tuple:
    """``repro_torch.examples.serve_batched`` with ``arch``, as the
    reference runs it (reduced), the counts set to 0 just before."""
    kbuild.reset_launches()
    res = serve_batched.main(["--arch", arch])
    torch.cuda.synchronize()
    launches = dict(kbuild.launches)
    tag = f"{phase} serve_batched"
    require(f"{tag}: decode_attention was not launched",
            launches["decode_attention"] > 0)
    require(f"{tag}: kernel check {res['kernel_max_abs_err']} > 5e-5",
            res["kernel_max_abs_err"] <= 5e-5)
    require(f"{tag}: tokens of the wrong shape",
            tuple(res["tokens"].shape) == (4, 24))
    return {"arch": res["cfg"].name,
            "decode_ms_per_token": res["decode_ms_per_token"],
            "kernel_check_max_abs_err": res["kernel_max_abs_err"],
            "first_request_tokens": res["tokens"][0].tolist(),
            "launches": launches}, launches


def transformer_family_phase(dev) -> dict:
    """The rest of the transformer family on the card: each arch served
    at published width (:data:`FAMILY_SERVE`), mixtral and granite-moe
    fine-tuned (:data:`FAMILY_FT`), the two-layer cuts of granite-moe,
    gemma and pixtral against the port's CPU run, and the serve_batched
    example.  Returns the launches summed over the serve, fine-tune and
    example runs."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total: dict = {}
    out = {"phase": "transformer_family", "card": CARD, "serve": [],
           "finetune": [], "parity": []}
    for arch, layers in FAMILY_SERVE:
        rec, n = family_serve(arch, layers, dev)
        _add(total, n)
        out["serve"].append(rec)
    for arch, layers, rounds in FAMILY_FT:
        rec, n = family_finetune(arch, layers, rounds, dev)
        _add(total, n)
        out["finetune"].append(rec)
    for arch in FAMILY_PARITY:
        out["parity"].append(family_parity(arch, dev))
    out["serve_batched"], n = family_serve_batched()
    _add(total, n)
    out.update({"launches": total, "seconds": time.perf_counter() - t0})
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# the remaining model families: rwkv6-3b, zamba2-7b (Mamba2 with shared
# attention at dh 112), seamless-m4t-medium (cross-attention over frames)
# ---------------------------------------------------------------------------

#: served at published width and depth
MF_SERVE = ("rwkv6-3b", "zamba2-7b", "seamless-m4t-medium")
#: (arch, layers kept, rounds) of the fine-tunes at published width:
#: rwkv's WKV loop makes a step host-bound (8 layers: 1.3–1.6 s), so its
#: depth is cut for time; zamba2's 36 layers are six sites, both shared
#: blocks three times each, four f32 trees of 3.45 B params (~55 GB)
MF_FT = (("rwkv6-3b", 8, 3), ("zamba2-7b", 36, 2))
MF_SERVE_BATCHED = "seamless-m4t-medium"


def model_families_phase(dev) -> dict:
    """rwkv6-3b, zamba2-7b and seamless-m4t-medium served at published
    width and depth (:data:`MF_SERVE`: the decode kernel checked at
    zamba2's dh 112 and seamless's dh 64 and on their live caches,
    seamless's cross cache among them; rwkv has no attention), rwkv and
    zamba2 fine-tuned (:data:`MF_FT`), each arch's two-layer cut on the
    card against the port's CPU run with equal greedy tokens, and the
    serve_batched example with seamless.  Returns the launches summed
    over the serve, fine-tune and example runs."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    total: dict = {}
    out = {"phase": "model_families", "card": CARD, "serve": [],
           "finetune": [], "parity": []}
    for arch in MF_SERVE:
        rec, n = family_serve(arch, None, dev, "model_families")
        _add(total, n)
        out["serve"].append(rec)
    for arch, layers, rounds in MF_FT:
        rec, n = family_finetune(arch, layers, rounds, dev, "model_families")
        _add(total, n)
        out["finetune"].append(rec)
    for arch in MF_SERVE:
        rec = family_parity(arch, dev, "model_families")
        require(f"model_families parity {rec['arch']}: greedy tokens "
                f"{rec['greedy_tokens_agree']} of "
                f"{rec['greedy_tokens_total']} equal",
                rec["greedy_tokens_agree"] == rec["greedy_tokens_total"])
        out["parity"].append(rec)
    out["serve_batched"], n = family_serve_batched(MF_SERVE_BATCHED,
                                                   "model_families")
    _add(total, n)
    out.update({"launches": total, "seconds": time.perf_counter() - t0})
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# LM fine-tuning: qwen2.5-3b at full width and depth, 6 rounds
# ---------------------------------------------------------------------------

LM_CLIENTS, LM_SELECT, LM_ROUNDS, LM_SEQS = 8, 2, 6, 4
LM_ARGV = ["--arch", "qwen2.5-3b", "--full", "--rounds", str(LM_ROUNDS),
           "--clients", str(LM_CLIENTS), "--select", str(LM_SELECT),
           "--seqs-per-client", str(LM_SEQS), "--seed", "0"]
LM_CUT_LAYERS = 2
LM_CUT_LOSS_TOL = 1e-4       # relative
LM_CUT_UPDATE_TOL = 1e-3     # of the largest |Δ| of the leaf


def lm_train_phase(dev) -> dict:
    """``repro_torch.launch.train`` on qwen2.5-3b at full width and
    depth (8 clients, K = 2, 6 rounds, the reference's other defaults:
    seq-len 128, 4 sequences a client, 1 epoch, sgd lr 0.05, HiCS at
    T = 0.01), the counts set to 0 just before it and read just after.
    Rounds 0-3 are HiCS's coverage sweep, 4-5 clustered; the selects
    of rounds 1-5 refresh the cache through fused_stats and the arccos
    strip.  Then: the selection replayed on the CPU from the card's Δb
    (the same participants every round), the final cache against the
    plain versions on the card, a profile of one local step, and the
    model cut to two layers trained on the card and on the CPU.
    Returns the kernels' launches on the path."""
    # the earlier phases' servers hold their CUDA graphs' private pools
    # (~17 GB) until the cycle collector frees them
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tel_dir = tempfile.TemporaryDirectory()
    tel_path = Path(tel_dir.name) / "lm_train.jsonl"
    kbuild.reset_launches()
    t0 = time.perf_counter()
    res = train.main(LM_ARGV + ["--telemetry", str(tel_path)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    hist, rec, sel = res["history"], res["record"], res["selector"]
    for name in ("fused_stats", "gram_update"):
        require(f"lm_train: {name} was not launched", launches[name] > 0)
    # one refresh a select after the first update, one stats launch each
    require("lm_train: fused_stats launches differ from the strip's",
            launches["fused_stats"] == launches["gram_update"]
            == LM_ROUNDS - 1)
    require("lm_train: pairwise launched on the incremental path",
            launches["pairwise"] == 0)
    require("lm_train: non-finite loss", bool(np.isfinite(hist["loss"]).all()))
    require("lm_train: participants not distinct",
            all(len(set(ids)) == LM_SELECT for ids in hist["selected"]))
    sweep = LM_CLIENTS // LM_SELECT
    require("lm_train: the coverage sweep missed a client",
            sorted(sum(hist["selected"][:sweep], [])) ==
            list(range(LM_CLIENTS)))
    ent = np.asarray(hist["bias_entropy"][-1])
    require("lm_train: Ĥ not finite or of the wrong shape",
            ent.shape == (LM_CLIENTS,) and bool(np.isfinite(ent).all()))
    steps = LM_SELECT * LM_SEQS          # one epoch
    step_ms = [r["local_s"] / steps * 1e3 for r in rec]
    out = {"phase": "lm_train", "arch": res["cfg"].name,
           "layers": res["cfg"].num_layers, "d_model": res["cfg"].d_model,
           "vocab": res["cfg"].vocab_size,
           "params": sum(t.numel() for t in _leaves(res["params"])),
           "clients": LM_CLIENTS, "select": LM_SELECT, "rounds": LM_ROUNDS,
           "seq_len": int(res["tokens"].shape[-1]) - 1,
           "seconds": seconds, "init_s": res["init_s"],
           "rounds_per_s": LM_ROUNDS / sum(hist["wall_s"]),
           "wall_s": hist["wall_s"], "ms_per_local_step": step_ms,
           "select_s": [r["select_s"] for r in rec],
           "select_seconds": hist["select_seconds"],
           "update_seconds": hist["update_seconds"],
           "peak_memory_gb": peak / 1e9, "card_memory_gb": total / 1e9,
           "selected": hist["selected"], "loss": hist["loss"],
           "entropy_spread": float(ent.max() - ent.min()),
           "entropy_last": ent.tolist(), "launches": launches}
    out["telemetry"] = lm_telemetry(tel_path, hist)
    tel_dir.cleanup()
    out["cpu_replay"] = lm_replay(rec, sel)
    out["cache_vs_plain"] = lm_cache_check(sel, dev)
    out["step_profile"] = lm_step_profile(res, dev)
    tokens = res["tokens"]
    del res, sel
    torch.cuda.empty_cache()
    out["two_layer_cut"] = lm_cut(tokens, dev)
    emit(out)
    return launches


def lm_telemetry(path, hist) -> dict:
    """The run's ``--telemetry`` JSONL read back: a header with the card
    in its env stamp, a record a round, the history's loss."""
    recs = read_jsonl(path)
    back = telemetry_from_records(recs[1:])
    fields = ["fairness/eff_participation", "fairness/participation",
              "selection/ent_mean", "training/loss"]
    ok = (recs[0]["kind"] == "header" and recs[0]["fields"] == fields
          and len(recs) == 1 + LM_ROUNDS
          and recs[0]["env"]["backend"] == "cuda"
          and np.array_equal(back["training/loss"],
                             np.float32(hist["loss"]).astype(np.float64)))
    require(f"lm_train: telemetry JSONL {recs[0]}", ok)
    return {"fields": recs[0]["fields"], "records": len(recs) - 1,
            "meta": recs[0]["meta"], "ok": ok,
            "participation": back["fairness/participation"].tolist()}


def lm_replay(rec: list, card_sel, clients=LM_CLIENTS, select=LM_SELECT,
              rounds=LM_ROUNDS, classes=151_936, tag="lm_train") -> dict:
    """The card run's selection replayed on the CPU with the plain
    versions: a CPU shim of the same seed draws the same noise; each
    round it selects, then observes the card's ids and Δb.  It must
    pick the card's participants every round; its Ĥ is printed beside
    the card's."""
    cpu = make_selector("hics", num_clients=clients, num_select=select,
                        total_rounds=rounds, temperature=T_LM,
                        num_classes=classes, seed=0, device="cpu")
    same = []
    for t, r in enumerate(rec):
        same.append(cpu.select(t) == r["ids"])
        cpu.update(t, r["ids"], bias_updates=r["delta_b"])
    require(f"{tag}: the CPU replay's participants differ: {same}",
            all(same))
    ent_cpu = torch.tensor(cpu.estimated_entropies())
    ent_card = torch.tensor(card_sel.estimated_entropies())
    return {"same_ids": same,
            "entropy_max_abs_diff": float((ent_cpu - ent_card).abs().max())}


def lm_cache_check(sel, dev) -> dict:
    """The card selector's final state: its cache, built by the kernels
    over the run and refreshed for the last cohort, against the plain
    from-scratch build on the card (tolerances of phase kernels)."""
    st = sel.state
    _, dist, stats = ops.hics_selection_step_cached(
        st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, T_LM, LAM,
        device=dev)
    ent_p, dist_p = ref.selection_step_ref(st.delta_b, T_LM, LAM)
    require("lm_train: cache not bit-symmetric",
            bool(torch.equal(dist, dist.T)))
    return {"dist": check("lm_train: cache vs plain", dist, dist_p,
                          1e-5, 1e-5),
            "entropy": check("lm_train: cached Ĥ vs plain", stats[:, 1],
                             ent_p, 5e-5),
            "norm": check("lm_train: cached norm vs plain", stats[:, 0],
                          torch.linalg.vector_norm(st.delta_b, dim=-1),
                          1e-5, 1e-5)}


def lm_step_profile(res, dev) -> dict:
    """Device time of one local step at full width (one sequence, the
    copy of the params included) by ``torch.profiler``: the sum of the
    kernels' own spans, the share in matrix products and the top
    kernels; and its host-clock time."""
    api = get_model(res["cfg"])
    toks = res["tokens"][0][:1]
    buf = tree_map(torch.empty_like, res["params"])

    def step():
        train.local_lm_update(api, res["params"], toks, 0.05, 1, out=buf)

    iters = 2
    spans = cuda_spans([step], iters)
    by_name: dict = {}
    for name, us in spans:
        by_name[name] = by_name.get(name, 0.0) + us
    total = sum(by_name.values())
    gemm = sum(t for n, t in by_name.items()
               if "gemm" in n.lower() or "gemv" in n.lower())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"host_ms": host_ms(step, reps=3),
            "device_ms": total / iters / 1e3,
            "matmul_ms": gemm / iters / 1e3,
            "kernels": len(spans) / iters,
            "top_kernels_ms": {n[:80]: t / iters / 1e3 for n, t in top}}


def lm_cut(tokens, dev) -> dict:
    """qwen2.5-3b cut to two layers at full width and vocabulary,
    weights from seed 0 on the card, copied to the CPU: one client's
    ``local_lm_update`` (client 0's 4 sequences, sgd lr 0.05, 1 epoch)
    on the card and on the port's CPU from the same params.  The loss
    within 1e-4 relative; each leaf's update (trained minus initial) —
    the head's Δb and weight and every other — within 1e-3 of its
    largest magnitude: the two sum the f32 matmuls in other orders,
    and the clip scale 1/‖g‖ carries that relative difference (~1e-6)
    into every update."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b"),
                              num_layers=LM_CUT_LAYERS,
                              name=f"qwen2.5-3b-{LM_CUT_LAYERS}layers")
    api = get_model(cfg)
    card = api.init(0, device=dev)
    cpu = _map(lambda t: t.cpu(), card)
    toks = tokens[0]
    t0 = time.perf_counter()
    cpu_new, cpu_loss = train.local_lm_update(api, cpu, toks.cpu(), 0.05, 1)
    cpu_s = time.perf_counter() - t0
    card_new, card_loss = train.local_lm_update(api, card, toks, 0.05, 1)
    a, b = float(card_loss), float(cpu_loss)
    rel = abs(a - b) / abs(b)
    require(f"lm_cut: loss {a} vs CPU {b} (rel {rel})",
            rel <= LM_CUT_LOSS_TOL)

    def update_err(path):
        d_card = (_at(card_new, path) - _at(card, path)).cpu()
        d_cpu = _at(cpu_new, path) - _at(cpu, path)
        scale = float(d_cpu.abs().max())
        err = float((d_card - d_cpu).abs().max())
        require(f"lm_cut: {path} update off by {err} > "
                f"{LM_CUT_UPDATE_TOL} x {scale}",
                err <= LM_CUT_UPDATE_TOL * scale)
        return {"max_abs_err": err, "max_abs_update": scale}

    paths = ["/".join(p) for p in _paths(cpu)]
    errs = {p: update_err(p) for p in paths}
    return {"layers": LM_CUT_LAYERS, "seqs": int(toks.shape[0]),
            "card_loss": a, "cpu_loss": b, "loss_rel_err": rel,
            "delta_b": errs["lm_head/b"], "head_w": errs["lm_head/w"],
            "worst_leaf_rel_err": max(e["max_abs_err"] / e["max_abs_update"]
                                      for e in errs.values()
                                      if e["max_abs_update"] > 0),
            "cpu_seconds": cpu_s}


# ---------------------------------------------------------------------------
# the federated fine-tuning example at its ~100M default
# ---------------------------------------------------------------------------

FT_ROUNDS = 6


def finetune_example_phase(dev) -> dict:
    """``repro_torch.examples.federated_finetune`` at its default size
    (qwen3-8b cut to 4 layers at d_model 768, vocab 32,768: ~100M
    params; 16 clients, K = 4, two sequences of 256 tokens each), cut
    to 6 rounds, the counts set to 0 just before it and read just
    after.  Rounds 0-3 sweep, 4-5 cluster; the selects of rounds 1-5
    refresh the cache through fused_stats and the arccos strip.  Checks
    finite losses, distinct participants, finite Ĥ and the final cache
    against the plain from-scratch build.  Returns the launches."""
    gc.collect()
    torch.cuda.empty_cache()
    kbuild.reset_launches()
    t0 = time.perf_counter()
    res = federated_finetune.main(["--rounds", str(FT_ROUNDS)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kbuild.launches)
    hist, sel = res["history"], res["selector"]
    for name in ("fused_stats", "gram_update"):
        require(f"finetune_example: {name} was not launched",
                launches[name] > 0)
    require("finetune_example: fused_stats launches differ from the strip's",
            launches["fused_stats"] == launches["gram_update"]
            == FT_ROUNDS - 1)
    require("finetune_example: non-finite loss",
            bool(np.isfinite(hist["loss"]).all()))
    require("finetune_example: participants not distinct",
            all(len(set(ids)) == len(ids) for ids in hist["selected"]))
    ent = sel.estimated_entropies()
    require("finetune_example: Ĥ not finite",
            ent is not None and bool(np.isfinite(ent).all()))
    st = sel.state
    _, dist, stats = ops.hics_selection_step_cached(
        st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, 0.63, LAM,
        normalize=True, device=dev)
    ent_p, dist_p = ref.selection_step_ref(st.delta_b, 0.63, LAM,
                                           normalize=True)
    out = {"phase": "finetune_example", "card": CARD,
           "arch": res["cfg"].name, "layers": res["cfg"].num_layers,
           "d_model": res["cfg"].d_model, "vocab": res["cfg"].vocab_size,
           "params": res["n_params"], "rounds": FT_ROUNDS,
           "seconds": seconds,
           "rounds_per_s": FT_ROUNDS / sum(hist["wall_s"]),
           "wall_s": hist["wall_s"], "loss": hist["loss"],
           "selected": hist["selected"], "entropy_spread": hist["spread"],
           "select_seconds": sel.select_seconds,
           "update_seconds": sel.update_seconds,
           "cache_vs_plain": {
               "dist": check("finetune_example: cache vs plain", dist,
                             dist_p, 1e-5, 1e-5),
               "entropy": check("finetune_example: cached Ĥ vs plain",
                                stats[:, 1], ent_p, 5e-5)},
           "launches": launches}
    emit(out)
    del res, sel
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the heterogeneity scenarios, the multi-seed sweep and the async server
# ---------------------------------------------------------------------------

SWEEP = SweepSpec(
    scenarios=("mixed_80_20", "dir_severe", "flaky_severe", "diurnal_mixed"),
    selectors=("hics", "cs"), seeds=(0, 1), arch="paper-cnn",
    num_clients=50, num_select=5, rounds=ROUNDS, cap=800,
    samples_train=10_000, samples_test=2_000, selector_kw=SELECTOR_KW,
    local=SPEC.local, data=SPEC.data)
ASYNC_SCENARIOS = ("stragglers_severe", "diurnal_heavy_tail", "flash_crowd")
ASYNC_TICKS = 20


def _launches_since_reset(fn):
    """``fn()`` with every count set to 0 just before it; (its result,
    its launches by kernel, its strip launches by epilogue)."""
    kbuild.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return (out, dict(kbuild.launches),
            dict(kbuild.variant_launches["gram_update"]["epilogue"]))


def _add(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def partitions_vs_cpu(dev) -> dict:
    """Each partition kind, drawn once on the CPU, built on the card and
    on the CPU from the same labels: ``idx``, ``mask`` and ``counts``
    bit-equal."""
    out = {}
    for name in ("dir_severe", "mixed_80_20", "shards2", "quantity_skew",
                 "iid"):
        scn = SWEEP.scenario(name)
        ncls = get_config(SWEEP.arch).vocab_size
        train, _, _ = make_dataset(scn, SWEEP.samples_train, 0, ncls,
                                   device="cpu")
        y = train["y"]
        draws = scn.draw(partition_generator(scn, 0), y.shape[0], ncls,
                         SWEEP.num_clients)
        cpu = scn.partition(draws, y, ncls, SWEEP.num_clients, SWEEP.cap)
        card = scn.partition(draws, y.to(dev), ncls, SWEEP.num_clients,
                             SWEEP.cap)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
        require(f"scenarios: {scn.kind} partition differs card vs CPU",
                same)
        out[scn.kind] = {"bit_equal": same,
                         "kept": int(cpu.mask.sum()),
                         "max_count": int(cpu.counts.max())}
    return out


def _seed_server_maker(pair, i, spec):
    """``make(rounds, device)`` of seed i of a sync cell: a host-loop
    server on ``device`` over the seed's client arrays, with its seed
    and availability schedule."""
    srv = pair.servers[i]
    arrays = [a.cpu().numpy() for a in (srv.x, srv.y, srv.mask)]
    init, apply, _ = make_classifier(get_config(spec.arch),
                                     input_dim=spec.data.dim)

    def make(rounds, device):
        cfg = dataclasses.replace(srv.cfg, rounds=rounds, jit_rounds=False)
        return FederatedServer(init, apply, cfg, *arrays, device=device,
                               availability=pair.scenario)

    return make


def sweep_cell(spec, scenario: str, selector: str, dev) -> tuple:
    """One sync cell: the sweep twice (the graph captured in the first
    run), each seed against the scanned driver alone (always-on
    scenarios), the availability of every pick (time-varying ones),
    seed 0's first rounds against the CPU.  Returns (the cell's record, its launches,
    its strip launches by epilogue)."""
    tag = f"scenarios sweep {scenario}/{selector}"
    pair = build_pair(spec, scenario, selector, device=dev)
    (ids, loss, ent, acc), launches, epi = _launches_since_reset(pair.run)
    first_s = pair.wall_s
    again = pair.run()
    second_s = pair.wall_s
    seeds, rounds = len(spec.seeds), spec.rounds
    require(f"{tag}: {pair.captures} captures", pair.captures == 1)
    require(f"{tag}: the second run differs from the first",
            all(np.array_equal(a, b) for a, b in zip((ids, loss), again)))
    require(f"{tag}: non-finite loss", bool(np.isfinite(loss).all()))
    require(f"{tag}: participants not distinct",
            all(len(set(r.tolist())) == spec.num_select
                for r in ids.reshape(-1, spec.num_select)))
    rec = {"cell": f"{scenario}/{selector}", "seeds": seeds,
           "rounds": rounds, "launches": launches, "by_epilogue": epi,
           "first_run_s": first_s, "second_run_s": second_s,
           "rounds_per_s_first": seeds * rounds / first_s,
           "rounds_per_s_second": seeds * rounds / second_s,
           "replay_ms": replay_ms(pair.graph, iters=5),
           "overflow_frac": pair.overflow_frac,
           "final_acc": acc[:, -1].tolist(),
           "train_loss_last": loss[:, -1].tolist()}
    scn = pair.scenario
    if scn.time_varying:
        off = 0
        for i, srv in enumerate(pair.servers):
            for t in range(rounds):
                avail = availability_mask(scn, spec.num_clients, t,
                                          pair.draws[i][t].avail).cpu()
                off += int((~avail[torch.as_tensor(ids[i, t]).long()]).sum())
        require(f"{tag}: {off} picks unavailable in their round", off == 0)
        rec["unavailable_picks"] = off
    else:
        same, walls = [], []
        for i, seed in enumerate(spec.seeds):
            host = run_host_reference(spec, scenario, selector, seed,
                                      jit_rounds=True, device=dev)
            same.append(host["selected"] == ids[i].tolist()
                        and np.array_equal(np.float32(host["train_loss"]),
                                           loss[i]))
            walls.append(sum(host["segment_wall_s"]))
        require(f"{tag}: a seed differs from its scanned run {same}",
                all(same))
        rec["bit_equal_to_scanned"] = same
        rec["serial_rounds_per_s_with_capture"] = seeds * rounds / sum(
            walls)
    hist = {"selected": ids[0].tolist(), "train_loss": loss[0].tolist()}
    rec["vs_cpu"] = first_rounds_vs_cpu(
        None, dev, hist, tag, make=_seed_server_maker(pair, 0, spec))
    del pair
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches, epi


def _arrivals(srv, selected) -> np.ndarray:
    """Each tick's arrivals from the dispatches and the delay tables."""
    ticks = selected.shape[0]
    base = srv._base_delay.cpu().numpy()
    delay = np.clip(base[selected] + srv._jitter.numpy()[:ticks], 0,
                    srv._window - 1)
    due = (np.arange(ticks)[:, None] + delay).ravel()
    return np.bincount(due[due < ticks], minlength=ticks)


def async_server(scenario: str, dev, ticks=ASYNC_TICKS, seed=0, **kw):
    """The async server over seed ``seed``'s partition of the
    scenario's data, with the scenario's latency model."""
    spec = dataclasses.replace(SWEEP, seeds=(seed,), rounds=ticks)
    k = spec.num_select
    m = kw.get("threshold", 0) or k
    sel_kw = dict(SELECTOR_KW, stale_slots=-(-m // k))
    scn = spec.scenario(scenario)
    acfg = AsyncConfig(
        num_clients=spec.num_clients, num_select=k, ticks=ticks,
        selector="hics", selector_kw=sel_kw, local=spec.local,
        latency=scn.latency, eval_every=5, seed=seed, **kw)
    pair = build_pair(spec, scenario, "hics", device=dev)
    srv0 = pair.servers[0]
    init, apply, _ = make_classifier(get_config(spec.arch),
                                     input_dim=spec.data.dim)
    return AsyncFederatedServer(
        init, apply, acfg, srv0.x.cpu().numpy(), srv0.y.cpu().numpy(),
        srv0.mask.cpu().numpy(), test={k: v.cpu().numpy()
                                       for k, v in srv0.test.items()},
        device=dev)


def async_record(tag, srv, hist) -> dict:
    ids = np.asarray(hist["selected"])
    arrivals = _arrivals(srv, ids)
    got = np.asarray(hist["accepted"]) + np.asarray(hist["dropped"])
    require(f"{tag}: accepted + dropped differ from the arrivals",
            np.array_equal(got, arrivals))
    require(f"{tag}: final version {hist['version'][-1]} but "
            f"{hist['aggregations']} fired ticks",
            hist["version"][-1] == hist["aggregations"])
    require(f"{tag}: non-finite loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    seg = hist["segment_rounds"]
    return {"ticks": len(hist["round"]), "captures": srv.captures,
            "aggregations": hist["aggregations"],
            "dropped_total": hist["dropped_total"],
            "mean_fill": hist["mean_fill"],
            "arrivals": arrivals.tolist(), "accepted": hist["accepted"],
            "dropped": hist["dropped"], "version": hist["version"],
            "ticks_per_s": hist["ticks_per_s"],
            "ticks_per_s_after_capture": sum(seg[1:])
            / sum(hist["segment_wall_s"][1:]),
            "replay_ms": replay_ms(srv._graph),
            "test_acc": hist["test_acc"]}


def _eq9_f64(x, temperature, lam):
    """The Eq. 9 matrix of ``x`` (rows RMS-normalized for Ĥ) in f64 on
    the CPU, and its cosines."""
    x = x.double().cpu()
    v = x / torch.sqrt((x * x).mean(dim=1, keepdim=True)).clamp(min=1e-12)
    p = torch.softmax(v / temperature, dim=1)
    h = -(p * torch.log(p.clamp(min=1e-300))).sum(dim=1)
    n = torch.linalg.vector_norm(x, dim=1).clamp(min=1e-8)
    cos = ((x @ x.T) / (n[:, None] * n[None, :])).clamp(-1.0, 1.0)
    d = torch.arccos(cos) + lam * (h[:, None] - h[None, :]).abs()
    d.fill_diagonal_(0.0)
    return d, cos


def stale_ring_checks(srv, dev) -> dict:
    """The M = 2K run's final state: the ring's strip (2K rows, repeated
    ids) against its plain version, and the cache after its pending
    refresh against a from-scratch build by the plain version and by
    the pairwise kernel, on every pair of distinct clients whose Δb rows
    were written (a never-written row's cached stats keep their initial
    0, where a from-scratch build reads the zero row's Ĥ), each entry
    within 1e-5 + 1e-5|x| + 1e-6/sin θ: the last term is a cosine's f32
    rounding through arccos near θ = 0 (θ from an f64 build)."""
    st = srv.state
    ids = st.stale_ids.long()
    repeated = len(set(ids.tolist())) < ids.numel()
    strip_ids = ids if repeated else torch.cat([ids[:-1], ids[:1]])
    x = st.delta_b.float().contiguous()
    stats = stats_of(x, T_SLICE, True).contiguous()
    got = gram_strip(x[strip_ids].contiguous(), x,
                     stats[strip_ids].contiguous(), stats,
                     strip_ids.to(torch.int32), LAM)
    want = ref.distance_strip_ref(x, stats, strip_ids, LAM)
    out = {"ring": ids.tolist(), "run_ring_repeats_an_id": repeated,
           "strip_rows": int(strip_ids.numel()),
           "strip_max_abs_err": check(
               "scenarios: the 2K strip vs plain", got, want, 1e-5, 1e-5)}
    _, dist_c, stats_c = ops.hics_selection_step_cached(
        st.delta_b, st.dist_cache, st.row_stats, st.stale_ids, T_SLICE,
        LAM, normalize=True, device=dev)
    _, dist_k = ops.hics_selection_step(st.delta_b, T_SLICE, LAM,
                                        normalize=True, device=dev)
    ent_p, dist_p = ref.selection_step_ref(st.delta_b, T_SLICE, LAM,
                                           normalize=True)
    written = st.delta_b.abs().sum(dim=1) > 0
    pairs = (written[:, None] & written[None, :]
             & ~torch.eye(written.numel(), dtype=torch.bool, device=dev))
    pick = lambda d: d[pairs]
    # the worst pair against the plain build, beside an f64 build
    d64, cos64 = _eq9_f64(st.delta_b, T_SLICE, LAM)
    gap = torch.where(pairs, (dist_c - dist_p).abs(), 0.0)
    u, v = divmod(int(torch.argmax(gap)), gap.shape[1])
    out["worst_pair"] = {
        "pair": [u, v], "cos_f64": float(cos64[u, v]),
        "cache": float(dist_c[u, v]), "plain": float(dist_p[u, v]),
        "pairwise": float(dist_k[u, v]), "f64": float(d64[u, v])}
    err64 = {name: float((d.double().cpu() - d64)[pairs.cpu()].abs().max())
             for name, d in (
        ("cache", dist_c), ("plain", dist_p), ("pairwise", dist_k))}
    out["max_abs_err_vs_f64"] = err64
    # arccos amplifies the cosine's f32 rounding by 1/sin θ: a pair
    # with cos 0.9998 (θ 0.019 rad, as severe skew makes) turns a few
    # ulps of its cosine into 1e-5 of distance, in every build alike
    sin64 = torch.sqrt((1.0 - cos64 ** 2).clamp(min=0.0)).float().to(dev)
    cond = pick(1e-6 / sin64.clamp(min=1e-3))
    out.update({
        "written_rows": int(written.sum()),
        "cache_vs_plain": check("scenarios: the 2K cache vs plain",
                                pick(dist_c), pick(dist_p), 1e-5 + cond,
                                1e-5),
        "cache_vs_pairwise": check("scenarios: the 2K cache vs pairwise",
                                   pick(dist_c), pick(dist_k), 1e-5 + cond,
                                   1e-5),
        "largest_conditioning_term": float(cond.max()),
        "entropy_vs_plain": check("scenarios: the 2K cached Ĥ vs plain",
                                  stats_c[written, 1], ent_p[written],
                                  5e-5),
        "bit_symmetric": bool(torch.equal(dist_c, dist_c.T))})
    require("scenarios: the 2K cache not bit-symmetric",
            out["bit_symmetric"])
    return out


def scenarios_phase(dev) -> tuple:
    """The heterogeneity scenarios, the multi-seed sweep and the async
    server at the slice's spec (paper-cnn at full width, N 50, K 5,
    10,000/2,000 samples, cap 800).  Returns the launches of the phase's
    main-path runs (each with the counts set to 0 just before it), by
    kernel and the strip's by epilogue."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, by_epi = {}, {}
    out = {"phase": "scenarios", "card": CARD,
           "partitions": partitions_vs_cpu(dev), "sweep": []}
    for scenario in SWEEP.scenarios:
        for selector in SWEEP.selectors:
            rec, n, e = sweep_cell(SWEEP, scenario, selector, dev)
            _add(launches, n)
            _add(by_epi, e)
            out["sweep"].append(rec)
    # the cell's seeds one after another through the scanned driver,
    # each run twice (the second without its capture)
    first, second = serial_seconds(SWEEP, "mixed_80_20", "hics", dev)
    n = len(SWEEP.seeds) * SWEEP.rounds
    out["serial"] = {"cell": "mixed_80_20/hics",
                     "serial_rounds_per_s_first": n / first,
                     "serial_rounds_per_s_second": n / second}

    # the async server at identity latency, B = M = K: the sync scanned
    # driver on the same data, bit for bit
    sync = build_pair(dataclasses.replace(SWEEP, seeds=(0,)), "mixed_80_20",
                      "hics", device=dev).servers[0]
    hs = sync.run()
    asrv = async_server("mixed_80_20", dev, ticks=SWEEP.rounds)
    ha, n, e = _launches_since_reset(asrv.run)
    _add(launches, n)
    _add(by_epi, e)
    same = {"selected": ha["selected"] == hs["selected"],
            "train_loss": ha["train_loss"] == hs["train_loss"],
            "params": all(torch.equal(a, b) for a, b in zip(
                _leaves(asrv.params), _leaves(sync.params)))}
    require(f"scenarios: identity async differs from sync {same}",
            all(same.values()))
    out["identity"] = {"bit_equal": same,
                       "ticks_per_s": ha["ticks_per_s"],
                       "sync_rounds_per_s": hs["rounds_per_s"]}
    del sync, asrv

    out["async"] = {}
    for scenario in ("stragglers_severe", "flash_crowd"):
        srv = async_server(scenario, dev, capacity=10, threshold=5)
        hist, n, e = _launches_since_reset(srv.run)
        _add(launches, n)
        _add(by_epi, e)
        out["async"][scenario] = async_record(
            f"scenarios async {scenario}", srv, hist)
        del srv
    srv = async_server("stragglers_severe", dev, capacity=20, threshold=10)
    require("scenarios: the M = 2K ring is not 2K long",
            srv.state.stale_ids.numel() == 2 * SWEEP.num_select)
    hist, n, e = _launches_since_reset(srv.run)
    _add(launches, n)
    _add(by_epi, e)
    rec = async_record("scenarios async M=2K", srv, hist)
    rec["stale_ring"] = stale_ring_checks(srv, dev)
    out["async"]["stragglers_severe_M10_B20"] = rec
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    aspec = dataclasses.replace(SWEEP, scenarios=ASYNC_SCENARIOS,
                                selectors=("hics",))
    res, n, e = _launches_since_reset(lambda: run_async_sweep(
        aspec, capacity=10, threshold=5, device=dev))
    _add(launches, n)
    _add(by_epi, e)
    out["async_sweep"] = {}
    for cell, c in res["grid"].items():
        require(f"scenarios async sweep {cell}: non-finite loss",
                bool(np.isfinite(c["train_loss"]).all()))
        out["async_sweep"][cell] = {
            key: c[key] for key in ("aggregations", "dropped_total",
                                    "mean_fill", "final_version",
                                    "final_acc", "wall_s")}
        out["async_sweep"][cell]["ticks_per_s"] = (
            len(aspec.seeds) * aspec.rounds / c["wall_s"])
    for name in ("fused_stats", "gram_update"):
        require(f"scenarios: {name} was not launched", launches[name] > 0)
    for epi in ("arccos", "cosine"):
        require(f"scenarios: no {epi} strip", by_epi[epi] > 0)
    out.update({"launches": launches, "launches_by_epilogue": by_epi,
                "seconds": time.perf_counter() - t0})
    emit(out)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, by_epi


#: the sync drivers' metric groups (the async server adds ``async``)
SYNC_GROUPS = ("selection", "training", "fairness")
#: the sweep cells of phase telemetry
TEL_SCENARIOS = ("mixed_80_20", "dir_severe")


def _np_spearman(a, b) -> float:
    """Spearman's rank correlation, ranks by a stable sort."""
    def ranks(v):
        r = np.empty(v.shape[0])
        r[np.argsort(v, kind="stable")] = np.arange(v.shape[0])
        return r - (v.shape[0] - 1) / 2
    ra, rb = ranks(a), ranks(b)
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom > 0 else 0.0


def telemetry_vs_history(tag, srv, hist) -> dict:
    """A run's telemetry against the host's recomputation from its
    history: ``fairness/*`` from the participants (counts exact, rates
    within 1e-6), ``selection/ent_*`` from its Ĥ (``bias_entropy``) and
    true entropies within 5e-5, those true entropies within 5e-6 of a
    CPU ``client_true_entropy``."""
    tel, n = srv.telemetry, srv.cfg.num_clients
    sel = np.asarray(hist["selected"])
    counts = np.cumsum([np.bincount(r, minlength=n) for r in sel], axis=0)
    p = counts / counts.sum(axis=1, keepdims=True)
    hp = -np.where(counts > 0, p * np.log(np.clip(p, 1e-12, None)),
                   0.0).sum(axis=1)
    fair = {"participation": (counts > 0).mean(axis=1),
            "eff_participation": np.exp(hp) / n}
    out = {"sel_counts_equal": bool(np.array_equal(
        tel["fairness/sel_counts"], counts))}
    out.update({f"{k}_max_abs_err": float(np.abs(
        tel[f"fairness/{k}"] - v).max()) for k, v in fair.items()})
    require(f"{tag}: fairness counts differ from the participants'",
            out["sel_counts_equal"])
    rate_err = max(out["participation_max_abs_err"],
                   out["eff_participation_max_abs_err"])
    require(f"{tag}: fairness rates off the participants' by {rate_err}",
            rate_err <= 1e-6)
    te_card = srv._true_ent.cpu()
    y, mask = srv.y.cpu(), srv.mask.cpu()
    te_cpu = client_true_entropy(y, mask, int(y.max()) + 1)
    out["true_entropy_vs_cpu"] = check(f"{tag}: true entropy vs CPU",
                                       te_card, te_cpu, 5e-6)
    ent = np.asarray(hist["bias_entropy"], np.float64)
    te = te_card.double().numpy()
    want = {
        "ent_mean": ent.mean(axis=1), "ent_std": ent.std(axis=1),
        "ent_selected_mean": np.asarray([ent[t, sel[t]].mean()
                                         for t in range(len(sel))]),
        "ent_mae": np.abs(ent - te).mean(axis=1),
        "ent_rank_corr": np.asarray([_np_spearman(e, te) for e in ent])}
    errs = {k: float(np.abs(tel[f"selection/{k}"] - v).max())
            for k, v in want.items()}
    require(f"{tag}: selection fields off the history's Ĥ {errs}",
            max(errs.values()) <= 5e-5)
    out["selection_max_abs_err"] = errs
    return out


def _same_runs(tag, a, b) -> dict:
    """Two runs' participants, train loss, final params and selector
    state, bit for bit."""
    (sa, ha), (sb, hb) = a, b
    same = {"selected": ha["selected"] == hb["selected"],
            "train_loss": ha["train_loss"] == hb["train_loss"],
            "params": all(torch.equal(x, y) for x, y in zip(
                _leaves(sa.params), _leaves(sb.params))),
            "state": all(torch.equal(x, y) for x, y in zip(sa.state,
                                                           sb.state))}
    require(f"{tag}: telemetry on differs from off {same}",
            all(same.values()))
    return same


def telemetry_sync(jit: bool, dev) -> tuple:
    """The slice's spec through one sync driver with telemetry off, then
    on (the sync groups, counts set to 0 just before it): bit-equal,
    one capture each in the graph driver, the fields against the
    history, and the cost: ms a replay with and without telemetry, in
    turns (graph), or the host loop's ms a round."""
    tag = f"telemetry {'graph' if jit else 'host'}"
    runs = []
    for groups in ((), SYNC_GROUPS):
        srv, _ = build(dataclasses.replace(SPEC, jit_rounds=jit,
                                           telemetry=groups), device=dev)
        hist, launches, _ = _launches_since_reset(srv.run)
        runs.append((srv, hist))
    (off, h_off), (on, h_on) = runs
    rec = {"bit_equal": _same_runs(tag, *runs), "launches": launches,
           "rounds_per_s": [h_off["rounds_per_s"], h_on["rounds_per_s"]]}
    rec.update(telemetry_vs_history(tag, on, h_on))
    if jit:
        rec["captures"] = [off.captures, on.captures]
        require(f"{tag}: captures {rec['captures']}",
                rec["captures"] == [1, 1])
        turns = [(name, replay_ms(g._graph)) for name, g in (
            ("off", off), ("on", on), ("on", on), ("off", off))]
        rec["replay_ms_in_turns"] = turns
        rec["replay_ms_off"] = [t for name, t in turns if name == "off"]
        rec["replay_ms_on"] = [t for name, t in turns if name == "on"]
    else:
        rec["ms_per_round_off"] = 1e3 * float(np.mean(h_off["wall_s"][1:]))
        rec["ms_per_round_on"] = 1e3 * float(np.mean(h_on["wall_s"][1:]))
    return rec, on, launches


def telemetry_async(graph_srv, dev) -> tuple:
    """The async server at identity latency (B = M = K) on the slice's
    client arrays, telemetry off then on (every group): bit-equal, one
    capture each, the ``async/*`` fields the history's."""
    tag = "telemetry async"
    arrays = [a.cpu().numpy() for a in (graph_srv.x, graph_srv.y,
                                        graph_srv.mask)]
    test = {k: v.cpu().numpy() for k, v in graph_srv.test.items()}
    init, apply, _ = make_classifier(get_config(SPEC.arch),
                                     input_dim=SPEC.data.dim)
    runs = []
    for groups in ((), GROUPS):
        acfg = AsyncConfig(
            num_clients=SPEC.num_clients, num_select=SPEC.num_select,
            ticks=ROUNDS, selector="hics", selector_kw=SELECTOR_KW,
            local=SPEC.local, eval_every=SPEC.eval_every, seed=SPEC.seed,
            telemetry=groups)
        srv = AsyncFederatedServer(init, apply, acfg, *arrays, test=test,
                                   device=dev)
        runs.append((srv, srv.run()))
    (off, _), (on, hist) = runs
    rec = {"bit_equal": _same_runs(tag, *runs),
           "captures": [off.captures, on.captures]}
    require(f"{tag}: captures {rec['captures']}", rec["captures"] == [1, 1])
    tel = on.telemetry
    fields = {}
    for field, key in (("fired", "fired"), ("fill", "buffer_fill"),
                       ("accepted", "accepted"), ("dropped", "dropped"),
                       ("version", "version")):
        fields[field] = bool(np.array_equal(
            tel[f"async/{field}"], np.asarray(hist[key], np.float32)))
    fields["version_lag_zero"] = bool((tel["async/version_lag"] == 0).all())
    fields["agg_ages_zero"] = bool((tel["async/agg_ages"] == 0).all())
    require(f"{tag}: async fields differ from the history {fields}",
            all(fields.values()))
    rec["async_fields_equal"] = fields
    rec.update(telemetry_vs_history(tag, on, hist))
    # identity latency is the sync scanned run: its telemetry too
    rec["sync_fields_bit_equal_to_graph"] = {
        k: bool(np.array_equal(v, tel[k]))
        for k, v in graph_srv.telemetry.items() if not k.startswith("async/")}
    rec["replay_ms"] = [replay_ms(off._graph), replay_ms(on._graph)]
    return rec, on


def telemetry_sweep(dev) -> tuple:
    """``run_sweep`` over :data:`TEL_SCENARIOS` × hics × 2 seeds with the
    sync groups: one capture a cell, fields (S, T, ...), each seed's
    fields bit-equal to its server's own scanned run."""
    spec = dataclasses.replace(SWEEP, scenarios=TEL_SCENARIOS,
                               selectors=("hics",), telemetry=SYNC_GROUPS)
    made, graph_cls = [], sweep_mod.RoundGraph

    class CountedGraph(graph_cls):
        """The sweep's graph, counting its captures."""
        def __init__(self, *args, **kwargs):
            made.append(1)
            super().__init__(*args, **kwargs)

    sweep_mod.RoundGraph = CountedGraph
    try:
        res = run_sweep(spec, device=dev)
    finally:
        sweep_mod.RoundGraph = graph_cls
    rec = {"captures": len(made), "cells": {}}
    require(f"telemetry sweep: {len(made)} captures for "
            f"{len(TEL_SCENARIOS)} cells", len(made) == len(TEL_SCENARIOS))
    seeds, rounds, n = len(spec.seeds), spec.rounds, spec.num_clients
    for scenario in TEL_SCENARIOS:
        tag = f"telemetry sweep {scenario}"
        cell = res["grid"][f"{scenario}/hics"]
        tel = cell["telemetry"]
        shapes_ok = (tel["fairness/sel_counts"].shape == (seeds, rounds, n)
                     and tel["training/loss"].shape == (seeds, rounds))
        require(f"{tag}: fields not (S, T, ...)", shapes_ok)
        pair = build_pair(spec, scenario, "hics", device=dev)
        same = []
        for i, srv in enumerate(pair.servers):
            srv.test = None
            srv.run()
            same.append(all(np.array_equal(v, tel[k][i])
                            for k, v in srv.telemetry.items()))
        require(f"{tag}: a seed's telemetry differs from its scanned run "
                f"{same}", all(same))
        rec["cells"][scenario] = {"shapes_ok": shapes_ok,
                                  "bit_equal_to_scanned": same,
                                  "wall_s": cell["wall_s"]}
        del pair
    return rec, res["grid"][f"{TEL_SCENARIOS[0]}/hics"]["telemetry"]


TRACE_CODE = """
import dataclasses, json, sys, torch
sys.path.insert(0, {root!r})
import chip_smoke
from repro_torch.fed import build
srv, _ = build(dataclasses.replace(chip_smoke.SPEC, rounds=2),
               device="cuda")
srv.step(0, srv.draw_round(0))
torch.cuda.synchronize()
with torch.profiler.profile() as prof:
    srv.step(1, srv.draw_round(1))
    torch.cuda.synchronize()
print(json.dumps(sorted({{e.key for e in prof.key_averages()
                         if e.key.startswith("kernels/")}})))
"""


def trace_ranges(dev) -> dict:
    """One host-loop round (round 1: its select refreshes the cache)
    profiled in a subprocess with ``REPRO_TRACE=1`` and here, without
    the switch: the ``kernels/*`` ranges each finds."""
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, REPRO_TRACE="1")
    proc = subprocess.run([sys.executable, "-c", TRACE_CODE.format(
        root=root)], env=env, capture_output=True, text=True, timeout=300,
        cwd=root)
    require(f"telemetry trace: the subprocess failed: {proc.stderr[-500:]}",
            proc.returncode == 0)
    with_switch = (json.loads(proc.stdout.strip().splitlines()[-1])
                   if proc.returncode == 0 else [])
    srv, _ = build(dataclasses.replace(SPEC, rounds=2), device=dev)
    srv.step(0, srv.draw_round(0))
    torch.cuda.synchronize()
    with torch.profiler.profile() as prof:
        srv.step(1, srv.draw_round(1))
        torch.cuda.synchronize()
    without = sorted({e.key for e in prof.key_averages()
                      if e.key.startswith("kernels/")})
    found = {"kernels/fused_row_stats",
             "kernels/hics_selection_step_cached"} & set(with_switch)
    require(f"telemetry trace: no kernel range with REPRO_TRACE=1 "
            f"({with_switch})", bool(found))
    require(f"telemetry trace: kernel ranges without the switch {without}",
            not without)
    return {"with_switch": with_switch, "without_switch": without}


def export_round_trip(graph_srv, sweep_tel) -> dict:
    """``write_run`` and ``write_sweep`` to JSONL and back."""
    live = {k: v for k, v in graph_srv.telemetry.items() if 0 not in v.shape}
    with tempfile.TemporaryDirectory() as tmp:
        write_run(Path(tmp) / "run.jsonl", graph_srv.telemetry,
                  meta={"driver": "chip_smoke"})
        recs = read_jsonl(Path(tmp) / "run.jsonl")
        back = telemetry_from_records(recs[1:])
        run_ok = (sorted(back) == sorted(live) == recs[0]["fields"] and all(
            np.array_equal(back[k].astype(v.dtype), v)
            for k, v in live.items()))
        write_sweep(Path(tmp) / "sweep.jsonl", {"cell": sweep_tel})
        recs = read_jsonl(Path(tmp) / "sweep.jsonl")
        seeds = np.asarray(sweep_tel["training/loss"]).shape[0]
        sweep_ok = all(np.array_equal(telemetry_from_records(
            [r for r in recs[1:] if r["seed"] == s])["training/loss"]
            .astype(np.float32), sweep_tel["training/loss"][s])
            for s in range(seeds))
    require(f"telemetry export: round trip run {run_ok} sweep {sweep_ok}",
            run_ok and sweep_ok)
    return {"write_run": run_ok, "write_sweep": sweep_ok,
            "header_env": recs[0]["env"]}


def telemetry_phase(dev) -> dict:
    """Telemetry at the slice's spec (paper-cnn, N 50, K 5, 14 rounds,
    HiCS incremental) in all four drivers: each run with telemetry on
    bit-equal to its run with it off and captured once; the fields
    against the host's recomputation; the same field set from every
    driver; the JSONL export; the env stamp; the ``REPRO_TRACE`` ranges.
    Returns the launches of the graph driver's run with telemetry on."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"phase": "telemetry", "card": CARD}
    out["graph"], graph_srv, launches = telemetry_sync(True, dev)
    out["host"], host_srv, _ = telemetry_sync(False, dev)
    out["async"], async_srv = telemetry_async(graph_srv, dev)
    out["sweep"], sweep_tel = telemetry_sweep(dev)
    sets = {"graph": sorted(graph_srv.telemetry),
            "host": sorted(host_srv.telemetry),
            "async": sorted(async_srv.telemetry),
            "sweep": sorted(sweep_tel)}
    same_set = all(v == sets["graph"] for v in sets.values())
    require(f"telemetry: field sets differ across drivers", same_set)
    out["same_field_set"] = same_set
    out["fields"] = sets["graph"]
    out["export"] = export_round_trip(graph_srv, sweep_tel)
    stamp = env_stamp()
    require(f"telemetry: env stamp {stamp}",
            stamp["backend"] == "cuda"
            and stamp["device_kind"] == torch.cuda.get_device_name(0))
    out["env_stamp"] = stamp
    out["trace"] = trace_ranges(dev)
    for name in ("fused_stats", "gram_update"):
        require(f"telemetry: {name} was not launched", launches[name] > 0)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    del graph_srv, host_srv, async_srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the rest of the LM substrate: the sweep CLI, the one-card dry run,
# qwen2.5-3b's bf16 steps at full width and depth, the local multi-host
# mode
# ---------------------------------------------------------------------------

#: one arch of each family for the dry run, rwkv first: its WKV loop's
#: train count is the longest
SUBSTRATE_ARCHS = ("rwkv6-3b", "qwen2.5-3b", "granite-moe-1b-a400m",
                   "pixtral-12b", "zamba2-7b", "seamless-m4t-medium")
#: the dry run's worker processes (the card's host has 8 cores)
SUBSTRATE_WORKERS = 6
#: the device memory the dry run's peak must fit for qwen2.5-3b's steps:
#: 10 GB of the card's 80 are left for what the meta pass does not hold
#: (the allocator's rounding, the libraries' workspaces)
SUBSTRATE_LIMIT = 70e9
#: the batches run, at most (``fit_batch``'s top): the dry run's fit,
#: cut for the script's time (a 32k prefill takes seconds a sequence)
SUBSTRATE_CAPS = {"train_4k": 4, "prefill_32k": 1, "decode_32k": 128}


def _sanitized_equal(got, want) -> bool:
    """The JSON of the CLI's --out against a run_sweep result, every key
    but the host-clock wall_s."""
    want = json.loads(json.dumps(sweep_cli._sanitize(want)))
    if got["spec"] != want["spec"]:
        return False
    return all(got["grid"][cell][k] == v for cell, c in want["grid"].items()
               for k, v in c.items() if k != "wall_s")


def substrate_sweep_cli(dev) -> tuple:
    """``repro_torch.launch.sweep --quick --host --telemetry`` into a
    temporary directory, with the launch counts set to 0 just before it
    and read just after; its --out against ``run_sweep`` of the same
    spec, bit for bit; its --bench and telemetry read back."""
    with tempfile.TemporaryDirectory() as tmp:
        t = Path(tmp)
        argv = ["--quick", "--host", "--telemetry", str(t / "tel.jsonl"),
                "--out", str(t / "out.json"), "--bench",
                str(t / "bench.json"), "--device", str(dev)]
        kbuild.reset_launches()
        t0 = time.perf_counter()
        sweep_cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(kbuild.launches)
        epi = dict(kbuild.variant_launches["gram_update"]["epilogue"])
        out = json.loads((t / "out.json").read_text())
        bench = json.loads((t / "bench.json").read_text())
        records = read_jsonl(t / "tel.jsonl")
    groups = ("selection", "training", "fairness")
    spec = sweep_cli.specs(sweep_cli.parse_args(argv), groups)[0]
    again = run_sweep(spec, device=dev)
    same = _sanitized_equal(out, again)
    require("substrate sweep CLI: --out differs from run_sweep", same)
    require("substrate sweep CLI: fused_stats was not launched",
            launches["fused_stats"] > 0)
    require("substrate sweep CLI: no arccos strip", epi["arccos"] > 0)
    require("substrate sweep CLI: no telemetry records", len(records) > 0)
    require("substrate sweep CLI: bench keys",
            sorted(bench) == ["env", "grid", "num_clients", "rounds",
                              "seeds", "what"])
    return {"seconds": seconds, "bit_equal_to_run_sweep": same,
            "telemetry_records": len(records),
            "final_acc_mean": {c: v["final_acc_mean"]
                               for c, v in out["grid"].items()},
            "bench": bench["grid"], "bench_env": bench["env"]}, launches, epi


def substrate_dryrun_submit(ex) -> tuple:
    """Submit qwen2.5-3b's batch that fits :data:`SUBSTRATE_LIMIT` at
    each shape it runs (first: the card's steps wait for them), then
    the one-card dry run of one arch a family × the four shapes, to
    worker processes (meta tensors only): the card's work of the phase
    runs meanwhile.  Returns the futures."""
    fits = {sh: ex.submit(dryrun.fit_batch, "qwen2.5-3b", sh,
                          SUBSTRATE_LIMIT, cap)
            for sh, cap in SUBSTRATE_CAPS.items()}
    # the full-depth train and prefill counts before the short decode
    # ones, so that the workers finish together
    recs = {(a, sh): ex.submit(dryrun.run_combo, a, sh)
            for sh in SHAPES for a in SUBSTRATE_ARCHS}
    return recs, fits


def substrate_dryrun_table(recs) -> dict:
    """Each dry-run record's status and, where ok, its bytes, peak, fit
    and roofline bound."""
    table = {}
    for (arch, sh), fut in recs.items():
        rec = fut.result()
        require(f"substrate dryrun {arch} {sh}: {rec['status']}",
                rec["status"] in ("ok", "skipped"))
        row = {"status": rec["status"]}
        if rec["status"] == "ok":
            r = rec["roofline"]
            row.update({
                "state_gb": rec["state_bytes_global"] / 1e9,
                "cache_gb": rec.get("cache_bytes_global", 0) / 1e9,
                "peak_gb": rec["peak_live_bytes"] / 1e9,
                "fits_one_card": rec["fits_one_card"],
                "floor_ms": rec["floor"]["roofline_bound_s"] * 1e3,
                "floor_by": rec["floor"]["bottleneck"],
                "eager_traffic_ms": r["roofline_bound_s"] * 1e3,
                "useful_flops_ratio": r["useful_flops_ratio"],
                "count_s": rec["count_s"]})
        table[f"{arch}/{sh}"] = row
    return table


def _qwen_batch(cfg, b, s, dev, train=True):
    gen = torch.Generator(device=dev).manual_seed(b * s)

    def ints(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)
    batch = {"tokens": ints(s)}
    if train:
        batch["targets"] = ints(s)
        batch["loss_mask"] = torch.ones((b, s), device=dev)
    return batch


def _timed(fn, reps: int = 1):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3 / reps


def _beside_dryrun(rec, run) -> dict:
    """A card run {ms, peak, ...} beside the dry run's record at its
    batch: its ms beside the step's floor (model_flops at the bf16 peak
    against the least bytes it must move) and beside the eager-traffic
    estimate (the meta count's FLOPs and unfused op bytes, an upper
    estimate of the traffic, no floor); its peak memory beside the dry
    run's bytes."""
    floor = rec["floor"]["roofline_bound_s"] * 1e3
    eager = rec["roofline"]["roofline_bound_s"] * 1e3
    run = dict(run)
    ms, peak = run.pop("ms"), run.pop("peak")
    return {**run, "ms": ms, "floor_ms": floor, "floor_share": floor / ms,
            "floor_by": rec["floor"]["bottleneck"],
            "floor_flops": rec["floor"]["flops"],
            "floor_bytes": rec["floor"]["bytes"],
            "eager_traffic_ms": eager, "eager_traffic_share": eager / ms,
            "peak_memory_gb": peak / 1e9,
            "dryrun_peak_gb": rec["peak_live_bytes"] / 1e9,
            "card_over_dryrun_peak": peak / rec["peak_live_bytes"],
            "dryrun_state_gb": rec["state_bytes_global"] / 1e9,
            "dryrun_cache_gb": rec.get("cache_bytes_global", 0) / 1e9}


def substrate_qwen(dev, batches) -> dict:
    """qwen2.5-3b at published width and depth (36 layers, d 2,048):
    one bf16 train step (adam 1e-4, the clip, per-layer recompute) at
    train_4k's length, a bf16 prefill_32k and a bf16 decode_32k step,
    each at the batch the dry run fits in 70 GB (cut for time), timed
    after a warm-up: its ms and peak memory (:func:`_beside_dryrun` puts
    them beside the dry run's bound and bytes)."""
    api = get_model("qwen2.5-3b")
    cfg = api.cfg
    out = {}
    bf16 = torch.bfloat16
    gc.collect()
    torch.cuda.empty_cache()

    b, s = batches["train_4k"], SHAPES["train_4k"].seq_len
    torch.cuda.reset_peak_memory_stats()
    opt = adam(1e-4)
    state = make_init_state(api, opt)(0, device=dev)
    step = make_train_step(api, opt, dtype=bf16)
    batch = _qwen_batch(cfg, b, s, dev)
    state, m0 = step(state, batch)
    (state, m1), ms = _timed(lambda: step(state, batch))
    losses = [float(m0["loss"]), float(m1["loss"])]
    require("substrate qwen train: non-finite loss",
            all(np.isfinite(losses)))
    require("substrate qwen train: the second step's loss is not lower",
            losses[1] < losses[0])
    out["train_4k"] = dict(ms=ms, peak=torch.cuda.max_memory_allocated(),
                           batch=b, seq_len=s, losses=losses,
                           grad_norm=float(m1["grad_norm"]))
    del state, step, batch, m0, m1
    gc.collect()
    torch.cuda.empty_cache()

    params = tree_map(lambda t: t.to(bf16), api.init(0, device=dev))
    gc.collect()
    torch.cuda.empty_cache()
    prefill = make_prefill_step(api, dtype=bf16)
    b, s = batches["prefill_32k"], SHAPES["prefill_32k"].seq_len
    with torch.no_grad():
        prefill(params, _qwen_batch(cfg, b, 256, dev, train=False))
        torch.cuda.reset_peak_memory_stats()
        batch = _qwen_batch(cfg, b, s, dev, train=False)
        (tok, cache), ms = _timed(lambda: prefill(params, batch))
        require("substrate qwen prefill: bad tokens",
                tok.shape == (b, 1) and bool((tok >= 0).all())
                and bool((tok < cfg.vocab_size).all()))
        require("substrate qwen prefill: bad cache",
                tuple(cache["k"].shape) == (cfg.num_layers, b, s,
                                            cfg.num_kv_heads,
                                            cfg.resolved_head_dim())
                and bool(torch.isfinite(cache["k"][-1, :, -1]).all()))
        out["prefill_32k"] = dict(ms=ms,
                                  peak=torch.cuda.max_memory_allocated(),
                                  batch=b, seq_len=s)
        del cache, batch, tok
        gc.collect()
        torch.cuda.empty_cache()

        b, s = batches["decode_32k"], SHAPES["decode_32k"].seq_len
        serve_step = make_serve_step(api, dtype=bf16)
        torch.cuda.reset_peak_memory_stats()
        cache = api.init_cache(b, s, device=dev)
        for name in ("k", "v"):
            cache[name].normal_()
        token = _qwen_batch(cfg, b, 1, dev, train=False)["tokens"]
        serve_step(params, cache, {"token": token, "pos": s - 1})
        (tok, cache), ms = _timed(lambda: serve_step(
            params, cache, {"token": token, "pos": s - 1}), reps=3)
        require("substrate qwen decode: bad tokens",
                tok.shape == (b, 1) and bool((tok >= 0).all())
                and bool((tok < cfg.vocab_size).all()))
        out["decode_32k"] = dict(ms=ms,
                                 peak=torch.cuda.max_memory_allocated(),
                                 batch=b, seq_len=s)
        del cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def substrate_phase(dev) -> dict:
    """The sweep CLI (its launches counted), the dry run (in worker
    processes while the card works), qwen2.5-3b's bf16 steps and
    ``launch.multihost --local --task train`` for 2 steps.  Returns the
    sweep CLI's launches, by kernel and the strip's by epilogue."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"phase": "substrate", "card": CARD}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(SUBSTRATE_WORKERS,
                                                mp_context=ctx) as ex:
        recs, fits = substrate_dryrun_submit(ex)
        out["sweep_cli"], launches, epi = substrate_sweep_cli(dev)
        fits = {sh: f.result() for sh, f in fits.items()}
        batches = {sh: fit["batch"] for sh, fit in fits.items()}
        for sh, b in batches.items():
            require(f"substrate dryrun: no qwen2.5-3b batch of {sh} fits",
                    b > 0)
        runs = substrate_qwen(dev, batches)
        out["qwen"] = {sh: _beside_dryrun(fits[sh].pop("record"), run)
                       for sh, run in runs.items()}
        out["dryrun"] = {"table": substrate_dryrun_table(recs),
                         "fits": fits, "batches": batches}
    out["dryrun"]["seconds_after_start"] = time.perf_counter() - t0
    steps = multihost.main(["--local", "--task", "train", "--steps", "2",
                            "--device", str(dev)])
    require("substrate multihost: not 2 finite steps",
            len(steps) == 2 and all(np.isfinite(m["loss"]) for m in steps))
    out["multihost"] = steps
    out.update({"launches": launches, "launches_by_epilogue": epi,
                "seconds": time.perf_counter() - t0})
    emit(out)
    return launches, epi


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _at(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


#: the production dry run of phase ``sharded``: (arch, shape, policy)
#: on the 16x16 mesh, each in a worker process with its own fake world
SHARDED_DRYRUN = (("qwen2.5-3b", "train_4k", "2d"),
                  ("qwen2.5-3b", "train_4k", "fsdp"),
                  ("mixtral-8x22b", "decode_32k", "ep"),
                  ("deepseek-coder-33b", "prefill_32k", "2d"))
#: the one-card mesh's train and prefill length and batch
SHARDED_SEQ, SHARDED_BATCH = SHAPES["train_4k"].seq_len, 1
#: the runs whose steps are timed (fsdp's would read as 2d's: on a
#: (1, 1) mesh both run the same local ops through DTensor)
SHARDED_TIMED = ("unsharded", "2d")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / (scale if scale else 1.0)


def _tree_check(got, want) -> dict:
    """The largest leaf's max |got - want| / max |want| and whether
    every leaf is bit-equal; ``want`` may lie on the host."""
    got, want = _leaves(sharding.gather(got)), _leaves(want)
    errs, equal = [], True
    for g, w in zip(got, want):
        w = w.to(g.device)
        errs.append(_rel_err(g, w))
        equal = equal and torch.equal(g, w)
    return {"max_rel_err": max(errs), "bit_equal": equal,
            "leaves": len(errs)}


def _counted(fn):
    """``fn()`` under a collective counter: (its result, the bytes of
    each kind of collective it ran)."""
    counter = CollectiveCounter()
    with counter:
        out = fn()
    torch.cuda.synchronize()
    return out, counter.collectives


def sharded_one_card(dev) -> dict:
    """qwen2.5-3b at published width and depth on a real one-card mesh
    (NCCL, world 1, the (1, 1) host mesh): a bf16 train step at
    train_4k's length, a bf16 prefill of as many tokens and a decode
    step after it, unsharded and on DTensor state under ``2d`` and
    ``fsdp``, the same inputs from the same seed.  The first step of
    each is held to the unsharded one (losses and params within 1e-6
    relative, bit-equality expected: a (1, 1) mesh runs the same local
    ops); a second step counts the collectives (none expected) under a
    Python dispatch mode, and a third, with no mode over it, is timed
    (unsharded and 2d; so are their prefill and decode).  Deterministic algorithms are on for the compared steps (the
    embedding's backward on the card otherwise sums with atomics in
    any order, and adam's first step, ±lr where |g| >> eps, turns a
    last-bit difference of a gradient into one of lr) and off for the
    timed ones."""
    deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        return _sharded_one_card(dev)
    finally:
        torch.use_deterministic_algorithms(deterministic)


def _exact(on: bool) -> None:
    torch.use_deterministic_algorithms(on, warn_only=True)


def _sharded_one_card(dev) -> dict:
    api = get_model("qwen2.5-3b")
    cfg = api.cfg
    bf16 = torch.bfloat16
    mesh = make_host_mesh("cuda")
    policies = {"unsharded": None,
                **{m: sharding.ShardingPolicy(mesh, m)
                   for m in ("2d", "fsdp")}}
    batch = _qwen_batch(cfg, SHARDED_BATCH, SHARDED_SEQ, dev)
    prompt = {"tokens": batch["tokens"]}
    out = {"batch": SHARDED_BATCH, "seq_len": SHARDED_SEQ}
    base = {}
    for name, pol in policies.items():
        gc.collect()
        torch.cuda.empty_cache()
        sharding.REPLICATED_OPS.clear()
        sharding.COPIED_VIEWS.clear()
        row = {}
        opt = adam(1e-4)
        state = make_init_state(api, opt)(0, device=dev)
        step = make_train_step(api, opt, dtype=bf16)
        data = batch
        if pol is not None:
            state, data = shard_state(state, pol), shard_batch(batch, pol)
        with sharding.use_policy(pol):
            # the compared step with no dispatch mode over it: a Python
            # mode changes how a bias's gradient is reduced, by the last
            # bit (adam's first step turns that into a change of lr)
            _exact(True)
            state, m0 = step(state, data)
            torch.cuda.synchronize()
            _exact(False)
            row["train_loss"] = loss = float(m0["loss"])
            if pol is None:
                base["loss"] = loss
                base["params"] = tree_map(lambda t: t.to("cpu", copy=True),
                                          state["params"])
            else:
                row["train_loss_rel_err"] = abs(loss - base["loss"]) / abs(
                    base["loss"])
                row["train_params"] = _tree_check(state["params"],
                                                  base["params"])
                row["train_replicated_ops"] = dict(sharding.REPLICATED_OPS)
                row["train_copied_views"] = dict(sharding.COPIED_VIEWS)
            if pol is not None:     # a step under the collective counter
                (state, _), row["train_collectives"] = _counted(
                    lambda: step(state, data))
            if name in SHARDED_TIMED:    # a step with no mode over it
                (state, m1), row["train_ms"] = _timed(
                    lambda: step(state, data))
                row["timed_step_loss"] = float(m1["loss"])
                del m1
        del state, m0
        out[name] = row
    del base["params"]
    gc.collect()
    torch.cuda.empty_cache()

    params = tree_map(lambda t: t.to(bf16), api.init(0, device=dev))
    prefill = make_prefill_step(api, dtype=bf16, cache_extra=1)
    serve_step = make_serve_step(api, dtype=bf16)
    with torch.no_grad():
        for name, pol in policies.items():
            gc.collect()
            torch.cuda.empty_cache()
            row = out[name]
            p = params if pol is None else shard_params(params, pol)
            b = prompt if pol is None else shard_batch(prompt, pol)
            with sharding.use_policy(pol):
                (tok, cache), pcoll = _counted(lambda: prefill(p, b))
                if name in SHARDED_TIMED:
                    _, row["prefill_ms"] = _timed(lambda: prefill(p, b))
                dec = {"token": tok, "pos": SHARDED_SEQ}
                if pol is not None:
                    dec = shard_batch(dec, pol)
                (tok2, cache), dcoll = _counted(
                    lambda: serve_step(p, cache, dec))
                if name in SHARDED_TIMED:
                    (_, cache), row["decode_ms"] = _timed(
                        lambda: serve_step(p, cache, dec))
            tok, tok2 = sharding.gather(tok), sharding.gather(tok2)
            kv = {k: sharding.gather(v)[:, :, :SHARDED_SEQ + 1]
                  for k, v in cache.items()}
            if pol is None:
                base.update(tok=tok, tok2=tok2, kv={
                    k: v.cpu() for k, v in kv.items()})
            else:
                row["prefill_token_equal"] = torch.equal(tok, base["tok"])
                row["decode_token_equal"] = torch.equal(tok2, base["tok2"])
                row["cache"] = _tree_check(kv, base["kv"])
                row["serve_collectives"] = {
                    k: pcoll[k] + dcoll.get(k, 0.0) for k in pcoll}
            del cache, kv, tok, tok2, p
    del params
    for name, pol in policies.items():
        if pol is None:
            continue
        row = out[name]
        require(f"sharded {name}: train loss off the unsharded one's",
                row["train_loss_rel_err"] <= 1e-6)
        require(f"sharded {name}: params off the unsharded step's",
                row["train_params"]["max_rel_err"] <= 1e-6)
        require(f"sharded {name}: prefill or decode token differs",
                row["prefill_token_equal"] and row["decode_token_equal"])
        require(f"sharded {name}: cache off the unsharded one",
                row["cache"]["max_rel_err"] <= 1e-6)
        moved = (sum(row["train_collectives"].values())
                 + sum(row["serve_collectives"].values()))
        require(f"sharded {name}: {moved} collective bytes on one card",
                moved == 0)
    return out


def _dryrun_row(rec) -> dict:
    """One production dry-run record: per-chip state and cache, FLOPs,
    bytes, peak and collective bytes, and the roofline's terms."""
    require(f"sharded dryrun {rec['arch']} {rec['shape']} "
            f"{rec.get('policy')}: {rec['status']} {rec.get('error', '')}",
            rec["status"] == "ok")
    if rec["status"] != "ok":
        return {"status": rec["status"], "error": rec.get("error")}
    r = rec["roofline"]
    coll = rec["collectives_bytes"]
    require(f"sharded dryrun {rec['arch']}: no collectives on 256 chips",
            coll["total_weighted"] > 0 and rec["chips"] == 256)
    return {"chips": rec["chips"],
            "state_gb_per_chip": rec["state_bytes_per_chip"] / 1e9,
            "cache_gb_per_chip": rec.get("cache_bytes_per_chip", 0) / 1e9,
            "flops_per_chip": rec["flops_per_chip"],
            "bytes_per_chip": rec["bytes_per_chip"],
            "peak_gb_per_chip": rec["peak_live_bytes"] / 1e9,
            "collectives_bytes": coll,
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"], "bottleneck": r["bottleneck"],
            "useful_flops_ratio": r["useful_flops_ratio"],
            "replicated_ops": rec["replicated_ops"],
            "copied_views": rec["copied_views"],
            "count_s": rec["count_s"]}


def sharded_phase(dev) -> None:
    """The multi-device layer: the production dry run of
    :data:`SHARDED_DRYRUN` in worker processes on ``meta`` while the card
    runs :func:`sharded_one_card` on a real one-card mesh."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"phase": "sharded", "card": CARD}
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    with concurrent.futures.ProcessPoolExecutor(len(SHARDED_DRYRUN),
                                                mp_context=ctx) as ex:
        futs = {f"{a}/{sh}/pod1/{pol}": dryrun.mesh_combo_in_worker(
            a, sh, "pod1", pol, pool=ex) for a, sh, pol in SHARDED_DRYRUN}
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                                world_size=1, rank=0)
        try:
            out["one_card_mesh"] = sharded_one_card(dev)
        finally:
            dist.destroy_process_group()
        out["one_card_seconds"] = time.perf_counter() - t0
        out["dryrun"] = {}
        for key, fut in futs.items():
            try:
                out["dryrun"][key] = _dryrun_row(fut.result())
            except Exception as e:  # the worker's failure, recorded
                require(f"sharded dryrun {key}: {e!r}", False)
                out["dryrun"][key] = {"status": "error", "error": repr(e)}
    out["seconds"] = time.perf_counter() - t0
    emit(out)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    alone = ("graph_rounds", "lm_train", "local_algos", "finetune_example",
             "scenarios", "telemetry", "transformer_family",
             "model_families", "substrate", "sharded")
    if argv and (len(argv) > 1 or argv[0] not in alone):
        print(f"usage: chip_smoke.py [{' | '.join(alone)}]", file=sys.stderr)
        return 2
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(CARD, flush=True)
    dev = torch.device("cuda", 0)
    started = time.perf_counter()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0))})
    t0 = time.perf_counter()
    reports = kbuild.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
                    for name, log in reports.items()}})

    if argv:                 # one phase alone (graph_rounds: its own host runs)
        {"graph_rounds": lambda: graph_rounds_phase(dev, {}),
         "lm_train": lambda: lm_train_phase(dev),
         "local_algos": lambda: local_algos_phase(dev),
         "finetune_example": lambda: finetune_example_phase(dev),
         "scenarios": lambda: scenarios_phase(dev),
         "telemetry": lambda: telemetry_phase(dev),
         "transformer_family": lambda: (serve_kernels_phase(dev),
                                        transformer_family_phase(dev)),
         "model_families": lambda: (serve_kernels_phase(dev),
                                    model_families_phase(dev)),
         "substrate": lambda: substrate_phase(dev),
         "sharded": lambda: sharded_phase(dev),
         }[argv[0]]()
        for f in failures:
            print("FAILED:", f, file=sys.stderr)
        return 1 if failures else 0

    (slice_cases, path_strip, modes, stats_timed, pair_timed,
     lm_strip) = kernel_phase(dev)
    server, hist, launches = slice_phase(dev)
    host_runs = {"hics": host_record(hist, server.state)}
    scratch_launches, host_runs["hics-scratch"] = from_scratch_phase(
        server, hist, dev)
    del server
    bf16_variants, bf16_scratch_variants, records = hics_bf16_phase(dev)
    host_runs.update(records)
    feature_launches, records = baselines_phase(dev)
    host_runs.update(records)
    graph_totals, graph_variants = graph_rounds_phase(dev, host_runs)
    del host_runs
    local_launches, local_graph_launches = local_algos_phase(dev)
    serve_cases, entropy_launches = serve_kernels_phase(dev)
    res, serve_launches = serve_phase(dev)
    serve_parity_phase(res, dev)
    del res
    family_launches = transformer_family_phase(dev)
    mf_launches = model_families_phase(dev)
    lm_launches = lm_train_phase(dev)
    ft_launches = finetune_example_phase(dev)
    scn_launches, scn_epilogues = scenarios_phase(dev)
    tel_launches = telemetry_phase(dev)
    sub_launches, sub_epilogues = substrate_phase(dev)
    sharded_phase(dev)

    # the strip kernel's three epilogues, each counted on its own path:
    # arccos in the HiCS slice and its bf16 run, cosine in the cs run,
    # l2 in the divfl-selected run; the Gram kernels' operand modes: f32
    # on the f32 paths, bf16 in the two runs with gram_in_bf16=True
    bf16_strip = bf16_variants["gram_update"]["operands"]["bf16"]
    bf16_pairwise = bf16_scratch_variants["pairwise"]["operands"]["bf16"]
    by_epilogue = {"arccos": launches["gram_update"] + bf16_strip,
                   **feature_launches}
    by_variant = {
        "gram_update": {"f32": sum(by_epilogue.values()) - bf16_strip,
                        "bf16": bf16_strip},
        "pairwise": {"f32": scratch_launches["pairwise"],
                     "bf16": bf16_pairwise}}
    counts = {"fused_stats": launches["fused_stats"],
              "gram_update": sum(by_epilogue.values()),
              "pairwise": sum(by_variant["pairwise"].values()),
              "hetero_entropy": entropy_launches["hetero_entropy"],
              "decode_attention": serve_launches["decode_attention"]}
    cases = dict(slice_cases, **serve_cases)
    # the timed case of each kernel: the slice's shape for the selection
    # kernels, 64 x 151,936 f32 for entropy, one decode_32k layer
    timed_case = {name: c[0] for name, c in slice_cases.items()}
    timed_case["hetero_entropy"] = serve_cases["hetero_entropy"][2]
    timed_case["decode_attention"] = serve_cases["decode_attention"][-1]
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        timed = timed_case[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed.get("library_ms")})
    # the split plan and device time at each timed case of the stats
    # kernels and the decode kernel; the stats kernels also at vocab
    # width (fused_stats: 64 and 2 rows; hetero_entropy: bf16)
    for kern in (kernels[0], kernels[2], kernels[3], kernels[4]):
        kern.update({key: timed_case[kern["name"]][key]
                     for key in ("splits", "device_ms", "bound_share")})
    keys = ("case", "splits", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_share")
    kernels[0]["wide"] = [{key: c[key] for key in keys} for c in stats_timed]
    # pairwise at 512×512×1024 and 256×151,936, beside x @ x.T
    kernels[2]["wide"] = [{key: c[key] for key in keys + (
        "bound_by", "gemm_device_ms", "max_abs_err")} for c in pair_timed]
    kernels[3]["wide"] = [{key: serve_cases["hetero_entropy"][3][key]
                           for key in keys}]
    # the decode kernel at dh 256, gemma's serve shape, f32 and bf16
    kernels[4]["dh256"] = [
        {key: c[key] for key in keys + ("bound_by", "library_ms",
                                        "max_abs_err")}
        for c in serve_cases["decode_attention"]
        if "dh256,S512" in c["case"] and "ms" in c]
    # dh 112, zamba2's serve shape, f32 and bf16
    kernels[4]["dh112"] = [
        {key: c[key] for key in keys + ("bound_by", "library_ms",
                                        "max_abs_err")}
        for c in serve_cases["decode_attention"]
        if "dh112,S512" in c["case"] and "ms" in c]
    # the shapes of the runtime row width and the chunked group, timed
    kernels[4]["new_shapes"] = [
        {key: c[key] for key in keys + ("bound_by", "library_ms",
                                        "max_abs_err", "plan")}
        for c in serve_cases["decode_attention"]
        if "ms" in c and c["plan"]["chunks"] + (not c["plan"]["fixed"]) > 1]
    # the strip kernel per epilogue: its launches on its own path and
    # its timed case at that path's shape (arccos: the slice's K5×N50×
    # C10; cosine and l2: the baselines' K5×N50×F158,570)
    strip = kernels[1]
    strip["launches_by_epilogue"] = by_epilogue
    # (cosine and l2 run in bf16 on no path: cs and divfl take no
    # gram_in_bf16, as in the reference)
    strip["epilogues"] = {
        epi: dict(case, launches=by_epilogue.get(epi)) for epi, case in
        dict(path_strip, arccos=timed_case["gram_update"]).items()}
    # the Gram kernels per operand mode: launches on their paths and the
    # timed case at the slice's shape
    for kern in kernels[1:3]:
        kern["launches_by_variant"] = by_variant[kern["name"]]
        kern["operand_modes"] = {
            mode: dict(case, launches=by_variant[kern["name"]][mode])
            for mode, case in modes[kern["name"]].items()}
        for mode, n in by_variant[kern["name"]].items():
            require(f"{kern['name']}: no {mode} launch on its path", n > 0)
    for epi, n in by_epilogue.items():
        require(f"gram_update: no {epi} launch on its path", n > 0)
    # the launches of phase graph_rounds' nine runs (one eager warm-up
    # round each, then the captured launches times the replays)
    for kern in kernels:
        kern["launches_graph"] = graph_totals[kern["name"]]
        if kern["name"] in graph_variants:
            kern["launches_graph_by_variant"] = graph_variants[kern["name"]]
        # phase lm_train: qwen2.5-3b's federated fine-tune
        kern["launches_lm"] = lm_launches[kern["name"]]
        # phase local_algos: its eight host runs and two graph runs;
        # phase finetune_example: the ~100M example
        kern["launches_local_algos"] = local_launches[kern["name"]]
        kern["launches_local_algos_graph"] = local_graph_launches[
            kern["name"]]
        kern["launches_finetune"] = ft_launches[kern["name"]]
        # phase scenarios: the sweeps and the async runs
        kern["launches_scenarios"] = scn_launches[kern["name"]]
        # phase telemetry: the graph driver's run with telemetry on
        kern["launches_telemetry"] = tel_launches[kern["name"]]
        # phase transformer_family: its serves, fine-tunes and example
        kern["launches_transformer_family"] = family_launches[kern["name"]]
        # phase model_families: its serves, fine-tunes and example
        kern["launches_model_families"] = mf_launches[kern["name"]]
        # phase substrate: the sweep CLI at its --quick spec
        kern["launches_substrate"] = sub_launches[kern["name"]]
    strip["launches_scenarios_by_epilogue"] = scn_epilogues
    strip["launches_substrate_by_epilogue"] = sub_epilogues
    # the arccos strip at the LM fine-tune's K2×N8×C151,936
    strip["lm_path"] = {key: lm_strip[key] for key in keys + (
        "bound_by", "max_abs_err", "unsplit_max_abs_err")}
    emit({"phase": "total", "seconds": time.perf_counter() - started})
    emit({"kernels": kernels})
    if failures:
        for f in failures:
            print("FAILED:", f, file=sys.stderr)
        return 1
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
