"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the three CUDA kernels of ``src/repro_torch/kernels/csrc`` with
nvcc, holds each against its plain PyTorch version on the card at the
slice's shapes and at wider ones, runs the slice (one 14-round HiCS-FL
run of paper-cnn at full width: 50 clients, K=5, 10,000 samples) on
the card and holds its first rounds against the port's own CPU run,
then checks the incremental cache on the run's final Δb against the
pairwise kernel and the plain version, drives the from-scratch path
(pairwise kernel) in a second run, and holds one more clustered select
of each run against the plain versions on the CPU.  Prints one JSON line per phase, one
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
Exits non-zero, with no result line, without a CUDA device or when any
check fails.

Tolerances (kernel vs plain version, and cache vs from scratch): Ĥ to
5e-5 at T = 0.63 and 1e-3 at T = 0.0025 (1/T amplifies f32 rounding);
norms and distances to 1e-5 absolute plus 1e-5 relative (the λ = 10
entropy term carries Ĥ's last-bit rounding into distances near 4).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (agglomerate_device,  # noqa: E402
                              hics_functional)
from repro_torch.data import SyntheticSpec  # noqa: E402
from repro_torch.fed import ExperimentSpec, LocalSpec, build  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.fused_stats import fused_stats_rows  # noqa: E402
from repro_torch.kernels.gram_update import gram_strip  # noqa: E402
from repro_torch.kernels.pairwise import pairwise  # noqa: E402

LAM = 10.0
T_SLICE = 0.63
ROUNDS = 14
CPU_ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
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
}

failures: list = []


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Record whether ``got`` is within tolerance of ``want``; returns
    the max absolute error."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool(((got - want).abs() <= atol + rtol * want.abs()).all()))
    if not ok:
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


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and
    operations over the f32 rate.  The callers count the least work
    the function needs: each distinct input read once, each output
    written once, and one dot product per distinct off-diagonal pair
    of the (symmetric) Eq. 9 matrix, 2·C operations each, plus ~10
    for the epilogue."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
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


def fused_stats_case(n, c, temperature, scaled, dev, timed=False):
    x = rows(n, c, seed=n + c, dev=dev)
    scale = (torch.rand(n, generator=torch.Generator().manual_seed(1))
             .to(dev) + 0.5) if scaled else None
    kscale = (torch.full((n,), 1.0 / temperature, device=dev)
              if scale is None else (scale / temperature).contiguous())
    got = fused_stats_rows(x, kscale)
    want = ref.fused_stats_ref(x, temperature, scale)
    h_tol = 5e-5 if temperature >= 0.01 else 1e-3
    tag = f"fused_stats({n},{c},T={temperature},scaled={scaled})"
    err = max(check(tag + ".ent", got[0], want[0], h_tol),
              check(tag + ".norm", got[1], want[1], 1e-5, 1e-5),
              check(tag + ".rms", got[2], want[2], 1e-5, 1e-5))
    out = {"case": tag, "max_abs_err": err}
    if timed:
        out["ms"] = time_ms(lambda: fused_stats_rows(x, kscale))
        out["plain_ms"] = time_ms(
            lambda: ref.fused_stats_ref(x, temperature, scale))
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + n + 3 * n), 8 * n * c)
    return out


def strip_case(k, n, c, temperature, normalize, dev, timed=False):
    x = rows(n, c, seed=k + n + c, dev=dev)
    stats = stats_of(x, temperature, normalize).contiguous()
    ids = torch.arange(0, n, max(1, n // k), device=dev)[:k]
    ids32 = ids.to(torch.int32)
    r, s_r = x[ids].contiguous(), stats[ids].contiguous()
    got = gram_strip(r, x, s_r, stats, ids32, LAM)
    want = ref.distance_strip_ref(x, stats, ids, LAM)
    tag = f"gram_update({k}x{n},{c},normalize={normalize})"
    err = check(tag, got, want, 1e-5, 1e-5)
    # bit-symmetry of the K x K block, as the cache scatter needs it
    kk = got[:, ids]
    require(tag + ": K x K block not bit-symmetric",
            bool(torch.equal(kk, kk.T)))
    out = {"case": tag, "max_abs_err": err}
    if timed:
        out["ms"] = time_ms(lambda: gram_strip(r, x, s_r, stats, ids32,
                                               LAM))
        out["plain_ms"] = time_ms(
            lambda: ref.distance_strip_ref(x, stats, ids, LAM))
        # the K rows and their stats are a gather of x and stats_all;
        # the K x K block is symmetric and its diagonal zero
        pairs = k * n - k * (k + 1) // 2
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + 2 * n + k + k * n), 2 * c * pairs + 10 * pairs)
    return out


def pairwise_case(n, c, temperature, normalize, dev, timed=False):
    x = rows(n, c, seed=3 * n + c, dev=dev)
    stats = stats_of(x, temperature, normalize).contiguous()
    got = pairwise(x, stats, LAM)
    want = ref.pairwise_distance_ref(x, stats[:, 1], LAM)
    tag = f"pairwise({n},{c},normalize={normalize})"
    err = check(tag, got, want, 1e-5, 1e-5)
    require(tag + ": not bit-symmetric", bool(torch.equal(got, got.T)))
    require(tag + ": diagonal not zero",
            bool((torch.diagonal(got) == 0).all()))
    out = {"case": tag, "max_abs_err": err}
    if timed:
        out["ms"] = time_ms(lambda: pairwise(x, stats, LAM))
        out["plain_ms"] = time_ms(
            lambda: ref.pairwise_distance_ref(x, stats[:, 1], LAM))
        pairs = n * (n - 1) // 2        # symmetric, zero diagonal
        out["bound_ms"], out["bound_by"] = bound(
            4 * (n * c + 2 * n + n * n), 2 * c * pairs + 10 * pairs)
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
    t0 = time.perf_counter()
    slice_cases = {
        "fused_stats": [fused_stats_case(5, 10, T_SLICE, True, dev, True),
                        fused_stats_case(50, 10, T_SLICE, False, dev)],
        "gram_update": [strip_case(5, 50, 10, T_SLICE, True, dev, True)],
        "pairwise": [pairwise_case(50, 10, T_SLICE, True, dev, True)],
    }
    wide = [cached_step_case(50, 5, 10, True, dev)]
    for normalize in (False, True):
        wide.append(strip_case(10, 512, 1024, T_SLICE, normalize, dev, True))
        wide.append(pairwise_case(512, 1024, T_SLICE, normalize, dev, True))
        wide.append(cached_step_case(512, 4, 1024, normalize, dev))
    for temperature in (T_SLICE, 0.0025):
        for scaled in (False, True):
            wide.append(fused_stats_case(64, 151_936, temperature, scaled,
                                         dev, timed=not scaled))
    emit({"phase": "kernels", "slice_shapes": slice_cases,
          "wider_shapes": wide,
          "seconds": time.perf_counter() - t0})
    return slice_cases


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
    """Host-clock ms of a round's two halves on the run's final state:
    one clustered select (cache refresh, ward, Eq. 10) and one cohort
    local update."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    idx = ids.long()
    decay = torch.tensor(0.5, device=server.device)
    return {
        "select_ms": host_ms(lambda: server.selector.select(
            server.state, t, draws.select)),
        "local_update_ms": host_ms(lambda: server._lu(
            server.params, server.x[idx], server.y[idx],
            server.mask[idx], draws.perms, decay), reps=2),
        "s_max": int(server.x.shape[1]),
    }


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
    require("slice: non-finite train loss",
            bool(np.isfinite(hist["train_loss"]).all()))
    require("slice: bad test accuracy",
            all(0.0 <= a <= 1.0 for a in hist["test_acc"]))
    require("slice: Ĥ shape", len(hist["bias_entropy"][-1]) == 50
            and bool(np.isfinite(hist["bias_entropy"][-1]).all()))
    require("slice: participants not distinct",
            all(len(set(s)) == 5 for s in hist["selected"]))

    # the port's own CPU run of the same spec: the first rounds agree
    cpu_spec = dataclasses.replace(SPEC, rounds=CPU_ROUNDS)
    cpu_server, _ = build(cpu_spec, device="cpu")
    cpu_hist = cpu_server.run()
    require("slice: selected differs from the CPU run",
            cpu_hist["selected"] == hist["selected"][:CPU_ROUNDS])
    rel = [abs(a - b) / abs(b) for a, b in
           zip(hist["train_loss"][:CPU_ROUNDS], cpu_hist["train_loss"])]
    require(f"slice: train loss differs from the CPU run by {max(rel)}",
            max(rel) <= 1e-3)
    emit({"phase": "slice", "rounds": ROUNDS, "seconds": seconds,
          "rounds_per_s": hist["rounds_per_s"], "wall_s": hist["wall_s"],
          "launches": launches,
          "selected": hist["selected"], "train_loss": hist["train_loss"],
          "test_round": hist["test_round"], "test_acc": hist["test_acc"],
          "cpu_rounds": CPU_ROUNDS,
          "cpu_train_loss": cpu_hist["train_loss"],
          "max_rel_loss_diff_vs_cpu": max(rel),
          "round_split": round_split(server)})
    return server, hist, launches


def select_vs_plain(server, incremental: bool, tag: str) -> dict:
    """One more clustered select on the run's final state, by the
    kernels on the card and by the plain versions on the CPU with the
    same noise: the participants must be identical."""
    t = ROUNDS
    draws = server.draw_round(t)
    ids, _ = server.selector.select(server.state, t, draws.select)
    plain = hics_functional(SPEC.num_clients, SPEC.num_select, ROUNDS,
                            device="cpu",
                            **dict(SELECTOR_KW, incremental=incremental))

    def cpu(tup):
        return type(tup)(*(a.cpu() for a in tup))

    ids_p, _ = plain.select(cpu(server.state), t, cpu(draws.select))
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
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
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

    slice_cases = kernel_phase(dev)
    server, hist, launches = slice_phase(dev)
    scratch_launches = from_scratch_phase(server, hist, dev)

    counts = {"fused_stats": launches["fused_stats"],
              "gram_update": launches["gram_update"],
              "pairwise": scratch_launches["pairwise"]}
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        timed = slice_cases[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(c["max_abs_err"]
                               for c in slice_cases[name]),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": None})
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
    sys.exit(main())
