"""One-card dry run: memory and cost of every (architecture × input
shape) on one H100, with no allocation and no kernel.

The port of the reference's ``launch/dryrun.py``, which lowers and
compiles each combo on a 512-device TPU mesh.  Here each combo's step
(``launch/steps.py``: a bf16 train step with adam and per-layer
recompute, a bf16 prefill, a bf16 decode step) runs once on the
``meta`` device, at full depth, under ``roofline/cost.py``'s counters,
and the record holds:

  state_bytes_global   params and adam's m and v (train), or the params
                       cast to bf16 (prefill, decode), as the reference
                       casts them
  cache_bytes_global   the KV or recurrent cache (decode: as
                       ``cache_specs`` lays it out; prefill: what it
                       returns)
  flops_per_chip, bytes_per_chip, peak_live_bytes
                       the meta pass's counts (``cost.count``; the peak,
                       the largest of its phases' peaks, stands in for
                       XLA's memory_analysis: it holds op results only,
                       not the allocator's rounding or a library's
                       workspace, so the card peaks somewhat above it)
  roofline             the terms of those counts against the H100
                       (``analysis``), with model_flops and
                       useful_flops_ratio: the eager-traffic estimate
                       (every unfused op's operands and result), not a
                       floor
  floor                a lower bound on the step's time: model_flops at
                       the bf16 peak against the least bytes the step
                       must move (train: the params and adam's state
                       read and written once; prefill: the params read,
                       the cache written; decode: both read), the
                       larger of the two
  chips                1
  fits_one_card        state and cache within the card's 80 GB;
                       ``peak_fits`` the meta pass's peak as well

With ``--mesh pod1|pod2`` the combo runs on the reference's production
mesh, 16×16 ("data", "model") or 2×16×16 ("pod", "data", "model"),
under ``--policy 2d|fsdp|ep|auto`` (``sharding.py``; ``auto`` is fsdp
for the train shapes and 2d otherwise), in a worker process of its own
that starts a fake process group of the mesh's 256 or 512 ranks
(``launch/mesh.py: planning_world``) and is rank 0 of it.  The state,
the batch and the cache are DTensors on ``meta`` placed by the policy,
the step runs at rank 0's shapes under ``cost.count(mesh=True)``, and
the record holds, per chip, ``state_bytes_per_chip``,
``cache_bytes_per_chip``, ``flops_per_chip``, ``bytes_per_chip``,
``peak_live_bytes`` and ``collectives_bytes`` (result bytes by the
reference's ``parse_collectives`` kinds, ``total_weighted`` with an
all-reduce twice), the roofline's three terms (the collective one over
NVLink's rate), ``chips`` 256 or 512, ``fits_per_chip`` and
``replicated_ops``, the ops DTensor could not shard and ran replicated
(``copied_views``: the views it viewed on a contiguous copy).
Every count is of the full depth (``depth``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape train_4k [--mesh pod1 --policy fsdp]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--skip-existing]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --summary

Records: ``build/dryrun/<arch>__<shape>.json`` on one card,
``<arch>__<shape>__<mesh>[__<policy>].json`` on a mesh (no suffix for
2d), ``--out`` moves them.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import mesh as meshes
from repro_torch.launch.steps import (make_init_state, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      shard_batch, shard_cache, shard_params,
                                      shard_state)
from repro_torch.models import cache_specs, get_model, input_specs, \
    supports_shape
from repro_torch.optim import adam, tree_leaves, tree_map
from repro_torch.roofline import HW_H100, model_flops, roofline_terms
from repro_torch.roofline.cost import count

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
DTYPE = torch.bfloat16


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _bf16(params):
    return tree_map(lambda t: t.to(DTYPE) if t.dtype == torch.float32
                    else t, params)


def _step(cfg, shape, policy=None):
    """(the step on ``meta`` as a thunk, its record fields, the bytes
    live before it, a holder for its output) of one combo; under
    ``policy`` the state, cache and batch are DTensors placed by it,
    the step runs under it, and the bytes live before it are one
    rank's."""
    api = get_model(cfg)
    batch = input_specs(cfg, shape)
    rec, out = {}, []
    cache = None
    if shape.mode == "train":
        opt = adam(1e-4)
        state = make_init_state(api, opt)(device="meta")
        step = make_train_step(api, opt, dtype=DTYPE)
        rec["state_bytes_global"] = _tree_bytes(state)
        if policy is not None:
            state = shard_state(state, policy)

        def call():
            return step(state, batch)
    else:
        state = _bf16(api.init(device="meta"))
        rec["state_bytes_global"] = _tree_bytes(state)
        if policy is not None:
            state = shard_params(state, policy)
        if shape.mode == "prefill":
            step = make_prefill_step(api, dtype=DTYPE)

            def call():
                with torch.no_grad():
                    out.append(step(state, batch)[1])
                return out[-1]
        else:
            cache = cache_specs(cfg, shape)
            rec["cache_bytes_global"] = _tree_bytes(cache)
            if policy is not None:
                cache = shard_cache(cache, policy)
            step = make_serve_step(api, long_context=shape.name
                                   == "long_500k", dtype=DTYPE)
            # the new token at the cache's last position
            batch = {"token": batch["token"], "pos": shape.seq_len - 1}

            def call():
                with torch.no_grad():
                    return step(state, cache, batch)
    tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
    if policy is None:
        run = call
        base = rec["state_bytes_global"] + rec.get(
            "cache_bytes_global", 0) + _tree_bytes(tensors)
    else:
        batch = shard_batch(batch, policy)
        tensors = shard_batch(tensors, policy)
        rec["state_bytes_per_chip"] = sharding.local_bytes(state)
        if cache is not None:
            rec["cache_bytes_per_chip"] = sharding.local_bytes(cache)
        base = sharding.local_bytes((state, cache, tensors))

        def run():
            with sharding.use_policy(policy):
                return call()
    return run, rec, base, out


#: the sequence lengths a token recurrence is counted at (:func:`measure`)
RECUR_LENS = (32, 64, 96)
KEYS = ("flops", "hbm_bytes", "ops", "cache_bytes")


def _count(cfg, shape, policy=None) -> tuple:
    """(the step's counts, its record fields, the bytes live before
    it)."""
    run, rec, base, out = _step(cfg, shape, policy)
    c = count(run, base, mesh=policy is not None)
    c["cache_bytes"] = _tree_bytes(out[0]) if out else 0
    if policy is not None:
        c["cache_bytes_local"] = sharding.local_bytes(out[0]) if out else 0
    return c, rec, base


def measure(cfg, shape, policy=None) -> dict:
    """The combo's record fields and its counts: one meta pass of the
    full step, at full depth (its peak is the largest of its phases'
    peaks, ``cost.phase``, and no straight line in the layers: the phase
    that peaks at a few layers need not be the one that peaks at 36).

    A recurrence over the tokens (rwkv's WKV loop, four ops a token a
    layer: some four million dispatches at 32k tokens) is counted at
    full depth at :data:`RECUR_LENS` tokens instead.  Its FLOPs, bytes
    and ops are solved as a quadratic in the tokens, exact for these
    counts (each token adds the same ops; the backward pass of a
    token's slice writes a zero tensor as long as the sequence), and
    each phase's peak above the batch's own bytes is extended along the
    line through the two longest counts, an estimate
    (``extrapolated_from`` names the counts).  Under ``policy`` the
    counts are one rank's and add its collectives by kind."""
    keys = KEYS + (("cache_bytes_local",) if policy is not None else ())
    if not (cfg.kind == "ssm" and shape.mode != "decode"
            and shape.seq_len > RECUR_LENS[-1]):
        tot, rec, _ = _count(cfg, shape, policy)
        peaks, src = tot["phase_peaks"], None
    else:
        rep = dataclasses.replace
        _, rec, base, _ = _step(cfg, shape, policy)  # the full combo's
        cs = [_count(cfg, rep(shape, seq_len=t), policy)
              for t in RECUR_LENS]
        t = np.array(RECUR_LENS, np.float64)
        full = np.array([1.0, shape.seq_len, shape.seq_len ** 2])
        w = np.linalg.solve(np.stack([t ** 0, t, t ** 2], 1),
                            np.array([[c[k] for k in keys] for c, _, _ in cs],
                                     np.float64))
        tot = dict(zip(keys, (full @ w).tolist()))
        if policy is not None:
            kinds = list(cs[0][0]["collectives"])
            w = np.linalg.solve(np.stack([t ** 0, t, t ** 2], 1), np.array(
                [[c["collectives"][k] for k in kinds] for c, _, _ in cs],
                np.float64))
            tot["collectives"] = dict(zip(kinds, (full @ w).tolist()))
        (t1, (c1, _, b1)), (t2, (c2, _, b2)) = zip(RECUR_LENS[-2:], cs[-2:])
        peaks = {}
        for k in c1["phase_peaks"]:
            p1, p2 = c1["phase_peaks"][k] - b1, c2["phase_peaks"][k] - b2
            peaks[k] = base + p1 + (p2 - p1) * (shape.seq_len - t1) / (t2 - t1)
        src = [{"layers": cfg.num_layers, "seq_len": n} for n in RECUR_LENS]
    if shape.mode == "prefill":
        rec["cache_bytes_global"] = int(round(tot["cache_bytes"]))
        if policy is not None:
            rec["cache_bytes_per_chip"] = int(round(tot["cache_bytes_local"]))
    rec["cost"] = {"flops": tot["flops"], "hbm_bytes": tot["hbm_bytes"],
                   "peak_bytes": max(peaks.values()),
                   "phase_peak_bytes": dict(peaks), "ops": tot["ops"]}
    if policy is not None:
        rec["cost"]["collectives"] = tot["collectives"]
    if src:
        rec["cost"]["extrapolated_from"] = src
    return rec


def run_combo(arch: str, shape_name: str, batch: int | None = None,
              cfg=None) -> dict:
    """One combo's record; ``batch`` replaces the shape's global batch,
    ``cfg`` the registered config of ``arch`` (a reduced one)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=int(batch))
    rec = {"arch": arch, "shape": shape_name, "mode": shape.mode,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "dtype": "bf16", "chips": 1, "hardware": HW_H100.name}
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = (f"long_context_mode={cfg.long_context_mode} "
                         "(see configs/base.py)")
        return rec
    t0 = time.time()
    rec.update(measure(cfg, shape))
    rec["count_s"] = round(time.time() - t0, 2)
    cost = rec["cost"]
    rec["flops_per_chip"] = cost["flops"]
    rec["bytes_per_chip"] = cost["hbm_bytes"]
    rec["peak_live_bytes"] = cost["peak_bytes"]
    terms = roofline_terms(cost["flops"], cost["hbm_bytes"], 0.0, HW_H100,
                           DTYPE)
    mf = model_flops(cfg, shape, shape.mode)
    terms["model_flops_global"] = mf
    terms["model_flops_per_chip"] = mf
    terms["useful_flops_ratio"] = mf / cost["flops"] if cost["flops"] else 0.0
    rec["roofline"] = terms
    held = rec["state_bytes_global"] + rec.get("cache_bytes_global", 0)
    # train reads and writes the params and adam's state once; prefill
    # reads the params and writes the cache; decode reads both
    least = 2 * held if shape.mode == "train" else held
    rec["floor"] = {"flops": mf, "bytes": least, **roofline_terms(
        mf, least, 0.0, HW_H100, DTYPE)}
    rec["fits_one_card"] = held <= HW_H100.hbm_bytes
    rec["peak_fits"] = cost["peak_bytes"] <= HW_H100.hbm_bytes
    rec["status"] = "ok"
    return rec


def policy_for(policy: str, shape_name: str) -> str:
    """``auto`` as the reference's production recommendation: fsdp for
    the train shapes, 2d otherwise; any other policy as it is."""
    if policy != "auto":
        return policy
    return "fsdp" if SHAPES[shape_name].mode == "train" else "2d"


def run_mesh_combo(arch: str, shape_name: str, mesh_name: str = "pod1",
                   policy: str = "2d", cfg=None) -> dict:
    """One combo's record on the production mesh ``mesh_name`` (pod1:
    16×16, pod2: 2×16×16) under ``policy``, counted at this rank's
    shapes; the current process group must have the mesh's size (a
    :func:`repro_torch.launch.mesh.planning_world`).  ``cfg`` replaces
    the registered config of ``arch``."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name]
    mode = policy_for(policy, shape_name)
    mesh = meshes.make_production_mesh(multi_pod=mesh_name == "pod2")
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "mode": shape.mode, "policy": mode, "global_batch":
           shape.global_batch, "seq_len": shape.seq_len, "dtype": "bf16",
           "chips": chips, "hardware": HW_H100.name, "depth": "full"}
    if policy != mode:
        rec["policy_asked"] = policy
    if not supports_shape(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = (f"long_context_mode={cfg.long_context_mode} "
                         "(see configs/base.py)")
        return rec
    pol = sharding.ShardingPolicy(mesh, mode)
    sharding.REPLICATED_OPS.clear()
    sharding.COPIED_VIEWS.clear()
    t0 = time.time()
    rec.update(measure(cfg, shape, pol))
    rec["count_s"] = round(time.time() - t0, 2)
    rec["replicated_ops"] = dict(sharding.REPLICATED_OPS)
    rec["copied_views"] = dict(sharding.COPIED_VIEWS)
    cost = rec["cost"]
    coll = cost["collectives"]
    rec["flops_per_chip"] = cost["flops"]
    rec["bytes_per_chip"] = cost["hbm_bytes"]
    rec["peak_live_bytes"] = cost["peak_bytes"]
    rec["collectives_bytes"] = coll
    terms = roofline_terms(cost["flops"], cost["hbm_bytes"],
                           coll["total_weighted"], HW_H100, DTYPE)
    mf = model_flops(cfg, shape, shape.mode)
    terms["model_flops_global"] = mf
    terms["model_flops_per_chip"] = mf / chips
    terms["useful_flops_ratio"] = (mf / chips / cost["flops"]
                                   if cost["flops"] else 0.0)
    rec["roofline"] = terms
    held = rec["state_bytes_per_chip"] + rec.get("cache_bytes_per_chip", 0)
    rec["fits_per_chip"] = held <= HW_H100.hbm_bytes
    rec["peak_fits"] = cost["peak_bytes"] <= HW_H100.hbm_bytes
    rec["status"] = "ok"
    return rec


def _mesh_worker(arch, shape_name, mesh_name, policy, cfg):
    with meshes.planning_world(meshes.mesh_size(mesh_name == "pod2")):
        return run_mesh_combo(arch, shape_name, mesh_name, policy, cfg)


def mesh_combo_in_worker(arch: str, shape_name: str, mesh_name: str = "pod1",
                         policy: str = "2d", cfg=None, pool=None):
    """:func:`run_mesh_combo` in a spawned worker process, which starts
    and ends the fake process group of the mesh's size: the record, or
    with ``pool`` (a ``ProcessPoolExecutor`` of spawned workers) its
    future."""
    args = (arch, shape_name, mesh_name, policy, cfg)
    if pool is not None:
        return pool.submit(_mesh_worker, *args)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as ex:
        return ex.submit(_mesh_worker, *args).result()


#: the most counts :func:`fit_batch` makes
FIT_COUNTS = 8


def fit_batch(arch: str, shape_name: str, limit: float,
              top: int | None = None) -> dict:
    """The largest global batch, at most ``top`` (the shape's when
    None), whose meta pass peaks within ``limit`` bytes.  The peak is
    convex in the batch (the largest of its phases' peaks: the
    optimizer's update, free of the batch, and the passes' a + b·B), so
    the chord between a batch that fits and one that does not never
    overshoots: each count moves the fitting end up (regula falsi), at
    most :data:`FIT_COUNTS` counts.  Returns {batch (0 when one sequence
    does not fit), the peak of each batch counted, record (the chosen
    batch's :func:`run_combo` record, None at 0)}."""
    top = SHAPES[shape_name].global_batch if top is None else int(top)
    recs = {}

    def peak(b):
        if b not in recs:
            recs[b] = run_combo(arch, shape_name, b)
        return recs[b]["peak_live_bytes"]

    if peak(top) <= limit:
        lo = top
    elif top == 1 or peak(1) > limit:
        lo = 0
    else:
        lo, hi = 1, top
        while hi - lo > 1 and len(recs) < FIT_COUNTS:
            b = lo + int((limit - peak(lo)) * (hi - lo)
                         // (peak(hi) - peak(lo)))
            b = min(max(b, lo + 1), hi - 1)
            if peak(b) <= limit:
                lo = b
            else:
                hi = b
    return {"batch": lo,
            "peaks": {str(k): r["peak_live_bytes"] for k, r in recs.items()},
            "record": recs.get(lo)}


def combos(only_arch=None, only_shape=None):
    for arch in list_archs():
        if get_config(arch).kind == "classifier":
            continue
        if only_arch and arch != only_arch:
            continue
        for shape in SHAPES:
            if only_shape and shape != only_shape:
                continue
            yield arch, shape


def record_path(out: Path, arch: str, shape: str, mesh: str | None = None,
                policy: str = "2d") -> Path:
    """A one-card record ``<arch>__<shape>.json``, a mesh's
    ``<arch>__<shape>__<mesh>[__<policy>].json`` (no suffix for 2d)."""
    if mesh is None:
        return out / f"{arch}__{shape}.json"
    suffix = "" if policy == "2d" else f"__{policy}"
    return out / f"{arch}__{shape}__{mesh}{suffix}.json"


def summary(out: Path) -> list:
    """One row a record: arch, shape, mesh and policy (empty on one
    card), status, the roofline terms, the bottleneck, the useful
    ratio, the peak (per chip on a mesh) and whether it fits (one card,
    or per chip)."""
    rows = [("arch", "shape", "mesh", "policy", "status", "compute_s",
             "memory_s", "collective_s", "bottleneck", "useful_ratio",
             "peak_gb", "fits")]
    for p in sorted(out.glob("*.json")):
        rec = json.loads(p.read_text())
        r = rec.get("roofline", {})
        rows.append((rec["arch"], rec["shape"], rec.get("mesh"),
                     rec.get("policy"), rec["status"],
                     r.get("compute_s"), r.get("memory_s"),
                     r.get("collective_s"), r.get("bottleneck"),
                     r.get("useful_flops_ratio"),
                     rec.get("peak_live_bytes", 0) / 1e9 if rec.get(
                         "peak_live_bytes") else None,
                     rec.get("fits_one_card", rec.get("fits_per_chip"))))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--summary", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the records")
    ap.add_argument("--mesh", choices=["pod1", "pod2"],
                    help="the production mesh (16x16 or 2x16x16); one "
                    "card without it")
    ap.add_argument("--policy", default="2d",
                    choices=["2d", "fsdp", "ep", "auto"],
                    help="the sharding policy on --mesh; auto: fsdp for "
                    "train shapes, 2d otherwise")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.summary:
        for row in summary(out):
            print(",".join("" if v is None else
                           (f"{v:.4g}" if isinstance(v, float) else str(v))
                           for v in row))
        return
    todo = list(combos(args.arch, args.shape))
    if not todo or not (args.all or args.arch or args.shape):
        raise SystemExit("nothing to do: --arch, --shape or --all")
    for arch, shape in todo:
        path = record_path(out, arch, shape, args.mesh, args.policy)
        if args.skip_existing and path.exists():
            if json.loads(path.read_text()).get("status") in ("ok",
                                                              "skipped"):
                continue
        where = f" x {args.mesh} ({args.policy})" if args.mesh else ""
        print(f"=== dryrun {arch} x {shape}{where}", flush=True)
        try:
            rec = (mesh_combo_in_worker(arch, shape, args.mesh, args.policy)
                   if args.mesh else run_combo(arch, shape))
        except Exception as e:  # a failure is a record too
            rec = {"arch": arch, "shape": shape, "status": "error",
                   "error": repr(e),
                   "traceback": traceback.format_exc()[-4000:]}
            if args.mesh:
                rec.update(mesh=args.mesh, policy=args.policy)
        path.write_text(json.dumps(rec, indent=1))
        print(f"    -> {rec['status']}", flush=True)
        if rec["status"] == "error":
            print(rec["error"], flush=True)


if __name__ == "__main__":
    main()
