"""The port's telemetry (``repro_torch.telemetry``) against the JAX
reference's (``repro.telemetry``), on the CPU, with the reference's own
small specs (``tests/test_telemetry.py``): paper-mlp, 12 clients,
K = 3, 8 rounds; the ``dir_mild`` sweep, 10 clients, 2 seeds, 6
rounds; the async server on its seed-0 partition.  Draws are the
reference's (``torch_parity.JaxKeyChain``), initial params the
reference's (``params_from_jax``).  Held here:

(a) ``MetricsSpec`` refuses an unknown group, ``all()`` covers
    ``GROUPS``; for every combination of groups the port's field set,
    shapes and dtypes are the reference's.
(b) One metrics step on the same ``TelemetryCtx`` inputs (zero Δb rows,
    so tied Ĥ; repeated ids; a cache with stale rows) against the
    reference's jitted step, at T = 0.63 and 0.0025.
(c) The host loop and the scanned driver: each run with telemetry on
    bit-identical to its run with telemetry off, the two drivers'
    telemetry bit-equal, and the reference's host-loop telemetry
    matched; the round step with telemetry reads nothing on the host.
(d) The seed sweep and the async server: the same checks, fields
    ``(S, T, ...)`` in the sweep, each seed bit-equal to its own
    scanned run; every driver emits the reference's field set.
(e) Export: a port ``write_run`` / ``write_sweep`` file read back by
    the reference's reader, ``summarize`` against the reference's,
    ``env_stamp`` here.
(f) Trace: no-ops without ``REPRO_TRACE``; a ``kernels/...`` range
    with it.
(g) ``launch/train.py --telemetry``: the reference's fields and values.

Tolerances, port against reference: ints (``sel_counts``,
``cluster_sizes``), ``stale_frac``, the loss and lr scale as given and
the async fields exact; the fairness rates 1e-6 relative (XLA may
divide by N as a product with 1/N); the ``ent_*`` fields and the within-cluster
spread 5e-5 at T = 0.63 and 1e-3 at T = 0.0025 (the estimator's
tolerances); norms 1e-5 relative; ``ent_rank_corr`` exact wherever no
two distinct Ĥ lie within 5e-5 of each other (a near-tie may sort
either way), and otherwise equal to numpy's Spearman of the port's own
Ĥ; a driver's train loss 1e-4 relative
(``tests/test_torch_round_loop.py``).

Each test loops over its cases (``torch_parity.each``).
"""
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_get_config
from repro.core import Observations as JObservations
from repro.core import make_functional as jax_make_functional
from repro.data import SyntheticSpec as JSyntheticSpec
from repro.fed import AsyncConfig as JAsyncConfig
from repro.fed import AsyncFederatedServer as JAsyncServer
from repro.fed import ExperimentSpec as JExperimentSpec
from repro.fed import LocalSpec as JLocalSpec
from repro.fed import build as jax_build
from repro.launch import train as jtrain
from repro.scenarios import SweepSpec as JSweepSpec
from repro.scenarios import build_pair as jax_build_pair
from repro.scenarios import make_dataset as jax_make_dataset
from repro.scenarios.sweep import _make_model as jax_make_model
from repro.telemetry import GROUPS as JGROUPS
from repro.telemetry import MetricsSpec as JMetricsSpec
from repro.telemetry import TelemetryCtx as JTelemetryCtx
from repro.telemetry import client_true_entropy as jax_true_entropy
from repro.telemetry import make_metrics as jax_make_metrics
from repro.telemetry import read_jsonl as jax_read_jsonl
from repro.telemetry import summarize as jax_summarize
from repro.telemetry import telemetry_from_records as jax_from_records
from repro_torch.configs import get_config
from repro_torch.core import SelectorState, make_functional
from repro_torch.data import SyntheticSpec
from repro_torch.fed import (AsyncConfig, AsyncFederatedServer,
                             ExperimentSpec, FedConfig, LocalSpec, build)
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models import make_classifier, params_from_jax
from repro_torch.optim import tree_leaves
from repro_torch.scenarios import SweepSpec
from repro_torch.telemetry import (GROUPS, MetricsSpec,
                                   TelemetryCtx, annotate,
                                   client_true_entropy, env_stamp,
                                   make_metrics, read_jsonl, summarize,
                                   trace_enabled, trace_span, write_run,
                                   write_sweep)
from repro_torch.telemetry.export import (COMPARE_KEYS,
                                          telemetry_from_records)
from torch_parity import JaxKeyChain, each, port_pair_on_reference, to_np

ROOT = Path(__file__).resolve().parents[1]
SYNC_GROUPS = ("selection", "training", "fairness")
N, K, ROUNDS = 12, 3, 8
SWEEP_N, SWEEP_ROUNDS, SWEEP_SEEDS = 10, 6, (0, 1)
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__")
NORM_FIELDS = ("training/delta_b_norm", "training/update_norm")
ENT_FIELDS = ("selection/ent_mean", "selection/ent_std",
              "selection/ent_selected_mean", "selection/ent_mae",
              "selection/cluster_ent_spread")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The runs' tensors are tiny: one torch thread, as the other port
    tests (more only spin against the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _local(pkg_local):
    return pkg_local(algo="fedavg", optimizer="sgd", lr=0.1, epochs=1,
                     batch_size=32)


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------


def _ranks(v):
    r = np.empty(v.shape[0])
    r[np.argsort(v, kind="stable")] = np.arange(v.shape[0])
    return r


def _np_spearman(a, b):
    ra, rb = _ranks(a) - (a.shape[0] - 1) / 2, _ranks(b) - (b.shape[0] - 1) / 2
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return (ra * rb).sum() / denom if denom > 0 else 0.0


def _no_near_ties(ent) -> bool:
    """No two distinct Ĥ within 5e-5 of each other."""
    vals = np.unique(np.asarray(ent, np.float64))
    return vals.size < 2 or float(np.diff(vals).min()) > 5e-5


def _check_fields(got: dict, want: dict, ent_tol: float, ents, tes,
                  what=""):
    """Every field of ``got`` (the port's) against ``want`` (the
    reference's), both stacked over the same leading axes, at the
    module's tolerances.  ``ents`` and ``tes`` are the port's own Ĥ and
    true entropies per leading index (rows of the same leading shape),
    for the rank correlation."""
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, (what, k, g.shape, w.shape)
        assert g.dtype == w.dtype, (what, k, g.dtype, w.dtype)
        if k == "selection/ent_rank_corr":
            continue
        if k in ENT_FIELDS:
            np.testing.assert_allclose(g, w, atol=ent_tol, err_msg=k)
        elif k in NORM_FIELDS:
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        elif k == "training/loss" and g.ndim:
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
        elif k in ("fairness/participation",
                   "fairness/eff_participation"):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=k)
        else:
            assert np.array_equal(g, w), (what, k, g, w)
    corr_g = np.asarray(got["selection/ent_rank_corr"]).reshape(-1)
    corr_w = np.asarray(want["selection/ent_rank_corr"]).reshape(-1)
    if corr_w.size:
        ents = np.asarray(ents).reshape(corr_w.size, -1)
        tes = np.asarray(tes).reshape(corr_w.size, -1)
        for i in range(corr_w.size):
            if _no_near_ties(ents[i]):
                assert corr_g[i] == corr_w[i], (what, i)
            np.testing.assert_allclose(
                corr_g[i], _np_spearman(ents[i], tes[i]), atol=1e-6)


def _field_shapes(tel: dict, lead: int) -> dict:
    """{field: (shape past the ``lead`` axes, dtype)}."""
    return {k: (tuple(np.shape(v))[lead:], np.asarray(v).dtype)
            for k, v in tel.items()}


# ---------------------------------------------------------------------------
# (a) spec and schema
# ---------------------------------------------------------------------------


def _jax_state(temperature, normalize, db_scale, n=N):
    """A HiCS state of the reference (n clients, K = 3) after two
    updates and a select: unseen clients' Δb rows zero, the cache
    refreshed for the first cohort, the second cohort's rows stale
    (``stale_fill`` 3)."""
    rng = np.random.default_rng(7)
    jfn = jax_make_functional("hics", num_clients=n, num_select=K,
                              total_rounds=ROUNDS, temperature=temperature,
                              normalize=normalize, num_classes=10)
    st = jfn.init(jax.random.PRNGKey(0))
    for t, ids in enumerate(([0, 1, 2], [n - 1, 0, 3])):
        db = rng.normal(size=(K, 10)).astype(np.float32) * db_scale
        st = jfn.update(st, t, jnp.asarray(ids), JObservations(
            bias_updates=jnp.asarray(db)))
        if t == 0:
            _, st = jfn.select(st, 1, jax.random.PRNGKey(3))
    return jfn, st


def _port_state(jst) -> SelectorState:
    return SelectorState(**{f: torch.tensor(np.asarray(getattr(jst, f)))
                            for f in SelectorState._fields})


def _ctx_inputs(rng, n=N):
    """Every non-state ctx input for n clients, numpy: ids with a
    repeat, a cohort Δb with a zero row, θ^t and θ^{t+1}, labels and a
    mask for the true entropies, the async scalars."""
    params = {"head": {"b": rng.normal(size=10), "w": rng.normal(
        size=(4, 10))}, "conv": rng.normal(size=(3, 3, 2, 4))}
    params = {k: ({kk: vv.astype(np.float32) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.astype(np.float32))
              for k, v in params.items()}
    after = {k: ({kk: vv + np.float32(0.01) * rng.normal(size=vv.shape)
                  .astype(np.float32) for kk, vv in v.items()}
                 if isinstance(v, dict) else
                 v + np.float32(0.01) * rng.normal(size=v.shape)
                 .astype(np.float32)) for k, v in params.items()}
    db = rng.normal(size=(K, 10)).astype(np.float32) * 0.02
    db[1] = 0.0
    y = rng.integers(0, 10, size=(n, 20))
    mask = (rng.random((n, 20)) < 0.8).astype(np.float32)
    mask[3] = 0.0
    return dict(params_before=params, params_after=after,
                bias_updates=db, y=y, mask=mask,
                ids=[np.asarray([2, 2, 0], np.int32),
                     np.asarray([1, 2, n - 1], np.int32)],
                scalars=dict(train_loss=np.float32(2.25),
                             lr_scale=np.float32(0.5), fired=True,
                             fill=np.int32(2), accepted=np.int32(3),
                             dropped=np.int32(1), version=np.int32(4),
                             version_lag=np.int32(1)),
                agg_ages=np.asarray([0.0, 1.0, -1.0], np.float32))


def _ctxs(inp, jst, tst, jte, tte, t):
    """The same round's ctx in both packages."""
    common = dict(inp["scalars"], t=np.int32(t),
                  ids=inp["ids"][t], bias_updates=inp["bias_updates"],
                  agg_ages=inp["agg_ages"])
    jctx = JTelemetryCtx(
        state=jst, true_entropy=jte,
        params_before=jax.tree_util.tree_map(jnp.asarray,
                                             inp["params_before"]),
        params_after=jax.tree_util.tree_map(jnp.asarray,
                                            inp["params_after"]),
        **{k: jnp.asarray(v) for k, v in common.items()})
    pt = lambda tree: {k: (pt(v) if isinstance(v, dict) else
                           torch.tensor(v)) for k, v in tree.items()}
    tctx = TelemetryCtx(
        state=tst, true_entropy=tte, params_before=pt(inp["params_before"]),
        params_after=pt(inp["params_after"]),
        **{k: torch.tensor(v) for k, v in common.items()})
    return jctx, tctx


def test_metrics_spec_and_field_sets_equal_reference():
    """(a) the spec's checks; every combination of groups, every field's
    shape and dtype against the reference's (``jax.eval_shape``), at 5
    clients (a cheap trace of the clustering)."""
    with pytest.raises(ValueError, match="unknown metric group"):
        MetricsSpec(("selektion",))
    assert MetricsSpec.all().groups == GROUPS == JGROUPS
    for bad in (lambda: FedConfig(telemetry=("bogus",)),
                lambda: AsyncConfig(telemetry=("bogus",)),
                lambda: SweepSpec(telemetry=("bogus",))):
        with pytest.raises(ValueError, match="unknown metric group"):
            bad()
    n = 5
    jfn, jst = _jax_state(0.63, True, 0.05, n)
    tfn = make_functional("hics", num_clients=n, num_select=K,
                          total_rounds=ROUNDS, temperature=0.63,
                          normalize=True, num_classes=10, device="cpu")
    tst = _port_state(jst)
    inp = _ctx_inputs(np.random.default_rng(0), n)
    te = np.linspace(0.0, 2.0, n).astype(np.float32)
    jctx, tctx = _ctxs(inp, jst, tst, jnp.asarray(te), torch.tensor(te), 0)
    combos = [c for r in range(len(GROUPS) + 1)
              for c in itertools.combinations(GROUPS, r)]
    for combo in combos:
        jm = jax_make_metrics(JMetricsSpec(combo), fn=jfn, num_clients=n,
                              num_select=K)
        tm = make_metrics(MetricsSpec(combo), fn=tfn, num_clients=n,
                          num_select=K, device="cpu")
        jcarry, jtel = jax.eval_shape(jm.step, jm.init(), jctx)
        tcarry, ttel = tm.step(tm.init(), tctx)
        want = {k: (v.shape, np.dtype(v.dtype)) for k, v in jtel.items()}
        got = {k: (tuple(v.shape), np.dtype(str(v.dtype).split(".")[-1]))
               for k, v in ttel.items()}
        assert got == want, combo
        assert tuple(tcarry["fairness/counts"].shape) == \
            jcarry["fairness/counts"].shape, combo
    # the reference's zero widths with no ctx inputs at all
    _, off = make_metrics(MetricsSpec(), device="cpu").step(
        make_metrics(MetricsSpec(), device="cpu").init(), TelemetryCtx())
    assert all(tuple(v.shape) == (0,) for v in off.values())


# ---------------------------------------------------------------------------
# (b) one metrics step
# ---------------------------------------------------------------------------


def _step_case(case):
    temperature, normalize, db_scale, ent_tol = case
    jfn, jst = _jax_state(temperature, normalize, db_scale)
    tfn = make_functional("hics", num_clients=N, num_select=K,
                          total_rounds=ROUNDS, temperature=temperature,
                          normalize=normalize, num_classes=10, device="cpu")
    tst = _port_state(jst)
    inp = _ctx_inputs(np.random.default_rng(1))
    jte = jax_true_entropy(jnp.asarray(inp["y"]), jnp.asarray(inp["mask"]),
                           10)
    tte = client_true_entropy(torch.tensor(inp["y"]),
                              torch.tensor(inp["mask"]), 10)
    np.testing.assert_allclose(tte.numpy(), np.asarray(jte), atol=1e-6)
    jm = jax_make_metrics(JMetricsSpec.all(), fn=jfn, num_clients=N,
                          num_select=K)
    tm = make_metrics(MetricsSpec.all(), fn=tfn, num_clients=N,
                      num_select=K, device="cpu")
    jstep = jax.jit(jm.step)
    jcarry, tcarry = jm.init(), tm.init()
    ent = tfn.entropies(tst).numpy()
    # zero Δb rows: tied Ĥ
    assert np.unique(ent).size < N
    for t in range(2):
        jctx, tctx = _ctxs(inp, jst, tst, jte, tte, t)
        jcarry, jtel = jstep(jcarry, jctx)
        tcarry, ttel = tm.step(tcarry, tctx)
        _check_fields(to_np(ttel), to_np(jtel), ent_tol, ent,
                      tte.numpy(), what=(case, t))
    # repeated ids counted twice
    assert to_np(ttel)["fairness/sel_counts"][2] == 3
    assert int(to_np(ttel)["selection/cluster_sizes"].sum()) == N


def test_metrics_step_matches_reference_step():
    """(b) at T = 0.63 normalized (Ĥ spread apart: the rank correlation
    exact) and T = 0.0025 on small raw Δb."""
    each(_step_case, [(0.63, True, 0.05, 5e-5),
                      (0.0025, False, 0.003, 1e-3)])


# ---------------------------------------------------------------------------
# (c) the host loop and the scanned driver
# ---------------------------------------------------------------------------


def _exp_spec(pkg_spec, pkg_local, telemetry=(), jit_rounds=False):
    return pkg_spec(
        arch="paper-mlp", num_clients=N, num_select=K, rounds=ROUNDS,
        alphas=(0.05, 5.0), selector="hics", local=_local(pkg_local),
        samples_train=400, samples_test=120, eval_every=4, seed=0,
        jit_rounds=jit_rounds, telemetry=telemetry)


@pytest.fixture(scope="module")
def jax_host_run():
    """The reference's host loop with the sync groups, and its initial
    params."""
    server, _ = jax_build(_exp_spec(JExperimentSpec, JLocalSpec,
                                    SYNC_GROUPS))
    params0 = to_np(server.params)
    hist = server.run()
    return server, hist, params0


def _port_run(params0, telemetry, jit_rounds):
    server, _ = build(_exp_spec(ExperimentSpec, LocalSpec, telemetry,
                                jit_rounds), device="cpu")
    server.params = params_from_jax(params0, "cpu")
    hist = server.run(draws=JaxKeyChain(0, N, K, K, 1, server.x.shape[1]))
    return server, hist


def _same_run(a, b):
    (sa, ha), (sb, hb) = a, b
    assert ha["selected"] == hb["selected"]
    assert ha["train_loss"] == hb["train_loss"]
    assert ha["bias_entropy"] == hb["bias_entropy"]
    for x, y in zip(tree_leaves(sa.params), tree_leaves(sb.params)):
        assert torch.equal(x, y)
    for x, y in zip(sa.state, sb.state):
        assert torch.equal(x, y)


def _host_round_step_reads_nothing(server):
    step = server._make_round_step()
    carry = server._initial_carry()
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the round step")

    try:
        for name in saved:
            setattr(torch.Tensor, name, host_read)
        for t in range(2):
            carry, out = step(carry, server.draw_round(t))
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert out[-1]["fairness/sel_counts"].sum() == 2 * K


def test_sync_drivers_invariant_and_match_reference(jax_host_run):
    """(c) host loop and scanned driver, the sync groups: on and off
    bit-identical, the drivers' telemetry bit-equal, the reference's
    matched; the round step reads nothing."""
    jserver, jhist, params0 = jax_host_run
    runs = {}
    for jit in (False, True):
        off = _port_run(params0, (), jit)
        on = _port_run(params0, SYNC_GROUPS, jit)
        _same_run(off, on)
        assert on[1]["selected"] == jhist["selected"]
        runs[jit] = on[0].telemetry
        assert runs[jit]["fairness/sel_counts"].shape == (ROUNDS, N)
        counts = np.bincount(np.concatenate(on[1]["selected"]),
                             minlength=N)
        assert np.array_equal(runs[jit]["fairness/sel_counts"][-1], counts)
    host, scan = runs[False], runs[True]
    assert sorted(host) == sorted(scan)
    for k in host:
        assert np.array_equal(host[k], scan[k]), k
    _check_fields(host, jserver.telemetry, 1e-3, on[1]["bias_entropy"],
                  np.repeat(on[0]._true_ent.numpy()[None], ROUNDS, 0))
    _host_round_step_reads_nothing(build(_exp_spec(
        ExperimentSpec, LocalSpec, SYNC_GROUPS), device="cpu")[0])


# ---------------------------------------------------------------------------
# (d) the sweep and the async server
# ---------------------------------------------------------------------------


def _sweep_specs(telemetry):
    kw = dict(scenarios=("dir_mild",), selectors=("hics",),
              seeds=SWEEP_SEEDS, num_clients=SWEEP_N, num_select=K,
              rounds=SWEEP_ROUNDS, samples_train=400, samples_test=120,
              telemetry=telemetry)
    return (JSweepSpec(data=JSyntheticSpec(dim=16, rank=2, noise=0.5),
                       local=_local(JLocalSpec), **kw),
            SweepSpec(data=SyntheticSpec(dim=16, rank=2, noise=0.5),
                      local=_local(LocalSpec), **kw))


@pytest.fixture(scope="module")
def jax_sweep():
    """The reference's sweep cell with the sync groups, each seed's
    initial params, and seed 0's partition (idx, mask)."""
    jspec, _ = _sweep_specs(SYNC_GROUPS)
    jpair = jax_build_pair(jspec, "dir_mild", "hics")
    # run_sweep's cell: the pair's vmapped runner
    cell = jax.tree_util.tree_map(np.asarray, jpair.vmapped()(
        jpair.params0, jpair.sstate0, jpair.parts, jpair.round_keys))
    params0 = [to_np(jax.tree_util.tree_map(lambda l: l[i], jpair.params0))
               for i in range(len(SWEEP_SEEDS))]
    part0 = (np.asarray(jpair.parts.idx[0]), np.array(jpair.parts.mask[0]))
    return cell, params0, part0


def _port_pair(telemetry, params0):
    jspec, spec = _sweep_specs(telemetry)
    return port_pair_on_reference(jspec, spec, "dir_mild", "hics", params0)


def test_sweep_invariant_and_matches_reference(jax_sweep):
    """(d) the sweep cell on the reference's partitions, params and
    draws: on and off bit-identical, each seed bit-equal to its own
    scanned run, the reference's telemetry matched."""
    want, params0, _ = jax_sweep
    off, on = _port_pair((), params0), _port_pair(SYNC_GROUPS, params0)
    out_off, out_on = off.run(), on.run()
    for a, b in zip(out_off, out_on):
        assert np.array_equal(a, b)
    assert np.array_equal(out_on[0], np.asarray(want["selected"]))
    tel = on.telemetry
    assert tel["fairness/sel_counts"].shape == (len(SWEEP_SEEDS),
                                                 SWEEP_ROUNDS, SWEEP_N)
    assert off.telemetry["training/loss"].shape == (len(SWEEP_SEEDS),
                                                     SWEEP_ROUNDS, 0)
    # each seed alone through its server's scanned driver from its
    # initial carry, same draws
    ents, tes = [], []
    for i, srv in enumerate(on.servers):
        srv._store_carry(on.carries0[i])
        hist = srv.run(draws=lambda t, i=i: on.draws[i][t])
        for k, v in srv.telemetry.items():
            assert np.array_equal(v, tel[k][i]), (i, k)
        ents.append(hist["bias_entropy"])
        tes.append(np.repeat(srv._true_ent.numpy()[None], SWEEP_ROUNDS, 0))
    _check_fields(tel, want["telemetry"], 1e-3, ents, tes, what="sweep")


def _async_arrays(part0):
    """The reference test's async data: seed 0's ``dir_mild`` partition
    (the sweep's, ``materialize``'s) of the sweep spec's dataset, its
    model and test set."""
    jspec, _ = _sweep_specs(())
    scn = jspec.scenario("dir_mild")
    cfg = jax_get_config(jspec.arch)
    train, test, _ = jax_make_dataset(scn, jspec.samples_train,
                                      jspec.samples_test, cfg.vocab_size,
                                      jspec.data_seed)
    jinit, japply, _ = jax_make_model(jspec, cfg, scn.data.dim)
    idx, mask = part0
    return (jinit, japply, np.asarray(train["x"])[idx],
            np.asarray(train["y"])[idx], mask,
            {k: np.array(v) for k, v in test.items()})


def _acfg(pkg_cfg, pkg_local, telemetry):
    return pkg_cfg(num_clients=SWEEP_N, num_select=K, ticks=SWEEP_ROUNDS,
                   selector="hics", local=_local(pkg_local),
                   eval_every=SWEEP_ROUNDS, seed=0, telemetry=telemetry)


@pytest.fixture(scope="module")
def jax_async_run(jax_sweep):
    """The reference's async server with every group, its initial
    params and its client arrays."""
    jinit, japply, cx, cy, cm, test = _async_arrays(jax_sweep[2])
    jsrv = JAsyncServer(jinit, japply, _acfg(JAsyncConfig, JLocalSpec,
                                             GROUPS), cx, cy, cm,
                        test=test)
    params0 = to_np(jsrv.params)
    return jsrv, jsrv.run(), params0, (cx, cy, cm, test)


def test_async_invariant_and_matches_reference(jax_async_run):
    """(d) the async server at identity latency with every group: on
    and off bit-identical, the reference's telemetry matched, the
    ``async/*`` fields the history's; the tick reads nothing."""
    jsrv, jhist, params0, (cx, cy, cm, test) = jax_async_run
    init, apply, _ = make_classifier(get_config("paper-mlp"), input_dim=16)
    runs = []
    for tel in ((), GROUPS):
        srv = AsyncFederatedServer(init, apply, _acfg(AsyncConfig, LocalSpec,
                                                      tel),
                                   cx, cy, cm, test=test, device="cpu")
        srv.params = params_from_jax(params0, "cpu")
        runs.append((srv, srv.run(draws=JaxKeyChain(0, SWEEP_N, K, K, 1,
                                                    cx.shape[1]))))
    _same_run(*runs)
    srv, hist = runs[1]
    assert hist["selected"] == jhist["selected"]
    tel = srv.telemetry
    for field, key in (("fired", "fired"), ("fill", "buffer_fill"),
                       ("accepted", "accepted"), ("dropped", "dropped"),
                       ("version", "version")):
        assert np.array_equal(tel[f"async/{field}"],
                              np.asarray(hist[key], np.float32)), field
    assert np.all(tel["async/version_lag"] == 0.0)
    assert tel["async/agg_ages"].shape == (SWEEP_ROUNDS, K)
    _check_fields(tel, jsrv.telemetry, 1e-3, hist["bias_entropy"],
                  np.repeat(srv._true_ent.numpy()[None], SWEEP_ROUNDS, 0))


def test_drivers_emit_the_reference_field_set(jax_host_run, jax_sweep,
                                              jax_async_run):
    """(d) the four drivers' fields and the reference's, widths past the
    time (and seed) axes included."""
    params0 = jax_host_run[2]
    want = _field_shapes(jax_host_run[0].telemetry, 1)
    host = _port_run(params0, SYNC_GROUPS, False)[0].telemetry
    scan = _port_run(params0, SYNC_GROUPS, True)[0].telemetry
    assert _field_shapes(host, 1) == want == _field_shapes(scan, 1)
    sweep = jax_sweep[0]["telemetry"]
    assert set(sweep) == set(want) == set(jax_async_run[0].telemetry)


# ---------------------------------------------------------------------------
# (e) export
# ---------------------------------------------------------------------------


def test_export_round_trips_through_the_reference(jax_host_run, tmp_path):
    """(e) ``write_run`` read by the reference's reader; ``write_sweep``
    by the port's; ``summarize`` against the reference's; the stamp."""
    params0 = jax_host_run[2]
    server, _ = _port_run(params0, SYNC_GROUPS, True)
    path = tmp_path / "run.jsonl"
    summary = write_run(path, server.telemetry, meta={"driver": "test"})
    recs = jax_read_jsonl(path)
    header, rounds = recs[0], recs[1:]
    assert header["kind"] == "header" and header["meta"] == {
        "driver": "test"}
    assert len(rounds) == ROUNDS
    back = jax_from_records(rounds)
    live = {k: v for k, v in server.telemetry.items() if 0 not in v.shape}
    assert sorted(back) == sorted(live) == header["fields"]
    for k in live:
        np.testing.assert_allclose(back[k], live[k], rtol=1e-6)
    assert summary == jax_summarize(server.telemetry) == summarize(
        server.telemetry)
    for line in path.read_text().splitlines():
        json.loads(line)
    tel = {k: np.stack([v, v]) for k, v in server.telemetry.items()}
    sums = write_sweep(tmp_path / "sweep.jsonl", {"dir_mild/hics": tel},
                       meta={"driver": "test"})
    recs = read_jsonl(tmp_path / "sweep.jsonl")
    assert len(recs) == 1 + 2 * ROUNDS
    seed1 = telemetry_from_records([r for r in recs[1:] if r["seed"] == 1])
    for k in live:
        np.testing.assert_allclose(seed1[k], live[k], rtol=1e-6)
    assert sums["dir_mild/hics"] == summarize(server.telemetry)
    stamp = env_stamp()
    assert stamp["backend"] == "cpu" and stamp["device_kind"] == "cpu"
    assert set(COMPARE_KEYS) <= set(stamp)
    assert COMPARE_KEYS == ("backend", "device_kind", "cpu_count")
    assert sorted(stamp) == sorted(
        ["torch", "backend", "device_kind", "device_count", "cpu_count",
         "python", "platform", "git_sha"])
    assert stamp["torch"] == torch.__version__


# ---------------------------------------------------------------------------
# (f) trace
# ---------------------------------------------------------------------------


def test_trace_ranges_behind_the_switch():
    """(f) without ``REPRO_TRACE`` the wrappers are no-ops and a CPU
    profile of the entropy entry point has no ``kernels/`` range; a
    subprocess with ``REPRO_TRACE=1`` finds its range."""
    assert os.environ.get("REPRO_TRACE", "") != "1" and not trace_enabled()
    fn = lambda x: x
    assert annotate("kernels/x")(fn) is fn
    with trace_span("fed/x") as span:
        assert span is None
    code = (
        "import torch\n"
        "from repro_torch.kernels import ops\n"
        "x = torch.randn(4, 10)\n"
        "with torch.profiler.profile() as prof:\n"
        "    ops.estimate_entropies(x, 0.0025, device='cpu')\n"
        "print(sorted({e.key for e in prof.key_averages()\n"
        "              if e.key.startswith('kernels/')}))\n")
    with torch.profiler.profile() as prof:
        ops.estimate_entropies(torch.randn(4, 10), 0.0025, device="cpu")
    assert not [e.key for e in prof.key_averages()
                if e.key.startswith("kernels/")]
    env = dict(os.environ, REPRO_TRACE="1", PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "['kernels/estimate_entropies']"


# ---------------------------------------------------------------------------
# (g) launch/train.py --telemetry
# ---------------------------------------------------------------------------


def test_train_cli_telemetry(tmp_path, monkeypatch, capsys):
    """(g) the reference's CLI writes its telemetry and history (its
    model and local training replaced by a head bias and a cheap
    deterministic stand-in: what is held is the writer); the port's
    writer on that history gives its records, field for field; the
    port's CLI writes the same fields and meta keys from its own run,
    its loss the history's."""
    argv = ["--rounds", "3", "--clients", "4", "--select", "2",
            "--seq-len", "8", "--seqs-per-client", "1"]
    jpath, hpath = tmp_path / "j.jsonl", tmp_path / "j.json"

    def stand_in(api, params, tokens, lr, epochs):
        # a head-bias update and a loss that differ by client
        shift = jnp.cos(jnp.arange(512) * (tokens[0, 1] % 7 + 1.0))
        return ({"lm_head": {"b": params["lm_head"]["b"] + 1e-3 * shift}},
                jnp.mean(tokens.astype(jnp.float32)) / 100.0)

    head = types.SimpleNamespace(init=lambda key: {
        "lm_head": {"b": jnp.zeros(512, jnp.float32)}})
    monkeypatch.setattr(jtrain, "get_model", lambda cfg: head)
    monkeypatch.setattr(jtrain, "local_lm_update", stand_in)
    monkeypatch.setattr(sys, "argv", ["train"] + argv + [
        "--telemetry", str(jpath), "--out", str(hpath)])
    jtrain.main()
    want = jax_read_jsonl(jpath)
    jhist = json.loads(hpath.read_text())
    args = dataclasses.make_dataclass("Args", ["clients", "selector",
                                               "rounds"])(4, "hics", 3)
    tpath = tmp_path / "t.jsonl"
    ttrain.write_telemetry(tpath, jhist, "qwen3-8b-reduced", args)
    got = read_jsonl(tpath)
    assert got[0]["meta"] == want[0]["meta"]
    assert got[0]["fields"] == want[0]["fields"]
    assert got[1:] == want[1:]
    opath = tmp_path / "o.jsonl"
    res = ttrain.main(["--device", "cpu", "--telemetry", str(opath)] + argv)
    own = read_jsonl(opath)
    assert own[0]["fields"] == want[0]["fields"]
    assert sorted(own[0]["meta"]) == sorted(want[0]["meta"])
    assert own[0]["env"]["backend"] == "cpu"
    back = telemetry_from_records(own[1:])
    np.testing.assert_allclose(back["training/loss"],
                               res["history"]["loss"], rtol=1e-6)
    assert "wrote telemetry" in capsys.readouterr().out
