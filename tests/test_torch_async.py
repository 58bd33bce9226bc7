"""The port's buffered-async server, ring buffer and latency models
against the JAX reference, on the CPU.

paper-mlp, 12 clients, K = 3, 2 seeds.  Held here:

(a) the latency tables of all five kinds, bit-equal;
(b) the ring buffer: random pushes (overflow) and pops (wraparound)
    leave the reference's ids, versions, head, fill and payload, with
    its accepted and dropped counts;
(c) ``aggregate_params``: unit weights bit-equal to the unweighted
    mean, other weights within 1e-6 of the reference;
(d) identity latency at B = M = K: hics and cs bit-equal to the port's
    sync scanned driver on the same data (participants, train loss,
    final params, Ĥ);
(e) stragglers_severe at B = 9, M = 6 (``stale_slots`` = 2):
    participants, fired, accepted, dropped, version and fill equal to
    the reference's ``AsyncFederatedServer`` on its initial params and
    key chain, loss within 1e-4; and one ``run_async_sweep`` cell
    against the reference's;
(f) the tick step reading nothing on the host;
(g) the refusals: an unknown telemetry group, ``full_all`` selectors,
    M > B; the ``async`` group recorded.

Each test loops over its cases (``torch_parity.each``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import SyntheticSpec as JSyntheticSpec
from repro.fed import LocalSpec as JLocalSpec
from repro.fed.async_server import AsyncConfig as JAsyncConfig
from repro.fed.async_server import AsyncFederatedServer as JAsyncServer
from repro.fed.buffer import buffer_init as jax_buffer_init
from repro.fed.buffer import buffer_pop as jax_buffer_pop
from repro.fed.buffer import buffer_push as jax_buffer_push
from repro.fed.latency import LatencySpec as JLatencySpec
from repro.fed.latency import delay_tables as jax_delay_tables
from repro.fed.server import aggregate_params as jax_aggregate_params
from repro.scenarios import SweepSpec as JSweepSpec
from repro.scenarios import build_async_pair as jax_build_async_pair
from repro.scenarios import make_dataset as jax_make_dataset
from repro.scenarios import materialize as jax_materialize
from repro.scenarios import run_async_sweep as jax_run_async_sweep
from repro.scenarios.sweep import _make_model as jax_make_model
from repro_torch.data import SyntheticSpec
from repro_torch.fed import (AsyncConfig, AsyncFederatedServer, FedConfig,
                             FederatedServer, LatencySpec, LocalSpec,
                             aggregate_params, buffer_init, buffer_pop,
                             buffer_push, delay_tables, max_delay,
                             ticks_to_loss)
from repro_torch.models import make_classifier, params_from_jax
from repro_torch.optim import tree_leaves
from repro_torch.scenarios import SweepSpec, build_async_pair
from torch_parity import JaxKeyChain, each, port_pair_on_reference, to_np

N, K = 12, 3
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__")
STRAGGLERS = dict(kind="stragglers", straggler_frac=0.3, straggler_delay=6)


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
# (a)-(c) latency, buffer, aggregation
# ---------------------------------------------------------------------------


def test_latency_tables_bit_equal_all_kinds():
    """(a) every kind, at two seeds and a nonzero base."""
    for kind in ("identity", "uniform", "lognormal", "stragglers",
                 "flash_crowd"):
        for seed in (0, 3):
            kw = dict(kind=kind, base=1, scale=2.5, mu=0.3, seed=seed,
                      straggler_frac=0.4, straggler_delay=5, period=6)
            want = jax_delay_tables(JLatencySpec(**kw), N, 17, K)
            got = delay_tables(LatencySpec(**kw), N, 17, K)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and np.array_equal(g, w), kind
            assert max_delay(LatencySpec(**kw), *got, 4) <= 4
    with pytest.raises(ValueError, match="latency kind"):
        LatencySpec(kind="nope")


def test_buffer_ops_equal_reference():
    """(b) 40 random steps on B = 3: a push of four masked rows (full
    buffers drop the overflow) or a pop of one or two (the head wraps)."""
    rng = np.random.default_rng(0)
    proto = {"v": np.zeros((), np.float32), "w": np.zeros(2, np.float32)}
    jbuf = jax_buffer_init(3, jax.tree_util.tree_map(jnp.asarray, proto))
    tbuf = buffer_init(3, {k: torch.tensor(v) for k, v in proto.items()})
    jpush = jax.jit(jax_buffer_push)
    jpop = jax.jit(jax_buffer_pop, static_argnums=1)
    for step in range(40):
        fill = int(tbuf.fill)
        m = int(rng.integers(1, 3))
        if rng.random() < 0.5 and fill >= m:
            jout = jpop(jbuf, m)
            tout = buffer_pop(tbuf, m)
            jbuf, tbuf = jout[3], tout[3]
            for k in proto:
                assert np.array_equal(tout[0][k].numpy(),
                                      np.asarray(jout[0][k])), step
            for a, b in zip(tout[1:3], jout[1:3]):
                assert np.array_equal(a.numpy(), np.asarray(b)), step
        else:
            mask = rng.random(4) < 0.6
            rows = {"v": rng.normal(size=4).astype(np.float32),
                    "w": rng.normal(size=(4, 2)).astype(np.float32)}
            ids = rng.integers(0, N, 4).astype(np.int32)
            ver = rng.integers(0, 9, 4).astype(np.int32)
            jbuf, jacc, jdrop = jpush(
                jbuf, jnp.asarray(mask),
                {k: jnp.asarray(v) for k, v in rows.items()},
                jnp.asarray(ids), jnp.asarray(ver))
            tbuf, tacc, tdrop = buffer_push(
                tbuf, torch.tensor(mask),
                {k: torch.tensor(v) for k, v in rows.items()},
                torch.tensor(ids), torch.tensor(ver))
            assert (int(tacc), int(tdrop)) == (int(jacc), int(jdrop)), step
            assert int(tacc) + int(tdrop) == int(mask.sum())
        for field in ("ids", "version", "head", "fill"):
            assert np.array_equal(getattr(tbuf, field).numpy(),
                                  np.asarray(getattr(jbuf, field))), step
        for k in proto:
            assert np.array_equal(tbuf.payload[k].numpy(),
                                  np.asarray(jbuf.payload[k])), step
    with pytest.raises(ValueError, match="capacity"):
        buffer_init(0, {"v": torch.zeros(())})


def test_aggregate_params_weighted():
    """(c) K = 5 stacked leaves: unit weights bit-equal to the plain
    mean; staleness weights (1 + age)^-0.5 within 1e-6 of the
    reference."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.normal(size=(5, 7, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(5, 4)).astype(np.float32)}}
    ttree = {"a": torch.tensor(tree["a"]),
             "b": {"c": torch.tensor(tree["b"]["c"])}}
    plain = aggregate_params(ttree)
    unit = aggregate_params(ttree, torch.ones(5))
    for a, b in zip(tree_leaves(plain), tree_leaves(unit)):
        assert torch.equal(a, b)
    ages = np.array([0, 1, 3, 0, 7], np.float32)
    w = np.power(1.0 + ages, -0.5).astype(np.float32)
    want = jax_aggregate_params(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(w))
    got = aggregate_params(ttree, torch.tensor(w))
    for g, x in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), atol=1e-6)


# ---------------------------------------------------------------------------
# (d)-(f) the async server
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _client_data(scenario="stragglers_severe", seed=0):
    """The reference's client arrays of one scenario's partition, and
    its model."""
    jspec, _ = _sweep_specs(scenario)
    scn = jspec.scenario(scenario)
    cfg = jax_get_config("paper-mlp")
    train, test, _ = jax_make_dataset(scn, 600, 200, cfg.vocab_size)
    part = jax_materialize(scn, seed, train, cfg.vocab_size, N,
                           jspec.capacity())
    idx = np.asarray(part.idx)
    jinit, japply, _ = jax_make_model(jspec, cfg, scn.data.dim)
    return (jinit, japply, np.asarray(train["x"])[idx],
            np.asarray(train["y"])[idx], np.array(part.mask),
            {k: np.array(v) for k, v in test.items()})


def _port_model():
    init, apply, _ = make_classifier(
        jax_get_config("paper-mlp"), input_dim=16)
    return init, apply


def _identity_case(selector):
    """(d) one case: the async server at identity latency, B = M = K,
    against the sync scanned driver on the same arrays and seed."""
    _, _, cx, cy, cm, test = _client_data("dir_mild")
    init, apply = _port_model()
    common = dict(num_clients=N, num_select=K, selector=selector,
                  local=_local(LocalSpec), eval_every=3, seed=0)
    sync = FederatedServer(init, apply, FedConfig(rounds=6, jit_rounds=True,
                                                  **common),
                           cx, cy, cm, test=test, device="cpu")
    asrv = AsyncFederatedServer(init, apply, AsyncConfig(ticks=6, **common),
                                cx, cy, cm, test=test, device="cpu")
    hs, ha = sync.run(), asrv.run()
    assert ha["selected"] == hs["selected"]
    assert ha["train_loss"] == hs["train_loss"]
    assert ha["bias_entropy"] == hs["bias_entropy"]
    assert ha["test_acc"] == hs["test_acc"]
    for a, b in zip(tree_leaves(asrv.params), tree_leaves(sync.params)):
        assert torch.equal(a, b)
    for a, b in zip(asrv.state, sync.state):
        assert torch.equal(a, b)
    assert ha["aggregations"] == 6 and ha["dropped_total"] == 0
    assert ha["version"] == list(range(1, 7))
    assert ha["segment_rounds"] == [3, 3]


def test_identity_latency_bit_equal_to_sync_scan():
    """(d) hics and cs, 6 ticks in two segments."""
    each(_identity_case, ["hics", "cs"])


def _async_kw(ticks):
    return dict(num_clients=N, num_select=K, ticks=ticks, selector="hics",
                capacity=9, threshold=6, eval_every=ticks, seed=0)


def test_stragglers_equal_reference_server():
    """(e) 10 ticks of stragglers_severe with B = 9, M = 6: the
    reference's participants, fired ticks, accepted, dropped, versions
    and fills; train loss within 1e-4; ``stale_slots`` = 2, so the
    refresh runs over 2K rows."""
    jinit, japply, cx, cy, cm, test = _client_data()
    jsrv = JAsyncServer(jinit, japply, JAsyncConfig(
        latency=JLatencySpec(**STRAGGLERS), local=_local(JLocalSpec),
        **_async_kw(10)), cx, cy, cm, test=test)
    init, apply = _port_model()
    tsrv = AsyncFederatedServer(init, apply, AsyncConfig(
        latency=LatencySpec(**STRAGGLERS), local=_local(LocalSpec),
        **_async_kw(10)), cx, cy, cm, test=test, device="cpu")
    assert tsrv.state.stale_ids.shape[0] == 2 * K
    tsrv.params = params_from_jax(to_np(jsrv.params), "cpu")
    chain = JaxKeyChain(0, N, K, K, 1, cx.shape[1])
    jh = jsrv.run()
    th = tsrv.run(draws=chain)
    assert th["selected"] == jh["selected"]
    for key in ("fired", "accepted", "dropped", "version", "buffer_fill"):
        assert th[key] == jh[key], key
    np.testing.assert_allclose(th["train_loss"], jh["train_loss"],
                               rtol=1e-4)
    assert th["aggregations"] == jh["aggregations"] >= 1
    got = np.asarray(th["accepted"]) + np.asarray(th["dropped"])
    assert np.array_equal(got, _arrivals(tsrv, np.asarray(th["selected"])))
    assert sum(th["accepted"]) == 6 * th["aggregations"] + \
        th["buffer_fill"][-1]
    assert ticks_to_loss(th, 1e9) == 0 and ticks_to_loss(th, -1.0) is None


def _sweep_specs(scenario):
    kw = dict(scenarios=(scenario,), selectors=("hics",), seeds=(0, 1),
              arch="paper-mlp", num_clients=N, num_select=K, rounds=6,
              samples_train=600, samples_test=200)
    return (JSweepSpec(data=JSyntheticSpec(dim=16, rank=2, noise=0.5),
                       local=_local(JLocalSpec), **kw),
            SweepSpec(data=SyntheticSpec(dim=16, rank=2, noise=0.5),
                      local=_local(LocalSpec), **kw))


def test_async_sweep_cell_equals_reference():
    """(e) run_async_sweep's stragglers_severe/hics cell at B = M = 6
    (``stale_slots`` = 2) on the reference's partitions, params and key
    chain: every seed's participants, fired, accepted, dropped and
    versions."""
    jspec, spec = _sweep_specs("stragglers_severe")
    want = jax_run_async_sweep(jspec, capacity=6, threshold=6)["grid"][
        "stragglers_severe/hics"]
    jpair, _ = jax_build_async_pair(jspec, "stragglers_severe", "hics",
                                    capacity=6, threshold=6)
    params0 = [to_np(jax.tree_util.tree_map(lambda l: l[i], jpair.params0))
               for i in range(2)]
    _, acfg = build_async_pair(spec, "stragglers_severe", "hics",
                               capacity=6, threshold=6, device="cpu")
    pair = port_pair_on_reference(jspec, spec, "stragglers_severe", "hics",
                                  params0, acfg=acfg)
    ids, loss, _, fired, fill, acc, drop, ver = pair.run()
    assert np.array_equal(ids, np.asarray(want["selected"]))
    np.testing.assert_allclose(loss, np.asarray(want["train_loss"]),
                               rtol=1e-4)
    assert fired.sum(axis=1).tolist() == want["aggregations"]
    assert drop.sum(axis=1).tolist() == want["dropped_total"]
    assert ver[:, -1].tolist() == want["final_version"]
    np.testing.assert_allclose(fill.mean(axis=1), want["mean_fill"])
    for i, srv in enumerate(pair.servers):     # arrivals all accounted
        assert np.array_equal(acc[i] + drop[i], _arrivals(srv, ids[i]))


def _arrivals(srv, selected):
    """Each tick's arrivals, from the dispatches and the delay tables:
    client ``selected[t, s]`` dispatched at t arrives at t + clip(base
    + jitter[t, s], 0, W - 1)."""
    ticks = selected.shape[0]
    base = srv._base_delay.cpu().numpy()
    delay = np.clip(base[selected] + srv._jitter.numpy()[:ticks], 0,
                    srv._window - 1)
    due = (np.arange(ticks)[:, None] + delay).ravel()
    return np.bincount(due[due < ticks], minlength=ticks)


def test_tick_step_reads_nothing_on_the_host():
    """(f) 6 ticks of the stragglers tick step (both branches of the
    fire test and of every select) with the host reads patched to
    raise."""
    _, _, cx, cy, cm, _ = _client_data()
    init, apply = _port_model()
    srv = AsyncFederatedServer(init, apply, AsyncConfig(
        latency=LatencySpec(**STRAGGLERS), local=_local(LocalSpec),
        **_async_kw(6)), cx, cy, cm, device="cpu")
    step = srv._make_round_step()
    carry = srv._initial_carry()
    draws = [srv._draw_host(t) for t in range(6)]
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the tick step")

    try:
        for name in saved:
            setattr(torch.Tensor, name, host_read)
        for rd in draws:
            carry, out = step(carry, rd)
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert int(carry[3]) == 6 and len(out) == 9


def test_async_refusals():
    """(g) an unknown telemetry group (``ValueError``), DivFL's ideal
    mode (``full_all``) in both entry points, M > B; the ``async``
    group runs and records every tick."""
    with pytest.raises(ValueError, match="unknown metric group"):
        AsyncConfig(telemetry=("asink",))
    _, _, cx, cy, cm, _ = _client_data("dir_mild")
    init, apply = _port_model()
    srv = AsyncFederatedServer(init, apply, AsyncConfig(
        num_clients=N, num_select=K, ticks=2, telemetry=("async",)),
        cx, cy, cm, device="cpu")
    hist = srv.run()
    assert np.array_equal(srv.telemetry["async/version"],
                          np.float32(hist["version"]))
    assert srv.telemetry["async/agg_ages"].shape == (2, K)
    _, spec = _sweep_specs("dir_mild")
    with pytest.raises(ValueError, match="async semantics"):
        build_async_pair(spec, "dir_mild", "divfl", device="cpu")
    with pytest.raises(ValueError, match="async semantics"):
        AsyncFederatedServer(init, apply, AsyncConfig(
            num_clients=N, num_select=K, ticks=2, selector="divfl"),
            cx, cy, cm, device="cpu")
    with pytest.raises(ValueError, match="threshold"):
        AsyncConfig(num_select=2, capacity=2, threshold=3).sizes()
    assert dataclasses.replace(AsyncConfig(), capacity=0).sizes() == (5, 5,
                                                                      5)
