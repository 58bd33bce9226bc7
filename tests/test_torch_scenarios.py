"""The port's scenarios package against the JAX reference, on the CPU.

paper-mlp, 12 clients, K = 3, 6 rounds, 2 seeds.  Held here:

(a) the five partition kinds: the reference's draws on its
    ``scenario_key`` (replayed by ``torch_parity.partition_draws``)
    give the port's ``partition_device`` the reference's ``idx``,
    ``mask`` and ``counts``, equal; ``pack_assignment`` equal on random
    assignments;
(b) the port's own log-gamma draw finite at α = 1e-3, and its draws'
    means (log Γ(α) against ψ(α), Dirichlet proportions against 1/N)
    within stated tolerances;
(c) the registry (every scenario's fields) and ``make_dataset``,
    bit-equal;
(d) ``availability_mask``, ``replace_unavailable`` and
    ``masked_select`` (hics, random) on the reference's draws: equal;
(e) ``stale_slots = 2`` with two updates between selects (repeated
    ids in the ring): the hics and cs caches against the reference and
    a from-scratch build, exactly symmetric;
(f) the sweep: each seed's participants equal the reference's
    ``run_sweep`` (loss within 1e-4) for mixed_80_20, flaky_severe and
    a feddyn cell, on the reference's partitions, initial params and
    key chain; and, on the port's own draws, each seed bit-equal to
    the port's ``run_host_reference`` in both drivers;
(g) the sweep's round step reading nothing on the host;
(h) the refusals: an unknown telemetry group, a time-varying host
    reference, unknown names; a telemetry group recorded per seed.

Each test loops over its cases (``torch_parity.each``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Observations as JObservations
from repro.core import make_functional as jax_make_functional
from repro.data import SyntheticSpec as JSyntheticSpec
from repro.fed import LocalSpec as JLocalSpec
from repro.kernels import hics_selection_step_cached as jax_cached_step
from repro.scenarios import SCENARIOS as JSCENARIOS
from repro.scenarios import SweepSpec as JSweepSpec
from repro.scenarios import availability_mask as jax_availability_mask
from repro.scenarios import build_pair as jax_build_pair
from repro.scenarios import make_dataset as jax_make_dataset
from repro.scenarios import masked_select as jax_masked_select
from repro.scenarios import pack_assignment as jax_pack_assignment
from repro.scenarios import partition_device as jax_partition_device
from repro.scenarios import replace_unavailable as jax_replace_unavailable
from repro.scenarios import run_sweep as jax_run_sweep
from repro.scenarios import scenario_key as jax_scenario_key
from repro_torch.core.selectors import (Observations, make_functional)
from repro_torch.core.selectors.baselines import _angular_scratch
from repro_torch.data import SyntheticSpec
from repro_torch.fed import LocalSpec
from repro_torch.kernels import ref
from repro_torch.scenarios import (SCENARIOS, SweepSpec,
                                   availability_mask, draw_partition,
                                   get_scenario, make_dataset,
                                   masked_select, pack_assignment,
                                   replace_unavailable,
                                   run_host_reference, run_sweep)
from repro_torch.scenarios.partition_device import log_gamma
from repro_torch.scenarios.sweep import build_pair
from torch_parity import (JaxKeyChain, availability_draws, each,
                          partition_draws, port_pair_on_reference,
                          select_noise, to_np)

N, K, ROUNDS, SEEDS = 12, 3, 6, (0, 1)
COMMON = dict(arch="paper-mlp", num_clients=N, num_select=K, rounds=ROUNDS,
              seeds=SEEDS, samples_train=600, samples_test=200)
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__")


def _local(pkg_local, algo="fedavg"):
    return pkg_local(algo=algo, optimizer="sgd", lr=0.1, epochs=1,
                     batch_size=32, mu=0.1)


def _specs(scenario, selector, algo="fedavg"):
    """The same sweep spec in both packages."""
    kw = dict(COMMON, scenarios=(scenario,), selectors=(selector,))
    return (JSweepSpec(data=JSyntheticSpec(dim=16, rank=2, noise=0.5),
                       local=_local(JLocalSpec, algo), **kw),
            SweepSpec(data=SyntheticSpec(dim=16, rank=2, noise=0.5),
                      local=_local(LocalSpec, algo), **kw))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The runs' tensors are tiny: one torch thread, as the other port
    tests (more only spin against the other test workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a)-(c) partitions, draws, registry
# ---------------------------------------------------------------------------

_jax_partition = jax.jit(
    jax_partition_device, static_argnums=(2, 3, 4, 5),
    static_argnames=("alphas", "labels_per_client", "beta"))
KIND_CASES = [("dir_severe", 30), ("mixed_80_20", 200), ("shards2", 200),
              ("quantity_skew", 120), ("iid", 200)]


def _partition_case(case):
    name, cap = case
    jscn, scn = JSCENARIOS[name], SCENARIOS[name]
    jtrain, _, _ = jax_make_dataset(jscn, 600, 200, 10)
    labels = torch.tensor(np.asarray(jtrain["y"]))
    for seed in SEEDS:
        key = jax_scenario_key(jscn, seed)
        want = _jax_partition(
            key, jtrain["y"], 10, N, jscn.kind, cap, alphas=jscn.alphas,
            labels_per_client=jscn.labels_per_client, beta=jscn.beta)
        draws = partition_draws(key, scn.kind, 600, 10, N, scn.alphas,
                                scn.labels_per_client, scn.beta)
        got = scn.partition(draws, labels, 10, N, cap)
        for field in ("idx", "mask", "counts"):
            w = np.asarray(getattr(want, field))
            g = getattr(got, field).numpy()
            assert g.dtype == w.dtype and np.array_equal(g, w), field
        # the port's own draws: a partition of every sample
        own = scn.partition(scn.draw(torch.Generator().manual_seed(seed),
                                     600, 10, N), labels, 10, N, cap)
        assert int(own.counts.sum()) == 600
        kept = own.idx[own.mask > 0]
        assert len(set(kept.tolist())) == kept.numel()


def test_partitions_equal_reference_all_kinds():
    """(a) dirichlet (α = 1e-3, cap 30 clips), multi_alpha, shards,
    quantity, iid."""
    each(_partition_case, KIND_CASES)


def test_pack_assignment_equals_reference():
    """(a) random assignments, caps below and above the largest
    client."""
    rng = np.random.default_rng(0)
    pack = jax.jit(jax_pack_assignment, static_argnums=(1, 2))
    n = 9
    for trial in range(4):
        a = rng.integers(0, n - trial, 300).astype(np.int32)
        for cap in (1, 7, 300):
            want = pack(jnp.asarray(a), n, cap)
            got = pack_assignment(torch.tensor(a), n, cap)
            for w, g in zip(want, got):
                assert np.array_equal(g.numpy(), np.asarray(w)), (trial, cap)


def test_log_gamma_draw_finite_and_dirichlet_means():
    """(b) at α = 1e-3 a direct gamma draw underflows; log Γ(α + 1) +
    log(U)/α stays finite, its mean within 5 standard errors of
    E[log X] = ψ(α) (std ~ 1/α); Dirichlet(0.5) and (0.01) proportions
    over N = 12 average 1/N within 0.01."""
    gen = torch.Generator().manual_seed(0)
    alpha = 1e-3
    x = log_gamma(gen, torch.full((200_000,), alpha))
    assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
    from scipy.special import polygamma, psi
    se = np.sqrt(polygamma(1, alpha) / x.numel())
    assert abs(float(x.double().mean()) - psi(alpha)) < 5 * se
    for a in (0.5, 0.01):
        lp = log_gamma(gen, torch.full((20_000, N), a)).double()
        p = torch.softmax(lp, dim=1)
        assert float((p.mean(dim=0) - 1.0 / N).abs().max()) < 0.01, a
    draws = draw_partition(gen, "dirichlet", 600, 10, N, alphas=(1e-3,))
    assert bool(torch.isfinite(draws.logp).all())


def test_registry_and_dataset_equal_reference():
    """(c) all 12 scenarios field for field, and each one's dataset."""
    assert sorted(SCENARIOS) == sorted(JSCENARIOS)
    for name, jscn in JSCENARIOS.items():
        scn = get_scenario(name)
        for f in dataclasses.fields(jscn):
            a, b = getattr(scn, f.name), getattr(jscn, f.name)
            if dataclasses.is_dataclass(b):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            else:
                assert a == b, (name, f.name)
        assert scn.time_varying == jscn.time_varying
    for name in ("mixed_80_20", "flash_crowd"):
        jtrain, jtest, jprotos = jax_make_dataset(JSCENARIOS[name], 300,
                                                  50, 10, 3)
        train, test, protos = make_dataset(SCENARIOS[name], 300, 50, 10,
                                           3, device="cpu")
        for a, b in ((train, jtrain), (test, jtest)):
            for k in b:
                assert np.array_equal(a[k].numpy(), np.asarray(b[k])), k
        assert np.array_equal(protos, np.asarray(jprotos))
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")


# ---------------------------------------------------------------------------
# (d) availability
# ---------------------------------------------------------------------------


def test_availability_equals_reference():
    """(d) the masks of every kind over 8 rounds, and
    ``replace_unavailable`` with some, none and all available."""
    n = 40
    for name in ("dir_mild", "flaky_severe", "diurnal_mixed"):
        for t in range(8):
            kr = jax.random.PRNGKey(100 + t)
            u, _ = availability_draws(kr, n)
            want = jax_availability_mask(JSCENARIOS[name], n, t,
                                         jax.random.fold_in(kr, 1))
            for tt in (t, torch.tensor(t, dtype=torch.int32)):
                got = availability_mask(SCENARIOS[name], n, tt, u)
                assert np.array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(0)
    for trial in range(8):
        kr = jax.random.PRNGKey(trial)
        _, g = availability_draws(kr, n)
        ids = rng.choice(n, 5, replace=False).astype(np.int32)
        avail = rng.random(n) < [0.5, 0.0, 1.0, 0.1][trial % 4]
        w = rng.random(n).astype(np.float32)
        want = jax_replace_unavailable(
            jax.random.fold_in(kr, 2), jnp.asarray(ids),
            jnp.asarray(avail), jnp.asarray(w))
        got = replace_unavailable(g, torch.tensor(ids), torch.tensor(avail),
                                  torch.tensor(w))
        assert np.array_equal(got.numpy(), np.asarray(want)), trial


def _masked_case(selector):
    n, c = 10, 5
    jfn = jax_make_functional(selector, num_clients=n, num_select=K,
                              total_rounds=8, num_classes=c)
    tfn = make_functional(selector, num_clients=n, num_select=K,
                          total_rounds=8, num_classes=c, device="cpu")
    jstate, tstate = jfn.init(jax.random.PRNGKey(0)), tfn.init()
    jselect = jax.jit(functools.partial(jax_masked_select, jfn))
    jupdate = jax.jit(jfn.update)
    rng = np.random.default_rng(1)
    for t in range(8):
        kr = jax.random.PRNGKey(50 + t)
        k_sel = jax.random.split(kr)[0]
        avail = rng.random(n) < 0.6
        _, g = availability_draws(kr, n)
        jids, jstate = jselect(jstate, t, k_sel, jnp.asarray(avail),
                               jax.random.fold_in(kr, 2))
        tids, tstate = masked_select(tfn, tstate, t,
                                     select_noise(k_sel, n, K, K),
                                     torch.tensor(avail), g)
        assert np.array_equal(tids.numpy(), np.asarray(jids)), t
        assert np.array_equal(tstate.seen.numpy(), np.asarray(jstate.seen))
        assert np.array_equal(tstate.weights.numpy(),
                              np.asarray(jstate.weights))
        db = (rng.normal(size=(K, c)) * 0.05).astype(np.float32)
        jstate = jupdate(jstate, t, jids,
                         JObservations(bias_updates=jnp.asarray(db)))
        tstate = tfn.update(tstate, t, tids,
                            Observations(bias_updates=torch.tensor(db)))


def test_masked_select_equals_reference():
    """(d) hics (sweep, then clustered) and random, 8 rounds under a
    random 60% availability."""
    each(_masked_case, ["hics", "random"])


# ---------------------------------------------------------------------------
# (e) stale_slots = 2
# ---------------------------------------------------------------------------


def _stale_case(selector):
    n, c = 10, 6
    kw = dict(num_clients=n, num_select=K, total_rounds=10, stale_slots=2)
    if selector == "hics":
        kw["num_classes"] = c
    else:
        kw["feat_dim"] = c
    jfn = jax_make_functional(selector, **kw)
    tfn = make_functional(selector, device="cpu", **kw)
    assert tfn.init().stale_ids.shape[0] == 2 * K
    jstate, tstate = jfn.init(jax.random.PRNGKey(0)), tfn.init()
    jselect, jupdate = jax.jit(jfn.select), jax.jit(jfn.update)
    rng = np.random.default_rng(2)
    for t in range(7):
        k_sel = jax.random.PRNGKey(200 + t)
        jids, jstate = jselect(jstate, t, k_sel)
        tids, tstate = tfn.select(tstate, t, select_noise(k_sel, n, K, K))
        assert np.array_equal(tids.numpy(), np.asarray(jids)), t
        # two updates between selects: the cohort, then one repeating
        # one of its ids (repeated ids in the ring, equal rows)
        ids = np.asarray(jids)
        for upd in (ids, np.array([ids[0], (ids[1] + 1) % n, ids[0]])):
            rows = rng.normal(size=(K, c)).astype(np.float32)
            for i, cid in enumerate(upd):
                rows[i] = rows[int(np.where(upd == cid)[0][0])]
            jobs = JObservations(bias_updates=jnp.asarray(rows),
                                 full_updates=jnp.asarray(rows))
            tobs = Observations(bias_updates=torch.tensor(rows),
                                full_updates=torch.tensor(rows))
            jstate = jupdate(jstate, t, jnp.asarray(upd, jnp.int32), jobs)
            tstate = tfn.update(tstate, t, torch.tensor(upd, dtype=torch
                                                        .int32), tobs)
        assert int(tstate.stale_fill) == 2 * K
    tids, tstate = tfn.select(tstate, 7, select_noise(
        jax.random.PRNGKey(9), n, K, K))
    jids, jstate = jselect(jstate, 7, jax.random.PRNGKey(9))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    dist = tstate.dist_cache
    np.testing.assert_allclose(dist.numpy(), np.asarray(jstate.dist_cache),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(dist, dist.T)
    if selector == "hics":
        _, scratch = ref.selection_step_ref(tstate.delta_b, 0.0025, 10.0)
        _, jd, _ = jax_cached_step(
            jstate.delta_b, jnp.zeros_like(jstate.dist_cache),
            jnp.zeros_like(jstate.row_stats),
            jnp.arange(n, dtype=jnp.int32), 0.0025)
        np.testing.assert_allclose(np.asarray(jd), scratch.numpy(),
                                   atol=1e-5, rtol=1e-5)
    else:
        scratch = _angular_scratch(tstate.feats)
    np.testing.assert_allclose(dist.numpy(), scratch.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_stale_slots_two_caches():
    """(e) hics and cs, 7 select/update/update rounds, then one more
    select that refreshes the 2K ring."""
    each(_stale_case, ["hics", "cs"])


# ---------------------------------------------------------------------------
# (f)-(g) the sweep
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _reference_cell(scenario, selector, algo):
    jspec, _ = _specs(scenario, selector, algo)
    res = jax_run_sweep(jspec)["grid"][f"{scenario}/{selector}"]
    pair = jax_build_pair(jspec, scenario, selector)
    params0 = [to_np(jax.tree_util.tree_map(lambda l: l[i], pair.params0))
               for i in range(len(SEEDS))]
    return res, params0


def _port_pair_on_reference(scenario, selector, algo):
    jspec, spec = _specs(scenario, selector, algo)
    _, params0 = _reference_cell(scenario, selector, algo)
    return port_pair_on_reference(jspec, spec, scenario, selector,
                                  params0)


def _sweep_vs_reference(case):
    scenario, selector, algo = case
    want, _ = _reference_cell(scenario, selector, algo)
    ids, loss, ent, acc = _port_pair_on_reference(scenario, selector,
                                                  algo).run()
    assert np.array_equal(ids, np.asarray(want["selected"]))
    np.testing.assert_allclose(loss, np.asarray(want["train_loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(acc, np.asarray(want["test_acc"]),
                               atol=1e-5)
    if scenario == "flaky_severe":      # every pick available
        for i, seed in enumerate(SEEDS):
            chain = JaxKeyChain(seed, N, K, K, 1, 1, availability=True)
            for t in range(ROUNDS):
                rd = chain(t)
                avail = availability_mask(SCENARIOS[scenario], N, t,
                                          rd.avail)
                assert bool(avail[torch.tensor(ids[i, t])].all())


def test_sweep_matches_reference_sweep():
    """(f) mixed_80_20 hics and cs, flaky_severe hics, dir_mild with
    feddyn."""
    each(_sweep_vs_reference, [("mixed_80_20", "hics", "fedavg"),
                               ("mixed_80_20", "cs", "fedavg"),
                               ("flaky_severe", "hics", "fedavg"),
                               ("dir_mild", "hics", "feddyn")])


def test_sweep_seeds_bit_equal_to_host_reference():
    """(f) on the port's own draws: each seed's participants and train
    loss bit-equal to ``run_host_reference`` through the host loop and
    through the scanned driver."""
    _, spec = _specs("mixed_80_20", "hics")
    spec = dataclasses.replace(spec, selectors=("hics", "cs"))
    res = run_sweep(spec, device="cpu")
    for selector in spec.selectors:
        cell = res["grid"][f"mixed_80_20/{selector}"]
        assert cell["selected"].shape == (len(SEEDS), ROUNDS, K)
        assert not np.array_equal(cell["selected"][0], cell["selected"][1])
        for i, seed in enumerate(SEEDS):
            for jit in (False, True):
                host = run_host_reference(spec, "mixed_80_20", selector,
                                          seed, jit_rounds=jit,
                                          device="cpu")
                assert host["selected"] == cell["selected"][i].tolist()
                assert np.array_equal(np.float32(host["train_loss"]),
                                      cell["train_loss"][i]), (seed, jit)
                assert host["test_acc"][-1] == cell["final_acc"][i]


def test_sweep_step_reads_nothing_on_the_host():
    """(g) the round step of every seed of a flaky_severe hics cell
    (masked select, both branches of every cond) with the host reads
    patched to raise."""
    _, spec = _specs("flaky_severe", "hics")
    pair = build_pair(spec, "flaky_severe", "hics", device="cpu")
    carries = tuple(pair.carries0)
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def host_read(*args, **kwargs):
        raise AssertionError("a host read inside the round step")

    try:
        for name in saved:
            setattr(torch.Tensor, name, host_read)
        for t in range(4):
            carries, outs = pair._all_seeds(
                carries, tuple(d[t] for d in pair.draws))
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
    assert all(int(c[3]) == 4 for c in carries)
    assert all(len(set(o[0].tolist())) == K for o in outs)


def test_sweep_refusals():
    """(h) an unknown telemetry group (``ValueError``), a host
    reference of a time-varying scenario, unknown names; the
    ``fairness`` group runs, (S, T, N) in the cell."""
    with pytest.raises(ValueError, match="unknown metric group"):
        SweepSpec(telemetry=("selektion",))
    _, spec = _specs("flaky_severe", "hics")
    fair = dataclasses.replace(spec, rounds=2, telemetry=("fairness",))
    cell = run_sweep(fair, device="cpu")["grid"]["flaky_severe/hics"]
    counts = cell["telemetry"]["fairness/sel_counts"]
    assert counts.shape == (len(SEEDS), 2, N)
    for i in range(len(SEEDS)):
        assert np.array_equal(counts[i, -1], np.bincount(
            cell["selected"][i].ravel(), minlength=N))
    with pytest.raises(ValueError, match="availability"):
        run_host_reference(spec, "flaky_severe", "hics", 0, device="cpu")
    with pytest.raises(KeyError, match="unknown selector"):
        build_pair(spec, "dir_mild", "nope", device="cpu")
    with pytest.raises(KeyError, match="unknown scenario"):
        build_pair(spec, "nope", "hics", device="cpu")
    assert spec.capacity() == 4 * 600 // N
    assert dataclasses.replace(spec, cap=33).capacity() == 33
