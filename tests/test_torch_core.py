"""The port's HiCS-FL core against the JAX reference: estimator,
head Δb extraction, clustering, the device samplers, and a 20-round
select/update sequence of the functional HiCS selector.

Inputs come from seeded numpy; the samplers' Gumbel noise is replayed
from the keys the reference draws with.  Ĥ is held to 5e-5; cluster
labels and sampled ids must be identical.  Each test loops over its
cases (``torch_parity.each``).  Also: the reference options the port
does not run (``stale_slots``, telemetry) raise naming their ROADMAP.md
item, the ported ones (every linkage and cluster count, every local
update) build and run, and a 6-round HiCS run with ``gram_in_bf16`` on
the CPU picks JAX's participants.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import clustering as jclust
from repro.core import hetero as jhet
from repro.core import sampling as jsamp
from repro.core.selectors.functional import Observations
from repro.core.selectors.hics import hics_functional as jax_hics
from repro_torch.core import (agglomerate_device, anneal_device,
                              cluster_means_device, coverage_sweep_device,
                              estimate_entropy, head_bias_updates_stacked,
                              head_num_classes, hics_functional,
                              hierarchical_sample_device, label_entropy)
from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro_torch.core import Observations as TObservations
from repro_torch.core import make_functional
from repro_torch.core.selectors import draw_select_noise
from repro_torch.data import SyntheticSpec
from repro_torch.fed import ExperimentSpec, FedConfig, LocalSpec, build
from repro_torch.models import params_from_jax
from torch_parity import JaxKeyChain, each, select_noise, to_np

def test_estimate_entropy_matches_jax():
    each(_entropy_case, [False, True], [0.63, 0.05])


def _entropy_case(normalize, temperature):
    db = (np.random.default_rng(0).normal(size=(30, 10)) * 0.05
          ).astype(np.float32)
    got = estimate_entropy(torch.tensor(db), temperature,
                           normalize=normalize)
    want = jhet.estimate_entropy(jnp.asarray(db), temperature,
                                 normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_label_entropy_matches_jax():
    r = np.random.default_rng(1)
    dists = np.stack([r.dirichlet(np.full(10, a)) for a in
                      (0.01, 0.1, 1.0, 10.0)] + [np.eye(10)[3]])
    got = label_entropy(torch.tensor(dists, dtype=torch.float32))
    want = jhet.label_entropy(jnp.asarray(dists, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_head_bias_updates_stacked_matches_jax():
    each(_head_case, ["bias", "weight"])


def _head_case(head):
    r = np.random.default_rng(2)
    before = {"fc": {"w": r.normal(size=(6, 8)), "b": r.normal(size=8)},
              "lm_head": {"w": r.normal(size=(8, 10)),
                          "b": r.normal(size=10)}}
    after = {k: {kk: r.normal(size=(3,) + v.shape) for kk, v in p.items()}
             for k, p in before.items()}
    if head == "weight":
        del before["lm_head"]["b"], after["lm_head"]["b"]

    def tree(t, conv):
        return {k: {kk: conv(np.asarray(v, np.float32))
                    for kk, v in p.items()} for k, p in t.items()}

    got = head_bias_updates_stacked(tree(before, torch.tensor),
                                    tree(after, torch.tensor))
    want = jhet.head_bias_updates_stacked(tree(before, jnp.asarray),
                                          tree(after, jnp.asarray))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert head_num_classes(tree(before, torch.tensor)) == 10
    assert head_bias_updates_stacked({"fc": {}}, {"fc": {}}) is None


def _sym(n, seed):
    a = np.random.default_rng(seed).uniform(0.1, 3.0, size=(n, n))
    d = (a + a.T).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    return d


def _tied(n, seed):
    """Small integer distances: many exact ties, exact arithmetic."""
    a = np.random.default_rng(seed).integers(1, 4, size=(n, n))
    d = np.triu(a, 1)
    return (d + d.T).astype(np.float32)


def test_agglomerate_labels_identical():
    """Random and tied matrices, ward linkage."""
    each(_agglomerate_case, [_sym, _tied], [(50, 5), (12, 3), (7, 7)])


def _agglomerate_case(make, shape):
    n, m = shape
    d = make(n, seed=n + m)
    for precomputed in (False, True):
        got = agglomerate_device(torch.tensor(d), m,
                                 precomputed=precomputed)
        want = jclust.agglomerate_device(jnp.asarray(d), m, linkage="ward",
                                         precomputed=precomputed)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_cluster_means_matches_jax():
    r = np.random.default_rng(3)
    vals = r.normal(size=20).astype(np.float32)
    labels = np.array([0, 1, 1, 3] * 5, np.int32)        # cluster 2 empty
    got = cluster_means_device(torch.tensor(vals), torch.tensor(labels), 4)
    want = jclust.cluster_means_device(jnp.asarray(vals),
                                       jnp.asarray(labels), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert float(got[2]) == 0.0


def test_anneal_matches_jax():
    for t in (0, 7, 30, 50):
        got = anneal_device(4.0, t, 30.0)
        want = jsamp.anneal_device(4.0, jnp.int32(t), 30.0)
        assert float(got) == float(want), t


def test_coverage_sweep_ids_identical():
    """Same Gumbel draws, same ids — including the ties that the 1e6
    offset's 0.0625 f32 grid makes common."""
    each(_coverage_case, range(6), [(50, 5), (12, 3), (4, 6)])


def _coverage_case(seed, shape):
    n, k = shape
    key = jax.random.PRNGKey(seed)
    seen = np.random.default_rng(seed).random(n) < 0.6
    noise = select_noise(key, n, k, 1)
    got = coverage_sweep_device(noise.cover, torch.tensor(seen), k)
    want = jsamp.coverage_sweep_device(key, jnp.asarray(seen), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hierarchical_sample_ids_identical():
    each(_hierarchical_case, range(6), [(50, 5, 5), (12, 3, 3), (9, 4, 2)])


def _hierarchical_case(seed, shape):
    n, k, m = shape
    r = np.random.default_rng(seed)
    labels = np.concatenate([np.arange(m), r.integers(0, m, n - m)]
                            ).astype(np.int32)
    means = r.uniform(0.0, 2.3, m).astype(np.float32)
    weights = r.uniform(0.0, 1.0, n).astype(np.float32)
    weights[r.integers(n)] = 0.0                          # log floor
    gamma_t = 4.0 * (1 - seed / 6)
    key = jax.random.PRNGKey(100 + seed)
    noise = select_noise(key, n, k, m)
    got = hierarchical_sample_device(
        noise.cluster, noise.client, torch.tensor(labels),
        torch.tensor(means), torch.tensor(weights), k,
        torch.tensor(gamma_t, dtype=torch.float32))
    want = jsamp.hierarchical_sample_device(
        key, jnp.asarray(labels), jnp.asarray(means), jnp.asarray(weights),
        k, jnp.float32(gamma_t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(set(got.tolist())) == k


@pytest.mark.parametrize("incremental", [True, False])
def test_hics_functional_20_rounds_identical(incremental):
    """A 20-round select/update sequence with the same Δb and noise
    picks the same participants in both packages."""
    n, k, c, rounds = 20, 4, 10, 20
    r = np.random.default_rng(4)
    weights = r.integers(5, 50, n).astype(np.float64)
    kw = dict(num_clients=n, num_select=k, total_rounds=rounds,
              weights=weights / weights.sum(), temperature=0.63,
              gamma0=4.0, normalize=True, num_classes=c,
              incremental=incremental)
    jfn = jax_hics(**kw)
    jstate = jfn.init(jax.random.PRNGKey(0))
    jselect, jupdate = jax.jit(jfn.select), jax.jit(jfn.update)
    tfn = hics_functional(**kw, device="cpu")
    tstate = tfn.init()
    key = jax.random.PRNGKey(1)
    for t in range(rounds):
        key, k_sel = jax.random.split(key)
        jids, jstate = jselect(jstate, t, k_sel)
        tids, tstate = tfn.select(tstate, t, select_noise(k_sel, n, k, k))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        db = (r.normal(size=(k, c)) * 0.05).astype(np.float32)
        jstate = jupdate(jstate, t, jids, Observations(
            bias_updates=jnp.asarray(db)))
        tstate = tfn.update(tstate, t, tids, TObservations(
            bias_updates=torch.tensor(db)))
    np.testing.assert_allclose(tfn.entropies(tstate).numpy(),
                               np.asarray(jfn.entropies(jstate)),
                               atol=5e-5)
    if incremental:
        np.testing.assert_allclose(tstate.dist_cache.numpy(),
                                   np.asarray(jstate.dist_cache),
                                   atol=1e-5, rtol=1e-5)
        assert torch.equal(tstate.dist_cache, tstate.dist_cache.T)


def _builds_and_runs(name, fine):
    """Each of ``fine``, the defaults, the ported values (``stale_slots``
    above 1 since the scenarios slice) and names no selector reads,
    builds and runs four select/update rounds (three sweep rounds, then
    a clustered one for HiCS); an incremental selector's ring of staled
    ids holds ``stale_slots``·K ids."""
    kw = dict(num_clients=8, num_select=3, total_rounds=4, device="cpu")
    for opts in fine:
        fn = make_functional(name, **kw, num_classes=10, feat_dim=10,
                             **opts)
        ring = fn.init().stale_ids.shape[0]
        if ring:
            assert ring == 3 * max(1, opts.get("stale_slots", 1)), opts
        _four_rounds(fn)


def _four_rounds(fn):
    gen = torch.Generator().manual_seed(0)
    r = np.random.default_rng(0)
    state = fn.init()
    for t in range(4):
        noise = draw_select_noise(gen, 8, 3, fn.num_clusters)
        ids, state = fn.select(state, t, noise)
        assert len(set(ids.tolist())) == 3
        obs = (r.normal(size=(3, 10)) * 0.05).astype(np.float32)
        state = fn.update(state, t, ids, TObservations(
            bias_updates=torch.tensor(obs), full_updates=torch.tensor(obs),
            losses=torch.rand(8)))


def test_hics_unported_options_raise():
    _builds_and_runs(
        "hics",
        [{"stale_slots": 2}, {"stale_slots": 2, "incremental": False},
         {"stale_slots": 3, "linkage": "average", "num_clusters": 2},
         {"linkage": "average"}, {"linkage": "single", "num_clusters": 8},
         {"linkage": "complete", "num_clusters": 1, "incremental": False},
         {"num_clusters": 2},
         {"linkage": "ward", "num_clusters": 3, "stale_slots": 1,
          "gram_in_bf16": True}, {"num_clusters": None, "stale_slots": 0},
         {"no_such_option": 5}])


def test_cs_unported_options_raise():
    _builds_and_runs("cs", [{"stale_slots": 2},
                            {"stale_slots": 2, "incremental": False},
                            {"stale_slots": 1, "gram_in_bf16": True,
                             "linkage": "average"}])


def test_divfl_unported_options_raise():
    _builds_and_runs("divfl", [{"stale_slots": 3},
                               {"stale_slots": 2, "refresh": "selected"},
                               {"stale_slots": 1, "refresh": "selected"},
                               {"no_such_option": 5}])


def test_unported_local_and_driver_options_raise():
    """The reference's ``LocalSpec``, ``FedConfig`` and
    ``ExperimentSpec`` fields are taken.  Every algorithm × optimizer
    pair builds and runs two rounds; telemetry, still refused, raises
    ``NotImplementedError`` naming its ROADMAP.md item by title, an
    unknown algo or optimizer ``ValueError``, as the reference's."""
    refused = [lambda: FedConfig(telemetry=("selection",)),
               lambda: build(ExperimentSpec(telemetry=["training"]),
                             device="cpu")]
    for make in refused:
        with pytest.raises(NotImplementedError, match="queue 1: telemetry"):
            make()
    for bad in (dict(algo="fedsgd"), dict(optimizer="lamb")):
        with pytest.raises(ValueError, match="must be one of"):
            LocalSpec(**bad)
    spec = LocalSpec(algo="fedavg", optimizer="sgd", lr=0.05, mu=0.3,
                     moon_tau=0.1)
    assert (spec.algo, spec.optimizer, spec.mu, spec.moon_tau) == (
        "fedavg", "sgd", 0.3, 0.1)
    cfg = FedConfig(local=spec, jit_rounds=False, telemetry=())
    assert not cfg.jit_rounds and cfg.telemetry == ()
    assert FedConfig(jit_rounds=True).jit_rounds      # ported
    for algo in ("fedavg", "fedprox", "feddyn", "moon"):
        for optimizer in ("sgd", "momentum", "adam"):
            local = LocalSpec(algo=algo, optimizer=optimizer, lr=0.05,
                              epochs=1, batch_size=16, mu=0.01, moon_tau=0.2)
            hist = build(ExperimentSpec(
                arch="paper-mlp", num_clients=4, num_select=2, rounds=2,
                alphas=(0.5,), local=local, samples_train=80,
                samples_test=20, data=SyntheticSpec(dim=8)),
                device="cpu")[0].run()
            assert len(hist["selected"]) == 2
            assert np.isfinite(hist["train_loss"]).all(), (algo, optimizer)


def test_hics_bf16_run_picks_jax_participants():
    """A 6-round HiCS run with ``selector_kw={"gram_in_bf16": True}``
    through both packages' builders on the CPU: the option is accepted
    and dispatched as in JAX, whose CPU oracle ignores it (f32 on both
    sides), so the participants are JAX's in every round and Ĥ within
    1e-4 relative."""
    sel_kw = dict(temperature=0.63, gamma0=4.0, normalize=True,
                  incremental=True, gram_in_bf16=True)
    common = dict(arch="paper-cnn", num_clients=12, num_select=3, rounds=6,
                  alphas=(0.001, 0.002, 0.005, 0.01, 0.5), selector="hics",
                  selector_kw=sel_kw, samples_train=600, samples_test=100,
                  eval_every=3, seed=0)
    jserver, _ = jax_build(JaxExperimentSpec(
        data=JaxSyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=JaxLocalSpec(algo="fedavg", optimizer="sgd", lr=0.05,
                           epochs=2, batch_size=32), **common))
    tserver, _ = build(ExperimentSpec(
        data=SyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=LocalSpec(lr=0.05, epochs=2, batch_size=32), **common),
        device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    jhist = jserver.run()
    thist = tserver.run(draws=JaxKeyChain(0, 12, 3, 3, 2,
                                          tserver.x.shape[1]))
    assert thist["selected"] == jhist["selected"]
    assert len(thist["selected"]) == 6
    np.testing.assert_allclose(np.asarray(thist["bias_entropy"]),
                               np.asarray(jhist["bias_entropy"]), rtol=1e-4)
