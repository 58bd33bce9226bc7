"""The rest of the selector layer against the JAX reference: every
linkage and cluster count of the device clustering, the host-side
helpers (``agglomerate``, ``cluster_means``, ``silhouette_hint``, the
four sampling helpers, ``distance_matrix``), the estimator's theory
half, and 6-round HiCS runs with each linkage at M ≠ K.

Inputs come from seeded numpy.  Cluster labels and sampled ids must be
identical; the host helpers within 1e-5, the theory functions within
1e-6.  Tied matrices are where a wrong rounding of a Lance–Williams
update shows: ward and average linkage round as the reference's fused
multiply-adds (at the seeds of ``_few_values`` an unfused average
update clusters otherwise), complete and single are exact.
Each test loops over its cases (``torch_parity.each``).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import clustering as jclust
from repro.core import distance as jdist
from repro.core import hetero as jhet
from repro.core import sampling as jsamp
from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro_torch import core
from repro_torch.core import hics_functional
from repro_torch.data import SyntheticSpec
from repro_torch.fed import ExperimentSpec, LocalSpec, build
from repro_torch.models import params_from_jax
from torch_parity import JaxKeyChain, each, to_np

LINKAGES = ["ward", "average", "complete", "single"]
N, K = 12, 5


def _sym(n, seed):
    a = np.random.default_rng(seed).uniform(0.1, 3.0, size=(n, n))
    d = np.triu(a, 1)
    return (d + d.T).astype(np.float32)


def _tied(n, seed):
    """Small integer distances: many exact ties."""
    a = np.random.default_rng(seed).integers(1, 4, size=(n, n))
    d = np.triu(a, 1)
    return (d + d.T).astype(np.float32)


#: the reference's device clustering, compiled once per static argument
#: set (eager, its loop would be traced again at every call)
_jax_agglomerate = jax.jit(jclust.agglomerate_device,
                           static_argnames=("num_clusters", "linkage",
                                            "precomputed"))


def test_agglomerate_device_every_linkage_and_m():
    def case(linkage, make, m, seed):
        d = make(N, seed)
        # the symmetrizing sweep, a no-op on these matrices, at M = K only
        for precomputed in ((False, True) if m == K else (True,)):
            got = core.agglomerate_device(torch.tensor(d), m, linkage,
                                          precomputed=precomputed)
            want = _jax_agglomerate(jnp.asarray(d), num_clusters=m,
                                    linkage=linkage,
                                    precomputed=precomputed)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        assert int(got.max()) + 1 == m

    each(case, LINKAGES, [_sym, _tied], [1, 3, K, N - 1], [0, 1, 2])


def _few_values(seed):
    """(d, M): a matrix of two or three distinct random floats, tied and
    with inexact products, so that the updates' rounding decides merges
    (complete and single linkage round nothing).
    At these seeds average linkage with the update rounded unfused
    (ni·di + nj·dj in two roundings) clusters otherwise than the
    reference, whose compiled update is fma(ni, di, nj·dj)."""
    r = np.random.default_rng(seed)
    n = int(r.integers(6, 16))
    m = int(r.integers(1, n))
    vals = r.uniform(0.1, 3.0, size=int(r.integers(2, 4))).astype(np.float32)
    d = np.triu(vals[r.integers(0, len(vals), size=(n, n))], 1)
    return (d + d.T).astype(np.float32), m


def test_agglomerate_device_rounds_as_the_reference():
    def case(linkage, seed):
        d, m = _few_values(seed)
        got = core.agglomerate_device(torch.tensor(d), m, linkage,
                                      precomputed=True)
        want = _jax_agglomerate(jnp.asarray(d), num_clusters=m,
                                linkage=linkage, precomputed=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    each(case, ["ward", "average"], [347, 928, 1786])


def test_agglomerate_device_finite_on_a_zero_matrix():
    """The scanned driver's discarded branch clusters the sweep rounds'
    zero cache: every linkage stays in range there."""
    def case(linkage, m):
        labels = core.agglomerate_device(torch.zeros(N, N), m, linkage,
                                         precomputed=True)
        want = _jax_agglomerate(jnp.zeros((N, N)), num_clusters=m,
                                linkage=linkage, precomputed=True)
        np.testing.assert_array_equal(labels.numpy(), np.asarray(want))

    each(case, LINKAGES, [1, K, N - 1])


def test_unknown_linkage_raises():
    for make in (lambda: core.agglomerate_device(torch.zeros(3, 3), 2,
                                                 "median"),
                 lambda: core.agglomerate(np.zeros((3, 3)), 2, "median"),
                 lambda: hics_functional(8, 3, 4, linkage="median",
                                         device="cpu")):
        with pytest.raises(ValueError, match="linkage must be one of"):
            make()


def test_host_agglomerate_matches_reference():
    def case(linkage, make, m, seed):
        d = make(N, seed).astype(np.float64)
        for precomputed in (False, True):
            got = core.agglomerate(d, m, linkage, precomputed=precomputed)
            want = jclust.agglomerate(d, m, linkage, precomputed=precomputed)
            np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int64

    each(case, LINKAGES, [_sym, _tied], [1, 3, K, N - 1], [0, 3])
    with pytest.raises(ValueError, match="square"):
        core.agglomerate(np.zeros((3, 4)), 2)


def test_cluster_means_and_silhouette_match_reference():
    r = np.random.default_rng(4)
    d = _sym(N, 5).astype(np.float64)
    vals = r.normal(size=N)
    for m in (1, 3, K):
        labels = jclust.agglomerate(d, m)
        np.testing.assert_allclose(core.cluster_means(vals, labels, m + 1),
                                   jclust.cluster_means(vals, labels, m + 1),
                                   atol=1e-5)
        assert core.silhouette_hint(d, labels) == pytest.approx(
            jclust.silhouette_hint(d, labels), abs=1e-5)
    assert core.silhouette_hint(d, np.zeros(N, np.int64)) == 0.0


def test_sampling_helpers_match_reference():
    r = np.random.default_rng(6)
    labels = np.array([0, 1, 1, 2, 0, 2, 2, 1, 0, 3, 3, 1])
    ent = r.uniform(0.0, 2.3, size=4)
    w = r.uniform(0.5, 2.0, size=N)
    w[9] = 0.0
    for t in (0, 3, 9, 12):
        assert core.anneal(4.0, t, 10) == jsamp.anneal(4.0, t, 10)
        g = jsamp.anneal(4.0, t, 10)
        np.testing.assert_allclose(core.cluster_probs(ent, g),
                                   jsamp.cluster_probs(ent, g), atol=1e-5)
        np.testing.assert_allclose(
            core.sampling_probabilities(labels, ent, w, g),
            jsamp.sampling_probabilities(labels, ent, w, g), atol=1e-5)
        for k in (1, K, N):
            got = core.hierarchical_sample(np.random.default_rng(t), labels,
                                           ent, w, k, g)
            want = jsamp.hierarchical_sample(np.random.default_rng(t),
                                             labels, ent, w, k, g)
            assert got == want
            assert len(set(got)) == k
    zero = np.zeros(N)
    np.testing.assert_allclose(
        core.sampling_probabilities(labels, ent, zero, 1.0),
        jsamp.sampling_probabilities(labels, ent, zero, 1.0), atol=1e-5)


def test_distance_matrix_matches_reference():
    db = (np.random.default_rng(7).normal(size=(N, 10)) * 0.05
          ).astype(np.float32)
    db[3] = 0.0                                  # a zero row
    t = torch.tensor(db)
    np.testing.assert_allclose(core.pairwise_arccos(t).numpy(),
                               np.asarray(jdist.pairwise_arccos(
                                   jnp.asarray(db))), atol=1e-5)
    for ent in (None, np.linspace(0.0, 2.0, N).astype(np.float32)):
        got = core.distance_matrix(
            t, 0.63, 10.0, None if ent is None else torch.tensor(ent))
        want = jdist.distance_matrix(
            jnp.asarray(db), 0.63, 10.0,
            None if ent is None else jnp.asarray(ent))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert float(got.diagonal().abs().max()) == 0.0


def test_theory_functions_match_reference():
    r = np.random.default_rng(8)
    dist = r.dirichlet(np.full(10, 0.3), size=4).astype(np.float32)
    e_vec = r.uniform(0.0, 1.0, size=10).astype(np.float32)
    np.testing.assert_allclose(
        core.expected_bias_update(torch.tensor(dist), torch.tensor(e_vec),
                                  0.05, 2).numpy(),
        np.asarray(jhet.expected_bias_update(jnp.asarray(dist),
                                             jnp.asarray(e_vec), 0.05, 2)),
        atol=1e-6)
    dw = r.normal(size=(16, 10)).astype(np.float32) * 0.01
    for axis in (-1, 1, 0):
        np.testing.assert_allclose(
            core.delta_b_from_head_delta(torch.tensor(dw), axis).numpy(),
            np.asarray(jhet.delta_b_from_head_delta(jnp.asarray(dw), axis)),
            atol=1e-6)
    with pytest.raises(ValueError, match="2-D"):
        core.delta_b_from_head_delta(torch.zeros(2, 3, 4))
    before = {"body": {"w": r.normal(size=(4, 16))},
              "lm_head": {"w": r.normal(size=(16, 10)),
                          "b": r.normal(size=10)}}
    after = {k: {kk: v + r.normal(size=v.shape) * 0.01
                 for kk, v in p.items()} for k, p in before.items()}
    no_bias = [{k: ({kk: v for kk, v in p.items() if kk != "b"}
                    if k == "lm_head" else p) for k, p in tree.items()}
               for tree in (before, after)]
    headless = [{"body": tree["body"]} for tree in (before, after)]
    for b, a in ((before, after), no_bias, headless):
        got = core.head_bias_update(_tensors(b), _tensors(a))
        want = jhet.head_bias_update(_f32(b), _f32(a))
        if want is None:
            assert got is None
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    h = np.linspace(0.0, np.log(10), 7)
    np.testing.assert_allclose(
        core.dissimilarity_envelope(h, 2.0, 0.5, 1.5),
        jhet.dissimilarity_envelope(h, 2.0, 0.5, 1.5), atol=1e-6)
    np.testing.assert_allclose(
        core.dissimilarity_envelope(h, 2.0, 0.5, 1.5, h0=1.0,
                                    num_classes=4),
        jhet.dissimilarity_envelope(h, 2.0, 0.5, 1.5, h0=1.0,
                                    num_classes=4), atol=1e-6)
    args = (dist[0].astype(np.float64), np.full(10, 0.1), 3.0, 0.01, 0.05,
            2, 0.63)
    assert core.entropy_separation_bound(*args) == pytest.approx(
        jhet.entropy_separation_bound(*args), abs=1e-6)


def _tensors(tree):
    return {k: {kk: torch.tensor(v, dtype=torch.float32)
                for kk, v in p.items()} for k, p in tree.items()}


def _f32(tree):
    return {k: {kk: jnp.asarray(v, jnp.float32) for kk, v in p.items()}
            for k, p in tree.items()}


def test_core_exports_the_reference_names():
    for name in ("distance_matrix", "pairwise_arccos", "agglomerate",
                 "cluster_means", "silhouette_hint", "anneal",
                 "cluster_probs", "hierarchical_sample",
                 "sampling_probabilities", "expected_bias_update",
                 "delta_b_from_head_delta", "head_bias_update",
                 "dissimilarity_envelope", "entropy_separation_bound"):
        assert name in core.__all__ and callable(getattr(core, name)), name


#: the HiCS runs' spec: 8 clients, K = 3, so rounds 3-5 cluster
RUN = dict(arch="paper-mlp", num_clients=8, num_select=3, rounds=6,
           alphas=(0.05, 5.0), selector="hics", samples_train=400,
           samples_test=80, eval_every=3, seed=0)
#: M for each linkage's run, none of them K
LINKAGE_M = {"ward": 4, "average": 2, "complete": 5, "single": 8}


def test_hics_linkage_runs_pick_jax_participants():
    def case(linkage):
        m = LINKAGE_M[linkage]
        kw = dict(temperature=0.63, gamma0=4.0, normalize=True,
                  linkage=linkage, num_clusters=m)
        jserver, _ = jax_build(JaxExperimentSpec(
            data=JaxSyntheticSpec(), selector_kw=kw,
            local=JaxLocalSpec(lr=0.1, epochs=2, batch_size=32), **RUN))
        tserver, _ = build(ExperimentSpec(
            data=SyntheticSpec(), selector_kw=kw,
            local=LocalSpec(lr=0.1, epochs=2, batch_size=32), **RUN),
            device="cpu")
        tserver.params = params_from_jax(to_np(jserver.params), "cpu")
        assert tserver.selector.num_clusters == m
        thist = tserver.run(draws=JaxKeyChain(0, 8, 3, m, 2,
                                              tserver.x.shape[1]))
        jhist = jserver.run()
        assert thist["selected"] == jhist["selected"]
        assert len(thist["selected"]) == 6
        np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                                   rtol=1e-4)

    each(case, LINKAGES)
