"""The port's selection kernels on the CPU (their plain PyTorch
versions) against the reference's Pallas kernels in interpret mode and
against its ``ref.py`` oracles.

Each test loops over its cases (``torch_parity.each``).

Tolerances: 5e-5 for Ĥ and 1e-5 for norms and distances at T ≥ 0.01;
at T = 0.0025 the reference's own kernel tolerances, 1e-3 for Ĥ and
5e-3 for distances (``tests/test_fused_stats.py:105-110``), because
1/T amplifies f32 rounding.  Distances also get a relative 1e-5: the
λ = 10 entropy term multiplies Ĥ's last-bit rounding (a few ulps of
values near 2.3) into differences just above 1e-5 absolute at
distances near 4.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_stats import fused_stats_pallas
from repro.kernels.gram_update import (cached_selection_step_pallas,
                                       gram_row_update_pallas)
from repro.kernels.pairwise import hics_selection_step_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_stats import fused_stats
from repro_torch.kernels.gram_update import (cached_selection_step,
                                             gram_row_update)
from repro_torch.kernels.pairwise import hics_selection_step
from torch_parity import each

SHAPES = [(5, 10), (17, 769), (50, 1030)]
LAM = 10.0


def _tol(temperature):
    """(Ĥ tol, norm/distance tol) for a temperature."""
    return (5e-5, 1e-5) if temperature >= 0.01 else (1e-3, 5e-3)


def _x(n, c, seed=0):
    return (np.random.default_rng(seed).normal(size=(n, c)) * 0.02
            ).astype(np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def _close_dist(got, want, atol):
    _close(got, want, atol, rtol=1e-5)


def test_fused_stats_plain_vs_pallas_and_ref():
    each(_fused_stats_case, SHAPES, [0.63, 0.0025], [False, True])


def _fused_stats_case(shape, temperature, scaled):
    n, c = shape
    x = _x(n, c)
    scale = (np.random.default_rng(1).uniform(0.5, 2.0, n)
             .astype(np.float32) if scaled else None)
    got = fused_stats(torch.tensor(x), temperature,
                      None if scale is None else torch.tensor(scale))
    js = None if scale is None else jnp.asarray(scale)
    pallas = fused_stats_pallas(jnp.asarray(x), temperature, row_scale=js,
                                interpret=True)
    oracle = jref.fused_stats_ref(jnp.asarray(x), temperature, js)
    h_tol, n_tol = _tol(temperature)
    for want in (pallas, oracle):
        _close(got[0], want[0], h_tol)
        _close(got[1], want[1], n_tol)
        _close(got[2], want[2], n_tol)


def _cache(x, temperature, normalize):
    """A valid cache: every row refreshed from the zero cache."""
    n = x.shape[0]
    return ref.cached_selection_step_ref(
        torch.tensor(x), torch.zeros(n, n), torch.zeros(n, 2),
        torch.arange(n), temperature, LAM, normalize=normalize)


def test_strip_plain_vs_pallas_and_ref():
    each(_strip_case, SHAPES, [0.63, 0.0025])


def _strip_case(shape, temperature):
    n, c = shape
    x = _x(n, c)
    _, _, stats = _cache(x, temperature, False)
    ids = np.array([n - 1, 0, n // 2, 0][: min(4, n)], np.int32)  # dup 0
    got = gram_row_update(torch.tensor(x), stats,
                          torch.tensor(ids, dtype=torch.int64), LAM)
    js = jnp.asarray(stats.numpy())
    pallas = gram_row_update_pallas(jnp.asarray(x), js, jnp.asarray(ids),
                                    lam=LAM, interpret=True)
    oracle = jref.distance_strip_ref(jnp.asarray(x), js, jnp.asarray(ids),
                                     LAM)
    _, d_tol = _tol(temperature)
    _close_dist(got, pallas, d_tol)
    _close_dist(got, oracle, d_tol)
    # the strip zeroes the true diagonal
    assert all(float(got[u, i]) == 0.0 for u, i in enumerate(ids))


def test_cached_step_plain_vs_pallas():
    """Refreshed rows, duplicate ids and K = 0, with and without the
    RMS-normalized estimator."""
    each(_cached_step_case, SHAPES,
          [(0.63, True), (0.63, False), (0.0025, False)],
          ["some", "dups", "none"])


def _cached_step_case(shape, t_norm, ids):
    (n, c), (temperature, normalize) = shape, t_norm
    x = _x(n, c)
    x_old = _x(n, c, seed=7)
    _, dist0, stats0 = _cache(x_old, temperature, normalize)
    sel = {"some": [1, n - 1, n // 3], "dups": [2, 2, 0, n - 1],
           "none": []}[ids]
    ids_np = np.array(sel, np.int32)
    # rows not in ids keep their old Δb, so the cache stays valid
    x_new = x_old.copy()
    x_new[ids_np] = x[ids_np]
    ent, dist, stats = cached_selection_step(
        torch.tensor(x_new), dist0, stats0,
        torch.tensor(ids_np, dtype=torch.int64), temperature, LAM,
        normalize=normalize)
    args = (jnp.asarray(x_new), jnp.asarray(dist0.numpy()),
            jnp.asarray(stats0.numpy()), jnp.asarray(ids_np), temperature)
    p_ent, p_dist, p_stats = cached_selection_step_pallas(
        *args, lam=LAM, normalize=normalize, interpret=True)
    o_ent, o_dist, o_stats = jref.cached_selection_step_ref(
        *args, LAM, normalize=normalize)
    h_tol, d_tol = _tol(temperature)
    for w_ent, w_dist, w_stats in ((p_ent, p_dist, p_stats),
                                   (o_ent, o_dist, o_stats)):
        _close(ent, w_ent, h_tol)
        _close(stats[:, 0], np.asarray(w_stats)[:, 0], 1e-5)
        _close_dist(dist, w_dist, d_tol)
    # an exactly symmetric cache with a zero diagonal
    d = dist.numpy()
    assert np.array_equal(d, d.T)
    assert np.all(np.diag(d) == 0.0)
    if not sel:
        assert torch.equal(dist, dist0) and torch.equal(stats, stats0)


def test_selection_step_plain_vs_pallas():
    each(_selection_step_case, SHAPES, [0.63, 0.0025], [True, False])


def _selection_step_case(shape, temperature, normalize):
    n, c = shape
    x = _x(n, c)
    ent, dist = hics_selection_step(torch.tensor(x), temperature, LAM,
                                    normalize=normalize)
    p_ent, p_dist = hics_selection_step_pallas(
        jnp.asarray(x), temperature, lam=LAM, normalize=normalize,
        interpret=True)
    o_ent, o_dist = jref.selection_step_ref(jnp.asarray(x), temperature,
                                            LAM, normalize=normalize)
    h_tol, d_tol = _tol(temperature)
    for w_ent, w_dist in ((p_ent, p_dist), (o_ent, o_dist)):
        _close(ent, w_ent, h_tol)
        _close_dist(dist, w_dist, d_tol)
    assert np.all(np.diag(dist.numpy()) == 0.0)


def test_cache_refreshed_everywhere_equals_from_scratch():
    """Refreshing every row of a zero cache reproduces the pairwise
    matrix: the incremental and from-scratch plain paths agree."""
    x = _x(50, 10)
    ent_c, dist_c, _ = _cache(x, 0.63, True)
    ent_s, dist_s = hics_selection_step(torch.tensor(x), 0.63, LAM,
                                        normalize=True)
    _close(ent_c, ent_s, 1e-6)
    _close_dist(dist_c, dist_s, 1e-5)


def test_ops_cpu_dispatch_runs_plain_versions():
    x = torch.tensor(_x(12, 40))
    h, nrm, rms = ops.fused_row_stats(x, 0.63, device="cpu")
    want = ref.fused_stats_ref(x, 0.63)
    for a, b in zip((h, nrm, rms), want):
        assert torch.equal(a, b)
    dist = ops.pairwise_distances(x, 0.63, LAM, device="cpu")
    assert torch.equal(dist, ref.selection_step_ref(x, 0.63, LAM)[1])
    with pytest.raises(ValueError):
        ops.fused_row_stats(x, 0.63, device="meta")
