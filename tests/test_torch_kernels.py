"""The port's kernels on the CPU (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode and against
its ``ref.py`` oracles.

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
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.fused_stats import fused_stats_pallas
from repro.kernels.gram_update import (cached_feature_step_pallas,
                                       cached_selection_step_pallas,
                                       gram_row_update_pallas)
from repro.kernels.hetero_entropy import entropy_pallas
from repro.kernels.pairwise import (hics_selection_step_pallas,
                                    pairwise_distance_pallas)
from repro_torch.kernels import gram_update as gu
from repro_torch.kernels import ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels.decode_attention import (decode_splits,
                                                  resident_blocks)
from repro_torch.kernels.fused_stats import fused_stats, stats_splits
from repro_torch.kernels.gram_update import (cached_feature_step,
                                             cached_selection_step,
                                             gram_row_update)
from repro_torch.kernels import pairwise as pw
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
    assert torch.equal(ops.estimate_entropies(x, 0.63, device="cpu"),
                       ref.entropy_ref(x, 0.63))
    q, kv = torch.tensor(_x(2, 32)).reshape(2, 2, 16), \
        torch.tensor(_x(2, 64)).reshape(2, 2, 2, 16)
    assert torch.equal(ops.gqa_decode_attention(q, kv, kv, 2, device="cpu"),
                       ref.decode_attention_ref(q, kv, kv, 2))
    with pytest.raises(ValueError):
        ops.fused_row_stats(x, 0.63, device="meta")


# ---------------------------------------------------------------------------
# the strip's cosine and l2 epilogues and the full-update cache step
# (Clustered Sampling, DivFL), at the tolerances of the reference's own
# tests (tests/test_full_update_selectors.py:66-200): 1e-5 against the
# lax oracles and a from-scratch build, 1e-4 against Pallas
# ---------------------------------------------------------------------------

FEATURE_SHAPES = [(5, 10), (17, 769), (20, 260), (50, 1030)]


def _scratch(x: torch.Tensor, metric: str) -> torch.Tensor:
    """The dense from-scratch distance with a zero diagonal."""
    n = x.shape[0]
    if metric == "cosine":
        unit = x / torch.clamp(torch.linalg.vector_norm(
            x, dim=-1, keepdim=True), min=1e-8)
        d = torch.arccos(torch.clamp(unit @ unit.T, ref.COS_LO, ref.COS_HI))
    else:
        sq = (x * x).sum(dim=1)
        d = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :]
                                   - 2.0 * (x @ x.T), min=0.0))
    return torch.where(torch.eye(n, dtype=torch.bool), 0.0, d)


def test_feature_strip_plain_vs_pallas_and_ref():
    """cosine and l2 strips; the entropy lane holds values the two
    epilogues must not read."""
    each(_feature_strip_case, FEATURE_SHAPES, ["cosine", "l2"])


def _feature_strip_case(shape, epilogue):
    n, c = shape
    x = _x(n, c, seed=3) * 2.5
    rng = np.random.default_rng(n)
    stats = np.stack([np.linalg.norm(x.astype(np.float64), axis=-1),
                      rng.uniform(0.0, 2.3, n)], -1).astype(np.float32)
    ids = np.array([n - 1, 0, n // 2, 0][: min(4, n)], np.int32)  # dup 0
    got = gram_row_update(torch.tensor(x), torch.tensor(stats),
                          torch.tensor(ids, dtype=torch.int64), 0.0,
                          epilogue=epilogue)
    args = (jnp.asarray(x), jnp.asarray(stats), jnp.asarray(ids))
    pallas = gram_row_update_pallas(*args, lam=0.0, epilogue=epilogue,
                                    interpret=True)
    oracle = jref.distance_strip_ref(*args, 0.0, epilogue=epilogue)
    _close(got, pallas, 1e-4, rtol=1e-4)
    _close(got, oracle, 1e-5, rtol=1e-5)
    assert all(float(got[u, i]) == 0.0 for u, i in enumerate(ids))
    # the entropy lane is not read: another one changes nothing
    stats2 = torch.tensor(stats).clone()
    stats2[:, 1] = -7.0
    assert torch.equal(got, gram_row_update(
        torch.tensor(x), stats2, torch.tensor(ids, dtype=torch.int64), 0.0,
        epilogue=epilogue))


def test_cached_feature_step_plain_vs_pallas():
    """Two successive refreshes of some, duplicate and no rows: the
    plain step against Pallas and the lax oracle, exactly symmetric
    with a zero diagonal, and equal to a from-scratch build."""
    each(_cached_feature_case, FEATURE_SHAPES, ["cosine", "l2"],
         ["some", "dups", "none"])


def _cached_feature_case(shape, metric, which):
    n, c = shape
    rng = np.random.default_rng(n + c)
    x = (rng.normal(size=(n, c)) * 0.05).astype(np.float32)
    tx = torch.tensor(x)
    dist, stats = cached_feature_step(tx, torch.zeros(n, n),
                                      torch.zeros(n, 2), torch.arange(n),
                                      metric=metric)
    jdist, jstats = cached_feature_step_pallas(
        jnp.asarray(x), jnp.zeros((n, n)), jnp.zeros((n, 2)),
        jnp.arange(n, dtype=jnp.int32), metric=metric, interpret=True)
    odist, ostats = jnp.asarray(dist.numpy()), jnp.asarray(stats.numpy())
    for step in range(2):
        sel = {"some": [1, n - 1, n // 3], "dups": [2, 2, 0, n - 1],
               "none": []}[which]
        ids = np.array(sel, np.int32)
        x = x.copy()
        x[ids] = (rng.normal(size=(len(ids), c)) * 0.05).astype(np.float32)
        tx, tids = torch.tensor(x), torch.tensor(ids, dtype=torch.int64)
        before = (dist, stats)
        dist, stats = cached_feature_step(tx, dist, stats, tids,
                                          metric=metric)
        jdist, jstats = cached_feature_step_pallas(
            jnp.asarray(x), jdist, jstats, jnp.asarray(ids), metric=metric,
            interpret=True)
        odist, ostats = jref.cached_feature_step_ref(
            jnp.asarray(x), odist, ostats, jnp.asarray(ids), metric=metric)
        if not sel:
            assert torch.equal(dist, before[0])
            assert torch.equal(stats, before[1])
    _close(dist, jdist, 1e-4, rtol=1e-4)
    _close(dist, odist, 1e-5, rtol=1e-5)
    _close(stats, jstats, 1e-5, rtol=1e-5)
    _close(stats[:, 0], torch.linalg.vector_norm(tx, dim=-1), 1e-5)
    assert torch.all(stats[:, 1] == 0.0)
    _close(dist, _scratch(tx, metric), 1e-5)
    d = dist.numpy()
    assert np.array_equal(d, d.T)
    assert np.all(np.diag(d) == 0.0)


def test_scatter_strip_symmetric_averages_the_block():
    """An asymmetric K×K block is replaced by its transpose average;
    rows and columns outside it carry the strip and its transpose."""
    n = 7
    dist = torch.zeros(n, n)
    strip = torch.tensor(_x(3, n, seed=9))
    ids = torch.tensor([4, 1, 6])
    out = ref.scatter_strip_symmetric(dist, strip, ids)
    assert torch.equal(out, out.T)
    kk = strip[:, ids]
    assert torch.equal(out[ids[:, None], ids[None, :]], 0.5 * (kk + kk.T))
    others = torch.tensor([0, 2, 3, 5])
    assert torch.equal(out[ids][:, others], strip[:, others])
    want = jref._scatter_strip_symmetric(
        jnp.zeros((n, n)), jnp.asarray(strip.numpy()),
        jnp.asarray(ids.numpy()))
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_feature_ops_cpu_dispatch_runs_plain_versions():
    x = torch.tensor(_x(12, 40))
    stats = torch.stack([torch.linalg.vector_norm(x, dim=-1),
                         torch.zeros(12)], -1)
    ids = torch.tensor([3, 0, 11])
    for epi in ("arccos", "cosine", "l2"):
        got = ops.gram_row_update(x, stats, ids, 10.0, epilogue=epi,
                                  device="cpu")
        assert torch.equal(got, ref.distance_strip_ref(x, stats, ids, 10.0,
                                                       epilogue=epi))
    dist = torch.zeros(12, 12)
    for metric in ("cosine", "l2"):
        got = ops.cached_feature_step(x, dist, stats, ids, metric,
                                      device="cpu")
        want = ref.cached_feature_step_ref(x, dist, stats, ids, metric)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="metric"):
        ops.cached_feature_step(x, dist, stats, ids, "arccos", device="cpu")
    with pytest.raises(ValueError, match="epilogue"):
        ops.gram_row_update(x, stats, ids, epilogue="dot", device="cpu")


# ---------------------------------------------------------------------------
# hetero_entropy and decode_attention: plain versions vs the Pallas
# kernels in interpret mode, at the shapes and tolerances of the
# reference's own kernel tests (tests/test_kernels.py:23-56, 89-122)
# ---------------------------------------------------------------------------


def _to_jax(x: np.ndarray, dtype):
    """The same values on both sides: (jax array, torch tensor)."""
    j = jnp.asarray(x, dtype)
    t = torch.tensor(np.asarray(j.astype(jnp.float32)))
    return j, (t.bfloat16() if dtype == jnp.bfloat16 else t)


def test_entropy_plain_vs_pallas():
    """T = 0.0025: 5e-5 for f32 and 5e-3 for bf16, absolute and
    relative."""
    each(_entropy_case, [(1, 4), (5, 10), (50, 1000), (17, 769), (8, 4096),
                         (3, 151_936 // 64)], [jnp.float32, jnp.bfloat16])


def _entropy_case(shape, dtype):
    jx, tx = _to_jax(np.random.default_rng(sum(shape)).normal(size=shape)
                     * 0.02, dtype)
    got = ops.estimate_entropies(tx, 0.0025, device="cpu")
    want = entropy_pallas(jx, 0.0025, interpret=True)
    tol = 5e-5 if dtype == jnp.float32 else 5e-3
    assert got.dtype == torch.float32 and got.shape == (shape[0],)
    _close(got, want, tol, rtol=tol)
    _close(got, jref.entropy_ref(jx, 0.0025), tol, rtol=tol)


def test_entropy_plain_extreme_magnitudes():
    """Inputs of magnitude 500 at T = 0.0025 stay finite and within
    0.05 (f32 rounding of (u - m) at |u| ~ 2e5)."""
    x = np.random.default_rng(0).normal(size=(4, 600)) * 500.0
    jx, tx = _to_jax(x, jnp.float32)
    got = ops.estimate_entropies(tx, 0.0025, device="cpu")
    assert torch.isfinite(got).all()
    _close(got, entropy_pallas(jx, 0.0025, interpret=True), 0.05)


def test_decode_attention_plain_vs_pallas():
    """5e-5 for f32 and 3e-2 for bf16 K/V (and q), absolute and
    relative; the Pallas kernel with 128-position blocks.  dh 112 is
    zamba2's shared attention (MHA, G 1), a row that is not a multiple
    of 32."""
    each(_decode_case, [(2, 8, 2, 64, 256), (1, 16, 8, 128, 512),
                        (2, 4, 4, 256, 128), (3, 2, 1, 64, 96),
                        (2, 4, 4, 112, 128)],
         [jnp.float32, jnp.bfloat16])


def _decode_case(shape, dtype):
    b, h, kv, dh, s = shape
    rng = np.random.default_rng(s + dh)
    jq, tq = _to_jax(rng.normal(size=(b, h, dh)), dtype)
    jk, tk = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    jv, tv = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    got = ops.gqa_decode_attention(tq, tk, tv, s, device="cpu")
    want = decode_attention_pallas(jq, jk, jv, s, block_s=128,
                                   interpret=True)
    tol = 5e-5 if dtype == jnp.float32 else 3e-2
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    _close(got, want, tol, rtol=tol)
    _close(got, jref.decode_attention_ref(jq, jk, jv, s), tol, rtol=tol)


def test_decode_attention_plain_ragged_lengths():
    """Per-request lengths [1, 320, 130] within 1e-4; a length-1 row
    equals v[:, 0] of its KV head."""
    b, h, kv, dh, s = 3, 8, 4, 64, 320
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    lens = np.array([1, 320, 130])
    got = ops.gqa_decode_attention(torch.tensor(q), torch.tensor(k),
                                   torch.tensor(v), torch.tensor(lens),
                                   device="cpu")
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), lens, block_s=64,
                                   interpret=True)
    _close(got, want, 1e-4)
    first = np.broadcast_to(v[0, 0][:, None, :], (kv, h // kv, dh))
    _close(got[0].reshape(kv, h // kv, dh), first, 1e-4)


def test_decode_splits_cover_every_tile_once():
    """The split plan: 1 <= P <= the 32-position tiles, the splits'
    ranges tile [0, S) in order with whole tiles, and P > 1 at the serve
    shape (B 4, S 512) and at decode_32k (B 128, S 32,768), with the
    default residency and with the kernel's own (3 blocks an SM of bf16
    at G 8 and dh 128, 2 of f32)."""
    assert resident_blocks(8, 128, 2) == 3
    assert resident_blocks(8, 128, 4) == 2
    for b, kv, s in [(4, 2, 512), (128, 2, 32_768), (3, 2, 96), (1, 1, 31),
                     (1, 1, 32), (2, 8, 100), (64, 8, 4096),
                     (1, 2, 1_000_000), (1024, 8, 64)]:
        tiles = -(-s // ref.DECODE_TILE)
        for resident in (1, 2, 3):
            p = decode_splits(b, kv, s, resident=resident)
            assert 1 <= p <= tiles, (b, kv, s, resident, p)
            ranges = ref.decode_split_ranges(s, p)
            assert len(ranges) == p and ranges[0][0] == 0
            assert ranges[-1][1] == s
            assert all(a[1] == c[0] for a, c in zip(ranges, ranges[1:]))
            assert all(lo < hi and lo % ref.DECODE_TILE == 0
                       for lo, hi in ranges)
    for resident in (2, 3):
        assert decode_splits(4, 2, 512, resident=resident) > 1
        assert decode_splits(128, 2, 32_768, resident=resident) > 1
    assert decode_splits(4, 2, 512) == 8
    with pytest.raises(ValueError, match="splits"):
        ref.decode_split_ranges(512, 17)


def test_decode_split_plain_vs_pallas():
    """The split plain version at G in {1, 2, 8}, dh in {64, 128, 256}
    and at zamba2's dh 112 with G 1 and 8, f32 and bf16 K/V with an f32
    q, P in {1, 2, 3, 8}: within 5e-5 absolute and relative of the
    Pallas kernel in interpret mode and of the unsplit plain version
    (both sides read the same K/V values in f32; only the order of the
    sums differs)."""
    each(_split_case,
         [(g, dh) for g in (1, 2, 8) for dh in (64, 128, 256)]
         + [(1, 112), (8, 112)], [jnp.float32, jnp.bfloat16])


def _split_case(g_dh, dtype):
    g, dh = g_dh
    b, kv, s = 2, 2, 256
    rng = np.random.default_rng(g * dh)
    q = rng.normal(size=(b, kv * g, dh)).astype(np.float32)
    jk, tk = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    jv, tv = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    lens = np.array([s, 171])
    want = decode_attention_pallas(jnp.asarray(q), jk, jv, lens,
                                   block_s=64, interpret=True)
    tq, tl = torch.tensor(q), torch.tensor(lens)
    unsplit = ref.decode_attention_ref(tq, tk, tv, tl)
    for splits in (1, 2, 3, 8):
        got = ref.decode_attention_split_ref(tq, tk, tv, tl, splits)
        assert got.dtype == torch.float32 and got.shape == (b, kv * g, dh)
        _close(got, want, 5e-5, rtol=5e-5)
        _close(got, unsplit, 5e-5, rtol=5e-5)


def test_decode_plan_takes_every_group_and_width():
    """The chunk plan: the registered configs keep one chunk, their
    compile-time width and 3 stages; every G in 1..40 and every dh that
    is a multiple of 8 up to 512 gets chunks of gc heads that cover G
    with fewer than GP·E <= 32 register values a lane and shared memory
    within the limit, f32 and bf16; G 16 at dh 128 is two chunks of 8,
    G 24 at dh 64 two of 12; a dh off the 16-byte rows (4, 36, 100,
    260, and odd ones) gets a plan whose ring rows are padded to 8
    values and copied 4 bytes at a time (f32) or 2 (bf16);
    a dh past 512 or below 1 is refused with the reason."""
    for g, dh in [(8, 128), (7, 128), (6, 128), (4, 128), (1, 256),
                  (1, 112), (2, 64), (16, 64)]:
        for elt in (2, 4):
            plan = da.decode_plan(g, dh, elt)
            assert (plan.chunks, plan.gc, plan.stages, plan.fixed) == (
                1, g, 3, True), (g, dh, plan)
            assert plan.gp == da.group_pad(g)
    for g in range(1, 41):
        for dh in range(8, 513, 8):
            for elt in (2, 4):
                plan = da.decode_plan(g, dh, elt)
                assert plan.gc * plan.chunks >= g > plan.gc * (
                    plan.chunks - 1)
                assert plan.gp == da.group_pad(plan.gc) <= 16
                assert plan.gp * plan.e <= 32 and 32 * plan.e >= dh
                assert dh % plan.e == 0 or plan.e == 16
                assert da.smem_bytes(g, dh, elt) <= da.SMEM_LIMIT
                assert plan.fixed == (dh in da.HEAD_DIMS)
    assert (da.decode_plan(16, 128, 4).chunks,
            da.decode_plan(16, 128, 4).gc) == (2, 8)
    assert (da.decode_plan(24, 64, 2).chunks,
            da.decode_plan(24, 64, 2).gc) == (2, 12)
    assert da.decode_plan(1, 512, 4).stages == 1
    assert da.decode_plan(1, 320, 4).stages == 2
    assert da.decode_plan(1, 512, 2).stages == 3
    for dh in (4, 36, 100, 260, 1, 37, 511):
        for g in (1, 8):
            for elt in (2, 4):
                plan = da.decode_plan(g, dh, elt)
                assert not plan.fixed and 32 * plan.e >= dh
                assert plan.gp * plan.e <= 32
                assert plan.copy_bytes == (4 if elt == 4 else 2)
                assert da.ring_row(dh) % 8 == 0
                assert 0 < da.ring_row(dh) - dh < 8
                assert da.smem_bytes(g, dh, elt) <= da.SMEM_LIMIT
    assert da.decode_plan(2, 128, 4).copy_bytes == 16
    for dh in (520, 0):
        with pytest.raises(ValueError, match="from 1 to 512"):
            da.decode_plan(2, dh, 4)


def test_decode_chunked_split_plain_vs_pallas():
    """The plain version of the chunked split at the plan's gc, at dh
    80, 96, 192 and 512 (G 4), G 16 at dh 128 and G 24 at dh 64, f32
    and bf16 K/V with an f32 q, P in {1, 3}: within 5e-5 absolute and
    relative of the Pallas kernel in interpret mode (only the order of
    the sums differs), a length-0 row exactly 0."""
    each(_chunked_case, [(4, 80), (4, 96), (4, 192), (4, 512), (16, 128),
                         (24, 64)], [jnp.float32, jnp.bfloat16])


def test_decode_any_dh_split_plain_vs_pallas():
    """A dh off the 16-byte rows, as the TPU kernel takes: the plain
    version of the split at the plan's gc, dh 4, 36, 100 and 260 at G 1
    and 8, f32 and bf16 K/V, within 5e-5 of the Pallas kernel in
    interpret mode, a length-0 row exactly 0."""
    each(_chunked_case, [(g, dh) for dh in (4, 36, 100, 260)
                         for g in (1, 8)], [jnp.float32, jnp.bfloat16])


def _chunked_case(g_dh, dtype):
    g, dh = g_dh
    b, kv, s = 3, 2, 96
    rng = np.random.default_rng(g + dh)
    q = rng.normal(size=(b, kv * g, dh)).astype(np.float32)
    jk, tk = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    jv, tv = _to_jax(rng.normal(size=(b, s, kv, dh)), dtype)
    lens = np.array([s, 41, 0])
    want = decode_attention_pallas(jnp.asarray(q), jk, jv, lens,
                                   block_s=32, interpret=True)
    tq, tl = torch.tensor(q), torch.tensor(lens)
    plan = da.decode_plan(g, dh, tk.element_size())
    for splits in (1, 3):
        got = ref.decode_attention_split_ref(tq, tk, tv, tl, splits,
                                             gc=plan.gc)
        assert got.shape == (b, kv * g, dh) and not got[2].any()
        _close(got, want, 5e-5, rtol=5e-5)


def test_decode_split_plain_ragged_and_empty_rows():
    """Lengths [0, 1, 64, 65, 512] at S 512 and P 8 (64 positions a
    split, so whole splits lie past most lengths): every partial is
    finite, a split at or past its row's length is (m, l, acc) =
    (-1e30, 0, 0) and merges with weight 0 (the row is bit-equal to the
    merge of its other splits), length 0 gives 0 as the Pallas kernel
    does, and every row is within 1e-4 of the Pallas kernel and, past
    length 0, of the unsplit plain version."""
    b, kv, g, dh, s, splits = 5, 2, 8, 64, 512, 8
    rng = np.random.default_rng(11)
    q, k, v = (rng.normal(size=sh).astype(np.float32)
               for sh in ((b, kv * g, dh), (b, s, kv, dh), (b, s, kv, dh)))
    lens = np.array([0, 1, 64, 65, 512])
    tq, tk, tv, tl = map(torch.tensor, (q, k, v, lens))
    m, l, acc = ref.decode_split_partials(tq, tk, tv, tl, splits)
    assert all(bool(torch.isfinite(x).all()) for x in (m, l, acc))
    ranges = ref.decode_split_ranges(s, splits)
    for i, n in enumerate(lens):
        live = [p for p, (lo, _) in enumerate(ranges) if lo < n]
        for p, (lo, _) in enumerate(ranges):
            if lo >= n:
                assert bool((m[p, i] == ref.NEG_INF).all())
                assert not l[p, i].any() and not acc[p, i].any()
        got = ref.merge_decode_partials(m[:, i:i + 1], l[:, i:i + 1],
                                        acc[:, i:i + 1])
        if live:
            alone = ref.merge_decode_partials(m[live, i:i + 1],
                                              l[live, i:i + 1],
                                              acc[live, i:i + 1])
            assert torch.equal(got, alone)
        else:
            assert not got.any()
    got = ref.merge_decode_partials(m, l, acc)
    want = decode_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), lens, block_s=64,
                                   interpret=True)
    _close(got, want, 1e-4)
    _close(got[1:], ref.decode_attention_ref(tq, tk, tv, tl)[1:], 1e-4)
    assert torch.equal(got, ref.decode_attention_split_ref(tq, tk, tv, tl,
                                                           splits))


# ---------------------------------------------------------------------------
# gram_in_bf16: the plain versions with bf16 Gram operands against the
# Pallas kernels with gram_in_bf16=True in interpret mode, at the f32
# tolerances of the strip and step tests above.  These hold because the
# two sides read the same bf16-rounded operands and a product of two
# bf16 values is exact in f32: only the order of the f32 sums (and the
# plain versions' division before the dot product) differs, as in f32.
# Each is also held within 2e-2 of the f32 oracle, as the reference's
# own bf16 test (tests/test_fused_stats.py:113-123).
# ---------------------------------------------------------------------------

BF16_VS_F32 = 2e-2


def test_strip_bf16_plain_vs_pallas():
    each(_strip_bf16_case, SHAPES, ["arccos", "cosine", "l2"])


def _strip_bf16_case(shape, epilogue):
    n, c = shape
    x = _x(n, c, seed=5) * 2.5
    _, _, stats = _cache(x, 0.63, False)
    if epilogue != "arccos":
        stats[:, 1] = torch.tensor(np.random.default_rng(n).uniform(
            0.0, 2.3, n).astype(np.float32))
    ids = np.array([n - 1, 0, n // 2, 0][: min(4, n)], np.int32)  # dup 0
    lam = LAM if epilogue == "arccos" else 0.0
    tx, tids = torch.tensor(x), torch.tensor(ids, dtype=torch.int64)
    got = ref.distance_strip_ref(tx, stats, tids, lam, epilogue=epilogue,
                                 gram_in_bf16=True)
    args = (jnp.asarray(x), jnp.asarray(stats.numpy()), jnp.asarray(ids))
    pallas = gram_row_update_pallas(*args, lam=lam, epilogue=epilogue,
                                    gram_in_bf16=True, interpret=True)
    if epilogue == "arccos":
        _close_dist(got, pallas, 1e-5)
    else:
        _close(got, pallas, 1e-4, rtol=1e-4)
    f32 = jref.distance_strip_ref(*args, lam, epilogue=epilogue)
    _close(got, f32, BF16_VS_F32)
    assert all(float(got[u, i]) == 0.0 for u, i in enumerate(ids))
    # the operands really were rounded: bf16 differs from f32 somewhere
    assert not torch.equal(got, ref.distance_strip_ref(
        tx, stats, tids, lam, epilogue=epilogue))


def test_selection_steps_bf16_plain_vs_pallas():
    """The from-scratch and cached HiCS steps and the full-update step,
    plain bf16 against Pallas bf16 in interpret mode."""
    each(_steps_bf16_case, SHAPES, [(0.63, True), (0.0025, False)])


def _steps_bf16_case(shape, t_norm):
    (n, c), (temperature, normalize) = shape, t_norm
    h_tol, d_tol = _tol(temperature)
    x = _x(n, c, seed=8)
    tx = torch.tensor(x)
    ent, dist = ref.selection_step_ref(tx, temperature, LAM,
                                       normalize=normalize,
                                       gram_in_bf16=True)
    p_ent, p_dist = hics_selection_step_pallas(
        jnp.asarray(x), temperature, lam=LAM, normalize=normalize,
        gram_in_bf16=True, interpret=True)
    _close(ent, p_ent, h_tol)
    _close_dist(dist, p_dist, d_tol)
    _close(dist, jref.selection_step_ref(jnp.asarray(x), temperature, LAM,
                                         normalize=normalize)[1],
           BF16_VS_F32)

    x_old = _x(n, c, seed=9)
    _, dist0, stats0 = _cache(x_old, temperature, normalize)
    ids = np.array([1, n - 1, n // 3, 1][: min(4, n)], np.int32)
    x_new = x_old.copy()
    x_new[ids] = x[ids]
    ent, dist, stats = ref.cached_selection_step_ref(
        torch.tensor(x_new), dist0, stats0,
        torch.tensor(ids, dtype=torch.int64), temperature, LAM,
        normalize=normalize, gram_in_bf16=True)
    args = (jnp.asarray(x_new), jnp.asarray(dist0.numpy()),
            jnp.asarray(stats0.numpy()), jnp.asarray(ids), temperature)
    p_ent, p_dist, p_stats = cached_selection_step_pallas(
        *args, lam=LAM, normalize=normalize, gram_in_bf16=True,
        interpret=True)
    _close(ent, p_ent, h_tol)
    _close(stats[:, 0], np.asarray(p_stats)[:, 0], 1e-5)
    _close_dist(dist, p_dist, d_tol)
    _close(dist, jref.cached_selection_step_ref(
        *args, LAM, normalize=normalize)[1], BF16_VS_F32)
    d = dist.numpy()
    assert np.array_equal(d, d.T)

    for metric in ("cosine", "l2"):
        feats = x_new * 2.5
        fd, fs = ref.cached_feature_step_ref(
            torch.tensor(feats), torch.zeros(n, n), torch.zeros(n, 2),
            torch.arange(n), metric, gram_in_bf16=True)
        jd, js = cached_feature_step_pallas(
            jnp.asarray(feats), jnp.zeros((n, n)), jnp.zeros((n, 2)),
            jnp.arange(n, dtype=jnp.int32), metric=metric,
            gram_in_bf16=True, interpret=True)
        _close(fd, jd, 1e-4, rtol=1e-4)
        _close(fs, js, 1e-5, rtol=1e-5)
        _close(fd, jref.cached_feature_step_ref(
            jnp.asarray(feats), jnp.zeros((n, n)), jnp.zeros((n, 2)),
            jnp.arange(n, dtype=jnp.int32), metric=metric)[0], BF16_VS_F32)
        assert torch.equal(fd, fd.T)


def test_ops_cpu_ignore_gram_in_bf16():
    """On the CPU the option is ignored, as the reference's CPU oracle
    ignores it: every Gram op equals its f32 plain version."""
    x = torch.tensor(_x(12, 40, seed=2))
    ids = torch.tensor([3, 0, 11])
    _, dist0, stats0 = _cache(_x(12, 40, seed=3), 0.63, True)
    dist = ops.pairwise_distances(x, 0.63, LAM, gram_in_bf16=True,
                                  device="cpu")
    assert torch.equal(dist, ref.selection_step_ref(x, 0.63, LAM)[1])
    got = ops.hics_selection_step(x, 0.63, LAM, True, gram_in_bf16=True,
                                  device="cpu")
    want = ref.selection_step_ref(x, 0.63, LAM, normalize=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = ops.hics_selection_step_cached(x, dist0, stats0, ids, 0.63, LAM,
                                         True, gram_in_bf16=True,
                                         device="cpu")
    want = ref.cached_selection_step_ref(x, dist0, stats0, ids, 0.63, LAM,
                                         normalize=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for epi in ("arccos", "cosine", "l2"):
        got = ops.gram_row_update(x, stats0, ids, LAM, True, epilogue=epi,
                                  device="cpu")
        assert torch.equal(got, ref.distance_strip_ref(x, stats0, ids, LAM,
                                                       epilogue=epi))
    for metric in ("cosine", "l2"):
        got = ops.cached_feature_step(x, dist0, stats0, ids, metric,
                                      gram_in_bf16=True, device="cpu")
        want = ref.cached_feature_step_ref(x, dist0, stats0, ids, metric)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_strip_splits_and_slice_ranges():
    """S fills the card at the baselines' shape (two to four blocks an
    SM of 132), is 1 at the HiCS slice's C = 10, and the slices are
    whole 32-column chunks covering [0, C) without overlap."""
    tiles = gu.strip_splits(5, 50, 158_570) * 4          # 4 N tiles, 1 K
    assert 2 * 132 <= tiles <= 4 * 132
    assert gu.strip_splits(5, 50, 10) == 1
    assert gu.strip_splits(10, 512, 1024) >= 1
    for k, n, c in [(5, 50, 10), (5, 50, 158_570), (10, 512, 1024),
                    (4, 512, 1024), (1, 3, 31), (8, 16, 33), (3, 7, 0),
                    (5, 50, 255), (5, 50, 256), (2, 2, 100_000)]:
        s = gu.strip_splits(k, n, c)
        assert s >= 1
        ranges = gu.slice_ranges(c, s)
        assert len(ranges) == s
        assert ranges[0][0] == 0 and ranges[-1][1] == c
        for (b0, e0), (b1, _) in zip(ranges, ranges[1:]):
            assert e0 == b1            # contiguous, no overlap
        for b, e in ranges:
            assert b % gu.CHUNK == 0 and b <= e
            assert e == c or e % gu.CHUNK == 0
            assert c == 0 or e > b     # no empty slice
        if -(-c // gu.CHUNK) < 2 * gu.MIN_SLICE_CHUNKS:
            assert s == 1              # a few chunks: one launch
    # more SMs, more slices; a slice keeps at least MIN_SLICE_CHUNKS
    assert gu.strip_splits(5, 50, 158_570, sms=264) > gu.strip_splits(
        5, 50, 158_570)
    assert gu.strip_splits(5, 50, 8 * 32 * 3) == 3


# ---------------------------------------------------------------------------
# the pairwise kernel's split: each 64×64 tile of the upper triangle
# sums C in S slices of whole 32-column chunks, merged in slice order
# with Kahan compensation (``ref.pairwise_split_ref``), at forced S
# against the Pallas kernel in interpret mode and the unsplit plain
# version, in both operand modes, at the tolerances above (distances
# 1e-5 + 1e-5 relative at T = 0.63): only the order of the sums differs.
# ---------------------------------------------------------------------------

PAIRWISE_SPLITS = (1, 3, 8)


def test_pairwise_split_plain_vs_pallas():
    each(_pairwise_split_case, SHAPES + [(65, 4099)], [False, True],
         [False])
    each(_pairwise_split_case, [(65, 4099)], [False, True], [True])


def _pairwise_split_case(shape, bf16, zero_row):
    n, c = shape
    x = _x(n, c, seed=21) * 2.5
    if zero_row:
        x[3] = 0.0          # cosines 0: distances π/2 + λ|ΔĤ|
    tx = torch.tensor(x)
    norms = torch.linalg.vector_norm(tx, dim=-1)
    ent = ref.row_entropy(tx, 0.63, True)
    stats = torch.stack([norms, ent], dim=-1)
    pallas = pairwise_distance_pallas(
        jnp.asarray(x), jnp.asarray(norms.numpy()), jnp.asarray(ent.numpy()),
        lam=LAM, gram_in_bf16=bf16, interpret=True)
    plain = ref.pairwise_distance_ref(tx, ent, LAM, gram_in_bf16=bf16)
    for splits in PAIRWISE_SPLITS:
        got = ref.pairwise_split_ref(tx, stats, LAM, splits, bf16)
        _close_dist(got, pallas, 1e-5)
        _close_dist(got, plain, 1e-5)
        assert torch.equal(got, got.T)
        assert torch.all(torch.diagonal(got) == 0.0)
        if zero_row:
            want = np.pi / 2 + LAM * np.abs(ent[3].item() - ent.numpy())
            want[3] = 0.0
            _close(got[3], want, 1e-5, rtol=1e-5)
    if bf16:        # the operands really were rounded
        assert not torch.equal(got, ref.pairwise_split_ref(tx, stats, LAM,
                                                           splits))


def test_pairwise_plan_covers_each_pair_and_column_once():
    """The plan's tiles are the upper triangle's 64×64 tiles, row-major,
    each unordered pair of row blocks once; its slices tile [0, C) in
    order on whole 32-column chunks (empty where S exceeds the chunks);
    S is 1 at the slice's 50×10 and fills the card in one wave at the
    reference's 256×151,936."""
    for n, c in [(50, 10), (65, 4099), (256, 151_936), (512, 1024),
                 (257, 1000), (1, 1), (64, 64), (128, 33), (3, 0)]:
        plan = pw.pairwise_plan(n, c)
        nb = -(-n // pw.TILE)
        assert plan.tiles == sorted(plan.tiles)
        assert plan.tiles == [(i, j) for i in range(nb)
                              for j in range(nb) if i <= j]
        covered = np.zeros((nb * pw.TILE,) * 2, int)
        for bi, bj in plan.tiles:
            covered[bi * 64:(bi + 1) * 64, bj * 64:(bj + 1) * 64] += 1
        upper = np.triu(np.ones_like(covered))
        # each pair (i <= j) of every row block lies in one tile
        assert np.all(covered[upper == 1] >= 1)
        pairs = {(min(i, j), max(i, j)) for i, j in plan.tiles}
        assert len(pairs) == len(plan.tiles) == nb * (nb + 1) // 2
        assert 1 <= plan.splits <= pw.MAX_SPLITS
        assert len(plan.slices) == plan.splits
        assert plan.slices[0][0] == 0 and plan.slices[-1][1] == c
        for (b0, e0), (b1, _) in zip(plan.slices, plan.slices[1:]):
            assert e0 == b1
        for b, e in plan.slices:
            assert b % ref.GRAM_CHUNK == 0 and b <= e
            assert e == c or e % ref.GRAM_CHUNK == 0
        if plan.splits > 1:    # a slice keeps its MIN_SLICE_CHUNKS
            assert all(e - b >= pw.MIN_SLICE_CHUNKS * ref.GRAM_CHUNK
                       for b, e in plan.slices[:-1])
        assert len(plan.tiles) * plan.splits <= max(
            len(plan.tiles), pw.RESIDENT * 132)
    assert pw.pairwise_plan(50, 10).splits == 1
    big = pw.pairwise_plan(256, 151_936)
    assert 2 * 132 <= len(big.tiles) * big.splits <= pw.RESIDENT * 132
    assert pw.pairwise_plan(256, 151_936, sms=264).splits > big.splits
    forced = pw.pairwise_plan(50, 10, splits=8)
    assert forced.splits == 8
    assert sum(b == e for b, e in forced.slices) == 7       # empty slices
    assert gu.slice_ranges(4099, 3) == pw.pairwise_plan(
        65, 4099, splits=3).slices
    for bad in (0, pw.MAX_SPLITS + 1):
        with pytest.raises(ValueError, match="splits"):
            pw.pairwise_plan(50, 10, splits=bad)


# ---------------------------------------------------------------------------
# the stats kernels' split (fused_stats, hetero_entropy): each row cut
# into P slices of whole 32-column units, one carry (m, Z, S) and sum
# of squares per slice, merged in slice order.  The split plain versions
# at forced P against the Pallas kernels in interpret mode and the
# unsplit plain versions, at the tolerances above (Ĥ 5e-5 at T = 0.63
# and 1e-3 at 0.0025, norm and RMS 1e-5 + 1e-5 relative, bf16 entropy
# 5e-3): only the order of the sums differs.
# ---------------------------------------------------------------------------

STATS_SPLITS = (1, 3, 8)


def test_stats_splits_cover_every_column_once():
    """P <= 8, P = 1 at the slice's C = 10, P = 8 at vocab width for 2
    and 64 rows; the slices tile [0, C) in order on 32-column units,
    and C < P x 32 leaves empty slices."""
    assert stats_splits(5, 10) == 1 and stats_splits(50, 10) == 1
    assert stats_splits(2, 151_936) == 8 and stats_splits(64, 151_936) == 8
    assert stats_splits(512, 1024) == 1
    for n, c in [(5, 10), (50, 10), (2, 151_936), (64, 151_936), (3, 40),
                 (17, 4099), (1, 1), (1000, 1_000_000), (64, 4096)]:
        p = stats_splits(n, c)
        assert 1 <= p <= ref.MAX_STATS_SPLITS
        for splits in {p, 1, 3, 8}:
            ranges = ref.stats_slice_ranges(c, splits)
            assert len(ranges) == splits
            assert ranges[0][0] == 0 and ranges[-1][1] == c
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
            assert all(lo % ref.STATS_UNIT == 0 and lo <= hi
                       for lo, hi in ranges)
            if c >= splits * ref.STATS_UNIT:
                assert all(lo < hi for lo, hi in ranges)
    assert sum(lo == hi for lo, hi in ref.stats_slice_ranges(40, 8)) == 6
    with pytest.raises(ValueError, match="splits"):
        ref.stats_slice_ranges(100, 9)


def test_fused_stats_split_plain_vs_pallas():
    """fused_stats_split_ref at P in {1, 3, 8}, unscaled, with a per-row
    scale and normalized (the selection steps' one launch: Σx² merged
    first, then x·1/(max(RMS, 1e-12)·T)), against fused_stats_pallas
    (normalized: its two passes, as the reference's selection steps
    make them) and the unsplit plain versions.  C = 1030 is not a
    multiple of 4."""
    each(_fused_split_case, [(5, 10), (17, 1030)], [0.63, 0.0025],
         ["unscaled", "scaled", "normalized"])


def _fused_split_case(shape, temperature, mode):
    n, c = shape
    x = _x(n, c, seed=4)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    scale = (np.random.default_rng(1).uniform(0.5, 2.0, n).astype(np.float32)
             if mode == "scaled" else None)
    js = None if scale is None else jnp.asarray(scale)
    pallas = fused_stats_pallas(jx, temperature, row_scale=js, interpret=True)
    plain = ref.fused_stats_ref(tx, temperature,
                                None if scale is None else torch.tensor(scale))
    if mode == "normalized":
        # gram_update.py:236-239 and pairwise.py:149-154 of the reference
        inv = 1.0 / (jnp.clip(pallas[2], 1e-12, None) * temperature)
        ent = fused_stats_pallas(jx, temperature, row_scale=inv * temperature,
                                 interpret=True)[0]
        pallas = (ent, pallas[1], pallas[2])
        plain = (ref.row_entropy(tx, temperature, True), plain[1], plain[2])
    h_tol, _ = _tol(temperature)
    for splits in STATS_SPLITS:
        got = ref.fused_stats_split_ref(
            tx, temperature, splits,
            None if scale is None else torch.tensor(scale),
            normalize=mode == "normalized")
        for want in (pallas, plain):
            _close(got[0], want[0], h_tol)
            _close(got[1], want[1], 1e-5, rtol=1e-5)
            _close(got[2], want[2], 1e-5, rtol=1e-5)


def test_entropy_split_plain_vs_pallas():
    """entropy_split_ref at P in {1, 3, 8}, f32 and bf16, against
    entropy_pallas and the unsplit plain version at T = 0.0025; C = 1030
    and 4099 are multiples of neither 4 nor 8."""
    each(_entropy_split_case, [(5, 10), (17, 1030), (8, 4099)],
         [jnp.float32, jnp.bfloat16])


def _entropy_split_case(shape, dtype):
    jx, tx = _to_jax(np.random.default_rng(sum(shape) + 1).normal(size=shape)
                     * 0.02, dtype)
    want = entropy_pallas(jx, 0.0025, interpret=True)
    plain = ref.entropy_ref(tx, 0.0025)
    tol = 5e-5 if dtype == jnp.float32 else 5e-3
    for splits in STATS_SPLITS:
        got = ref.entropy_split_ref(tx, 0.0025, splits)
        assert got.dtype == torch.float32 and got.shape == (shape[0],)
        _close(got, want, tol, rtol=tol)
        _close(got, plain, tol, rtol=tol)


def test_stats_split_plain_edge_cases():
    """Empty slices (C = 40 < 8 x 32) merge to the unsplit result with no
    NaN; a zero row under normalize has RMS 0, scale 1/(1e-12·T) and
    Ĥ = ln C in the split, unsplit and reference versions; rows of
    magnitude 500 at T = 0.0025 stay finite and within 0.05 of Pallas
    (as test_entropy_plain_extreme_magnitudes)."""
    x = _x(3, 40, seed=6)
    tx = torch.tensor(x)
    for temperature in (0.63, 0.0025):
        h_tol, _ = _tol(temperature)
        got = ref.fused_stats_split_ref(tx, temperature, 8)
        assert all(bool(torch.isfinite(a).all()) for a in got)
        _close(got[0], ref.fused_stats_ref(tx, temperature)[0], h_tol)
        _close(ref.entropy_split_ref(tx, temperature, 8),
               ref.entropy_ref(tx, temperature), h_tol)
    empty = ref._slice_carry(tx[:, 5:5])
    assert torch.equal(ref.merge_carries([empty, ref._slice_carry(tx)]),
                       ref.merge_carries([ref._slice_carry(tx)]))

    z = _x(4, 1000, seed=7)
    z[1] = 0.0
    tz = torch.tensor(z)
    ln_c = np.full(1, np.log(1000.0), np.float32)
    for splits in STATS_SPLITS:
        ent, _, rms = ref.fused_stats_split_ref(tz, 0.63, splits,
                                                normalize=True)
        assert float(rms[1]) == 0.0
        _close(ent[1:2], ln_c, 5e-5)
    _close(ref.row_entropy(tz, 0.63, True)[1:2], ln_c, 5e-5)
    j_ent, _ = jref.selection_step_ref(jnp.asarray(z), 0.63, LAM,
                                       normalize=True)
    _close(np.asarray(j_ent)[1:2], ln_c, 5e-5)

    big = np.random.default_rng(0).normal(size=(4, 600)) * 500.0
    jx, tx = _to_jax(big, jnp.float32)
    want = entropy_pallas(jx, 0.0025, interpret=True)
    for splits in STATS_SPLITS:
        got = ref.entropy_split_ref(tx, 0.0025, splits)
        assert torch.isfinite(got).all()
        _close(got, want, 0.05)


def test_one_launch_normalize_steps_vs_pallas():
    """The selection steps' stats as the card now makes them, in one
    launch (``fused_stats_split_ref(..., normalize=True)`` at the
    kernel's plan, and at P = 3 on a wider C), composed with the strip
    and the pairwise matrix as ``gram_update.cached_selection_step`` and
    ``pairwise.hics_selection_step`` compose them, against the
    reference's two-pass ``cached_selection_step_pallas`` and
    ``hics_selection_step_pallas`` on the slice's shape (50 clients,
    K = 5, C = 10, T = 0.63)."""
    each(_one_launch_case, [(50, 10, None), (50, 1030, 3)])


def _one_launch_case(case):
    (n, c, splits), temperature = case, 0.63
    x_old, x = _x(n, c, seed=12), _x(n, c, seed=13)
    ids = np.array([1, n - 1, n // 2, 7, 1], np.int32)   # duplicate 1
    x_new = x_old.copy()
    x_new[ids] = x[ids]
    _, dist0, stats0 = _cache(x_old, temperature, True)
    tx, tids = torch.tensor(x_new), torch.tensor(ids, dtype=torch.int64)
    rows = tx[tids]
    p = splits or stats_splits(len(ids), c)
    ent_r, norm_r, _ = ref.fused_stats_split_ref(rows, temperature, p,
                                                 normalize=True)
    stats = stats0.clone()
    stats[tids] = torch.stack([norm_r, ent_r], dim=-1)
    strip = ref.distance_strip_ref(tx, stats, tids, LAM)
    dist = ref.scatter_strip(dist0, strip, tids)
    p_ent, p_dist, p_stats = cached_selection_step_pallas(
        jnp.asarray(x_new), jnp.asarray(dist0.numpy()),
        jnp.asarray(stats0.numpy()), jnp.asarray(ids), temperature,
        lam=LAM, normalize=True, interpret=True)
    _close(stats[:, 1], p_ent, 5e-5)
    _close(stats[:, 0], np.asarray(p_stats)[:, 0], 1e-5, rtol=1e-5)
    _close_dist(dist, p_dist, 1e-5)

    ent, norm, _ = ref.fused_stats_split_ref(
        tx, temperature, splits or stats_splits(n, c), normalize=True)
    full = ref.pairwise_distance_ref(tx, ent, LAM)
    s_ent, s_dist = hics_selection_step_pallas(
        jnp.asarray(x_new), temperature, lam=LAM, normalize=True,
        interpret=True)
    _close(ent, s_ent, 5e-5)
    _close_dist(full, s_dist, 1e-5)
