"""K-row incremental refresh of a cached distance matrix.

Replaces the TPU kernel ``src/repro/kernels/gram_update.py:
_gram_row_kernel`` with all three of its epilogues and both operand
modes (via ``_gram_rows_padded``, ``gram_row_update_pallas``,
``cached_selection_step_pallas`` and ``cached_feature_step_pallas``)
with ``csrc/gram_update.cu``.  The kernel splits C across blocks so
that every SM streams x: a grid of (N tiles, K tiles, S slices of
whole 32-column chunks), S from :func:`strip_splits`.  Each block sums
its slice in an order fixed by the column index (``fmaf`` within four
staged steps, Kahan across them, a butterfly across lanes); with S > 1
a merge pass adds the slices' partial sums in increasing slice order
with Kahan compensation and applies the epilogue, with S = 1 the block
does.
Every ⟨a_u, x_j⟩ sees the same order, so ⟨a_u, a_v⟩ and ⟨a_v, a_u⟩
are bit-equal and the scattered K×K block is exactly symmetric, which
``agglomerate_device(..., precomputed=True)`` relies on.  The epilogue
is one of ``arccos`` (Eq. 9, HiCS), ``cosine`` (the angle alone,
Clustered Sampling) and ``l2`` (Euclidean from the cached norms,
DivFL).  ``gram_in_bf16`` rounds both Gram operands to bf16 as
the kernel loads them from the f32 buffer (one pass over x; the
reference casts a bf16 copy first) and keeps the sums f32; the stats
stay those of the f32 rows.  It is bound by the bytes of x.

:func:`cached_selection_step` mirrors ``cached_selection_step_pallas``:
gather the K rows, fused stats on them (one launch, ``normalize``
included), scatter the stats, the strip kernel, and the row and column
scatter.
:func:`cached_feature_step` mirrors ``cached_feature_step_pallas``: the
K rows' norms in plain torch (the reference too computes them outside
the kernel), the strip kernel with the selector's epilogue and the
transpose-averaged scatter.  The gather and scatter glue is torch.  On
a CPU tensor each function takes its plain version in
:mod:`repro_torch.kernels.ref`, f32 whatever ``gram_in_bf16`` says, as
the reference's CPU oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_stats import fused_stats_rows

EPS = 1e-8

#: the strip kernel's epilogues, in the order of the C entry's codes
EPILOGUES = ("arccos", "cosine", "l2")

#: the kernel's tiling (csrc/gram_update.cu: KT, JT) and its slices'
#: unit (csrc/gram_tile.cuh: TC)
TILE_ROWS, TILE_COLS, CHUNK = 8, 16, ref.GRAM_CHUNK
#: blocks an SM the split aims at (the kernel's registers let two
#: blocks share an SM, so one wave), and the fewest chunks a slice
#: keeps (two staged steps of 128 columns)
BLOCKS_PER_SM, MIN_SLICE_CHUNKS = 2, 8


def strip_splits(k: int, n: int, c: int, sms: int = 132) -> int:
    """S, the slices of C the strip kernel splits its K×N strip into:
    enough (N tiles × K tiles × S) blocks for two an SM, each
    slice at least :data:`MIN_SLICE_CHUNKS` chunks, so that a C of a
    few chunks is one slice and one launch (S = 1)."""
    tiles = -(-n // TILE_COLS) * -(-k // TILE_ROWS)
    chunks = -(-c // CHUNK)
    want = -(-BLOCKS_PER_SM * sms // max(1, tiles))
    return max(1, min(want, chunks // MIN_SLICE_CHUNKS))


def slice_ranges(c: int, splits: int) -> list:
    """The kernel's slices of [0, c): [(begin, end)] per slice, whole
    chunks of :data:`CHUNK` columns, the last cut at c
    (csrc/gram_tile.cuh: slice_range)."""
    return ref.gram_slice_ranges(c, splits)


def gram_strip(rows: torch.Tensor, x: torch.Tensor,
               stats_rows: torch.Tensor, stats_all: torch.Tensor,
               row_ids: torch.Tensor, lam: float,
               eps: float = EPS, epilogue: str = "arccos",
               gram_in_bf16: bool = False,
               splits: int | None = None) -> torch.Tensor:
    """Launch the strip kernel: rows (K, C), x (N, C), stats (K, 2) and
    (N, 2) = [norm, Ĥ] f32, row_ids (K,) int32 -> (K, N) f32.
    ``epilogue`` is one of :data:`EPILOGUES`; ``gram_in_bf16`` rounds
    the operands to bf16; ``splits`` (default :func:`strip_splits` for
    this card) is S.  With S > 1 the wrapper allocates the (S, K, N) f32
    workspace of the slices' partial sums."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}; expected one "
                         f"of {EPILOGUES}")
    k, c = rows.shape
    n = x.shape[0]
    build.require(rows, "rows", (k, c))
    build.require(x, "x", (n, c))
    build.require(stats_rows, "stats_rows", (k, 2))
    build.require(stats_all, "stats_all", (n, 2))
    build.require(row_ids, "row_ids", (k,), torch.int32)
    if splits is None:
        splits = strip_splits(k, n, c, build.sm_count(x.device.index))
    most = max(1, min(65535, -(-c // CHUNK)))
    if not 1 <= splits <= most:
        raise ValueError(f"splits must lie in [1, {most}], got {splits}")
    out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, k, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    build.launch("gram_update", rows.data_ptr(), x.data_ptr(),
                 stats_rows.data_ptr(), stats_all.data_ptr(),
                 row_ids.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), k, n, c, splits,
                 float(lam), float(eps), EPILOGUES.index(epilogue),
                 int(bool(gram_in_bf16)), epilogue=epilogue,
                 operands=build.OPERANDS[bool(gram_in_bf16)])
    return out


def gram_row_update(updates: torch.Tensor, stats: torch.Tensor,
                    ids: torch.Tensor, lam: float = 10.0,
                    epilogue: str = "arccos",
                    gram_in_bf16: bool = False) -> torch.Tensor:
    """(N, C), (N, 2) current [norm, Ĥ], (K,) ids -> (K, N) distance
    strip.  ``stats`` must already hold every row's current values."""
    if updates.device.type == "cpu":
        return ref.distance_strip_ref(updates, stats, ids, lam,
                                      epilogue=epilogue)
    x = updates.float().contiguous()
    stats = stats.float().contiguous()
    return gram_strip(x[ids].contiguous(), x, stats[ids].contiguous(),
                      stats, ids.to(torch.int32).contiguous(), lam,
                      epilogue=epilogue, gram_in_bf16=gram_in_bf16)


def cached_selection_step(updates: torch.Tensor, dist: torch.Tensor,
                          stats: torch.Tensor, ids: torch.Tensor,
                          temperature: float, lam: float = 10.0,
                          normalize: bool = False,
                          gram_in_bf16: bool = False):
    """Incremental HiCS step: (N, C) Δb, cached dist (N, N) and stats
    (N, 2) = [norm, Ĥ], (K,) refreshed ids -> (Ĥ (N,), dist, stats)
    with the rows and columns of ``ids`` recomputed.  K = 0 returns the
    cache unchanged; duplicate ids are harmless."""
    if updates.device.type == "cpu":
        return ref.cached_selection_step_ref(updates, dist, stats, ids,
                                             temperature, lam,
                                             normalize=normalize)
    k = ids.numel()
    if k == 0:
        return stats[:, 1], dist, stats
    x = updates.float().contiguous()
    rows = x[ids].contiguous()
    ent_r, norm_r, _ = fused_stats_rows(rows, temperature,
                                        normalize=normalize)
    stats = stats.float().contiguous().clone()
    stats[ids] = torch.stack([norm_r, ent_r], dim=-1)
    strip = gram_strip(rows, x, stats[ids].contiguous(), stats,
                       ids.to(torch.int32).contiguous(), lam,
                       gram_in_bf16=gram_in_bf16)
    return stats[:, 1], ref.scatter_strip(dist, strip, ids), stats


def cached_feature_step(feats: torch.Tensor, dist: torch.Tensor,
                        stats: torch.Tensor, ids: torch.Tensor,
                        metric: str = "cosine", gram_in_bf16: bool = False):
    """Incremental full-update step (CS, DivFL): (N, F) features,
    cached dist (N, N) and stats (N, 2) = [norm, 0], (K,) refreshed ids
    -> (dist, stats) with the rows and columns of ``ids`` recomputed by
    the ``metric`` ("cosine" or "l2") epilogue.  K = 0 returns the
    cache unchanged; duplicate ids are harmless."""
    if metric not in ("cosine", "l2"):
        raise ValueError(f"unknown metric {metric!r}; expected 'cosine' "
                         "or 'l2'")
    if feats.device.type == "cpu":
        return ref.cached_feature_step_ref(feats, dist, stats, ids,
                                           metric=metric)
    if ids.numel() == 0:
        return dist, stats
    x = feats.float().contiguous()
    rows = x[ids].contiguous()
    norms = torch.linalg.vector_norm(rows, dim=-1)
    stats = stats.float().contiguous().clone()
    stats[ids] = torch.stack([norms, torch.zeros_like(norms)], dim=-1)
    strip = gram_strip(rows, x, stats[ids].contiguous(), stats,
                       ids.to(torch.int32).contiguous(), 0.0,
                       epilogue=metric, gram_in_bf16=gram_in_bf16)
    return ref.scatter_strip_symmetric(dist, strip, ids), stats
