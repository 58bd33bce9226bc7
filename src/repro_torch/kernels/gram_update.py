"""K-row incremental refresh of a cached distance matrix.

Replaces the TPU kernel ``src/repro/kernels/gram_update.py:
_gram_row_kernel`` with all three of its epilogues (via
``_gram_rows_padded``, ``gram_row_update_pallas``,
``cached_selection_step_pallas`` and ``cached_feature_step_pallas``)
with ``csrc/gram_update.cu``: one block per 16×16 output tile stages
row and column tiles through shared memory and sums each ⟨a_u, x_j⟩ in
a fixed order, one ``fmaf`` per column within a 32-column chunk and the
chunks' sums with Kahan compensation (``csrc/gram_tile.cuh``).
⟨a_u, a_v⟩ and ⟨a_v, a_u⟩ are therefore bit-equal and the scattered
K×K block is exactly symmetric, which ``agglomerate_device(...,
precomputed=True)`` relies on.  The epilogue is a template parameter:
``arccos`` (Eq. 9, HiCS), ``cosine`` (the angle alone, Clustered
Sampling) and ``l2`` (Euclidean from the cached norms, DivFL).  At the
HiCS slice's shapes (K = 5, N = 50, C = 10) its time is the launch; at
the baselines' F = 158,570 four blocks walk all of F, so it is bound by
their load latency (``csrc/gram_update.cu``).

:func:`cached_selection_step` mirrors ``cached_selection_step_pallas``:
gather the K rows, fused stats on them (twice under ``normalize``),
scatter the stats, the strip kernel, and the row and column scatter.
:func:`cached_feature_step` mirrors ``cached_feature_step_pallas``: the
K rows' norms in plain torch (the reference too computes them outside
the kernel), the strip kernel with the selector's epilogue and the
transpose-averaged scatter.  The gather and scatter glue is torch.  On
a CPU tensor each function takes its plain version in
:mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_stats import fused_stats_rows

EPS = 1e-8

#: the strip kernel's epilogues, in the order of the C entry's codes
EPILOGUES = ("arccos", "cosine", "l2")


def gram_strip(rows: torch.Tensor, x: torch.Tensor,
               stats_rows: torch.Tensor, stats_all: torch.Tensor,
               row_ids: torch.Tensor, lam: float,
               eps: float = EPS, epilogue: str = "arccos") -> torch.Tensor:
    """Launch the strip kernel: rows (K, C), x (N, C), stats (K, 2) and
    (N, 2) = [norm, Ĥ] f32, row_ids (K,) int32 -> (K, N) f32.
    ``epilogue`` is one of :data:`EPILOGUES`."""
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
    out = torch.empty((k, n), dtype=torch.float32, device=x.device)
    build.launch("gram_update", rows.data_ptr(), x.data_ptr(),
                 stats_rows.data_ptr(), stats_all.data_ptr(),
                 row_ids.data_ptr(), out.data_ptr(), k, n, c, float(lam),
                 float(eps), EPILOGUES.index(epilogue), variant=epilogue)
    return out


def gram_row_update(updates: torch.Tensor, stats: torch.Tensor,
                    ids: torch.Tensor, lam: float = 10.0,
                    epilogue: str = "arccos") -> torch.Tensor:
    """(N, C), (N, 2) current [norm, Ĥ], (K,) ids -> (K, N) distance
    strip.  ``stats`` must already hold every row's current values."""
    if updates.device.type == "cpu":
        return ref.distance_strip_ref(updates, stats, ids, lam,
                                      epilogue=epilogue)
    x = updates.float().contiguous()
    stats = stats.float().contiguous()
    return gram_strip(x[ids].contiguous(), x, stats[ids].contiguous(),
                      stats, ids.to(torch.int32).contiguous(), lam,
                      epilogue=epilogue)


def cached_selection_step(updates: torch.Tensor, dist: torch.Tensor,
                          stats: torch.Tensor, ids: torch.Tensor,
                          temperature: float, lam: float = 10.0,
                          normalize: bool = False):
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
    inv_t = torch.full((k,), 1.0 / temperature, dtype=torch.float32,
                       device=x.device)
    ent_r, norm_r, rms_r = fused_stats_rows(rows, inv_t)
    if normalize:
        scale = 1.0 / (torch.clamp(rms_r, min=1e-12) * temperature)
        ent_r, _, _ = fused_stats_rows(rows, scale)
    stats = stats.float().contiguous().clone()
    stats[ids] = torch.stack([norm_r, ent_r], dim=-1)
    strip = gram_strip(rows, x, stats[ids].contiguous(), stats,
                       ids.to(torch.int32).contiguous(), lam)
    return stats[:, 1], ref.scatter_strip(dist, strip, ids), stats


def cached_feature_step(feats: torch.Tensor, dist: torch.Tensor,
                        stats: torch.Tensor, ids: torch.Tensor,
                        metric: str = "cosine"):
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
                       epilogue=metric)
    return ref.scatter_strip_symmetric(dist, strip, ids), stats
