"""Single-sweep row stats: Ĥ, L2 norm and RMS of each row of (N, C).

Replaces the TPU kernel ``src/repro/kernels/fused_stats.py:
_fused_stats_kernel`` (via ``_fused_stats_padded``, ``fused_stats_pallas``)
with ``csrc/fused_stats.cu``.  It reads (N, C) once and writes 3N
floats, so on the H100 it is bound by the bytes of x.  Each row is
split across the :func:`stats_splits` blocks of one thread-block
cluster, so that 2 or 64 rows at vocab width still stream x on most of
the SMs; the blocks' online-softmax carries (m, Z, S) of u = x·scale
and their sums of squares merge in rank order (``entropy_carry.cuh``).
``normalize`` (the RMS-normalized estimator) runs in the same launch:
the cluster adds the row's Σx² first, then every block scales by
1/(max(RMS, 1e-12)·T), the reference's arithmetic, where the reference
sweeps twice with torch-side ops between.  At the slice's C = 10 a row
is one block and the time is the launch.  No padding: the kernel stops
at C.

On a CPU tensor the wrapper takes the plain version
(:func:`repro_torch.kernels.ref.fused_stats_ref`); on a CUDA tensor it
launches the kernel or raises.  :func:`repro_torch.kernels.ref.
fused_stats_split_ref` is the plain version of the split itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: blocks an SM the split aims at (four of 256 threads, all resident at
#: once), and the fewest columns a slice keeps
BLOCKS_PER_SM, MIN_SLICE_COLS = 4, 2048


def stats_splits(n: int, c: int, sms: int = 132) -> int:
    """P, the blocks (one cluster) each of the N rows is split across:
    enough N·P blocks for about four an SM, P <= 8 (the portable cluster
    size), each slice at least :data:`MIN_SLICE_COLS` columns, so a
    narrow row is one block (P = 1 at C = 10)."""
    want = -(-BLOCKS_PER_SM * sms // max(1, n))
    return max(1, min(ref.MAX_STATS_SPLITS, want, c // MIN_SLICE_COLS))


def check_splits(n: int, c: int, x: torch.Tensor, splits) -> int:
    """``splits``, or the plan for this card; raises unless C > 0 and
    1 <= P <= 8 (a slice may be empty)."""
    if c == 0:
        raise ValueError("x must have at least one column")
    if splits is None:
        return stats_splits(n, c, build.sm_count(x.device.index))
    if not 1 <= splits <= ref.MAX_STATS_SPLITS:
        raise ValueError(f"splits must lie in [1, {ref.MAX_STATS_SPLITS}], "
                         f"got {splits}")
    return splits


def fused_stats_rows(x: torch.Tensor, temperature: float,
                     row_scale: torch.Tensor | None = None,
                     normalize: bool = False, splits: int | None = None):
    """Launch the kernel: x (N, C) f32 -> (Ĥ, norm, RMS), each (N,) f32.
    The softmax reads x·s: s = ``row_scale`` (N,) f32 when given (it
    already carries 1/T), 1/(max(RMS, 1e-12)·T) under ``normalize``,
    computed in the same launch, else 1/T.  ``splits`` (default
    :func:`stats_splits` for this card) is P."""
    n, c = x.shape
    build.require(x, "x", (n, c))
    if row_scale is not None:
        build.require(row_scale, "row_scale", (n,))
        if normalize:
            raise ValueError("normalize takes no row_scale")
    splits = check_splits(n, c, x, splits)
    ent, norm, rms = (torch.empty(n, dtype=torch.float32, device=x.device)
                      for _ in range(3))
    build.launch("fused_stats", x.data_ptr(),
                 None if row_scale is None else row_scale.data_ptr(),
                 ent.data_ptr(), norm.data_ptr(), rms.data_ptr(), n, c,
                 splits, 1.0 / temperature, float(temperature),
                 int(bool(normalize)))
    return ent, norm, rms


def fused_stats(updates: torch.Tensor, temperature: float,
                row_scale: torch.Tensor | None = None):
    """(N, C) -> (Ĥ, |Δb|₂, RMS), each (N,) f32, in one sweep.
    ``row_scale`` (N,) multiplies each row before the tempered softmax;
    norm and RMS always describe the raw rows."""
    if updates.device.type == "cpu":
        return ref.fused_stats_ref(updates, temperature, row_scale)
    x = updates.float().contiguous()
    scale = (None if row_scale is None
             else (row_scale.float() / temperature).contiguous())
    return fused_stats_rows(x, temperature, row_scale=scale)
