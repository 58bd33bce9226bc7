"""Single-sweep row stats: Ĥ, L2 norm and RMS of each row of (N, C).

Replaces the TPU kernel ``src/repro/kernels/fused_stats.py:
_fused_stats_kernel`` (via ``_fused_stats_padded``, ``fused_stats_pallas``)
with ``csrc/fused_stats.cu``: one warp per row carries the online
softmax state (m, Z, S) of u = x·scale and Σx² over the row, and the 32
lane carries merge by shuffle.  The kernel reads (N, C) once and writes
3N floats, so on the H100 it is bound by memory bytes; at the slice's
C = 10 its time is the launch.  No padding: the kernel stops at C.

On a CPU tensor the wrapper takes the plain version
(:func:`repro_torch.kernels.ref.fused_stats_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def fused_stats_rows(x: torch.Tensor, scale: torch.Tensor):
    """Launch the kernel: x (N, C) f32 and the per-row scale (N,) f32
    that multiplies x before the softmax (1/T, or 1/(RMS·T)) ->
    (Ĥ, norm, RMS), each (N,) f32."""
    n, c = x.shape
    build.require(x, "x", (n, c))
    build.require(scale, "scale", (n,))
    ent, norm, rms = (torch.empty(n, dtype=torch.float32, device=x.device)
                      for _ in range(3))
    build.launch("fused_stats", x.data_ptr(), scale.data_ptr(),
                 ent.data_ptr(), norm.data_ptr(), rms.data_ptr(), n, c)
    return ent, norm, rms


def fused_stats(updates: torch.Tensor, temperature: float,
                row_scale: torch.Tensor | None = None):
    """(N, C) -> (Ĥ, |Δb|₂, RMS), each (N,) f32, in one sweep.
    ``row_scale`` (N,) multiplies each row before the tempered softmax;
    norm and RMS always describe the raw rows."""
    if updates.device.type == "cpu":
        return ref.fused_stats_ref(updates, temperature, row_scale)
    x = updates.float().contiguous()
    n = x.shape[0]
    if row_scale is None:
        scale = torch.full((n,), 1.0 / temperature, dtype=torch.float32,
                           device=x.device)
    else:
        scale = (row_scale.float() / temperature).contiguous()
    return fused_stats_rows(x, scale)
