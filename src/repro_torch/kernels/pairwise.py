"""Full Eq. 9 distance matrix and the from-scratch selection step.

Replaces the TPU kernel ``src/repro/kernels/pairwise.py:
_pairwise_kernel`` with both operand modes (via ``_pairwise_padded``,
``pairwise_distance_pallas`` and ``hics_selection_step_pallas``) with
``csrc/pairwise.cu``: ``gram_tile.cuh``'s tile loop over (N tiles,
N tiles), the diagonal zeroed, each sum over C in one fixed order
(``fmaf`` within 32-column chunks, Kahan across them) so the matrix is
bit-symmetric.  ``gram_in_bf16`` rounds the operands to bf16 as the
kernel loads them (f32 sums; the stats stay f32).  At the slice's
N = 50, C = 10 its time is the launch; at large N it rereads x once per
16-row tile, so it is bound by its shared-memory loads long before
device memory.

:func:`hics_selection_step` mirrors ``hics_selection_step_pallas``:
fused stats over all rows (one launch, ``normalize`` included), then
this kernel.  On a CPU tensor it takes the plain
:func:`repro_torch.kernels.ref.selection_step_ref`, f32 whatever
``gram_in_bf16`` says, as the reference's CPU oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_stats import fused_stats_rows

EPS = 1e-8


def pairwise(x: torch.Tensor, stats: torch.Tensor, lam: float,
             eps: float = EPS, gram_in_bf16: bool = False) -> torch.Tensor:
    """Launch the kernel: x (N, C) f32, stats (N, 2) = [norm, Ĥ] f32
    -> (N, N) f32; ``gram_in_bf16`` rounds the operands to bf16."""
    n, c = x.shape
    build.require(x, "x", (n, c))
    build.require(stats, "stats", (n, 2))
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    build.launch("pairwise", x.data_ptr(), stats.data_ptr(),
                 out.data_ptr(), n, c, float(lam), float(eps),
                 int(bool(gram_in_bf16)),
                 operands=build.OPERANDS[bool(gram_in_bf16)])
    return out


def hics_selection_step(updates: torch.Tensor, temperature: float,
                        lam: float = 10.0, normalize: bool = False,
                        gram_in_bf16: bool = False):
    """From-scratch HiCS step: (N, C) -> (Ĥ (N,), Eq. 9 D (N, N))."""
    if updates.device.type == "cpu":
        return ref.selection_step_ref(updates, temperature, lam,
                                      normalize=normalize)
    x = updates.float().contiguous()
    ent, norm, _ = fused_stats_rows(x, temperature, normalize=normalize)
    stats = torch.stack([norm, ent], dim=-1).contiguous()
    return ent, pairwise(x, stats, lam, gram_in_bf16=gram_in_bf16)
