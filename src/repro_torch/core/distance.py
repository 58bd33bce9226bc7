"""Heterogeneity-aware pairwise distance (paper §3.3, Eq. 9), plain.

    Distance(u, k) = arccos( <Δb_u, Δb_k> / (|Δb_u||Δb_k|) )
                     + λ |Ĥ(D_u) − Ĥ(D_k)|

The port of the reference's ``core/distance.py``: the whole (N, N)
matrix in plain tensor ops, for analysis and the benchmarks.  The
selectors build it through the ``pairwise`` kernel and refresh it
through the Gram strip (``repro_torch.kernels.ops``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hetero import estimate_entropy


def pairwise_arccos(updates: torch.Tensor, eps: float = 1e-8
                    ) -> torch.Tensor:
    """arccos of the row-wise cosine matrix of ``updates`` (N, C): (N, N)
    angles in [0, π], the cosine clipped to ±(1 − 1e-7) first and the
    diagonal exactly 0."""
    norms = torch.linalg.vector_norm(updates, dim=-1, keepdim=True)
    unit = updates / torch.clamp(norms, min=eps)
    cos = torch.clamp(unit @ unit.T, -1.0 + 1e-7, 1.0 - 1e-7)
    ang = torch.arccos(cos)
    eye = torch.eye(updates.shape[0], dtype=ang.dtype, device=ang.device)
    return ang * (1.0 - eye)


def distance_matrix(updates: torch.Tensor, temperature: float,
                    lam: float = 10.0,
                    entropies: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """The Eq. 9 distance over N clients' bias updates (N, C);
    ``entropies`` default to Eq. 7's Ĥ of ``updates`` at
    ``temperature``."""
    if entropies is None:
        entropies = estimate_entropy(updates, temperature)
    dh = torch.abs(entropies[:, None] - entropies[None, :])
    return pairwise_arccos(updates) + lam * dh
