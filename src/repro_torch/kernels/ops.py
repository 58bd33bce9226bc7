"""Public kernel API of the port, with an explicit device.

    fused_row_stats(updates, T)             (N, C) -> (Ĥ, norm, RMS)
    hics_selection_step(updates, T, lam)    (N, C) -> (Ĥ (N,), D (N, N))
    hics_selection_step_cached(...)         K-row incremental refresh
    gram_row_update(updates, stats, ids)    (K, N) strip, any epilogue
    cached_feature_step(feats, ...)         K-row refresh, cosine or l2
    pairwise_distances(updates, T, lam)     (N, C) -> (N, N)   [Eq. 9]
    estimate_entropies(updates, T)          (N, C) -> (N,)
    gqa_decode_attention(q, k, v, length)   one-token flash decode

Each takes ``device`` (default ``"cuda"``) and the tensors must lie on
it.  On ``"cpu"`` the plain PyTorch versions run; on ``"cuda"`` the
hand-written kernels run or the call raises.  Asking for the card on a
machine without one raises; nothing falls back.  ``gram_in_bf16`` (the
Gram functions) rounds the two Gram operands to bf16 with f32 sums on
the card; on the CPU it is ignored and the plain versions stay f32, as
the reference's CPU oracle.
"""
from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.kernels import (decode_attention, fused_stats, gram_update,
                                 hetero_entropy, pairwise)


def _on(device, *tensors: torch.Tensor) -> None:
    dev = resolve_device(device)
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"tensor on {t.device}, but device={dev}")


def fused_row_stats(updates: torch.Tensor, temperature: float, *,
                    device="cuda"):
    """(Ĥ, |Δb|₂, RMS) per client in one sweep over (N, C)."""
    _on(device, updates)
    return fused_stats.fused_stats(updates, temperature)


def hics_selection_step(updates: torch.Tensor, temperature: float,
                        lam: float = 10.0, normalize: bool = False,
                        gram_in_bf16: bool = False, *, device="cuda"):
    """(N, C) Δb -> (Ĥ (N,), Eq. 9 distance (N, N)), from scratch."""
    _on(device, updates)
    return pairwise.hics_selection_step(updates, temperature, lam=lam,
                                        normalize=normalize,
                                        gram_in_bf16=gram_in_bf16)


def hics_selection_step_cached(updates: torch.Tensor, dist: torch.Tensor,
                               stats: torch.Tensor, ids: torch.Tensor,
                               temperature: float, lam: float = 10.0,
                               normalize: bool = False,
                               gram_in_bf16: bool = False, *,
                               device="cuda"):
    """(N, C) Δb, cached (dist (N, N), stats (N, 2) = [norm, Ĥ]), (K,)
    refreshed ids -> (Ĥ (N,), dist, stats).  Only the rows and columns
    of ``ids`` are recomputed: O(K·N·C) instead of O(N²·C)."""
    _on(device, updates, dist, stats, ids)
    return gram_update.cached_selection_step(
        updates, dist, stats, ids, temperature, lam=lam,
        normalize=normalize, gram_in_bf16=gram_in_bf16)


def gram_row_update(updates: torch.Tensor, stats: torch.Tensor,
                    ids: torch.Tensor, lam: float = 10.0,
                    gram_in_bf16: bool = False, epilogue: str = "arccos", *,
                    device="cuda"):
    """(N, C), (N, 2) current [norm, Ĥ], (K,) ids -> the (K, N) strip
    of the ``epilogue`` distance ("arccos", "cosine" or "l2")."""
    _on(device, updates, stats, ids)
    return gram_update.gram_row_update(updates, stats, ids, lam=lam,
                                       epilogue=epilogue,
                                       gram_in_bf16=gram_in_bf16)


def cached_feature_step(feats: torch.Tensor, dist: torch.Tensor,
                        stats: torch.Tensor, ids: torch.Tensor,
                        metric: str = "cosine", gram_in_bf16: bool = False,
                        *, device="cuda"):
    """(N, F) features, cached (dist (N, N), stats (N, 2) = [norm, 0]),
    (K,) refreshed ids -> (dist, stats), the rows and columns of
    ``ids`` recomputed by the ``metric`` ("cosine" or "l2") strip."""
    _on(device, feats, dist, stats, ids)
    return gram_update.cached_feature_step(feats, dist, stats, ids,
                                           metric=metric,
                                           gram_in_bf16=gram_in_bf16)


def pairwise_distances(updates: torch.Tensor, temperature: float,
                       lam: float = 10.0, gram_in_bf16: bool = False, *,
                       device="cuda"):
    """Full Eq. 9 matrix: fused stats, then the pairwise kernel."""
    _on(device, updates)
    return pairwise.hics_selection_step(updates, temperature, lam=lam,
                                        gram_in_bf16=gram_in_bf16)[1]


def estimate_entropies(updates: torch.Tensor, temperature: float, *,
                       device="cuda") -> torch.Tensor:
    """Ĥ over N clients' bias updates: (N, C) f32 or bf16 -> (N,) f32."""
    _on(device, updates)
    return hetero_entropy.entropy(updates, temperature)


def gqa_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length, scale: float | None = None, *,
                         device="cuda") -> torch.Tensor:
    """One-token GQA attention against a (B, S, KV, dh) cache: q
    (B, H, dh), length () or (B,) -> (B, H, dh) f32."""
    _on(device, q, k, v)
    return decode_attention.decode_attention(q, k, v, length, scale=scale)
