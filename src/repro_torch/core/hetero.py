"""Data-heterogeneity estimation from output-layer updates (paper §3.2).

    Ĥ(D^(k)) = H(softmax(Δb^(k) / T))                       (Eq. 7)

grounded in the expectation identity (Eq. 6)

    E[Δb_i^(k)] = ηR (D_i^(k) Σ_c E_c − E_i)

The port of the reference's ``core/hetero.py``: the estimator, the head
Δb of a param dict (a bias-free head's ΔW row mean as its surrogate),
and the theory-facing helpers (Eq. 6's forward model, Assumption 3.1's
envelope and Thm 3.3's bound, the last two host numpy as there).  Params
are nested dicts (``{"lm_head": {"w", "b"}, ...}``) and the head is
found by a ``"lm_head/b"`` path, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def softmax_entropy(v: torch.Tensor, temperature: float) -> torch.Tensor:
    """H(softmax(v / T)) along the last axis, as lnZ − Σ s·u with
    u = v/T − max (no materialized log p)."""
    u = v / temperature
    u = u - u.max(dim=-1, keepdim=True).values
    e = torch.exp(u)
    z = e.sum(dim=-1)
    s = (e * u).sum(dim=-1)
    return torch.log(z) - s / z


def estimate_entropy(delta_b: torch.Tensor, temperature: float,
                     normalize: bool = False) -> torch.Tensor:
    """Ĥ(D) per Eq. 7.  ``normalize=True`` RMS-normalizes each Δb
    before the tempered softmax (invariant to update magnitude and to
    C)."""
    if normalize:
        rms = torch.sqrt((delta_b * delta_b).mean(dim=-1, keepdim=True))
        delta_b = delta_b / torch.clamp(rms, min=1e-12)
    return softmax_entropy(delta_b, temperature)


def label_entropy(dist: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """True Shannon entropy H(D) of label distribution(s) (..., C)."""
    p = dist / torch.clamp(dist.sum(dim=-1, keepdim=True), min=eps)
    plogp = p * torch.log(torch.clamp(p, min=eps))
    return -torch.where(p > 0, plogp, torch.zeros_like(p)).sum(dim=-1)


def expected_bias_update(dist: torch.Tensor, e_vec: torch.Tensor,
                         eta: float, epochs: int) -> torch.Tensor:
    """Eq. 6's forward model: E[Δb_i] = ηR (D_i Σ_c E_c − E_i), for a
    label distribution ``dist`` (..., C) and the misleading-confidence
    vector ``e_vec`` (C,)."""
    return eta * epochs * (dist * e_vec.sum(dim=-1, keepdim=True) - e_vec)


def delta_b_from_head_delta(delta_w: torch.Tensor,
                            class_axis: int = -1) -> torch.Tensor:
    """A bias-free head's Δb surrogate: the mean of the head's weight
    update ΔW (one class axis of size C, one feature axis) over the
    feature axis, (C,).  Eq. 6's derivation with z for the constant 1
    gives each class's mean the same affine structure in D."""
    if delta_w.dim() != 2:
        raise ValueError(
            f"head delta must be 2-D, got {tuple(delta_w.shape)}")
    feat_axis = 0 if class_axis in (-1, 1) else 1
    return delta_w.mean(dim=feat_axis)


def head_bias_update(params_before: dict, params_after: dict,
                     bias_path: str = "lm_head/b"
                     ) -> Optional[torch.Tensor]:
    """Δb of one client from two param dicts: the real bias at
    ``bias_path`` first, else :func:`delta_b_from_head_delta` of the
    weight at ``lm_head/w``; None when the model has no recognizable
    head."""
    before = _lookup(params_before, bias_path)
    if before is not None:
        return _lookup(params_after, bias_path) - before
    wpath = bias_path.rsplit("/", 1)[0] + "/w"
    before = _lookup(params_before, wpath)
    if before is not None:
        return delta_b_from_head_delta(_lookup(params_after, wpath) - before)
    return None


def _lookup(params: dict, path: str):
    node = params
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def head_bias_updates_stacked(params_before: dict, stacked_after: dict,
                              bias_path: str = "lm_head/b"
                              ) -> Optional[torch.Tensor]:
    """(global params, K-stacked local params) -> (K, C) Δb.  The real
    bias at ``bias_path`` first, else the feature-mean ΔW surrogate at
    ``lm_head/w``; None when the model has no recognizable head."""
    before = _lookup(params_before, bias_path)
    if before is not None:
        return _lookup(stacked_after, bias_path) - before[None]
    wpath = bias_path.rsplit("/", 1)[0] + "/w"
    before = _lookup(params_before, wpath)
    if before is not None:
        return (_lookup(stacked_after, wpath) - before[None]).mean(dim=1)
    return None


def head_num_classes(params: dict, bias_path: str = "lm_head/b"
                     ) -> Optional[int]:
    """Class-axis width C of the head's Δb; None without a head."""
    b = _lookup(params, bias_path)
    if b is not None:
        return int(b.shape[-1])
    w = _lookup(params, bias_path.rsplit("/", 1)[0] + "/w")
    return None if w is None else int(w.shape[-1])


def dissimilarity_envelope(h: np.ndarray, kappa: float, rho: float,
                           beta: float, h0: Optional[float] = None,
                           num_classes: int = 10) -> np.ndarray:
    """σ_k² = κ − ρ e^{β (H − H(D₀))}: Assumption 3.1's envelope; H(D₀)
    defaults to ln C."""
    if h0 is None:
        h0 = float(np.log(num_classes))
    return kappa - rho * np.exp(beta * (np.asarray(h) - h0))


def entropy_separation_bound(dist_k: np.ndarray, dist_u: np.ndarray,
                             e_sum: float, delta: float, eta: float,
                             epochs: int, temperature: float) -> float:
    """The right-hand side of Thm 3.3 (Eq. 8) for a client pair, u
    balanced and k imbalanced: positive when the theorem predicts
    Ĥ(u) > Ĥ(k) in expectation."""
    C = dist_k.shape[-1]
    u = np.full(C, 1.0 / C)
    t1 = 0.5 * (eta * epochs * e_sum / (C * temperature)) ** 2 \
        * float(np.sum((dist_k - u) ** 2))
    t2 = eta * epochs / temperature * float(np.max(np.abs(dist_u - u)))
    cc = eta * epochs * (eta * epochs + C * C * temperature * np.log(C)) \
        / (C * C * temperature * temperature)
    return t1 - t2 - cc * delta
