"""Data-heterogeneity estimation from output-layer updates (paper §3.2).

    Ĥ(D^(k)) = H(softmax(Δb^(k) / T))                       (Eq. 7)

The port of the reference's ``core/hetero.py`` estimator half.  Params
are nested dicts (``{"lm_head": {"w", "b"}, ...}``) and the head is
found by a ``"lm_head/b"`` path, as in the reference.
"""
from __future__ import annotations

from typing import Optional

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
