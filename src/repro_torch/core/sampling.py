"""Two-stage hierarchical clustered sampling (paper §3.4, Eq. 10).

Stage 1 picks a cluster m with probability
π_m^t = exp(γ^t H̄_m^t) / Σ_m' exp(γ^t H̄_m'^t), γ^t = γ⁰(1 − t/T);
stage 2 a client k inside it with probability p_k / Σ_{j∈G_m} p_j.
K clients repeat both stages without replacement.

The port of the reference's ``core/sampling.py``, in two halves:

* host numpy (``anneal``, ``cluster_probs``, ``hierarchical_sample``,
  ``sampling_probabilities``): the reference's own helpers, copied, for
  analysis and the benchmarks; ``hierarchical_sample`` draws from the
  caller's ``np.random.Generator``, so a shared seed gives the
  reference's ids;
* device (``anneal_device``, ``gumbel_topk``, ``weighted_sample_device``,
  ``coverage_sweep_device``, ``hierarchical_sample_device``), with the
  Gumbel noise as an input.  Given the same Gumbel tensors the port
  picks the same ids as the reference: top-k is a stable descending
  sort, so ties go to the lower index as in ``lax.top_k``
  (``torch.topk`` orders ties otherwise, and the coverage sweep's 1e6
  offset puts its f32 noise on a 0.0625 grid, where ties are common),
  and ``torch.argmax`` returns the first maximal index, as
  ``jnp.argmax``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

_NEG_LOG_FLOOR = 1e-30   # log-clip so zero weights become ~ -inf, not nan


def anneal(gamma0: float, t: int, total_rounds: int) -> float:
    """γ^t = γ⁰ (1 − t/T), clipped at 0."""
    return float(gamma0 * max(0.0, 1.0 - t / max(1, total_rounds)))


def cluster_probs(mean_entropies: np.ndarray, gamma_t: float) -> np.ndarray:
    """π^t over clusters (Eq. 10 left), a stable softmax in f64."""
    z = gamma_t * np.asarray(mean_entropies, dtype=np.float64)
    z = z - np.max(z)
    e = np.exp(z)
    return e / np.sum(e)


def hierarchical_sample(rng: np.random.Generator, labels: np.ndarray,
                        mean_entropies: np.ndarray, weights: np.ndarray,
                        k: int, gamma_t: float) -> List[int]:
    """K distinct client ids by the two-stage scheme, drawn from
    ``rng``: labels (N,) cluster ids, mean_entropies (M,) H̄_m, weights
    (N,) p_k (need not be normalized).  An emptied cluster is
    renormalized away."""
    n = len(labels)
    k = min(k, n)
    m = int(np.max(labels)) + 1 if n else 0
    avail = [list(np.flatnonzero(labels == c)) for c in range(m)]
    pi = cluster_probs(mean_entropies, gamma_t)
    w = np.asarray(weights, dtype=np.float64)
    chosen: List[int] = []
    while len(chosen) < k:
        mask = np.array([len(a) > 0 for a in avail], dtype=np.float64)
        probs = pi * mask
        s = probs.sum()
        if s <= 0:
            probs = mask / mask.sum()
        else:
            probs = probs / s
        c = int(rng.choice(m, p=probs))
        cand = avail[c]
        pw = w[cand]
        pw = pw / pw.sum() if pw.sum() > 0 else np.full(len(cand),
                                                        1.0 / len(cand))
        pick = int(rng.choice(len(cand), p=pw))
        chosen.append(cand.pop(pick))
    return chosen


def sampling_probabilities(labels: np.ndarray, mean_entropies: np.ndarray,
                           weights: np.ndarray,
                           gamma_t: float) -> np.ndarray:
    """The single-draw marginal ω_k^t = π_{m(k)} · p_k / Σ_{j∈G_m} p_j
    (uniform within a cluster of zero weight)."""
    pi = cluster_probs(mean_entropies, gamma_t)
    w = np.asarray(weights, dtype=np.float64)
    out = np.zeros(len(labels), dtype=np.float64)
    for c in np.unique(labels):
        sel = labels == c
        denom = w[sel].sum()
        if denom > 0:
            out[sel] = pi[c] * w[sel] / denom
        else:
            out[sel] = pi[c] / sel.sum()
    return out


def anneal_device(gamma0: float, t, total_rounds: float,
                  device=None) -> torch.Tensor:
    """γ^t = γ⁰ (1 − t/T) clipped at 0, as an f32 scalar tensor, from
    the round index ``t`` (a 0-d int32 tensor, or an int)."""
    tt = torch.as_tensor(t, device=device).to(torch.float32)
    frac = tt / max(1.0, float(total_rounds))
    return gamma0 * torch.clamp(1.0 - frac, min=0.0)


def _topk_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    return torch.sort(scores, descending=True, stable=True).indices[:k]


def gumbel_topk(noise: torch.Tensor, logits: torch.Tensor,
                k: int) -> torch.Tensor:
    """Top-K of ``logits + noise`` (standard Gumbel, the shape of
    ``logits``): K draws without replacement, P(i first) ∝ exp(logits_i)."""
    return _topk_stable(logits + noise, k)


def weighted_sample_device(noise: torch.Tensor, weights: torch.Tensor,
                           k: int) -> torch.Tensor:
    """min(K, N) distinct ids ∝ ``weights`` (Gumbel top-K over log w).
    ``noise`` is (N,) standard Gumbel f32: the reference draws it on the
    select key with the coverage sweep's shape, so it is the round's
    ``SelectNoise.cover``."""
    logw = torch.log(torch.clamp(weights, min=_NEG_LOG_FLOOR)).float()
    return gumbel_topk(noise, logw, min(k, weights.shape[-1]))


def coverage_sweep_device(noise: torch.Tensor, seen: torch.Tensor,
                          k: int) -> torch.Tensor:
    """min(K, N) distinct ids, uniformly among unseen clients first
    (Alg. 1 lines 14-15).  ``noise`` is (N,) standard Gumbel f32."""
    offset = torch.where(seen, 0.0, 1e6).to(torch.float32)
    return _topk_stable(noise + offset, min(k, seen.shape[-1]))


def hierarchical_sample_device(cluster_noise: torch.Tensor,
                               client_noise: torch.Tensor,
                               labels: torch.Tensor,
                               mean_entropies: torch.Tensor,
                               weights: torch.Tensor, k: int,
                               gamma_t: torch.Tensor) -> torch.Tensor:
    """K sequential two-stage draws without replacement (Eq. 10).

    Stage 1: Gumbel argmax over γ^t·H̄ among clusters with clients
    left, with ``cluster_noise[i]`` (M,).  Stage 2: Gumbel argmax over
    log p_k within the chosen cluster, with ``client_noise[i]`` (N,).
    """
    n = labels.shape[0]
    k = min(k, n)
    m = mean_entropies.shape[0]
    dev = labels.device
    logw = torch.log(torch.clamp(weights, min=_NEG_LOG_FLOOR)).float()
    clogit_live = gamma_t * mean_entropies.float()
    labels = labels.long()
    avail = torch.ones(n, dtype=torch.bool, device=dev)
    chosen = []
    for i in range(k):
        live = torch.zeros(m, device=dev).index_add_(
            0, labels, avail.float()) > 0
        clogit = torch.where(live, clogit_live, -torch.inf)
        c = torch.argmax(clogit + cluster_noise[i])
        jlogit = torch.where((labels == c) & avail, logw, -torch.inf)
        j = torch.argmax(jlogit + client_noise[i])
        avail = avail.index_fill(0, j[None], False)
        chosen.append(j)
    return torch.stack(chosen).to(torch.int32)
