"""Two-stage hierarchical clustered sampling (paper §3.4, Eq. 10), on
device, with the Gumbel noise as an input.

The port of the reference's ``anneal_device``, ``gumbel_topk``,
``weighted_sample_device``, ``coverage_sweep_device`` and
``hierarchical_sample_device``.  The caller draws the noise; given
the same Gumbel tensors the port picks the same ids as the reference:

* top-k is a stable descending sort, so ties go to the lower index as
  in ``lax.top_k`` (``torch.topk`` orders ties otherwise, and the
  coverage sweep's 1e6 offset puts its f32 noise on a 0.0625 grid,
  where ties are common);
* ``torch.argmax`` returns the first maximal index, as ``jnp.argmax``.
"""
from __future__ import annotations

import torch

_NEG_LOG_FLOOR = 1e-30   # log-clip so zero weights become ~ -inf, not nan


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
