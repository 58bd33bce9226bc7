"""Agglomerative clustering on a precomputed distance matrix, on device.

The port of the reference's ``agglomerate_device`` and
``cluster_means_device`` for ward linkage, the only one HiCS-FL uses:
Lance–Williams merges on squared distances, the flat row-major first-occurrence argmin as merge order
(``torch.argmin`` returns the first minimal index, as ``jnp.argmin``
does), the higher index absorbed into the lower, and first-appearance
relabelling.  N − M merges run as a Python loop of tensor ops with no
host synchronization inside it: every element is gathered by an index
tensor, never by a 0-d tensor used as a Python index.

The reference's compiled Lance–Williams update rounds as fused
multiply-adds (XLA contracts ``a·b + c·d`` into ``fma(a, b, c·d)``).
The port evaluates the same fmas, each as an exact f64 product plus
one f64 add rounded to f32, so a tied matrix keeps its ties and the
labels match the reference's.
"""
from __future__ import annotations

import torch

def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c with one rounding to f32 (a·b is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def agglomerate_device(dist: torch.Tensor, num_clusters: int,
                       precomputed: bool = False) -> torch.Tensor:
    """Ward-cluster N items into ``num_clusters`` groups -> (N,) int32
    labels in [0, M), numbered by first appearance.  ``precomputed``
    promises an exactly symmetric matrix and skips ``0.5·(d + dᵀ)``."""
    n = dist.shape[0]
    m = max(1, min(int(num_clusters), n))
    dev = dist.device
    d = dist.float()
    if not precomputed:
        d = 0.5 * (d + d.T)
    d = d * d
    d = torch.where(torch.eye(n, dtype=torch.bool, device=dev),
                    torch.inf, d).contiguous()
    sizes = torch.ones(n, dtype=torch.float32, device=dev)
    labels = torch.arange(n, device=dev)
    for _ in range(n - m):
        flat = torch.argmin(d)               # row-major, so i < j
        i, j = flat // n, flat % n
        ij = torch.stack([i, j])
        # gathers by index tensor: no scalar crosses to the host
        dij = d.view(-1).index_select(0, flat[None])[0]
        ni, nj = sizes.index_select(0, ij).unbind()
        di, dj = d.index_select(0, ij).unbind()
        new = _fma(-sizes, dij, _fma(ni + sizes, di, (nj + sizes) * dj)
                   ) / (ni + nj + sizes)
        new = new.index_fill(0, ij, torch.inf)
        d.index_copy_(0, i[None], new[None])
        d.index_copy_(1, i[None], new[:, None])
        d.index_fill_(0, j[None], torch.inf)
        d.index_fill_(1, j[None], torch.inf)
        sizes = sizes.index_copy(0, ij, torch.stack(
            [ni + nj, torch.zeros_like(nj)]))
        labels = torch.where(labels == j, i, labels)
    # every surviving representative r has labels[r] == r, so the rank
    # of r among the representatives is its first-appearance label
    is_rep = labels == torch.arange(n, device=dev)
    rank = torch.cumsum(is_rep.to(torch.int64), 0) - 1
    return rank[labels].to(torch.int32)


def cluster_means_device(values: torch.Tensor, labels: torch.Tensor,
                         num_clusters: int) -> torch.Tensor:
    """Per-cluster mean of ``values`` (empty clusters get 0), summed
    through a one-hot mask so the order is fixed on every device."""
    onehot = (labels[None, :].long() == torch.arange(
        num_clusters, device=labels.device)[:, None]).to(values.dtype)
    s = (onehot * values[None, :]).sum(dim=1)
    c = onehot.sum(dim=1)
    return torch.where(c > 0, s / torch.clamp(c, min=1.0),
                       torch.zeros_like(s))
