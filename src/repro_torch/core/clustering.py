"""Agglomerative clustering on a precomputed distance matrix.

The port of the reference's ``core/clustering.py``, with its four
Lance–Williams linkages: ward (on squared distances), average (UPGMA),
complete and single.

* :func:`agglomerate_device`, :func:`cluster_means_device`: the
  selectors' path, on the matrix's device.  The flat row-major
  first-occurrence argmin gives the merge order (``torch.argmin``
  returns the first minimal index, as ``jnp.argmin`` does), the higher
  index is absorbed into the lower, and labels are numbered by first
  appearance.  N − M merges run as a Python loop of tensor ops with no
  host synchronization inside it: every element is gathered by an
  index tensor, never by a 0-d tensor used as a Python index.
* :func:`agglomerate`, :func:`cluster_means`, :func:`silhouette_hint`:
  the reference's host-side numpy helpers (f64, a lazily verified
  row-minimum cache), copied, for analysis and the benchmarks.

The reference's compiled Lance–Williams update rounds as fused
multiply-adds (XLA contracts ``a·b + c·d`` into ``fma(a, b, c·d)``), in
ward's update and in average's.  The port evaluates the same fmas, each
as an exact f64 product plus one f64 add rounded to f32, so a tied
matrix keeps its ties and the labels match the reference's.  Complete
and single linkage (``maximum``, ``minimum``) round nothing.
"""
from __future__ import annotations

import numpy as np
import torch

LINKAGES = ("ward", "average", "complete", "single")


def check_linkage(linkage: str) -> None:
    """Raise ``ValueError`` for a name that is not one of :data:`LINKAGES`."""
    if linkage not in LINKAGES:
        raise ValueError(f"linkage must be one of {LINKAGES}")


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c with one rounding to f32 (a·b is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def agglomerate_device(dist: torch.Tensor, num_clusters: int,
                       linkage: str = "ward",
                       precomputed: bool = False) -> torch.Tensor:
    """Cluster N items into ``num_clusters`` groups -> (N,) int32
    labels in [0, M), numbered by first appearance.  ``precomputed``
    promises an exactly symmetric matrix and skips ``0.5·(d + dᵀ)``.
    Every linkage stays finite on any finite matrix, the all-zero one
    included (the scanned driver's discarded branch)."""
    check_linkage(linkage)
    n = dist.shape[0]
    m = max(1, min(int(num_clusters), n))
    dev = dist.device
    d = dist.float()
    if not precomputed:
        d = 0.5 * (d + d.T)
    if linkage == "ward":
        d = d * d
    d = torch.where(torch.eye(n, dtype=torch.bool, device=dev),
                    torch.inf, d).contiguous()
    sizes = torch.ones(n, dtype=torch.float32, device=dev)
    labels = torch.arange(n, device=dev)
    for _ in range(n - m):
        flat = torch.argmin(d)               # row-major, so i < j
        i, j = flat // n, flat % n
        ij = torch.stack([i, j])
        ni, nj = sizes.index_select(0, ij).unbind()
        di, dj = d.index_select(0, ij).unbind()
        if linkage == "ward":
            # gathers by index tensor: no scalar crosses to the host
            dij = d.view(-1).index_select(0, flat[None])[0]
            new = _fma(-sizes, dij, _fma(ni + sizes, di, (nj + sizes) * dj)
                       ) / (ni + nj + sizes)
        elif linkage == "average":
            new = _fma(ni, di, nj * dj) / (ni + nj)
        elif linkage == "complete":
            new = torch.maximum(di, dj)
        else:                                # single
            new = torch.minimum(di, dj)
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


def agglomerate(dist: np.ndarray, num_clusters: int,
                linkage: str = "ward",
                precomputed: bool = False) -> np.ndarray:
    """The reference's host-side clustering: N items into
    ``num_clusters`` groups, (N,) int64 labels numbered by first
    appearance, in f64 with a lazily verified per-row minimum cache.

    The cached row minimum is always a lower bound on the row's true
    minimum (merges fold in with ``np.minimum``); the picked row is
    verified with one row argmin, which also gives the partner column
    and reproduces the flat argmin's tie order.  Retired rows and
    columns are parked at +inf.  ``precomputed=True`` promises an exactly
    symmetric matrix and skips ``0.5·(d + dᵀ)``, a no-op on one."""
    check_linkage(linkage)
    n = dist.shape[0]
    if dist.shape != (n, n):
        raise ValueError(f"distance matrix must be square, got {dist.shape}")
    num_clusters = max(1, min(num_clusters, n))
    d = np.array(dist, dtype=np.float64)
    if not precomputed:
        d = 0.5 * (d + d.T)
    if linkage == "ward":
        d = d ** 2
    np.fill_diagonal(d, np.inf)

    sizes = np.ones(n, dtype=np.float64)
    # merge forest: parent[j] = i records "cluster j absorbed into i"
    # (always i < j)
    parent = np.arange(n)
    row_min = d.min(axis=1)
    for _ in range(n - num_clusters):
        while True:
            i = int(np.argmin(row_min))
            j = int(np.argmin(d[i]))        # true row min + tie column
            true_min = d[i, j]
            if true_min == row_min[i]:
                break
            row_min[i] = true_min           # was stale-low: repair, retry
        if i > j:
            i, j = j, i
        dij = d[i, j]
        ni, nj = sizes[i], sizes[j]
        # Lance–Williams update of d(k, i∪j) over every k: retired and
        # self entries are +inf and stay +inf through each formula
        di, dj = d[i], d[j]
        if linkage == "ward":
            nk = sizes
            new = (ni + nk) * di
            new += (nj + nk) * dj
            new -= nk * dij
            new /= ni + nj + nk
        elif linkage == "average":
            new = ni * di
            new += nj * dj
            new /= ni + nj
        elif linkage == "complete":
            new = np.maximum(di, dj)
        else:  # single
            new = np.minimum(di, dj)
        new[i] = np.inf
        new[j] = np.inf
        d[i, :] = new
        d[:, i] = new
        d[:, j] = np.inf                    # row j is never read again
        sizes[i] = ni + nj
        sizes[j] = 0.0
        parent[j] = i
        # lower bounds only: rows whose minimum sat at column i or j may
        # now be stale-low, and the pick-time verify repairs them
        np.minimum(row_min, new, out=row_min)
        row_min[i] = new.min()
        row_min[j] = np.inf

    # parents point to lower indices: one increasing pass resolves them
    labels = np.arange(n)
    for k in range(n):
        labels[k] = labels[parent[k]]
    uniq: dict = {}
    out = np.empty(n, dtype=np.int64)
    for k, lab in enumerate(labels):
        if lab not in uniq:
            uniq[lab] = len(uniq)
        out[k] = uniq[lab]
    return out


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


def cluster_means(values: np.ndarray, labels: np.ndarray,
                  num_clusters: int) -> np.ndarray:
    """Per-cluster mean of a per-item scalar, f64 (empty clusters 0)."""
    out = np.zeros(num_clusters, dtype=np.float64)
    for m in range(num_clusters):
        sel = labels == m
        out[m] = float(np.mean(values[sel])) if np.any(sel) else 0.0
    return out


def silhouette_hint(dist: np.ndarray, labels: np.ndarray) -> float:
    """Mean silhouette over items (a diagnostic; nothing selects by
    it); 0 with fewer than two clusters."""
    n = dist.shape[0]
    uniq = np.unique(labels)
    if len(uniq) < 2:
        return 0.0
    s = []
    for i in range(n):
        same = labels == labels[i]
        same[i] = False
        a = float(np.mean(dist[i, same])) if np.any(same) else 0.0
        b = min(float(np.mean(dist[i, labels == m]))
                for m in uniq if m != labels[i])
        denom = max(a, b)
        s.append(0.0 if denom == 0 else (b - a) / denom)
    return float(np.mean(s))
