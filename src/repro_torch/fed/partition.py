"""Non-IID data partitioning (paper App. A.10), numpy.

A copy of the reference's ``fed/partition.py``: for each label i,
proportions X_i^(1..N) ~ Dir(α) are drawn and client k receives
X_i^(k) N_i / Σ_j X_i^(j) of the label-i samples.  The multi-α scheme
splits the training set into |α| equal parts, each partitioned over its
own client group.  The same ``rng`` gives the same partition as the
reference.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def dirichlet_partition(rng: np.random.Generator, labels: np.ndarray,
                        num_clients: int, alpha: float,
                        min_per_client: int = 2) -> List[np.ndarray]:
    """Indices of `labels` split over clients with per-label Dir(α)."""
    num_classes = int(labels.max()) + 1
    client_idx: List[List[int]] = [[] for _ in range(num_clients)]
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, alpha))
        counts = _largest_remainder(props, len(idx))
        start = 0
        for k, cnt in enumerate(counts):
            client_idx[k].extend(idx[start:start + cnt])
            start += cnt
    out = [np.asarray(client_idx[k], dtype=np.int64)
           for k in range(num_clients)]
    # top up starved clients by stealing from the largest client, so
    # the result stays a true partition
    for k in range(num_clients):
        while len(out[k]) < min_per_client:
            sizes = np.array([len(o) for o in out])
            sizes[k] = -1                        # never donate to self
            donor = int(np.argmax(sizes))
            if sizes[donor] <= max(min_per_client, 1):
                break                            # nothing left to steal
            j = int(rng.integers(len(out[donor])))
            out[k] = np.append(out[k], out[donor][j])
            out[donor] = np.delete(out[donor], j)
    for ids in out:
        rng.shuffle(ids)
    return out


def multi_alpha_partition(rng: np.random.Generator, labels: np.ndarray,
                          num_clients: int, alphas: Sequence[float],
                          ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Returns (per-client indices, per-client α used): client groups
    are equal splits over `alphas`, each partitioning an equal slice of
    the data."""
    alphas = list(alphas)
    n_groups = len(alphas)
    perm = rng.permutation(len(labels))
    data_slices = np.array_split(perm, n_groups)
    client_groups = np.array_split(np.arange(num_clients), n_groups)
    out: List[np.ndarray] = [np.empty(0, dtype=np.int64)] * num_clients
    client_alpha = np.zeros(num_clients)
    for alpha, dslice, cgroup in zip(alphas, data_slices, client_groups):
        sub = dirichlet_partition(rng, labels[dslice], len(cgroup), alpha)
        for local_k, k in enumerate(cgroup):
            out[k] = dslice[sub[local_k]]
            client_alpha[k] = alpha
    return out, client_alpha


def _largest_remainder(props: np.ndarray, total: int) -> np.ndarray:
    raw = props * total
    counts = np.floor(raw).astype(np.int64)
    rem = total - counts.sum()
    order = np.argsort(-(raw - counts))
    counts[order[:rem]] += 1
    return counts
