"""Client partitions with a fixed-capacity layout, from random draws
given as inputs.

The port of the reference's ``scenarios/partition_jax.py``.  A
partition is a :class:`Partition` of fixed-shape tensors

    idx    (N, cap) int32    row indices into the dataset
    mask   (N, cap) float32  1.0 where the row is a real sample
    counts (N,)     int32    true client sizes (before the cap clip)

Every scheme is a per-sample *assignment* ``assign (S,) ∈ [0, N)``
(Gumbel-argmax categoricals over per-class client log-proportions, a
shard deal or a round-robin deal), packed into the padded layout by
one stable sort.  The random draws come in as a :class:`PartitionDraws`,
made on the CPU by :func:`draw_partition` from one ``torch.Generator``;
:func:`partition_device` is then a pure function of the draws and the
labels, on whatever device the labels lie, so the card and the CPU
build the same partition from the same draws.

The Dirichlet proportions are drawn in log space: log Γ(α) as
log Γ(α + 1) + log(U)/α, in float64, then cast to f32.  A direct gamma
draw underflows at the paper's α = 1e-3 (every client then ties and
the argmax partition degenerates).  Samples beyond ``cap`` for an
overfull client are dropped (mask 0); ``counts`` keeps the true size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.selectors.functional import draw_gumbel


class Partition(NamedTuple):
    """Fixed-capacity partition (see the module docstring)."""
    idx: torch.Tensor      # (N, cap) int32
    mask: torch.Tensor     # (N, cap) float32
    counts: torch.Tensor   # (N,) int32


class PartitionDraws(NamedTuple):
    """The random inputs of one partition; a kind's unused fields are
    None.

    logp    (C, N) f32  per-class, per-client log-Dirichlet proportions
                        (dirichlet, multi_alpha); (N,) log-Dirichlet
                        sizes (quantity)
    perm    (S,) int64  the sample permutation that deals the data
                        slices of the α cohorts (multi_alpha with more
                        than one α)
    gumbel  (S, N) f32  standard Gumbel draws of the categoricals
                        (dirichlet, multi_alpha, quantity)
    shard_perm (N·L,) int64  the shard permutation (shards)
    iid_perm   (S,) int64    the deal's permutation (iid)
    """
    logp: Optional[torch.Tensor] = None
    perm: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None
    shard_perm: Optional[torch.Tensor] = None
    iid_perm: Optional[torch.Tensor] = None


def pack_assignment(assign: torch.Tensor, num_clients: int,
                    cap: int) -> Partition:
    """Pack a per-sample client-assignment vector into a Partition.

    One stable sort groups samples by client; client k's rows then
    occupy a contiguous span, gathered into the (N, cap) layout with a
    clamped position index.  Padded slots point at row 0 (a valid row:
    the mask, not the value, makes them inert)."""
    s = assign.shape[0]
    dev = assign.device
    assign = assign.long()
    order = torch.sort(assign, stable=True).indices
    counts = torch.bincount(assign, minlength=num_clients)[:num_clients]
    starts = torch.cumsum(counts, 0) - counts
    ar = torch.arange(cap, device=dev)
    pos = starts[:, None] + ar[None, :]
    valid = ar[None, :] < torch.clamp(counts, max=cap)[:, None]
    idx = torch.where(valid, order[torch.clamp(pos, 0, s - 1)],
                      torch.zeros((), dtype=order.dtype, device=dev))
    return Partition(idx.to(torch.int32), valid.to(torch.float32),
                     counts.to(torch.int32))


def equal_split_groups(total: int, n_groups: int) -> np.ndarray:
    """Group id per position, with ``np.array_split``'s sizes."""
    sizes = [len(a) for a in np.array_split(np.arange(total), n_groups)]
    return np.repeat(np.arange(n_groups), sizes)


def log_gamma(gen: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """log of Gamma(α, 1) draws, elementwise, as f32: log Γ(α + 1) +
    log(U)/α in float64 (U uniform on (0, 1]), finite down to α = 1e-3
    and below, where a direct f32 or f64 gamma draw underflows to 0."""
    a = alpha.to(torch.float64)
    g1 = torch._standard_gamma(a + 1.0, generator=gen)
    u = 1.0 - torch.rand(a.shape, dtype=torch.float64, generator=gen)
    return (torch.log(g1) + torch.log(u) / a).to(torch.float32)


def draw_partition(gen: torch.Generator, kind: str, num_samples: int,
                   num_classes: int, num_clients: int, *,
                   alphas: Sequence[float] = (0.5,),
                   labels_per_client: int = 2,
                   beta: float = 0.5) -> PartitionDraws:
    """One partition's random draws for ``kind``, on the CPU from
    ``gen``."""
    s, n = int(num_samples), int(num_clients)
    if kind in ("dirichlet", "multi_alpha"):
        alpha = np.asarray(alphas, np.float32)[
            equal_split_groups(n, len(alphas))]
        logp = log_gamma(gen, torch.as_tensor(alpha).expand(
            int(num_classes), n))
        perm = (torch.randperm(s, generator=gen) if len(alphas) > 1
                else None)
        return PartitionDraws(logp=logp, perm=perm,
                              gumbel=draw_gumbel(gen, (s, n)))
    if kind == "shards":
        return PartitionDraws(shard_perm=torch.randperm(
            n * int(labels_per_client), generator=gen))
    if kind == "quantity":
        logq = log_gamma(gen, torch.full((n,), float(beta)))
        return PartitionDraws(logp=logq, gumbel=draw_gumbel(gen, (s, n)))
    if kind == "iid":
        return PartitionDraws(iid_perm=torch.randperm(s, generator=gen))
    raise ValueError(f"unknown partition kind {kind!r}")


def dirichlet_assign(draws: PartitionDraws, labels: torch.Tensor,
                     num_clients: int,
                     alphas: Sequence[float]) -> torch.Tensor:
    """Multi-α Dirichlet assignment (paper App. A.10 / §4.1 settings).

    With one α this is the single-concentration scheme; with several,
    clients and data are both equal-split into ``len(alphas)`` cohorts
    and each data slice is partitioned over its client group with its
    own α, the host ``multi_alpha_partition``'s structure."""
    dev = labels.device
    s = labels.shape[0]
    n_groups = len(alphas)
    logits = draws.logp.to(dev)[labels.long()]               # (S, N)
    if n_groups > 1:
        group_of_client = torch.as_tensor(
            equal_split_groups(num_clients, n_groups), device=dev)
        group_pos = torch.as_tensor(equal_split_groups(s, n_groups),
                                    device=dev)
        group_of_sample = torch.zeros(s, dtype=group_pos.dtype,
                                      device=dev).index_copy(
            0, draws.perm.to(dev), group_pos)
        logits = torch.where(group_of_client[None, :]
                             == group_of_sample[:, None], logits,
                             -torch.inf)
    return torch.argmax(logits + draws.gumbel.to(dev), dim=1).to(
        torch.int32)


def shards_assign(draws: PartitionDraws, labels: torch.Tensor,
                  num_clients: int, labels_per_client: int) -> torch.Tensor:
    """Pathological label skew: label-sorted data cut into N·L shards,
    each client dealt L shards (McMahan et al.'s FedAvg partition)."""
    dev = labels.device
    s = labels.shape[0]
    num_shards = num_clients * labels_per_client
    shard_size = max(1, s // num_shards)
    order = torch.sort(labels.long(), stable=True).indices
    shard_of_pos = torch.clamp(torch.arange(s, device=dev) // shard_size,
                               0, num_shards - 1)
    client_of_shard = torch.div(draws.shard_perm.to(dev), labels_per_client,
                                rounding_mode="floor")
    return torch.zeros(s, dtype=torch.int64, device=dev).index_copy(
        0, order, client_of_shard[shard_of_pos]).to(torch.int32)


def quantity_assign(draws: PartitionDraws, num_samples: int,
                    device) -> torch.Tensor:
    """Quantity skew: label-agnostic sizes ∝ Dir(β) over clients."""
    logq = draws.logp.to(device)
    return torch.argmax(logq[None, :] + draws.gumbel.to(device),
                        dim=1).to(torch.int32)


def iid_assign(draws: PartitionDraws, num_samples: int, num_clients: int,
               device) -> torch.Tensor:
    """Exactly balanced IID deal (round-robin under a permutation)."""
    deal = torch.arange(num_samples, device=device) % num_clients
    return torch.zeros(num_samples, dtype=torch.int64,
                       device=device).index_copy(
        0, draws.iid_perm.to(device), deal).to(torch.int32)


def partition_device(draws: PartitionDraws, labels: torch.Tensor,
                     num_classes: int, num_clients: int, kind: str,
                     cap: int, *, alphas: Sequence[float] = (0.5,),
                     labels_per_client: int = 2,
                     beta: float = 0.5) -> Partition:
    """The partition of ``labels.shape[0]`` samples that ``draws`` (a
    :func:`draw_partition` of the same kind and sizes) define, on the
    labels' device.  ``kind`` ∈ {"dirichlet", "multi_alpha", "shards",
    "quantity", "iid"}; "dirichlet" and "multi_alpha" share one path
    (the former is the latter with a single cohort).  ``num_classes``
    and ``beta`` shaped the draws and are not read again."""
    del num_classes, beta
    s = labels.shape[0]
    dev = labels.device
    if kind in ("dirichlet", "multi_alpha"):
        assign = dirichlet_assign(draws, labels, num_clients, alphas)
    elif kind == "shards":
        assign = shards_assign(draws, labels, num_clients,
                               labels_per_client)
    elif kind == "quantity":
        assign = quantity_assign(draws, s, dev)
    elif kind == "iid":
        assign = iid_assign(draws, s, num_clients, dev)
    else:
        raise ValueError(f"unknown partition kind {kind!r}")
    return pack_assignment(assign, num_clients, cap)


def partition_label_distributions(part: Partition, labels: torch.Tensor,
                                  num_classes: int) -> torch.Tensor:
    """Per-client empirical label distribution (N, C) from the padded
    layout."""
    y = labels[part.idx.long()].long()                    # (N, cap)
    onehot = torch.nn.functional.one_hot(y, num_classes).float()
    cnt = (onehot * part.mask[..., None]).sum(dim=1)      # (N, C)
    tot = torch.clamp(cnt.sum(dim=1, keepdim=True), min=1.0)
    return cnt / tot
