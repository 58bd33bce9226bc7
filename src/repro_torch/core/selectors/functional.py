"""The functional selector protocol of the port: state tuple, pure
transitions.

    state = fn.init()
    ids, state = fn.select(state, t, noise)
    state = fn.update(state, t, ids, obs)

The port of the reference's ``core/selectors/functional.py``.  Every
field is a tensor on the server's device.  Randomness is an input:
``select`` takes the round's :class:`SelectNoise`, which the server
draws in one place per round.  ``update`` takes the
:class:`Observations` the server computed for the selector's
``requires``.  Transitions return new tensors and never write into the
state they were given.

A branch on the state goes through :func:`cond`, the port's
``jax.lax.cond``: the host loop reads the predicate and runs one
branch; inside :func:`both_branches` (the scanned driver's round
step) both run and each output is picked on the device.  The round
index ``t`` is a 0-d int32 tensor (:func:`round_index`), as the
reference's traced ``t``.
"""
from __future__ import annotations

import contextlib
from typing import Callable, FrozenSet, NamedTuple, Optional

import torch

from repro_torch.optim import tree_map


class SelectNoise(NamedTuple):
    """One round's standard Gumbel draws (f32), each the reference's
    draw on the round's select key:

    cover        (N,)   the coverage sweep's, and the weighted
                        sampler's (same key and shape)
    cluster      (K, M) per two-stage draw i, the cluster stage's (M
                        clusters, K unless HiCS's ``num_clusters``)
    client       (K, N) per two-stage draw i, the client stage's
    cluster_pick (K, N) Clustered Sampling's one pick per cluster
    """
    cover: torch.Tensor
    cluster: torch.Tensor
    client: torch.Tensor
    cluster_pick: torch.Tensor


def draw_gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    """Standard Gumbel f32 draws of ``shape``, on the CPU from ``gen``."""
    return -torch.empty(shape).exponential_(generator=gen).log()



def draw_select_noise(gen: torch.Generator, n: int, k: int,
                      m: Optional[int] = None) -> SelectNoise:
    """One round's :class:`SelectNoise` for N clients, a cohort of K and
    M clusters (default K), drawn on the CPU from ``gen`` in field
    order: the server's draws, and the OO shim's when no noise is
    given."""
    k = min(k, n)
    return SelectNoise(cover=draw_gumbel(gen, (n,)),
                       cluster=draw_gumbel(gen, (k, k if m is None else m)),
                       client=draw_gumbel(gen, (k, n)),
                       cluster_pick=draw_gumbel(gen, (k, n)))


class Observations(NamedTuple):
    """What the server computed for the selector this round.

    bias_updates : (K, C) Δb of the round's participants, row-aligned
                   with ``ids`` (HiCS-FL).
    full_updates : (K, P) or (N, P) flattened model updates (CS, DivFL).
    losses       : (N,) global-model loss of every client (pow-d,
                   FedCor).
    """
    bias_updates: Optional[torch.Tensor] = None
    full_updates: Optional[torch.Tensor] = None
    losses: Optional[torch.Tensor] = None


class SelectorState(NamedTuple):
    """Every selector's round-to-round data; a selector's unused
    buffers have a zero-width axis."""
    weights: torch.Tensor       # (N,) normalized p_k
    seen: torch.Tensor          # (N,) bool — coverage pool complement
    unseen_count: torch.Tensor  # () int32
    delta_b: torch.Tensor       # (N, C) Δb buffer
    feats: torch.Tensor         # (N, F) full-update features, or (N, 0)
    losses: torch.Tensor        # (N,) latest loss poll
    loss_hist: torch.Tensor     # (H, N) loss-history ring, newest last
    hist_count: torch.Tensor    # () int32 — observations received
    dist_cache: torch.Tensor    # (N, N) cached distance, or (N, 0)
    row_stats: torch.Tensor     # (N, 2) cached [L2 norm, Ĥ or 0], or (N, 0)
    stale_ids: torch.Tensor     # (L,) int32 ring of staled rows, or (0,)
    stale_fill: torch.Tensor    # () int32 — ids appended since refresh


class FunctionalSelector(NamedTuple):
    name: str
    #: observations ``update`` reads: a subset of {"bias_sel",
    #: "loss_all", "full_sel", "full_all"}
    requires: FrozenSet[str]
    init: Callable[[], SelectorState]
    select: Callable[..., tuple]          # (state, t, noise) -> (ids, state)
    update: Callable[..., SelectorState]  # (state, t, ids, obs) -> state
    #: (state) -> (N,) Ĥ
    entropies: Optional[Callable[[SelectorState], torch.Tensor]] = None
    #: (state) -> {"cluster_sizes": (M,) int32, "cluster_ent_spread":
    #: ()}: clustering-health observables for the telemetry
    #: ``selection`` group; reads nothing on the host, like ``entropies``
    diagnostics: Optional[Callable[[SelectorState], dict]] = None
    #: observed full-update width P -> stored feature width F
    feat_width: Optional[Callable[[int], int]] = None
    #: clusters M of the two-stage sampler's noise; None: K
    num_clusters: Optional[int] = None


def state_entropies(fn: FunctionalSelector,
                    state: SelectorState) -> torch.Tensor:
    """(N,) Ĥ from a selector's state, or a (0,) tensor when the
    selector does not estimate entropies: the one extraction shared by
    the OO shim and the scanned round step."""
    if fn.entropies is None:
        return torch.zeros(0, device=state.weights.device)
    return fn.entropies(state)


def init_state(num_clients: int, weights=None, num_classes: int = 0,
               feat_dim: int = 0, hist_len: int = 0,
               dist_cache: bool = False, stale_len: int = 0,
               device="cuda") -> SelectorState:
    """A fresh state.  ``weights`` are normalized in f64 and again in
    f32, as the reference's shim and ``init_state`` do."""
    n = int(num_clients)
    if weights is None:
        w = torch.ones(n, dtype=torch.float32)
    else:
        w64 = torch.as_tensor(weights, dtype=torch.float64)
        w = (w64 / w64.sum()).float()
    w = (w / w.sum()).to(device)
    z32 = torch.zeros((), dtype=torch.int32, device=device)
    return SelectorState(
        weights=w,
        seen=torch.zeros(n, dtype=torch.bool, device=device),
        unseen_count=torch.tensor(n, dtype=torch.int32, device=device),
        delta_b=torch.zeros((n, int(num_classes)), device=device),
        feats=torch.zeros((n, int(feat_dim)), device=device),
        losses=torch.zeros(n, device=device),
        loss_hist=torch.zeros((int(hist_len), n), device=device),
        hist_count=z32,
        dist_cache=torch.zeros((n, n if dist_cache else 0), device=device),
        row_stats=torch.zeros((n, 2 if dist_cache else 0), device=device),
        stale_ids=torch.zeros(int(stale_len), dtype=torch.int32,
                              device=device),
        stale_fill=z32,
    )



def round_index(t, device=None) -> torch.Tensor:
    """Round ``t`` as a 0-d int32 tensor on ``device``; a tensor is
    returned as it is."""
    if isinstance(t, torch.Tensor):
        return t
    return torch.tensor(int(t), dtype=torch.int32, device=device)


#: depth of :func:`both_branches` blocks entered
_both_depth = [0]


@contextlib.contextmanager
def both_branches():
    """Within the block, :func:`cond` reads nothing on the host: it runs
    both branches and picks each output on the device."""
    _both_depth[0] += 1
    try:
        yield
    finally:
        _both_depth[0] -= 1


def _pick(pred: torch.Tensor, a, b):
    """``torch.where(pred, a, b)`` leaf by leaf; a leaf both branches
    return unchanged is kept as it is."""
    def leaf(x, y):
        if x is y:
            return x
        if x.shape != y.shape or x.dtype != y.dtype:
            raise TypeError(f"cond branches differ: {x.dtype}"
                            f"{tuple(x.shape)} vs {y.dtype}{tuple(y.shape)}")
        return torch.where(pred, x, y)

    return tree_map(leaf, a, b)


def cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable,
         *operands):
    """``true_fn(*operands)`` if the 0-d bool ``pred`` holds, else
    ``false_fn(*operands)``, as ``jax.lax.cond``.  Both branches return
    the same structure of tensors.  Outside :func:`both_branches` the
    predicate is read on the host (one scalar) and one branch runs;
    inside, both run and ``torch.where`` picks each output, so a branch
    must stay finite and in range on any state it may be given."""
    if _both_depth[0]:
        return _pick(pred, true_fn(*operands), false_fn(*operands))
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def mark_seen(state: SelectorState, ids: torch.Tensor) -> SelectorState:
    """Fold ``ids`` into the coverage pool (idempotent)."""
    seen = state.seen.index_fill(0, ids.long(), True)
    return state._replace(seen=seen,
                          unseen_count=(~seen).sum().to(torch.int32))


def stale_append(state: SelectorState, ids: torch.Tensor) -> SelectorState:
    """Append ``ids`` to the ring of staled rows the next refresh must
    cover; appends land at ``stale_fill mod L`` onward."""
    ids = ids.reshape(-1).to(torch.int32)
    kk, ring = ids.shape[0], state.stale_ids.shape[0]
    if kk == 0:
        return state
    if kk > ring:
        raise ValueError(
            f"incremental selector's staleness ring holds {ring} ids but "
            f"one update staled {kk}")
    pos = torch.remainder(
        state.stale_fill + torch.arange(kk, dtype=torch.int32,
                                        device=ids.device), ring)
    stale_ids = state.stale_ids.index_copy(0, pos.long(), ids)
    return state._replace(stale_ids=stale_ids,
                          stale_fill=state.stale_fill + kk)


def stale_clear(state: SelectorState) -> SelectorState:
    """Reset the staleness counter after a refresh covered the ring."""
    return state._replace(stale_fill=torch.zeros_like(state.stale_fill))


def refresh_cache(state: SelectorState, step) -> SelectorState:
    """Run ``step(state) -> (dist, stats)`` over the staled rows when
    any update staled a row since the last refresh (a :func:`cond` on
    ``stale_fill > 0``), then reset the ring's counter.  Shared by the
    incremental selectors (hics on Δb, cs and divfl on full-update
    features).  Before the first update the ring holds zeros: a
    refresh that :func:`both_branches` runs there is discarded."""
    dist, stats = cond(state.stale_fill > 0, step,
                       lambda st: (st.dist_cache, st.row_stats), state)
    return stale_clear(state._replace(dist_cache=dist, row_stats=stats))
