"""The paper's five baseline selectors as functional triples.

    random : multinomial ∝ p_k without replacement
    pow-d  : sample d candidates ∝ p_k, keep the K largest-loss [8]
    cs     : Clustered Sampling [11], ward clustering of full updates
             under the angular distance
    divfl  : DivFL [2], greedy facility location on update distances
    fedcor : FedCor [28], GP over loss-history embeddings

The port of the reference's ``core/selectors/baselines.py``, with its
OO shims (``RandomSelector`` ... ``FedCorSelector``, over
``base.ClientSelector``).  Each select takes the round's
:class:`SelectNoise`; each branch test is a ``functional.cond``, one
scalar read from the device in the host loop and none in the scanned
driver's round step, where both branches run and must stay finite on
any state (ward on a zero cache, the GP on an empty loss history).
Given the same noise and observations the port picks the same ids as
the reference: top-k is a stable descending sort, argmax returns the
first maximum, and DivFL's gains round half to even.

CS and DivFL keep flattened full updates in an (N, F) feature buffer.
``proj_dim`` bounds F by a signed feature hash (Rademacher signs, then
contiguous bucket sums); the signs are an input (``proj_signs``, (P,)),
by default drawn from a torch generator seeded ``proj_seed``, since a
torch generator cannot give ``jax.random.rademacher``'s bits.
``incremental=True`` keeps a cached (N, N) distance and refreshes only
the rows the last ``update`` wrote, through the strip kernel with the
selector's own epilogue (``ops.cached_feature_step``: cosine for CS,
l2 for DivFL); ``incremental=False`` rebuilds the matrix from the
buffer each round with plain products, as the reference leaves them to
XLA.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.backend import resolve_device
from repro_torch.core.clustering import agglomerate_device
from repro_torch.core.sampling import (_topk_stable, coverage_sweep_device,
                                       weighted_sample_device)
from repro_torch.core.selectors.base import ClientSelector
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   Observations,
                                                   SelectNoise,
                                                   SelectorState, cond,
                                                   init_state, mark_seen,
                                                   refresh_cache,
                                                   round_index,
                                                   stale_append)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import COS_HI, COS_LO

_LOG_FLOOR = 1e-30


def rademacher(seed: int, p: int) -> torch.Tensor:
    """(P,) f32 signs ±1 from a torch generator seeded ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    return torch.randint(0, 2, (int(p),), generator=gen).float() * 2.0 - 1.0


def _make_projector(proj_dim: Optional[int], proj_seed: int,
                    proj_signs: Optional[torch.Tensor] = None
                    ) -> tuple[Callable, Callable[[int], int]]:
    """(project, feat_width): ``project`` maps (..., P) raw updates to
    (..., F) stored features, F = min(P, proj_dim), by multiplying with
    the (P,) signs and summing contiguous buckets of ceil(P / F);
    ``proj_dim=None`` is the identity."""
    if proj_dim is None:
        return (lambda u: u), (lambda p: p)
    f_cap = int(proj_dim)
    signs = {}

    def feat_width(p: int) -> int:
        return min(int(p), f_cap)

    def project(u: torch.Tensor) -> torch.Tensor:
        p = u.shape[-1]
        f = feat_width(p)
        if f == p:
            return u
        if p not in signs:
            s = rademacher(proj_seed, p) if proj_signs is None \
                else torch.as_tensor(proj_signs, dtype=torch.float32)
            if s.shape != (p,):
                raise ValueError(f"proj_signs must have shape ({p},), got "
                                 f"{tuple(s.shape)}")
            signs[p] = s.to(u.device)
        chunk = -(-p // f)
        u = F.pad(u * signs[p], (0, f * chunk - p))
        return u.reshape(*u.shape[:-1], f, chunk).sum(dim=-1)

    return project, feat_width


# ---------------------------------------------------------------------------
# random
# ---------------------------------------------------------------------------


def random_functional(num_clients: int, num_select: int, total_rounds: int,
                      weights=None, device="cuda",
                      **_kw) -> FunctionalSelector:
    n = int(num_clients)
    k = min(int(num_select), n)
    device = resolve_device(device)

    def init():
        return init_state(n, weights, device=device)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        ids = weighted_sample_device(noise.cover, state.weights, k)
        return ids.to(torch.int32), state

    def update(state, t, ids, obs: Observations):
        return state

    return FunctionalSelector("random", frozenset(), init, select, update)


# ---------------------------------------------------------------------------
# pow-d
# ---------------------------------------------------------------------------


def powd_functional(num_clients: int, num_select: int, total_rounds: int,
                    weights=None, d: Optional[int] = None, device="cuda",
                    **_kw) -> FunctionalSelector:
    n = int(num_clients)
    k = min(int(num_select), n)
    d = n if d is None else min(int(d), n)
    device = resolve_device(device)

    def init():
        return init_state(n, weights, device=device)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        def cold():
            ids = weighted_sample_device(noise.cover, state.weights, k)
            return ids.to(torch.int32)

        def warm():
            cand = weighted_sample_device(noise.cover, state.weights, d)
            in_cand = torch.zeros(n, dtype=torch.bool,
                                  device=device).index_fill(0, cand, True)
            masked = torch.where(in_cand, state.losses, -torch.inf)
            return _topk_stable(masked, k).to(torch.int32)

        return cond((state.losses != 0).any(), warm, cold), state

    def update(state, t, ids, obs: Observations):
        if obs.losses is None:
            return state
        return state._replace(losses=obs.losses.float(),
                              hist_count=state.hist_count + 1)

    return FunctionalSelector("pow-d", frozenset({"loss_all"}), init,
                              select, update)


# ---------------------------------------------------------------------------
# cs (Clustered Sampling)
# ---------------------------------------------------------------------------


def _angular_scratch(f: torch.Tensor) -> torch.Tensor:
    """The reference's from-scratch angular distance of the rows of f,
    diagonal zeroed."""
    norms = torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    unit = f / torch.clamp(norms, min=1e-8)
    ang = torch.arccos(torch.clamp(unit @ unit.T, COS_LO, COS_HI))
    eye = torch.eye(f.shape[0], dtype=torch.bool, device=f.device)
    return torch.where(eye, 0.0, ang)


def _l2_scratch(g: torch.Tensor) -> torch.Tensor:
    """The reference's from-scratch Euclidean distance of the rows of
    g (its diagonal is not zeroed)."""
    sq = (g * g).sum(dim=1)
    return torch.sqrt(torch.clamp(
        sq[:, None] + sq[None, :] - 2.0 * (g @ g.T), min=0.0))


def cs_functional(num_clients: int, num_select: int, total_rounds: int,
                  weights=None, feat_dim: int = 1,
                  proj_dim: Optional[int] = None, proj_seed: int = 0,
                  proj_signs: Optional[torch.Tensor] = None,
                  incremental: bool = True, stale_slots: int = 1,
                  device="cuda", **_kw) -> FunctionalSelector:
    """Clustered Sampling [11]: ward clustering of the participants'
    full updates under the angular distance, one pick per cluster ∝
    p_k.  ``feat_dim`` is the raw flattened-update width the server
    observes.  ``stale_slots`` sizes the ring of staled ids, L =
    ``stale_slots``·K (see ``hics_functional``)."""
    n = int(num_clients)
    k = min(int(num_select), n)
    stale_len = k * max(1, int(stale_slots))
    project, feat_width = _make_projector(proj_dim, proj_seed, proj_signs)
    f_dim = max(1, feat_width(int(feat_dim)))
    incremental = bool(incremental)
    device = resolve_device(device)

    def init():
        return init_state(n, weights, feat_dim=f_dim,
                          dist_cache=incremental,
                          stale_len=stale_len if incremental else 0, device=device)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        if incremental:
            state = refresh_cache(state, lambda st: ops.cached_feature_step(
                st.feats, st.dist_cache, st.row_stats, st.stale_ids,
                metric="cosine", device=device))

        def sweep():
            # coverage first, as Alg. 1's first rounds
            ids = coverage_sweep_device(noise.cover, state.seen, k)
            return ids.to(torch.int32)

        def clustered():
            ang = (state.dist_cache if incremental
                   else _angular_scratch(state.feats))
            # exactly symmetric by construction: skip re-symmetrizing
            labels = agglomerate_device(ang, k, precomputed=True)
            logw = torch.log(torch.clamp(state.weights, min=_LOG_FLOOR))
            member = (labels.long()[None, :]
                      == torch.arange(k, device=device)[:, None])
            logit = torch.where(member, logw[None, :], -torch.inf)
            ids = torch.argmax(logit + noise.cluster_pick, dim=1)
            return ids.to(torch.int32)

        return cond(state.unseen_count > 0, sweep, clustered), state

    def update(state, t, ids, obs: Observations):
        if obs.full_updates is None:
            return state
        feats = state.feats.index_copy(0, ids.long(),
                                       project(obs.full_updates.float()))
        state = mark_seen(state._replace(
            feats=feats, hist_count=state.hist_count + 1), ids)
        if incremental:
            state = stale_append(state, ids)
        return state

    return FunctionalSelector("cs", frozenset({"full_sel"}), init, select,
                              update, feat_width=feat_width)


# ---------------------------------------------------------------------------
# divfl
# ---------------------------------------------------------------------------


def facility_location(dist: torch.Tensor, k: int, tie_quant: float,
                      gains_out: Optional[list] = None) -> torch.Tensor:
    """DivFL's greedy facility location: K picks minimizing
    Σ_i min_{j∈S} dist(i, j), with the gains quantized as
    :func:`divfl_functional` says.  ``gains_out``, when given, receives
    each step's (N,) quantized gains."""
    n = dist.shape[0]
    chosen = []
    taken = torch.zeros(n, dtype=torch.bool, device=dist.device)
    cover = torch.full((n,), torch.inf, device=dist.device)
    for _ in range(min(k, n)):
        gains = torch.clamp(cover[None, :] - dist, min=0.0).sum(dim=1)
        if tie_quant > 0.0:
            scale = torch.clamp(gains.abs().max(),
                                min=_LOG_FLOOR) * tie_quant
            gains = torch.round(gains / scale)
            gains = torch.where(torch.isnan(gains), torch.inf, gains)
        if gains_out is not None:
            gains_out.append(gains)
        j = torch.argmax(torch.where(taken, -torch.inf, gains))
        chosen.append(j)
        taken = taken.index_fill(0, j[None], True)
        cover = torch.minimum(cover, dist.index_select(0, j[None])[0])
    return torch.stack(chosen).to(torch.int32)


def divfl_functional(num_clients: int, num_select: int, total_rounds: int,
                     weights=None, feat_dim: int = 1,
                     proj_dim: Optional[int] = None, proj_seed: int = 0,
                     proj_signs: Optional[torch.Tensor] = None,
                     refresh: str = "all", incremental: bool = True,
                     stale_slots: int = 1, tie_quant: float = 1e-5,
                     device="cuda", **_kw) -> FunctionalSelector:
    """DivFL [2]: greedy facility location on pairwise L2 distances of
    flattened updates.

    ``refresh="all"`` (ideal setting): a one-epoch update of every
    client replaces the whole feature buffer each round (``requires =
    full_all``); the matrix is rebuilt each round and ``incremental``
    is ignored.  ``refresh="selected"``: only the participants' rows
    change (``requires = full_sel``), after a coverage sweep, and the
    K-row l2 cache serves the distances.

    ``tie_quant`` quantizes the marginal gains to ``tie_quant`` ×
    max|gain| (rounded half to even) before the argmax, so exact ties
    break toward the smallest id.  In the first greedy step every gain
    is +inf and the reference's quotient inf/inf is NaN, which its
    argmax takes as the maximum; the port maps NaN to +inf, which
    picks the same first index.  ``stale_slots`` sizes the ring of
    staled ids, L = ``stale_slots``·K (see ``hics_functional``)."""
    n = int(num_clients)
    k = min(int(num_select), n)
    stale_len = k * max(1, int(stale_slots))
    if refresh not in ("all", "selected"):
        raise ValueError(f"refresh must be 'all' or 'selected', got "
                         f"{refresh!r}")
    selected_only = refresh == "selected"
    project, feat_width = _make_projector(proj_dim, proj_seed, proj_signs)
    f_dim = max(1, feat_width(int(feat_dim)))
    incremental = bool(incremental) and selected_only
    tie_quant = float(tie_quant)
    device = resolve_device(device)

    def init():
        return init_state(n, weights, feat_dim=f_dim,
                          dist_cache=incremental,
                          stale_len=stale_len if incremental else 0, device=device)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        if incremental:
            state = refresh_cache(state, lambda st: ops.cached_feature_step(
                st.feats, st.dist_cache, st.row_stats, st.stale_ids,
                metric="l2", device=device))

        def cold():
            if selected_only:
                # poll everyone once before trusting the distances
                ids = coverage_sweep_device(noise.cover, state.seen, k)
            else:
                ids = weighted_sample_device(noise.cover, state.weights, k)
            return ids.to(torch.int32)

        def warm():
            dist = (state.dist_cache if incremental
                    else _l2_scratch(state.feats))
            return facility_location(dist, k, tie_quant)

        warm_ok = (state.unseen_count == 0 if selected_only
                   else state.hist_count > 0)
        return cond(warm_ok, warm, cold), state

    def update(state, t, ids, obs: Observations):
        if obs.full_updates is None:
            return state
        raw = obs.full_updates.float()
        if selected_only:
            # the participants' rows only (gathered before projecting)
            rows = project(raw[ids.long()] if raw.shape[0] == n else raw)
            state = mark_seen(state._replace(
                feats=state.feats.index_copy(0, ids.long(), rows),
                hist_count=state.hist_count + 1), ids)
            if incremental:
                state = stale_append(state, ids)
            return state
        # ideal setting: only a full (N, P) poll refreshes the buffer
        if raw.shape[0] != n:
            return state
        return state._replace(feats=project(raw),
                              hist_count=state.hist_count + 1)

    requires = frozenset({"full_sel" if selected_only else "full_all"})
    return FunctionalSelector("divfl", requires, init, select, update,
                              feat_width=feat_width)


# ---------------------------------------------------------------------------
# fedcor
# ---------------------------------------------------------------------------


def fedcor_functional(num_clients: int, num_select: int, total_rounds: int,
                      weights=None, warmup: int = 10, beta: float = 0.9,
                      length_scale: float = 1.0, hist_len: int = 8,
                      device="cuda", **_kw) -> FunctionalSelector:
    n = int(num_clients)
    k = min(int(num_select), n)
    warmup, beta, ls = int(warmup), float(beta), float(length_scale)
    h_len = int(hist_len)
    device = resolve_device(device)

    def init():
        return init_state(n, weights, hist_len=h_len, device=device)

    def warm(state: SelectorState, t: torch.Tensor) -> torch.Tensor:
        # standardized loss-history embedding over the valid ring
        x = state.loss_hist.T                           # (N, H), newest last
        valid = (torch.arange(h_len, device=device)
                 >= h_len - torch.clamp(state.hist_count, max=h_len)
                 ).float()
        cnt = torch.clamp(valid.sum(), min=1.0)
        mu = (x * valid).sum(dim=1, keepdim=True) / cnt
        var = torch.square((x - mu) * valid).sum(dim=1, keepdim=True) / cnt
        xs = (x - mu) / (torch.sqrt(var) + 1e-8) * valid
        d2 = torch.square(xs[:, None, :] - xs[None, :, :]).sum(dim=-1)
        kmat = torch.exp(-d2 / (2.0 * ls * ls))
        w_t = torch.pow(beta, torch.clamp(t - warmup, min=0).float())
        kmat = w_t * kmat + (1.0 - w_t) * torch.eye(n, device=device)

        # greedy max variance reduction weighted by the current losses
        chosen = []
        taken = torch.zeros(n, dtype=torch.bool, device=device)
        var_d, cov = torch.diagonal(kmat), kmat
        for _ in range(k):
            score = torch.where(taken, -torch.inf,
                                var_d * (1.0 + state.losses))
            j = torch.argmax(score)
            chosen.append(j)
            # gathers by index tensor: no scalar crosses to the host
            cj = cov.index_select(1, j[None])[:, 0]
            denom = cj.index_select(0, j[None])[0] + 1e-8
            taken = taken.index_fill(0, j[None], True)
            var_d = var_d - cj * cj / denom
            cov = cov - torch.outer(cj, cj) / denom
        return torch.stack(chosen).to(torch.int32)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        t = round_index(t, device)

        def cold():
            ids = weighted_sample_device(noise.cover, state.weights, k)
            return ids.to(torch.int32)

        ids = cond((t >= warmup) & (state.hist_count >= 2),
                   lambda: warm(state, t), cold)
        return ids, state

    def update(state, t, ids, obs: Observations):
        if obs.losses is None:
            return state
        losses = obs.losses.float()
        hist = torch.roll(state.loss_hist, -1, dims=0)
        hist[-1] = losses
        return state._replace(losses=losses, loss_hist=hist,
                              hist_count=state.hist_count + 1)

    return FunctionalSelector("fedcor", frozenset({"loss_all"}), init,
                              select, update)


# ---------------------------------------------------------------------------
# OO shims
# ---------------------------------------------------------------------------


class RandomSelector(ClientSelector):
    """FedProx-style multinomial sampling ∝ p_k, without replacement."""
    name = "random"

    def _make_functional(self, **kw):
        return random_functional(**kw)


class PowerOfChoiceSelector(ClientSelector):
    """pow-d [8], ideal setting (App. A.1.2): d = N, the server polls
    every client's current local loss each round."""
    name = "pow-d"
    requires = frozenset({"loss_all"})

    def _make_functional(self, **kw):
        return powd_functional(**kw)


class ClusteredSamplingSelector(ClientSelector):
    """Clustered Sampling [11] on full updates."""
    name = "cs"
    requires = frozenset({"full_sel"})

    def _make_functional(self, **kw):
        return cs_functional(**kw)


class DivFLSelector(ClientSelector):
    """DivFL [2]: greedy facility location; the ideal setting polls
    every client, ``refresh="selected"`` the participants."""
    name = "divfl"
    requires = frozenset({"full_all"})

    def _make_functional(self, **kw):
        return divfl_functional(**kw)


class FedCorSelector(ClientSelector):
    """FedCor [28]: a GP over loss-history embeddings."""
    name = "fedcor"
    requires = frozenset({"loss_all"})

    def _make_functional(self, **kw):
        return fedcor_functional(**kw)
