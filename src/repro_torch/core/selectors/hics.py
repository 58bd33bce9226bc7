"""HiCS-FL (Algorithm 1) as a functional triple.

While the coverage pool is not empty: a uniform sweep without
replacement (Alg. 1 lines 14-15).  Afterwards: agglomerative clustering
(``linkage`` ward, average, complete or single) into ``num_clusters``
= M groups (default K, any M from 1 to N) on the Eq. 9 distance and the
two-stage Eq. 10 sampler.

* ``incremental=True`` (default) keeps a cached (N, N) distance and
  (N, 2) [norm, Ĥ] stats; ``select`` first refreshes the rows that
  ``update`` staled (``hics_selection_step_cached``, the strip
  kernel), O(K·N·C) per round.
* ``incremental=False`` rebuilds the matrix each clustered round
  (``hics_selection_step``, the pairwise kernel), O(N²·C).

``gram_in_bf16`` rounds the two Gram operands to bf16 in both kernels
(f32 sums; the stats stay f32).  On the CPU the plain versions ignore
it and stay f32, as the reference's CPU oracle does.  ``stale_slots``
sizes the ring of staled ids, L = ``stale_slots``·K, so that up to
that many cohorts' updates (the async server's aggregations of M > K
arrivals) wait between refreshes; the refresh covers all L slots,
rows already fresh again (idempotent), repeated ids included.

Both run on the state's device: the CUDA kernels on the card, the
plain versions on the CPU.  The two branch tests go
through ``functional.cond``: one scalar read each per round in the
host loop, none in the scanned driver's
round step, where both branches run (every linkage on the sweep
rounds' zero cache is finite and discarded).  ``update`` reads
``obs.bias_updates``.
"""
from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.core.clustering import (agglomerate_device,
                                         check_linkage,
                                         cluster_means_device)
from repro_torch.core.hetero import estimate_entropy
from repro_torch.core.sampling import (anneal_device, coverage_sweep_device,
                                       hierarchical_sample_device)
from repro_torch.core.selectors.base import ClientSelector
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   Observations,
                                                   SelectNoise,
                                                   SelectorState, cond,
                                                   init_state, mark_seen,
                                                   refresh_cache,
                                                   stale_append)
from repro_torch.kernels import ops


def hics_functional(num_clients: int, num_select: int, total_rounds: int,
                    weights=None, temperature: float = 0.0025,
                    lam: float = 10.0, gamma0: float = 4.0,
                    num_clusters=None, linkage: str = "ward",
                    normalize: bool = False, gram_in_bf16: bool = False,
                    num_classes: int = 1, incremental: bool = True,
                    stale_slots: int = 1,
                    device="cuda", **_kw) -> FunctionalSelector:
    n = int(num_clients)
    k = min(int(num_select), n)
    m = int(num_clusters) if num_clusters else k
    check_linkage(linkage)
    stale_len = k * max(1, int(stale_slots))
    gram_in_bf16 = bool(gram_in_bf16)
    temperature, lam, gamma0 = float(temperature), float(lam), float(gamma0)
    tr = float(total_rounds)
    num_classes = max(1, int(num_classes))
    device = resolve_device(device)

    def init() -> SelectorState:
        return init_state(n, weights, num_classes=num_classes,
                          dist_cache=incremental,
                          stale_len=stale_len if incremental else 0,
                          device=device)

    def select(state: SelectorState, t: int, noise: SelectNoise):
        if incremental:
            state = refresh_cache(state, lambda st: (
                ops.hics_selection_step_cached(
                    st.delta_b, st.dist_cache, st.row_stats, st.stale_ids,
                    temperature, lam=lam, normalize=normalize,
                    gram_in_bf16=gram_in_bf16, device=device)[1:]))

        def sweep(state):
            ids = coverage_sweep_device(noise.cover, state.seen, k)
            return ids.to(torch.int32), mark_seen(state, ids)

        def clustered(state):
            if incremental:
                ent, dist = state.row_stats[:, 1], state.dist_cache
            else:
                ent, dist = ops.hics_selection_step(
                    state.delta_b, temperature, lam=lam,
                    normalize=normalize, gram_in_bf16=gram_in_bf16,
                    device=device)
            # the cache scatter and the pairwise kernel keep the matrix
            # exactly symmetric, so clustering skips re-symmetrizing
            labels = agglomerate_device(dist, m, linkage=linkage,
                                        precomputed=True)
            means = cluster_means_device(ent, labels, m)
            gamma_t = anneal_device(gamma0, t, tr, device=device)
            ids = hierarchical_sample_device(noise.cluster, noise.client,
                                             labels, means, state.weights,
                                             k, gamma_t)
            return ids, state

        return cond(state.unseen_count > 0, sweep, clustered, state)

    def update(state: SelectorState, t: int, ids: torch.Tensor,
               obs: Observations) -> SelectorState:
        if obs.bias_updates is None:
            return state
        db = state.delta_b.index_copy(
            0, ids.long(), obs.bias_updates.to(state.delta_b.dtype))
        state = mark_seen(state._replace(
            delta_b=db, hist_count=state.hist_count + 1), ids)
        if incremental:
            state = stale_append(state, ids)    # next select refreshes
        return state

    def entropies(state: SelectorState) -> torch.Tensor:
        return estimate_entropy(state.delta_b, temperature,
                                normalize=normalize)

    return FunctionalSelector("hics", frozenset({"bias_sel"}), init,
                              select, update, entropies=entropies,
                              num_clusters=m)


class HiCSFLSelector(ClientSelector):
    """Algorithm 1, the OO shim over :func:`hics_functional`."""

    name = "hics"
    requires = frozenset({"bias_sel"})

    def _make_functional(self, **kw) -> FunctionalSelector:
        return hics_functional(**kw)

    @property
    def _delta_b(self) -> torch.Tensor:
        """The state's (N, C) Δb buffer."""
        return self.state.delta_b
