"""OO shim layer: the reference's stateful ``ClientSelector`` API over
the functional core.

Each class is a thin wrapper around its :class:`FunctionalSelector`
triple: ``select`` and ``update`` keep the reference's signatures
(``update`` takes ``bias_updates=/full_updates=/losses=`` and folds
them into :class:`Observations`), and the wrapper owns the
``SelectorState``.  Randomness stays an input: ``select(t, noise)``
takes the round's :class:`SelectNoise`, the counterpart of the
reference's ``key=`` override; without it the shim draws the noise
from its own CPU generator seeded by ``seed``, as the server draws it
(``functional.draw_select_noise``).  ``sel.fn`` and ``sel.state`` reach
the functional core.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   Observations,
                                                   SelectNoise,
                                                   SelectorState,
                                                   draw_select_noise,
                                                   round_index,
                                                   state_entropies)


class ClientSelector:
    """Stateful shim; subclasses plug in a functional factory.

    ``requires`` (what the server must compute for the selector each
    round: a subset of {"loss_all", "full_all", "full_sel",
    "bias_sel"}) is the functional's, since factory kwargs can move a
    selector between requirement classes (divfl's refresh="selected").
    """

    name = "base"
    requires: frozenset = frozenset()

    def __init__(self, num_clients: int, num_select: int, total_rounds: int,
                 weights: Optional[Sequence[float]] = None, seed: int = 0,
                 device="cuda", **kw):
        self.n = int(num_clients)
        self.k = int(num_select)
        self.total_rounds = int(total_rounds)
        self.device = resolve_device(device)
        w = np.ones(self.n) if weights is None else np.asarray(
            weights, dtype=np.float64)
        self.weights = w / w.sum()
        self.fn: FunctionalSelector = self._make_functional(
            num_clients=self.n, num_select=self.k,
            total_rounds=self.total_rounds, weights=self.weights,
            device=self.device, **kw)
        self.requires = self.fn.requires
        self.gen = torch.Generator().manual_seed(int(seed))
        self.state: SelectorState = self.fn.init()
        self.select_seconds = 0.0      # cumulative selection time
        self.update_seconds = 0.0
        # the staled-id ring holds stale_slots·K ids: updates staling
        # more than that without a select between them would wrap
        # around and leave the earliest cohort's cached rows stale, so
        # the shim fails fast instead
        self._stale_pending = 0

    # -- functional factory (override) ---------------------------------
    def _make_functional(self, **kw) -> FunctionalSelector:
        raise NotImplementedError

    # -- public API ----------------------------------------------------
    def select(self, t: int, noise: Optional[SelectNoise] = None
               ) -> List[int]:
        """Round t's participants.  ``noise`` overrides the shim's own
        draws (a driver or a test replaying another run's)."""
        t0 = time.perf_counter()
        if noise is None:
            noise = draw_select_noise(self.gen, self.n, self.k,
                                      self.fn.num_clusters)
        noise = SelectNoise(*(a.to(self.device) for a in noise))
        ids, self.state = self.fn.select(
            self.state, round_index(t, self.device), noise)
        self._stale_pending = 0            # select refreshed the cache
        out = [int(i) for i in ids.tolist()]
        self.select_seconds += time.perf_counter() - t0
        return out

    def update(self, t: int, selected: Sequence[int],
               observations: Optional[Observations] = None, *,
               bias_updates=None, full_updates=None, losses=None) -> None:
        t0 = time.perf_counter()
        req = self.fn.requires
        if observations is not None:
            obs = observations
        else:
            # only the fields this selector's ``requires`` reads
            def take(x, needed):
                return (torch.as_tensor(x, dtype=torch.float32,
                                        device=self.device)
                        if x is not None and needed else None)

            obs = Observations(
                bias_updates=take(bias_updates, "bias_sel" in req),
                full_updates=take(full_updates,
                                  bool(req & {"full_all", "full_sel"})),
                losses=take(losses, "loss_all" in req))
        ids = torch.tensor(list(selected), dtype=torch.int32,
                           device=self.device)
        # an update stales cached rows when the selector has a staleness
        # ring and this observation writes the buffer it caches over
        ring = int(self.state.stale_ids.shape[0])
        stales = ring and (
            (obs.bias_updates is not None and "bias_sel" in req)
            or (obs.full_updates is not None
                and bool(req & {"full_all", "full_sel"})))
        if stales:
            if self._stale_pending + len(ids) > ring:
                raise RuntimeError(
                    f"{self.name}: update() would stale "
                    f"{self._stale_pending + len(ids)} cached rows but "
                    f"the staled-id ring holds {ring} — ids from an "
                    "earlier cohort would be overwritten and their "
                    "rows silently stay stale without an "
                    "intervening select(). Call select() between "
                    "updates, construct the selector with a larger "
                    "stale_slots, or with incremental=False.")
            self._stale_pending += len(ids)
        self.state = self._ensure_dims(self.state, obs)
        self.state = self.fn.update(self.state, round_index(t, self.device),
                                    ids, obs)
        self.update_seconds += time.perf_counter() - t0

    # -- helpers -------------------------------------------------------
    def _ensure_dims(self, state: SelectorState,
                     obs: Observations) -> SelectorState:
        """Grow zero-width state buffers to the observed feature widths
        (standalone use: the server sizes them at init).  Only buffers
        this selector's ``requires`` reads are grown."""
        req = self.fn.requires
        if (obs.bias_updates is not None and "bias_sel" in req
                and state.delta_b.shape[1] != obs.bias_updates.shape[-1]):
            state = state._replace(delta_b=torch.zeros(
                (self.n, obs.bias_updates.shape[-1]), device=self.device))
        if obs.full_updates is not None and req & {"full_all", "full_sel"}:
            # a selector that down-projects stores features narrower
            # than the observations (fn.feat_width maps P -> F)
            fw = self.fn.feat_width or (lambda p: p)
            want = fw(obs.full_updates.shape[-1])
            if state.feats.shape[1] != want:
                state = state._replace(feats=torch.zeros(
                    (self.n, want), device=self.device))
        return state

    def estimated_entropies(self) -> Optional[np.ndarray]:
        """Latest Ĥ per client, or None before any observation or for a
        selector that does not estimate entropies."""
        if int(self.state.hist_count) == 0:
            return None
        ent = state_entropies(self.fn, self.state)
        return ent.cpu().numpy() if ent.shape[0] else None
