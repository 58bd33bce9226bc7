"""Buffered-async federated server: FedBuff-style aggregation with
staleness-aware selection, one functional step a tick.

The port of the reference's ``fed/async_server.py``.  Per tick t (one
step that reads nothing on the host):

  1. DISPATCH — select a cohort of K clients (the sync drivers'
     functional selector, under the availability schedule when there
     is one), run their local updates against the CURRENT global params
     and stamp each contribution with the server ``version``.  The
     contribution (local params and Δb row) enters the in-flight pool
     at row ``t mod W`` with an arrival tick ``t + delay`` from the
     latency model's delay tables (``repro_torch.fed.latency``):
     arrival order is data, so the tick is one captured graph.
  2. ARRIVALS — pool entries whose arrival tick is t are pushed,
     oldest-dispatch-first, into the fixed-capacity ring buffer
     (``repro_torch.fed.buffer``).  Overflow is dropped AND counted.
  3. AGGREGATE — when ``fill >= threshold`` fires, the M oldest entries
     pop (FIFO) and fold into the global params by staleness-weighted
     averaging: ``age = version_now − version_at_dispatch``, weight
     ``w = (1 + age)^−β`` (``β = 0`` is the plain mean; ``server_mix``
     optionally anchors to the previous params).  The selector's
     ``update`` then consumes the popped cohort; duplicate client ids
     across buffered cohorts resolve NEWEST-WINS before its scatter, so
     the write is deterministic, and the staled-id ring
     (``stale_slots`` cohorts wide) records up to M rows for the next
     select's cache refresh.  The fire test is a ``functional.cond``:
     the step runs both branches and picks on the device.

Each tick consumes the sync server's draws for that round (the
selector's Gumbel draws, the cohort's epoch permutations) plus the
latency table's jitter row, so with the identity latency model and
``capacity = threshold = K`` every tick fires with all ages 0, the
weights are exactly 1.0, ``aggregate_params`` reduces bit-identically
to the sync mean and the async run IS the sync scanned run, bit for
bit.  On the card each tick replays one captured CUDA graph (the sync
server's ``RoundGraph``); on the CPU the same step runs eagerly.

``full_all`` selectors (DivFL's ideal all-clients poll) are refused:
an every-tick N-client poll has no async semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.hetero import (head_bias_updates_stacked,
                                     head_num_classes)
from repro_torch.core.selectors import Observations
from repro_torch.core.selectors.functional import (both_branches, cond,
                                                   state_entropies)
from repro_torch.fed.buffer import buffer_init, buffer_pop, buffer_push
from repro_torch.fed.client import LocalSpec
from repro_torch.fed.latency import LatencySpec, delay_tables, max_delay
from repro_torch.fed.server import (FedConfig, FederatedServer, RoundDraws,
                                    aggregate_params, full_sel_updates)
from repro_torch.optim import tree_map
from repro_torch.telemetry import MetricsSpec

#: the observations the async tick can make on the device
ASYNC_SCANNABLE = frozenset({"bias_sel", "loss_all", "full_sel"})


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    num_clients: int = 50
    num_select: int = 5          # cohort size dispatched per tick
    ticks: int = 100             # ticks (≈ sync "rounds")
    selector: str = "hics"
    selector_kw: Optional[Dict[str, Any]] = None
    local: LocalSpec = dataclasses.field(default_factory=LocalSpec)
    capacity: int = 0            # ring-buffer capacity B (0 → K)
    threshold: int = 0           # aggregation fill threshold M (0 → K)
    beta: float = 0.5            # staleness exponent in (1+age)^−beta
    server_mix: float = 0.0      # θ ← (1−mix)·agg + mix·θ_prev
    latency: LatencySpec = dataclasses.field(default_factory=LatencySpec)
    max_lag: int = 16            # delay clip → in-flight window W−1
    eval_every: int = 5
    seed: int = 0
    lr_decay_every: int = 10
    lr_decay: float = 0.5
    #: telemetry metric groups to record (``repro_torch.telemetry.
    #: GROUPS``, ``async`` included); () is off
    telemetry: tuple = ()

    def __post_init__(self):
        MetricsSpec(tuple(self.telemetry))     # an unknown group raises

    def sizes(self):
        """Resolved (K, B, M) with the 0 → K defaults applied."""
        k = int(self.num_select)
        b = int(self.capacity) or k
        m = int(self.threshold) or k
        if m < 1 or m > b:
            raise ValueError(f"threshold must be in [1, capacity]: "
                             f"M={m}, B={b}")
        return k, b, m


def check_async_selector(name: str, requires) -> None:
    """The reference's refusal of a selector the tick cannot serve."""
    unmet = frozenset(requires) - ASYNC_SCANNABLE
    if unmet:
        raise ValueError(
            f"async server unsupported for selector {name!r} (needs "
            f"{sorted(unmet)}; an every-tick all-clients poll has no "
            "async semantics)")


class InFlightPool(NamedTuple):
    """Dispatched-but-not-arrived contributions: one row per tick in a
    W-deep window (W = max delay + 1), K slots a row.  Tick t writes
    row ``t mod W``: every earlier occupant of that row arrived at
    least one tick ago (delays are clipped to W − 1)."""
    payload: Any              # dict tree, leaves (W, K, ...)
    ids: torch.Tensor         # (W, K) int32
    version: torch.Tensor     # (W, K) int32
    arrive: torch.Tensor      # (W, K) int32 — absolute arrival tick
    live: torch.Tensor        # (W, K) bool


def pool_init(window: int, k: int, payload_proto: Any,
              device) -> InFlightPool:
    payload = tree_map(lambda l: torch.zeros(
        (window, k) + tuple(l.shape), dtype=l.dtype, device=device),
        payload_proto)
    z32 = lambda: torch.zeros((window, k), dtype=torch.int32, device=device)
    return InFlightPool(
        payload=payload, ids=z32(), version=z32(),
        arrive=torch.full((window, k), -1, dtype=torch.int32,
                          device=device),
        live=torch.zeros((window, k), dtype=torch.bool, device=device))


def make_tick_step(cfg: AsyncConfig, server: FederatedServer,
                   base_delay: torch.Tensor, window: int):
    """The async tick for ``server`` (its selector, select, local
    update, data and metrics step), ``((params, extras, state, t,
    telemetry carry, pool, buffer, version), draws) -> (carry after the
    tick, (ids, mean train loss, Ĥ or (0,), fired, fill, accepted,
    dropped, version, telemetry dict))``, and ``init_runtime(params)
    -> (pool, buffer)``."""
    k, b, m = cfg.sizes()
    w = int(window)
    beta, mix = float(cfg.beta), float(cfg.server_mix)
    fn = server.selector
    check_async_selector(fn.name, fn.requires)
    need_losses = "loss_all" in fn.requires
    need_full_sel = "full_sel" in fn.requires
    dev = server.device

    def init_runtime(params):
        c = head_num_classes(params) or 1
        proto = {"params": params,
                 "delta_b": torch.zeros(c, dtype=torch.float32,
                                        device=dev)}
        return pool_init(w, k, proto, dev), buffer_init(b, proto)

    def aggregate(params, state, buf, version, t):
        popped, pids, pver, buf = buffer_pop(buf, m)
        ages = (version - pver).to(torch.float32)
        agg = aggregate_params(popped["params"],
                               torch.pow(1.0 + ages, -beta))
        if mix > 0.0:
            agg = tree_map(lambda a, p: (1.0 - mix) * a + mix * p, agg,
                           params)
        # duplicate ids across buffered cohorts: newest wins (each row
        # takes the row of its id's last occurrence; the max is unique)
        same = (pids[None, :] == pids[:, None]).to(torch.float32)
        rank = torch.arange(1, m + 1, dtype=torch.float32, device=dev)
        win = torch.argmax(same * rank[None, :], dim=1)
        obs = Observations(
            bias_updates=popped["delta_b"].index_select(0, win),
            full_updates=(full_sel_updates(agg, popped["params"])
                          .index_select(0, win) if need_full_sel else None),
            losses=(server._poll(agg, server.x, server.y, server.mask)
                    if need_losses else None))
        state = fn.update(state, t, pids, obs)
        return agg, state, buf, version + 1, ages

    def idle(params, state, buf, version, t):
        return params, state, buf, version, torch.full(
            (m,), -1.0, device=dev)

    ar_k = torch.arange(k, device=dev)
    ar_w = torch.arange(w, device=dev)
    ar_b = torch.arange(b, dtype=torch.int32, device=dev)
    want_async = server._metrics.spec.enabled("async")

    def version_lag(buf, version):
        """The server version minus the oldest buffered entry's (0 when
        the buffer is empty)."""
        live_ver = torch.where(
            ar_b < buf.fill,
            buf.version.index_select(
                0, torch.remainder(buf.head + ar_b, b).long()),
            torch.iinfo(torch.int32).max)
        return torch.where(buf.fill > 0, version - live_ver.min(),
                           torch.zeros_like(version))

    def tick_step(carry, rd: RoundDraws):
        params, extras, state, t, telc, pool, buf, version = carry
        params_before = params
        with both_branches():
            # -- 1. dispatch ----------------------------------------------
            ids, state = server.select(state, t, rd)
            new_params, new_extras, metrics = server.local_update(
                t, ids, rd.perms, params, extras)
            idx = ids.long()
            # client-local algorithm state (feddyn h, moon prev) updates
            # when the client trains, at dispatch, not at arrival
            extras = tree_map(lambda a, v: a.index_copy(0, idx, v),
                              extras, new_extras)
            db = head_bias_updates_stacked(params, new_params)
            if db is None:
                db = torch.zeros((k, 1), device=dev)
            delay = torch.clamp(base_delay.index_select(0, idx) + rd.jitter,
                                0, w - 1)
            row = torch.remainder(t, w).long().reshape(1)
            entry = {"params": new_params, "delta_b": db}
            put = lambda dst, src: dst.index_copy(0, row, src[None])
            pool = InFlightPool(
                payload=tree_map(put, pool.payload, entry),
                ids=put(pool.ids, ids.to(torch.int32)),
                version=put(pool.version, version.expand(k)),
                arrive=put(pool.arrive, (t + delay).to(torch.int32)),
                live=put(pool.live, torch.ones(k, dtype=torch.bool,
                                               device=dev)))

            # -- 2. arrivals, oldest dispatch first ---------------------
            order = torch.remainder(t + 1 + ar_w, w).long()
            arriving = pool.live & (pool.arrive == t)
            flat = lambda l: l.index_select(0, order).reshape(w * k)
            rows = (order[:, None] * k + ar_k[None, :]).reshape(w * k)
            buf, accepted, dropped = buffer_push(
                buf, flat(arriving),
                tree_map(lambda l: l.reshape((w * k,) + l.shape[2:]),
                         pool.payload),
                flat(pool.ids), flat(pool.version), row_index=rows)
            pool = pool._replace(live=pool.live & ~arriving)

            # -- 3. aggregate -------------------------------------------
            fire = buf.fill >= m
            params, state, buf, version, ages = cond(
                fire, aggregate, idle, params, state, buf, version, t)
            ent = state_entropies(fn, state)
            ctx = server.telemetry_ctx(t, ids, state, metrics,
                                       params_before, params,
                                       new_params, db)
            if want_async:
                ctx = ctx._replace(
                    fired=fire, fill=buf.fill, accepted=accepted,
                    dropped=dropped, version=version,
                    version_lag=version_lag(buf, version), agg_ages=ages)
            telc, tel = server._metrics.step(telc, ctx)
        return ((params, extras, state, t + 1, telc, pool, buf, version),
                (ids, ctx.train_loss, ent, fire, buf.fill, accepted,
                 dropped, version, tel))

    return tick_step, init_runtime


class AsyncFederatedServer(FederatedServer):
    """Drives T async ticks over padded client data: the buffered
    counterpart of :class:`FederatedServer`, drawing from the same
    generator in the same order (the initial params, then one round's
    draws a tick), so the identity-latency configuration is the sync
    scanned run bit for bit.  The tick runs in segments of
    ``eval_every`` (all ticks in one without a test set), one captured
    CUDA graph a tick on the card, eagerly on the CPU."""

    _span = "fed/async_tick_segment"

    def __init__(self, init_fn, apply_fn, cfg: AsyncConfig,
                 client_x: np.ndarray, client_y: np.ndarray,
                 client_mask: np.ndarray,
                 test: Optional[Dict[str, np.ndarray]] = None,
                 device="cuda", features_fn=None, availability=None):
        k, b, m = cfg.sizes()
        kw = dict(cfg.selector_kw or {})
        # the staled-id ring must cover one aggregation's M ids
        kw.setdefault("stale_slots", -(-m // k))
        fed = FedConfig(
            num_clients=cfg.num_clients, num_select=k, rounds=cfg.ticks,
            selector=cfg.selector, selector_kw=kw, local=cfg.local,
            eval_every=cfg.eval_every, seed=cfg.seed,
            lr_decay_every=cfg.lr_decay_every, lr_decay=cfg.lr_decay,
            jit_rounds=True, telemetry=tuple(cfg.telemetry))
        super().__init__(init_fn, apply_fn, fed, client_x, client_y,
                         client_mask, test=test, device=device,
                         features_fn=features_fn, availability=availability)
        check_async_selector(cfg.selector, self.requires)
        self.acfg = cfg
        base, jitter = delay_tables(cfg.latency, cfg.num_clients, cfg.ticks,
                                    k)
        self._window = max_delay(cfg.latency, base, jitter,
                                 cfg.max_lag) + 1
        self._jitter = torch.as_tensor(
            np.clip(jitter, 0, self._window - 1), dtype=torch.int32)
        self._base_delay = torch.as_tensor(base, dtype=torch.int32,
                                           device=self.device)
        self._tick_step, init_runtime = make_tick_step(
            cfg, self, self._base_delay, self._window)
        self.pool, self.buffer = init_runtime(self.params)
        self.version = torch.zeros((), dtype=torch.int32,
                                   device=self.device)
        for key in ("fired", "buffer_fill", "accepted", "dropped",
                    "version"):
            self.history[key] = []

    def _draw_host(self, t: int) -> RoundDraws:
        """Round t's draws, with the tick's jitter row."""
        return super()._draw_host(t)._replace(jitter=self._jitter[t])

    def _make_round_step(self):
        return self._tick_step

    def _initial_carry(self) -> tuple:
        return super()._initial_carry() + (self.pool, self.buffer,
                                           self.version)

    def _store_carry(self, carry) -> None:
        super()._store_carry(carry)
        self.pool, self.buffer, self.version = carry[5:]

    def _record(self, t: int, outs: list) -> None:
        super()._record(t, outs[:3])
        fired, fill, acc, drop, ver = outs[3:]
        self.history["fired"].extend(bool(f) for f in fired)
        self.history["buffer_fill"].extend(int(f) for f in fill)
        self.history["accepted"].extend(int(a) for a in acc)
        self.history["dropped"].extend(int(d) for d in drop)
        self.history["version"].extend(int(v) for v in ver)

    def run(self, progress: bool = False, draws=None) -> Dict[str, list]:
        """``ticks`` ticks from tick 0 (there is no host loop).
        ``draws(t)``, when given, replaces the generator's round draws;
        the tick's jitter row is added to them."""
        if draws is not None:
            given = draws
            draws = lambda t: given(t)._replace(jitter=self._jitter[t])
        hist = self._run_segments(progress, draws)
        hist["aggregations"] = int(np.sum(hist["fired"]))
        hist["dropped_total"] = int(np.sum(hist["dropped"]))
        hist["mean_fill"] = float(np.mean(hist["buffer_fill"]))
        hist["ticks_per_s"] = hist["rounds_per_s"]
        return hist


def ticks_to_loss(history: Dict[str, list], target: float
                  ) -> Optional[int]:
    """First tick at which train loss dipped to ``target``."""
    for t, l in zip(history["round"], history["train_loss"]):
        if l <= target:
            return int(t)
    return None
