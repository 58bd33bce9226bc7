"""Federated server: the round loop of Algorithm 1 on one device.

Per round t:
  1. S^t ← select (ids, state = fn.select(state, t, noise))
  2. LocalUpdate for the K selected clients, as one batched cohort step,
     with their rows of the per-client extras (FedDyn's ``h``, Moon's
     ``prev``: N-stacked, gathered and written back by index)
  3. θ^{t+1} ← (1/K) Σ_{k∈S^t} θ_k^t
  4. whatever the selector ``requires`` (:meth:`observe`):
       bias_sel — the participants' head-bias Δb (HiCS-FL)
       loss_all — the global model's loss on every client (pow-d,
                  FedCor)
       full_all — a one-epoch update from every client, flattened
                  θ_k − θ^{t+1} (DivFL's ideal setting)
       full_sel — the participants' flattened θ_k − θ^{t+1} (CS,
                  DivFL's refresh="selected")
     then state = fn.update(state, t, ids, obs)

The port of the reference's ``FederatedServer``.  All of a round's
randomness (the selector's Gumbel draws, the cohort's epoch
permutations and, for DivFL's ideal setting, the all-clients poll's)
is drawn in one place, :meth:`draw_round`, from one
``torch.Generator`` on the CPU, and then moved to the device, so a CPU
run and a card run consume identical draws.  ``run(draws=...)`` takes
another source of the same tensors (the tests replay the reference's
key chain through it).  The round index ``t`` reaches the transitions,
the lr decay and FedCor's kernel weight as a 0-d int32 tensor.

Two drivers over the same round, :meth:`FederatedServer._round`:

* ``run()`` (host loop): one Python iteration a round; each branch on
  the selector state (``functional.cond``) reads one scalar on the
  host and runs one branch.
* ``run(jit_rounds=True)`` (the reference's scanned driver): the round
  is one functional step, ``(params, extras, state, t), draws ->
  (params, extras, state, t + 1), (ids, train loss, Ĥ)``, built once,
  that reads nothing on the host: every ``cond`` runs both branches and
  picks on the device.  On the card the step is captured once as a
  ``torch.cuda.CUDAGraph`` and replayed every round; on the CPU it
  runs eagerly.  Rounds go in segments of ``eval_every`` (all rounds
  in one without a test set): a segment's draws are made first, in
  round order, from the same generator as the host loop's, and its
  per-round outputs are read once at its end, before the evaluation.
  Both drivers pick the same participants.

:meth:`FederatedServer.from_partition` builds a server over a dataset
and a fixed-capacity partition (``repro_torch.scenarios``); given a
time-varying ``availability`` schedule, each round also draws its
availability draws and selects through ``scenarios.masked_select``.
The buffered-async server (``fed.async_server``) reuses this class's
draws, local update and segmented driver with its own tick step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.hetero import (head_bias_updates_stacked,
                                     head_num_classes)
from repro_torch.core.selectors import (Observations, SelectNoise,
                                        make_functional)
from repro_torch.core.selectors.functional import (both_branches,
                                                   draw_gumbel,
                                                   draw_select_noise,
                                                   round_index,
                                                   state_entropies)
from repro_torch.fed.client import (LocalSpec, init_extra, make_eval_fn,
                                    make_local_update, make_loss_poll)
from repro_torch.kernels import build as kernel_build
from repro_torch.optim import tree_map
from repro_torch.telemetry import (MetricsSpec, TelemetryCtx,
                                   client_true_entropy, make_metrics)

@dataclasses.dataclass(frozen=True)
class FedConfig:
    num_clients: int = 50
    num_select: int = 5
    rounds: int = 100
    selector: str = "hics"
    selector_kw: Optional[Dict[str, Any]] = None
    local: LocalSpec = dataclasses.field(default_factory=LocalSpec)
    eval_every: int = 5
    seed: int = 0
    lr_decay_every: int = 10     # paper: lr halves every 10 rounds
    lr_decay: float = 0.5
    #: run the segmented round driver (one CUDA graph a round on the
    #: card) instead of the host loop
    jit_rounds: bool = False
    #: telemetry metric groups to record (``repro_torch.telemetry.
    #: GROUPS``); () is off.  The groups' fields are extra outputs of
    #: the round: the training trajectory is bit-identical either way.
    telemetry: tuple = ()

    def __post_init__(self):
        MetricsSpec(tuple(self.telemetry))     # an unknown group raises


class RoundDraws(NamedTuple):
    """All random inputs of one round, on the server's device."""
    select: SelectNoise
    perms: torch.Tensor          # (K, epochs, S_max) int64
    #: (N, 1, S_max) int64 for the all-clients poll (``full_all``)
    grad_perms: Optional[torch.Tensor] = None
    #: under a time-varying availability schedule: the dropout's (N,)
    #: uniform f32 and the replacement's (N,) standard Gumbel f32
    #: (``scenarios.availability``)
    avail: Optional[torch.Tensor] = None
    repl: Optional[torch.Tensor] = None
    #: the async server's tick: the latency model's (K,) int32 jitter row
    jitter: Optional[torch.Tensor] = None


def aggregate_params(new_params: dict, weights=None) -> dict:
    """θ^{t+1} from the cohort's stacked local params (K, ...).

    ``weights=None`` is the sync drivers' mean (1/K) Σ θ_k.  With a
    (K,) ``weights`` tensor the normalized weighted mean Σ w_k θ_k /
    Σ w_k is computed as ``mean(θ_k · w̃_k)`` with ``w̃ = w·K/Σw``, the
    form the async server's staleness weighting uses: when every weight
    is equal (all ages 0, w_k = 1), ``w̃`` is exactly 1.0 and the
    weighted mean is bit-identical to the unweighted one, which the
    async server's identity-latency parity rests on."""
    if weights is None:
        return tree_map(lambda stacked: stacked.mean(dim=0), new_params)
    w = weights.to(torch.float32)
    tot = w.sum()
    scale = w * (torch.full_like(tot, float(w.shape[0])) / tot)
    return tree_map(lambda stacked: (stacked * scale.reshape(
        (stacked.shape[0],) + (1,) * (stacked.dim() - 1))).mean(dim=0),
        new_params)


def flatten_params(tree: dict, lead: int = 0) -> torch.Tensor:
    """Ravel a param dict in the reference's layout: leaves in sorted-key
    order (``jax.tree_util.tree_leaves`` of a dict), the OIHW conv
    weights (4-D past the ``lead`` stacked axes) as the reference's HWIO.
    (...) -> (P,), or (K, P) for ``lead=1``."""
    parts = []
    for key in sorted(tree):
        leaf = tree[key]
        if isinstance(leaf, dict):
            parts.append(flatten_params(leaf, lead))
            continue
        if leaf.dim() - lead == 4:
            leaf = leaf.permute(*range(lead), lead + 2, lead + 3,
                                lead + 1, lead)
        parts.append(leaf.reshape(*leaf.shape[:lead], -1))
    return torch.cat(parts, dim=-1)


def full_sel_updates(params: dict, new_params: dict) -> torch.Tensor:
    """The ``full_sel`` observation: the participants' flattened
    θ_k − θ^{t+1} against the aggregated params, (K, P)."""
    return flatten_params(new_params, lead=1) - flatten_params(params)


def make_grad_all(apply_fn: Callable, local: LocalSpec) -> Callable:
    """The ``full_all`` observation (DivFL's ideal setting): a one-epoch
    fedavg update of every client at the base lr, with the run's
    optimizer, ``(params, x, y, mask, perms (N, 1, S_max)) -> (N, P)``
    flattened θ_k − θ."""
    lu1 = make_local_update(apply_fn, dataclasses.replace(
        local, epochs=1, algo="fedavg"))

    def grad_all(params, x, y, mask, perms):
        one = torch.ones((), dtype=torch.float32, device=x.device)
        new_params, _, _ = lu1(params, {}, x, y, mask, perms, one)
        return flatten_params(new_params, lead=1) - flatten_params(params)

    return grad_all


def _copy_into(static, value) -> None:
    """Copy ``value`` leafwise into the ``static`` tensors.  The round's
    transitions return new tensors (or their input unchanged), so no
    copy reads what another one wrote."""
    tree_map(lambda s, v: s.copy_(v), static, value)


class RoundGraph:
    """One round captured as a ``torch.cuda.CUDAGraph``.

    ``step((params, extras, state, t), draws) -> ((params, extras,
    state, t + 1), outputs)`` is warmed up once on the capture stream,
    which builds and loads the kernels, sets their attributes and makes
    the per-stream buffers they keep (``kernels.pairwise.
    tile_counters``), without writing back: the transitions never write into what they are given.
    Then ``outputs = step(static)`` and the copy of the new carry into
    the static carry are captured; each :meth:`replay` copies a round's
    draws into the static draws and replays.  A capture records its
    kernels' launches without making them: the counts of
    ``kernels.build`` are set back after it, and each replay adds the
    captured launches.  ``carry``, ``draws`` and the outputs may be any
    nesting of dicts and tuples of tensors: the sweep captures its
    seeds' round steps, one after another, in one graph."""

    def __init__(self, step: Callable, carry, draws):
        self.carry = tree_map(torch.clone, carry)
        self.draws = tree_map(torch.clone, draws)
        self.stream = torch.cuda.Stream()
        self.stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self.stream):
            step(self.carry, self.draws)
        torch.cuda.current_stream().wait_stream(self.stream)
        before = kernel_build.counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=self.stream):
            new_carry, self.outputs = step(self.carry, self.draws)
            _copy_into(self.carry, new_carry)
        self.launches = kernel_build.counts_since(before)
        kernel_build.add_counts(self.launches, sign=-1)

    def load(self, carry) -> None:
        """Start the next replay from ``carry``."""
        _copy_into(self.carry, carry)

    def replay(self, draws) -> tuple:
        """One round from the static carry with ``draws``; returns
        copies of its outputs."""
        _copy_into(self.draws, draws)
        self.graph.replay()
        kernel_build.add_counts(self.launches)
        return tree_map(torch.clone, self.outputs)


class FederatedServer:
    """Drives T rounds of federated training over padded client data.

    ``init_fn(gen, device)`` makes the initial params from the
    server's generator, which then draws every round's noise.  Moon
    needs ``features_fn(params, x)``, the model's penultimate
    activations.  ``extras`` holds the per-client extras of the local
    update, each leaf N-stacked (``{}`` for fedavg and fedprox).
    """

    def __init__(self, init_fn, apply_fn, cfg: FedConfig,
                 client_x: np.ndarray, client_y: np.ndarray,
                 client_mask: np.ndarray,
                 test: Optional[Dict[str, np.ndarray]] = None,
                 device="cuda", features_fn=None, availability=None):
        if client_x.shape[0] != cfg.num_clients:
            raise ValueError("client_x must have num_clients rows")
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        self.x = torch.as_tensor(client_x, device=dev)
        self.y = torch.as_tensor(client_y, device=dev)
        self.mask = torch.as_tensor(client_mask, device=dev)
        self.test = (None if test is None else
                     {k: torch.as_tensor(v, device=dev)
                      for k, v in test.items()})
        self.gen = torch.Generator().manual_seed(cfg.seed)
        self.params = init_fn(self.gen, dev)
        self.apply_fn = apply_fn
        self.features_fn = features_fn
        kw = dict(cfg.selector_kw or {})
        # size the selector's buffers from the model: Δb width and the
        # raw flattened-update width
        kw.setdefault("num_classes", head_num_classes(self.params) or 1)
        kw.setdefault("feat_dim", int(flatten_params(self.params).numel()))
        self.selector = make_functional(
            cfg.selector, num_clients=cfg.num_clients,
            num_select=cfg.num_select, total_rounds=cfg.rounds,
            weights=np.asarray(client_mask).sum(axis=1), device=dev, **kw)
        self.requires = self.selector.requires
        self.state = self.selector.init()
        # telemetry (repro_torch.telemetry): with cfg.telemetry == ()
        # every field is zero-width and the step computes nothing
        self._metrics = make_metrics(
            MetricsSpec(tuple(cfg.telemetry)), fn=self.selector,
            num_clients=cfg.num_clients, device=dev)
        self._telc = self._metrics.init()
        # the selection group's ground truth: the true label entropy of
        # each client's partition
        self._true_ent = (
            client_true_entropy(self.y, self.mask,
                                int(np.max(np.asarray(client_y))) + 1)
            if "selection" in cfg.telemetry else None)
        #: a run's telemetry, {field: (T, ...)} numpy, set by the run
        self.telemetry: Dict[str, np.ndarray] = {}
        self._tel_segments: list = []
        self._lu = make_local_update(apply_fn, cfg.local, features_fn)
        n = cfg.num_clients
        self.extras = tree_map(
            lambda leaf: leaf.expand(n, *leaf.shape).clone(),
            init_extra(cfg.local, self.params))
        self._eval = make_eval_fn(apply_fn)
        if "loss_all" in self.requires:
            self._poll = make_loss_poll(apply_fn)
        if "full_all" in self.requires:
            self._grad_all = make_grad_all(apply_fn, cfg.local)
        #: the scanned driver's round step, built once; on the card its
        #: graph, captured at the first segment, and the captures made
        self._round_step: Optional[Callable] = None
        self._graph: Optional[RoundGraph] = None
        self.captures = 0
        #: a time-varying availability schedule (a ``scenarios.
        #: Scenario``): each round draws its (N,) uniform and Gumbel
        #: draws and selects through ``scenarios.masked_select``
        self.availability = None
        if getattr(availability, "time_varying", False):
            from repro_torch.scenarios import availability as avail_mod
            self.availability = availability
            self._avail = avail_mod
        # timing: wall_s per host-loop round; segment_wall_s and
        # segment_rounds per scanned segment (its draws and its one
        # read of the outputs included, the first one's capture too);
        # rounds_per_s over every timed round, whichever driver ran
        self.history: Dict[str, list] = {
            "round": [], "train_loss": [], "selected": [],
            "test_round": [], "test_loss": [], "test_acc": [],
            "bias_entropy": [], "wall_s": [],
            "segment_wall_s": [], "segment_rounds": [],
        }

    def draw_round(self, t: int) -> RoundDraws:
        """Round t's Gumbel draws and permutations, from the server's
        generator on the CPU, moved to the device."""
        return tree_map(lambda a: a.to(self.device), self._draw_host(t))

    def _draw_host(self, t: int) -> RoundDraws:
        """Round t's draws on the CPU (the scanned driver moves a whole
        segment's at once)."""
        del t
        cfg, gen = self.cfg, self.gen
        n = cfg.num_clients
        k = min(cfg.num_select, n)
        s_max = self.x.shape[1]
        noise = draw_select_noise(gen, n, k, self.selector.num_clusters)

        def perms(rows: int, epochs: int) -> torch.Tensor:
            return torch.stack([
                torch.stack([torch.randperm(s_max, generator=gen)
                             for _ in range(epochs)])
                for _ in range(rows)])

        rd = RoundDraws(
            noise, perms(k, cfg.local.epochs),
            perms(n, 1) if "full_all" in self.requires else None)
        if self.availability is not None:
            rd = rd._replace(avail=torch.rand(n, generator=gen),
                             repl=draw_gumbel(gen, (n,)))
        return rd

    @classmethod
    def from_partition(cls, init_fn, apply_fn, cfg: FedConfig, x, y,
                       partition,
                       test: Optional[Dict[str, np.ndarray]] = None,
                       device="cuda", features_fn=None, availability=None):
        """A server over a dataset and a fixed-capacity partition (a
        ``scenarios.Partition``): the client tensors are the rows
        ``x[idx]``, ``y[idx]`` gathered through its index layout, the
        mask its mask."""
        idx = np.asarray(torch.as_tensor(partition.idx).cpu())
        as_np = lambda a: np.asarray(torch.as_tensor(a).cpu())
        return cls(init_fn, apply_fn, cfg, as_np(x)[idx], as_np(y)[idx],
                   as_np(partition.mask).astype(np.float32), test=test,
                   device=device, features_fn=features_fn,
                   availability=availability)

    def select(self, state, t: torch.Tensor, rd: RoundDraws):
        """The round's select: the selector's own, or under the
        availability schedule through ``masked_select``."""
        if self.availability is None:
            return self.selector.select(state, t, rd.select)
        avail = self._avail.availability_mask(
            self.availability, self.cfg.num_clients, t, rd.avail)
        return self._avail.masked_select(self.selector, state, t,
                                         rd.select, avail, rd.repl)

    def local_update(self, t, ids: torch.Tensor, perms: torch.Tensor,
                     params: Optional[dict] = None,
                     extras: Optional[dict] = None):
        """The cohort's LocalUpdate from ``params`` and the N-stacked
        ``extras`` (default the current ones): (K-stacked params, the
        cohort's K-stacked new extras, {"train_loss": (K,), "lr_scale":
        ()}).  The lr halves every ``lr_decay_every`` rounds:
        ``lr_scale``, a 0-d tensor computed from the round index ``t``
        (a 0-d int32 tensor, or an int)."""
        cfg, idx = self.cfg, ids.long()
        t = round_index(t, self.device)
        decay = torch.pow(cfg.lr_decay, torch.div(
            t, cfg.lr_decay_every, rounding_mode="floor").float())
        extras = self.extras if extras is None else extras
        new_params, new_extras, metrics = self._lu(
            self.params if params is None else params,
            tree_map(lambda a: a.index_select(0, idx), extras),
            self.x[idx], self.y[idx], self.mask[idx],
            perms[:idx.shape[0]], decay)
        return new_params, new_extras, dict(metrics, lr_scale=decay)

    def observe(self, params_before: dict, new_params: dict,
                grad_perms: Optional[torch.Tensor],
                params: Optional[dict] = None) -> Observations:
        """What the selector ``requires``, against the aggregated
        ``params`` (default ``self.params``); Δb against
        ``params_before``."""
        req = self.requires
        params = self.params if params is None else params
        bias = losses = full = None
        if "bias_sel" in req:
            bias = head_bias_updates_stacked(params_before, new_params)
        if "loss_all" in req:
            losses = self._poll(params, self.x, self.y, self.mask)
        if "full_all" in req:
            full = self._grad_all(params, self.x, self.y, self.mask,
                                  grad_perms)
        elif "full_sel" in req:
            full = full_sel_updates(params, new_params)
        return Observations(bias_updates=bias, full_updates=full,
                            losses=losses)

    def _round(self, params: dict, extras: dict, state, t: torch.Tensor,
               rd: RoundDraws):
        """One round, functional: select, local update, aggregate,
        observe, update.  Returns (params, extras, state, ids, the
        cohort's metrics, the round's :class:`TelemetryCtx`); writes
        into nothing it is given."""
        ids, state = self.select(state, t, rd)
        new_params, new_extras, metrics = self.local_update(
            t, ids, rd.perms, params, extras)
        idx = ids.long()
        extras = tree_map(lambda a, v: a.index_copy(0, idx, v), extras,
                          new_extras)
        agg = aggregate_params(new_params)
        obs = self.observe(params, new_params, rd.grad_perms, agg)
        state = self.selector.update(state, t, ids, obs)
        ctx = self.telemetry_ctx(t, ids, state, metrics, params, agg,
                                 new_params, obs.bias_updates)
        return agg, extras, state, ids, metrics, ctx

    def telemetry_ctx(self, t, ids, state, metrics: dict,
                      params_before: dict, params_after: dict,
                      new_params: dict, bias_updates=None) -> TelemetryCtx:
        """What the metrics step reads of a round: its ids, the updated
        selector state, the cohort's mean train loss and lr scale, θ^t,
        θ^{t+1} and the cohort's Δb (made here for a selector that does
        not observe it, when the ``training`` group is on)."""
        if bias_updates is None and self._metrics.spec.enabled("training"):
            bias_updates = head_bias_updates_stacked(params_before,
                                                     new_params)
        return TelemetryCtx(
            t=t, ids=ids, state=state,
            train_loss=metrics["train_loss"].mean(),
            true_entropy=self._true_ent, params_before=params_before,
            params_after=params_after, bias_updates=bias_updates,
            lr_scale=metrics["lr_scale"])

    def step(self, t, rd: RoundDraws):
        """One host-loop round from the current params, extras and
        selector state, with round t's draws, and its telemetry when
        ``cfg.telemetry`` names a group.  Returns (ids, the cohort's
        metrics)."""
        self.params, self.extras, self.state, ids, metrics, ctx = \
            self._round(self.params, self.extras, self.state,
                        round_index(t, self.device), rd)
        if self.cfg.telemetry:
            self._telc, tel = self._metrics.step(self._telc, ctx)
            self._tel_segments.append(
                {k: v.cpu().numpy()[None] for k, v in tel.items()})
        return ids, metrics

    def run(self, progress: bool = False,
            draws: Optional[Callable[[int], RoundDraws]] = None,
            jit_rounds: Optional[bool] = None) -> Dict[str, list]:
        """``cfg.rounds`` rounds from round 0, by the host loop or, with
        ``jit_rounds`` (default ``cfg.jit_rounds``), the segmented
        driver."""
        if self.cfg.jit_rounds if jit_rounds is None else jit_rounds:
            return self._run_segments(progress, draws)
        cfg = self.cfg
        draws = draws or self.draw_round
        for t in range(cfg.rounds):
            t_start = time.perf_counter()
            ids, metrics = self.step(t, draws(t))
            self.history["round"].append(t)
            self.history["train_loss"].append(
                float(metrics["train_loss"].mean()))
            self.history["selected"].append(ids.tolist())
            ent = self.selector.entropies
            self.history["bias_entropy"].append(
                None if ent is None else ent(self.state).tolist())
            self.history["wall_s"].append(time.perf_counter() - t_start)
            if self.test is not None and (t % cfg.eval_every == 0
                                          or t == cfg.rounds - 1):
                self._eval_round(t, progress)
        return self._finish()

    def _make_round_step(self) -> Callable:
        """The scanned driver's round: ``((params, extras, state, t,
        telemetry carry), draws) -> ((params, extras, state, t + 1,
        telemetry carry), (ids, mean train loss, Ĥ or (0,), telemetry
        dict))``, :meth:`_round` and the metrics step with every
        ``cond`` on the device."""
        def round_step(carry, rd: RoundDraws):
            params, extras, state, t, telc = carry
            with both_branches():
                params, extras, state, ids, _, ctx = self._round(
                    params, extras, state, t, rd)
                telc, tel = self._metrics.step(telc, ctx)
            return ((params, extras, state, t + 1, telc),
                    (ids, ctx.train_loss,
                     state_entropies(self.selector, state), tel))

        return round_step

    def _run_segments(self, progress: bool,
                      draws: Optional[Callable[[int], RoundDraws]]
                      ) -> Dict[str, list]:
        """The scanned driver: the round step in segments of
        ``eval_every`` rounds, replayed as one CUDA graph a round on the
        card (a capture that fails raises), run eagerly on the CPU."""
        cfg = self.cfg
        draws = draws or self._draw_host
        if self._round_step is None:
            self._round_step = self._make_round_step()
        carry = self._initial_carry()
        if self._graph is not None:
            self._graph.load(carry)
        seg_len = cfg.eval_every if self.test is not None else cfg.rounds
        t = 0
        while t < cfg.rounds:
            n = min(seg_len, cfg.rounds - t)
            t_start = time.perf_counter()
            with torch.profiler.record_function(f"{self._span}[{n}]"):
                carry, outs = self._segment(carry, [draws(t + i)
                                                    for i in range(n)])
                outs = tree_map(lambda *a: torch.stack(a).cpu(), *outs)
            self._store_carry(carry)
            self.history["segment_wall_s"].append(
                time.perf_counter() - t_start)
            self.history["segment_rounds"].append(n)
            self._record(t, outs[:-1])
            self._tel_segments.append(
                {k: v.numpy() for k, v in outs[-1].items()})
            t += n
            if self.test is not None:
                self._eval_round(t - 1, progress)
        return self._finish()

    #: the profiler range of a segment (``fed/scan_segment[n]``)
    _span = "fed/scan_segment"

    def _initial_carry(self) -> tuple:
        """The round step's carry from the server's current params,
        extras, selector state and telemetry carry, at round 0."""
        return (self.params, self.extras, self.state,
                torch.zeros((), dtype=torch.int32, device=self.device),
                self._telc)

    def _store_carry(self, carry) -> None:
        self.params, self.extras, self.state = carry[:3]
        self._telc = carry[4]

    def _record(self, t: int, outs: tuple) -> None:
        """A segment's per-round outputs but the telemetry (each stacked
        over its rounds, on the CPU) into the history, from round
        ``t``."""
        ids, loss, ent = outs
        for i in range(ids.shape[0]):
            self.history["round"].append(t + i)
            self.history["train_loss"].append(float(loss[i]))
            self.history["selected"].append(ids[i].tolist())
            self.history["bias_entropy"].append(
                ent[i].tolist() if ent.shape[-1] else None)

    def _segment(self, carry, draws: list):
        """The rounds of one segment from ``carry`` with their
        ``draws``: (the carry after them, each round's outputs)."""
        seg = tree_map(lambda *a: torch.stack(a).to(self.device), *draws)
        outs = []
        for i in range(len(draws)):
            rd = tree_map(lambda a: a[i], seg)
            if self.device.type == "cpu":
                carry, out = self._round_step(carry, rd)
                outs.append(out)
                continue
            if self._graph is None:
                self._graph = RoundGraph(self._round_step, carry, rd)
                self.captures += 1
            outs.append(self._graph.replay(rd))
        if self.device.type == "cuda":   # the graph keeps its carry
            carry = tree_map(torch.clone, self._graph.carry)
        return carry, outs

    def _finish(self) -> Dict[str, list]:
        wall = (sum(self.history["segment_wall_s"])
                or sum(self.history["wall_s"]))
        rounds = (sum(self.history["segment_rounds"])
                  or len(self.history["wall_s"]))
        self.history["rounds_per_s"] = rounds / wall if wall else None
        if self._tel_segments:
            self.telemetry = {
                k: np.concatenate([seg[k] for seg in self._tel_segments])
                for k in self._tel_segments[0]}
        return self.history

    def _eval_round(self, t: int, progress: bool) -> None:
        tl, ta = self._eval(self.params, self.test["x"], self.test["y"],
                            self.test["mask"])
        self.history["test_round"].append(t)
        self.history["test_loss"].append(float(tl))
        self.history["test_acc"].append(float(ta))
        if progress:
            print(f"round {t:4d} loss={self.history['train_loss'][-1]:.4f} "
                  f"test_acc={float(ta):.4f}", flush=True)


def rounds_to_accuracy(history: Dict[str, list], target: float
                       ) -> Optional[int]:
    """First round at which test accuracy reached `target` (Table 2)."""
    for r, a in zip(history["test_round"], history["test_acc"]):
        if a >= target:
            return int(r)
    return None
