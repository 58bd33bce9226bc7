"""The multi-seed, multi-scenario sweep engine.

The port of the reference's ``scenarios/sweep.py``.  One grid cell
(scenario × selector) runs S seeds.  Each seed is a server over the
scenario's shared dataset and the seed's own partition
(``FederatedServer.from_partition``, or the async server's), seeded by
the sweep seed: its initial params and every round's draws are what
``FederatedServer(seed=s)`` draws, in the same order, plus the
availability draws of a time-varying scenario.  The seeds' round steps
are the servers' own scanned round steps, so each seed reproduces the
server's scanned driver for that seed bit for bit, and the host loop's
participants (``run_host_reference``).

The port's kernels are ``ctypes`` launches, which ``torch.func.vmap``
cannot batch, so the S seeds' round steps run one after another: on
the card inside ONE captured CUDA graph a round (``fed.server.
RoundGraph`` over the tuple of the seeds' carries), replayed each round;
on the CPU eagerly.  Each seed keeps its own carry and its own kernel
launches.

Drivers:

  run_sweep(spec)            scenarios × selectors grid; mean ± std
                             accuracy and entropy trajectories
  run_host_reference(...)    one (scenario, selector, seed) through the
                             FederatedServer (host loop or scanned) on
                             the same data
  run_async_sweep(spec)      the grid through the buffered-async server
  bench_sweep(spec)          the sweep against one seed at a time (and
                             the host loop): seconds a cell
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.backend import resolve_device, set_precision
from repro_torch.configs import get_config
from repro_torch.core.selectors import SELECTORS, make_functional
from repro_torch.data import SyntheticSpec
from repro_torch.fed.async_server import (AsyncConfig, AsyncFederatedServer,
                                          check_async_selector)
from repro_torch.fed.client import LocalSpec
from repro_torch.fed.server import FedConfig, FederatedServer, RoundGraph
from repro_torch.models.classifier import (make_classifier,
                                           make_classifier_with_features)
from repro_torch.optim import tree_map
from repro_torch.scenarios.partition_device import Partition
from repro_torch.scenarios.registry import (Scenario, get_scenario,
                                            make_dataset, materialize)
from repro_torch.telemetry import MetricsSpec, env_stamp


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """Declarative sweep grid: scenarios × selectors × seeds."""
    scenarios: Sequence[str] = ("mixed_80_20", "dir_mild")
    selectors: Sequence[str] = ("hics", "random")
    seeds: Sequence[int] = (0, 1, 2, 3)
    arch: str = "paper-mlp"
    num_clients: int = 12
    num_select: int = 3
    rounds: int = 10
    cap: Optional[int] = None        # fixed per-client capacity (None →
    samples_train: int = 600         #  4·S/N, clipped to S)
    samples_test: int = 200
    selector_kw: Optional[Dict[str, Any]] = None
    local: LocalSpec = dataclasses.field(default_factory=LocalSpec)
    lr_decay_every: int = 10
    lr_decay: float = 0.5
    data_seed: int = 0
    data: Optional[SyntheticSpec] = None   # overrides every scenario's
    #: telemetry metric groups every seed records (``repro_torch.
    #: telemetry.GROUPS``); a cell's ``telemetry`` is {field: (S, T, ...)}
    telemetry: Sequence[str] = ()

    def __post_init__(self):
        MetricsSpec(tuple(self.telemetry))     # an unknown group raises

    def capacity(self) -> int:
        if self.cap is not None:
            return int(self.cap)
        return min(self.samples_train,
                   max(1, 4 * self.samples_train // self.num_clients))

    def scenario(self, name: str) -> Scenario:
        scn = get_scenario(name)
        if self.data is not None:
            scn = dataclasses.replace(scn, data=self.data)
        return scn


def seed_keychain(seed: int) -> torch.Generator:
    """The chain of one seed: the CPU generator ``FederatedServer(seed=
    s)`` draws its initial params and then every round's draws from."""
    return torch.Generator().manual_seed(int(seed))


def _make_model(spec: SweepSpec, cfg, input_dim: int):
    """(init, apply, features) for the sweep's model, with the server
    builder's moon special case (the contrastive term needs the
    embedding head)."""
    if spec.local.algo == "moon":
        return make_classifier_with_features(cfg, input_dim=input_dim)
    init_fn, apply_fn, _ = make_classifier(cfg, input_dim=input_dim)
    return init_fn, apply_fn, None


def _probe_requires(spec: SweepSpec, name: str) -> frozenset:
    """A selector's effective requirements (its kwargs can move it
    between classes, e.g. divfl's ``refresh="selected"``), from a
    throwaway tiny instance on the CPU."""
    if name not in SELECTORS:
        raise KeyError(f"unknown selector {name!r}; known: "
                       f"{sorted(SELECTORS)}")
    return make_functional(name, num_clients=2, num_select=1,
                           total_rounds=1, device="cpu",
                           **dict(spec.selector_kw or {})).requires


def _fed_config(spec: SweepSpec, selector: str, seed: int,
                jit_rounds: bool) -> FedConfig:
    return FedConfig(
        num_clients=spec.num_clients, num_select=spec.num_select,
        rounds=spec.rounds, selector=selector,
        selector_kw=spec.selector_kw, local=spec.local,
        eval_every=spec.rounds, seed=int(seed),
        lr_decay_every=spec.lr_decay_every, lr_decay=spec.lr_decay,
        jit_rounds=jit_rounds, telemetry=tuple(spec.telemetry))


def _cell_data(spec: SweepSpec, scn: Scenario, device):
    """The cell's shared dataset on ``device``, its model, and the
    class count."""
    set_precision()
    cfg = get_config(spec.arch)
    num_classes = cfg.vocab_size
    train, test, _ = make_dataset(scn, spec.samples_train,
                                  spec.samples_test, num_classes,
                                  spec.data_seed, device=device)
    return train, test, _make_model(spec, cfg, scn.data.dim), num_classes


def make_seed_runner(spec: SweepSpec, scenario: Scenario, selector: str,
                     model, train: dict, test: dict, part: Partition,
                     seed: int, device="cuda") -> FederatedServer:
    """One seed of a sync cell: the scanned-driver server over the
    shared ``train`` set through the seed's partition, seeded by the
    sweep seed, under the scenario's availability schedule."""
    init_fn, apply_fn, features = model
    return FederatedServer.from_partition(
        init_fn, apply_fn, _fed_config(spec, selector, seed, True),
        train["x"], train["y"], part, test=test, device=device,
        features_fn=features, availability=scenario)


def make_async_seed_runner(spec: SweepSpec, scenario: Scenario,
                           acfg: AsyncConfig, model, train: dict,
                           test: dict, part: Partition, seed: int,
                           device="cuda") -> AsyncFederatedServer:
    """One seed of an async cell: the buffered-async server over the
    seed's partition, its latency model the scenario's (the tables are
    shared across seeds; which client sits behind each delay varies
    with the partition)."""
    init_fn, apply_fn, features = model
    return AsyncFederatedServer.from_partition(
        init_fn, apply_fn, dataclasses.replace(acfg, seed=int(seed)),
        train["x"], train["y"], part, test=test, device=device,
        features_fn=features, availability=scenario)


@dataclasses.dataclass
class PairRun:
    """One (scenario, selector) cell: a server per seed (each one's
    initial carry kept, so the cell can run again), each seed's draws
    for every round on the device, and the graph that runs all seeds'
    round steps a round once captured.  Each seed carries its own
    telemetry carry, its true entropies from its own partition; the
    last run's telemetry is ``telemetry``, {field: (S, T, ...)}."""
    scenario: Scenario
    selector: str
    servers: List[FederatedServer]
    parts: List[Partition]
    overflow_frac: float
    carries0: list = dataclasses.field(init=False)
    draws: list = dataclasses.field(init=False)
    graph: Optional[RoundGraph] = dataclasses.field(default=None,
                                                    init=False)
    captures: int = dataclasses.field(default=0, init=False)
    #: host-clock seconds of the last :meth:`run`, its capture included
    wall_s: float = dataclasses.field(default=0.0, init=False)
    telemetry: Dict[str, np.ndarray] = dataclasses.field(
        default_factory=dict, init=False)

    def __post_init__(self):
        self.carries0 = [srv._initial_carry() for srv in self.servers]
        self.draws = [self._seed_draws(srv) for srv in self.servers]
        self._steps = [self._seed_step(srv) for srv in self.servers]

    @staticmethod
    def _seed_draws(srv: FederatedServer) -> list:
        """Every round's draws of the server, on its device; its
        generator is put back, so that its own run draws them again."""
        state = srv.gen.get_state()
        draws = [tree_map(lambda a: a.to(srv.device), srv._draw_host(t))
                 for t in range(srv.cfg.rounds)]
        srv.gen.set_state(state)
        return draws

    @staticmethod
    def _seed_step(srv: FederatedServer):
        """The server's round step, and after it the round's mean Ĥ and,
        for the sync server, the test accuracy; its telemetry dict
        last."""
        step = srv._make_round_step()
        sync = not isinstance(srv, AsyncFederatedServer)

        def seed_step(carry, rd):
            carry, out = step(carry, rd)
            ent = out[2]
            ent_mean = (ent.mean() if ent.shape[-1] else
                        torch.zeros((), device=ent.device))
            extra = ()
            if sync:
                _, acc = srv._eval(carry[0], srv.test["x"], srv.test["y"],
                                   srv.test["mask"])
                extra = (acc,)
            return carry, ((out[0], out[1], ent_mean) + out[3:-1] + extra
                           + (out[-1],))

        return seed_step

    def _all_seeds(self, carries, draws):
        outs = [step(c, d) for step, c, d in zip(self._steps, carries,
                                                 draws)]
        return tuple(o[0] for o in outs), tuple(o[1] for o in outs)

    def run(self) -> List[np.ndarray]:
        """Every seed's rounds from its initial carry: on the card one
        replay a round of the graph of all seeds' round steps (captured
        at the first round of the first run), on the CPU eagerly.
        Returns the round step's outputs, each stacked (S, T, ...) as
        numpy: (ids, train loss, mean Ĥ, then the async tick's fired,
        fill, accepted, dropped and version, or the sync round's test
        accuracy), sets :attr:`telemetry` and leaves each server holding
        its seed's final carry."""
        dev = self.servers[0].device
        carries = tuple(self.carries0)
        rounds = len(self.draws[0])
        outs = []
        t0 = time.perf_counter()
        if self.graph is not None:
            self.graph.load(carries)
        for t in range(rounds):
            draws = tuple(d[t] for d in self.draws)
            if dev.type == "cpu":
                carries, out = self._all_seeds(carries, draws)
            else:
                if self.graph is None:
                    self.graph = RoundGraph(self._all_seeds, carries, draws)
                    self.captures += 1
                out = self.graph.replay(draws)
            outs.append(out)
        if dev.type == "cuda":
            carries = tree_map(torch.clone, self.graph.carry)
        stacked = [tree_map(lambda *a: torch.stack(a).cpu().numpy(),
                            *[o[i] for o in outs])
                   for i in range(len(self.servers))]
        self.wall_s = time.perf_counter() - t0
        for srv, carry in zip(self.servers, carries):
            srv._store_carry(carry)
        tel = [seed[-1] for seed in stacked]
        self.telemetry = {k: np.stack([t[k] for t in tel]) for k in tel[0]}
        return [np.stack(field) for field in zip(*[seed[:-1]
                                                   for seed in stacked])]


def _overflow(parts: List[Partition]) -> float:
    counts = sum(float(p.counts.sum()) for p in parts)
    kept = sum(float(p.mask.sum()) for p in parts)
    return float(1.0 - kept / max(1.0, counts))


def build_pair(spec: SweepSpec, scenario_name: str, selector: str,
               device="cuda") -> PairRun:
    """Materialize one sync grid cell on ``device``: the shared
    dataset, each seed's partition, server and draws."""
    dev = resolve_device(device)
    scn = spec.scenario(scenario_name)
    _probe_requires(spec, selector)
    train, test, model, num_classes = _cell_data(spec, scn, dev)
    parts, servers = [], []
    for s in spec.seeds:
        part = materialize(scn, int(s), train, num_classes,
                           spec.num_clients, spec.capacity())
        parts.append(part)
        servers.append(make_seed_runner(spec, scn, selector, model, train,
                                        test, part, int(s), dev))
    return PairRun(scn, selector, servers, parts, _overflow(parts))


def run_sweep(spec: SweepSpec, progress: bool = False,
              device="cuda") -> Dict[str, Any]:
    """The whole grid.  Returns per-cell per-seed raw trajectories and
    their mean ± std over seeds."""
    grid: Dict[str, Any] = {}
    for scenario_name in spec.scenarios:
        for selector in spec.selectors:
            pair = build_pair(spec, scenario_name, selector, device)
            with torch.profiler.record_function(
                    f"sweep/{scenario_name}/{selector}"):
                ids, loss, ent, acc = pair.run()
            cell = {
                "seeds": [int(s) for s in spec.seeds],
                "selected": ids,                       # (S, T, K)
                "train_loss": loss,                    # (S, T)
                "test_acc": acc,
                "mean_entropy": ent,
                "final_acc": acc[:, -1].tolist(),
                "final_acc_mean": float(acc[:, -1].mean()),
                "final_acc_std": float(acc[:, -1].std()),
                "acc_mean": acc.mean(axis=0).tolist(),
                "acc_std": acc.std(axis=0).tolist(),
                "entropy_mean": ent.mean(axis=0).tolist(),
                "entropy_std": ent.std(axis=0).tolist(),
                "train_loss_mean": loss.mean(axis=0).tolist(),
                "overflow_frac": pair.overflow_frac,
                "wall_s": pair.wall_s,
                "telemetry": pair.telemetry,   # {field: (S, T, ...)}
            }
            grid[f"{scenario_name}/{selector}"] = cell
            if progress:
                print(f"  {scenario_name:18s} {selector:8s} "
                      f"acc={cell['final_acc_mean']:.3f}"
                      f"±{cell['final_acc_std']:.3f}", flush=True)
    return {"spec": _spec_dict(spec), "grid": grid}


def run_host_reference(spec: SweepSpec, scenario_name: str, selector: str,
                       seed: int, jit_rounds: bool = False,
                       device="cuda") -> Dict[str, list]:
    """One seed through the ``FederatedServer`` on the dataset and
    partition the sweep uses: the host loop, or with ``jit_rounds=True``
    the scanned driver."""
    scn = spec.scenario(scenario_name)
    if scn.time_varying:
        raise ValueError("the server loop has no availability schedule; "
                         "host references need an always-on scenario")
    dev = resolve_device(device)
    train, test, (init_fn, apply_fn, features), num_classes = _cell_data(
        spec, scn, dev)
    part = materialize(scn, seed, train, num_classes, spec.num_clients,
                       spec.capacity())
    server = FederatedServer.from_partition(
        init_fn, apply_fn, _fed_config(spec, selector, seed, jit_rounds),
        train["x"], train["y"], part, test=test, device=dev,
        features_fn=features)
    return server.run()


def build_async_pair(spec: SweepSpec, scenario_name: str, selector: str,
                     capacity: int = 0, threshold: int = 0,
                     beta: float = 0.5, server_mix: float = 0.0,
                     max_lag: int = 16, device="cuda"
                     ) -> Tuple[PairRun, AsyncConfig]:
    """Materialize one async grid cell: the dataset, partitions, params
    and draws of :func:`build_pair` (so identity latency with
    ``capacity = threshold = K`` is the sync cell bit for bit), driven
    by the buffered-async tick, and a staled-id ring wide enough for one
    aggregation's M ids."""
    check_async_selector(selector, _probe_requires(spec, selector))
    dev = resolve_device(device)
    k = spec.num_select
    m = int(threshold) or k
    kw = dict(spec.selector_kw or {})
    kw.setdefault("stale_slots", -(-m // k))
    spec = dataclasses.replace(spec, selector_kw=kw)
    scn = spec.scenario(scenario_name)
    acfg = AsyncConfig(
        num_clients=spec.num_clients, num_select=k, ticks=spec.rounds,
        selector=selector, selector_kw=kw, local=spec.local,
        capacity=capacity, threshold=threshold, beta=beta,
        server_mix=server_mix, latency=scn.latency, max_lag=max_lag,
        eval_every=spec.rounds, lr_decay_every=spec.lr_decay_every,
        lr_decay=spec.lr_decay, telemetry=tuple(spec.telemetry))
    train, test, model, num_classes = _cell_data(spec, scn, dev)
    parts, servers = [], []
    for s in spec.seeds:
        part = materialize(scn, int(s), train, num_classes,
                           spec.num_clients, spec.capacity())
        parts.append(part)
        servers.append(make_async_seed_runner(spec, scn, acfg, model, train,
                                              test, part, int(s), dev))
    return PairRun(scn, selector, servers, parts, _overflow(parts)), acfg


def run_async_sweep(spec: SweepSpec, capacity: int = 0,
                    threshold: int = 0, beta: float = 0.5,
                    server_mix: float = 0.0, max_lag: int = 16,
                    progress: bool = False, device="cuda") -> Dict[str, Any]:
    """The async grid: each cell's latency model is its scenario's, so a
    grid over the async traffic-shape family (``stragglers_severe``,
    ``diurnal_heavy_tail``, ``flash_crowd``) compares selectors under
    increasing system heterogeneity."""
    grid: Dict[str, Any] = {}
    for scenario_name in spec.scenarios:
        for selector in spec.selectors:
            pair, _ = build_async_pair(
                spec, scenario_name, selector, capacity=capacity,
                threshold=threshold, beta=beta, server_mix=server_mix,
                max_lag=max_lag, device=device)
            (ids, loss, ent, fired, fill, accepted, dropped,
             version) = pair.run()
            acc = np.asarray([float(srv._eval(
                srv.params, srv.test["x"], srv.test["y"],
                srv.test["mask"])[1]) for srv in pair.servers])
            cell = {
                "seeds": [int(s) for s in spec.seeds],
                "selected": ids,                       # (S, T, K)
                "train_loss": loss,                    # (S, T)
                "train_loss_mean": loss.mean(axis=0).tolist(),
                "mean_entropy": ent,
                "fired": fired, "buffer_fill": fill,
                "accepted": accepted, "dropped": dropped,
                "version": version,
                "final_acc": acc.tolist(),
                "final_acc_mean": float(acc.mean()),
                "final_acc_std": float(acc.std()),
                "aggregations": fired.sum(axis=1).tolist(),
                "dropped_total": dropped.sum(axis=1).tolist(),
                "mean_fill": fill.mean(axis=1).tolist(),
                "final_version": version[:, -1].tolist(),
                "overflow_frac": pair.overflow_frac,
                "wall_s": pair.wall_s,
                "telemetry": pair.telemetry,   # {field: (S, T, ...)}
            }
            grid[f"{scenario_name}/{selector}"] = cell
            if progress:
                print(f"  {scenario_name:18s} {selector:8s} "
                      f"acc={cell['final_acc_mean']:.3f}"
                      f"±{cell['final_acc_std']:.3f} "
                      f"aggs={cell['aggregations']}", flush=True)
    return {"spec": _spec_dict(spec),
            "async": {"capacity": capacity, "threshold": threshold,
                      "beta": beta, "server_mix": server_mix,
                      "max_lag": max_lag},
            "grid": grid}


def serial_seconds(spec: SweepSpec, scenario_name: str, selector: str,
                   device="cuda") -> Tuple[float, float]:
    """The cell's seeds one after another, each a single-seed sweep
    server through the scanned driver run twice: (the seconds of the
    first runs' segments, their capture included; the seconds of the
    second runs', replays only), summed over the seeds."""
    first = second = 0.0
    for seed in spec.seeds:
        srv = build_pair(dataclasses.replace(spec, seeds=(seed,)),
                         scenario_name, selector, device).servers[0]
        srv.test = None
        srv.run()
        first += sum(srv.history["segment_wall_s"])
        srv.run()
        second += srv.history["segment_wall_s"][-1]
        del srv
    return first, second


def bench_sweep(spec: SweepSpec, include_host: bool = False,
                device="cuda") -> Dict[str, Any]:
    """The sweep's seconds a grid cell against one seed at a time, with
    the reference's keys.

    ``vmapped_s`` is the cell's :meth:`PairRun.run`, which replays one
    graph a round over all its seeds; ``serial_engine_s`` the seeds one
    at a time through the scanned driver (:func:`serial_seconds`).  Each
    is timed on its second run, so that the CUDA graphs' capture is
    excluded from both, as the reference excludes its compiles; on the
    CPU both run eagerly.  With ``include_host`` the ``FederatedServer``
    host loop (:func:`run_host_reference`) is timed as it is, set-up
    included, for the scenarios that are not time-varying."""
    out: Dict[str, Any] = {
        "what": "one graph a round over the seeds vs one seed at a time",
        "seeds": [int(s) for s in spec.seeds],
        "rounds": spec.rounds, "num_clients": spec.num_clients,
        "env": env_stamp(),
        "grid": {},
    }
    for scenario_name in spec.scenarios:
        for selector in spec.selectors:
            pair = build_pair(spec, scenario_name, selector, device)
            pair.run()                                   # capture
            pair.run()
            vmapped_s = pair.wall_s
            serial_s = serial_seconds(spec, scenario_name, selector,
                                      device)[1]
            cell = {"vmapped_s": vmapped_s, "serial_engine_s": serial_s,
                    "speedup_vs_serial": serial_s / vmapped_s}
            # the server loop has no availability schedule, so the
            # host-loop baseline only exists for always-on scenarios
            if include_host and not pair.scenario.time_varying:
                t0 = time.perf_counter()
                for s in spec.seeds:
                    run_host_reference(spec, scenario_name, selector,
                                       int(s), device=device)
                cell["host_loop_s"] = time.perf_counter() - t0
                cell["speedup_vs_host"] = cell["host_loop_s"] / vmapped_s
            out["grid"][f"{scenario_name}/{selector}"] = cell
            print(f"  {scenario_name:18s} {selector:8s} "
                  f"vmapped={vmapped_s:6.2f}s  serial={serial_s:6.2f}s  "
                  f"({cell['speedup_vs_serial']:.2f}x)"
                  + (f"  host={cell['host_loop_s']:6.2f}s"
                     if "host_loop_s" in cell else ""), flush=True)
            del pair
    return out


def _spec_dict(spec: SweepSpec) -> Dict[str, Any]:
    d = dataclasses.asdict(spec)
    d["scenarios"] = list(d["scenarios"])
    d["selectors"] = list(d["selectors"])
    d["seeds"] = [int(s) for s in d["seeds"]]
    d["local"] = dataclasses.asdict(spec.local)
    d["data"] = None if spec.data is None else dataclasses.asdict(spec.data)
    d["telemetry"] = list(d["telemetry"])
    return d
