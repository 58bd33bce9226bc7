"""Federated server: the round loop of Algorithm 1 on one device.

Per round t:
  1. S^t ← select (ids, state = fn.select(state, t, noise))
  2. LocalUpdate for the K selected clients, as one batched cohort step
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

The port of the reference's host-loop ``FederatedServer.run``.  All of
a round's randomness (the selector's Gumbel draws, the cohort's epoch
permutations and, for DivFL's ideal setting, the all-clients poll's)
is drawn in one place, :meth:`draw_round`, from one
``torch.Generator`` on the CPU, and then moved to the device, so a CPU
run and a card run consume identical draws.  ``run(draws=...)`` takes
another source of the same tensors (the tests replay the reference's
key chain through it).
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
from repro_torch.core.selectors.functional import (ROUND_DRIVER, TELEMETRY,
                                                   not_ported)
from repro_torch.fed.client import (LocalSpec, make_eval_fn,
                                    make_local_update, make_loss_poll)
from repro_torch.optim import tree_map

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
    #: the reference's scanned round loop and telemetry groups: only
    #: their defaults (the host loop, no telemetry) are ported
    jit_rounds: bool = False
    telemetry: tuple = ()

    def __post_init__(self):
        if self.jit_rounds:
            raise not_ported("jit_rounds", self.jit_rounds, ROUND_DRIVER)
        if self.telemetry:
            raise not_ported("telemetry", self.telemetry, TELEMETRY)


class RoundDraws(NamedTuple):
    """All random inputs of one round, on the server's device."""
    select: SelectNoise
    perms: torch.Tensor          # (K, epochs, S_max) int64
    #: (N, 1, S_max) int64 for the all-clients poll (``full_all``)
    grad_perms: Optional[torch.Tensor] = None


def aggregate_params(new_params: dict) -> dict:
    """θ^{t+1} = (1/K) Σ θ_k over the cohort's stacked params (K, ...)."""
    return tree_map(lambda stacked: stacked.mean(dim=0), new_params)


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
    fedavg update of every client at the base lr,
    ``(params, x, y, mask, perms (N, 1, S_max)) -> (N, P)`` flattened
    θ_k − θ."""
    lu1 = make_local_update(apply_fn, dataclasses.replace(local, epochs=1))

    def grad_all(params, x, y, mask, perms):
        one = torch.ones((), dtype=torch.float32, device=x.device)
        new_params, _ = lu1(params, x, y, mask, perms, one)
        return flatten_params(new_params, lead=1) - flatten_params(params)

    return grad_all


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    return -torch.empty(shape).exponential_(generator=gen).log()


class FederatedServer:
    """Drives T rounds of federated training over padded client data.

    ``init_fn(gen, device)`` makes the initial params from the
    server's generator, which then draws every round's noise.
    """

    def __init__(self, init_fn, apply_fn, cfg: FedConfig,
                 client_x: np.ndarray, client_y: np.ndarray,
                 client_mask: np.ndarray,
                 test: Optional[Dict[str, np.ndarray]] = None,
                 device="cuda"):
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
        self._lu = make_local_update(apply_fn, cfg.local)
        self._eval = make_eval_fn(apply_fn)
        if "loss_all" in self.requires:
            self._poll = make_loss_poll(apply_fn)
        if "full_all" in self.requires:
            self._grad_all = make_grad_all(apply_fn, cfg.local)
        self.history: Dict[str, list] = {
            "round": [], "train_loss": [], "selected": [],
            "test_round": [], "test_loss": [], "test_acc": [],
            "bias_entropy": [], "wall_s": [],
        }

    def draw_round(self, t: int) -> RoundDraws:
        """Round t's Gumbel draws and permutations, from the server's
        generator on the CPU, moved to the device."""
        del t
        cfg, gen = self.cfg, self.gen
        n = cfg.num_clients
        k = min(cfg.num_select, n)
        s_max = self.x.shape[1]
        noise = SelectNoise(cover=_gumbel(gen, (n,)),
                            cluster=_gumbel(gen, (k, k)),
                            client=_gumbel(gen, (k, n)),
                            cluster_pick=_gumbel(gen, (k, n)))

        def perms(rows: int, epochs: int) -> torch.Tensor:
            return torch.stack([
                torch.stack([torch.randperm(s_max, generator=gen)
                             for _ in range(epochs)])
                for _ in range(rows)]).to(self.device)

        dev = self.device
        return RoundDraws(
            SelectNoise(*(a.to(dev) for a in noise)),
            perms(k, cfg.local.epochs),
            perms(n, 1) if "full_all" in self.requires else None)

    def local_update(self, t: int, ids: torch.Tensor,
                     perms: torch.Tensor):
        """The cohort's LocalUpdate from the current params: (K-stacked
        params, {"train_loss": (K,)}).  The lr halves every
        ``lr_decay_every`` rounds, passed as a tensor."""
        cfg, idx = self.cfg, ids.long()
        decay = torch.tensor(cfg.lr_decay, dtype=torch.float32,
                             device=self.device) ** (t // cfg.lr_decay_every)
        return self._lu(self.params, self.x[idx], self.y[idx],
                        self.mask[idx], perms[:idx.shape[0]], decay)

    def observe(self, params_before: dict, new_params: dict,
                grad_perms: Optional[torch.Tensor]) -> Observations:
        """What the selector ``requires``, against the aggregated
        ``self.params``; Δb against ``params_before``."""
        req = self.requires
        bias = losses = full = None
        if "bias_sel" in req:
            bias = head_bias_updates_stacked(params_before, new_params)
        if "loss_all" in req:
            losses = self._poll(self.params, self.x, self.y, self.mask)
        if "full_all" in req:
            full = self._grad_all(self.params, self.x, self.y, self.mask,
                                  grad_perms)
        elif "full_sel" in req:
            full = full_sel_updates(self.params, new_params)
        return Observations(bias_updates=bias, full_updates=full,
                            losses=losses)

    def step(self, t: int, rd: RoundDraws):
        """One round from the current params and selector state, with
        round t's draws: select, local update, aggregate, observe,
        update.  Returns (ids, the cohort's metrics)."""
        ids, self.state = self.selector.select(self.state, t, rd.select)
        new_params, metrics = self.local_update(t, ids, rd.perms)
        params_before = self.params
        self.params = aggregate_params(new_params)
        obs = self.observe(params_before, new_params, rd.grad_perms)
        self.state = self.selector.update(self.state, t, ids, obs)
        return ids, metrics

    def run(self, progress: bool = False,
            draws: Optional[Callable[[int], RoundDraws]] = None
            ) -> Dict[str, list]:
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
        wall = sum(self.history["wall_s"])
        self.history["rounds_per_s"] = cfg.rounds / wall if wall else None
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
