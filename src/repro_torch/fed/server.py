"""Federated server: the round loop of Algorithm 1 on one device.

Per round t:
  1. S^t ← select (ids, state = fn.select(state, t, noise))
  2. LocalUpdate for the K selected clients, as one batched cohort step
  3. θ^{t+1} ← (1/K) Σ_{k∈S^t} θ_k^t
  4. Δb^{(k)} from the head; state = fn.update(state, t, ids, Δb)

The port of the reference's host-loop ``FederatedServer.run``.  All of
a round's randomness (the selector's Gumbel draws and the cohort's
epoch permutations) is drawn in one place, :meth:`draw_round`, from
one ``torch.Generator`` on the CPU, and then moved to the device, so a
CPU run and a card run consume identical draws.  ``run(draws=...)``
takes another source of the same tensors (the tests replay the
reference's key chain through it).
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
from repro_torch.core.selectors import SelectNoise, hics_functional
from repro_torch.fed.client import LocalSpec, make_eval_fn, make_local_update
from repro_torch.optim import tree_map

SELECTORS = {"hics": hics_functional}


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


class RoundDraws(NamedTuple):
    """All random inputs of one round, on the server's device."""
    select: SelectNoise
    perms: torch.Tensor          # (K, epochs, S_max) int64


def aggregate_params(new_params: dict) -> dict:
    """θ^{t+1} = (1/K) Σ θ_k over the cohort's stacked params (K, ...)."""
    return tree_map(lambda stacked: stacked.mean(dim=0), new_params)


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
        if cfg.selector not in SELECTORS:
            raise KeyError(f"unknown selector {cfg.selector!r}; known: "
                           f"{sorted(SELECTORS)}")
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
        kw.setdefault("num_classes", head_num_classes(self.params) or 1)
        self.selector = SELECTORS[cfg.selector](
            num_clients=cfg.num_clients, num_select=cfg.num_select,
            total_rounds=cfg.rounds,
            weights=np.asarray(client_mask).sum(axis=1), device=dev, **kw)
        self.state = self.selector.init()
        self._lu = make_local_update(apply_fn, cfg.local)
        self._eval = make_eval_fn(apply_fn)
        self.history: Dict[str, list] = {
            "round": [], "train_loss": [], "selected": [],
            "test_round": [], "test_loss": [], "test_acc": [],
            "bias_entropy": [], "wall_s": [],
        }

    def draw_round(self, t: int) -> RoundDraws:
        """Round t's Gumbel draws and epoch permutations, from the
        server's generator on the CPU, moved to the device."""
        del t
        cfg, gen = self.cfg, self.gen
        n = cfg.num_clients
        k = min(cfg.num_select, n)
        s_max = self.x.shape[1]
        noise = SelectNoise(cover=_gumbel(gen, (n,)),
                            cluster=_gumbel(gen, (k, k)),
                            client=_gumbel(gen, (k, n)))
        perms = torch.stack([
            torch.stack([torch.randperm(s_max, generator=gen)
                         for _ in range(cfg.local.epochs)])
            for _ in range(k)])
        dev = self.device
        return RoundDraws(SelectNoise(*(a.to(dev) for a in noise)),
                          perms.to(dev))

    def run(self, progress: bool = False,
            draws: Optional[Callable[[int], RoundDraws]] = None
            ) -> Dict[str, list]:
        cfg = self.cfg
        draws = draws or self.draw_round
        for t in range(cfg.rounds):
            t_start = time.perf_counter()
            rd = draws(t)
            ids, self.state = self.selector.select(self.state, t, rd.select)
            idx = ids.long()
            # lr halves every lr_decay_every rounds, as a tensor
            decay = torch.tensor(cfg.lr_decay, dtype=torch.float32,
                                 device=self.device) ** (
                                     t // cfg.lr_decay_every)
            new_params, metrics = self._lu(
                self.params, self.x[idx], self.y[idx], self.mask[idx],
                rd.perms[:idx.shape[0]], decay)
            bias_updates = head_bias_updates_stacked(self.params,
                                                     new_params)
            self.params = aggregate_params(new_params)
            self.state = self.selector.update(self.state, t, ids,
                                              bias_updates)
            self.history["round"].append(t)
            self.history["train_loss"].append(
                float(metrics["train_loss"].mean()))
            self.history["selected"].append(ids.tolist())
            self.history["bias_entropy"].append(
                self.selector.entropies(self.state).tolist())
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
