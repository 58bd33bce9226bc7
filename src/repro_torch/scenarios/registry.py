"""Declarative heterogeneity scenarios and the named registry.

The port of the reference's ``scenarios/registry.py``.  A
:class:`Scenario` bundles what makes one evaluation regime
reproducible: the partition scheme (kind and its knobs), the
synthetic-data spec, a client-availability schedule and an
arrival-latency model.  ``SCENARIOS`` maps names to specs (see
``repro_torch.scenarios``).  :func:`materialize` turns (scenario, seed)
into a partition of the shared train set: the base dataset comes from
the scenario's ``data_seed`` (shared across sweep seeds, so every seed
sees the same task; numpy's generator, so it is the reference's bit for
bit), the partition from a generator seeded by :func:`scenario_key`.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.data import SyntheticSpec, make_train_test
from repro_torch.fed.latency import LatencySpec
from repro_torch.scenarios.partition_device import (Partition,
                                                    PartitionDraws,
                                                    draw_partition,
                                                    partition_device)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One heterogeneity regime, fully declarative."""
    name: str
    kind: str = "dirichlet"       # dirichlet|multi_alpha|shards|quantity|iid
    alphas: Tuple[float, ...] = (0.5,)
    labels_per_client: int = 2    # shards
    beta: float = 0.5             # quantity skew concentration
    availability: str = "always"  # always | dropout | blocks
    avail_p: float = 0.0          # dropout prob / blocks off-duty fraction
    avail_period: int = 4         # blocks cycle length (rounds)
    data: SyntheticSpec = dataclasses.field(default_factory=SyntheticSpec)
    #: arrival-latency model for the buffered-async server (sync
    #: drivers ignore it; identity = async degenerates to sync)
    latency: LatencySpec = dataclasses.field(default_factory=LatencySpec)
    paper: str = ""               # paper section this regime instantiates

    def draw(self, gen: torch.Generator, num_samples: int,
             num_classes: int, num_clients: int) -> PartitionDraws:
        """This scenario's partition draws, on the CPU from ``gen``."""
        return draw_partition(
            gen, self.kind, num_samples, num_classes, num_clients,
            alphas=self.alphas, labels_per_client=self.labels_per_client,
            beta=self.beta)

    def partition(self, draws: PartitionDraws, labels: torch.Tensor,
                  num_classes: int, num_clients: int,
                  cap: int) -> Partition:
        """The partition ``draws`` define, on the labels' device."""
        return partition_device(
            draws, labels, num_classes, num_clients, self.kind, cap,
            alphas=self.alphas, labels_per_client=self.labels_per_client,
            beta=self.beta)

    @property
    def time_varying(self) -> bool:
        return self.availability != "always"


#: §4.1's FMNIST-block concentration settings, reused across registries.
SETTING1 = (0.001, 0.002, 0.005, 0.01, 0.5)
SETTING2 = (0.001, 0.002, 0.005, 0.01, 0.2)

SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    Scenario("iid", kind="iid",
             paper="sanity baseline (no heterogeneity)"),
    Scenario("dir_mild", kind="dirichlet", alphas=(0.5,),
             paper="App. A.10 single-α Dirichlet, α=0.5"),
    Scenario("dir_severe", kind="dirichlet", alphas=(0.001,),
             paper="§4.1 setting (3): all clients severely imbalanced"),
    Scenario("mixed_80_20", kind="multi_alpha", alphas=SETTING1,
             paper="§4.1 setting (1): 80% severe + 20% balanced"),
    Scenario("mixed_80_20_mild", kind="multi_alpha", alphas=SETTING2,
             paper="§4.1 setting (2): 80% severe + 20% mild"),
    Scenario("shards2", kind="shards", labels_per_client=2,
             paper="pathological 2-label shards (McMahan; Briggs "
                   "arXiv:2004.11791 motivates clustering on it)"),
    Scenario("quantity_skew", kind="quantity", beta=0.5,
             paper="beyond the paper: |B_k| ∝ Dir(0.5), labels IID — "
                   "stresses the p_k∝|B_k| stage-2 sampler"),
    Scenario("flaky_severe", kind="dirichlet", alphas=(0.01,),
             availability="dropout", avail_p=0.3,
             paper="beyond the paper: severe skew + 30% per-round "
                   "client dropout (Fu arXiv:2211.01549 §V)"),
    Scenario("diurnal_mixed", kind="multi_alpha", alphas=SETTING1,
             availability="blocks", avail_p=0.25, avail_period=4,
             paper="beyond the paper: setting (1) with staggered "
                   "diurnal availability windows"),
    # --- async traffic-shape family (repro_torch.fed.async_server) -----
    Scenario("stragglers_severe", kind="dirichlet", alphas=(0.01,),
             latency=LatencySpec(kind="stragglers", straggler_frac=0.3,
                                 straggler_delay=6),
             paper="beyond the paper: severe skew + a 30% straggler "
                   "cohort 6 ticks slow (FedBuff-style system "
                   "heterogeneity; Fu arXiv:2211.01549 §IV)"),
    Scenario("diurnal_heavy_tail", kind="multi_alpha", alphas=SETTING1,
             availability="blocks", avail_p=0.25, avail_period=4,
             latency=LatencySpec(kind="lognormal", mu=0.3, scale=0.9),
             paper="beyond the paper: setting (1), diurnal windows + "
                   "heavy-tail lognormal arrival latency"),
    Scenario("flash_crowd", kind="multi_alpha", alphas=SETTING1,
             latency=LatencySpec(kind="flash_crowd", period=6),
             paper="beyond the paper: setting (1) with periodic burst "
                   "arrivals — the ring buffer's overflow stress test"),
)}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}") from None


def scenario_key(scenario: Scenario, seed: int) -> int:
    """The seed of the partition's generator: the scenario's identity
    (crc32 of its name, so stable across processes, unlike ``hash``)
    in the high 32 bits and the sweep seed in the low 32.  It never
    equals a training seed below 2**32, so the partition's draws are
    independent of the training run's and adding scenarios perturbs no
    run."""
    return ((zlib.crc32(scenario.name.encode()) & 0x7FFFFFFF) << 32) | (
        int(seed) & 0xFFFFFFFF)


def make_dataset(scenario: Scenario, samples_train: int, samples_test: int,
                 num_classes: int, data_seed: int = 0, device="cuda"):
    """The scenario's base dataset (shared across sweep seeds): the
    train/test split of the synthetic Gaussian-mixture task as tensors
    on ``device``, and the class prototypes (numpy)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(
        (zlib.crc32(scenario.name.encode()) ^ data_seed) & 0x7FFFFFFF)
    data_spec = dataclasses.replace(scenario.data, num_classes=num_classes)
    train, test, protos = make_train_test(rng, data_spec, samples_train,
                                          samples_test)
    as_dev = lambda d: {k: torch.as_tensor(v, device=dev)
                        for k, v in d.items()}
    return as_dev(train), as_dev(test), protos


def partition_generator(scenario: Scenario, seed: int) -> torch.Generator:
    """The CPU generator the partition of (scenario, seed) is drawn
    from."""
    return torch.Generator().manual_seed(scenario_key(scenario, seed))


def materialize(scenario: Scenario, seed: int, train: dict,
                num_classes: int, num_clients: int, cap: int) -> Partition:
    """(scenario, seed) -> partition of the shared train set, drawn on
    the CPU and built on the train labels' device."""
    labels = train["y"]
    draws = scenario.draw(partition_generator(scenario, seed),
                          labels.shape[0], num_classes, num_clients)
    return scenario.partition(draws, labels, num_classes, num_clients, cap)
