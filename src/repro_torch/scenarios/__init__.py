"""Heterogeneity scenarios and the multi-seed sweep engine.

The port of the reference's ``scenarios`` package.  The paper's claim
is that HiCS-FL adapts *across heterogeneity profiles* (§4.1,
App. A.10); this package makes evaluating that claim cheap: partitions
are fixed-capacity tensors built from random draws given as inputs,
scenarios are declarative registry entries, and a multi-seed ×
multi-scenario × multi-selector sweep runs each cell's seeds in one
captured CUDA graph a round.

Quickstart::

    from repro_torch.scenarios import SweepSpec, run_sweep
    res = run_sweep(SweepSpec(scenarios=("mixed_80_20", "dir_mild"),
                              selectors=("hics", "random"), seeds=(0, 1)))
    print({k: v["final_acc_mean"] for k, v in res["grid"].items()})

Scenario registry → paper map:

  =================  =====================================================
  name               instantiates
  =================  =====================================================
  iid                no-heterogeneity sanity baseline
  dir_mild           App. A.10 single-α Dirichlet, α = 0.5
  dir_severe         §4.1 setting (3): every client severely imbalanced
  mixed_80_20        §4.1 setting (1): α = {1e-3..1e-2} ∪ {0.5}
  mixed_80_20_mild   §4.1 setting (2): α = {1e-3..1e-2} ∪ {0.2}
  shards2            pathological 2-label shards (McMahan; the regime
                     Briggs et al. arXiv:2004.11791 clusters on)
  quantity_skew      |B_k| ∝ Dir(β), labels IID — beyond the paper,
                     stresses the p_k ∝ |B_k| stage-2 sampler (Eq. 10)
  flaky_severe       severe skew + 30% per-round dropout, availability
                     fed into select as a mask (Fu arXiv:2211.01549 §V)
  diurnal_mixed      setting (1) under staggered duty-cycle windows
  stragglers_severe  severe skew + a 30% straggler cohort (async server)
  diurnal_heavy_tail setting (1), diurnal windows + lognormal latency
  flash_crowd        setting (1) with periodic burst arrivals
  =================  =====================================================

Modules: ``partition_device`` (the partitioner, draws as inputs),
``registry`` (Scenario specs and dataset materialization),
``availability`` (time-varying client masks and the ``masked_select``
combinator), ``sweep`` (the engine and its host reference).
"""
from repro_torch.scenarios.availability import (availability_mask,
                                                masked_select,
                                                replace_unavailable)
from repro_torch.scenarios.partition_device import (
    Partition, PartitionDraws, draw_partition, pack_assignment,
    partition_device, partition_label_distributions)
from repro_torch.scenarios.registry import (SCENARIOS, Scenario,
                                            get_scenario, make_dataset,
                                            materialize, scenario_key)
from repro_torch.scenarios.sweep import (SweepSpec, bench_sweep,
                                         build_async_pair, build_pair,
                                         run_async_sweep,
                                         run_host_reference, run_sweep,
                                         seed_keychain, serial_seconds)

__all__ = [
    "availability_mask", "masked_select", "replace_unavailable",
    "Partition", "PartitionDraws", "draw_partition", "pack_assignment",
    "partition_device", "partition_label_distributions",
    "SCENARIOS", "Scenario", "get_scenario", "make_dataset",
    "materialize", "scenario_key",
    "SweepSpec", "bench_sweep", "build_async_pair", "build_pair",
    "run_async_sweep", "run_host_reference", "run_sweep", "seed_keychain",
    "serial_seconds",
]
