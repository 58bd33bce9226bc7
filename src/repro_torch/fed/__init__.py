"""Federated-learning runtime of the port: partitioning, the fedavg
client, the host-loop server and the experiment builder."""
from repro_torch.fed.client import LocalSpec, make_eval_fn, make_local_update
from repro_torch.fed.partition import (dirichlet_partition,
                                       multi_alpha_partition)
from repro_torch.fed.server import (FedConfig, FederatedServer, RoundDraws,
                                    aggregate_params, rounds_to_accuracy)
from repro_torch.fed.simulation import ExperimentSpec, build

__all__ = ["ExperimentSpec", "FedConfig", "FederatedServer", "LocalSpec",
           "RoundDraws", "aggregate_params", "build",
           "dirichlet_partition", "make_eval_fn", "make_local_update",
           "multi_alpha_partition", "rounds_to_accuracy"]
