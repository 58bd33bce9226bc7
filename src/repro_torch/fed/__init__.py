"""Federated-learning runtime of the port: partitioning, the client's
local updates (fedavg, fedprox, feddyn, moon), the server's two round
drivers, the buffered-async server with its ring buffer and latency
models, and the experiment builder."""
from repro_torch.fed.async_server import (AsyncConfig, AsyncFederatedServer,
                                          ticks_to_loss)
from repro_torch.fed.buffer import (RingBuffer, buffer_init, buffer_pop,
                                    buffer_push)
from repro_torch.fed.latency import LatencySpec, delay_tables, max_delay
from repro_torch.fed.client import (LocalSpec, init_extra, make_eval_fn,
                                    make_local_update, make_loss_poll)
from repro_torch.fed.partition import (dirichlet_partition,
                                       multi_alpha_partition)
from repro_torch.fed.server import (FedConfig, FederatedServer, RoundDraws,
                                    aggregate_params, flatten_params,
                                    full_sel_updates, make_grad_all,
                                    rounds_to_accuracy)
from repro_torch.fed.simulation import (PAPER_SETTINGS, ExperimentSpec, build,
                                        run_experiment)

__all__ = ["AsyncConfig", "AsyncFederatedServer", "ExperimentSpec",
           "FedConfig", "FederatedServer", "LatencySpec", "LocalSpec",
           "PAPER_SETTINGS", "RingBuffer", "RoundDraws", "aggregate_params",
           "buffer_init", "buffer_pop", "buffer_push", "build",
           "delay_tables", "dirichlet_partition", "flatten_params",
           "full_sel_updates", "init_extra", "make_eval_fn",
           "make_grad_all", "make_local_update", "make_loss_poll",
           "max_delay", "multi_alpha_partition", "rounds_to_accuracy",
           "run_experiment", "ticks_to_loss"]
