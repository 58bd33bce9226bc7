"""Optimizers of the port (sgd; momentum and adam are still to port)."""
from repro_torch.optim.optimizers import (Optimizer, apply_updates, sgd,
                                          tree_map)

__all__ = ["Optimizer", "apply_updates", "sgd", "tree_map"]
