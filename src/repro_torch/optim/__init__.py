"""Optimizers of the port: sgd, sgd-momentum and adam, global-norm
clipping, and the in-place forms of the LM fine-tuning driver."""
from repro_torch.optim.optimizers import (Optimizer, adam, apply_updates,
                                          clip_by_global_norm,
                                          clip_by_global_norm_, global_norm,
                                          sgd, sgd_momentum, tree_leaves,
                                          tree_map)

__all__ = ["Optimizer", "adam", "apply_updates", "clip_by_global_norm",
           "clip_by_global_norm_", "global_norm", "sgd", "sgd_momentum",
           "tree_leaves", "tree_map"]
