"""npz checkpoints of param trees, in the reference's file format."""
from repro_torch.checkpoint.npz import (latest_step, load_pytree, restore,
                                        save_pytree)

__all__ = ["latest_step", "load_pytree", "restore", "save_pytree"]
