"""Client models of the port."""
from repro_torch.models.classifier import (cnn_apply, make_classifier,
                                           mlp_apply, params_from_jax)

__all__ = ["cnn_apply", "make_classifier", "mlp_apply", "params_from_jax"]
