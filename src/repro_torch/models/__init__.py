"""Models of the port: the paper's classifiers and the dense LM."""
from repro_torch.models.classifier import (cnn_apply, make_classifier,
                                           mlp_apply, params_from_jax)
from repro_torch.models.registry import ModelApi, get_model

__all__ = ["ModelApi", "cnn_apply", "get_model", "make_classifier",
           "mlp_apply", "params_from_jax"]
