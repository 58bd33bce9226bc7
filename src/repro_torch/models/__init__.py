"""Models of the port: the paper's classifiers and, through
``get_model``, every LM family of the reference."""
from repro_torch.models.classifier import (cnn_apply, cnn_features,
                                           make_classifier,
                                           make_classifier_with_features,
                                           mlp_apply, mlp_features,
                                           params_from_jax)
from repro_torch.models.registry import (ModelApi, cache_specs, get_model,
                                         input_specs, supports_shape)

__all__ = ["ModelApi", "cache_specs", "cnn_apply", "cnn_features",
           "get_model", "input_specs", "make_classifier", "make_classifier_with_features", "mlp_apply",
           "mlp_features", "params_from_jax", "supports_shape"]
