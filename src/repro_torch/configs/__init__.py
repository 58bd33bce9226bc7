"""Configs of the port: ``get_config(name)`` over the registered archs
(paper-cnn, paper-mlp, qwen2.5-3b, qwen3-8b)."""
from repro_torch.configs import (paper_cnn, qwen2_5_3b,  # noqa: F401
                                 qwen3_8b)
from repro_torch.configs.base import (ARCH_KINDS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config, register)

__all__ = ["ARCH_KINDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "register"]
