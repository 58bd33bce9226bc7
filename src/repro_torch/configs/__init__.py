"""Configs of the port: ``get_config(name)`` over the registered archs
(paper-cnn, paper-mlp and the decoder-only transformer family:
qwen2.5-3b, qwen3-8b, gemma-7b, deepseek-coder-33b,
granite-moe-1b-a400m, mixtral-8x22b, pixtral-12b)."""
from repro_torch.configs import (deepseek_coder_33b, gemma_7b,  # noqa: F401
                                 granite_moe_1b_a400m, mixtral_8x22b,
                                 paper_cnn, pixtral_12b, qwen2_5_3b,
                                 qwen3_8b)
from repro_torch.configs.base import (ARCH_KINDS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config, register)

__all__ = ["ARCH_KINDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "register"]
