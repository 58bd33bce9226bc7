"""Configs of the port: ``get_config(name)`` over every arch the
reference registers (paper-cnn, paper-mlp, qwen2.5-3b, qwen3-8b,
gemma-7b, deepseek-coder-33b, granite-moe-1b-a400m, mixtral-8x22b,
pixtral-12b, rwkv6-3b, zamba2-7b, seamless-m4t-medium)."""
from repro_torch.configs import (deepseek_coder_33b, gemma_7b,  # noqa: F401
                                 granite_moe_1b_a400m, mixtral_8x22b,
                                 paper_cnn, pixtral_12b, qwen2_5_3b,
                                 qwen3_8b, rwkv6_3b, seamless_m4t_medium,
                                 zamba2_7b)
from repro_torch.configs.base import (ARCH_KINDS, SHAPES, ModelConfig,
                                      ShapeConfig, get_config, list_archs,
                                      register)

__all__ = ["ARCH_KINDS", "SHAPES", "ModelConfig", "ShapeConfig",
           "get_config", "list_archs", "register"]
