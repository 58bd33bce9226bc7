"""deepseek-coder-33b — llama-arch dense, GQA (KV 8), rope theta
100,000, at the widths of the reference's
``configs/deepseek_coder_33b.py``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b",
    kind="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=19200,
    vocab_size=32_256,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=100_000.0,
    long_context_mode="swa",
    source="arXiv:2401.14196",
))
