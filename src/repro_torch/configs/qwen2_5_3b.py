"""qwen2.5-3b — dense decoder, GQA (kv=2), QKV bias, at the widths of
the reference's ``configs/qwen2_5_3b.py``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2.5-3b",
    kind="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151_936,
    head_dim=128,
    qkv_bias=True,
    qk_norm=False,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    long_context_mode="swa",
    source="hf:Qwen/Qwen2.5-0.5B",
))
