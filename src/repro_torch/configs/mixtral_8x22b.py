"""mixtral-8x22b — MoE, 8 experts top-2, GQA (KV 8), native sliding
window 4096, at the widths of the reference's
``configs/mixtral_8x22b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    kind="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32_768,
    head_dim=128,
    sliding_window=4096,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=1.25),
    long_context_mode="native",  # the window bounds the KV cache
    source="arXiv:2401.04088",
))
