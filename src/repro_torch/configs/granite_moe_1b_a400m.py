"""granite-moe-1b-a400m — MoE, 32 experts top-8, GQA (KV 8), tied
embeddings, at the widths of the reference's
``configs/granite_moe_1b_a400m.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    kind="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,                    # per-expert ffn width
    vocab_size=49_155,
    head_dim=64,
    mlp="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, top_k=8, capacity_factor=1.25),
    long_context_mode="swa",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
