"""gemma-7b — dense, GeGLU (tanh gelu), head_dim 256 (q proj 3072 ->
4096), MHA (KV 16), tied and scaled embeddings, at the widths of the
reference's ``configs/gemma_7b.py``."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-7b",
    kind="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256_000,
    head_dim=256,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    scale_embeddings=True,
    long_context_mode="swa",
    source="arXiv:2403.08295",
))
