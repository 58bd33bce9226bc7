"""pixtral-12b — the multimodal projector and the 40-layer mistral-nemo
decoder (d 5120, H 32, GQA KV 8, head_dim 128: q proj 5120 -> 4096), at
the widths of the reference's ``configs/pixtral_12b.py``.  The vision
encoder is a stub there and here: a batch brings precomputed patch
embeddings (B, P, 1024), which the projector maps to d_model and
prepends to the tokens."""
from repro_torch.configs.base import ModelConfig, VLMConfig, register

CONFIG = register(ModelConfig(
    name="pixtral-12b",
    kind="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=131_072,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    vlm=VLMConfig(num_patches=256, patch_embed_dim=1024),
    long_context_mode="swa",
    source="hf:mistralai/Pixtral-12B-2409",
))
