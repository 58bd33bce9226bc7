"""qwen3-8b — dense, qk_norm, GQA kv=8, at the widths of the
reference's ``configs/qwen3_8b.py``: the LM fine-tuning driver's
default arch (``--arch qwen3-8b``, reduced by default).  At full width
its f32 params, a client's copy and the gradients need ~98 GB, more
than one H100 holds, so the card trains qwen2.5-3b at full width."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-8b",
    kind="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=12288,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    long_context_mode="swa",
    source="hf:Qwen/Qwen3-8B",
))
