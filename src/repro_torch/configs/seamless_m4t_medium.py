"""seamless-m4t-medium — encoder-decoder (12 + 12 layers) over frame
embeddings with cross-attention and a 256,206-token vocabulary, at the
widths of the reference's ``configs/seamless_m4t_medium.py``.  The
audio frontend is a stub there too: the model reads precomputed frame
embeddings (B, frames, d_model)."""
from repro_torch.configs.base import EncDecConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    kind="audio",
    num_layers=12,               # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    head_dim=64,
    mlp="gelu",
    norm="layernorm",
    encdec=EncDecConfig(encoder_layers=12, cross_attn=True,
                        max_source_frames=4096),
    long_context_mode="skip",    # no long-context analogue
    source="arXiv:2308.11596",
))
