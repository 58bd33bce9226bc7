"""rwkv6-3b (Finch) — attention-free token mixer with data-dependent
decay, at the widths of the reference's ``configs/rwkv6_3b.py``."""
from repro_torch.configs.base import ModelConfig, RWKVConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    kind="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=0,                 # attention-free
    num_kv_heads=0,
    d_ff=8960,
    vocab_size=65_536,
    mlp="rwkv_channel_mix",      # rwkv channel-mix (squared relu)
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64, lora_rank_decay=64, lora_rank_mix=32),
    long_context_mode="native",  # O(1) recurrent state decode
    source="arXiv:2404.05892",
))
