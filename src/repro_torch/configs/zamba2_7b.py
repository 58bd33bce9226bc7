"""zamba2-7b — Mamba2 backbone (81 layers) with two weight-tied shared
transformer blocks applied alternately before every sixth layer, at the
widths of the reference's ``configs/zamba2_7b.py``: the shared
attention's head_dim is 112 (3584 / 32)."""
from repro_torch.configs.base import (HybridConfig, ModelConfig, SSMConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    kind="hybrid",
    num_layers=81,               # mamba2 blocks
    d_model=3584,
    num_heads=32,                # shared attention block heads
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=112,                # 3584 / 32
    mlp="swiglu",
    norm="rmsnorm",
    ssm=SSMConfig(state_dim=64, expand=2, conv_width=4, head_dim=64,
                  chunk=256),
    hybrid=HybridConfig(attn_period=6, num_shared_blocks=2),
    long_context_mode="native",
    source="arXiv:2411.15242",
))
