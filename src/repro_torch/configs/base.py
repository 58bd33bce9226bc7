"""Model configs, input-shape configs and the registry of the port.

A copy of the reference's ``configs/base.py`` (the port imports nothing
of ``repro``): :class:`ModelConfig` with its sub-configs,
``resolved_head_dim()`` and ``reduced()`` as they are there, the
assigned input shapes, and ``register`` / ``get_config`` /
``list_archs``.  Each ``<arch>.py`` module of this package registers
one of the reference's configs: paper-cnn and paper-mlp (the HiCS-FL
slice), the decoder-only transformers qwen2.5-3b, qwen3-8b, gemma-7b
and deepseek-coder-33b (dense), granite-moe-1b-a400m and mixtral-8x22b
(MoE), pixtral-12b (the VLM prefix), and rwkv6-3b (ssm), zamba2-7b
(hybrid) and seamless-m4t-medium (audio encoder-decoder).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

ARCH_KINDS = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "classifier")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2-style SSD mixer config (used by ssm/hybrid archs)."""
    state_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    head_dim: int = 64
    chunk: int = 256


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_rank_decay: int = 64
    lora_rank_mix: int = 32


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2: mamba2 backbone + shared attention block every `period`."""
    attn_period: int = 6
    num_shared_blocks: int = 2


@dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 12
    cross_attn: bool = True
    max_source_frames: int = 4096


@dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 256
    patch_embed_dim: int = 1024


@dataclass(frozen=True)
class ModelConfig:
    name: str
    kind: str                    # one of ARCH_KINDS
    num_layers: int
    d_model: int
    num_heads: int               # query heads (0 for attn-free)
    num_kv_heads: int            # GQA kv heads
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int = 0      # 0 = full attention; >0 = SWA window
    rope_theta: float = 10000.0
    # mlp flavor: "swiglu" | "geglu" | "gelu"
    mlp: str = "swiglu"
    # normalization: "rmsnorm" | "layernorm"
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # multiply embeddings by sqrt(d_model)
    # HiCS-FL head option: the estimator reads Δb of the head
    lm_head_bias: bool = True
    # sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    # long-context handling for the long_500k shape:
    #   "native"  - O(1)-state decode (ssm/hybrid) or native SWA
    #   "swa"     - enable sliding-window (window below) only for long_500k
    #   "skip"    - pair skipped (no semantic long-context analogue)
    long_context_mode: str = "swa"
    long_context_window: int = 4096
    # provenance
    source: str = ""

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        small_moe = None
        if self.moe is not None:
            small_moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k))
        small_ssm = None
        if self.ssm is not None:
            small_ssm = dataclasses.replace(
                self.ssm, state_dim=min(16, self.ssm.state_dim),
                head_dim=32, chunk=32)
        small_rwkv = None
        if self.rwkv is not None:
            small_rwkv = dataclasses.replace(
                self.rwkv, head_dim=32, lora_rank_decay=8, lora_rank_mix=8)
        small_hybrid = None
        if self.hybrid is not None:
            small_hybrid = dataclasses.replace(
                self.hybrid, attn_period=1, num_shared_blocks=1)
        small_encdec = None
        if self.encdec is not None:
            small_encdec = dataclasses.replace(
                self.encdec, encoder_layers=2, max_source_frames=32)
        small_vlm = None
        if self.vlm is not None:
            small_vlm = dataclasses.replace(
                self.vlm, num_patches=8, patch_embed_dim=64)
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, heads // 2)) if heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=max(kv, 1) if heads else 0,
            head_dim=64 if heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            moe=small_moe, ssm=small_ssm, rwkv=small_rwkv,
            hybrid=small_hybrid, encdec=small_encdec, vlm=small_vlm,
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                    # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    if cfg.kind not in ARCH_KINDS:
        raise ValueError(f"unknown arch kind {cfg.kind!r}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """The registered config ``name``; an unknown name raises
    ``KeyError``."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def list_archs():
    """The registered arch names, sorted (the reference's
    ``list_archs``)."""
    return tuple(sorted(_REGISTRY))

