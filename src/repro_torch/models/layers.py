"""Layers of the decoder LM: initializers, norms, RoPE, attention
(prefill and decode), the KV-cache write and the MLPs.

A port of the reference's ``models/layers.py``: what the decoder-only
transformer, the hybrid's shared blocks and the encoder-decoder need,
cross-attention among it.
Params are nested dicts of tensors, in the reference's layouts:
(d_in, d_out) weights, heads split last, caches (B, S, KV, dh).  Init functions take a ``lead``
shape that is prepended to every tensor, so that the transformer can
stack its layers on a leading axis as the reference's vmapped init
does.

The numerics follow the reference where they decide tokens:
``rms_norm`` multiplies by ``1 + scale`` in f32; RoPE rotates split
halves with f32 angles; attention scores and softmax are f32, and the
probabilities are cast to the value dtype before the value product
(``_gqa_out``), so against a bf16 cache the attention output is
rounded to bf16 as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor

from repro_torch.sharding import (constrain_attn_q, local_attention,
                                  local_decode_attention, merge_heads,
                                  split_heads, write_slot)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: float | None = None):
    """Truncated normal on [-2, 2] times ``scale`` (default
    1/sqrt(fan_in), fan_in = shape[-2]), drawn on the generator's
    device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = 1.0 / math.sqrt(fan_in) if scale is None else scale
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def embed_init(gen: torch.Generator, shape):
    return torch.randn(shape, generator=gen, device=gen.device) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) * (x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def init_norm(d: int, kind: str, lead=(), *, device) -> dict:
    if kind == "rmsnorm":
        return {"scale": torch.zeros((*lead, d), device=device)}
    return {"scale": torch.ones((*lead, d), device=device),
            "bias": torch.zeros((*lead, d), device=device)}


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)            # (head_dim // 2,)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, dh); positions: broadcastable to (..., T).  The
    two halves of dh rotate together, as in the reference."""
    dh = x.shape[-1]
    freqs = rope_frequencies(dh, theta, x.device)
    angles = positions[..., None].float() * freqs   # (..., T, dh//2)
    cos = torch.cos(angles)[..., None, :]           # (..., T, 1, dh//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _gqa_scores(q, k, scale):
    """q: (B, Tq, KV, G, dh), k: (B, Tk, KV, dh) -> (B, KV, G, Tq, Tk) f32."""
    return torch.einsum("bqkgd,btkd->bkgqt", q.float(), k.float()) * scale


def _gqa_out(p, v):
    """p: (B, KV, G, Tq, Tk) f32, v: (B, Tk, KV, dh) -> (B, Tq, KV, G, dh)
    in v's dtype: p is cast to it first."""
    return torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_chunk: int = 128, q0: int = 0):
    """Attention for Tq > 1 (prefill).

    q: (B, Tq, H, dh); k, v: (B, Tk, KV, dh).  Returns (B, Tq, H, dh).
    The query axis runs in chunks of ``q_chunk``: Tq must be at most
    ``q_chunk`` or a multiple of it, as in the reference.  ``window > 0``
    masks to positions within [pos - window + 1, pos]; the queries sit
    at positions ``q0`` on.  A sharded q (a DTensor, under a sharding
    policy) runs on each rank's shard (``sharding.local_attention``).
    """
    if isinstance(q, DTensor):
        return local_attention(
            lambda ql, kl, vl, first: full_attention(
                ql, kl, vl, causal=causal, window=window, q_chunk=q_chunk,
                q0=first), q, k, v)
    b, tq, h, dh = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, tq, kv, g, dh)
    kpos = torch.arange(tk, device=q.device)

    def attend(qc, qpos):
        s = _gqa_scores(qc, k, scale)            # (B, KV, G, Cq, Tk)
        if causal:
            m = qpos[:, None] >= kpos[None, :]
            if window:
                m &= qpos[:, None] < kpos[None, :] + window
            s = torch.where(m, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        return _gqa_out(p, v).reshape(qc.shape[0], qc.shape[1], h, dh)

    if tq <= q_chunk:
        return attend(qg, torch.arange(q0, q0 + tq, device=q.device))
    if tq % q_chunk:
        raise ValueError(f"Tq={tq} not divisible by q_chunk={q_chunk}")
    return torch.cat([
        attend(qg[:, i:i + q_chunk],
               torch.arange(q0 + i, q0 + i + q_chunk, device=q.device))
        for i in range(0, tq, q_chunk)], dim=1)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: int = 0,
                     ring: bool = False):
    """Single-token attention against a KV cache, the model's own path
    (probabilities rounded to the cache dtype, as in the reference; the
    hand-written kernel of ``kernels/decode_attention.py`` keeps them
    f32 and is not this function).

    q: (B, 1, H, dh); caches: (B, S, KV, dh); pos: the position of the
    current token (the number of tokens cached before it).  With
    ``ring=True`` the cache is a ring buffer of the last S positions.
    A sharded cache (a DTensor) runs on each rank's shard, the softmax
    merged across sharded positions
    (``sharding.local_decode_attention``).
    """
    s = k_cache.shape[1]

    def scores_of(q, k_cache, s0=0):
        b, _, h, dh = q.shape
        kv = k_cache.shape[2]
        qg = q.reshape(b, 1, kv, h // kv, dh)
        scores = _gqa_scores(qg, k_cache, 1.0 / math.sqrt(dh))
        slot = torch.arange(s0, s0 + k_cache.shape[1], device=q.device)
        if ring:
            valid = slot < min(pos + 1, s)
        else:
            valid = slot <= pos
            if window:
                valid &= slot > pos - window
        return torch.where(valid, scores, NEG_INF)   # (B, KV, G, 1, S)

    if isinstance(k_cache, DTensor):
        return local_decode_attention(
            lambda ql, kl, vl, s0: (
                scores_of(ql, kl, s0),
                lambda p: _gqa_out(p, vl).reshape(ql.shape)),
            q, k_cache, v_cache)
    p = torch.softmax(scores_of(q, k_cache), dim=-1)
    return _gqa_out(p, v_cache).reshape(q.shape)


def cache_update(k_cache, v_cache, k_new, v_new, pos: int, *,
                 ring: bool = False):
    """Write k_new/v_new (B, 1, KV, dh) at slot ``pos`` (ring: pos % S),
    in place.  A slot past the cache raises (the reference's update
    would clamp it onto the last slot): prefill leaves headroom."""
    idx = pos % k_cache.shape[1] if ring else pos
    if isinstance(k_cache, DTensor):
        return (write_slot(k_cache, k_new, idx),
                write_slot(v_cache, v_new, idx))
    k_cache[:, idx] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, idx] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# Attention blocks (projection + rope + attend)
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg, lead=()) -> dict:
    d, h, kv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    p = {
        "wq": dense_init(gen, (*lead, d, h * dh)),
        "wk": dense_init(gen, (*lead, d, kv * dh)),
        "wv": dense_init(gen, (*lead, d, kv * dh)),
        "wo": dense_init(gen, (*lead, h * dh, d)),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * dh), device=dev)
        p["bk"] = torch.zeros((*lead, kv * dh), device=dev)
        p["bv"] = torch.zeros((*lead, kv * dh), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, dh), device=dev)
        p["k_norm"] = torch.zeros((*lead, dh), device=dev)
    return p


def _project_qkv(p, x, cfg, positions):
    b, t, _ = x.shape
    h, kv = cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim()
    q = x @ p["wq"].to(x.dtype)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = split_heads(q, h, dh)
    k = split_heads(k, kv, dh)
    v = split_heads(v, kv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, x, cfg, *, window: int = 0, q_chunk: int = 128,
                    shard_q: bool = False):
    """Causal self-attention over x (B, T, d) at positions 0..T-1.
    Returns (out, (k, v)): the roped K and V are the prefill's cache.
    ``shard_q``: q takes the policy's attention sharding
    (``sharding.constrain_attn_q``; nothing outside a policy)."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if shard_q:
        q = constrain_attn_q(q)
    out = full_attention(q, k, v, causal=True, window=window,
                         q_chunk=q_chunk)
    out = merge_heads(out) @ p["wo"].to(x.dtype)
    return out, (k, v)


def attention_decode_block(p, x, cfg, k_cache, v_cache, pos: int, *,
                           window: int = 0, ring: bool = False):
    """Single-token self-attention step, x (B, 1, d); writes the token's
    K/V into the caches in place.  Returns (out, (k_cache, v_cache))."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    k_cache, v_cache = cache_update(k_cache, v_cache, k, v, pos, ring=ring)
    out = decode_attention(q, k_cache, v_cache, pos, window=window,
                           ring=ring)
    out = merge_heads(out).to(x.dtype) @ p["wo"].to(x.dtype)
    return out, (k_cache, v_cache)


def init_cross_attention(gen: torch.Generator, cfg, lead=()) -> dict:
    """Cross-attention: queries from the decoder, keys and values from
    the encoder; the self-attention's layout."""
    return init_attention(gen, cfg, lead)


def cross_attention_block(p, x, enc_k, enc_v, cfg):
    """x (B, Tq, d) against the encoder's precomputed enc_k / enc_v
    (B, Tk, KV, dh): no RoPE and no mask on either side."""
    b, t, _ = x.shape
    h, dh = cfg.num_heads, cfg.resolved_head_dim()
    q = x @ p["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    out = full_attention(split_heads(q, h, dh), enc_k, enc_v, causal=False)
    return merge_heads(out) @ p["wo"].to(x.dtype)


def cross_kv(p, enc_out, cfg):
    """The cross-attention's K and V (B, Tk, KV, dh) of the encoder's
    output (B, Tk, d)."""
    b, tk, _ = enc_out.shape
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    k = enc_out @ p["wk"].to(enc_out.dtype)
    v = enc_out @ p["wv"].to(enc_out.dtype)
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k.reshape(b, tk, kv, dh), v.reshape(b, tk, kv, dh)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, ff: int, kind: str,
             lead=()) -> dict:
    if kind in ("swiglu", "geglu"):
        return {"wi0": dense_init(gen, (*lead, d, ff)),
                "wi1": dense_init(gen, (*lead, d, ff)),
                "wo": dense_init(gen, (*lead, ff, d))}
    return {"wi0": dense_init(gen, (*lead, d, ff)),
            "wo": dense_init(gen, (*lead, ff, d))}


def mlp_block(p, x, kind: str):
    """jax.nn.gelu's default is the tanh approximation; so is this."""
    w0 = p["wi0"].to(x.dtype)
    wo = p["wo"].to(x.dtype)
    if kind == "swiglu":
        h = F.silu(x @ w0) * (x @ p["wi1"].to(x.dtype))
    elif kind == "geglu":
        h = F.gelu(x @ w0, approximate="tanh") * (x @ p["wi1"].to(x.dtype))
    else:  # gelu
        h = F.gelu(x @ w0, approximate="tanh")
    return h @ wo
