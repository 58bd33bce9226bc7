"""Encoder-decoder backbone of seamless-m4t-medium (audio frames to
text).

A port of the reference's ``models/encdec.py``.  As there, the audio
frontend is a stub: the model reads precomputed frame embeddings
``frames`` (B, F, d_model).  The bidirectional encoder (RoPE'd
self-attention in query chunks of 128, so F is at most 128 or a
multiple of it) feeds every decoder layer's cross-attention, whose K/V
the decoder computes per layer from the encoder's output.  Compute is
in ``dtype`` (f32 unless the caller asks for bf16; the frames are cast
to it, every weight to the activations' dtype where it is used).  The prefill's cache holds the self-attention K/V (with
``cache_extra`` free slots) and the cross K/V ``xk``/``xv`` at length
F, all bf16; ``decode_step`` writes the token's self-attention K/V in
place and reads the cross caches back in the compute dtype.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.sharding import (constrain, constrain_attn_q,
                                  embed_lookup, gather_for_compute,
                                  merge_heads)


def _init_layers(gen: torch.Generator, cfg, n: int, cross: bool) -> dict:
    d, dev, lead = cfg.d_model, gen.device, (n,)
    out = {"ln1": L.init_norm(d, cfg.norm, lead, device=dev),
           "attn": L.init_attention(gen, cfg, lead)}
    if cross:
        out["ln_x"] = L.init_norm(d, cfg.norm, lead, device=dev)
        out["xattn"] = L.init_cross_attention(gen, cfg, lead)
    out["ln2"] = L.init_norm(d, cfg.norm, lead, device=dev)
    out["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, lead)
    return out


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, the encoder's and the
    decoder's layers each stacked on axis 0."""
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, d)),
        "encoder": _init_layers(gen, cfg, cfg.encdec.encoder_layers, False),
        "enc_norm": L.init_norm(d, cfg.norm, device=dev),
        "decoder": _init_layers(gen, cfg, cfg.num_layers, True),
        "final_norm": L.init_norm(d, cfg.norm, device=dev),
        "lm_head": {"w": L.dense_init(gen, (d, cfg.vocab_size))},
    }
    if cfg.lm_head_bias:
        params["lm_head"]["b"] = torch.zeros(cfg.vocab_size, device=dev)
    return params


def encode(params, frames, cfg, *, q_chunk: int = 128, remat: bool = False):
    """frames (B, F, d) -> the encoder's output (B, F, d).  ``remat``:
    each layer recomputed in the backward pass
    (``transformer.remat_call``)."""
    b, f, _ = frames.shape
    positions = torch.arange(f, device=frames.device)[None, :]

    def layer(lp, x):
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        q, k, v = L._project_qkv(lp["attn"], h, cfg, positions)
        q = constrain_attn_q(q)
        a = L.full_attention(q, k, v, causal=False, q_chunk=q_chunk)
        y = x + merge_heads(a) @ lp["attn"]["wo"].to(x.dtype)
        h = L.apply_norm(y, lp["ln2"], cfg.norm)
        return y + L.mlp_block(lp["mlp"], h, cfg.mlp)

    x = constrain(frames, "batch", "seq", "embed")
    for lp in TF.unstack_layers(params["encoder"],
                                cfg.encdec.encoder_layers):
        x = TF.remat_call(layer, remat, lp, x)
    return L.apply_norm(x, params["enc_norm"], cfg.norm)


def decode_train(params, tokens, enc_out, cfg, *, q_chunk: int = 128,
                 collect_kv: bool = False, remat: bool = False):
    """The teacher-forced decoder over tokens (B, T) against the
    encoder's output.  Returns (hidden after the final norm, None or,
    with ``collect_kv``, (k, v, xk, xv) each stacked over the layers).
    ``remat``: as :func:`encode`."""
    x = embed_lookup(params, tokens).to(enc_out.dtype)
    x = constrain(x, "batch", "seq", "embed")
    kvs = []

    def layer(lp, x, enc_out):
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        a, (k, v) = L.attention_block(lp["attn"], h, cfg, q_chunk=q_chunk,
                                      shard_q=True)
        y = x + a
        h = L.apply_norm(y, lp["ln_x"], cfg.norm)
        ek, ev = L.cross_kv(lp["xattn"], enc_out, cfg)
        y = y + L.cross_attention_block(lp["xattn"], h, ek, ev, cfg)
        h = L.apply_norm(y, lp["ln2"], cfg.norm)
        return y + L.mlp_block(lp["mlp"], h, cfg.mlp), (k, v, ek, ev)

    for lp in TF.unstack_layers(params["decoder"], cfg.num_layers):
        x, kv = TF.remat_call(layer, remat, lp, x, enc_out)
        if collect_kv:
            kvs.append(kv)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    if not collect_kv:
        return x, None
    return x, tuple(torch.stack(t) for t in zip(*kvs))


def loss_fn(params, batch, cfg, *, dtype=torch.float32, loss_chunk: int = 512,
            remat: bool = False):
    """The LM loss of {'frames' (B, F, d), 'tokens', 'targets' (B, S),
    optional 'loss_mask'}, in ``dtype``; ``remat`` as :func:`encode`."""
    enc = encode(params, batch["frames"].to(dtype), cfg, remat=remat)
    x, _ = decode_train(params, batch["tokens"], enc, cfg, remat=remat)
    return TF.lm_loss(params, x, batch, cfg, loss_chunk)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, cache_len: int, source_len: int,
               dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero caches: self-attention K/V (L, B, cache_len, KV, dh) and
    cross K/V (L, B, source_len, KV, dh), all in ``dtype``."""
    kv, dh = cfg.num_kv_heads, cfg.resolved_head_dim()
    lead = (cfg.num_layers, batch)

    def zeros(n):
        return torch.zeros((*lead, n, kv, dh), dtype=dtype, device=device)

    return {"k": zeros(cache_len), "v": zeros(cache_len),
            "xk": zeros(source_len), "xv": zeros(source_len)}


def prefill(params, batch, cfg, *, dtype=torch.float32, cache_extra: int = 0):
    """Encode {'frames': (B, F, d)} and run the decoder over {'tokens':
    (B, T)}, in ``dtype``: (last-token logits (B, 1, V) f32, the bf16
    cache: self K/V with ``cache_extra`` free slots, cross K/V at length
    F)."""
    enc = encode(params, batch["frames"].to(dtype), cfg)
    x, (k, v, ek, ev) = decode_train(params, batch["tokens"], enc, cfg,
                                     collect_kv=True)
    logits = TF.head_logits(params, x[:, -1:, :], cfg)
    bf16 = torch.bfloat16
    cache = {"k": TF._pad_cache_seq(k, cache_extra).to(bf16),
             "v": TF._pad_cache_seq(v, cache_extra).to(bf16),
             "xk": ek.to(bf16), "xv": ev.to(bf16)}
    return logits, cache


def decode_step(params, cache, batch, cfg, *, dtype=torch.float32):
    """One decoder token {'token': (B, 1), 'pos': int} in ``dtype``
    against the self-attention cache (written in place) and the cross
    caches.  Returns (logits (B, 1, V) f32, cache)."""
    token, pos = batch["token"], int(batch["pos"])
    x = embed_lookup(params, token).to(dtype)
    for i, lp in enumerate(TF.unstack_layers(params["decoder"],
                                             cfg.num_layers)):
        lp = gather_for_compute(lp)
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        a, _ = L.attention_decode_block(lp["attn"], h, cfg, cache["k"][i],
                                        cache["v"][i], pos)
        y = x + a
        h = L.apply_norm(y, lp["ln_x"], cfg.norm)
        y = y + L.cross_attention_block(lp["xattn"], h,
                                        cache["xk"][i].to(x.dtype),
                                        cache["xv"][i].to(x.dtype), cfg)
        h = L.apply_norm(y, lp["ln2"], cfg.norm)
        x = y + L.mlp_block(lp["mlp"], h, cfg.mlp)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return TF.head_logits(params, x, cfg), cache
