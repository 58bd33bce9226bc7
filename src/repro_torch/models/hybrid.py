"""Zamba2-style hybrid (zamba2-7b): a Mamba2 backbone with weight-tied
shared transformer blocks (attention + MLP).

A port of the reference's ``models/hybrid.py``.  Before each group of
``attn_period`` mamba layers (the last group may be shorter) the shared
block ``site % num_shared_blocks`` is applied: the weights are shared
across sites, while each site keeps its own K/V cache at decode time.
The mamba layers are stacked on a leading axis and split once a
forward; each group takes its slice.  Compute is in ``dtype`` (f32
unless the caller asks for bf16; the SSD scan and its state stay f32,
as in the reference); the attention cache is bf16 (stacked over the
sites), the mamba conv inputs in the compute dtype after a prefill.  ``decode_step`` writes the token's K/V and each layer's SSD
state into the cache in place.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as TF
from repro_torch.sharding import (constrain, embed_lookup,
                                  gather_for_compute)


def group_sizes(cfg) -> List[int]:
    period = cfg.hybrid.attn_period
    n, out = cfg.num_layers, []
    while n > 0:
        out.append(min(period, n))
        n -= period
    return out


def num_attn_sites(cfg) -> int:
    return len(group_sizes(cfg))


def _init_shared_blocks(gen: torch.Generator, cfg) -> dict:
    d, dev = cfg.d_model, gen.device
    lead = (cfg.hybrid.num_shared_blocks,)
    return {
        "ln1": L.init_norm(d, cfg.norm, lead, device=dev),
        "attn": L.init_attention(gen, cfg, lead),
        "ln2": L.init_norm(d, cfg.norm, lead, device=dev),
        "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, lead),
    }


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device: the mamba layers and the
    shared blocks each stacked on axis 0."""
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, d)),
        "mamba": M.init_layer(gen, cfg, (cfg.num_layers,)),
        "shared": _init_shared_blocks(gen, cfg),
        "final_norm": L.init_norm(d, cfg.norm, device=dev),
        "lm_head": {"w": L.dense_init(gen, (d, cfg.vocab_size))},
    }
    if cfg.lm_head_bias:
        params["lm_head"]["b"] = torch.zeros(cfg.vocab_size, device=dev)
    return params


def _sites(params, cfg):
    """[(the site's shared block, its group's mamba layer indices)]."""
    shared = TF.unstack_layers(params["shared"],
                               cfg.hybrid.num_shared_blocks)
    out, start = [], 0
    for site, gs in enumerate(group_sizes(cfg)):
        out.append((shared[site % len(shared)], range(start, start + gs)))
        start += gs
    return out


def _shared_block(sp, x, cfg, attend):
    """The shared block around ``attend(attn params, normed x)`` ->
    (out, cache)."""
    a, kv = attend(sp["attn"], L.apply_norm(x, sp["ln1"], cfg.norm))
    x = x + a
    h = L.apply_norm(x, sp["ln2"], cfg.norm)
    return x + L.mlp_block(sp["mlp"], h, cfg.mlp), kv


# ---------------------------------------------------------------------------
# Train / prefill forward
# ---------------------------------------------------------------------------


def forward(params, tokens, cfg, *, dtype=torch.float32, window: int = 0,
            q_chunk: int = 128, collect_cache: bool = False,
            remat: bool = False):
    """Full-span forward in ``dtype`` over tokens (B, T).  Returns
    (hidden after the final norm, None or, with ``collect_cache``,
    {'kv': [(k, v) of each site], 'mamba': [each layer's mixer
    cache]}).  ``remat``: each shared block and mamba layer recomputed
    in the backward pass (``transformer.remat_call``)."""
    x = constrain(embed_lookup(params, tokens).to(dtype), "batch",
                  "seq", "embed")
    layers = TF.unstack_layers(params["mamba"], cfg.num_layers)
    kv_sites, mamba = [], []

    def attend(p, h):
        return L.attention_block(p, h, cfg, window=window, q_chunk=q_chunk)

    def mamba_layer(lp, x):
        out, cache = M.mixer_apply(lp, L.rms_norm(x, lp["ln"]["scale"]), cfg)
        return x + out, cache

    for sp, group in _sites(params, cfg):
        x, kv = TF.remat_call(lambda sp, x: _shared_block(sp, x, cfg, attend),
                              remat, sp, x)
        kv_sites.append(kv)
        for i in group:
            x, cache = TF.remat_call(mamba_layer, remat, layers[i], x)
            mamba.append(cache)
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return x, ({"kv": kv_sites, "mamba": mamba} if collect_cache else None)


def loss_fn(params, batch, cfg, *, dtype=torch.float32, window: int = 0,
            loss_chunk: int = 512, remat: bool = False):
    """The LM loss of {'tokens', 'targets' (B, S), optional 'loss_mask'}
    (the registry passes ``window=cfg.sliding_window``), the forward in
    ``dtype``."""
    x, _ = forward(params, batch["tokens"], cfg, dtype=dtype,
                   window=window, remat=remat)
    return TF.lm_loss(params, x, batch, cfg, loss_chunk)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _stack_mamba(caches: list) -> dict:
    return {name: torch.stack([c[name] for c in caches])
            for name in ("state", "conv")}


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    """Zero caches: K/V (sites, B, cache_len, KV, dh) in ``dtype`` and
    the mamba layers' {'state' f32, 'conv' in ``dtype``} stacked."""
    shape = (num_attn_sites(cfg), batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "mamba": M.init_cache_layer(cfg, batch, dtype, (cfg.num_layers,),
                                        device=device)}


def prefill(params, batch, cfg, *, dtype=torch.float32, window: int = 0,
            q_chunk: int = 128, cache_extra: int = 0):
    """Forward in ``dtype`` over the prompt {'tokens': (B, T)}:
    (last-token logits (B, 1, V) f32, the cache: the sites' K/V stacked
    in bf16 with ``cache_extra`` free slots, the mamba layers' caches
    stacked)."""
    x, cache = forward(params, batch["tokens"], cfg, dtype=dtype,
                       window=window, q_chunk=q_chunk, collect_cache=True)
    logits = TF.head_logits(params, x[:, -1:, :], cfg)
    out = {name: TF._pad_cache_seq(
        torch.stack([kv[j] for kv in cache["kv"]]).to(torch.bfloat16),
        cache_extra) for j, name in enumerate(("k", "v"))}
    out["mamba"] = _stack_mamba(cache["mamba"])
    return logits, out


def decode_step(params, cache, batch, cfg, *, window: int = 0,
                ring: bool = False, dtype=torch.float32):
    """One-token decode in ``dtype``.  batch: {'token': (B, 1), 'pos':
    int}.  Writes
    each site's K/V and each layer's SSD state into ``cache`` in place;
    the conv inputs are stacked anew in the compute dtype, as the
    reference's cache leaves come out.  Returns (logits (B, 1, V) f32,
    cache)."""
    token, pos = batch["token"], int(batch["pos"])
    x = embed_lookup(params, token).to(dtype)
    layers = TF.unstack_layers(params["mamba"], cfg.num_layers)
    mc = cache["mamba"]
    convs = []
    for site, (sp, group) in enumerate(_sites(params, cfg)):
        def attend(p, h, site=site):
            return L.attention_decode_block(
                p, h, cfg, cache["k"][site], cache["v"][site], pos,
                window=window, ring=ring)

        x, _ = _shared_block(gather_for_compute(sp), x, cfg, attend)
        for i in group:
            lp = gather_for_compute(layers[i])
            out, new = M.mixer_apply(lp, L.rms_norm(x, lp["ln"]["scale"]),
                                     cfg, {"state": mc["state"][i],
                                           "conv": mc["conv"][i]})
            x = x + out
            mc["state"][i] = new["state"]
            convs.append(new["conv"])
    cache["mamba"] = {"state": mc["state"], "conv": torch.stack(convs)}
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return TF.head_logits(params, x, cfg), cache
