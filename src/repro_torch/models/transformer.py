"""Decoder-only transformer LM covering the dense, MoE and VLM configs:
init, forward, the training loss, prefill and one-token decode against
a bf16 KV cache.

A port of the reference's ``models/transformer.py``; the other
families (``rwkv.py``, ``hybrid.py``, ``encdec.py``) share its layer
stacking, head and loss helpers.  Layers are stacked on a leading axis
as in the reference (its vmapped init), and run in a Python loop
over that axis in place of ``lax.scan``: each stacked leaf is split
once a forward (``torch.unbind``), whose backward is one ``stack``,
where indexing each layer would write a zero-filled gradient of the
whole stacked leaf per layer.  A MoE
config's layers take ``models/moe.py``'s block in place of the MLP,
and its per-layer aux terms are stacked over the layers as the scan
stacks them.  A VLM config projects a batch's ``patches`` (B, P,
patch_embed_dim) to d_model and prepends them to the tokens, so the
positions run over P + S; the loss reads the text positions only.
Compute is in ``dtype`` (f32 unless the caller asks for bf16, as the
reference's functions take it): the embeddings are cast to it and every
weight is cast to the activations' dtype where it is used, while norms,
RoPE, attention scores and softmax, the router and the logits run in
f32, as the reference casts them.  The cache is bf16, as the
reference's ``prefill`` and serve path keep it.  Unlike the reference, ``decode_step`` writes the
new token's K/V into the cache tensors in place (no copy of the cache
per token) and returns the same dict.  The reference's
``jax.checkpoint`` of each layer does not change the numbers; the port
keeps the activations.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.losses import chunked_lm_loss
from repro_torch.sharding import (constrain, constrain_kv, current_policy,
                                  embed_lookup, embed_table,
                                  gather_for_compute, unbind_layers)


# ---------------------------------------------------------------------------
# Window / cache geometry
# ---------------------------------------------------------------------------


def effective_window(cfg, seq_len: int, long_context: bool) -> int:
    if long_context:
        if cfg.long_context_mode == "native":
            return cfg.sliding_window
        if cfg.long_context_mode == "swa":
            return cfg.long_context_window
    return cfg.sliding_window


def cache_geometry(cfg, seq_len: int, long_context: bool):
    """(cache_len, ring): sliding-window decode uses a ring buffer of
    the window size."""
    w = effective_window(cfg, seq_len, long_context)
    if w and w < seq_len:
        return w, True
    return seq_len, False


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, layers stacked on axis 0."""
    dev, d = gen.device, cfg.d_model
    lead = (cfg.num_layers,)
    layers = {
        "ln1": L.init_norm(d, cfg.norm, lead, device=dev),
        "attn": L.init_attention(gen, cfg, lead),
        "ln2": L.init_norm(d, cfg.norm, lead, device=dev),
    }
    if cfg.moe is not None:
        layers["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.moe, lead)
    else:
        layers["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp, lead)
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, d)),
        "layers": layers,
        "final_norm": L.init_norm(d, cfg.norm, device=dev),
    }
    head = {}
    if not cfg.tie_embeddings:
        head["w"] = L.dense_init(gen, (d, cfg.vocab_size))
    if cfg.lm_head_bias:
        head["b"] = torch.zeros(cfg.vocab_size, device=dev)
    if head:
        params["lm_head"] = head
    if cfg.vlm is not None:
        params["projector"] = {
            "w": L.dense_init(gen, (cfg.vlm.patch_embed_dim, d)),
            "b": torch.zeros(d, device=dev)}
    return params


def params_from_jax(tree, device="cuda"):
    """Carry a reference param tree (nested dicts of numpy arrays) over
    as it is: the port keeps the reference's layouts."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def unstack_layers(layers: dict, n: int) -> list:
    """The per-layer param dicts of a stacked tree: each stacked leaf
    split once into ``n`` views (``torch.unbind``)."""
    split = {k: unstack_layers(v, n) if isinstance(v, dict)
             else unbind_layers(v) for k, v in layers.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _gathered(fn, params, *args):
    return fn(gather_for_compute(params), *args)


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, ``args[0]`` the layer's params; with ``remat``
    under autograd its activations are recomputed in the backward pass
    rather than kept (the reference's ``jax.checkpoint`` of each layer):
    the same numbers, one layer's activations live at a time.  Under a
    sharding policy the params are gathered for compute inside the
    call (``sharding.gather_for_compute``), so that the gathered copy
    is one layer's and is gathered again in the backward pass."""
    if current_policy() is not None:
        fn = functools.partial(_gathered, fn)
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def head_weights(params, cfg):
    """The head's (d, V) weight and bias; under a sharding policy the
    weight gathered for compute, d whole and V over the tensor-parallel
    axis, so that the logits come out vocab-sharded, never partial
    sums."""
    w = (embed_table(params).T
         if cfg.tie_embeddings else
         gather_for_compute(params["lm_head"]["w"], "lm_head/w"))
    b = params.get("lm_head", {}).get("b") if cfg.lm_head_bias else None
    return constrain(w, None, "vocab"), b


def head_logits(params, x, cfg):
    """The head's f32 logits of hidden states x (..., d)."""
    w, b = head_weights(params, cfg)
    logits = (x @ w.to(x.dtype)).float()
    return logits if b is None else logits + b


def lm_loss(params, x, batch, cfg, loss_chunk: int = 512):
    """The chunked cross-entropy of the head on hidden states x (B, S,
    d) against batch['targets'] under batch['loss_mask'] (all ones if
    absent): (loss, {ce_loss, accuracy, tokens, loss})."""
    targets, mask = batch["targets"], batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, device=x.device)
    w, b = head_weights(params, cfg)
    loss, metrics = chunked_lm_loss(x, w, b, targets, mask, chunk=loss_chunk)
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg, dtype=torch.float32):
    x = embed_lookup(params, tokens).to(dtype)
    if cfg.scale_embeddings:
        # √d_model rounded to dtype first, as jnp.asarray(d ** 0.5, dtype)
        x = x * float(torch.tensor(np.float32(cfg.d_model ** 0.5)).to(dtype))
    return constrain(x, "batch", "seq", "embed")


def _ffn(lp, h, cfg):
    """The layer's MLP, or its MoE block: (out, aux or None)."""
    if cfg.moe is not None:
        return MOE.moe_block(lp["moe"], h, cfg.moe, cfg.mlp)
    return L.mlp_block(lp["mlp"], h, cfg.mlp), None


def _layer_apply(lp, x, cfg, q_chunk):
    """One layer.  Beside the reference's constraints the residual
    stream is pinned to ("batch", "seq", "embed") after each block: the
    row-parallel products leave partial sums, which GSPMD's propagation
    reduces there and DTensor, op by op, would carry on (and gather the
    next weight to meet them in the backward pass)."""
    h = L.apply_norm(x, lp["ln1"], cfg.norm)
    a, kv = L.attention_block(lp["attn"], h, cfg,
                              window=cfg.sliding_window, q_chunk=q_chunk,
                              shard_q=True)
    x = constrain(x + a, "batch", "seq", "embed")
    h = L.apply_norm(x, lp["ln2"], cfg.norm)
    if cfg.moe is None:
        h = constrain(h, "batch", "seq", "embed")
    m, aux = _ffn(lp, h, cfg)
    return constrain(x + m, "batch", "seq", "embed"), kv, aux


def forward(params, tokens, cfg, *, extra_embeds=None, dtype=torch.float32,
            q_chunk: int = 128, remat: bool = False):
    """Full-span forward in ``dtype`` over tokens (B, T), after the
    projected ``extra_embeds`` (B, P, patch_embed_dim) if given (VLM).
    Returns (hidden (B, P + T, d) after the final norm, [(k, v) of each
    layer], the MoE aux terms stacked over the layers or None).
    ``remat``: each layer recomputed in the backward pass
    (:func:`remat_call`)."""
    x = _embed(params, tokens, cfg, dtype)
    if extra_embeds is not None:
        proj = params["projector"]
        pref = (extra_embeds.to(dtype) @ proj["w"].to(dtype)
                + proj["b"].to(dtype))
        x = constrain(torch.cat([pref, x], dim=1), "batch", "seq", "embed")
    kvs, auxs = [], []
    for lp in unstack_layers(params["layers"], cfg.num_layers):
        x, kv, aux = remat_call(lambda lp, x: _layer_apply(lp, x, cfg,
                                                           q_chunk),
                                remat, lp, x)
        if not torch.is_grad_enabled():    # a prefill's cache, as decode's
            kv = tuple(constrain_kv(t) for t in kv)
        kvs.append(kv)
        auxs.append(aux)
    aux = (None if cfg.moe is None else
           {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]})
    return L.apply_norm(x, params["final_norm"], cfg.norm), kvs, aux


def _patches(batch, cfg):
    """The batch's patch embeddings if the config is a VLM (others
    ignore them, as the reference does)."""
    return batch.get("patches") if cfg.vlm is not None else None


# ---------------------------------------------------------------------------
# Train loss
# ---------------------------------------------------------------------------


def loss_fn(params, batch, cfg, *, dtype=torch.float32, q_chunk: int = 128,
            loss_chunk: int = 512, remat: bool = False):
    """The LM loss of ``batch`` {'tokens', 'targets' (B, S), optional
    'loss_mask', and 'patches' for a VLM}: the forward in ``dtype``,
    then the chunked cross-entropy of the head (f32 logits) over the
    text positions, plus a MoE config's aux losses.  Returns (loss,
    {ce_loss, accuracy, tokens, loss} and, for MoE, moe_frac_dropped
    averaged over the layers).  ``remat``: see :func:`forward`."""
    tokens = batch["tokens"]
    extra = _patches(batch, cfg)
    x, _, aux = forward(params, tokens, cfg, extra_embeds=extra,
                        dtype=dtype, q_chunk=q_chunk, remat=remat)
    if extra is not None:
        x = x[:, -tokens.shape[1]:, :]     # loss over text positions only
    loss, metrics = lm_loss(params, x, batch, cfg, loss_chunk)
    if aux is not None:
        loss = loss + aux["moe_lb_loss"].sum() + aux["moe_z_loss"].sum()
        metrics["moe_frac_dropped"] = aux["moe_frac_dropped"].mean()
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg, batch: int, cache_len: int, dtype=torch.bfloat16,
               device="cuda") -> dict:
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.resolved_head_dim())
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _pad_cache_seq(k, extra: int):
    """Append ``extra`` empty slots on the sequence axis (axis 2 of
    (L, B, S, KV, dh)) for the decode steps to write."""
    if not extra:
        return k
    pad = torch.zeros((*k.shape[:2], extra, *k.shape[3:]), dtype=k.dtype,
                      device=k.device)
    return torch.cat([k, pad], dim=2)


def prefill(params, batch, cfg, *, dtype=torch.float32, cache_extra: int = 0):
    """Forward in ``dtype`` over a prompt {'tokens': (B, T)} (a VLM's
    after its 'patches' (B, P, ·): the cache then holds P + T
    positions); returns (last-token logits (B, 1, V) f32, bf16 cache
    with ``cache_extra`` free slots)."""
    x, kvs, _ = forward(params, batch["tokens"], cfg, dtype=dtype,
                        extra_embeds=_patches(batch, cfg))
    logits = head_logits(params, x[:, -1:, :], cfg)
    cache = {name: _pad_cache_seq(
        torch.stack([kv[j] for kv in kvs]).to(torch.bfloat16), cache_extra)
        for j, name in enumerate(("k", "v"))}
    return logits, cache


def decode_step(params, cache, batch, cfg, *, window: int = 0,
                ring: bool = False, dtype=torch.float32):
    """One-token decode in ``dtype``.  batch: {'token': (B, 1), 'pos':
    int}.  Writes the token's K/V into ``cache`` in place; returns
    (logits (B, 1, V) f32, cache)."""
    token, pos = batch["token"], int(batch["pos"])
    x = _embed(params, token, cfg, dtype)
    layers = unstack_layers(params["layers"], cfg.num_layers)
    for i, lp in enumerate(layers):
        lp = gather_for_compute(lp)
        h = L.apply_norm(x, lp["ln1"], cfg.norm)
        a, _ = L.attention_decode_block(
            lp["attn"], h, cfg, cache["k"][i], cache["v"][i], pos,
            window=window, ring=ring)
        y = x + a
        h = L.apply_norm(y, lp["ln2"], cfg.norm)
        x = y + _ffn(lp, h, cfg)[0]
    x = L.apply_norm(x, params["final_norm"], cfg.norm)
    return head_logits(params, x, cfg), cache
