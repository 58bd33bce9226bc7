"""RWKV6 ("Finch"): an attention-free token mixer with data-dependent
decay (rwkv6-3b).

A port of the reference's ``models/rwkv.py``.  The per-token
projections (r/k/v/g, the decay LoRA and the token-shift LoRA) run for
the whole segment as batched products; the WKV state recurrence is a
Python loop over the tokens of the same step the reference scans, with
the (B, H, N, N) state in f32.  Decode feeds one token through the same
forward with the recurrent cache: the per-layer state and the two
token-shift rows, O(1) in the sequence length.  Layers are stacked on a
leading axis and split once a forward (``transformer.unstack_layers``).
Compute is in ``dtype`` (f32 unless the caller asks for bf16): the
weights are cast to it where they are used, while the decay, the WKV
state and its recurrence, and the group norm run in f32, as the
reference casts them.  The reference's ``jax.checkpoint`` of each layer
does not change the numbers, and the port keeps the activations.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.sharding import constrain, embed_lookup

_MIX = 5  # r, k, v, w, g


def init_tmix(gen: torch.Generator, d: int, rw, lead=()) -> dict:
    r_mix, r_dec = rw.lora_rank_mix, rw.lora_rank_decay
    dev = gen.device

    def zeros(*shape):
        return torch.zeros((*lead, *shape), device=dev)

    return {
        "mu_x": zeros(d),
        "mu": zeros(_MIX, d),
        "w1": L.dense_init(gen, (*lead, d, _MIX * r_mix), scale=0.01),
        "w2": L.dense_init(gen, (*lead, _MIX, r_mix, d), scale=0.01),
        "decay_base": torch.full((*lead, d), -6.0, device=dev),
        "decay_a": L.dense_init(gen, (*lead, d, r_dec), scale=0.01),
        "decay_b": L.dense_init(gen, (*lead, r_dec, d), scale=0.01),
        "receptance": L.dense_init(gen, (*lead, d, d)),
        "key": L.dense_init(gen, (*lead, d, d)),
        "value_ff": L.dense_init(gen, (*lead, d, d)),
        "gate": L.dense_init(gen, (*lead, d, d)),
        "wo": L.dense_init(gen, (*lead, d, d)),
        "bonus": zeros(d),
        "gn_scale": torch.ones((*lead, d), device=dev),
        "gn_bias": zeros(d),
    }


def init_cmix(gen: torch.Generator, d: int, ff: int, lead=()) -> dict:
    dev = gen.device
    return {
        "mu_k": torch.zeros((*lead, d), device=dev),
        "mu_r": torch.zeros((*lead, d), device=dev),
        "key": L.dense_init(gen, (*lead, d, ff)),
        "value_out": L.dense_init(gen, (*lead, ff, d)),
        "receptance": L.dense_init(gen, (*lead, d, d)),
    }


def init_layer(gen: torch.Generator, cfg, lead=()) -> dict:
    d, dev = cfg.d_model, gen.device
    return {
        "ln1": L.init_norm(d, "layernorm", lead, device=dev),
        "tmix": init_tmix(gen, d, cfg.rwkv, lead),
        "ln2": L.init_norm(d, "layernorm", lead, device=dev),
        "cmix": init_cmix(gen, d, cfg.d_ff, lead),
    }


# ---------------------------------------------------------------------------
# Token shift, time mix, channel mix
# ---------------------------------------------------------------------------


def _shift(x, x_prev):
    """x: (B, T, d); x_prev: (B, d), the last token of the previous
    segment."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _tmix_projections(p, x, x_prev, n_heads: int, head_dim: int):
    """r, k, v (B, T, H, N) and the gate g (B, T, d) in x's dtype, the
    decay w (B, T, H, N) in f32, of a segment."""
    b, t, _ = x.shape
    dt = x.dtype
    xx = _shift(x, x_prev) - x
    xxx = x + xx * p["mu_x"].to(dt)
    m = torch.tanh(xxx @ p["w1"].to(dt)).reshape(b, t, _MIX, -1)
    m = torch.einsum("btmr,mrd->btmd", m, p["w2"].to(dt))
    xs = x[:, :, None, :] + xx[:, :, None, :] * (p["mu"].to(dt) + m)
    xr, xk, xv, xw, xg = xs.unbind(2)
    r = xr @ p["receptance"].to(dt)
    k = xk @ p["key"].to(dt)
    v = xv @ p["value_ff"].to(dt)
    g = F.silu(xg @ p["gate"].to(dt))
    dec = p["decay_base"].float() + (
        torch.tanh(xw @ p["decay_a"].to(dt)).float() @ p["decay_b"].float())
    w = torch.exp(-torch.exp(dec))                  # (B, T, d) in (0, 1)
    shp = (b, t, n_heads, head_dim)
    return r.reshape(shp), k.reshape(shp), v.reshape(shp), w.reshape(shp), g


def _wkv_step(state, r, kv, ukv, w):
    """One WKV step.  state: (B, H, N, N) f32 [key dim, value dim]; r,
    w: (B, H, N); kv = k ⊗ v and ukv = u ⊙ kv (B, H, N, N)."""
    y = (r[..., None, :] @ (state + ukv))[..., 0, :]
    return w[..., :, None] * state + kv, y


def tmix_apply(p, x, state, x_prev, n_heads: int, head_dim: int):
    """Time mix over a segment: (out, new state, new x_prev).  The outer
    products k ⊗ v and their bonus terms are formed for the whole
    segment at once; the loop over its tokens carries the state."""
    b, t, d = x.shape
    r, k, v, w, g = _tmix_projections(p, x, x_prev, n_heads, head_dim)
    u = p["bonus"].float().reshape(n_heads, head_dim)
    r, k, v = r.float(), k.float(), v.float()
    kv = k[..., :, None] * v[..., None, :]              # (B, T, H, N, N)
    ukv = u[..., :, None] * kv
    ys = []
    for i in range(t):
        state, y = _wkv_step(state, r[:, i], kv[:, i], ukv[:, i], w[:, i])
        ys.append(y)
    # per-head group norm: the population variance, eps 64e-5
    yh = torch.stack(ys, dim=1)                     # (B, T, H, N)
    mu = yh.mean(-1, keepdim=True)
    var = torch.var(yh, dim=-1, keepdim=True, unbiased=False)
    y = ((yh - mu) * torch.rsqrt(var + 64e-5)).reshape(b, t, d)
    y = (y * p["gn_scale"] + p["gn_bias"]).to(x.dtype) * g
    return y @ p["wo"].to(x.dtype), state, x[:, -1, :]


def cmix_apply(p, x, x_prev):
    dt = x.dtype
    xx = _shift(x, x_prev) - x
    xk = x + xx * p["mu_k"].to(dt)
    xr = x + xx * p["mu_r"].to(dt)
    k = torch.square(torch.relu(xk @ p["key"].to(dt)))
    k = constrain(k, "batch", "seq", "ff")
    kv = k @ p["value_out"].to(dt)
    return torch.sigmoid(xr @ p["receptance"].to(dt)) * kv, x[:, -1, :]


def layer_apply(lp, x, state, xp_att, xp_ffn, cfg):
    hd = cfg.rwkv.head_dim
    h = L.layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    a, state, xp_att = tmix_apply(lp["tmix"], h, state, xp_att,
                                  cfg.d_model // hd, hd)
    x = x + a
    h = L.layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    f, xp_ffn = cmix_apply(lp["cmix"], h, xp_ffn)
    return x + f, state, xp_att, xp_ffn


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random params on ``gen``'s device, layers stacked on axis 0."""
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": L.embed_init(gen, (cfg.vocab_size, d)),
        "ln_in": L.init_norm(d, "layernorm", device=dev),
        "layers": init_layer(gen, cfg, (cfg.num_layers,)),
        "final_norm": L.init_norm(d, "layernorm", device=dev),
        "lm_head": {"w": L.dense_init(gen, (d, cfg.vocab_size))},
    }
    if cfg.lm_head_bias:
        params["lm_head"]["b"] = torch.zeros(cfg.vocab_size, device=dev)
    return params


def init_cache(cfg, batch: int, cache_len: int = 0, dtype=torch.float32,
               device="cuda") -> dict:
    """The recurrent cache, O(1) in the sequence length (``cache_len``
    unused): the f32 WKV state and the token-shift rows in ``dtype``."""
    del cache_len
    n = cfg.rwkv.head_dim
    lb = (cfg.num_layers, batch)
    return {
        "state": torch.zeros((*lb, cfg.d_model // n, n, n), device=device),
        "xp_att": torch.zeros((*lb, cfg.d_model), dtype=dtype,
                              device=device),
        "xp_ffn": torch.zeros((*lb, cfg.d_model), dtype=dtype,
                              device=device),
    }


def forward(params, tokens, cfg, cache=None, *, dtype=torch.float32,
            remat: bool = False):
    """Segment forward in ``dtype`` over tokens (B, T), a whole sequence
    or one token, from ``cache`` (a zero cache in ``dtype`` if None).
    Returns (hidden after the final norm, the new cache); the
    token-shift rows are computed in ``dtype`` and stored back in the
    cache's dtype.  ``remat``: each layer recomputed in the backward
    pass (``transformer.remat_call``)."""
    if cache is None:
        cache = init_cache(cfg, tokens.shape[0], dtype=dtype,
                           device=tokens.device)
    x = embed_lookup(params, tokens).to(dtype)
    x = constrain(x, "batch", "seq", "embed")
    x = L.layer_norm(x, params["ln_in"]["scale"], params["ln_in"]["bias"])
    out = {"state": [], "xp_att": [], "xp_ffn": []}
    layers = TF.unstack_layers(params["layers"], cfg.num_layers)
    for i, lp in enumerate(layers):
        x, st, xa, xf = TF.remat_call(
            lambda *a: layer_apply(*a, cfg), remat, lp, x,
            cache["state"][i], cache["xp_att"][i].to(dtype),
            cache["xp_ffn"][i].to(dtype))
        for name, t in (("state", st), ("xp_att", xa), ("xp_ffn", xf)):
            out[name].append(t)
    x = L.layer_norm(x, params["final_norm"]["scale"],
                     params["final_norm"]["bias"])
    return x, {name: torch.stack(ts).to(cache[name].dtype)
               for name, ts in out.items()}


def loss_fn(params, batch, cfg, *, dtype=torch.float32, loss_chunk: int = 512,
            remat: bool = False):
    """The LM loss of {'tokens', 'targets' (B, S), optional 'loss_mask'},
    the forward in ``dtype``: (loss, {ce_loss, accuracy, tokens,
    loss})."""
    x, _ = forward(params, batch["tokens"], cfg, dtype=dtype, remat=remat)
    return TF.lm_loss(params, x, batch, cfg, loss_chunk)


def prefill(params, batch, cfg, *, dtype=torch.float32, cache_extra: int = 0):
    """Forward in ``dtype`` over the prompt {'tokens': (B, T)}:
    (last-token logits (B, 1, V) f32, the recurrent cache).
    ``cache_extra`` is unused: the cache does not grow."""
    del cache_extra
    x, cache = forward(params, batch["tokens"], cfg, dtype=dtype)
    return TF.head_logits(params, x[:, -1:, :], cfg), cache


def decode_step(params, cache, batch, cfg, *, dtype=torch.float32):
    """One token {'token': (B, 1)} in ``dtype`` against the cache ('pos'
    unused): (logits (B, 1, V) f32, the new cache)."""
    x, cache = forward(params, batch["token"], cfg, cache, dtype=dtype)
    return TF.head_logits(params, x, cfg), cache
