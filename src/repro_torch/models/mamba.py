"""The Mamba2 (SSD) mixer in its chunked-scan form, zamba2-7b's backbone.

A port of the reference's ``models/mamba.py``.  The sequence is split
into chunks of Q tokens: within a chunk the SSD is an attention-like
masked product, and across chunks a Python loop (the reference's
``lax.scan``) carries the (B, H, P, N) f32 state.  The causal mask
sets the decay to -inf before the exponential, so no entry above the
diagonal overflows and the backward stays finite.  Decode is the same
mixer over one token with the cache {'state', 'conv'}: the SSD state
and the depthwise convolution's last W − 1 inputs.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.sharding import constrain

NGROUPS = 1  # B and C shared across heads (zamba2's setting)


def dims(cfg):
    """(d_inner, heads, conv channels, in_proj width) of the mixer."""
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    conv_dim = d_inner + 2 * NGROUPS * ssm.state_dim
    d_in_proj = 2 * d_inner + 2 * NGROUPS * ssm.state_dim + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def init_layer(gen: torch.Generator, cfg, lead=()) -> dict:
    """One mixer layer's params, ``lead`` prepended to every shape."""
    ssm, d, dev = cfg.ssm, cfg.d_model, gen.device
    d_inner, n_heads, conv_dim, d_in_proj = dims(cfg)
    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev))
    return {
        "ln": {"scale": torch.zeros((*lead, d), device=dev)},
        "in_proj": L.dense_init(gen, (*lead, d, d_in_proj)),
        "conv_w": 0.1 * torch.randn((*lead, conv_dim, ssm.conv_width),
                                    generator=gen, device=dev),
        "conv_b": torch.zeros((*lead, conv_dim), device=dev),
        "a_log": a_log.expand(*lead, n_heads).clone(),
        "dt_bias": torch.zeros((*lead, n_heads), device=dev),
        "d_skip": torch.ones((*lead, n_heads), device=dev),
        "gn_scale": torch.ones((*lead, d_inner), device=dev),
        "out_proj": L.dense_init(gen, (*lead, d_inner, d)),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv of x (B, T, C) with w (C, W), after the
    previous segment's last W − 1 inputs ``conv_state`` (B, W − 1, C;
    zeros if None).  Returns (silu(y), the new state in x's dtype)."""
    bsz, t, c = x.shape
    width = w.shape[1]
    if conv_state is None:
        conv_state = torch.zeros((bsz, width - 1, c), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)  # (B, T + W − 1, C)
    w = w.to(x.dtype)
    y = xp[:, :t, :] * w[:, 0]
    for i in range(1, width):
        y = y + xp[:, i:i + t, :] * w[:, i]
    y = y + b.to(x.dtype)
    new_state = xp[:, -(width - 1):, :] if width > 1 else conv_state
    return F.silu(y), new_state


def _split_proj(zxbcdt, cfg):
    d_inner, _, conv_dim, _ = dims(cfg)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:d_inner + conv_dim],
            zxbcdt[..., d_inner + conv_dim:])


def _split_xbc(xbc, cfg):
    d_inner, n = dims(cfg)[0], cfg.ssm.state_dim
    return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + n],
            xbc[..., d_inner + n:])


@functools.lru_cache(maxsize=None)
def _causal_mask(q: int, device) -> torch.Tensor:
    return torch.ones((q, q), dtype=torch.bool, device=device).tril()


def ssd_chunked(x, a_log_t, bm, cm, dt, ssm, state=None):
    """Chunked SSD scan.

    x: (B, T, H, P); a_log_t: (B, T, H) per-token log-decay (negative);
    bm, cm: (B, T, N); dt: (B, T, H); state: (B, H, P, N) carry or
    None.  Returns (y (B, T, H, P) f32, the final state).  T must be a
    multiple of Q = min(chunk, T).
    """
    b, t, h, pd = x.shape
    n = bm.shape[-1]
    q = min(ssm.chunk, t)
    if t % q:
        raise ValueError(f"T={t} not divisible by chunk={q}")
    nc = t // q
    if state is None:
        state = torch.zeros((b, h, pd, n), device=x.device)
    # B and C in the compute dtype, their products and sums in f32 (the
    # reference's preferred_element_type and its promotions)
    xc = x.reshape(b, nc, q, h, pd).float()
    ac = a_log_t.reshape(b, nc, q, h).float()
    bc = bm.reshape(b, nc, q, n).float()
    cc = cm.reshape(b, nc, q, n).float()
    dtc = dt.reshape(b, nc, q, h)

    la = torch.cumsum(ac, dim=2)                          # (B, nc, Q, H)
    # intra-chunk: scores[q, s] = exp(La[q] − La[s]) (C_q · B_s) dt_s, s ≤ q
    g = torch.einsum("bcqn,bcsn->bcqs", cc, bc)           # (B, nc, Q, Q)
    decay = la[:, :, :, None, :] - la[:, :, None, :, :]   # (B, nc, Q, Q, H)
    causal = _causal_mask(q, x.device)
    decay = torch.where(causal[None, None, :, :, None], decay,
                        float("-inf"))
    scores = g[..., None] * torch.exp(decay) * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqsh,bcshp->bcqhp", scores, xc)

    # chunk states: Σ_s exp(La[end] − La[s]) dt_s (x_s B_sᵀ)
    dte = torch.exp(la[:, :, -1:, :] - la) * dtc          # (B, nc, Q, H)
    cstate = torch.einsum("bcqhp,bcqn->bchpn", dte[..., None] * xc, bc)
    a_chunk = torch.exp(la[:, :, -1, :])                  # (B, nc, H)
    y_inter = []
    for c in range(nc):
        # the inter-chunk term reads the incoming state
        y_inter.append(torch.exp(la[:, c])[..., None] * torch.einsum(
            "bqn,bhpn->bqhp", cc[:, c], state))
        state = a_chunk[:, c, :, None, None] * state + cstate[:, c]
    y = y_intra + torch.stack(y_inter, dim=1)             # (B, nc, Q, H, P)
    return y.reshape(b, t, h, pd), state


def mixer_apply(lp, x, cfg, cache=None):
    """x: (B, T, d); cache: None or {'state': (B, H, P, N), 'conv':
    (B, W − 1, C)}.  Returns (out (B, T, d) in x's dtype, the new
    cache: the SSD state f32, the conv inputs in x's dtype)."""
    ssm = cfg.ssm
    b, t, _ = x.shape
    d_inner, n_heads, _, _ = dims(cfg)
    z, xbc, dt = _split_proj(x @ lp["in_proj"].to(x.dtype), cfg)
    xbc, conv_state = _causal_conv(xbc, lp["conv_w"], lp["conv_b"],
                                   None if cache is None else cache["conv"])
    xs, bm, cm = _split_xbc(xbc, cfg)
    xs = constrain(xs.reshape(b, t, n_heads, ssm.head_dim), "batch", "seq",
                   "heads", None)
    dt = F.softplus(dt.float() + lp["dt_bias"])            # (B, T, H)
    a_log_t = -dt * torch.exp(lp["a_log"])                 # negative
    y, state = ssd_chunked(xs, a_log_t, bm, cm, dt, ssm,
                           None if cache is None else cache["state"])
    y = y + lp["d_skip"][None, None, :, None] * xs.float()
    y = y.reshape(b, t, d_inner)
    # gated RMSNorm, eps 1e-6
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * lp["gn_scale"]
    y = y.to(x.dtype) * F.silu(z)
    return (y @ lp["out_proj"].to(x.dtype),
            {"state": state, "conv": conv_state})


def init_cache_layer(cfg, batch: int, dtype=torch.float32, lead=(), *,
                     device="cuda") -> dict:
    """A zero mixer cache: the f32 state and the conv inputs in
    ``dtype``, ``lead`` prepended."""
    ssm = cfg.ssm
    _, n_heads, conv_dim, _ = dims(cfg)
    return {
        "state": torch.zeros((*lead, batch, n_heads, ssm.head_dim,
                              ssm.state_dim), device=device),
        "conv": torch.zeros((*lead, batch, ssm.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
