"""Mixture-of-experts block with capacity-based, index-based dispatch:
the port of the reference's ``models/moe.py``.

Routing groups are batch rows, so capacity is per (row, expert):
C = ceil(S·K / E · capacity_factor), clamped to [1, S].  Each token
picks its K experts by a stable descending sort of the router's softmax
probabilities (ties to the lower expert, as ``lax.top_k``), and the K
weights are renormalised to sum to 1.  The S·K (token, choice) pairs,
token-major, queue at their experts in that order: a pair's slot is
its expert's count before it (a cumsum of the one-hot), and a pair at
slot C or beyond is dropped.  Kept pairs are scattered into a
(B, E, C + 1, d) buffer whose last slot takes the dropped ones and is
then cut off; the experts' FFNs run on (B, E, C, d) as batched matrix
products; each pair reads its expert's output back at
min(slot, C − 1), weighed by its router weight times ``keep``, so a
dropped pair adds 0 and gets a zero gradient.  Under a sharding policy
the dispatch buffers are pinned batch-sharded (and expert-sharded in
"ep" mode) at the reference's five ``constrain`` sites; outside one
the calls do nothing.

The aux terms are Switch-style: the load-balance loss
E · Σ_e mean(probs)_e · mean(first choice is e), the router z-loss
mean(logsumexp(logits)²), each times its coefficient of
:class:`MoEConfig`, and the share of dropped pairs.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding import constrain, rowwise


def init_moe(gen: torch.Generator, d: int, ff: int, moe_cfg,
             lead=()) -> dict:
    """The router (d, E) at scale 0.02 and the experts' (E, d, ff),
    (E, d, ff), (E, ff, d) weights; ``lead`` is prepended to each."""
    e = moe_cfg.num_experts
    return {"router": dense_init(gen, (*lead, d, e), scale=0.02),
            "wi0": dense_init(gen, (*lead, e, d, ff)),
            "wi1": dense_init(gen, (*lead, e, d, ff)),
            "wo": dense_init(gen, (*lead, e, ff, d))}


def capacity(seq: int, moe_cfg) -> int:
    e, k, cf = moe_cfg.num_experts, moe_cfg.top_k, moe_cfg.capacity_factor
    return max(1, min(seq, int(math.ceil(seq * k / e * cf))))


def top_k(x: torch.Tensor, k: int):
    """The ``k`` largest of the last axis, in descending order, ties to
    the lower index (``lax.top_k``): (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x, moe_cfg):
    """The router's logits (B, S, E) f32, probabilities, the renormalised
    top-k weights and expert ids (B, S, K), each pair's slot and
    ``keep`` (B, S·K) and the capacity C."""
    b, s, _ = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    c = capacity(s, moe_cfg)
    logits = torch.einsum("bsd,de->bse", x, p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k(probs, k)
    top_w = top_w / top_w.sum(dim=-1, keepdim=True)
    flat_e = top_i.reshape(b, s * k)
    pos_all = torch.cumsum(F.one_hot(flat_e, e), dim=1) - 1
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0]
    keep = pos < c
    slot = torch.where(keep, pos, c)
    return logits, probs, top_w, top_i, slot, keep, c


def _dispatch(xr, flat_e, slot, e: int, c: int):
    """The (B, E, C, d) buffer of the pairs xr (B, S·K, d) at their
    experts' slots; slot C takes the dropped ones and is cut off."""
    b, _, d = xr.shape
    rows = torch.arange(b, device=xr.device)[:, None]
    buf = xr.new_zeros((b, e, c + 1, d)).index_put((rows, flat_e, slot), xr)
    return buf[:, :, :c]


def _combine(out, flat_e, slot, c: int):
    """Each pair's expert output (B, S·K, d), read at min(slot, C − 1)."""
    rows = torch.arange(out.shape[0], device=out.device)[:, None]
    return out[rows, flat_e, torch.clamp(slot, max=c - 1)]


def moe_block(p, x, moe_cfg, mlp_kind: str = "swiglu"):
    """x (B, S, d) -> (y (B, S, d), aux: the weighted losses, the share
    of dropped pairs and the mean router probability of each expert)."""
    b, s, d = x.shape
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    logits, probs, top_w, top_i, slot, keep, c = route(p, x, moe_cfg)
    flat_e = top_i.reshape(b, s * k)

    # scatter the pairs into (B, E, C + 1, d), each rank its own rows
    # under a policy; slot C takes the dropped
    xr = torch.repeat_interleave(x, k, dim=1)                # (B, S·K, d)
    xr = constrain(xr, "batch", None, None)
    buf = rowwise(_dispatch, xr, flat_e, slot, e=e, c=c)
    buf = constrain(buf, "batch", "expert", None, None)

    h = torch.einsum("becd,edf->becf", buf, p["wi0"].to(x.dtype))
    if mlp_kind == "swiglu":
        h = F.silu(h) * torch.einsum("becd,edf->becf", buf,
                                     p["wi1"].to(x.dtype))
    elif mlp_kind == "geglu":
        h = F.gelu(h, approximate="tanh") * torch.einsum(
            "becd,edf->becf", buf, p["wi1"].to(x.dtype))
    else:
        h = F.gelu(h, approximate="tanh")
    out = torch.einsum("becf,efd->becd", h, p["wo"].to(x.dtype))
    out = constrain(out, "batch", "expert", None, None)

    # gather back at min(slot, C - 1), weighed by router weight · keep
    gathered = rowwise(_combine, out, flat_e, slot, c=c)
    gathered = constrain(gathered, "batch", None, None)      # (B, S·K, d)
    w = top_w.reshape(b, s * k) * keep.float()
    y = (gathered.float() * w[..., None]).reshape(b, s, k, d).sum(dim=2)

    me = probs.mean(dim=(0, 1))                              # (E,)
    ce = F.one_hot(top_i[..., 0], e).float().mean(dim=(0, 1))
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    aux = {"moe_lb_loss": moe_cfg.load_balance_loss * lb_loss,
           "moe_z_loss": moe_cfg.router_z_loss * z_loss,
           "moe_frac_dropped": 1.0 - keep.float().mean(),
           "moe_expert_load": me}
    return y.to(x.dtype), aux
