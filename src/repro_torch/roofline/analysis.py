"""Roofline terms of one step on an NVIDIA H100, per card.

The port of the reference's ``roofline/analysis.py``.  Its three terms,
in seconds:

  compute    = FLOPs / the peak of the step's dtype
  memory     = HBM bytes / HBM bandwidth
  collective = collective bytes (all-reduce weighted 2x) / link
               bandwidth (0 on one card)

The FLOPs, bytes and collective bytes come from ``roofline/cost.py`` (a
count of one step on the ``meta`` device, under a device mesh at one
rank's shapes), where the reference parses XLA's HLO:
``cost.MeshCounter`` stands in for ``parse_collectives``, with its keys
and weights.  The link term takes NVLink's rate for every collective;
a 16-wide 'model' axis spans two 8-card NVLink nodes, whose traffic
between them crosses the slower network, so the term is optimistic
there.

``model_flops`` (6·N·D for train, 2·N·D for a forward; N the active
params of a token) and ``_active_params`` are the reference's, in the
port's own copy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str
    peak_flops: float          # bf16 FLOP/s, dense, tensor cores
    peak_flops_f32: float      # f32 FLOP/s outside the tensor cores
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s a direction, NVLink
    hbm_bytes: float           # device memory

    def peak_for(self, dtype) -> float:
        """The peak FLOP/s of a step whose products are in ``dtype``."""
        return (self.peak_flops if dtype in (torch.bfloat16, torch.float16)
                else self.peak_flops_f32)


#: H100 SXM (data sheet): 989 TFLOP/s bf16 dense, 67 TFLOP/s f32,
#: 3.35 TB/s HBM3, NVLink 4 at 450 GB/s a direction, 80 GB
HW_H100 = Hardware("nvidia-h100-sxm", 989e12, 67e12, 3.35e12, 450e9, 80e9)


def roofline_terms(flops: float, hbm_bytes: float,
                   collective_bytes: float = 0.0, hw: Hardware = HW_H100,
                   dtype=torch.bfloat16) -> Dict[str, float]:
    """The three terms in seconds, the bottleneck (the largest), the
    bound (its time) and the compute share of the bound; the compute
    peak is ``dtype``'s."""
    t_c = flops / hw.peak_for(dtype)
    t_m = hbm_bytes / hw.hbm_bw
    t_x = collective_bytes / hw.link_bw
    terms = {"compute_s": t_c, "memory_s": t_m, "collective_s": t_x}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom.replace("_s", "")
    total = max(t_c, t_m, t_x)
    terms["roofline_bound_s"] = total
    terms["compute_fraction"] = t_c / total if total > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE): the "useful" FLOPs
# ---------------------------------------------------------------------------


def _active_params(cfg) -> float:
    """Active parameter count per token (MoE counts top_k experts only),
    as the reference counts it."""
    d, ff, v, n_layers = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    dh = cfg.resolved_head_dim()
    n = v * d  # embedding
    if not cfg.tie_embeddings:
        n += d * v
    if cfg.kind in ("dense", "moe", "vlm"):
        attn = d * cfg.num_heads * dh + 2 * d * cfg.num_kv_heads * dh \
            + cfg.num_heads * dh * d
        gates = 3 if cfg.mlp in ("swiglu", "geglu") else 2
        if cfg.moe is not None:
            mlp = cfg.moe.top_k * gates * d * ff + d * cfg.moe.num_experts
        else:
            mlp = gates * d * ff
        n += n_layers * (attn + mlp)
    elif cfg.kind == "ssm":     # rwkv6
        n += n_layers * (5 * d * d + 2 * d * ff + d * d)
    elif cfg.kind == "hybrid":
        from repro_torch.models.mamba import dims as mdims
        d_inner, _, _, d_in_proj = mdims(cfg)
        n += n_layers * (d * d_in_proj + d_inner * d)
        sites_attn = d * cfg.num_heads * dh * 2 + 2 * d * cfg.num_kv_heads * dh
        n += 14 * (sites_attn + 3 * d * ff)   # shared-block applications
    elif cfg.kind == "audio":
        attn = 2 * (d * cfg.num_heads * dh * 2 + 2 * d * cfg.num_kv_heads * dh)
        n += (n_layers + cfg.encdec.encoder_layers) * (attn / 2 + 2 * d * ff)
    return float(n)


def model_flops(cfg, shape, mode: str) -> float:
    """6·N_active·D for train; 2·N_active·D for an inference forward."""
    n = _active_params(cfg)
    if mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch      # decode: a token a sequence
