"""Model registry of the port: one functional API over the LM archs it
covers, as the reference's ``models/registry.py``.

  api = get_model("qwen2.5-3b")
  params = api.init(seed, device="cuda")
  loss, metrics = api.loss(params, batch)
  logits, cache = api.prefill(params, {"tokens": tokens}, cache_extra=n)
  logits, cache = api.decode_step(params, cache, {"token": t, "pos": p})

The decoder-only transformer kinds (dense, moe, vlm) are ported; SSM,
hybrid and encoder-decoder (audio) configs raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import ModelConfig, get_config
from repro_torch.core.selectors.functional import LM_SUBSTRATE, not_ported
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import cache_geometry


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def _transformer_api(cfg) -> ModelApi:
    def init(seed: int = 0, *, device="cuda"):
        """Params drawn from a generator on ``device`` seeded by
        ``seed``; weights never leave the device."""
        gen = torch.Generator(device=resolve_device(device))
        return TF.init_params(gen.manual_seed(seed), cfg)

    def init_cache(batch, seq_len, long_context=False,
                   dtype=torch.bfloat16, *, device="cuda"):
        cache_len, _ = cache_geometry(cfg, seq_len, long_context)
        return TF.init_cache(cfg, batch, cache_len, dtype,
                             resolve_device(device))

    def decode_step(params, cache, batch):
        """The window and ring of the default (not long-context)
        geometry, as ``init_cache`` and ``prefill`` lay the cache out."""
        w = cfg.sliding_window
        cache_len = cache["k"].shape[2]
        ring = bool(w) and cache_len <= w
        return TF.decode_step(params, cache, batch, cfg, window=w,
                              ring=ring)

    return ModelApi(cfg=cfg, init=init,
                    loss=partial(TF.loss_fn, cfg=cfg),
                    prefill=partial(TF.prefill, cfg=cfg),
                    decode_step=decode_step, init_cache=init_cache)


def get_model(cfg_or_name) -> ModelApi:
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    if cfg.kind == "classifier":
        raise ValueError("classifier models use "
                         "repro_torch.models.classifier")
    if cfg.kind not in ("dense", "moe", "vlm"):
        raise not_ported("kind", cfg.kind, LM_SUBSTRATE)
    TF.require_ported(cfg)
    return _transformer_api(cfg)
