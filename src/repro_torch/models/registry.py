"""Model registry of the port: one functional API over every LM arch
the reference registers, as its ``models/registry.py``.

  api = get_model("qwen2.5-3b")
  params = api.init(seed, device="cuda")
  loss, metrics = api.loss(params, batch)
  logits, cache = api.prefill(params, {"tokens": tokens}, cache_extra=n)
  logits, cache = api.decode_step(params, cache, {"token": t, "pos": p})

The kinds: dense, moe and vlm (``models/transformer.py``), ssm
(``models/rwkv.py``), hybrid (``models/hybrid.py``) and audio
(``models/encdec.py``: its batches carry 'frames').  A classifier
config raises ``ValueError``: it has ``models/classifier.py``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import ModelConfig, get_config
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import rwkv as RK
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


def _init(init_params, cfg):
    def init(seed: int = 0, *, device="cuda"):
        """Params drawn from a generator on ``device`` seeded by
        ``seed``; weights never leave the device."""
        gen = torch.Generator(device=resolve_device(device))
        return init_params(gen.manual_seed(seed), cfg)
    return init


def _windowed(decode_step, cfg):
    """``decode_step`` with the window and ring of the default (not
    long-context) geometry, as ``init_cache`` and ``prefill`` lay the
    cache out."""
    def step(params, cache, batch):
        w = cfg.sliding_window
        ring = bool(w) and cache["k"].shape[2] <= w
        return decode_step(params, cache, batch, cfg, window=w, ring=ring)
    return step


def _transformer_api(cfg) -> ModelApi:
    def init_cache(batch, seq_len, long_context=False,
                   dtype=torch.bfloat16, *, device="cuda"):
        cache_len, _ = cache_geometry(cfg, seq_len, long_context)
        return TF.init_cache(cfg, batch, cache_len, dtype,
                             resolve_device(device))

    return ModelApi(cfg=cfg, init=_init(TF.init_params, cfg),
                    loss=partial(TF.loss_fn, cfg=cfg),
                    prefill=partial(TF.prefill, cfg=cfg),
                    decode_step=_windowed(TF.decode_step, cfg),
                    init_cache=init_cache)


def _rwkv_api(cfg) -> ModelApi:
    def init_cache(batch, seq_len, long_context=False,
                   dtype=torch.float32, *, device="cuda"):
        del seq_len, long_context
        return RK.init_cache(cfg, batch, dtype=dtype,
                             device=resolve_device(device))

    return ModelApi(cfg=cfg, init=_init(RK.init_params, cfg),
                    loss=partial(RK.loss_fn, cfg=cfg),
                    prefill=partial(RK.prefill, cfg=cfg),
                    decode_step=partial(RK.decode_step, cfg=cfg),
                    init_cache=init_cache)


def _hybrid_api(cfg) -> ModelApi:
    def init_cache(batch, seq_len, long_context=False,
                   dtype=torch.bfloat16, *, device="cuda"):
        cache_len, _ = cache_geometry(cfg, seq_len, long_context)
        return HY.init_cache(cfg, batch, cache_len, dtype,
                             resolve_device(device))

    def loss(params, batch, *, dtype=torch.float32, **kw):
        return HY.loss_fn(params, batch, cfg, dtype=dtype,
                          window=cfg.sliding_window, **kw)

    return ModelApi(cfg=cfg, init=_init(HY.init_params, cfg), loss=loss,
                    prefill=partial(HY.prefill, cfg=cfg),
                    decode_step=_windowed(HY.decode_step, cfg),
                    init_cache=init_cache)


def _encdec_api(cfg) -> ModelApi:
    def init_cache(batch, seq_len, long_context=False,
                   dtype=torch.bfloat16, *, device="cuda"):
        del long_context
        source = min(cfg.encdec.max_source_frames, seq_len)
        return ED.init_cache(cfg, batch, seq_len, source, dtype,
                             resolve_device(device))

    return ModelApi(cfg=cfg, init=_init(ED.init_params, cfg),
                    loss=partial(ED.loss_fn, cfg=cfg),
                    prefill=partial(ED.prefill, cfg=cfg),
                    decode_step=partial(ED.decode_step, cfg=cfg),
                    init_cache=init_cache)


_APIS = {"dense": _transformer_api, "moe": _transformer_api,
         "vlm": _transformer_api, "ssm": _rwkv_api, "hybrid": _hybrid_api,
         "audio": _encdec_api}


def get_model(cfg_or_name) -> ModelApi:
    cfg = (get_config(cfg_or_name) if isinstance(cfg_or_name, str)
           else cfg_or_name)
    if cfg.kind not in _APIS:
        raise ValueError(f"get_model does not handle kind={cfg.kind!r}; "
                         "classifier models use "
                         "repro_torch.models.classifier")
    return _APIS[cfg.kind](cfg)
