"""Model registry of the port: one functional API over every LM arch
the reference registers, as its ``models/registry.py``.

  api = get_model("qwen2.5-3b")
  params = api.init(seed, device="cuda")
  loss, metrics = api.loss(params, batch)
  logits, cache = api.prefill(params, {"tokens": tokens}, cache_extra=n)
  logits, cache = api.decode_step(params, cache, {"token": t, "pos": p},
                                  long_context=False, dtype=torch.float32)

``input_specs(cfg, shape)`` and ``cache_specs(cfg, shape)`` give the
inputs and the cache of one assigned input shape as ``meta`` tensors
(shapes and dtypes, no storage), and ``api.init(device="meta")`` the
params, for the one-card dry run (``launch/dryrun.py``).

The kinds: dense, moe and vlm (``models/transformer.py``), ssm
(``models/rwkv.py``), hybrid (``models/hybrid.py``) and audio
(``models/encdec.py``: its batches carry 'frames').  A classifier
config raises ``ValueError``: it has ``models/classifier.py``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import ModelConfig, ShapeConfig, get_config
from repro_torch.models import encdec as ED
from repro_torch.models import hybrid as HY
from repro_torch.models import rwkv as RK
from repro_torch.models import transformer as TF
from repro_torch.models.transformer import cache_geometry, effective_window


@dataclasses.dataclass
class ModelApi:
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


class _ShapeOnly(torch.Generator):
    """A generator whose draws land on ``meta``: init's shapes and
    dtypes with no storage and no draw."""
    device = torch.device("meta")


def _init(init_params, cfg):
    def init(seed: int = 0, *, device="cuda"):
        """Params drawn from a generator on ``device`` seeded by
        ``seed``; weights never leave the device.  On ``meta`` only
        their shapes and dtypes."""
        dev = resolve_device(device)
        if dev.type == "meta":
            return init_params(_ShapeOnly(), cfg)
        return init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg)
    return init


def _windowed(decode_step, cfg):
    """``decode_step`` with the window of the geometry ``long_context``
    selects (the reference's ``effective_window(cfg, 1 << 62,
    long_context)``), a ring buffer where the cache is no longer than
    the window, as ``init_cache`` lays it out."""
    def step(params, cache, batch, *, long_context=False,
             dtype=torch.float32):
        w = effective_window(cfg, 1 << 62, long_context)
        ring = bool(w) and cache["k"].shape[2] <= w
        return decode_step(params, cache, batch, cfg, window=w, ring=ring,
                           dtype=dtype)
    return step


def _unwindowed(decode_step, cfg):
    """``decode_step`` of a family with no attention window (the
    recurrent and the encoder-decoder caches): ``long_context`` does
    not change it, as in the reference."""
    def step(params, cache, batch, *, long_context=False,
             dtype=torch.float32):
        del long_context
        return decode_step(params, cache, batch, cfg, dtype=dtype)
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
                    decode_step=_unwindowed(RK.decode_step, cfg),
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
                    decode_step=_unwindowed(ED.decode_step, cfg),
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


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The model inputs of one assigned input shape, as ``meta``
    tensors: the reference's ``input_specs`` (torch has no
    ``ShapeDtypeStruct``)."""
    b, s = shape.global_batch, shape.seq_len

    def spec(dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.mode == "decode":     # one new token against a seq_len cache
        return {"token": spec((b, 1)), "pos": spec(())}
    if cfg.kind == "vlm":
        p = cfg.vlm.num_patches
        prefix, text = {"patches": spec((b, p, cfg.vlm.patch_embed_dim),
                                        dtype)}, s - p
    elif cfg.kind == "audio":
        f = min(cfg.encdec.max_source_frames, s)
        prefix, text = {"frames": spec((b, f, cfg.d_model), dtype)}, s
    else:
        prefix, text = {}, s
    specs = dict(prefix, tokens=spec((b, text)))
    if shape.mode == "train":
        specs["targets"] = spec((b, text))
        specs["loss_mask"] = spec((b, text), torch.float32)
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Any:
    """The cache of a decode shape as ``meta`` tensors, in the layout
    ``init_cache`` gives it (long_500k at the long-context geometry)."""
    return get_model(cfg).init_cache(
        shape.global_batch, shape.seq_len,
        long_context=shape.name == "long_500k", device="meta")


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and cfg.long_context_mode == "skip":
        return False
    return cfg.kind != "classifier"
