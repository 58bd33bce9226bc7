"""The paper's client models (App. A.1.1): paper-cnn and paper-mlp.

Params are nested dicts of tensors keyed like the reference's
(``conv1``, ``conv2``, ``fc``, ``lm_head``, each ``{"w", "b"}``), and
inputs are (B, 196) flattened 14×14 images.  Dense weights keep the
reference's (in, out) layout.  The convolutions run in NCHW with OIHW
weights; before the flatten the activations are permuted back to NHWC,
so ``fc/w`` is the reference's ``fc/w`` element for element.  SAME
padding is ``padding=2`` for the 5×5 convs, and the SAME 2×2 pools
(14→7→4) are ``max_pool2d(2, ceil_mode=True)``.

Functions are pure in the params, so ``torch.func`` can vmap and
differentiate them over a cohort of clients.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.losses import classifier_loss

IMG = 14  # synthetic "image" side for the CNN


def _dense(gen: torch.Generator, shape) -> torch.Tensor:
    """Truncated-normal fan-in init, as the reference's ``dense_init``:
    std 1/√fan_in, truncated at ±2 std."""
    w = torch.empty(shape)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w / math.sqrt(shape[-2])


def init_cnn_params(gen: torch.Generator, cfg, device="cuda") -> dict:
    c1, c2 = 16, cfg.d_model
    side = -(-(-(-IMG // 2)) // 2)            # SAME pooling twice: 4
    params = {
        "conv1": {"w": 0.1 * torch.randn((c1, 1, 5, 5), generator=gen),
                  "b": torch.zeros(c1)},
        "conv2": {"w": 0.1 * torch.randn((c2, c1, 5, 5), generator=gen),
                  "b": torch.zeros(c2)},
        "fc": {"w": _dense(gen, (side * side * c2, cfg.d_ff)),
               "b": torch.zeros(cfg.d_ff)},
        "lm_head": {"w": _dense(gen, (cfg.d_ff, cfg.vocab_size)),
                    "b": torch.zeros(cfg.vocab_size)},
    }
    return _to(params, device)


def init_mlp_params(gen: torch.Generator, cfg, input_dim: int,
                    device="cuda") -> dict:
    h = cfg.d_model
    params = {
        "fc1": {"w": _dense(gen, (input_dim, h)), "b": torch.zeros(h)},
        "fc2": {"w": _dense(gen, (h, h)), "b": torch.zeros(h)},
        "lm_head": {"w": _dense(gen, (h, cfg.vocab_size)),
                    "b": torch.zeros(cfg.vocab_size)},
    }
    return _to(params, device)


def _to(params: dict, device) -> dict:
    return {k: {kk: v.to(device) for kk, v in p.items()}
            for k, p in params.items()}


def params_from_jax(tree: dict, device="cuda") -> dict:
    """Carry a reference param tree (nested dicts of numpy arrays) over:
    conv weights HWIO -> OIHW, everything else as it is."""
    out = {}
    for name, p in tree.items():
        w = np.asarray(p["w"], dtype=np.float32)
        if name.startswith("conv"):
            w = w.transpose(3, 2, 0, 1)
        out[name] = {"w": torch.tensor(np.ascontiguousarray(w)),
                     "b": torch.tensor(np.asarray(p["b"], np.float32))}
    return _to(out, device)


def cnn_features(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 196) -> the penultimate ReLU activations (B, d_ff), Moon's
    contrastive anchor."""
    b = x.shape[0]
    h = x.reshape(b, 1, IMG, IMG)
    for name in ("conv1", "conv2"):
        h = F.relu(F.conv2d(h, params[name]["w"], params[name]["b"],
                            padding=2))
        h = F.max_pool2d(h, 2, ceil_mode=True)
    h = h.permute(0, 2, 3, 1).reshape(b, -1)   # NHWC flatten
    return F.relu(h @ params["fc"]["w"] + params["fc"]["b"])


def cnn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, 196) -> logits (B, C)."""
    h = cnn_features(params, x)
    return h @ params["lm_head"]["w"] + params["lm_head"]["b"]


def mlp_features(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, input_dim) -> the penultimate ReLU activations (B, h)."""
    h = F.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return F.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, input_dim) -> logits (B, C)."""
    h = mlp_features(params, x)
    return h @ params["lm_head"]["w"] + params["lm_head"]["b"]


def make_classifier(cfg, input_dim: int = 64):
    """(init(gen, device), apply(params, x), loss_fn(params, batch)) for
    paper-cnn or paper-mlp, as the reference's: ``loss_fn`` is
    :func:`repro_torch.models.losses.classifier_loss` of the logits of
    ``batch["x"]`` against ``batch["y"]``.  ``input_dim`` sizes the
    mlp; the cnn takes 196 = 14·14."""
    if cfg.name.startswith("paper-cnn"):
        init = lambda gen, device="cuda": init_cnn_params(gen, cfg, device)
        apply = cnn_apply
    else:
        init = lambda gen, device="cuda": init_mlp_params(gen, cfg, input_dim,
                                                          device)
        apply = mlp_apply

    def loss_fn(params, batch):
        return classifier_loss(apply(params, batch["x"]), batch["y"])

    return init, apply, loss_fn


def make_classifier_with_features(cfg, input_dim: int = 64):
    """(init, apply, features): :func:`make_classifier`'s init and apply
    and the model's penultimate activations, which feed Moon's
    contrastive term."""
    init, apply, _ = make_classifier(cfg, input_dim)
    features = (cnn_features if cfg.name.startswith("paper-cnn")
                else mlp_features)
    return init, apply, features
