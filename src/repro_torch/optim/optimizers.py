"""Optimizers over nested param dicts, with ``lr_scale`` a tensor.

The port of the reference's ``optim/optimizers.py``: ``sgd``,
``sgd_momentum`` and ``adam`` as (init, update) pairs, ``update``
returning the step per leaf, and ``clip_by_global_norm``.  The server's
lr decay rides in as a 0-d tensor, and momentum's and adam's ``count``
is a 0-d int32 tensor, so a round step captured as a CUDA graph reads
no host number.

``clip_by_global_norm_`` is the in-place form the LM fine-tuning driver
applies leaf by leaf: at qwen2.5-3b's widths a second tree of clipped
gradients would not fit beside the params, their copies and the
gradients.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested dicts and tuples of tensors (a
    named tuple keeps its type); a None leaf stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple):
        out = [tree_map(fn, *leaves) for leaves in zip(*trees, strict=True)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and tuples in
    ``jax.tree_util.tree_leaves`` order: dict keys sorted at every
    level, tuple items in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def _first_leaf(tree) -> torch.Tensor:
    return tree_leaves(tree)[0]


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None, lr_scale=1.0):
        del params
        step = -lr * lr_scale
        return (tree_map(lambda g: step * g, grads),
                {"count": state["count"] + 1})

    return Optimizer(init, update)


def sgd_momentum(lr: float, momentum: float = 0.9) -> Optimizer:
    """The reference's momentum: an EMA of the gradients,
    ``m = β·m + (1 − β)·g``, and the step ``−lr·m`` (not
    ``torch.optim.SGD``'s ``m = β·m + g``); ``count`` a 0-d int32
    tensor."""
    def init(params):
        dev = _first_leaf(params).device
        return {"m": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None, lr_scale=1.0):
        del params
        m = tree_map(lambda mm, g: momentum * mm + (1.0 - momentum) * g,
                     state["m"], grads)
        step_lr = -lr * lr_scale
        return (tree_map(lambda mm: step_lr * mm, m),
                {"m": m, "count": state["count"] + 1})

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    """The reference's adam: m and v in f32, ``count`` a 0-d int32
    tensor, the step ``m / bc1 / (sqrt(v / bc2) + eps)`` with
    ``bc = 1 - b ** count``, in that order."""
    def init(params):
        dev = _first_leaf(params).device
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None, lr_scale=1.0):
        count = state["count"] + 1
        c = count.float()
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g),
                     state["v"], grads)
        bc1 = 1 - torch.pow(b1, c)
        bc2 = 1 - torch.pow(b2, c)
        step_lr = -lr * lr_scale

        def u(mm, vv, p):
            step = mm / bc1 / (torch.sqrt(vv / bc2) + eps)
            if weight_decay and p is not None:
                step = step + weight_decay * p
            return step_lr * step

        if params is None:
            upd = tree_map(lambda mm, vv: u(mm, vv, None), m, v)
        else:
            upd = tree_map(u, m, v, params)
        return upd, {"m": m, "v": v, "count": count}

    return Optimizer(init, update)


def global_norm(grads) -> torch.Tensor:
    """√(Σ over the leaves, in the reference's leaf order, of each
    leaf's sum of squares), f32.  ``torch.sum`` of the squares, as the
    reference: on the CPU ``torch.linalg.vector_norm`` of a long f32
    vector is far less accurate (8e-3 relative at 8e7 elements,
    measured), where the sum's pairwise order keeps ~1e-8."""
    total = 0
    for g in tree_leaves(grads):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads · min(1, max_norm / (‖grads‖ + 1e-9)), ‖grads‖)."""
    gn = global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """:func:`clip_by_global_norm` of a sequence of leaves in the
    reference's leaf order, scaling each in place.  Returns the norm."""
    gn = global_norm(tuple(grads))
    scale = _clip_scale(gn, max_norm)
    for g in grads:
        g.mul_(scale)
    return gn


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
