"""Optimizers over nested param dicts, with ``lr_scale`` a tensor.

The port of the reference's ``sgd``: ``update`` returns −lr·lr_scale·g
per leaf, and the server's lr decay rides in as a 0-d tensor.
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


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None, lr_scale=1.0):
        del params
        step = -lr * lr_scale
        return (tree_map(lambda g: step * g, grads),
                {"count": state["count"] + 1})

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
