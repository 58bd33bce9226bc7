"""Step builders shared by the serving driver, the one-card dry run and
the local multi-host mode: train_step (forward, backward, clip and the
optimizer), prefill_step and serve_step (one-token decode + greedy
sample), as the reference's ``launch/steps.py`` builds them.

The compute dtype defaults to bf16, as the reference's; the serving
driver passes f32 (``launch/serve.py``).  Greedy sampling takes the
first maximum (``torch.argmax``, as ``jnp.argmax``).  The LM
fine-tuning driver (``launch/train.py``) has its own local update.

Under a sharding policy (``sharding.use_policy``) the steps take
``DTensor`` state and batches (:func:`shard_state`, :func:`shard_batch`)
and run the same code: DTensor and the models' ``constrain`` calls
place the activations, the optimizer's m and v take the params'
placements (ZeRO-3 on the mesh), and the update runs on each rank's
shards.  Their metrics come back as whole tensors."""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.optim import clip_by_global_norm_, tree_map
from repro_torch.roofline.cost import phase
from repro_torch.sharding import (batch_pspecs, cache_pspecs, param_pspecs,
                                  to_shardings)


def _paths(tree, prefix=()):
    """The key paths of a dict tree's leaves, in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _local(t):
    """This rank's shard of a DTensor, a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def _placed_like(g, p):
    """A gradient in its param's placements (a reduce-scatter where it
    comes back partial or otherwise placed)."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def shard_params(params, policy):
    """Params as DTensors placed by ``param_pspecs``."""
    return to_shardings(params, param_pspecs(params, policy), policy)


def shard_state(state, policy):
    """A train state's params, and the optimizer's per-leaf trees (adam's
    m and v), as DTensors in the params' placements; the scalars
    (``count``, ``step``) stay plain tensors, replicated."""
    specs = param_pspecs(state["params"], policy)
    opt = {k: to_shardings(v, specs, policy) if isinstance(v, dict) else v
           for k, v in state["opt"].items()}
    return dict(state, params=to_shardings(state["params"], specs, policy),
                opt=opt)


def shard_batch(batch, policy):
    """A batch's tensors over the data axes (``batch_pspecs``)."""
    return to_shardings(batch, batch_pspecs(batch, policy), policy)


def shard_cache(cache, policy):
    """A decode cache placed by ``cache_pspecs``."""
    return to_shardings(cache, cache_pspecs(cache, policy), policy)


def make_train_step(api, optimizer, *, dtype=torch.bfloat16,
                    clip_norm: float = 1.0, cast_params_bf16: bool = False):
    """``train_step(state, batch) -> (state, metrics)``: the loss in
    ``dtype`` and its gradients, clipped to ``clip_norm`` by the global
    norm, then one ``optimizer`` update of the f32 params, leaf by leaf.
    ``cast_params_bf16``: the loss reads a bf16 copy of the f32 params,
    cast once a step, and its gradients come back in f32 (the
    reference's mixed-precision compute copy).  Each layer is recomputed
    in the backward pass (the loss's ``remat``), as the reference's
    ``jax.checkpoint`` of every layer does.  ``metrics`` gets
    ``grad_norm``.

    The step consumes ``state``: the reference donates it, and the port
    writes the new params and optimizer state into its tensors (the
    same numbers as the reference's functional update), so that no
    second copy of the params, the optimizer state or the updates is
    ever live, only one layer's slice of one leaf.  On DTensors the
    gradients are first placed as their params (``_placed_like``), and
    the update runs on each rank's local shards, a layer's slice at a
    time as on one card."""
    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        paths = _paths(params)
        leaves = [_get(params, p) for p in paths]
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            compute = params
            if cast_params_bf16:
                compute = tree_map(lambda p: p.to(torch.bfloat16)
                                   if p.dtype == torch.float32 else p,
                                   params)
            loss, metrics = api.loss(compute, batch, dtype=dtype,
                                     remat=True)
            phase("backward")
            grads = list(torch.autograd.grad(loss, leaves,
                                             allow_unused=True))
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        del compute, loss
        grads = [torch.zeros_like(p) if g is None else
                 _placed_like(g.to(p.dtype), p)
                 for g, p in zip(grads, leaves)]
        phase("update")
        gnorm = clip_by_global_norm_(grads, clip_norm)
        # the optimizer's per-leaf trees (m, v) beside its scalars (count)
        trees = [k for k, v in opt.items() if isinstance(v, dict)]
        new_opt = dict(opt)
        with torch.no_grad():
            for i, path in enumerate(paths):
                # a stacked leaf (layers on axis 0) a layer at a time, its
                # m and v written back in place; a DTensor's local shard
                leaf, grad = _local(leaves[i]), _local(grads[i])
                parts = range(leaf.shape[0]) if leaf.dim() >= 3 else [...]
                for j in parts:
                    sub = {k: (_local(_get(opt[k], path))[j] if k in trees
                               else v) for k, v in opt.items()}
                    upd, sub = optimizer.update(grad[j], sub, leaf[j])
                    leaf[j] += upd
                    for k in trees:
                        _local(_get(opt[k], path))[j].copy_(sub[k])
                    new_opt.update({k: v for k, v in sub.items()
                                    if k not in trees})
                grads[i] = grad = None
        metrics = {k: _whole(v.detach()) for k, v in metrics.items()}
        metrics["grad_norm"] = _whole(gnorm)
        return {"params": params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_init_state(api, optimizer):
    """``init_state(seed, device=...) -> {params, opt, step}``."""
    def init_state(seed: int = 0, *, device="cuda"):
        params = api.init(seed, device=device)
        leaf = torch.utils._pytree.tree_leaves(params)[0]
        return {"params": params, "opt": optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=leaf.device)}
    return init_state


def make_prefill_step(api, *, dtype=torch.bfloat16, cache_extra: int = 0):
    """cache_extra: decode headroom slots appended to the KV cache — set
    it to the number of tokens to generate after the prefill."""
    def prefill_step(params, batch):
        logits, cache = api.prefill(params, batch, dtype=dtype,
                                    cache_extra=cache_extra)
        token = _whole(torch.argmax(logits[:, -1, :], dim=-1)).to(torch.int32)
        return token[:, None], cache
    return prefill_step


def make_serve_step(api, *, long_context: bool = False,
                    dtype=torch.bfloat16):
    def serve_step(params, cache, batch):
        logits, cache = api.decode_step(params, cache, batch,
                                        long_context=long_context,
                                        dtype=dtype)
        token = _whole(torch.argmax(logits[:, -1, :], dim=-1)).to(torch.int32)
        return token[:, None], cache
    return serve_step
