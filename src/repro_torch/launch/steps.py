"""Step builders shared by the serving driver, the one-card dry run and
the local multi-host mode: train_step (forward, backward, clip and the
optimizer), prefill_step and serve_step (one-token decode + greedy
sample), as the reference's ``launch/steps.py`` builds them.

The compute dtype defaults to bf16, as the reference's; the serving
driver passes f32 (``launch/serve.py``).  Greedy sampling takes the
first maximum (``torch.argmax``, as ``jnp.argmax``).  The LM
fine-tuning driver (``launch/train.py``) has its own local update."""
from __future__ import annotations

import torch

from repro_torch.optim import clip_by_global_norm_, tree_map
from repro_torch.roofline.cost import phase


def _paths(tree, prefix=()):
    """The key paths of a dict tree's leaves, in ``tree_leaves`` order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


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
    ever live, only one layer's slice of one leaf."""
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
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for g, p in zip(grads, leaves)]
        phase("update")
        gnorm = clip_by_global_norm_(grads, clip_norm)
        # the optimizer's per-leaf trees (m, v) beside its scalars (count)
        trees = [k for k, v in opt.items() if isinstance(v, dict)]
        new_opt = dict(opt)
        with torch.no_grad():
            for i, path in enumerate(paths):
                # a stacked leaf (layers on axis 0) a layer at a time, its
                # m and v written back in place
                leaf, grad = leaves[i], grads[i]
                parts = range(leaf.shape[0]) if leaf.dim() >= 3 else [...]
                for j in parts:
                    sub = {k: (_get(opt[k], path)[j] if k in trees else v)
                           for k, v in opt.items()}
                    upd, sub = optimizer.update(grad[j], sub, leaf[j])
                    leaf[j] += upd
                    for k in trees:
                        _get(opt[k], path)[j].copy_(sub[k])
                    new_opt.update({k: v for k, v in sub.items()
                                    if k not in trees})
                grads[i] = grad = None
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
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
        token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return token[:, None], cache
    return prefill_step


def make_serve_step(api, *, long_context: bool = False,
                    dtype=torch.bfloat16):
    def serve_step(params, cache, batch):
        logits, cache = api.decode_step(params, cache, batch,
                                        long_context=long_context,
                                        dtype=dtype)
        token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return token[:, None], cache
    return serve_step
