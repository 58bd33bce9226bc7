"""Client-side LocalUpdate (Algorithm 1 line 3) for every FL-algorithm ×
optimizer pair the paper analyzes, and the server's all-clients loss
poll:

  algorithms : fedavg | fedprox (Eq. 67) | feddyn (Eq. 74) | moon (Eq. 91)
  optimizers : sgd | sgd-momentum | adam        (App. A.9)

The port of the reference's ``fed/client.py``.  Every client's data is
padded to a common (S_max, d) with a sample mask, and the whole cohort
of K clients trains at once: ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the K stacked param dicts and the K
stacked per-client extras (FedDyn's ``h``, Moon's ``prev``).  The epoch
permutations are an input, (K, epochs, S_max), in place of the
reference's per-epoch ``jax.random.permutation``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch.func import grad_and_value, vmap

from repro_torch.optim import (adam, apply_updates, sgd, sgd_momentum,
                               tree_leaves, tree_map)

ALGOS = ("fedavg", "fedprox", "feddyn", "moon")
OPTIMIZERS = {"sgd": sgd, "momentum": sgd_momentum, "adam": adam}


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """The reference's ``LocalSpec``: an unknown ``algo`` or
    ``optimizer`` raises ``ValueError``, as there.  ``mu`` weighs the
    fedprox, feddyn and moon terms, ``moon_tau`` is Moon's contrastive
    temperature."""
    algo: str = "fedavg"
    optimizer: str = "sgd"
    lr: float = 0.001
    epochs: int = 2              # R in the paper
    batch_size: int = 64         # B in the paper
    mu: float = 0.1              # fedprox/feddyn/moon regularization weight
    moon_tau: float = 0.5        # Moon contrastive temperature

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"algo must be one of {ALGOS}")
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(
                f"optimizer must be one of {tuple(OPTIMIZERS)}")


def masked_ce(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows with mask > 0, along the last
    axis of ``mask`` (the leading axes, if any, are kept)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.long()[..., None])[..., 0]
    # where(), not multiply-by-zero: a padded row may carry any value,
    # and 0·inf would leak NaN into the mean
    per = torch.where(mask > 0, logz - tgt, 0.0) * mask
    return per.sum(dim=-1) / torch.clamp(mask.sum(dim=-1), min=1.0)


def _tree_sum(fn, a: dict, b: dict) -> torch.Tensor:
    """Σ over the leaves of ``fn(a_leaf, b_leaf).sum()``, leaf by leaf in
    the reference's order (dict keys sorted), from 0 as Python's
    ``sum``: the order sets the loss's last bits."""
    total = 0
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        total = total + torch.sum(fn(x, y))
    return total


def _tree_sqdist(a: dict, b: dict) -> torch.Tensor:
    return _tree_sum(lambda x, y: torch.square(x - y), a, b)


def _tree_dot(a: dict, b: dict) -> torch.Tensor:
    return _tree_sum(torch.mul, a, b)


def _moon_term(feat, feat_glob, feat_prev, tau: float,
               mask) -> torch.Tensor:
    """−log(e^{sim(z, z_g)/τ} / (e^{sim(z, z_g)/τ} + e^{sim(z, z_p)/τ})),
    the mean over the rows with mask > 0."""
    def cos(u, v):
        un = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-8)
        vn = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)
        return torch.sum(un * vn, dim=-1)

    pos = cos(feat, feat_glob) / tau
    neg = cos(feat, feat_prev) / tau
    per = torch.logsumexp(torch.stack([pos, neg], dim=-1), dim=-1) - pos
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_local_update(apply_fn: Callable, spec: LocalSpec,
                      features_fn: Optional[Callable] = None) -> Callable:
    """Build ``local_update(global_params, extra, x, y, mask, perms,
    lr_scale)`` for a cohort: ``extra`` the K-stacked per-client extras
    (:func:`init_extra`'s keys, each leaf with a leading K axis; ``{}``
    for fedavg and fedprox), x (K, S, d), y and mask (K, S), perms
    (K, epochs, S) int64, lr_scale a 0-d f32 tensor.  Returns (K-stacked
    local params, the K-stacked new extras, {"train_loss": (K,)}), the
    loss being the mean over epochs of the mean over steps of the
    algorithm's whole objective, as in the reference.  The optimizer
    state is made anew in each call, as the reference's
    ``opt.init(params0)``.  Moon needs ``features_fn(params, x)``, the
    penultimate activations."""
    opt = OPTIMIZERS[spec.optimizer](spec.lr)
    algo, mu = spec.algo, spec.mu
    if algo == "moon" and features_fn is None:
        raise ValueError("moon requires a features_fn")

    def loss_fn(params, global_params, extra, xb, yb, mb):
        loss = masked_ce(apply_fn(params, xb), yb, mb)
        if algo == "fedprox":
            loss = loss + 0.5 * mu * _tree_sqdist(params, global_params)
        elif algo == "feddyn":
            loss = (loss - _tree_dot(extra["h"], params)
                    + 0.5 * mu * _tree_sqdist(params, global_params))
        elif algo == "moon":
            # the anchors carry no gradient, as the reference's
            # stop_gradient
            feat = features_fn(params, xb)
            fg = features_fn(global_params, xb).detach()
            fp = features_fn(extra["prev"], xb).detach()
            loss = loss + mu * _moon_term(feat, fg, fp, spec.moon_tau, mb)
        return loss

    cohort_grad = vmap(grad_and_value(loss_fn),
                       in_dims=(0, None, 0, 0, 0, 0))

    def local_update(global_params, extra, x, y, mask, perms, lr_scale):
        k, s_max = x.shape[:2]
        bs = min(spec.batch_size, s_max)
        nb = max(1, s_max // bs)
        usable = nb * bs
        rows = torch.arange(k, device=x.device)[:, None]
        params = tree_map(lambda p: p.expand(k, *p.shape).clone(),
                          global_params)
        opt_state = opt.init(params)
        epoch_losses = []
        for e in range(spec.epochs):
            perm = perms[:, e, :usable]
            xb = x[rows, perm].reshape(k, nb, bs, *x.shape[2:])
            yb = y[rows, perm].reshape(k, nb, bs)
            mb = mask[rows, perm].reshape(k, nb, bs)
            step_losses = []
            for b in range(nb):
                grads, loss = cohort_grad(params, global_params, extra,
                                          xb[:, b], yb[:, b], mb[:, b])
                # a fully masked (padding-only) batch gets zero grads,
                # the algorithm's terms included: a no-op under sgd,
                # while momentum's m decays and adam's moments and
                # count advance, as in the reference
                live = (mb[:, b].sum(dim=-1) > 0).float()
                grads = tree_map(
                    lambda g: g * live.view(-1, *([1] * (g.dim() - 1))),
                    grads)
                updates, opt_state = opt.update(grads, opt_state, params,
                                                lr_scale=lr_scale)
                params = apply_updates(params, updates)
                step_losses.append(loss)
            epoch_losses.append(torch.stack(step_losses, dim=1).mean(dim=1))
        train_loss = torch.stack(epoch_losses, dim=1).mean(dim=1)
        new_extra = dict(extra)
        if algo == "feddyn":
            # h_k ← h_k − μ (θ_k − θ^t)
            new_extra["h"] = tree_map(lambda h, p, g: h - mu * (p - g),
                                      extra["h"], params, global_params)
        elif algo == "moon":
            new_extra["prev"] = params
        return params, new_extra, {"train_loss": train_loss}

    return local_update


def init_extra(spec: LocalSpec, params: dict) -> Dict[str, dict]:
    """Per-client persistent algorithm state at round 0 (one client's,
    unstacked): FedDyn's ``h`` zeros, Moon's ``prev`` the params."""
    extra: Dict[str, dict] = {}
    if spec.algo == "feddyn":
        extra["h"] = tree_map(torch.zeros_like, params)
    if spec.algo == "moon":
        extra["prev"] = params
    return extra


def make_eval_fn(apply_fn: Callable) -> Callable:
    """(params, x, y, mask) -> (loss, acc), both 0-d tensors."""
    @torch.no_grad()
    def evaluate(params, x, y, mask):
        logits = apply_fn(params, x)
        loss = masked_ce(logits, y, mask)
        hit = (logits.argmax(dim=-1) == y.long()).float() * mask
        return loss, hit.sum() / torch.clamp(mask.sum(), min=1.0)

    return evaluate


def make_loss_poll(apply_fn: Callable) -> Callable:
    """(params, x (N, S, d), y (N, S), mask (N, S)) -> (N,) global-model
    loss on every client's data: the ``loss_all`` observation (pow-d,
    FedCor), the reference's vmapped ``make_eval_fn`` loss, here as one
    batched forward over all N·S rows."""
    @torch.no_grad()
    def poll(params, x, y, mask):
        n, s = x.shape[:2]
        logits = apply_fn(params, x.reshape(n * s, *x.shape[2:]))
        return masked_ce(logits.reshape(n, s, -1), y, mask)

    return poll
