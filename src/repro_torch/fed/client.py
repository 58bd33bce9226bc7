"""Client-side LocalUpdate (Algorithm 1 line 3): fedavg with sgd or
adam, and the server's all-clients loss poll.

The port of the reference's ``fed/client.py`` for fedavg.
:class:`LocalSpec` takes the reference's fields and names; the other
algorithms and sgd-momentum raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.  Every
client's data is padded to a common (S_max, d) with a sample mask, and
the whole cohort of K clients trains at once: ``torch.func.vmap`` of
``torch.func.grad_and_value`` over the K stacked param dicts.  The
epoch permutations are an input, (K, epochs, S_max), in place of the
reference's per-epoch ``jax.random.permutation``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from repro_torch.core.selectors.functional import LOCAL_UPDATES, not_ported
from repro_torch.optim import adam, apply_updates, sgd, tree_map

ALGOS = ("fedavg", "fedprox", "feddyn", "moon")
OPTIMIZERS = ("sgd", "momentum", "adam")


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    """The reference's ``LocalSpec``: an unknown ``algo`` or
    ``optimizer`` raises ``ValueError``, as there; a known one the port
    does not run yet (every algo but fedavg, the momentum optimizer)
    raises ``NotImplementedError``.  ``mu`` and ``moon_tau`` are read
    only by those algorithms."""
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
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}")
        if self.algo != "fedavg":
            raise not_ported("algo", self.algo, LOCAL_UPDATES)
        if self.optimizer == "momentum":
            raise not_ported("optimizer", self.optimizer, LOCAL_UPDATES)


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


def make_local_update(apply_fn: Callable, spec: LocalSpec) -> Callable:
    """Build ``local_update(global_params, x, y, mask, perms, lr_scale)``
    for a cohort: x (K, S, d), y and mask (K, S), perms (K, epochs, S)
    int64, lr_scale a 0-d f32 tensor.  Returns (K-stacked local params,
    {"train_loss": (K,)}), the loss being the mean over epochs of the
    mean over steps, as in the reference.  The optimizer state is made
    anew in each call, as the reference's ``opt.init(params0)``."""
    opt = {"sgd": sgd, "adam": adam}[spec.optimizer](spec.lr)

    def loss_fn(params, xb, yb, mb):
        return masked_ce(apply_fn(params, xb), yb, mb)

    cohort_grad = vmap(grad_and_value(loss_fn))

    def local_update(global_params, x, y, mask, perms, lr_scale):
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
                grads, loss = cohort_grad(params, xb[:, b], yb[:, b],
                                          mb[:, b])
                # a fully masked (padding-only) batch gets zero grads: a
                # no-op under sgd, while adam's moments and count still
                # advance, as in the reference
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
        return params, {"train_loss": train_loss}

    return local_update


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
