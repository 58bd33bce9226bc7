"""Losses: the port of the reference's ``models/losses.py``.

The LM cross-entropy runs over sequence chunks, so that the (B, S, V)
logits are never whole: at qwen2.5-3b's vocabulary one chunk of 512
positions is 311 MB of f32 logits.  Under autograd each chunk is
recomputed in the backward pass (``torch.utils.checkpoint``), so one
chunk's logits are live at a time there too.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding import vocab_argmax, vocab_terms


def _chunk_ce(x, head_w, head_b, targets, mask):
    """x: (B, C, d) hidden; returns (sum of the loss, of the mask, of
    the correct argmaxes), f32 logits, argmax ties to the lower index
    (as ``jnp.argmax``)."""
    logits = torch.einsum("bcd,dv->bcv", x, head_w.to(x.dtype)).float()
    if head_b is not None:
        logits = logits + head_b.float()
    logz, tgt = vocab_terms(logits, targets)              # (B, C) each
    ce = (logz - tgt) * mask
    correct = (vocab_argmax(logits) == targets.long()) * mask
    return ce.sum(), mask.sum(), correct.sum()


def chunked_lm_loss(x, head_w, head_b, targets, mask,
                    chunk: int = 512) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d); head_w: (d, V); targets/mask: (B, S).

    S ≤ ``chunk`` is one chunk.  Otherwise ``chunk`` falls back to the
    largest divisor of S below it, and the sums of the chunks are
    added in chunk order, as the reference's scan adds them.
    """
    b, s, _ = x.shape
    mask = mask.float()
    if s <= chunk:
        tot, cnt, cor = _chunk_ce(x, head_w, head_b, targets, mask)
    else:
        while s % chunk:
            chunk -= 1
        zero = torch.zeros((), device=x.device)
        tot, cnt, cor = zero, zero, zero
        for i in range(0, s, chunk):
            part = (x[:, i:i + chunk], head_w, head_b,
                    targets[:, i:i + chunk], mask[:, i:i + chunk])
            if torch.is_grad_enabled():
                t, c, r = checkpoint(_chunk_ce, *part, use_reentrant=False,
                                     preserve_rng_state=False)
            else:
                t, c, r = _chunk_ce(*part)
            tot, cnt, cor = tot + t, cnt + c, cor + r
    denom = torch.clamp(cnt, min=1.0)
    loss = tot / denom
    return loss, {"ce_loss": loss, "accuracy": cor / denom, "tokens": cnt}


def classifier_loss(logits: torch.Tensor,
                    labels: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Plain CE over one-hot labels (the paper's Eq. 13): the mean over
    rows of logsumexp(logits) − logits[label] in f32, and the accuracy
    of the argmax (ties to the lower index, as ``jnp.argmax``)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, labels.long()[..., None])[..., 0]
    loss = (logz - tgt).mean()
    acc = (logits.argmax(dim=-1) == labels.long()).float().mean()
    return loss, {"ce_loss": loss, "accuracy": acc}
