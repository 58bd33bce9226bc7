"""Losses of the paper's classifiers: the port's copy of the
reference's ``models/losses.py: classifier_loss``."""
from __future__ import annotations

from typing import Tuple

import torch


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
