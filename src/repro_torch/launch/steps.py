"""Step builders of the serving entry point: prefill_step and serve_step
(one-token decode + greedy sample), as the reference's
``launch/steps.py`` builds them.  Greedy sampling takes the first
maximum (``torch.argmax``, as ``jnp.argmax``).  The reference's
``make_train_step`` and ``make_init_state`` serve only its dry-run and
multi-host drivers, which are not ported; the LM fine-tuning driver
(``launch/train.py``) has its own local update."""
from __future__ import annotations

import torch


def make_prefill_step(api, *, cache_extra: int = 0):
    """cache_extra: decode headroom slots appended to the KV cache — set
    it to the number of tokens to generate after the prefill."""
    def prefill_step(params, batch):
        logits, cache = api.prefill(params, batch, cache_extra=cache_extra)
        token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return token[:, None], cache
    return prefill_step


def make_serve_step(api):
    def serve_step(params, cache, batch):
        logits, cache = api.decode_step(params, cache, batch)
        token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        return token[:, None], cache
    return serve_step
