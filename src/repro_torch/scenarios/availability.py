"""Time-varying client availability, fed into selection as a mask.

The port of the reference's ``scenarios/availability.py``.  A
scenario's availability schedule is a function ``(t, uniform draw) ->
(N,) bool``, and :func:`masked_select` applies it to any functional
selector without touching the selector's own code:

  1. the selector sees a state whose weights are zeroed for
     unavailable clients (the stage-2 and multinomial samplers then
     avoid them on their own);
  2. any unavailable client that still slips through (HiCS-FL's
     coverage sweep, or a cluster whose members are all offline) is
     replaced by a Gumbel draw ∝ p_k from the available-and-unchosen
     pool.

If fewer than K clients are available the surplus picks are kept as
they are (the round proceeds under-provisioned rather than
deadlocking).  Randomness is an input: the dropout's (N,) uniform draw
and the replacement's (N,) Gumbel draw are the round's
(``fed.server.RoundDraws.avail`` and ``.repl``).  Nothing here reads a
tensor on the host, so the step stays capturable.
"""
from __future__ import annotations

import torch

from repro_torch.core.sampling import _topk_stable
from repro_torch.core.selectors.functional import (FunctionalSelector,
                                                   SelectNoise,
                                                   SelectorState)

_LOG_FLOOR = 1e-30


def availability_mask(scenario, num_clients: int, t,
                      uniform: torch.Tensor) -> torch.Tensor:
    """(N,) bool availability for round ``t`` (an int or a 0-d tensor).

    kinds: "always" — all on; "dropout" — iid Bernoulli(1 − p) per
    client per round, ``uniform < 1 − p`` on the round's (N,) uniform
    draw; "blocks" — staggered duty cycles: client k is offline for
    ``round(p·period)`` rounds of every ``period``, with phase k mod
    period (a crude diurnal model; ``uniform`` unread).
    """
    n = num_clients
    dev = uniform.device
    if scenario.availability == "always":
        return torch.ones(n, dtype=torch.bool, device=dev)
    if scenario.availability == "dropout":
        return uniform < torch.tensor(1.0 - scenario.avail_p,
                                      dtype=torch.float32)
    if scenario.availability == "blocks":
        period = max(1, int(scenario.avail_period))
        off = int(round(scenario.avail_p * period))
        tt = torch.as_tensor(t, device=dev).to(torch.int64)
        phase = torch.remainder(tt + torch.arange(n, device=dev), period)
        return phase >= off
    raise ValueError(f"unknown availability {scenario.availability!r}")


def replace_unavailable(gumbel: torch.Tensor, ids: torch.Tensor,
                        avail: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Swap unavailable picks for Gumbel draws ∝ weights from the
    available-and-unchosen pool (fixed shape; the top-k is the stable
    descending sort of ``core.sampling``).  ``gumbel`` is (N,) standard
    Gumbel f32."""
    k = ids.shape[0]
    n = avail.shape[0]
    idx = ids.long()
    chosen = torch.zeros(n, dtype=torch.bool,
                         device=avail.device).index_fill(0, idx, True)
    ok = avail.index_select(0, idx)                     # (K,) keepers
    pool = avail & ~chosen
    logw = torch.log(torch.clamp(weights, min=_LOG_FLOOR)).float()
    cand = _topk_stable(torch.where(pool, logw + gumbel, -torch.inf), k)
    rank = torch.clamp(torch.cumsum((~ok).to(torch.int64), 0) - 1, 0,
                       k - 1)                           # i-th bad: rank
    repl = cand.index_select(0, rank)
    # substitute only a candidate genuinely from the pool (the top-k
    # over an all -inf row returns arbitrary indices)
    use = ~ok & pool.index_select(0, repl)
    return torch.where(use, repl.to(ids.dtype), ids)


def masked_select(fn: FunctionalSelector, state: SelectorState, t,
                  noise: SelectNoise, avail: torch.Tensor,
                  repl_gumbel: torch.Tensor):
    """Run ``fn.select`` under an availability mask (see the module
    docstring).

    Returns (ids, state) as ``fn.select``; the output state keeps the
    selector's own transitions but the original weights (masking is per
    round, not persistent).  For clients the replacement swapped out,
    the select's marking of the seen pool is reverted: an offline
    client picked by a coverage sweep never trained, so it stays
    unseen (and its row unwritten) until it really participates.  The
    cache an incremental selector carries is written only from the
    observations of clients that really participated, so masked-out
    clients never reach it."""
    w0 = state.weights
    masked = state._replace(weights=torch.where(avail, w0,
                                                torch.zeros_like(w0)))
    ids0, out = fn.select(masked, t, noise)
    ids = replace_unavailable(repl_gumbel, ids0, avail, w0)
    idx0 = ids0.long()
    replaced = ids != ids0
    seen = out.seen.index_copy(0, idx0, torch.where(
        replaced, state.seen.index_select(0, idx0),
        out.seen.index_select(0, idx0)))
    return ids, out._replace(weights=w0, seen=seen,
                             unseen_count=(~seen).sum().to(torch.int32))
