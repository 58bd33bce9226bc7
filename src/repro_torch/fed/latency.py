"""Pluggable latency models for the buffered-async server.

The port of the reference's ``fed/latency.py``, bit-equal tables.  The
async tick (``repro_torch.fed.async_server``) is one captured step a
tick because arrival order is *data*, not control flow: a latency
model is materialized host-side into two plain int32 delay tables —

    base   : (N,)    per-client base delay in ticks (systematic
                     heterogeneity: slow hardware, bad links)
    jitter : (T, K)  per-dispatch jitter for the K cohort slots of
                     every tick (stochastic network noise)

and a dispatch of client ``i`` in slot ``s`` of tick ``t`` arrives at
``t + clip(base[i] + jitter[t, s], 0, max_lag)``.  The tables are
drawn from ``numpy.random.default_rng(spec.seed)`` — a PRNG stream
fully independent of the generator the training loop draws from, so
adding/charging a latency model can never perturb selection or local
training (the parity oracle's identity model is all-zeros by
construction).

The zoo (``LatencySpec.kind``):

  identity    — every delay 0: the async loop degenerates to the sync
                round loop (the parity oracle).
  uniform     — iid jitter ~ U{0, .., scale}.
  lognormal   — heavy-tail iid jitter ~ ⌊LogNormal(mu, scale)⌋; the
                classic straggler-tail shape.
  stragglers  — a ``straggler_frac`` cohort of clients (chosen by a
                deterministic Bernoulli on the spec seed) carries a
                constant ``straggler_delay`` base; everyone else is
                fast.  Models systematic device heterogeneity.
  flash_crowd — jitter ``period − 1 − (t mod period)``: every dispatch
                of a period lands on the period's last tick at once —
                the burst-arrival stress test for the ring buffer's
                overflow accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

KINDS = ("identity", "uniform", "lognormal", "stragglers", "flash_crowd")


@dataclasses.dataclass(frozen=True)
class LatencySpec:
    kind: str = "identity"
    base: int = 0                  # constant base delay added to all
    scale: float = 2.0             # uniform high / lognormal sigma
    mu: float = 0.5                # lognormal location
    straggler_frac: float = 0.2
    straggler_delay: int = 8
    period: int = 8                # flash_crowd burst period
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"latency kind must be one of {KINDS}, "
                             f"got {self.kind!r}")


def delay_tables(spec: LatencySpec, num_clients: int, ticks: int,
                 k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize ``(base (N,), jitter (T, K))`` int32 delay tables.

    Pure host-side numpy from ``spec.seed`` — rerunning with the same
    spec reproduces the same traffic shape bit-for-bit, and the tables
    ride the tick as ordinary inputs (``jitter`` rows as per-tick
    draws, ``base`` as a device constant)."""
    rng = np.random.default_rng(int(spec.seed))
    n, t, k = int(num_clients), int(ticks), int(k)
    base = np.full(n, int(spec.base), np.int32)
    jitter = np.zeros((t, k), np.int32)
    if spec.kind == "identity":
        base = np.zeros(n, np.int32)
    elif spec.kind == "uniform":
        hi = max(0, int(spec.scale))
        jitter = rng.integers(0, hi + 1, (t, k)).astype(np.int32)
    elif spec.kind == "lognormal":
        jitter = np.floor(rng.lognormal(
            float(spec.mu), float(spec.scale), (t, k))).astype(np.int32)
    elif spec.kind == "stragglers":
        slow = rng.random(n) < float(spec.straggler_frac)
        base = base + np.where(slow, int(spec.straggler_delay),
                               0).astype(np.int32)
        jitter = rng.integers(0, 2, (t, k)).astype(np.int32)
    elif spec.kind == "flash_crowd":
        p = max(1, int(spec.period))
        per_tick = (p - 1 - (np.arange(t) % p)).astype(np.int32)
        jitter = np.broadcast_to(per_tick[:, None], (t, k)).copy()
    return base, jitter


def max_delay(spec: LatencySpec, base: np.ndarray, jitter: np.ndarray,
              max_lag: int) -> int:
    """Largest delay any dispatch can see after the ``max_lag`` clip —
    sizes the server's in-flight window (W = max_delay + 1)."""
    raw = int(base.max(initial=0)) + int(jitter.max(initial=0))
    return max(0, min(raw, int(max_lag)))
