"""Helpers for the tests that hold the PyTorch port against the JAX
reference: numpy conversion and a replayer of the reference's key chain.

The port takes its random draws (Gumbel noise, epoch permutations) as
tensors.  :class:`JaxKeyChain` evaluates ``jax.random`` on exactly the
keys the reference's host-loop server would use
(``fed/server.py:170,270-273,298-301``, ``core/sampling.py:96-116,
144-150``, ``core/selectors/baselines.py:218``,
``fed/client.py:127,151``) and hands the same numbers to the port;
:class:`ShimKeyChain` does the same for the reference's OO selector
shim, which draws from a key chain of its own.
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.core.selectors import SelectNoise
from repro_torch.fed.server import RoundDraws


def each(case, *axes):
    """Run ``case`` on every combination of ``axes``; a failure names
    its case.  The port's tests loop over their cases instead of
    parametrizing them: under pytest-xdist's load scheduling the chunk
    sizes grow with the number of collected items, and larger chunks
    put more of another module's heavy XLA compiles into one worker
    process, which XLA:CPU's per-process memory-map limit does not
    survive."""
    for args in itertools.product(*axes):
        try:
            case(*args)
        except AssertionError as e:
            raise AssertionError(f"{case.__name__}{args}: {e}") from e


def to_np(tree):
    """JAX/torch tree of arrays -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def select_noise(k_sel, n: int, k: int, m: int) -> SelectNoise:
    """The Gumbel draws of one reference ``select`` on key ``k_sel``:
    the coverage sweep's and weighted sampler's (N,), the two-stage
    sampler's per-draw (M,) cluster and (N,) client noise, and
    Clustered Sampling's (K, N) pick, each on the key the reference
    draws it from."""
    k = min(k, n)
    cover = jax.random.gumbel(k_sel, (n,), jnp.float32)
    pick = jax.random.gumbel(k_sel, (k, n), jnp.float32)
    cluster, client = [], []
    key = k_sel
    for _ in range(k):
        key, kc, kj = jax.random.split(key, 3)
        cluster.append(jax.random.gumbel(kc, (m,), jnp.float32))
        client.append(jax.random.gumbel(kj, (n,), jnp.float32))
    return SelectNoise(torch.tensor(np.asarray(cover)),
                       torch.tensor(np.stack(cluster)),
                       torch.tensor(np.stack(client)),
                       torch.tensor(np.asarray(pick)))


def epoch_perms(k_loc, k: int, epochs: int, s_max: int) -> torch.Tensor:
    """The (K, epochs, S_max) permutations the reference's vmapped
    local update draws from the round's local key."""
    out = []
    for rng in jax.random.split(k_loc, k):
        erngs = jax.random.split(rng, epochs)
        out.append([np.asarray(jax.random.permutation(e, s_max))
                    for e in erngs])
    return torch.tensor(np.asarray(out), dtype=torch.int64)


class JaxKeyChain:
    """Replays the reference server's per-round key chain as the
    port's :class:`RoundDraws`; call it with the round index.
    ``grad_all`` follows DivFL's ideal setting, whose all-clients poll
    splits one more key off the chain after each round's
    (``fed/server.py:298-301``): one (N, 1, S_max) permutation set."""

    def __init__(self, seed: int, n: int, k: int, m: int, epochs: int,
                 s_max: int, grad_all: bool = False):
        self.rng = jax.random.PRNGKey(seed)
        self.rng, self.init_key = jax.random.split(self.rng)
        self.n, self.k, self.m = n, k, m
        self.epochs, self.s_max = epochs, s_max
        self.grad_all = grad_all

    def __call__(self, t: int) -> RoundDraws:
        self.rng, kr = jax.random.split(self.rng)
        k_sel, k_loc = jax.random.split(kr)
        grad_perms = None
        if self.grad_all:
            self.rng, kg = jax.random.split(self.rng)
            grad_perms = epoch_perms(kg, self.n, 1, self.s_max)
        return RoundDraws(select_noise(k_sel, self.n, self.k, self.m),
                          epoch_perms(k_loc, self.k, self.epochs,
                                      self.s_max), grad_perms)


class ShimKeyChain:
    """Replays the reference OO shim's own key chain
    (``core/selectors/base.py:52-53,77``): ``PRNGKey(seed)`` split once
    for the state's init, then once for each ``select``.  Call it with
    the round index for that round's :class:`SelectNoise`."""

    def __init__(self, seed: int, n: int, k: int, m=None):
        self.key, _ = jax.random.split(jax.random.PRNGKey(seed))
        self.n, self.k = n, k
        self.m = min(k, n) if m is None else m

    def __call__(self, t: int) -> SelectNoise:
        self.key, sub = jax.random.split(self.key)
        return select_noise(sub, self.n, self.k, self.m)
