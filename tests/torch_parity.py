"""Helpers for the tests that hold the PyTorch port against the JAX
reference: numpy conversion and a replayer of the reference's key chain.

The port takes its random draws (Gumbel noise, epoch permutations) as
tensors.  :class:`JaxKeyChain` evaluates ``jax.random`` on exactly the
keys the reference's host-loop server would use
(``fed/server.py:170,270-273,298-301``, ``core/sampling.py:96-116,
144-150``, ``core/selectors/baselines.py:218``,
``fed/client.py:127,151``) and hands the same numbers to the port;
:class:`ShimKeyChain` does the same for the reference's OO selector
shim, which draws from a key chain of its own.  :func:`partition_draws`
replays the reference's partition draws (``scenarios/partition_jax.py:
83-93,117-132,138-143``) and :func:`availability_draws` its
availability draws (``scenarios/sweep.py:236-240``).
"""
from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.scenarios.partition_jax import _equal_split_groups
from repro_torch.core.selectors import SelectNoise
from repro_torch.fed.server import RoundDraws
from repro_torch.scenarios import PartitionDraws


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


def _t(a):
    return torch.tensor(np.asarray(a))


def partition_draws(key, kind: str, num_samples: int, num_classes: int,
                    num_clients: int, alphas=(0.5,),
                    labels_per_client: int = 2,
                    beta: float = 0.5) -> PartitionDraws:
    """The reference's partition draws on ``key`` (its
    ``scenario_key``) as the port's :class:`PartitionDraws`: the
    log-gamma proportions, the sample permutation, the Gumbel draws,
    the shard or the IID permutation, each on the key the reference
    draws it from."""
    s, n = num_samples, num_clients
    if kind in ("dirichlet", "multi_alpha"):
        k_perm, k_gamma, k_cat = jax.random.split(key, 3)
        alpha = jnp.asarray(np.asarray(alphas, np.float32))[
            jnp.asarray(_equal_split_groups(n, len(alphas)))]
        logp = jax.random.loggamma(
            k_gamma, jnp.broadcast_to(alpha[None, :], (num_classes, n)))
        perm = (_t(jax.random.permutation(k_perm, s)).long()
                if len(alphas) > 1 else None)
        return PartitionDraws(
            logp=_t(logp), perm=perm,
            gumbel=_t(jax.random.gumbel(k_cat, (s, n), jnp.float32)))
    if kind == "shards":
        return PartitionDraws(shard_perm=_t(jax.random.permutation(
            key, n * labels_per_client)).long())
    if kind == "quantity":
        k_gamma, k_cat = jax.random.split(key)
        logq = jax.random.loggamma(k_gamma,
                                   jnp.full((n,), float(beta), jnp.float32))
        return PartitionDraws(
            logp=_t(logq),
            gumbel=_t(jax.random.gumbel(k_cat, (s, n), jnp.float32)))
    if kind == "iid":
        return PartitionDraws(
            iid_perm=_t(jax.random.permutation(key, s)).long())
    raise ValueError(kind)


def availability_draws(kr, n: int):
    """A round's availability draws on its round key ``kr``, as the
    reference's sweep takes them: the dropout's uniform on
    ``fold_in(kr, 1)`` (``bernoulli`` compares it with 1 − p) and the
    replacement's Gumbel on ``fold_in(kr, 2)``."""
    u = jax.random.uniform(jax.random.fold_in(kr, 1), (n,), jnp.float32)
    g = jax.random.gumbel(jax.random.fold_in(kr, 2), (n,), jnp.float32)
    return _t(u), _t(g)


class JaxKeyChain:
    """Replays the reference server's per-round key chain as the
    port's :class:`RoundDraws`; call it with the round index.
    ``grad_all`` follows DivFL's ideal setting, whose all-clients poll
    splits one more key off the chain after each round's
    (``fed/server.py:298-301``): one (N, 1, S_max) permutation set.
    ``availability`` adds the sweep's availability draws
    (:func:`availability_draws`)."""

    def __init__(self, seed: int, n: int, k: int, m: int, epochs: int,
                 s_max: int, grad_all: bool = False,
                 availability: bool = False):
        self.rng = jax.random.PRNGKey(seed)
        self.rng, self.init_key = jax.random.split(self.rng)
        self.n, self.k, self.m = n, k, m
        self.epochs, self.s_max = epochs, s_max
        self.grad_all = grad_all
        self.availability = availability

    def __call__(self, t: int) -> RoundDraws:
        self.rng, kr = jax.random.split(self.rng)
        k_sel, k_loc = jax.random.split(kr)
        grad_perms = None
        if self.grad_all:
            self.rng, kg = jax.random.split(self.rng)
            grad_perms = epoch_perms(kg, self.n, 1, self.s_max)
        rd = RoundDraws(select_noise(k_sel, self.n, self.k, self.m),
                        epoch_perms(k_loc, self.k, self.epochs,
                                    self.s_max), grad_perms)
        if self.availability:
            avail, repl = availability_draws(kr, self.n)
            rd = rd._replace(avail=avail, repl=repl)
        return rd


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


def port_pair_on_reference(jspec, spec, scenario: str, selector: str,
                           params0: list, acfg=None):
    """The port's grid cell (``scenarios.sweep.PairRun``) on the
    reference's data: each seed's partition from the reference's draws
    on its ``scenario_key``, its initial params ``params0[i]`` (the
    reference's, as numpy) and its round draws from the reference's
    key chain (with the availability draws of a time-varying scenario
    and, given the async config ``acfg``, the tick's jitter row)."""
    from repro.scenarios import scenario_key
    from repro_torch.models import params_from_jax
    from repro_torch.scenarios.sweep import (PairRun, _cell_data,
                                             make_async_seed_runner,
                                             make_seed_runner)
    scn = spec.scenario(scenario)
    train, test, model, ncls = _cell_data(spec, scn, "cpu")
    cap, n, k = spec.capacity(), spec.num_clients, spec.num_select
    servers, parts = [], []
    for i, seed in enumerate(spec.seeds):
        draws = partition_draws(
            scenario_key(jspec.scenario(scenario), seed), scn.kind,
            spec.samples_train, ncls, n, scn.alphas,
            scn.labels_per_client, scn.beta)
        part = scn.partition(draws, train["y"], ncls, n, cap)
        if acfg is None:
            srv = make_seed_runner(spec, scn, selector, model, train, test,
                                   part, seed, "cpu")
        else:
            srv = make_async_seed_runner(spec, scn, acfg, model, train,
                                         test, part, seed, "cpu")
        srv.params = params_from_jax(params0[i], "cpu")
        servers.append(srv)
        parts.append(part)
    pair = PairRun(scn, selector, servers, parts, 0.0)
    pair.draws = []
    for srv, seed in zip(servers, spec.seeds):
        chain = JaxKeyChain(seed, n, k, k, spec.local.epochs, cap,
                            availability=scn.time_varying)
        jitter = getattr(srv, "_jitter", None)
        pair.draws.append([
            chain(t) if jitter is None else chain(t)._replace(
                jitter=jitter[t]) for t in range(spec.rounds)])
    return pair
