"""The paper's other local updates against the JAX reference: fedprox
(Eq. 67), feddyn (Eq. 74) and moon (Eq. 91), each with sgd,
sgd-momentum and adam, and fedavg with all three optimizers.

(a) One cohort local update for each of the 12 algorithm × optimizer
    pairs, on a narrow paper-cnn (8 conv channels, 16 hidden), three
    clients: one full, one with 4 live rows of 40, one with none (every
    batch padding-only, so the whole gradient, the algorithm's terms
    included, is multiplied by 0 while momentum's m decays and adam's
    moments advance).  The port runs from ``params_from_jax`` params
    and extras: a nonzero FedDyn ``h`` and a Moon ``prev`` away from the
    global params, carried through the same HWIO -> OIHW conversion;
    the reference runs its vmapped ``make_local_update`` with the
    replayed epoch permutations.  Train loss within 1e-4 relative;
    every leaf of the new params and new extras within 1e-4 of the
    leaf's largest magnitude (f32 sums in other orders: the conv, the
    matmuls, the backward and the trees' sums over a conv leaf differ).
(b) 6-round ``build`` runs of fedprox, feddyn and moon (paper-mlp, 6
    clients, K = 3: 2 sweep rounds, 4 clustered) with the reference's
    params and key chain: JAX's participants every round through the
    host loop and through ``jit_rounds=True``, and the scanned driver's
    participants, train loss and extras bit-equal to the host loop's.

Each test loops over its cases (``torch_parity.each``).
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro.fed.client import make_local_update as jax_local_update
from repro.models.classifier import (
    make_classifier_with_features as jax_classifier)
from repro_torch.backend import set_precision
from repro_torch.configs import get_config
from repro_torch.data import SyntheticSpec
from repro_torch.fed import ExperimentSpec, LocalSpec, build, init_extra
from repro_torch.fed.client import make_local_update
from repro_torch.models import make_classifier_with_features, params_from_jax
from repro_torch.optim import tree_leaves, tree_map
from torch_parity import JaxKeyChain, each, epoch_perms, to_np

ALGOS = ["fedavg", "fedprox", "feddyn", "moon"]
OPTIMIZERS = ["sgd", "momentum", "adam"]
K, S, EPOCHS, BATCH = 3, 40, 2, 16
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, so as not to spin against the
    other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow(cfg):
    return dataclasses.replace(cfg, d_model=8, d_ff=16)


def _hwio_to_oihw(tree):
    """A K- or N-stacked reference tree of numpy arrays -> the port's
    layout (conv weights HWIO -> OIHW behind the stacked axis)."""
    if isinstance(tree, dict):
        return {k: _hwio_to_oihw(v) for k, v in tree.items()}
    if tree.ndim == 5:
        tree = tree.transpose(0, 4, 3, 1, 2)
    return torch.tensor(np.ascontiguousarray(tree))


def _close(got, want, what):
    """Each leaf within RTOL of the leaf's largest magnitude."""
    want = _hwio_to_oihw(to_np(want))
    for g, w in zip(tree_leaves(got), tree_leaves(want), strict=True):
        scale = float(w.abs().max())
        err = float((g.detach() - w).abs().max())
        assert err <= RTOL * max(scale, 1e-30), (what, err, scale)


def test_cohort_update_matches_jax_every_pair():
    set_precision()
    init, japply, jfeat = jax_classifier(_narrow(jax_config("paper-cnn")),
                                         input_dim=196)
    _, tapply, tfeat = make_classifier_with_features(
        _narrow(get_config("paper-cnn")), input_dim=196)
    jparams = init(jax.random.PRNGKey(3))
    r = np.random.default_rng(0)
    x = r.normal(size=(K, S, 196)).astype(np.float32)
    y = r.integers(0, 10, size=(K, S)).astype(np.int32)
    mask = np.ones((K, S), np.float32)
    mask[1, 4:] = 0.0
    mask[2] = 0.0
    stacked = jax.tree_util.tree_map(
        lambda a: np.broadcast_to(np.asarray(a), (K,) + a.shape), jparams)
    extras = {
        "feddyn": {"h": jax.tree_util.tree_map(
            lambda a: (r.normal(size=a.shape) * 0.05).astype(np.float32),
            stacked)},
        "moon": {"prev": jax.tree_util.tree_map(
            lambda a: (a + r.normal(size=a.shape) * 0.05).astype(np.float32),
            stacked)}}
    k_loc = jax.random.PRNGKey(9)
    perms = epoch_perms(k_loc, K, EPOCHS, S)
    tparams = params_from_jax(to_np(jparams), "cpu")

    def case(algo, optimizer):
        kw = dict(algo=algo, optimizer=optimizer, lr=0.05, epochs=EPOCHS,
                  batch_size=BATCH, mu=0.1, moon_tau=0.5)
        jex = extras.get(algo, {})
        lu = jax.vmap(jax_local_update(japply, JaxLocalSpec(**kw), jfeat),
                      in_axes=(None, 0, 0, 0, 0, 0, None))
        jnew, jnex, jmet = lu(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                              jex),
                              jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(mask), jax.random.split(k_loc, K),
                              jnp.float32(0.5))
        tlu = make_local_update(tapply, LocalSpec(**kw), tfeat)
        tnew, tnex, tmet = tlu(tparams, _hwio_to_oihw(jex), torch.tensor(x),
                               torch.tensor(y), torch.tensor(mask), perms,
                               torch.tensor(0.5))
        np.testing.assert_allclose(tmet["train_loss"].numpy(),
                                   np.asarray(jmet["train_loss"]),
                                   rtol=RTOL)
        _close(tnew, jnew, "params")
        assert sorted(tnex) == sorted(jnex)
        for key in tnex:
            _close(tnex[key], jnex[key], key)
        # the padding-only client: sgd and the algorithms' terms leave
        # it where it started; momentum and adam move it by nothing
        # either, their steps being zero from zero grads
        for got, want in zip(tree_leaves(tnew), tree_leaves(tparams)):
            assert torch.equal(got[2], want)

    each(case, ALGOS, OPTIMIZERS)


def test_moon_requires_features():
    _, tapply, _ = make_classifier_with_features(get_config("paper-mlp"))
    with pytest.raises(ValueError, match="features_fn"):
        make_local_update(tapply, LocalSpec(algo="moon"))


def test_init_extra_keys_and_shapes():
    init, _, _ = make_classifier_with_features(get_config("paper-mlp"))
    params = init(torch.Generator().manual_seed(0), "cpu")
    assert init_extra(LocalSpec(), params) == {}
    assert init_extra(LocalSpec(algo="fedprox"), params) == {}
    h = init_extra(LocalSpec(algo="feddyn"), params)["h"]
    assert all(float(a.abs().max()) == 0.0 for a in tree_leaves(h))
    prev = init_extra(LocalSpec(algo="moon"), params)["prev"]
    assert all(a is b for a, b in zip(tree_leaves(prev),
                                      tree_leaves(params)))


#: the build runs' spec: 6 clients, K = 3, so rounds 2-5 cluster
RUN = dict(arch="paper-mlp", num_clients=6, num_select=3, rounds=6,
           alphas=(0.05, 5.0), selector="hics",
           selector_kw=dict(temperature=0.63, gamma0=4.0, normalize=True),
           samples_train=300, samples_test=60, eval_every=3, seed=0)


def _local(make, algo):
    return make(algo=algo, optimizer="sgd", lr=0.1, epochs=2, batch_size=32,
                mu=0.1, moon_tau=0.5)


def _port_run(algo, jserver, jit_rounds):
    tserver, _ = build(ExperimentSpec(
        data=SyntheticSpec(), local=_local(LocalSpec, algo),
        jit_rounds=jit_rounds, **RUN), device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    tserver.extras = tree_map(lambda a: a.expand(6, *a.shape).clone(),
                              init_extra(tserver.cfg.local, tserver.params))
    hist = tserver.run(draws=JaxKeyChain(0, 6, 3, 3, 2, tserver.x.shape[1]))
    return hist, tserver


def test_build_runs_pick_jax_participants():
    def case(algo):
        jserver, _ = jax_build(JaxExperimentSpec(
            data=JaxSyntheticSpec(), local=_local(JaxLocalSpec, algo),
            **RUN))
        host, hserver = _port_run(algo, jserver, False)
        scan, sserver = _port_run(algo, jserver, True)
        jhist = jserver.run()
        assert host["selected"] == jhist["selected"]
        assert scan["selected"] == jhist["selected"]
        assert len(host["selected"]) == 6
        np.testing.assert_allclose(host["train_loss"], jhist["train_loss"],
                                   rtol=RTOL)
        assert scan["train_loss"] == host["train_loss"]
        assert sorted(sserver.extras) == sorted(hserver.extras)
        for a, b in zip(tree_leaves(sserver.extras),
                        tree_leaves(hserver.extras)):
            assert torch.equal(a, b)
        _close(hserver.extras, jserver._extras, "extras")

    each(case, ["fedprox", "feddyn", "moon"])


#: the host reads a round step must not make
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__")


def test_round_step_with_extras_reads_nothing_on_the_host():
    """4 rounds of the scanned driver's round step for FedDyn and Moon
    (per-client extras gathered and written back in the carry) with the
    host reads patched to raise; the carry's extras change only in the
    cohort's rows."""
    def case(algo):
        server, _ = build(ExperimentSpec(
            data=SyntheticSpec(), local=_local(LocalSpec, algo),
            jit_rounds=True, **dict(RUN, rounds=4)), device="cpu")
        step = server._make_round_step()
        carry = server._initial_carry()
        draws = [server._draw_host(t) for t in range(4)]
        saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

        def host_read(*args, **kwargs):
            raise AssertionError("a host read inside the round step")

        before, ids = [], []
        try:
            for name in saved:
                setattr(torch.Tensor, name, host_read)
            for rd in draws:
                before.append(carry[1])
                carry, out = step(carry, rd)
                ids.append(out[0])
        finally:
            for name, fn in saved.items():
                setattr(torch.Tensor, name, fn)
        assert int(carry[3]) == 4
        for (key, tree), old in zip(carry[1].items(), before[-1].values()):
            for new, prev in zip(tree_leaves(tree), tree_leaves(old)):
                moved = (new != prev).flatten(1).any(dim=1)
                assert set(torch.nonzero(moved).flatten().tolist()) <= set(
                    ids[-1].tolist()), key

    each(case, ["feddyn", "moon"])


def test_finetune_example_tiny_runs():
    """``python -m repro_torch.examples.federated_finetune --tiny`` on
    the CPU, cut to 3 rounds: qwen3-8b's reduced config, finite losses
    near ln 512 in round 0, distinct participants, the coverage sweep
    and Ĥ from the head's ΔW surrogate for every observed client."""
    from repro_torch.examples import federated_finetune
    res = federated_finetune.main(["--tiny", "--rounds", "3",
                                   "--device", "cpu"])
    hist = res["history"]
    assert res["cfg"].name == "qwen3-8b-reduced"
    assert np.isfinite(hist["loss"]).all()
    assert abs(hist["loss"][0] - np.log(512)) < 0.5
    assert all(len(set(ids)) == 2 for ids in hist["selected"])
    assert len(set(sum(hist["selected"], []))) == 6
    ent = res["selector"].estimated_entropies()
    assert ent.shape == (8,) and np.isfinite(ent).all()
    assert hist["spread"][-1] > 0.0
