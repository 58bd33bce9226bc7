"""The slice end to end: one HiCS-FL run of paper-cnn through
``repro_torch.fed.build(spec, device="cpu")`` against the reference's
``repro.fed.build(spec)``, at 12 clients, K=3, 6 rounds.

The port gets the reference's initial params (``params_from_jax``) and
its key chain replayed into the port's noise and permutation inputs.
Then the participants must be identical in every round, train loss and
Ĥ within 1e-4 relative, and test accuracy within 1/100.  Also
``examples/quickstart.py``'s own spec (paper-mlp, 50 clients, K=5,
``LocalSpec(algo="fedavg", optimizer="sgd", ...)``), cut to 2 rounds,
builds and runs a port run with JAX's participants, and so does the
same spec with ``optimizer="adam"`` (train loss within 1e-3 relative:
see that test).
"""
import numpy as np
import pytest

import jax  # noqa: F401  (JAX_PLATFORMS=cpu keeps it on the CPU)

from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro_torch.data import SyntheticSpec
from repro_torch.fed import ExperimentSpec, LocalSpec, build
from repro_torch.models import params_from_jax
from torch_parity import JaxKeyChain, to_np

SELECTOR_KW = dict(temperature=0.63, gamma0=4.0, normalize=True,
                   incremental=True)
COMMON = dict(arch="paper-cnn", num_clients=12, num_select=3, rounds=6,
              alphas=(0.001, 0.002, 0.005, 0.01, 0.5), selector="hics",
              selector_kw=SELECTOR_KW, samples_train=600,
              samples_test=100, eval_every=2, seed=0)


@pytest.fixture(scope="module")
def runs():
    jspec = JaxExperimentSpec(
        data=JaxSyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=JaxLocalSpec(algo="fedavg", optimizer="sgd", lr=0.05,
                           epochs=2, batch_size=32), **COMMON)
    tspec = ExperimentSpec(
        data=SyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=LocalSpec(lr=0.05, epochs=2, batch_size=32), **COMMON)
    jserver, jinfo = jax_build(jspec)
    tserver, tinfo = build(tspec, device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    arrays = {
        "x": (np.asarray(jserver.x), tserver.x.numpy()),
        "y": (np.asarray(jserver.y), tserver.y.numpy()),
        "mask": (np.asarray(jserver.mask), tserver.mask.numpy()),
        "test_x": (np.asarray(jserver.test["x"]),
                   tserver.test["x"].numpy()),
        "label_dists": (jinfo["label_dists"], tinfo["label_dists"]),
    }
    chain = JaxKeyChain(0, 12, 3, 3, 2, tserver.x.shape[1])
    jhist = jserver.run()
    thist = tserver.run(draws=chain)
    return jhist, thist, arrays


def test_data_arrays_exactly_equal(runs):
    _, _, arrays = runs
    for name, (want, got) in arrays.items():
        assert np.array_equal(want, got), name


def test_selected_identical_every_round(runs):
    jhist, thist, _ = runs
    assert thist["selected"] == jhist["selected"]
    assert len(thist["selected"]) == 6


def test_losses_entropies_and_accuracy_agree(runs):
    jhist, thist, _ = runs
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(np.asarray(thist["bias_entropy"]),
                               np.asarray(jhist["bias_entropy"]),
                               rtol=1e-4)
    assert thist["test_round"] == jhist["test_round"]
    np.testing.assert_allclose(thist["test_acc"], jhist["test_acc"],
                               atol=1e-2)


def _quickstart_runs(optimizer):
    """The reference's quickstart spec, word for word but for the rounds
    and the optimizer, through both builders: the port run gets the
    reference's params and key chain.  Returns both histories."""
    def spec(experiment, synthetic, local):
        return experiment(
            arch="paper-mlp", num_clients=50, num_select=5, rounds=2,
            alphas=(0.001, 0.002, 0.005, 0.01, 0.5), selector="hics",
            selector_kw={"temperature": 0.63, "gamma0": 4.0,
                         "normalize": True},
            data=synthetic(noise=0.5, proto_scale=1.2),
            local=local(algo="fedavg", optimizer=optimizer, lr=0.05,
                        epochs=2, batch_size=32),
            samples_train=10_000, samples_test=2_000, eval_every=5, seed=0)

    jserver, _ = jax_build(spec(JaxExperimentSpec, JaxSyntheticSpec,
                                JaxLocalSpec))
    tserver, _ = build(spec(ExperimentSpec, SyntheticSpec, LocalSpec),
                       device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    jhist = jserver.run()
    thist = tserver.run(draws=JaxKeyChain(0, 50, 5, 5, 2,
                                          tserver.x.shape[1]))
    return jhist, thist


def test_quickstart_spec_picks_jax_participants():
    """The reference's quickstart spec, word for word but for the
    rounds, builds a port run on the CPU; with the reference's params
    and key chain it picks JAX's participants in both rounds."""
    jhist, thist = _quickstart_runs("sgd")
    assert thist["selected"] == jhist["selected"]
    assert len(thist["selected"]) == 2
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=1e-4)


#: adam's train-loss tolerance on the quickstart spec.  Adam's step
#: lr·m̂/(√v̂ + 1e-8) turns a rounding-level gradient (true value ~0)
#: into a step of up to lr, so a last-bit difference grows over the
#: epoch's steps at lr 0.05: the reference itself moves its train loss
#: by 2.0e-4 and 1.2e-4 relative in the two rounds when its initial
#: params are perturbed by 1e-7 relative (sgd: 1e-7), and the port is
#: 2.4e-4 from it (both measured on the CPU).
ADAM_LOSS_RTOL = 1e-3


def test_quickstart_spec_with_adam_picks_jax_participants():
    """The same spec with ``LocalSpec(optimizer="adam")`` (the paper's
    optimizer for CIFAR10, Mini-ImageNet and THUC): JAX's participants
    in both rounds and its train loss within ``ADAM_LOSS_RTOL``."""
    jhist, thist = _quickstart_runs("adam")
    assert thist["selected"] == jhist["selected"]
    assert len(thist["selected"]) == 2
    np.testing.assert_allclose(thist["train_loss"], jhist["train_loss"],
                               rtol=ADAM_LOSS_RTOL)
