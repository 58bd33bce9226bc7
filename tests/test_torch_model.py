"""The port's classifiers, their loss and fedavg local update against
the JAX reference, from params carried across with ``params_from_jax``.

Logits, losses and local params are held to 1e-5: the same f32
arithmetic in another order (conv, matmul and the backward pass reduce
differently).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.fed.client import LocalSpec as JaxLocalSpec
from repro.fed.client import make_local_update as jax_local_update
from repro.models.classifier import make_classifier as jax_classifier
from repro_torch.backend import set_precision
from repro_torch.configs import get_config
from repro_torch.fed.client import LocalSpec, make_eval_fn, make_local_update
from repro_torch.models import make_classifier, params_from_jax
from torch_parity import each, epoch_perms, to_np

ARCHS = ["paper-cnn", "paper-mlp"]


def _models(arch):
    jinit, japply, _ = jax_classifier(jax_config(arch), input_dim=196)
    _, tapply, _ = make_classifier(get_config(arch), input_dim=196)
    jparams = jinit(jax.random.PRNGKey(3))
    return japply, jparams, tapply, params_from_jax(to_np(jparams), "cpu")


def _data(k, s, seed=0, c=10):
    r = np.random.default_rng(seed)
    x = r.normal(size=(k, s, 196)).astype(np.float32)
    y = r.integers(0, c, size=(k, s)).astype(np.int32)
    return x, y


def test_logits_match_jax():
    set_precision()
    each(_logits_case, ARCHS)


def _logits_case(arch):
    japply, jparams, tapply, tparams = _models(arch)
    x, _ = _data(1, 64)
    got = tapply(tparams, torch.tensor(x[0]))
    want = japply(jparams, jnp.asarray(x[0]))
    assert got.shape == (64, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_port_init_matches_reference_layout_and_scale():
    init, apply, _ = make_classifier(get_config("paper-cnn"))
    params = init(torch.Generator().manual_seed(0), "cpu")
    jparams = params_from_jax(to_np(jax_classifier(
        jax_config("paper-cnn"))[0](jax.random.PRNGKey(0))), "cpu")
    for name, p in jparams.items():
        for leaf, v in p.items():
            assert params[name][leaf].shape == v.shape
    # dense fan-in init: std 1/sqrt(1024) truncated at 2 std
    w = params["fc"]["w"]
    assert float(w.abs().max()) <= 2.0 / 32.0 + 1e-6
    assert abs(float(w.std()) * 32.0 - 0.88) < 0.05
    assert apply(params, torch.zeros(2, 196)).shape == (2, 10)


def test_loss_fn_matches_jax():
    """``make_classifier``'s third value, the CE and the accuracy of a
    batch, as the reference's ``loss_fn`` on the same params."""
    set_precision()
    each(_loss_case, ARCHS)


def _loss_case(arch):
    jinit, _, jloss = jax_classifier(jax_config(arch), input_dim=196)
    _, _, tloss = make_classifier(get_config(arch), input_dim=196)
    jparams = jinit(jax.random.PRNGKey(4))
    x, y = _data(1, 64, seed=5)
    want, wmet = jloss(jparams, {"x": jnp.asarray(x[0]),
                                 "y": jnp.asarray(y[0])})
    got, met = tloss(params_from_jax(to_np(jparams), "cpu"),
                     {"x": torch.tensor(x[0]), "y": torch.tensor(y[0])})
    np.testing.assert_allclose(float(got), float(want), atol=1e-5)
    np.testing.assert_allclose(float(met["ce_loss"]),
                               float(wmet["ce_loss"]), atol=1e-5)
    assert float(met["accuracy"]) == float(wmet["accuracy"])


def test_mlp_input_dim_defaults_to_the_reference_s():
    """Without ``input_dim`` both packages size paper-mlp's first layer
    for 64 inputs."""
    jparams = jax_classifier(jax_config("paper-mlp"))[0](
        jax.random.PRNGKey(0))
    init, apply, _ = make_classifier(get_config("paper-mlp"))
    params = init(torch.Generator().manual_seed(0), "cpu")
    assert params["fc1"]["w"].shape == jparams["fc1"]["w"].shape
    assert params["fc1"]["w"].shape[0] == 64
    assert apply(params, torch.zeros(2, 64)).shape == (2, 10)


def test_local_update_matches_jax():
    """One fedavg local update of a 2-client cohort with the reference's
    epoch permutations, with lr decay 0.5 and a padded tail."""
    set_precision()
    each(_local_update_case, ARCHS)


def _local_update_case(arch):
    japply, jparams, tapply, tparams = _models(arch)
    k, s = 2, 80
    x, y = _data(k, s, seed=1)
    mask = np.ones((k, s), np.float32)
    mask[1, 50:] = 0.0
    jspec = JaxLocalSpec(lr=0.05, epochs=2, batch_size=32)
    lu = jax.vmap(jax_local_update(japply, jspec),
                  in_axes=(None, None, 0, 0, 0, 0, None))
    k_loc = jax.random.PRNGKey(9)
    rngs = jax.random.split(k_loc, k)
    jnew, _, jmet = lu(jparams, {}, jnp.asarray(x), jnp.asarray(y),
                       jnp.asarray(mask), rngs, jnp.float32(0.5))
    tlu = make_local_update(tapply, LocalSpec(lr=0.05, epochs=2,
                                              batch_size=32))
    tnew, _, tmet = tlu(tparams, {}, torch.tensor(x), torch.tensor(y),
                        torch.tensor(mask), epoch_perms(k_loc, k, 2, s),
                        torch.tensor(0.5))
    for name, p in to_np(tnew).items():
        for leaf, v in p.items():
            want = np.asarray(jnew[name][leaf])
            if name.startswith("conv") and leaf == "w":
                want = want.transpose(0, 4, 3, 1, 2)    # K,HWIO -> K,OIHW
            np.testing.assert_allclose(v, want, atol=1e-5)
    np.testing.assert_allclose(tmet["train_loss"].numpy(),
                               np.asarray(jmet["train_loss"]), rtol=1e-5)


def test_fully_masked_client_is_a_no_op():
    _, _, tapply, tparams = _models("paper-cnn")
    x, y = _data(2, 64, seed=2)
    mask = np.ones((2, 64), np.float32)
    mask[0] = 0.0
    perms = torch.stack([torch.stack([torch.randperm(64)
                                      for _ in range(2)])
                         for _ in range(2)])
    tlu = make_local_update(tapply, LocalSpec(lr=0.05, epochs=2,
                                              batch_size=32))
    new, _, met = tlu(tparams, {}, torch.tensor(x), torch.tensor(y),
                      torch.tensor(mask), perms, torch.tensor(1.0))
    for name, p in tparams.items():
        for leaf, v in p.items():
            assert torch.equal(new[name][leaf][0], v)
            assert not torch.equal(new[name][leaf][1], v)
    assert float(met["train_loss"][0]) == 0.0


def test_eval_fn_counts_only_masked_rows():
    _, _, tapply, tparams = _models("paper-mlp")
    x, y = _data(1, 10, seed=3)
    mask = np.zeros(10, np.float32)
    mask[:4] = 1.0
    loss, acc = make_eval_fn(tapply)(tparams, torch.tensor(x[0]),
                                     torch.tensor(y[0]),
                                     torch.tensor(mask))
    logits = tapply(tparams, torch.tensor(x[0][:4]))
    want = (logits.argmax(-1) == torch.tensor(y[0][:4]).long()).float()
    assert float(acc) == pytest.approx(float(want.mean()))
    assert np.isfinite(float(loss))
