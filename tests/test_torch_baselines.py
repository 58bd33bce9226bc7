"""The paper's five baseline selectors in the port against the JAX
reference: the samplers, the flattened-update layout and projection,
each selector's ``select`` and ``update`` on the same inputs, and
whole paper-cnn runs through ``repro_torch.fed.build(spec,
device="cpu")`` against ``repro.fed.build(spec)``.

Randomness comes over from JAX (``torch_parity.select_noise`` and
``JaxKeyChain``), initial params through ``params_from_jax``.  The JAX
side runs as its own tests run it on the CPU: the selectors' cached
steps through the lax oracle.  Each test loops over its cases
(``torch_parity.each``).

Tolerances: participants identical; stored features 1e-6 and cached
distances 1e-5 absolute plus relative (the reference's
``tests/test_full_update_selectors.py``); losses and flattened
updates of a local epoch 1e-5 (``tests/test_torch_model.py``); train
loss of a whole run 1e-4 relative (``tests/test_torch_slice.py``).

DivFL's ideal setting (``refresh="all"``) is held to what the
reference keeps of itself: identical selects on identical
observations, and identical participants over the first
``DIVFL_IDEAL_HORIZON`` = 12 rounds of a whole run.  Its from-scratch
distance √(|a|² + |b|² − 2⟨a, b⟩) keeps its diagonal, where the
difference cancels: the last bits of |a|² and ⟨a, a⟩, which each
framework sums in its own order, become distances of ~5e-4 at
|a|² ~ 0.75, about five of the 1e-5 quanta the greedy gains are
rounded to.  With general f32 observations the selects then differ
(measured: round 4 of the selector test below), so the identical-
observation check feeds observations on a dyadic grid whose sums are
exact in any order.  Over a whole run, measured on the CPU at the
spec below: rounds 0-11 agree; in round 12 the two frameworks'
all-clients updates differ by about 1% (eleven rounds of f32 drift
through training), and two quantized gains tie in the reference (both
round to 100,000 quanta) where the port's second rounds to 99,980, so
the third pick differs.
"""
import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.core import Observations as JaxObservations
from repro.core import make_functional as jax_make_functional
from repro.core import sampling as jsamp
from repro.core.selectors.baselines import _make_projector as jax_projector
from repro.data import SyntheticSpec as JaxSyntheticSpec
from repro.fed import ExperimentSpec as JaxExperimentSpec
from repro.fed import LocalSpec as JaxLocalSpec
from repro.fed import build as jax_build
from repro.fed.client import LocalSpec as JaxClientSpec
from repro.fed.client import make_eval_fn as jax_eval_fn
from repro.fed.server import _flatten_params as jax_flatten
from repro.fed.server import full_sel_updates as jax_full_sel
from repro.fed.server import make_grad_all as jax_grad_all
from repro.models.classifier import make_classifier as jax_classifier
from repro_torch.configs import get_config
from repro_torch.core import (Observations, gumbel_topk, make_functional,
                              weighted_sample_device)
from repro_torch.core.selectors.baselines import _make_projector, rademacher
from repro_torch.data import SyntheticSpec
from repro_torch.fed import (ExperimentSpec, LocalSpec, build,
                             flatten_params, full_sel_updates, make_grad_all,
                             make_loss_poll)
from repro_torch.models import make_classifier, params_from_jax
from repro_torch.optim import tree_map
from torch_parity import JaxKeyChain, each, epoch_perms, select_noise, to_np

DIVFL_IDEAL_HORIZON = 12


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def test_weighted_sampler_ids_identical():
    """The weighted sampler draws on the select key with the coverage
    sweep's shape, so its noise is ``SelectNoise.cover``; zero weights
    hit the log floor, equal weights tie in log w."""
    each(_weighted_case, range(6), [(50, 5), (12, 3), (4, 6), (20, 20)])


def _weighted_case(seed, shape):
    n, k = shape
    r = np.random.default_rng(seed)
    w = r.uniform(0.0, 1.0, n).astype(np.float32)
    w[r.integers(n)] = 0.0
    w[: n // 3] = w[0]
    key = jax.random.PRNGKey(seed)
    noise = select_noise(key, n, k, 1)
    assert np.array_equal(noise.cover.numpy(),
                          np.asarray(jax.random.gumbel(key, (n,))))
    got = weighted_sample_device(noise.cover, torch.tensor(w), k)
    want = jsamp.weighted_sample_device(key, jnp.asarray(w), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gumbel_topk_ties_on_the_f32_grid():
    """Logits of 1e6 and 2e6 put logits + noise on 0.0625 and 0.125
    grids, where ties are common: ties go to the lower index, as
    ``lax.top_k``."""
    ties = []
    each(lambda seed, shape: ties.append(_topk_case(seed, shape)),
         range(8), [(50, 5), (12, 12), (30, 7)])
    assert sum(ties) > 0


def _topk_case(seed, shape):
    n, k = shape
    r = np.random.default_rng(seed)
    logits = np.where(r.random(n) < 0.5, 1e6, 2e6).astype(np.float32)
    key = jax.random.PRNGKey(50 + seed)
    noise = np.asarray(jax.random.gumbel(key, (n,), jnp.float32))
    got = gumbel_topk(torch.tensor(noise), torch.tensor(logits), k)
    want = jsamp.gumbel_topk(key, jnp.asarray(logits), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return n - len(np.unique(logits + noise))


# ---------------------------------------------------------------------------
# flattened updates: layout, projection, full_sel, full_all, loss poll
# ---------------------------------------------------------------------------


def _models(arch, seed=0):
    jinit, japply, _ = jax_classifier(jax_config(arch), input_dim=196)
    _, tapply, _ = make_classifier(get_config(arch), input_dim=196)
    jp = jinit(jax.random.PRNGKey(seed))
    return jp, params_from_jax(to_np(jp), "cpu"), japply, tapply


def test_flatten_params_in_the_reference_layout():
    """paper-cnn's OIHW conv weights ravel as the reference's HWIO, the
    leaves in sorted-key order: equal vectors, single and stacked, and
    equal ``full_sel`` updates."""
    each(_flatten_case, ["paper-cnn", "paper-mlp"])


def _flatten_case(arch):
    jp, tp, _, _ = _models(arch)
    flat = flatten_params(tp)
    assert np.array_equal(flat.numpy(), np.asarray(jax_flatten(jp)))
    if arch == "paper-cnn":
        assert flat.numel() == 158_570
    scales = (1.5, -0.25, 3.0)
    jstack = jax.tree_util.tree_map(
        lambda a: jnp.stack([a * s for s in scales]), jp)
    tstack = tree_map(lambda a: torch.stack([a * s for s in scales]), tp)
    got = flatten_params(tstack, lead=1)
    assert got.shape == (3, flat.numel())
    assert np.array_equal(got[1].numpy(),
                          np.asarray(jax_flatten(jp)) * np.float32(-0.25))
    assert np.array_equal(full_sel_updates(tp, tstack).numpy(),
                          np.asarray(jax_full_sel(jp, jstack)))


def test_projector_matches_reference_with_its_signs():
    """``proj_dim`` buckets with JAX's Rademacher signs equal the
    reference's projection; the port's default signs are ±1 and fixed by
    ``proj_seed``; a width at or under ``proj_dim`` is the identity."""
    each(_projector_case, [(300, 64), (158_570, 4096), (50, 64)])


def _projector_case(shape):
    p, f = shape
    u = (np.random.default_rng(p).normal(size=(3, p)) * 0.05
         ).astype(np.float32)
    jproject, jwidth = jax_projector(f, 0)
    signs = np.asarray(jax.random.rademacher(jax.random.PRNGKey(0), (p,),
                                             jnp.float32))
    project, width = _make_projector(f, 0, torch.tensor(signs))
    assert width(p) == jwidth(p) == min(p, f)
    got = project(torch.tensor(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(jproject(
        jnp.asarray(u))), atol=1e-6, rtol=1e-6)
    own, _ = _make_projector(f, 7)
    assert own(torch.tensor(u)).shape == (3, min(p, f))
    s = rademacher(7, p)
    assert torch.equal(s, rademacher(7, p))
    assert set(s.unique().tolist()) <= {-1.0, 1.0}


def _client_data(n, s, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(n, s, 196)).astype(np.float32)
    y = r.integers(0, 10, (n, s)).astype(np.int32)
    mask = (np.arange(s)[None, :] < r.integers(s // 2, s + 1, n)[:, None]
            ).astype(np.float32)
    return x, y, mask


def test_grad_all_matches_reference():
    """DivFL's all-clients poll: a one-epoch update of every client at
    the base lr, flattened θ_k − θ, from the same params, data and
    permutations."""
    each(_grad_all_case, ["paper-cnn", "paper-mlp"])


def _grad_all_case(arch):
    n, s = 4, 70
    jp, tp, japply, tapply = _models(arch, seed=2)
    x, y, mask = _client_data(n, s, seed=3)
    kg = jax.random.PRNGKey(11)
    spec = dict(lr=0.05, epochs=2, batch_size=32)
    want = jax_grad_all(japply, JaxClientSpec(**spec))(
        jp, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        jax.random.split(kg, n))
    got = make_grad_all(tapply, LocalSpec(**spec))(
        tp, torch.tensor(x), torch.tensor(y), torch.tensor(mask),
        epoch_perms(kg, n, 1, s))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_loss_poll_matches_reference():
    each(_loss_poll_case, ["paper-cnn", "paper-mlp"])


def _loss_poll_case(arch):
    jp, tp, japply, tapply = _models(arch, seed=4)
    x, y, mask = _client_data(5, 40, seed=5)
    jeval = jax_eval_fn(japply)
    want = [float(jeval(jp, x[i], y[i], mask[i])[0]) for i in range(5)]
    got = make_loss_poll(tapply)(tp, torch.tensor(x), torch.tensor(y),
                                 torch.tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# each selector's select and update on the same inputs
# ---------------------------------------------------------------------------

N, K, P, ROUNDS = 12, 3, 300, 16
SELECTOR_CASES = [
    ("random", {}), ("pow-d", {}), ("pow-d", {"d": 6}),
    ("cs", {}), ("cs", {"incremental": False}), ("cs", {"proj_dim": 64}),
    ("divfl", {"refresh": "selected"}),
    ("divfl", {"refresh": "selected", "incremental": False}),
    ("divfl", {"refresh": "selected", "proj_dim": 64}),
    ("divfl", {}), ("divfl", {"proj_dim": 64}),
    ("fedcor", {}), ("fedcor", {"warmup": 3, "hist_len": 4}),
]


def test_selectors_select_and_update_identical():
    """16 rounds of select and update with the same noise and
    observations (random full updates of width 300, losses in
    [0.5, 2.5]) pick the same participants in both packages; the
    stored features, cached distances and loss history agree.  DivFL's
    ideal setting gets the same ``full_all`` tensor on both sides, on
    the dyadic grid of the module docstring: multiples of 2**-10 within
    ±2**-4, so every |a|², ⟨a, b⟩ and bucket sum is exact in f32."""
    each(_selector_case, SELECTOR_CASES)


def _selector_case(case):
    name, extra = case
    r = np.random.default_rng(len(name) + len(extra))
    weights = r.integers(5, 50, N).astype(np.float64)
    kw = dict(num_clients=N, num_select=K, total_rounds=ROUNDS,
              weights=weights / weights.sum(), feat_dim=P, **extra)
    jfn = jax_make_functional(name, **kw)
    jstate = jfn.init(jax.random.PRNGKey(0))
    jselect, jupdate = jax.jit(jfn.select), jax.jit(jfn.update)
    if "proj_dim" in extra:
        kw["proj_signs"] = torch.tensor(np.asarray(jax.random.rademacher(
            jax.random.PRNGKey(0), (P,), jnp.float32)))
    tfn = make_functional(name, device="cpu", **kw)
    assert tfn.requires == jfn.requires
    tstate = tfn.init()
    key = jax.random.PRNGKey(1)
    for t in range(ROUNDS):
        key, k_sel = jax.random.split(key)
        jids, jstate = jselect(jstate, t, k_sel)
        tids, tstate = tfn.select(tstate, t, select_noise(k_sel, N, K, K))
        assert tids.tolist() == np.asarray(jids).tolist(), f"round {t}"
        rows = N if "full_all" in jfn.requires else K
        full = (r.normal(size=(rows, P)) * 0.05).astype(np.float32)
        if "full_all" in jfn.requires:
            full = np.clip(np.round(full * 1024) / 1024, -1 / 16, 1 / 16)
        losses = r.uniform(0.5, 2.5, N).astype(np.float32)
        jobs = JaxObservations(full_updates=jnp.asarray(full),
                               losses=jnp.asarray(losses))
        tobs = Observations(full_updates=torch.tensor(full),
                            losses=torch.tensor(losses))
        jstate = jupdate(jstate, t, jids, jobs)
        tstate = tfn.update(tstate, t, tids, tobs)
    assert int(tstate.hist_count) == int(jstate.hist_count)
    np.testing.assert_allclose(tstate.feats.numpy(),
                               np.asarray(jstate.feats), atol=1e-6)
    np.testing.assert_array_equal(tstate.loss_hist.numpy(),
                                  np.asarray(jstate.loss_hist))
    assert tstate.dist_cache.shape == jstate.dist_cache.shape
    if tstate.dist_cache.numel():
        np.testing.assert_allclose(tstate.dist_cache.numpy(),
                                   np.asarray(jstate.dist_cache),
                                   atol=1e-5, rtol=1e-5)
        assert torch.equal(tstate.dist_cache, tstate.dist_cache.T)


# ---------------------------------------------------------------------------
# whole runs: paper-cnn, 12 clients, K = 3, 14 rounds
# ---------------------------------------------------------------------------

RUN = dict(arch="paper-cnn", num_clients=12, num_select=3, rounds=14,
           alphas=(0.001, 0.002, 0.005, 0.01, 0.5), samples_train=600,
           samples_test=100, eval_every=5, seed=0)


def _whole_runs(selector, selector_kw=None):
    """(reference history, port history) of one run of each package
    from the reference's initial params and key chain."""
    common = dict(RUN, selector=selector, selector_kw=selector_kw)
    jspec = JaxExperimentSpec(
        data=JaxSyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=JaxLocalSpec(algo="fedavg", optimizer="sgd", lr=0.05,
                           epochs=2, batch_size=32), **common)
    tspec = ExperimentSpec(
        data=SyntheticSpec(dim=196, noise=0.5, proto_scale=1.2),
        local=LocalSpec(lr=0.05, epochs=2, batch_size=32), **common)
    jserver, _ = jax_build(jspec)
    tserver, _ = build(tspec, device="cpu")
    tserver.params = params_from_jax(to_np(jserver.params), "cpu")
    chain = JaxKeyChain(0, RUN["num_clients"], RUN["num_select"],
                        RUN["num_select"], 2, tserver.x.shape[1],
                        grad_all="full_all" in tserver.requires)
    return jserver.run(), tserver.run(draws=chain)


def _agree(jhist, thist, rounds):
    assert thist["selected"][:rounds] == jhist["selected"][:rounds]
    np.testing.assert_allclose(thist["train_loss"][:rounds],
                               jhist["train_loss"][:rounds], rtol=1e-4)


def test_whole_run_random():
    jhist, thist = _whole_runs("random")
    _agree(jhist, thist, 14)
    assert thist["bias_entropy"] == [None] * 14


def test_whole_run_powd():
    _agree(*_whole_runs("pow-d"), 14)


def test_whole_run_cs_incremental():
    """Four coverage rounds (N/K = 4), then ward on the cosine cache."""
    _agree(*_whole_runs("cs"), 14)


def test_whole_run_cs_from_scratch():
    _agree(*_whole_runs("cs", {"incremental": False}), 14)


def test_whole_run_divfl_selected():
    _agree(*_whole_runs("divfl", {"refresh": "selected"}), 14)


def test_whole_run_fedcor():
    """The GP branch starts at t >= warmup = 10."""
    _agree(*_whole_runs("fedcor"), 14)


def test_whole_run_divfl_ideal_horizon():
    """Identical participants and train loss for the measured horizon
    (module docstring)."""
    jhist, thist = _whole_runs("divfl")
    _agree(jhist, thist, DIVFL_IDEAL_HORIZON)
    assert len(thist["selected"]) == 14
