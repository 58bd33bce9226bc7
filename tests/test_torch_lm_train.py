"""The port's federated LM fine-tuning (``repro_torch.launch.train``)
on the CPU against the reference's (``repro.launch.train``), at the
reduced qwen3-8b (2 layers, d 256, H 4, KV 2, dh 64, qk_norm, vocab 512)
and the reduced qwen2.5-3b (QKV bias), the reference's init carried
over by ``params_from_jax``.

Tolerances, each against the reference's counterpart:
* ``make_lm_streams``: bit-equal (numpy on both sides).
* ``chunked_lm_loss`` (loss, accuracy, tokens, and the gradient of the
  hidden states through the chunks): 1e-5, at S ≤ chunk, S a multiple
  of it and S falling back to its largest divisor.
* ``loss_fn``: loss and every gradient leaf 1e-5.
* ``adam`` over 3 steps, a zero-gradient step among them (the moments
  and the count still advance), and ``clip_by_global_norm`` with and
  without clipping: 1e-6.
* ``local_lm_update``: every param and the loss 1e-5, sgd over two
  epochs (the driver's optimizer); adam over one epoch, the loss only.
  Adam's first step is lr·g/(|g| + 1e-8): where a gradient is rounding
  noise (true value 0) a last-bit difference flips a whole lr-sized
  step, so after two steps params differ by up to ~3e-4 while the loss
  agrees to 1e-7 (measured).
* The OO shims: every name picks the reference shim's ids on its
  replayed key chain (``torch_parity.ShimKeyChain``); the stale ring
  raises as there.
* The driver: 5 rounds at N = 4, K = 2 (2 coverage rounds, then 3
  clustered ones) pick the reference driver's participants every round;
  losses within 1e-4 relative, Ĥ within 1e-4 absolute.
* npz checkpoints written by either package restore in the other, bit
  for bit, bf16 leaves included.

Each test loops over its cases (``torch_parity.each``).
"""
import dataclasses
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.core import make_selector as jax_make_selector
from repro.data import make_lm_streams as jax_lm_streams
from repro.launch import train as jtrain
from repro.models import get_model as jax_model
from repro.models.losses import chunked_lm_loss as jax_chunked_loss
from repro.optim import adam as jax_adam
from repro.optim import clip_by_global_norm as jax_clip
from repro_torch import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import SSMConfig
from repro_torch.core import SELECTORS, make_selector
from repro_torch.core.selectors import draw_select_noise
from repro_torch.data import make_lm_streams
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.models.losses import chunked_lm_loss
from repro_torch.models.transformer import loss_fn, params_from_jax
from repro_torch.optim import (adam, clip_by_global_norm,
                               clip_by_global_norm_, tree_leaves)
from torch_parity import ShimKeyChain, each, to_np

TOL = 1e-5
ARCHS = ("qwen3-8b", "qwen2.5-3b")


def _models(arch):
    jcfg = jax_config(arch).reduced()
    tcfg = get_config(arch).reduced()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jax_model(jcfg), get_model(tcfg)


def _params(japi, seed=0):
    jp = japi.init(jax.random.PRNGKey(seed))
    return jp, params_from_jax(to_np(jp), "cpu")


def _close(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def test_make_lm_streams_bit_equal():
    def case(shape):
        vocab, seq_len, n, seqs, alphas = shape
        want = jax_lm_streams(np.random.default_rng(3), vocab, seq_len, n,
                              seqs, alphas)
        got = make_lm_streams(np.random.default_rng(3), vocab, seq_len, n,
                              seqs, alphas)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)

    each(case, [(512, 17, 4, 2, [0.05, 0.05, 0.05, 5.0]),
                (1000, 9, 7, 3, [0.1, 5.0])])


def test_chunked_lm_loss_matches_jax():
    def case(shape):
        s, chunk = shape
        rng = np.random.default_rng(s * 10 + chunk)
        b, d, v = 2, 16, 40
        x = rng.normal(size=(b, s, d)).astype(np.float32)
        w = (rng.normal(size=(d, v)) / 4).astype(np.float32)
        bias = rng.normal(size=(v,)).astype(np.float32)
        tgt = rng.integers(0, v, size=(b, s)).astype(np.int32)
        mask = (rng.random((b, s)) > 0.2).astype(np.float32)

        def jloss(xx):
            return jax_chunked_loss(xx, jnp.asarray(w), jnp.asarray(bias),
                                    jnp.asarray(tgt), jnp.asarray(mask),
                                    chunk=chunk)

        (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
            jnp.asarray(x))
        tx = torch.tensor(x, requires_grad=True)
        tl, tm = chunked_lm_loss(tx, torch.tensor(w), torch.tensor(bias),
                                 torch.tensor(tgt), torch.tensor(mask),
                                 chunk=chunk)
        (tg,) = torch.autograd.grad(tl, tx)
        _close(tl, jl, TOL, "loss")
        for key in ("ce_loss", "accuracy", "tokens"):
            _close(tm[key], jm[key], TOL, key)
        _close(tg, jg, TOL, "grad")

    # one chunk; several; the divisor fallback (12 -> 4, 14 -> 2)
    each(case, [(8, 512), (12, 4), (12, 5), (14, 5)])


def _batch(rng, vocab, s):
    seq = rng.integers(0, vocab, size=(s + 1,)).astype(np.int32)
    return {"tokens": seq[None, :-1], "targets": seq[None, 1:],
            "loss_mask": np.ones((1, s), np.float32)}


def test_loss_fn_and_grads_match_jax():
    def case(arch):
        japi, tapi = _models(arch)
        jp, tp = _params(japi)
        batch = _batch(np.random.default_rng(1), japi.cfg.vocab_size, 16)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (jl, jm), jg = jax.value_and_grad(
            lambda p: japi.loss(p, jb, dtype=jnp.float32), has_aux=True)(jp)
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tl, tm = tapi.loss(tp, tb)
        grads = torch.autograd.grad(tl, leaves)
        _close(tl, jl, TOL, "loss")
        _close(tm["accuracy"], jm["accuracy"], TOL, "accuracy")
        for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
            _close(got, want, TOL, "grad")

    each(case, ARCHS)


def test_loss_fn_unported_options_raise():
    _, tapi = _models("qwen3-8b")
    _, tp = _params(jax_model(jax_config("qwen3-8b").reduced()))
    tb = {k: torch.tensor(v) for k, v in
          _batch(np.random.default_rng(0), 512, 4).items()}
    # a bf16 compute dtype runs (its parity with the reference's bf16
    # loss is tests/test_torch_substrate.py's)
    half, _ = tapi.loss(tp, tb, dtype=torch.bfloat16)
    assert half.dtype == torch.float32 and bool(torch.isfinite(half))
    # patches on a config without a VLM prefix are ignored, as in the
    # reference; so is an SSM part of a dense config: the registry
    # routes by kind, and the reference's transformer reads no SSM field
    want, _ = tapi.loss(tp, tb)
    got, _ = tapi.loss(tp, dict(tb, patches=torch.zeros(1, 2, 8)))
    assert torch.equal(got, want)
    ssm_cfg = dataclasses.replace(tapi.cfg, ssm=SSMConfig())
    got, _ = loss_fn(tp, tb, ssm_cfg)
    assert torch.equal(got, want)


def _tree(rng, scale=1.0):
    return {"b": {"c": (rng.normal(size=(5,)) * scale).astype(np.float32)},
            "a": (rng.normal(size=(3, 4)) * scale).astype(np.float32)}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.tensor(v)
            for k, v in tree.items()}


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_adam_three_steps_with_a_zero_grad_step():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng), jax.tree_util.tree_map(np.zeros_like, params),
             _tree(rng, 3.0)]
    jopt, topt = jax_adam(1e-2), adam(1e-2)
    jp, tp = _jax_tree(params), _torch_tree(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for g in grads:
        ju, js = jopt.update(_jax_tree(g), js, jp, lr_scale=0.5)
        tu, ts = topt.update(_torch_tree(g), ts, tp,
                             lr_scale=torch.tensor(0.5))
        _close(tu, ju, 1e-6, "updates")
        _close({"m": ts["m"], "v": ts["v"]},
               {"m": js["m"], "v": js["v"]}, 1e-6, "moments")
        assert int(ts["count"]) == int(js["count"])
        assert ts["count"].dtype == torch.int32 and ts["count"].dim() == 0
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = {k: v for k, v in _torch_tree(to_np(jp)).items()}


def test_clip_by_global_norm_matches_jax():
    def case(scale):
        g = _tree(np.random.default_rng(1), scale)
        jg, jn = jax_clip(_jax_tree(g), 1.0)
        tg, tn = clip_by_global_norm(_torch_tree(g), 1.0)
        _close(tn, jn, 1e-6, "norm")
        _close(tg, jg, 1e-6, "clipped")
        leaves = tuple(tree_leaves(_torch_tree(g)))
        _close(clip_by_global_norm_(leaves, 1.0), jn, 1e-6, "norm_")
        for got, want in zip(leaves, jax.tree_util.tree_leaves(jg)):
            _close(got, want, 1e-6, "clipped in place")

    each(case, [0.01, 1.0])     # the norm below 1 (no clip) and above


def test_global_norm_of_a_long_leaf_is_accurate():
    """The clip's norm over a leaf of 2e7 elements within 1e-6 of the
    f64 norm (``torch.linalg.vector_norm`` of a long f32 vector is off
    by 3.6e-4 on the CPU at 1e7 elements, measured)."""
    g = torch.randn(20_000_000, generator=torch.Generator().manual_seed(0))
    want = float(g.double().square().sum().sqrt())
    got = clip_by_global_norm_((g * 1e-3,), 1.0)
    np.testing.assert_allclose(float(got), want * 1e-3, rtol=1e-6)


def test_local_lm_update_matches_jax():
    japi, tapi = _models("qwen3-8b")
    jp, tp = _params(japi)
    toks = np.random.default_rng(2).integers(
        0, japi.cfg.vocab_size, size=(2, 17)).astype(np.int32)

    def case(run):
        opt_name, epochs = run
        want, wl = jtrain.local_lm_update(japi, jp, jnp.asarray(toks), 0.05,
                                          epochs, opt_name)
        got, gl = ttrain.local_lm_update(tapi, tp, torch.tensor(toks), 0.05,
                                         epochs, opt_name)
        _close(gl, wl, TOL, "loss")
        if opt_name == "sgd":
            _close(got, want, TOL, "params")

    each(case, [("sgd", 2), ("adam", 1)])
    # the given params stay as they were
    _close(tp, jp, 0.0, "params unchanged")


def _observations(name, rng, n, ids, c=12):
    """What each selector's ``requires`` reads, as numpy."""
    k = len(ids)
    return {"random": {}, "hics": {"bias_updates": rng.normal(size=(k, c))
                                   * 0.01},
            "pow-d": {"losses": rng.random(n) + 1.0},
            "fedcor": {"losses": rng.random(n) + 1.0},
            "cs": {"full_updates": rng.normal(size=(k, 30))},
            "divfl": {"full_updates": rng.normal(size=(n, 30))}}[name]


def test_selector_shims_pick_jax_ids():
    n, k, rounds = 8, 2, 7

    def case(name):
        kw = dict(num_clients=n, num_select=k, total_rounds=rounds,
                  temperature=0.01, seed=3)
        jsel = jax_make_selector(name, **kw)
        tsel = make_selector(name, device="cpu", num_classes=12, **kw)
        assert tsel.requires == jsel.requires and tsel.name == jsel.name
        assert tsel.estimated_entropies() is None
        chain = ShimKeyChain(3, n, k)
        rng = np.random.default_rng(4)
        for t in range(rounds):
            want = jsel.select(t)
            got = tsel.select(t, chain(t))
            assert got == want, (t, got, want)
            obs = _observations(name, rng, n, want)
            jsel.update(t, want, **obs)
            tsel.update(t, got, **obs)
            je, te = jsel.estimated_entropies(), tsel.estimated_entropies()
            assert (je is None) == (te is None)
            if je is not None:
                np.testing.assert_allclose(te, je, atol=1e-4)
        assert tsel.select_seconds > 0 and tsel.update_seconds > 0

    each(case, sorted(SELECTORS))


def test_shim_stale_ring_and_default_noise():
    kw = dict(num_clients=6, num_select=2, total_rounds=4, seed=5)
    for mk in (lambda: jax_make_selector("hics", **kw),
               lambda: make_selector("hics", device="cpu", **kw)):
        sel = mk()
        ids = sel.select(0)
        sel.update(0, ids, bias_updates=np.ones((2, 10)))
        with pytest.raises(RuntimeError, match="staled-id ring holds 2"):
            sel.update(1, ids, bias_updates=np.ones((2, 10)))
    # no noise given: the shim's generator, drawn as the server draws
    a = make_selector("hics", device="cpu", **kw)
    b = make_selector("hics", device="cpu", **kw)
    gen = torch.Generator().manual_seed(5)
    for t in range(3):
        got = a.select(t)
        assert got == b.select(t, draw_select_noise(gen, 6, 2))
        a.update(t, got, bias_updates=np.eye(2, 10))
        b.update(t, got, bias_updates=np.eye(2, 10))


ROUNDS, CLIENTS, SELECT, SEQ, SEQS = 5, 4, 2, 16, 2


def test_train_loop_picks_jax_participants(tmp_path, monkeypatch, capsys):
    """The reference's CLI at the reduced qwen3-8b against the port's
    round loop from the reference's init and on its shim's key chain."""
    out = tmp_path / "hist.json"
    argv = ["--rounds", str(ROUNDS), "--clients", str(CLIENTS),
            "--select", str(SELECT), "--seq-len", str(SEQ),
            "--seqs-per-client", str(SEQS)]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + ["--out", str(out)])
    jtrain.main()
    want = json.loads(out.read_text())

    japi, tapi = _models("qwen3-8b")
    _, tp = _params(japi)
    toks, _ = make_lm_streams(np.random.default_rng(0), 512, SEQ + 1,
                              CLIENTS, SEQS, [0.05, 0.05, 0.05, 5.0])
    sel = make_selector("hics", num_clients=CLIENTS, num_select=SELECT,
                        total_rounds=ROUNDS, temperature=0.01,
                        num_classes=512, seed=0, device="cpu")
    _, got = ttrain.train_rounds(tapi, tp, torch.tensor(toks), sel,
                                 rounds=ROUNDS, lr=0.05, epochs=1,
                                 noise=ShimKeyChain(0, CLIENTS, SELECT))
    assert got["selected"] == want["selected"]
    assert got["round"] == list(range(ROUNDS))
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got["bias_entropy"]),
                               np.asarray(want["bias_entropy"]), atol=1e-4)
    # the sweep covers the 4 clients in 2 rounds, then clustered rounds
    assert sorted(sum(got["selected"][:2], [])) == list(range(CLIENTS))
    capsys.readouterr()


def test_train_cli_runs_every_selector(tmp_path, capsys):
    """The port's CLI at the reference's default arch (qwen3-8b,
    reduced) with each selector name: the reference's history keys and
    printed lines, finite losses; ``--telemetry`` writes a header and a
    record a round, the loss the history's."""
    for name in sorted(SELECTORS):
        out = tmp_path / f"{name}.json"
        res = ttrain.main(["--device", "cpu", "--selector", name,
                           "--rounds", "3", "--clients", "4", "--select",
                           "2", "--seq-len", "8", "--seqs-per-client", "1",
                           "--out", str(out)])
        hist = json.loads(out.read_text())
        assert sorted(hist) == sorted(
            ["round", "loss", "selected", "bias_entropy", "wall_s",
             "select_seconds", "update_seconds"]), name
        assert hist == json.loads(json.dumps(res["history"]))
        assert len(hist["selected"]) == 3 and np.isfinite(hist["loss"]).all()
        assert (hist["bias_entropy"][-1] is None) == (name != "hics")
        text = capsys.readouterr().out
        assert text.startswith("arch=qwen3-8b-reduced params=")
        assert "round   2 loss=" in text and "done. final loss:" in text
    tel = tmp_path / "t.jsonl"
    res = ttrain.main(["--device", "cpu", "--rounds", "2", "--clients", "4",
                       "--select", "2", "--seq-len", "8",
                       "--seqs-per-client", "1", "--telemetry", str(tel)])
    records = [json.loads(line) for line in tel.read_text().splitlines()]
    assert records[0]["kind"] == "header" and len(records) == 3
    assert [r["training/loss"] for r in records[1:]] == [
        float(np.float32(x)) for x in res["history"]["loss"]]


def test_npz_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"layers": {"w": rng.normal(size=(2, 3)).astype(np.float32),
                       "h": rng.normal(size=(4,)).astype(np.float32)},
            "step_count": np.arange(3, dtype=np.int32)}
    jtree = dict(_jax_tree(tree),
                 half=jnp.asarray(rng.normal(size=(5,)), jnp.bfloat16))
    ttree = dict(_torch_tree(tree), half=torch.tensor(
        np.asarray(jtree["half"].astype(jnp.float32))).bfloat16())

    # the reference writes, the port restores
    path = jckpt.save_pytree(tmp_path / "j" / "step_3", jtree, step=3)
    flat, step = tckpt.load_pytree(path)
    assert step == 3 and flat["half"].dtype == torch.bfloat16
    got, step = tckpt.restore(path, ttree)
    assert step == 3
    for key in ("step_count", "half"):
        assert torch.equal(got[key], ttree[key])
    assert torch.equal(got["layers"]["w"], ttree["layers"]["w"])

    # the port writes, the reference restores
    path = tckpt.save_pytree(tmp_path / "t" / "step_7.npz", ttree, step=7)
    assert path.name == "step_7.npz"
    tckpt.save_pytree(tmp_path / "t" / "step_12.npz", ttree, step=12)
    assert tckpt.latest_step(tmp_path / "t").name == "step_12.npz"
    back, step = jckpt.restore(path, jtree)
    assert step == 7
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a.astype(jnp.float32)),
                              np.asarray(b.astype(jnp.float32)))
    with np.load(path) as z:
        assert "half__bf16__" in z.files
        assert json.loads(bytes(z["__meta__"]).decode())["keys"] == [
            "half", "layers/h", "layers/w", "step_count"]
