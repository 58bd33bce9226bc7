"""The rest of the port's decoder-only transformer family on the CPU
against the JAX reference: gemma-7b and deepseek-coder-33b (dense),
granite-moe-1b-a400m and mixtral-8x22b (MoE), pixtral-12b (the VLM
prefix), each at its reduced config (2 layers, d 256, H 4, KV 2, dh 64,
vocab 512; MoE 4 experts top-2; pixtral 8 patches of width 64; mixtral
window 16), from the reference's params carried over by
``params_from_jax``.

Tolerances, each against the reference's counterpart:
* Configs: every field equal, full and reduced.
* Forward logits, the MoE aux terms of each layer, loss and metrics
  (``moe_frac_dropped`` among them) and the gradient of every leaf:
  1e-5 absolute and relative, as ``tests/test_torch_lm_train.py``.
* Prefill logits 1e-4; 8 decode steps teacher-forced by the
  reference's greedy tokens 2e-2, the port's greedy token the
  reference's at every step (``tests/test_torch_serve.py``'s
  tolerances: the bf16 cache can round an entry one bf16 step apart).
  mixtral at a 24-token prompt (over its window of 16: the window
  masks prefill and decode), and on a fresh ring cache of 16 slots fed
  32 tokens (the ring wraps twice).
* ``moe_block`` alone, at capacity factors that drop pairs: slots,
  ``keep`` and the share dropped equal; outputs, aux and gradients
  1e-5; ``capacity`` equal over a grid.
* ``launch.train`` at the reduced granite-moe (a tied head): the
  reference CLI's participants, losses (1e-4 relative) and Ĥ (1e-4)
  with the head's bias, whose update is Δb; without the bias the head
  yields no Δb on either side (None), and HiCS gets no observation.
* ``examples.serve_batched``: the reference example's greedy tokens for
  every request, free-running.

Each test loops over its cases (``torch_parity.each``).  The module
takes ~60 s of one worker, most of it the reference's compiles.
"""
import dataclasses
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.core import head_bias_updates_stacked as jax_head_db
from repro.launch import train as jtrain
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import get_model as jax_model
from repro.models import moe as JMOE
from repro.models import transformer as JTF
from repro_torch.backend import set_precision
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.core import make_selector
from repro_torch.data import make_lm_streams
from repro_torch.examples import serve_batched as tserve_batched
from repro_torch.launch import train as ttrain
from repro_torch.models import get_model
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TTF
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import tree_leaves
from torch_parity import ShimKeyChain, each, to_np

ARCHS = ("gemma-7b", "deepseek-coder-33b", "granite-moe-1b-a400m",
         "mixtral-8x22b", "pixtral-12b")
TOL = 1e-5
PREFILL_TOL = 1e-4
DECODE_TOL = 2e-2


def _close(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _models(arch, **changes):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    japi, tapi = jax_model(jcfg), get_model(tcfg)
    jp = japi.init(jax.random.PRNGKey(0))
    return japi, jp, tapi, params_from_jax(to_np(jp), "cpu")


def _jax_decode(japi):
    """The reference's decode step, compiled once for the arch."""
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(
        p, c, {"token": tok, "pos": pos}, dtype=jnp.float32))
    return lambda p, c, tok, pos: step(p, c, jnp.asarray(tok),
                                       jnp.asarray(pos, jnp.int32))


def _batch(cfg, rng, b, s, targets=True):
    """numpy inputs: tokens (B, S) and, for a VLM, patches (B, P, ·)."""
    out = {}
    if cfg.vlm is not None:
        out["patches"] = rng.normal(
            size=(b, cfg.vlm.num_patches, cfg.vlm.patch_embed_dim)
        ).astype(np.float32)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out["tokens"] = seq[:, :-1]
    if targets:
        out["targets"] = seq[:, 1:]
        out["loss_mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
    return out


def test_family_configs_are_the_references():
    def case(arch):
        for t, j in ((get_config(arch), jax_config(arch)),
                     (get_config(arch).reduced(), jax_config(arch).reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
    each(case, ARCHS)
    assert get_config("gemma-7b").resolved_head_dim() == 256
    assert get_model("pixtral-12b").cfg.kind == "vlm"


def test_family_forward_loss_and_grads_match_jax():
    """Logits of every position, the stacked aux terms, the loss and its
    metrics, and the gradient of every leaf (the MoE router and experts,
    the projector, the tied embedding among them)."""
    set_precision()

    def case(arch):
        japi, jp, tapi, tp = _models(arch)
        cfg = tapi.cfg
        batch = _batch(cfg, np.random.default_rng(1), 2, 16)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.tensor(v) for k, v in batch.items()}
        extra = jb.get("patches")
        jx, jaux, _ = JTF.forward(jp, jb["tokens"], japi.cfg,
                                  extra_embeds=extra)
        tx, _, taux = TTF.forward(tp, tb["tokens"], cfg,
                                  extra_embeds=tb.get("patches"))
        jw, jbias = JTF.head_weights(jp, japi.cfg)
        tw, tbias = TTF.head_weights(tp, cfg)
        _close(tx @ tw + tbias, jx @ jw + jbias, TOL, "logits")
        assert (taux is None) == (jaux is None)
        if jaux is not None:
            _close(taux, jaux, TOL, "aux")
            assert taux["moe_lb_loss"].shape == (cfg.num_layers,)

        (jl, jm), jg = jax.value_and_grad(
            lambda p: japi.loss(p, jb, dtype=jnp.float32), has_aux=True)(jp)
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tl, tm = tapi.loss(tp, tb)
        grads = torch.autograd.grad(tl, leaves)
        _close(tl, jl, TOL, "loss")
        _close(tm, jm, TOL, "metrics")
        assert ("moe_frac_dropped" in tm) == (cfg.moe is not None)
        for got, want in zip(grads, jax.tree_util.tree_leaves(jg)):
            _close(got, want, TOL, "grad")
        if cfg.vlm is not None:
            # the loss reads the text positions only: the tokens and
            # targets after the P patches
            assert float(tm["tokens"]) == float(batch["loss_mask"].sum())
            assert tx.shape[1] == cfg.vlm.num_patches + 16

    each(case, ARCHS)


def test_family_prefill_and_decode_match_jax():
    """Prefill logits and 8 decode steps fed the reference's greedy
    tokens; a VLM's decode positions start after its P + S prefix."""
    set_precision()
    each(_decode_case, [(a, 12) for a in ARCHS] + [("mixtral-8x22b", 24)])


def _decode_case(arch_prompt):
    arch, prompt = arch_prompt
    japi, jp, tapi, tp = _models(arch)
    b, n = 3, 8
    batch = _batch(tapi.cfg, np.random.default_rng(prompt), b, prompt,
                   targets=False)
    jl, jcache = japi.prefill(jp, {k: jnp.asarray(v)
                                   for k, v in batch.items()},
                              dtype=jnp.float32, cache_extra=n)
    tl, tcache = tapi.prefill(tp, {k: torch.tensor(v)
                                   for k, v in batch.items()},
                              cache_extra=n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=PREFILL_TOL)
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    pos = tcache["k"].shape[2] - n
    assert pos == prompt + (tapi.cfg.vlm.num_patches if tapi.cfg.vlm
                            else 0)
    decode = _jax_decode(japi)
    for i in range(n):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0]), i
        jl, jcache = decode(jp, jcache, tok, pos + i)
        tl, tcache = tapi.decode_step(
            tp, tcache, {"token": torch.tensor(tok), "pos": pos + i})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, err_msg=str(i))


def test_mixtral_ring_cache_wraps_as_jax():
    """The reduced mixtral (window 16) decodes 32 tokens from position
    0 on the 16-slot ring cache its registry sizes: the ring wraps
    twice; logits within 2e-2 and the greedy pick the reference's at
    every step."""
    set_precision()
    japi, jp, tapi, tp = _models("mixtral-8x22b")
    b, steps = 2, 32
    assert tapi.cfg.sliding_window == 16
    jcache = japi.init_cache(b, steps)
    tcache = tapi.init_cache(b, steps, device="cpu")
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == 16
    toks = np.random.default_rng(7).integers(
        0, tapi.cfg.vocab_size, (b, steps)).astype(np.int32)
    decode = _jax_decode(japi)
    for pos in range(steps):
        tok = toks[:, pos:pos + 1]
        jl, jcache = decode(jp, jcache, tok, pos)
        tl, tcache = tapi.decode_step(tp, tcache,
                                      {"token": torch.tensor(tok),
                                       "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, err_msg=str(pos))
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(),
                              np.asarray(jnp.argmax(jl[:, -1], -1))), pos


def _jax_slots(p, x, moe_cfg):
    """The reference's routing (``models/moe.py:52-66``) on its own
    ops: the top-k ids, each pair's slot and ``keep``."""
    e, k = moe_cfg.num_experts, moe_cfg.top_k
    c = JMOE.capacity(x.shape[1], moe_cfg)
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    flat_e = top_i.reshape(x.shape[0], -1)
    pos_all = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), 1) - 1
    pos = jnp.take_along_axis(pos_all, flat_e[..., None], -1)[..., 0]
    keep = pos < c
    return top_i, jnp.where(keep, pos, c), keep


def test_moe_block_with_drops_matches_jax():
    """One MoE block at capacity factor 0.5 (pairs dropped) for each
    expert FFN (swiglu, geglu, plain gelu), and at 1.25 (none dropped
    here)."""
    set_precision()

    def case(cf, kind):
        moe_cfg = MoEConfig(num_experts=4, top_k=2, capacity_factor=cf)
        d, ff, b, s = 32, 48, 3, 12
        jp = JMOE.init_moe(jax.random.PRNGKey(3), d, ff, moe_cfg)
        tp = params_from_jax(to_np(jp), "cpu")
        x = np.random.default_rng(4).normal(size=(b, s, d)).astype(
            np.float32)
        jx, tx = jnp.asarray(x), torch.tensor(x, requires_grad=True)

        top_i, slot, keep = _jax_slots(jp, jx, moe_cfg)
        _, _, _, t_top_i, t_slot, t_keep, c = TMOE.route(tp, tx, moe_cfg)
        assert c == JMOE.capacity(s, moe_cfg)
        assert np.array_equal(t_top_i.numpy(), np.asarray(top_i))
        assert np.array_equal(t_slot.numpy(), np.asarray(slot))
        assert np.array_equal(t_keep.numpy(), np.asarray(keep))
        dropped = 1.0 - float(np.mean(np.asarray(keep)))
        assert (dropped > 0) == (cf < 1)

        def jf(p, xx):
            y, aux = JMOE.moe_block(p, xx, moe_cfg, kind)
            return jnp.sum(y * jnp.cos(xx)) + aux["moe_lb_loss"] \
                + aux["moe_z_loss"], (y, aux)

        (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True)(jp, jx)
        leaves = [tp[k] for k in sorted(tp)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        ty, taux = TMOE.moe_block(tp, tx, moe_cfg, kind)
        obj = (ty * torch.cos(tx)).sum() + taux["moe_lb_loss"] \
            + taux["moe_z_loss"]
        grads = torch.autograd.grad(obj, leaves + [tx], allow_unused=True)
        # plain gelu leaves wi1 unused: the reference's gradient is 0
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, leaves + [tx])]
        _close(ty, jy, TOL, "y")
        _close(taux, jaux, TOL, "aux")
        assert float(taux["moe_frac_dropped"]) == dropped
        for key, g in zip(sorted(tp), grads):
            _close(g, jgp[key], TOL, f"grad {key}")
        _close(grads[-1], jgx, TOL, "grad x")

    each(lambda cf_kind: case(*cf_kind),
         [(0.5, "swiglu"), (0.5, "geglu"), (0.5, "gelu"), (1.25, "swiglu")])


def test_moe_capacity_matches_jax():
    for seq in (1, 2, 7, 12, 64, 128, 4096):
        for e, k in ((4, 2), (8, 2), (32, 8), (8, 1)):
            for cf in (0.1, 0.5, 1.0, 1.25, 2.0):
                cfg = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
                assert TMOE.capacity(seq, cfg) == JMOE.capacity(seq, cfg), \
                    (seq, e, k, cf)


def test_stable_top_k_ties_to_the_lower_index():
    x = torch.tensor([[0.25, 0.5, 0.25, 0.5], [0.1, 0.3, 0.3, 0.3]])
    vals, idx = TMOE.top_k(x, 3)
    jvals, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 3)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(vals.numpy(), np.asarray(jvals))


ROUNDS, CLIENTS, SELECT, SEQ, SEQS = 2, 4, 2, 16, 2
TIED = "granite-moe-1b-a400m"


def _port_rounds(tapi, tp):
    """The port's round loop on the reduced streams, HiCS on the
    reference shim's key chain: (history, record)."""
    toks, _ = make_lm_streams(np.random.default_rng(0), tapi.cfg.vocab_size,
                              SEQ + 1, CLIENTS, SEQS, [0.05, 0.05, 0.05, 5.0])
    sel = make_selector("hics", num_clients=CLIENTS, num_select=SELECT,
                        total_rounds=ROUNDS, temperature=0.01,
                        num_classes=tapi.cfg.vocab_size, seed=0,
                        device="cpu")
    record = []
    _, hist = ttrain.train_rounds(tapi, tp, torch.tensor(toks), sel,
                                  rounds=ROUNDS, lr=0.05, epochs=1,
                                  noise=ShimKeyChain(0, CLIENTS, SELECT),
                                  record=record)
    return hist, record


def test_tied_head_train_rounds_match_jax(tmp_path, monkeypatch, capsys):
    """The reference's CLI at the reduced granite-moe (tied head, MoE
    aux in the loss) against the port's round loop from the reference's
    init on its shim's key chain: the head keeps its bias (the config's
    default), whose update is Δb.  Without the bias neither package has
    a head to read: the reference's ``head_bias_updates_stacked`` and
    the port's round loop give Δb None, and HiCS observes nothing."""
    out = tmp_path / "hist.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", TIED, "--rounds", str(ROUNDS), "--clients",
        str(CLIENTS), "--select", str(SELECT), "--seq-len", str(SEQ),
        "--seqs-per-client", str(SEQS), "--out", str(out)])
    jtrain.main()
    want = json.loads(out.read_text())
    _, _, tapi, tp = _models(TIED)
    assert tapi.cfg.tie_embeddings and sorted(tp["lm_head"]) == ["b"]
    got, record = _port_rounds(tapi, tp)
    assert got["selected"] == want["selected"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got["bias_entropy"]),
                               np.asarray(want["bias_entropy"]), atol=1e-4)
    for r in record:
        assert r["delta_b"].shape == (SELECT, tapi.cfg.vocab_size)
        assert bool(r["delta_b"].abs().max() > 0)

    _, jp, tapi, tp = _models(TIED, lm_head_bias=False)
    assert "lm_head" not in jp and "lm_head" not in tp
    stacked = jax.tree_util.tree_map(lambda a: jnp.stack([a, a]), jp)
    assert jax_head_db(jp, stacked) is None
    got, record = _port_rounds(tapi, tp)
    assert all(r["delta_b"] is None for r in record)
    assert got["bias_entropy"] == [None] * ROUNDS
    assert np.isfinite(got["loss"]).all()
    capsys.readouterr()


def test_serve_batched_gives_jax_tokens(capsys):
    """The port's example on the reference's params against the
    reference example's loop on the same batch: every request's greedy
    tokens, free-running, for a MoE arch with a sliding window and the
    VLM; the CLI runs on the CPU."""
    set_precision()

    def case(arch):
        japi, jp, tapi, tp = _models(arch)
        b, s, gen = 3, 24, 8
        got = tserve_batched.serve_batched(
            tapi, tp, np.random.default_rng(0), b, s, gen, "cpu")
        from repro_torch.launch.serve import make_batch
        batch = make_batch(tapi.cfg, np.random.default_rng(0), b, s, "cpu")
        prefill = make_prefill_step(japi, dtype=jnp.float32,
                                    cache_extra=gen)
        serve = make_serve_step(japi, dtype=jnp.float32)
        token, cache = prefill(jp, {k: jnp.asarray(v.numpy())
                                    for k, v in batch.items()})
        want = [np.asarray(token)]
        for i in range(gen - 1):
            token, cache = serve(jp, cache,
                                 {"token": token,
                                  "pos": jnp.asarray(s + i, jnp.int32)})
            want.append(np.asarray(token))
        assert np.array_equal(got["tokens"].numpy(),
                              np.concatenate(want, axis=1))
        assert got["length"] == s + gen - 1
        assert got["kernel_max_abs_err"] == 0.0

    each(case, ["mixtral-8x22b", "pixtral-12b"])
    res = tserve_batched.main(["--arch", "gemma-7b", "--device", "cpu",
                               "--gen", "4"])
    assert res["tokens"].shape == (4, 4)
    assert "flash-decode kernel (H=4 KV=2 dh=64" in capsys.readouterr().out
