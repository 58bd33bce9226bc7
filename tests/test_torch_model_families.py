"""The port's remaining model families on the CPU against the JAX
reference: rwkv6-3b (RWKV6, ``models/rwkv.py``), zamba2-7b (Mamba2 with
shared attention blocks, ``models/{mamba,hybrid}.py``) and
seamless-m4t-medium (encoder-decoder with cross-attention,
``models/encdec.py``), each at its reduced config (2 layers, d 256,
vocab 512; rwkv head 32, LoRA ranks 8; zamba2 H 4, KV 2, dh 64, SSD
state 16, head 32, chunk 32, one shared block applied before every
layer; seamless 2 + 2 layers, H 4, KV 2, dh 64, frames of width 256),
and zamba2 over 4 layers with ``attn_period`` 2 and two shared blocks
(both blocks used, the mamba stack sliced in groups of two), from the
reference's params carried over by ``params_from_jax``.

Tolerances, each against the reference's counterpart:
* Configs: every field equal, full and reduced; the registries hold
  the same archs.
* Forward logits, loss, metrics and the gradient of every leaf: 1e-5
  absolute and relative, as ``tests/test_torch_lm_train.py``.
* Prefill logits 1e-4, and every cache leaf after the prefill within
  1e-5 (f32 leaves: the rwkv state and token-shift rows, the mamba
  state and conv inputs) or one bf16 step of its value plus 1e-5 (the
  bf16 attention caches, self and cross: an f32 last-bit difference
  at a rounding boundary moves an entry by one step, and near 0 the
  f32 values differ by more than their own step).
* 8 decode steps teacher-forced by the reference's greedy tokens: 2e-2
  (``tests/test_torch_serve.py``'s, for the bf16 caches), the port's
  greedy token the reference's at every step; rwkv's all-f32 cache
  after the steps within 1e-5 relative plus 1e-5 of each leaf's
  largest magnitude (each step adds f32-rounded products to the
  state).
* ``ssd_chunked`` over 3 chunks from a carried state: y, the final
  state and the gradients of every input 1e-5; a T that is not a
  multiple of the chunk raises ``ValueError`` in both packages.
* A prompt through ``prefill`` against the same prompt token by token
  through ``decode_step`` (rwkv) or the mixer's one-token step (mamba),
  in both packages: the last logits (rwkv) or the outputs (mamba)
  within 1e-5, the caches as rwkv's after decode (a segment's batched
  products and a token's round differently).
* ``launch.train`` at the reduced rwkv6-3b: the reference CLI's
  participants, losses within 1e-4 relative and Ĥ within 1e-4.
* ``examples.serve_batched`` with seamless: the reference example's
  greedy tokens for every request, free-running.

Each test loops over its cases (``torch_parity.each``).  The module
takes ~70 s alone in one process (its longest test ~35 s), most of it
the reference's compiles and eager inits.
"""
import dataclasses
import functools
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.launch import train as jtrain
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import encdec as JED
from repro.models import get_model as jax_model
from repro.models import hybrid as JHY
from repro.models import mamba as JMB
from repro.models import rwkv as JRK
from repro_torch.backend import set_precision
from repro_torch.configs import get_config, list_archs
from repro_torch.core import make_selector
from repro_torch.data import make_lm_streams
from repro_torch.examples import serve_batched as tserve_batched
from repro_torch.launch import train as ttrain
from repro_torch.launch.serve import make_batch
from repro_torch.models import encdec as TED
from repro_torch.models import get_model
from repro_torch.models import hybrid as THY
from repro_torch.models import mamba as TMB
from repro_torch.models import rwkv as TRK
from repro_torch.models.transformer import head_weights, params_from_jax
from repro_torch.optim import tree_leaves
from torch_parity import ShimKeyChain, each, to_np

ARCHS = ("rwkv6-3b", "zamba2-7b", "seamless-m4t-medium")
#: zamba2 with both of its published mechanisms at reduced width: two
#: shared blocks alternating, a site before every second mamba layer
ZAMBA_SITES = dict(num_layers=4)
TOL = 1e-5
PREFILL_TOL = 1e-4
DECODE_TOL = 2e-2
FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: one torch thread, so as not to spin against XLA's
    threads in the same process or the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case_cfg(arch, reduced_cfg):
    if arch == "zamba2-sites":
        return dataclasses.replace(
            reduced_cfg, **ZAMBA_SITES,
            hybrid=dataclasses.replace(reduced_cfg.hybrid, attn_period=2,
                                       num_shared_blocks=2))
    return reduced_cfg


@functools.lru_cache(maxsize=None)
def _jax_models(arch):
    """The reference's API and params (its CLI's init, on key 0), made
    once a process."""
    name = "zamba2-7b" if arch == "zamba2-sites" else arch
    japi = jax_model(_case_cfg(arch, jax_config(name).reduced()))
    return japi, japi.init(jax.random.PRNGKey(0))


def _models(arch):
    """(reference API, its params, the port's API, a fresh copy of the
    same params)."""
    japi, jp = _jax_models(arch)
    name = "zamba2-7b" if arch == "zamba2-sites" else arch
    tcfg = _case_cfg(arch, get_config(name).reduced())
    assert dataclasses.asdict(japi.cfg) == dataclasses.asdict(tcfg)
    return japi, jp, get_model(tcfg), params_from_jax(to_np(jp), "cpu")


def _close(got, want, tol, what=""):
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close(got[k], want[k], tol, f"{what}/{k}")
        return
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


def _close_scaled(got, want, what=""):
    """Each leaf within 1e-5 relative plus 1e-5 of its largest
    magnitude: for recurrent states after several steps, each of which
    adds f32-rounded products (a segment's batched products and a
    token's round differently)."""
    got, want = to_np(got), to_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close_scaled(got[k], want[k], f"{what}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=what)


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """One bf16 rounding step (8 significant bits) at each value."""
    mag = np.maximum(np.abs(a), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _close_cache(got, want, what=""):
    """Each leaf: f32 within 1e-5; bf16 within one bf16 step of the
    larger value plus 1e-5 (near 0 the f32 values before the rounding
    differ by more than a step of theirs, as f32 sums that nearly
    cancel do)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _close_cache(got[k], want[k], f"{what}/{k}")
        return
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what
    assert tuple(got.shape) == tuple(want.shape), what
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    if want.dtype == jnp.bfloat16:
        bad = np.abs(g - w) > _bf16_step(np.maximum(np.abs(g),
                                                    np.abs(w))) + TOL
        assert not bad.any(), f"{what}: {bad.sum()} entries off by > 1 step"
    else:
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=what)


def _batch(cfg, rng, b, s, targets=True):
    """numpy inputs: an audio arch's frames (B, F, d) first, then
    tokens (B, S) and, for training, targets and a loss mask."""
    out = {}
    if cfg.encdec is not None:
        out["frames"] = rng.normal(size=(b, FRAMES, cfg.d_model)).astype(
            np.float32)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out["tokens"] = seq[:, :-1]
    if targets:
        out["targets"] = seq[:, 1:]
        out["loss_mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
    return out


def _hidden(pkg, p, batch, cfg):
    """The model's hidden states after the final norm, by its family:
    (rwkv, hybrid, encdec) modules of one package."""
    rk, hy, ed = pkg
    if cfg.kind == "ssm":
        return rk.forward(p, batch["tokens"], cfg)[0]
    if cfg.kind == "hybrid":
        return hy.forward(p, batch["tokens"], cfg)[0]
    enc = ed.encode(p, batch["frames"], cfg)
    return ed.decode_train(p, batch["tokens"], enc, cfg)[0]


def test_family_configs_are_the_references():
    def case(arch):
        for t, j in ((get_config(arch), jax_config(arch)),
                     (get_config(arch).reduced(), jax_config(arch).reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert get_model(arch).cfg.kind == jax_config(arch).kind
    each(case, ARCHS)
    assert list_archs() == jax_archs()
    assert get_config("zamba2-7b").resolved_head_dim() == 112
    assert THY.group_sizes(get_config("zamba2-7b")) == \
        JHY.group_sizes(jax_config("zamba2-7b"))
    assert THY.num_attn_sites(get_config("zamba2-7b")) == 14


def test_family_forward_loss_and_grads_match_jax():
    """Logits of every position, the loss and its metrics, and the
    gradient of every leaf (the shared blocks' summed over their
    sites)."""
    set_precision()

    def case(arch):
        japi, jp, tapi, tp = _models(arch)
        cfg = tapi.cfg
        batch = _batch(cfg, np.random.default_rng(1), 2, 32)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        tb = {k: torch.tensor(v) for k, v in batch.items()}

        @jax.jit
        def reference(p):
            return (_hidden((JRK, JHY, JED), p, jb, japi.cfg),
                    jax.value_and_grad(lambda q: japi.loss(
                        q, jb, dtype=jnp.float32), has_aux=True)(p))

        jx, ((jl, jm), jg) = reference(jp)
        tx = _hidden((TRK, THY, TED), tp, tb, cfg)
        tw, tbias = head_weights(tp, cfg)
        jw, jbias = jp["lm_head"]["w"], jp["lm_head"]["b"]
        _close(tx @ tw + tbias, jx @ jw + jbias, TOL, "logits")
        leaves = tree_leaves(tp)
        for leaf in leaves:
            leaf.requires_grad_(True)
        tl, tm = tapi.loss(tp, tb)
        grads = torch.autograd.grad(tl, leaves)
        _close(tl, jl, TOL, "loss")
        _close(tm, jm, TOL, "metrics")
        jleaves = jax.tree_util.tree_leaves(jg)
        assert len(grads) == len(jleaves)
        for got, want in zip(grads, jleaves):
            _close(got, want, TOL, "grad")

    each(case, ARCHS + ("zamba2-sites",))


def test_family_prefill_cache_and_decode_match_jax():
    """Prefill logits and every cache leaf, then 8 decode steps fed the
    reference's greedy tokens."""
    set_precision()
    each(_decode_case, ARCHS + ("zamba2-sites",))


@functools.lru_cache(maxsize=None)
def _jax_steps(arch):
    """The reference's prefill (``cache_extra`` static) and decode step,
    each compiled once a process for the arch."""
    japi, _ = _jax_models(arch)
    prefill = jax.jit(lambda p, b, extra: japi.prefill(
        p, b, dtype=jnp.float32, cache_extra=extra), static_argnums=2)
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(
        p, c, {"token": tok, "pos": pos}, dtype=jnp.float32))

    def decode(p, c, tok, pos):
        return step(p, c, jnp.asarray(tok), jnp.asarray(pos, jnp.int32))

    def prefill_np(p, batch, extra):
        return prefill(p, {k: jnp.asarray(v) for k, v in batch.items()},
                       extra)
    return prefill_np, decode


def _decode_case(arch):
    japi, jp, tapi, tp = _models(arch)
    b, prompt, n = 3, 32, 8
    batch = _batch(tapi.cfg, np.random.default_rng(2), b, prompt,
                   targets=False)
    jprefill, decode = _jax_steps(arch)
    jl, jcache = jprefill(jp, batch, n)
    tl, tcache = tapi.prefill(tp, {k: torch.tensor(v)
                                   for k, v in batch.items()},
                              cache_extra=n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=PREFILL_TOL)
    _close_cache(tcache, jcache, f"{arch} prefill cache")
    for i in range(n):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0]), i
        jl, jcache = decode(jp, jcache, tok, prompt + i)
        tl, tcache = tapi.decode_step(
            tp, tcache, {"token": torch.tensor(tok), "pos": prompt + i})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, err_msg=str(i))
    if tapi.cfg.kind == "ssm":
        _close_scaled(tcache, jcache, f"{arch} cache after decode")


def test_ssd_chunked_matches_jax():
    """Three chunks of 32 from a carried state: y and the final state
    within 1e-5, and the gradients of x, the decays, B, C, dt and the
    state of a weighted sum within 1e-5 relative plus 1e-5 of each
    gradient's largest entry absolute (the decays' gradient leaves
    through the cumsum's backward, a reverse cumulative sum whose f32
    rounding is relative to its largest partial sums); T = 48 at chunk
    32 raises in both packages."""
    ssm = get_config("zamba2-7b").reduced().ssm
    b, t, h, pd, n = 2, 96, 3, 8, ssm.state_dim
    rng = np.random.default_rng(5)
    ins = [rng.normal(size=(b, t, h, pd)),
           -np.abs(rng.normal(size=(b, t, h))) * 0.5,
           rng.normal(size=(b, t, n)), rng.normal(size=(b, t, n)),
           np.abs(rng.normal(size=(b, t, h))) * 0.3,
           rng.normal(size=(b, h, pd, n))]
    ins = [x.astype(np.float32) for x in ins]
    wy = rng.normal(size=(b, t, h, pd)).astype(np.float32)
    ws = rng.normal(size=(b, h, pd, n)).astype(np.float32)

    def jf(*xs):
        y, s = JMB.ssd_chunked(*xs[:5], ssm, xs[5])
        return jnp.sum(y * wy) + jnp.sum(s * ws), (y, s)

    (_, (jy, js)), jg = jax.jit(jax.value_and_grad(
        jf, argnums=tuple(range(6)), has_aux=True))(*map(jnp.asarray, ins))
    tins = [torch.tensor(x, requires_grad=True) for x in ins]
    ty, ts = TMB.ssd_chunked(*tins[:5], ssm, tins[5])
    obj = (ty * torch.tensor(wy)).sum() + (ts * torch.tensor(ws)).sum()
    tg = torch.autograd.grad(obj, tins)
    _close(ty, jy, TOL, "y")
    _close(ts, js, TOL, "state")
    for i, (got, want) in enumerate(zip(tg, jg)):
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=TOL,
            atol=TOL * float(np.abs(want).max()), err_msg=f"grad {i}")
    assert bool(torch.isfinite(torch.cat([g.flatten() for g in tg])).all())
    short = [x[:, :48] for x in ins[:5]]
    with pytest.raises(ValueError, match="not divisible"):
        JMB.ssd_chunked(*map(jnp.asarray, short), ssm)
    with pytest.raises(ValueError, match="not divisible"):
        TMB.ssd_chunked(*map(torch.tensor, short), ssm)


def test_prefill_equals_token_by_token_decode():
    """rwkv: the prompt through ``prefill`` and token by token through
    ``decode_step`` from a zero cache give the same last logits and
    cache; mamba: the mixer over the prompt and token by token from a
    zero cache give the same outputs and cache; in both packages, and
    the port's within 1e-5 of the reference's."""
    set_precision()
    japi, jp, tapi, tp = _models("rwkv6-3b")
    b, s = 2, 12
    toks = np.random.default_rng(6).integers(
        0, tapi.cfg.vocab_size, (b, s)).astype(np.int32)
    jprefill, jdecode = _jax_steps("rwkv6-3b")
    jl, jc = jprefill(jp, {"tokens": toks}, 0)
    tl, tc = tapi.prefill(tp, {"tokens": torch.tensor(toks)})
    jstep, tstep = japi.init_cache(b, s), tapi.init_cache(b, s,
                                                          device="cpu")
    for i in range(s):
        jsl, jstep = jdecode(jp, jstep, toks[:, i:i + 1], i)
        tsl, tstep = tapi.decode_step(tp, tstep, {
            "token": torch.tensor(toks[:, i:i + 1]), "pos": i})
    for got, want, what in ((jsl, jl, "jax"), (tsl, tl, "port"),
                            (tsl, jl, "port vs jax")):
        _close(got, want, TOL, f"rwkv logits {what}")
    _close_scaled(jstep, jc, "rwkv cache jax")
    _close_scaled(tstep, tc, "rwkv cache port")
    _close_scaled(tstep, jc, "rwkv cache port vs jax")

    japi, jp, tapi, tp = _models("zamba2-7b")
    cfg = tapi.cfg
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["mamba"])
    tlp = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in tp["mamba"].items()}
    x = np.random.default_rng(7).normal(size=(b, 32, cfg.d_model)).astype(
        np.float32)
    mixer = jax.jit(lambda xx, c: JMB.mixer_apply(jlp, xx, japi.cfg, c))
    jy, jcache = mixer(jnp.asarray(x), None)
    ty, tcache = TMB.mixer_apply(tlp, torch.tensor(x), cfg)
    jc = JMB.init_cache_layer(japi.cfg, b)
    tc = TMB.init_cache_layer(cfg, b, device="cpu")
    jys, tys = [], []
    for i in range(32):
        out, jc = mixer(jnp.asarray(x[:, i:i + 1]), jc)
        jys.append(out)
        out, tc = TMB.mixer_apply(tlp, torch.tensor(x[:, i:i + 1]), cfg, tc)
        tys.append(out)
    jys, tys = jnp.concatenate(jys, 1), torch.cat(tys, 1)
    for got, want, what in ((jys, jy, "jax"), (tys, ty, "port"),
                            (tys, jy, "port vs jax")):
        _close(got, want, TOL, f"mamba outputs {what}")
    _close_scaled(jc, jcache, "mamba cache jax")
    _close_scaled(tc, tcache, "mamba cache port")
    _close_scaled(tc, jcache, "mamba cache port vs jax")


ROUNDS, CLIENTS, SELECT, SEQ, SEQS = 2, 4, 2, 16, 2


def test_rwkv_train_rounds_match_jax(tmp_path, monkeypatch, capsys):
    """The reference's CLI at the reduced rwkv6-3b against the port's
    round loop from the reference's init on its shim's key chain: the
    same participants, losses and Ĥ from the head bias's update Δb."""
    out = tmp_path / "hist.json"
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "rwkv6-3b", "--rounds", str(ROUNDS),
        "--clients", str(CLIENTS), "--select", str(SELECT), "--seq-len",
        str(SEQ), "--seqs-per-client", str(SEQS), "--out", str(out)])
    jtrain.main()
    want = json.loads(out.read_text())
    _, _, tapi, tp = _models("rwkv6-3b")
    toks, _ = make_lm_streams(np.random.default_rng(0), tapi.cfg.vocab_size,
                              SEQ + 1, CLIENTS, SEQS, [0.05, 0.05, 0.05, 5.0])
    sel = make_selector("hics", num_clients=CLIENTS, num_select=SELECT,
                        total_rounds=ROUNDS, temperature=0.01,
                        num_classes=tapi.cfg.vocab_size, seed=0,
                        device="cpu")
    record = []
    _, got = ttrain.train_rounds(tapi, tp, torch.tensor(toks), sel,
                                 rounds=ROUNDS, lr=0.05, epochs=1,
                                 noise=ShimKeyChain(0, CLIENTS, SELECT),
                                 record=record)
    assert got["selected"] == want["selected"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(np.asarray(got["bias_entropy"]),
                               np.asarray(want["bias_entropy"]), atol=1e-4)
    for r in record:
        assert r["delta_b"].shape == (SELECT, tapi.cfg.vocab_size)
    capsys.readouterr()


def test_serve_batched_gives_jax_tokens(capsys):
    """seamless (frames then tokens) through the port's example on the
    reference's params against the reference example's loop on the same
    batch: every request's greedy tokens, free-running; the CLI runs
    rwkv (no attention: the kernel check is skipped and said so)."""
    set_precision()
    japi, jp, tapi, tp = _models("seamless-m4t-medium")
    b, s, gen = 3, 24, 8
    got = tserve_batched.serve_batched(tapi, tp, np.random.default_rng(0),
                                       b, s, gen, "cpu")
    batch = make_batch(tapi.cfg, np.random.default_rng(0), b, s, "cpu")
    assert tuple(batch["frames"].shape) == (b, s, tapi.cfg.d_model)
    prefill = jax.jit(make_prefill_step(japi, dtype=jnp.float32,
                                        cache_extra=gen))
    serve = jax.jit(make_serve_step(japi, dtype=jnp.float32))
    token, cache = prefill(jp, {k: jnp.asarray(v.numpy())
                                for k, v in batch.items()})
    want = [np.asarray(token)]
    for i in range(gen - 1):
        token, cache = serve(jp, cache, {"token": token,
                                         "pos": jnp.asarray(s + i,
                                                            jnp.int32)})
        want.append(np.asarray(token))
    assert np.array_equal(got["tokens"].numpy(), np.concatenate(want, 1))
    assert got["length"] == s + gen - 1
    assert got["kernel_max_abs_err"] == 0.0
    res = tserve_batched.main(["--arch", "rwkv6-3b", "--device", "cpu",
                               "--gen", "4"])
    assert res["tokens"].shape == (4, 4) and res["kernel_max_abs_err"] is None
    assert "not checked (rwkv6-3b-reduced has no attention heads)" in \
        capsys.readouterr().out
