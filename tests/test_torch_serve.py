"""The port's LM serving path on the CPU against the JAX reference:
``layers.decode_attention`` on a bf16 cache, and the reduced qwen2.5-3b
(2 layers, d 256, H 4, KV 2, dh 64, vocab 512) from the reference's
params carried over by ``params_from_jax``: prefill, teacher-forced
decode steps and greedy tokens.

Tolerances:
* ``layers.decode_attention``: one bf16 rounding step, 2**-8 absolute
  plus 2**-8 relative.  Its output is rounded to bf16 on both sides
  (the probabilities are cast to the cache dtype before the value
  product), so one f32 rounding difference before that cast can move
  an output by one bf16 step; on this CPU the two agree exactly.
* Prefill logits: 1e-4 absolute.  All f32 (the prefill attends to its
  own f32 K/V), summed in another order; measured 3.5e-6.
* Decode logits: 2e-2 absolute.  The bf16 cache holds K/V computed in
  f32 by two libraries; where they differ in the last f32 bit at a bf16
  rounding boundary (~0.04% of cache entries) the cached entry differs
  by one bf16 step (2**-8 relative), which moves the logits (|logit|
  up to ~3.5) by up to 6.4e-3 over 8 steps (measured).
* Greedy tokens: identical.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jax_config
from repro.models import get_model as jax_model
from repro.models import layers as JL
from repro_torch.backend import set_precision
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.launch import serve
from repro_torch.models import get_model
from repro_torch.models import layers as TL
from repro_torch.models.transformer import params_from_jax
from torch_parity import each, to_np

ARCH = "qwen2.5-3b"
BF16_STEP = 2.0 ** -8
PREFILL_TOL = 1e-4
DECODE_TOL = 2e-2


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides: (jax array, torch tensor)."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).bfloat16()


def test_layers_decode_attention_matches_jax_on_bf16_cache():
    each(_decode_attention_case, [(2, 96, 2, 4, 64), (3, 40, 1, 2, 128)],
         [0, 5, 39, 70], [(0, False), (16, False), (0, True)])


def _decode_attention_case(shape, pos, window_ring):
    b, s, kv, g, dh = shape
    window, ring = window_ring
    if pos >= s and not ring:
        return
    rng = np.random.default_rng(pos + s)
    q = rng.normal(size=(b, 1, kv * g, dh)).astype(np.float32)
    jk, tk = _bf16(rng.normal(size=(b, s, kv, dh)))
    jv, tv = _bf16(rng.normal(size=(b, s, kv, dh)))
    want = JL.decode_attention(jnp.asarray(q), jk, jv, pos, window=window,
                               ring=ring)
    got = TL.decode_attention(torch.tensor(q), tk, tv, pos, window=window,
                              ring=ring)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_STEP, rtol=BF16_STEP)


def test_decode_kernel_plan_and_plain_take_any_dh():
    """The serve path's decode kernel at a dh off the 16-byte rows (4,
    36, 100, 260), G 1 and 8: ``decode_plan`` lays it out, and on the
    CPU the kernel's entry point (its plain version) agrees with the
    model's own decode attention on an f32 cache within 1e-5."""
    for dh in (4, 36, 100, 260):
        for g in (1, 8):
            plan = da.decode_plan(g, dh, 2)
            assert plan.copy_bytes == 2 and not plan.fixed
            b, s, kv, pos = 2, 40, 2, 29
            rng = np.random.default_rng(dh + g)
            q = torch.tensor(rng.normal(size=(b, 1, kv * g, dh)),
                             dtype=torch.float32)
            k, v = (torch.tensor(rng.normal(size=(b, s, kv, dh)),
                                 dtype=torch.float32) for _ in range(2))
            got = da.decode_attention(q[:, 0], k, v, pos + 1)
            want = TL.decode_attention(q, k, v, pos)[:, 0]
            np.testing.assert_allclose(got.numpy(), want.numpy(),
                                       atol=1e-5, rtol=1e-5)


def _models(sliding_window=0):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(),
                               sliding_window=sliding_window)
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               sliding_window=sliding_window)
    japi, tapi = jax_model(jcfg), get_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return japi, jparams, tapi, params_from_jax(to_np(jparams), "cpu")


def test_reduced_config_is_the_references():
    t, j = get_config(ARCH).reduced(), jax_config(ARCH).reduced()
    assert (t.num_layers, t.d_model, t.num_heads, t.num_kv_heads,
            t.resolved_head_dim(), t.d_ff, t.vocab_size) == \
        (2, 256, 4, 2, 64, 512, 512)
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads,
            full.num_kv_heads, full.resolved_head_dim(), full.d_ff,
            full.vocab_size, full.rope_theta, full.qkv_bias) == \
        (36, 2048, 16, 2, 128, 11008, 151_936, 1e6, True)


def test_prefill_and_teacher_forced_decode_match_jax():
    """Prefill logits and 8 decode steps fed the reference's greedy
    tokens; the port's greedy token equals the reference's at every
    step.  The sliding-window case (window 8 over 12 + 8 positions)
    decodes through the ring cache."""
    set_precision()
    each(_serve_case, [(0, 64), (8, 12)])


def _serve_case(window_prompt):
    (window, prompt), b, n = window_prompt, 4, 8
    japi, jparams, tapi, tparams = _models(window)
    toks = np.random.default_rng(1).integers(
        0, tapi.cfg.vocab_size, (b, prompt)).astype(np.int32)
    if window:
        # decode on a fresh ring cache from position 0, as the
        # reference's registry sizes it
        jcache = japi.init_cache(b, prompt + n)
        tcache = tapi.init_cache(b, prompt + n, device="cpu")
        assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
        assert tcache["k"].shape[2] == window
        steps = [(toks[:, i:i + 1], i) for i in range(prompt)]
        tok = None
    else:
        jl, jcache = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                  dtype=jnp.float32, cache_extra=n)
        tl, tcache = tapi.prefill(tparams, {"tokens": torch.tensor(toks)},
                                  cache_extra=n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=PREFILL_TOL)
        assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
        assert tcache["k"].dtype == torch.bfloat16
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        steps = []
    for i in range(n):
        steps.append((None, prompt + i))
    for given, pos in steps:
        tok_in = given if given is not None else tok
        jl, jcache = japi.decode_step(
            jparams, jcache, {"token": jnp.asarray(tok_in),
                              "pos": jnp.asarray(pos, jnp.int32)},
            dtype=jnp.float32)
        tl, tcache = tapi.decode_step(
            tparams, tcache, {"token": torch.tensor(tok_in), "pos": pos})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0]), pos


def test_greedy_generation_matches_jax():
    """The serve entry point's prefill + decode loop, run free (no teacher
    forcing): identical greedy tokens for every request."""
    set_precision()
    from repro.launch.steps import make_prefill_step, make_serve_step
    japi, jparams, tapi, tparams = _models()
    b, s, gen = 4, 32, 8
    toks = np.random.default_rng(2).integers(
        0, tapi.cfg.vocab_size, (b, s)).astype(np.int32)
    jprefill = make_prefill_step(japi, dtype=jnp.float32, cache_extra=gen)
    jserve = make_serve_step(japi, dtype=jnp.float32)
    token, cache = jprefill(jparams, {"tokens": jnp.asarray(toks)})
    want = [np.asarray(token)]
    for i in range(gen - 1):
        token, cache = jserve(jparams, cache,
                              {"token": token,
                               "pos": jnp.asarray(s + i, jnp.int32)})
        want.append(np.asarray(token))
    got = serve.generate(tapi, tparams, {"tokens": torch.tensor(toks)}, gen)
    assert np.array_equal(got["tokens"].numpy(),
                          np.concatenate(want, axis=1))
    assert got["length"] == s + gen - 1


def test_decode_matches_fresh_prefill():
    """Decoding the whole sequence token by token through an f32 cache
    gives the logits of one prefill over the extended sequence, as the
    reference's ``tests/test_decode_consistency.py`` holds it (2e-2,
    identical top-1); also through the bf16 cache that prefill leaves,
    decoding only the new tokens."""
    set_precision()
    tapi = get_model(get_config(ARCH).reduced())
    params = tapi.init(0, device="cpu")
    rng = np.random.default_rng(3)
    b, s, extra = 2, 24, 3
    toks = torch.tensor(rng.integers(0, tapi.cfg.vocab_size,
                                     (b, s + extra)), dtype=torch.int32)
    cache = tapi.init_cache(b, s + extra, dtype=torch.float32, device="cpu")
    for i in range(s + extra):
        last, cache = tapi.decode_step(params, cache,
                                       {"token": toks[:, i:i + 1], "pos": i})
    full, _ = tapi.prefill(params, {"tokens": toks})
    a, want = last[:, -1].numpy(), full[:, -1].numpy()
    np.testing.assert_allclose(a, want, atol=2e-2, rtol=2e-2)
    assert (a.argmax(-1) == want.argmax(-1)).all()

    _, cache = tapi.prefill(params, {"tokens": toks[:, :s]},
                            cache_extra=extra)
    for i in range(s, s + extra):
        last, cache = tapi.decode_step(params, cache,
                                       {"token": toks[:, i:i + 1], "pos": i})
    a = last[:, -1].numpy()
    np.testing.assert_allclose(a, want, atol=2e-2, rtol=2e-2)
    assert (a.argmax(-1) == want.argmax(-1)).all()


def test_init_matches_reference_layout_and_scale():
    """The port's own init has the reference's tree, shapes and
    per-tensor scale (truncated normal on [-2, 2] over sqrt(fan_in),
    embed 0.02, zero biases and norm scales)."""
    japi, jparams, tapi, _ = _models()
    params = tapi.init(0, device="cpu")
    jflat = dict(jax.tree_util.tree_flatten_with_path(jparams)[0])
    tflat = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tflat[path + (k,)] = v
    walk(params, ())
    jkeys = {tuple(p.key for p in path): v for path, v in jflat.items()}
    assert set(jkeys) == set(tflat)
    for key, jv in jkeys.items():
        t = tflat[key]
        assert tuple(t.shape) == jv.shape, key
        js, ts = float(np.std(np.asarray(jv))), float(t.std())
        assert abs(ts - js) <= 0.1 * js + 1e-12, (key, ts, js)
        assert float(t.abs().max()) <= 2.0 * max(
            float(np.abs(np.asarray(jv)).max()), 1e-12) + 1e-12, key


def test_cache_geometry_matches_jax():
    """Window and ring choice as the reference's registry makes it, with
    and without long context, for full attention and a sliding
    window."""
    from repro.models.transformer import cache_geometry as jgeom
    from repro.models.transformer import effective_window as jwin
    from repro_torch.models.transformer import (cache_geometry,
                                                effective_window)
    for window in (0, 16):
        t = dataclasses.replace(get_config(ARCH), sliding_window=window)
        j = dataclasses.replace(jax_config(ARCH), sliding_window=window)
        for seq_len in (8, 16, 4096, 5000, 1 << 62):
            for long_context in (False, True):
                assert cache_geometry(t, seq_len, long_context) == \
                    jgeom(j, seq_len, long_context)
                assert effective_window(t, seq_len, long_context) == \
                    jwin(j, seq_len, long_context)
    api = get_model(get_config(ARCH).reduced())
    assert api.init_cache(1, 5000, long_context=True,
                          device="cpu")["k"].shape[2] == 4096
    assert api.init_cache(1, 5000, device="cpu")["k"].shape[2] == 5000


def test_non_dense_configs_raise():
    """Every model kind of the reference builds, and the port registers
    the reference's archs; what the port still does not run raises
    ``NotImplementedError`` naming its ROADMAP.md item (nothing since
    every family takes a compute dtype and ``long_context``, as the
    reference's), a name neither package registers ``KeyError``, a
    classifier ``ValueError``; an audio arch through ``launch.train``
    fails as the reference's does (its batches carry no frames)."""
    from repro.configs import list_archs
    from repro.launch import train as jtrain
    from repro_torch.configs import list_archs as port_archs
    from repro_torch.launch import train as ttrain
    assert port_archs() == list_archs()
    kinds = {}
    for name in port_archs():
        cfg = get_config(name)
        if cfg.kind == "classifier":
            with pytest.raises(ValueError):
                get_model(name)
            continue
        kinds[cfg.kind] = get_model(name)
    assert sorted(kinds) == ["audio", "dense", "hybrid", "moe", "ssm", "vlm"]
    for api in kinds.values():
        for fn, names in ((api.loss, ("dtype",)), (api.prefill, ("dtype",)),
                          (api.decode_step, ("dtype", "long_context"))):
            params = inspect.signature(fn).parameters
            assert all(n in params for n in names), (api.cfg.name, fn)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch-7b")
    with pytest.raises(ValueError):
        get_model("paper-cnn")
    argv = ["--arch", "seamless-m4t-medium", "--rounds", "1", "--clients",
            "2", "--select", "1", "--seq-len", "8", "--seqs-per-client", "1"]
    with pytest.raises(KeyError, match="frames"):
        ttrain.main(argv + ["--device", "cpu"])
    japi = jax_model(jax_config("seamless-m4t-medium").reduced())
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.zeros(a.shape, a.dtype),
        jax.eval_shape(japi.init, jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="frames"):
        jtrain.local_lm_update(japi, jparams, jnp.zeros((1, 9), jnp.int32),
                               0.05, 1)


def test_full_attention_chunking_rule():
    """Tq <= 128 or a multiple of 128, as the reference: chunked and
    unchunked attention agree, and a ragged Tq raises."""
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.normal(size=(1, 256, 4, 16)), dtype=torch.float32)
    k = torch.tensor(rng.normal(size=(1, 256, 2, 16)), dtype=torch.float32)
    v = torch.tensor(rng.normal(size=(1, 256, 2, 16)), dtype=torch.float32)
    whole = TL.full_attention(q, k, v, causal=True, q_chunk=256)
    chunked = TL.full_attention(q, k, v, causal=True, q_chunk=128)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)
    want = JL.full_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                             jnp.asarray(v.numpy()), causal=True)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError):
        TL.full_attention(q[:, :200], k, v, causal=True)
