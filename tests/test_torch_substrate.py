"""The rest of the LM substrate through the port, on the CPU, against
the JAX reference: the registry's specs, the roofline's useful FLOPs,
the compute dtype of every family, the train step, long-context decode,
the meta-device cost count, and the sweep CLI.

Tolerances, each against the reference's counterpart:
* ``_active_params``, ``model_flops``, ``input_specs``, ``cache_specs``,
  ``supports_shape`` and the params' shapes on ``meta``: equal, for
  every arch × shape.
* bf16 compute (reduced configs: qwen2.5-3b, granite-moe-1b-a400m,
  pixtral-12b, rwkv6-3b, zamba2-7b, seamless-m4t-medium): the loss
  within 2e-3 relative (measured worst 7.7e-4, granite), prefill and 4
  teacher-forced decode steps' logits within 0.1 absolute (logits of
  magnitude ~1–4; measured worst 5.5e-2, zamba2): XLA:CPU keeps f32
  between the bf16 ops it fuses, where eager torch rounds every op's
  result to bf16, so the two differ by a few bf16 steps of the
  activations, as the reference's own bf16 differs from its f32 by
  2.5e-2 to 4.9e-2.  granite's prefill within 0.5 (measured 0.35):
  there a token whose bf16 router probabilities nearly tie takes
  another expert, and under capacity 1.25 that moves other tokens'
  slots.  The greedy token is compared only where the reference's top
  two logits are 0.3 or more apart.
* One bf16 train step of reduced qwen2.5-3b (adam at lr 1e-4, the
  clip at 1.0, with and without the bf16 compute copy): the loss 2e-2
  relative, the global norm 5e-2 relative, every param after the step
  within 2.2e-4 of the reference's (a first adam step is ±lr wherever
  |g| ≫ eps, so a gradient whose bf16 rounding flips its sign moves a
  param by 2·lr), and 99% of them within 1e-6.
* ``long_context=True`` decode of a sliding-window config (reduced
  qwen2.5-3b, window 16) over 24 steps from an empty ring cache, f32:
  logits within 2e-2 (the bf16 cache), greedy tokens equal.
* ``roofline.cost`` on ``meta`` against ``repro.roofline.hlo_cost`` of
  the reference's compiled step (reduced qwen2.5-3b, B 2, S 64, bf16):
  FLOPs within 0.95–1.05 of the reference's (measured 0.9966 train,
  0.99999 prefill: the counter counts the products, ``hlo_cost`` adds
  one an element of each transcendental), bytes within 0.25–4 of the
  reference's (measured 1.25 train, 0.52 prefill: each eager op reads
  and writes device memory where XLA fuses, while ``hlo_cost`` charges
  a top-level op in a scanned layer every operand it reads whole, such
  as the stacked weights a layer slices).
* The one-card dry run's peak, at qwen2.5-3b's published width on
  ``meta`` (4 layers, train_4k at batch 1, 5 and 9): the record's peak
  is the largest of the step's phase peaks (forward, backward, the
  optimizer's update) and rises with the batch; ``fit_batch`` at
  decode_32k returns the largest batch counted within the limit.  rwkv's
  token recurrence solved from three short lengths against a direct
  count at 288 tokens (3 layers, full width): FLOPs, bytes and ops
  equal (1e-9 relative), each phase's peak within 3% (measured 0.979
  forward, 0.989 backward, the update exact).
* The sweep CLI at a tiny spec (``--device cpu``): ``--out`` equals the
  port's ``run_sweep`` of the same spec (participants, losses,
  accuracies, telemetry); ``--bench`` has the reference's keys (those
  of the committed ``BENCH_sweep.json``).

The module takes ~60–80 s alone in one process, most of it the
reference's compiles and the dry run's meta passes.
"""
import dataclasses
import functools
import json
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch.steps import make_prefill_step as jmake_prefill
from repro.launch.steps import make_train_step as jmake_train
from repro.models import cache_specs as jcache_specs
from repro.models import get_model as jax_model
from repro.models import input_specs as jinput_specs
from repro.models import supports_shape as jsupports
from repro.optim import adam as jadam
from repro.roofline import analysis as janalysis
from repro.roofline.hlo_cost import analyze as hlo_analyze
from repro_torch.backend import set_precision
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import sweep as tsweep
from repro_torch.launch.steps import (make_init_state, make_prefill_step,
                                      make_train_step)
from repro_torch.models import cache_specs, get_model, input_specs, \
    supports_shape
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import adam, tree_leaves, tree_map
from repro_torch.roofline import analysis, count
from repro_torch.scenarios import run_sweep
from torch_parity import each, to_np

FAMILIES = ("qwen2.5-3b", "granite-moe-1b-a400m", "pixtral-12b",
            "rwkv6-3b", "zamba2-7b", "seamless-m4t-medium")
LOSS_RTOL = 2e-3
LOGIT_TOL = 0.1
MOE_PREFILL_TOL = 0.5
TIE_GAP = 0.3
LR = 1e-4
FRAMES = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _lm_archs():
    return [a for a in list_archs() if get_config(a).kind != "classifier"]


def _dtype_name(dt) -> str:
    return str(dt).split(".")[-1]


def _same_spec(got, want, what):
    """A tree of meta tensors against a tree of ShapeDtypeStructs:
    the same keys, shapes and dtypes."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same_spec(got[k], want[k], f"{what}/{k}")
        return
    assert got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), what
    assert _dtype_name(got.dtype) == str(want.dtype), what


def test_model_flops_and_specs_are_the_references():
    for arch in _lm_archs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert analysis._active_params(cfg) == janalysis._active_params(jcfg)
        api, japi = get_model(cfg), jax_model(jcfg)
        params = api.init(device="meta")
        _same_spec(params, jax.eval_shape(japi.init, jax.random.PRNGKey(0)),
                   f"{arch} params")
        for name, shape in SHAPES.items():
            jshape = JSHAPES[name]
            assert analysis.model_flops(cfg, shape, shape.mode) == \
                janalysis.model_flops(jcfg, jshape, jshape.mode)
            assert supports_shape(cfg, shape) == jsupports(jcfg, jshape)
            for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                            (torch.float32, jnp.float32)):
                _same_spec(input_specs(cfg, shape, dt),
                           jinput_specs(jcfg, jshape, jdt),
                           f"{arch} {name} inputs")
            if shape.mode == "decode" and supports_shape(cfg, shape):
                _same_spec(cache_specs(cfg, shape),
                           jcache_specs(jcfg, jshape), f"{arch} {name} cache")
    assert analysis.HW_H100.peak_for(torch.bfloat16) == 989e12
    assert analysis.HW_H100.peak_for(torch.float32) == 67e12
    terms = analysis.roofline_terms(67e12, 3.35e12, dtype=torch.float32)
    assert terms["compute_s"] == terms["memory_s"] == 1.0
    assert terms["collective_s"] == 0.0


@functools.lru_cache(maxsize=None)
def _jax_models(arch, **changes):
    japi = jax_model(dataclasses.replace(jax_config(arch).reduced(),
                                         **changes))
    return japi, japi.init(jax.random.PRNGKey(0))


def _models(arch, **changes):
    japi, jp = _jax_models(arch, **changes)
    tcfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    assert dataclasses.asdict(japi.cfg) == dataclasses.asdict(tcfg)
    return japi, jp, get_model(tcfg), params_from_jax(to_np(jp), "cpu")


def _batch(cfg, rng, b, s, targets=True):
    """numpy inputs: a VLM's patches or an audio arch's frames, the
    tokens (B, S) and, for training, targets and a loss mask."""
    out = {}
    if cfg.vlm is not None:
        out["patches"] = rng.normal(size=(b, cfg.vlm.num_patches,
                                          cfg.vlm.patch_embed_dim)).astype(
            np.float32)
    if cfg.encdec is not None:
        out["frames"] = rng.normal(size=(b, FRAMES, cfg.d_model)).astype(
            np.float32)
    seq = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    out["tokens"] = seq[:, :-1]
    if targets:
        out["targets"] = seq[:, 1:]
        out["loss_mask"] = (rng.random((b, s)) > 0.2).astype(np.float32)
    return out


def _greedy_agrees(got, want):
    """The port's greedy tokens are the reference's wherever the
    reference's top two logits are TIE_GAP or more apart."""
    want = np.asarray(want, np.float32)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] >= TIE_GAP
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_bf16_loss_prefill_and_decode_match_jax():
    """Every family in bf16 against the reference in bf16."""
    set_precision()
    each(_bf16_case, FAMILIES)


def _bf16_case(arch):
    japi, jp, tapi, tp = _models(arch)
    cfg = tapi.cfg
    bf16 = jnp.bfloat16
    rng = np.random.default_rng(3)
    batch = _batch(cfg, rng, 2, 32)
    jl, _ = jax.jit(lambda p, b: japi.loss(p, b, dtype=bf16))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _ = tapi.loss(tp, {k: torch.tensor(v) for k, v in batch.items()},
                      dtype=torch.bfloat16)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)

    n, prompt = 4, 32
    pb = {k: v for k, v in batch.items()
          if k not in ("targets", "loss_mask")}
    jlog, jcache = jax.jit(lambda p, b: japi.prefill(
        p, b, dtype=bf16, cache_extra=n))(
            jp, {k: jnp.asarray(v) for k, v in pb.items()})
    tlog, tcache = tapi.prefill(tp, {k: torch.tensor(v)
                                     for k, v in pb.items()},
                                dtype=torch.bfloat16, cache_extra=n)
    np.testing.assert_allclose(
        tlog.numpy(), np.asarray(jlog), err_msg=f"{arch} prefill",
        atol=MOE_PREFILL_TOL if cfg.moe is not None else LOGIT_TOL)
    _greedy_agrees(tlog.numpy(), jlog)
    pos0 = prompt + (cfg.vlm.num_patches if cfg.vlm is not None else 0)
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(
        p, c, {"token": tok, "pos": pos}, dtype=bf16))
    for i in range(n):
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
        jlog, jcache = step(jp, jcache, jnp.asarray(tok),
                            jnp.asarray(pos0 + i, jnp.int32))
        tlog, tcache = tapi.decode_step(
            tp, tcache, {"token": torch.tensor(tok), "pos": pos0 + i},
            dtype=torch.bfloat16)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL,
                                   err_msg=f"{arch} decode {i}")
        _greedy_agrees(tlog.numpy(), jlog)


def test_train_step_matches_jax():
    """One bf16 train step (adam, the clip) of reduced qwen2.5-3b, with
    and without the bf16 compute copy of the params."""
    set_precision()
    japi, jp, tapi, _ = _models("qwen2.5-3b")
    batch = _batch(tapi.cfg, np.random.default_rng(4), 2, 32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    for cast in (False, True):
        jopt = jadam(LR)
        jstate = {"params": jp, "opt": jopt.init(jp),
                  "step": jnp.zeros((), jnp.int32)}
        jnew, jm = jax.jit(jmake_train(japi, jopt, dtype=jnp.bfloat16,
                                       cast_params_bf16=cast))(jstate, jb)
        topt = adam(LR)
        tp = params_from_jax(to_np(jp), "cpu")
        tstate = {"params": tp, "opt": topt.init(tp),
                  "step": torch.zeros((), dtype=torch.int32)}
        tnew, tm = make_train_step(tapi, topt, dtype=torch.bfloat16,
                                   cast_params_bf16=cast)(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=5e-2)
        assert int(tnew["step"]) == int(jnew["step"]) == 1
        assert int(tnew["opt"]["count"]) == 1
        got = np.concatenate([to_np(x).ravel()
                              for x in tree_leaves(tnew["params"])])
        want = np.concatenate([np.asarray(x, np.float32).ravel() for x in
                               jax.tree_util.tree_leaves(jnew["params"])])
        diff = np.abs(got - want)
        assert diff.max() <= 2.2 * LR, (cast, diff.max())
        assert (diff <= 1e-6).mean() >= 0.99, (cast, (diff <= 1e-6).mean())


def test_make_init_state_on_meta():
    api = get_model(get_config("qwen2.5-3b").reduced())
    state = make_init_state(api, adam(LR))(device="meta")
    n = len(tree_leaves(state["params"]))
    assert len(tree_leaves(state["opt"]["m"])) == n
    assert all(t.device.type == "meta" for t in tree_leaves(state))


def test_long_context_decode_matches_jax():
    """A ring cache of the long-context window (16) over 24 decode
    steps, f32 compute, teacher-forced by the reference's tokens."""
    set_precision()
    japi, jp, tapi, tp = _models("qwen2.5-3b", long_context_window=16)
    b, n = 2, 24
    jcache = japi.init_cache(b, 64, long_context=True)
    tcache = tapi.init_cache(b, 64, long_context=True, device="cpu")
    assert tcache["k"].shape[2] == jcache["k"].shape[2] == 16
    step = jax.jit(lambda p, c, tok, pos: japi.decode_step(
        p, c, {"token": tok, "pos": pos}, long_context=True))
    tok = np.zeros((b, 1), np.int32)
    for i in range(n):
        jlog, jcache = step(jp, jcache, jnp.asarray(tok),
                            jnp.asarray(i, jnp.int32))
        tlog, tcache = tapi.decode_step(
            tp, tcache, {"token": torch.tensor(tok), "pos": i},
            long_context=True)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=2e-2, err_msg=str(i))
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
        assert np.array_equal(tlog[:, -1].argmax(-1).numpy(), tok[:, 0])


def test_cost_count_against_hlo_cost():
    """The meta count of a train and a prefill step against the
    reference's trip-count-weighted HLO count at the same shape."""
    japi, jp = _jax_models("qwen2.5-3b")
    tapi = get_model(get_config("qwen2.5-3b").reduced())
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=64)
    jshape = dataclasses.replace(JSHAPES["train_4k"], global_batch=2,
                                 seq_len=64)
    jbatch = jinput_specs(japi.cfg, jshape)
    jopt = jadam(LR)
    jstate = jax.eval_shape(lambda: {
        "params": japi.init(jax.random.PRNGKey(0)),
        "opt": jopt.init(japi.init(jax.random.PRNGKey(0))),
        "step": jnp.zeros((), jnp.int32)})
    jtrain = hlo_analyze(jax.jit(jmake_train(japi, jopt, dtype=jnp.bfloat16))
                         .lower(jstate, jbatch).compile().as_text())
    topt = adam(LR)
    tstate = make_init_state(tapi, topt)(device="meta")
    tstep = make_train_step(tapi, topt, dtype=torch.bfloat16)
    tbatch = input_specs(tapi.cfg, shape)
    ttrain = count(lambda: tstep(tstate, tbatch))

    pshape = dataclasses.replace(JSHAPES["prefill_32k"], global_batch=2,
                                 seq_len=64)
    jparams = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(x.shape, jnp.bfloat16), jax.eval_shape(
            japi.init, jax.random.PRNGKey(0)))
    jpre = hlo_analyze(jax.jit(jmake_prefill(japi, dtype=jnp.bfloat16))
                       .lower(jparams, jinput_specs(japi.cfg, pshape))
                       .compile().as_text())
    tparams = tree_map(lambda t: t.to(torch.bfloat16),
                       tapi.init(device="meta"))
    tshape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=2,
                                 seq_len=64)
    tpre_step = make_prefill_step(tapi, dtype=torch.bfloat16)
    tbatch = input_specs(tapi.cfg, tshape)
    with torch.no_grad():
        tpre = count(lambda: tpre_step(tparams, tbatch))
    for got, want in ((ttrain, jtrain), (tpre, jpre)):
        assert 0.95 <= got["flops"] / want["flops"] <= 1.05, (got, want)
        assert 0.25 <= got["hbm_bytes"] / want["hbm_bytes"] <= 4.0, (
            got, want)


def test_dryrun_peak_is_the_largest_phase():
    cfg = dataclasses.replace(get_config("qwen2.5-3b"), num_layers=4)
    peaks = []
    for b in (1, 5, 9):
        rec = dryrun.run_combo("qwen2.5-3b", "train_4k", b, cfg=cfg)
        phases = rec["cost"]["phase_peak_bytes"]
        assert sorted(phases) == ["backward", "forward", "update"]
        assert rec["peak_live_bytes"] == max(phases.values())
        assert rec["peak_live_bytes"] > rec["state_bytes_global"]
        peaks.append(rec["peak_live_bytes"])
    assert peaks == sorted(peaks), peaks
    limit = 20e9
    fit = dryrun.fit_batch("qwen2.5-3b", "decode_32k", limit, top=64)
    counted = {int(k): v for k, v in fit["peaks"].items()}
    b = fit["batch"]
    assert 0 < b < 64 and counted[b] <= limit
    assert fit["record"]["global_batch"] == b
    assert all(v > limit for k, v in counted.items() if k > b)
    assert sorted(counted.values()) == [counted[k] for k in sorted(counted)]


def test_dryrun_recurrence_against_a_direct_count():
    cfg = dataclasses.replace(get_config("rwkv6-3b"), num_layers=3)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=288)
    got = dryrun.measure(cfg, shape)["cost"]
    assert len(got["extrapolated_from"]) == len(dryrun.RECUR_LENS)
    want, _, _ = dryrun._count(cfg, shape)
    for k in ("flops", "hbm_bytes", "ops"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    for k, v in want["phase_peaks"].items():
        np.testing.assert_allclose(got["phase_peak_bytes"][k], v,
                                   rtol=0.03, err_msg=k)


def test_sweep_cli_matches_run_sweep(tmp_path):
    args = ["--scenarios", "mixed_80_20", "dir_mild", "--selectors", "hics",
            "--seeds", "2", "--clients", "6", "--select", "2", "--rounds",
            "3", "--samples", "120", "--dim", "8", "--epochs", "1",
            "--host", "--device", "cpu", "--telemetry",
            str(tmp_path / "t.jsonl"), "--out", str(tmp_path / "out.json"),
            "--bench", str(tmp_path / "bench.json")]
    tsweep.main(args)
    out = json.loads((tmp_path / "out.json").read_text())
    spec = tsweep.specs(tsweep.parse_args(args),
                        ("selection", "training", "fairness"))[0]
    want = tsweep._sanitize(run_sweep(spec, device="cpu"))
    assert out["spec"] == json.loads(json.dumps(want["spec"]))
    for cell, c in want["grid"].items():
        got = out["grid"][cell]
        for key in c:
            if key != "wall_s":
                assert got[key] == json.loads(json.dumps(c[key])), (cell, key)
    bench = json.loads((tmp_path / "bench.json").read_text())
    ref = json.loads(open("BENCH_sweep.json").read())
    assert sorted(bench) == sorted(ref)
    for cell in bench["grid"].values():
        assert sorted(cell) == sorted(next(iter(ref["grid"].values())))
    assert (tmp_path / "t.jsonl").stat().st_size > 0



def test_mesh_dry_run_fsdp_at_two_reduced_layers():
    """The dry run on the 16×16 mesh under fsdp (a worker process with a
    fake world of 256 ranks), qwen2.5-3b reduced to 2 layers at
    train_4k: ``chips`` 256, all-gathers (the layers gathered for
    compute) and reduce-scatters (their gradients) counted, and the
    state a chip holds 1/256 of each leaf the specs shard 256 ways and
    the whole of each leaf they replicate (params, adam's m and v; the
    two scalars whole), no planning world left behind."""
    from repro_torch import sharding
    from repro_torch.launch import mesh as meshes
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              num_layers=2)
    rec = dryrun.mesh_combo_in_worker("qwen2.5-3b", "train_4k", "pod1",
                                      "fsdp", cfg=cfg)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["mesh"] == "pod1" and rec["policy"] == "fsdp"
    coll = rec["collectives_bytes"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["total_weighted"] == pytest.approx(
        sum(v for k, v in coll.items() if k != "total_weighted")
        + coll["all-reduce"])
    r = rec["roofline"]
    assert r["collective_s"] == pytest.approx(
        coll["total_weighted"] / analysis.HW_H100.link_bw)
    with meshes.planning_world(256):
        policy = sharding.ShardingPolicy(meshes.make_production_mesh(),
                                         "fsdp")
        params = get_model(cfg).init(device="meta")
        specs = sharding.param_pspecs(params, policy)
        leaves = tree_leaves(params)
        spec_leaves = [s for _, s in sorted(_spec_items(specs))]
    per_chip = 0
    for t, spec in zip(leaves, spec_leaves):
        n = t.numel() * 4
        assert all(e in (None, ("data", "model")) for e in spec)
        per_chip += n // 256 if any(spec) else n
    assert rec["state_bytes_per_chip"] == 3 * per_chip + 4 + 4
    assert rec["state_bytes_global"] == 3 * sum(
        t.numel() * 4 for t in leaves) + 4 + 4
    assert not torch.distributed.is_initialized()


def _spec_items(tree, prefix=""):
    """(path, spec) of a spec tree, paths sorted as ``tree_leaves``
    sorts keys."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _spec_items(tree[k], prefix + "/" + k)]
    return [(prefix, tree)]


def test_dry_run_cli_mesh_record_names(tmp_path):
    """``--mesh``/``--policy`` name a record ``<arch>__<shape>__<mesh>``
    (2d) or ``...__<policy>``; without ``--mesh`` the one-card name."""
    assert dryrun.record_path(tmp_path, "a", "s").name == "a__s.json"
    assert dryrun.record_path(tmp_path, "a", "s", "pod1").name == \
        "a__s__pod1.json"
    assert dryrun.record_path(tmp_path, "a", "s", "pod2", "fsdp").name == \
        "a__s__pod2__fsdp.json"
    assert dryrun.policy_for("auto", "train_4k") == "fsdp"
    assert dryrun.policy_for("auto", "decode_32k") == "2d"


def test_multihost_without_local(monkeypatch):
    """``multihost`` without ``--local``: ``--task dryrun`` plans the
    full config on a fake world of the mesh's size with no rendezvous
    and prints the mesh dry run's record (granite-moe decode_32k under
    fsdp on 16×16); ``--task train`` on a world of 1 (gloo, from
    torchrun's environment) raises, naming the mesh's 256 ranks and the
    world's 1, and leaves no process group."""
    from repro_torch.launch import multihost
    rec = multihost.main(["--task", "dryrun", "--arch",
                          "granite-moe-1b-a400m", "--shape", "decode_32k",
                          "--policy", "fsdp"])
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["collectives_bytes"]["all-gather"] > 0
    assert not torch.distributed.is_initialized()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                 "RANK": "0", "WORLD_SIZE": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match=r"needs 256 ranks.* has 1"):
        multihost.main(["--task", "train", "--device", "cpu", "--arch",
                        "qwen2.5-3b"])
    assert not torch.distributed.is_initialized()
