"""The port's multi-device layer (``repro_torch/sharding.py``,
``launch/mesh.py``, the steps on DTensors, ``roofline/cost.py``'s
collective count) against the reference's ``repro/sharding.py``.

* Placements: for every registered LM arch on the 16×16 and 2×16×16
  production meshes under "2d", "fsdp" and "ep", the port's param,
  cache and batch specs equal the reference's ``PartitionSpec``s on a
  ``jax.sharding.AbstractMesh``, leaf by leaf; the port's meshes are
  real ``DeviceMesh``es over a fake world of 256 or 512 ranks in this
  process (``planning_world``), and its per-rank state bytes equal the
  sum of the local shard sizes the reference's specs imply.
* A sharded step: four gloo ranks on a (2, 2) ("data", "model") mesh
  take a train step of a 2-layer narrow qwen and of a 2-layer MoE
  (mixtral's reduced config) under each mode, from the reference's
  weights: loss and gathered params within 1e-5 of the port's
  one-process unsharded step and of the reference's step.
* Collectives: none on a (1, 1) mesh; an FSDP gather of one (d, ff)
  leaf counted exactly; a count over DTensors sees each op once, at
  the local shapes.

Any process group lives in a subprocess or in a ``with`` block that
destroys it.
"""
import dataclasses
import socket

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.multiprocessing as mp
from jax.sharding import AbstractMesh, PartitionSpec

from repro import sharding as JS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch.steps import make_train_step as jmake_train
from repro.models import cache_specs as jcache_specs
from repro.models import get_model as jax_model
from repro.models import input_specs as jinput_specs
from repro.optim import adam as jadam
from repro_torch import sharding as TS
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.launch import mesh as meshes
from repro_torch.launch.steps import (make_init_state, make_train_step,
                                      shard_batch, shard_state)
from repro_torch.models import cache_specs, get_model, input_specs, \
    supports_shape
from repro_torch.models.transformer import params_from_jax
from repro_torch.optim import adam, tree_leaves
from repro_torch.roofline.cost import count
from torch_parity import to_np

MODES = ("2d", "fsdp", "ep")
LM_ARCHS = [a for a in list_archs() if get_config(a).kind != "classifier"]
#: the sharded step's tolerance, relative
STEP_TOL = 1e-5
LR, EPS = 1e-3, 1e-4


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {JS._path_str(p): tuple(v) if isinstance(v, PartitionSpec)
            else v for p, v in leaves}


def _tflat(tree, prefix="") -> dict:
    """The port's spec tree by path; a spec (a tuple of entries) is a
    leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tflat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_tflat(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


def _meshes():
    """(name, multi_pod, the reference's abstract mesh) of pod1, pod2."""
    for name, multi in (("pod1", False), ("pod2", True)):
        shape, names = meshes.mesh_layout(multi)
        yield name, multi, AbstractMesh(shape, names)


def _local_bytes(shape, spec, policy, itemsize=4) -> int:
    """The bytes of one rank's shard of a leaf laid out by ``spec``."""
    n = itemsize
    for d, entry in zip(shape, spec):
        n *= d // policy.axis_size(entry)
    return n


def test_specs_match_the_reference_every_arch_mesh_and_mode():
    """Param specs of ``api.init(device="meta")`` against the
    reference's on ``jax.eval_shape`` of its init (the shapes equal
    too), batch specs of every supported shape's inputs, cache specs of
    its decode caches: equal, leaf by leaf, for every registered LM arch
    on pod1 and pod2 under 2d, fsdp and ep."""
    jparams = {a: jax.eval_shape(lambda a=a: jax_model(jax_config(a)).init(
        jax.random.PRNGKey(0))) for a in LM_ARCHS}
    compared = 0
    for name, multi, amesh in _meshes():
        with meshes.planning_world(meshes.mesh_size(multi)):
            mesh = meshes.make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == tuple(amesh.axis_sizes)
            for mode in MODES:
                jpol = JS.ShardingPolicy(amesh, mode)
                tpol = TS.ShardingPolicy(mesh, mode)
                for arch in LM_ARCHS:
                    cfg, jcfg = get_config(arch), jax_config(arch)
                    tparams = get_model(cfg).init(device="meta")
                    shapes = {k: tuple(v.shape) for k, v in
                              _tflat(tparams).items()}
                    jshapes = {JS._path_str(p): tuple(v.shape) for p, v in
                               jax.tree_util.tree_flatten_with_path(
                                   jparams[arch])[0]}
                    assert shapes == jshapes, arch
                    want = _jflat(JS.param_pspecs(jparams[arch], jpol))
                    got = _tflat(TS.param_pspecs(tparams, tpol))
                    assert got == want, (arch, name, mode)
                    compared += len(got)
                    for sh, shape in SHAPES.items():
                        if not supports_shape(cfg, shape):
                            continue
                        got = _tflat(TS.batch_pspecs(
                            input_specs(cfg, shape), tpol))
                        want = _jflat(JS.batch_pspecs(
                            jinput_specs(jcfg, JSHAPES[sh]), jpol))
                        assert got == want, (arch, sh, name, mode)
                        if shape.mode != "decode":
                            continue
                        got = _tflat(TS.cache_pspecs(
                            cache_specs(cfg, shape), tpol))
                        want = _jflat(JS.cache_pspecs(
                            jcache_specs(jcfg, JSHAPES[sh]), jpol))
                        assert got == want, (arch, sh, name, mode)
                        compared += len(got)
    assert compared > 1000


def test_per_rank_state_bytes_match_the_reference_specs():
    """Every arch's f32 params distributed as DTensors (on ``meta``) by
    the port's specs hold, on a rank, the sum of the local shard sizes
    the reference's specs imply; a spec's axes divide their dim (no
    uneven shard), so every rank holds as much."""
    for name, multi, amesh in _meshes():
        with meshes.planning_world(meshes.mesh_size(multi)):
            mesh = meshes.make_production_mesh(multi_pod=multi)
            for mode in MODES:
                jpol = JS.ShardingPolicy(amesh, mode)
                tpol = TS.ShardingPolicy(mesh, mode)
                for arch in LM_ARCHS:
                    tparams = get_model(get_config(arch)).init(
                        device="meta")
                    specs = TS.param_pspecs(tparams, tpol)
                    placed = TS.to_shardings(tparams, specs, tpol)
                    jspecs = _jflat(JS.param_pspecs(jax.eval_shape(
                        lambda: jax_model(jax_config(arch)).init(
                            jax.random.PRNGKey(0))), jpol))
                    shapes = {k: tuple(v.shape) for k, v in
                              _tflat(tparams).items()}
                    want = sum(_local_bytes(shapes[k], s, tpol)
                               for k, s in jspecs.items())
                    assert TS.local_bytes(placed) == want, (arch, name,
                                                            mode)
                    total = sum(int(np.prod(s)) * 4 for s in shapes.values())
                    assert want < total


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _narrow(arch):
    """The arch's reduced config at 2 layers (narrow widths)."""
    return dataclasses.replace(get_config(arch).reduced(), num_layers=2)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b, s = 4, 32
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "targets": rng.integers(0, cfg.vocab_size, (b, s)),
            "loss_mask": np.ones((b, s), np.float32)}


def _torch_batch(batch):
    return {k: torch.tensor(v, dtype=torch.float32 if k == "loss_mask"
                            else torch.int32) for k, v in batch.items()}


def _sharded_ranks(rank, world, port, cases, out):
    """One gloo rank: each case's (arch, mode, weights, batch) train
    step on the (2, 2) mesh; rank 0 puts (loss, gathered params)."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = meshes.make_mesh((2, 2), ("data", "model"), "cpu")
        for arch, mode, weights, batch in cases:
            api = get_model(_narrow(arch))
            opt = adam(LR, eps=EPS)
            policy = TS.ShardingPolicy(mesh, mode)
            state = {"params": params_from_jax(weights, "cpu"),
                     "step": torch.zeros((), dtype=torch.int32)}
            state["opt"] = opt.init(state["params"])
            state = shard_state(state, policy)
            step = make_train_step(api, opt, dtype=torch.float32)
            with TS.use_policy(policy):
                state, metrics = step(state, shard_batch(
                    _torch_batch(batch), policy))
            params = TS.gather(state["params"])
            if rank == 0:
                out.put((arch, mode, float(metrics["loss"]),
                         [t.numpy() for t in tree_leaves(params)],
                         dict(TS.REPLICATED_OPS)))
    finally:
        dist.destroy_process_group()


def test_sharded_train_step_on_four_gloo_ranks():
    """A 2-layer narrow qwen and a 2-layer MoE (mixtral reduced: 4
    experts, top 2) take one f32 train step (adam, lr 1e-3, eps 1e-4,
    the clip, per-layer recompute) on four gloo ranks, mesh (2, 2),
    under 2d, fsdp and ep, from the reference's init: the loss within
    1e-5 relative and every gathered param within 1e-5 of the params'
    largest magnitude, against the port's one-process unsharded step
    and the reference's step on the same weights and batch.  Adam's eps
    is 1e-4 so that a gradient at rounding level (~1e-7) cannot flip an
    element's first step of ±lr."""
    torch.set_num_threads(1)
    cases, refs = [], {}
    for arch in ("qwen2.5-3b", "mixtral-8x22b"):
        jcfg = dataclasses.replace(jax_config(arch).reduced(), num_layers=2)
        japi = jax_model(jcfg)
        jparams = japi.init(jax.random.PRNGKey(0))
        weights = to_np(jparams)
        batch = _batch(jcfg)
        jopt = jadam(LR, eps=EPS)
        jstate = {"params": jparams, "opt": jopt.init(jparams),
                  "step": jnp.zeros((), jnp.int32)}
        jnew, jm = jax.jit(jmake_train(japi, jopt, dtype=jnp.float32))(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        api = get_model(_narrow(arch))
        opt = adam(LR, eps=EPS)
        state = {"params": params_from_jax(weights, "cpu"),
                 "step": torch.zeros((), dtype=torch.int32)}
        state["opt"] = opt.init(state["params"])
        new, m = make_train_step(api, opt, dtype=torch.float32)(
            state, _torch_batch(batch))
        refs[arch] = {
            "port": (float(m["loss"]),
                     [t.numpy() for t in tree_leaves(new["params"])]),
            "reference": (float(jm["loss"]), [np.asarray(v) for v in
                                              tree_leaves(to_np(
                                                  jnew["params"]))])}
        cases += [(arch, mode, weights, batch) for mode in MODES]
    out = mp.get_context("spawn").Queue()
    ranks = mp.start_processes(_sharded_ranks,
                               args=(4, _free_port(), cases, out),
                               nprocs=4, start_method="spawn", join=False)
    results = [out.get(timeout=300) for _ in cases]
    while not ranks.join():
        pass
    for arch, mode, loss, params, replicated in results:
        assert not replicated, (arch, mode, replicated)
        for side, (want_loss, want) in refs[arch].items():
            assert abs(loss - want_loss) <= STEP_TOL * abs(want_loss), (
                arch, mode, side, loss, want_loss)
            assert len(params) == len(want)
            scale = max(np.abs(w).max() for w in want)
            err = max(np.abs(got - w).max() for got, w in zip(params, want))
            assert err <= STEP_TOL * scale, (arch, mode, side, err, scale)


def test_no_collectives_on_the_host_mesh():
    """A bf16 train step of the reduced qwen on DTensors over the
    (1, 1) mesh of a one-rank world moves no collective byte: every
    placement on a size-1 mesh dim is Replicate."""
    with meshes.planning_world(1):
        mesh = meshes.make_host_mesh("cpu")
        cfg = get_config("qwen2.5-3b").reduced()
        api = get_model(cfg)
        for mode in MODES:
            policy = TS.ShardingPolicy(mesh, mode)
            opt = adam(1e-4)
            state = shard_state(make_init_state(api, opt)(device="meta"),
                                policy)
            batch = shard_batch(input_specs(cfg, dataclasses.replace(
                SHAPES["train_4k"], global_batch=2, seq_len=64)), policy)
            step = make_train_step(api, opt, dtype=torch.bfloat16)

            def run():
                with TS.use_policy(policy):
                    return step(state, batch)
            counts = count(run, mesh=True)
            assert counts["flops"] > 0
            assert all(v == 0 for v in counts["collectives"].values()), (
                mode, counts["collectives"])


def test_fsdp_gather_of_one_leaf_is_counted_exactly():
    """On a (2, 2) mesh under fsdp, a (d, ff) = (64, 128) f32 leaf at
    'mlp/wi0' shards d over ("data", "model") (16 rows a rank); gathering
    it for compute is DTensor's two all-gathers, over 'model' (16 -> 32
    rows) then 'data' (32 -> 64): result bytes (32 + 64)·128·4 = 49,152,
    and nothing else is moved."""
    with meshes.planning_world(4):
        mesh = meshes.make_mesh((2, 2), ("data", "model"))
        policy = TS.ShardingPolicy(mesh, "fsdp")
        tree = {"mlp": {"wi0": torch.empty(64, 128, device="meta")}}
        placed = TS.to_shardings(tree, TS.param_pspecs(tree, policy),
                                 policy)
        leaf = placed["mlp"]["wi0"]
        assert TS.param_pspecs(tree, policy)["mlp"]["wi0"] == (
            ("data", "model"), None)
        assert tuple(leaf.to_local().shape) == (16, 128)

        def run():
            with TS.use_policy(policy):
                return TS.gather_for_compute(placed)
        coll = count(run, mesh=True)["collectives"]
        assert coll["all-gather"] == (32 + 64) * 128 * 4
        assert coll["total_weighted"] == coll["all-gather"]


def test_a_count_over_dtensors_sees_each_op_once_at_local_shapes():
    """x (8, 16) sharded on rows over 'data' @ w (16, 32) sharded on
    columns over 'model', on a (2, 2) mesh: one local product of
    (4, 16) @ (16, 16), 2·4·16·16 FLOPs, counted once (not the global
    product's 2·8·16·32, and not both), with no collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with meshes.planning_world(4):
        mesh = meshes.make_mesh((2, 2), ("data", "model"))
        x = distribute_tensor(torch.empty(8, 16, device="meta"), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(16, 32, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        counts = count(lambda: x @ w, mesh=True)
        assert counts["flops"] == 2 * 4 * 16 * 16
        assert counts["collectives"]["total_weighted"] == 0
        assert counts["hbm_bytes"] == (4 * 16 + 16 * 16 + 4 * 16) * 4


def test_planning_world_is_torn_down_and_checks_the_mesh_size():
    """No process group outlives ``planning_world``; a mesh of another
    size than the world raises, naming both sizes."""
    import torch.distributed as dist
    with meshes.planning_world(4):
        with pytest.raises(ValueError, match=r"\(16, 16\) needs 256 ranks"
                           r".* has 4"):
            meshes.make_production_mesh()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        meshes.make_host_mesh("cpu")
