"""The production meshes as ``torch.distributed`` device meshes, the port
of the reference's ``launch/mesh.py``.

Functions, not module constants: importing this module starts no
process group.  :func:`make_production_mesh` lays the current process
group out as the reference's 16×16 ("data", "model") pod, or its
2×16×16 ("pod", "data", "model") pair of pods; :func:`make_host_mesh`
is the (1, 1) mesh of one process.

:func:`planning_world` stands in for the reference's
``--xla_force_host_platform_device_count=512``: it starts, in the
current process, a process group of n ranks on torch's ``fake``
backend, which does no communication.  This process is rank 0 of it,
so a ``DTensor`` on a mesh over it holds rank 0's shard, and what runs
on it runs at one rank's shapes, as a compiled SPMD program does.  The
group is destroyed when the block ends.  On a CPU mesh DTensor lowers an
all-to-all to an all-gather and a chunk (gloo has no all-to-all); inside
the block a ``meta`` tensor takes DTensor's own all-to-all op, as NCCL
does, so a count on ``meta`` sees what the card would run.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import placement_types as _placements

POD = ((16, 16), ("data", "model"))
TWO_PODS = ((2, 16, 16), ("pod", "data", "model"))
HOST = ((1, 1), ("data", "model"))


def mesh_layout(multi_pod: bool = False) -> tuple:
    """(shape, axis names) of a production mesh."""
    return TWO_PODS if multi_pod else POD


def mesh_size(multi_pod: bool = False) -> int:
    shape, _ = mesh_layout(multi_pod)
    n = 1
    for s in shape:
        n *= s
    return n


def _device_type(device_type) -> str:
    """The mesh's device type: the caller's, else cuda under NCCL and
    cpu under any other backend (gloo, fake)."""
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """16×16 (256 ranks) a pod, or 2×16×16 (512), over the current
    process group, whose world size must be the mesh's."""
    shape, names = mesh_layout(multi_pod)
    return make_mesh(shape, names, device_type)


def make_host_mesh(device_type: str | None = None) -> DeviceMesh:
    """The (1, 1) ("data", "model") mesh of a one-process group, on the
    current device."""
    return make_mesh(*HOST, device_type)


def make_mesh(shape, names, device_type: str | None = None) -> DeviceMesh:
    """A mesh of ``shape`` with axis ``names`` over the current process
    group; raises, naming both sizes, where the world is not the
    mesh's size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (torchrun, "
                           "init_process_group or planning_world) first")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"the mesh {tuple(shape)} needs {n} ranks, the "
                         f"process group has {world}")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


@contextmanager
def planning_world(n: int):
    """A process group of ``n`` ranks on the ``fake`` backend in this
    process (rank 0), for planning at production size with no devices
    and no communication; destroyed on exit.  Raises where a process
    group is already running."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process")
    # the fake backend registers itself where its store is defined
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    cpu_alltoall = _placements.shard_dim_alltoall
    _placements.shard_dim_alltoall = _meta_alltoall(cpu_alltoall)
    try:
        yield
    finally:
        _placements.shard_dim_alltoall = cpu_alltoall
        dist.destroy_process_group()


def _meta_alltoall(cpu_alltoall):
    """DTensor's shard-to-shard all-to-all, as its own op on ``meta``
    (the op NCCL runs), else as DTensor does it."""
    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if input.device.type != "meta":
            return cpu_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            funcol._resolve_group_name((mesh, mesh_dim)))
    return alltoall

