"""FLOPs, HBM bytes and peak live bytes of one step, counted on the
``meta`` device: the port's counterpart of the reference's
``roofline/hlo_cost.py``, which parses XLA's optimized HLO.

:func:`count` runs a function whose tensors lie on ``meta`` (shapes and
dtypes, no storage, no kernel) under two dispatch modes:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``.  It counts the
  matmuls, convolutions and attention products (2·m·n·k a product) and
  no elementwise op or transcendental, where ``hlo_cost`` adds one
  FLOP an element of each transcendental.
* HBM bytes: :class:`ByteCounter`, the operand and result bytes of
  every aten op that touches memory (views, aliases and metadata ops
  move nothing and are skipped).  Each eager op reads its inputs from
  and writes its result to device memory, so the sum is an upper bound
  on what XLA's fusions move (``hlo_cost`` counts a fusion's operands
  and result once).
* Peak live bytes: the largest sum, over the run, of the bytes of the
  op results still referenced (by Python or by autograd's saved
  tensors), on top of what was live before (``base_bytes``): the meta
  pass's stand-in for XLA's ``memory_analysis``.

The Python loops of the eager model (layers, query chunks, the WKV
tokens) run their bodies once each, so every op is weighted by its trip
count by construction, as ``hlo_cost`` weights a ``while`` body.  The
dry run (``launch/dryrun.py``) counts each step at full depth: the peak
is no straight line in the layers (the phase that holds it at a few
layers need not hold it at 36), so no reduced depth stands in for it.
Only rwkv's WKV loop, four ops a token a layer, is counted at a few
short lengths and solved for the full one.

Under a device mesh (``count(..., mesh=True)``) the step's tensors are
``DTensor``s and one :class:`MeshCounter` counts at this rank's shapes:
it passes every op on DTensors through to DTensor (returns
``NotImplemented``), so it sees each op once, as the local op DTensor
runs on this rank's shard, with the collectives DTensor issues in
between.  FLOPs come from the formulas ``FlopCounterMode`` uses, bytes
and the peak as above, and each ``_c10d_functional`` collective adds
its result's bytes under the reference's ``parse_collectives`` kind
(:func:`collective_kind`).  The ops DTensor runs on fake tensors at the
global shapes, to learn an op's output, are not counted.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

aten = torch.ops.aten

#: ops that allocate or describe a tensor without moving its bytes
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.detach.default,
               aten.alias.default, aten.lift_fresh.default,
               aten.sym_size.int, aten.sym_stride.int, aten.sym_numel.default,
               aten.sym_storage_offset.default, aten.is_same_size.default,
               aten._local_scalar_dense.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


#: the counters of the :func:`count` calls running now
_ACTIVE: list = []


def phase(name: str) -> None:
    """Start phase ``name`` (say the backward pass, or the optimizer's
    update) of the step being counted: each phase's peak of live bytes
    is kept apart, since the step's peak is the largest of them and a
    different phase may hold it at another depth or batch.  A no-op
    outside :func:`count`."""
    for counter in _ACTIVE:
        counter.begin(name)


class ByteCounter(TorchDispatchMode):
    """Sums the operand and result bytes of every aten op that touches
    memory (``bytes``), and tracks the bytes of live op results
    (``live``, ``peak``, and each :func:`phase`'s own in
    ``phase_peaks``): a result counts from its op until its tensor is
    freed."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.ops = 0
        self.phase_peaks = {"forward": 0}
        self._phase = "forward"
        self._tracked = set()

    def begin(self, name: str) -> None:
        self._phase = name
        self.phase_peaks[name] = max(self.phase_peaks.get(name, 0),
                                     self.live)

    def _release(self, key, n):
        self._tracked.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if func in _NO_TRAFFIC or func.is_view:
            return out
        ins = tree_leaves((args, kwargs))
        outs = tree_leaves(out)
        self.bytes += sum(_nbytes(t) for t in ins) + sum(
            _nbytes(t) for t in outs)
        mutated = {id(t) for t in ins if isinstance(t, torch.Tensor)}
        for t in outs:
            if not isinstance(t, torch.Tensor) or id(t) in mutated:
                continue
            key = id(t)
            if key in self._tracked:
                continue
            n = _nbytes(t)
            self._tracked.add(key)
            self.live += n
            weakref.finalize(t, self._release, key, n)
        self.peak = max(self.peak, self.live)
        self.phase_peaks[self._phase] = max(self.phase_peaks[self._phase],
                                            self.live)
        return out


#: the reference's ``parse_collectives`` kinds
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND_OF = {"all_gather_into_tensor": "all-gather",
            "all_gather_into_tensor_out": "all-gather",
            "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
            "reduce_scatter_tensor": "reduce-scatter",
            "all_to_all_single": "all-to-all",
            "shard_dim_alltoall": "all-to-all"}
#: what a collective's result aliases or waits on: no traffic of its own
_COLLECTIVE_NO_TRAFFIC = ("wait_tensor", "_wrap_tensor_autograd")


def collective_kind(func):
    """The ``parse_collectives`` kind of a functional collective op, its
    own name for one of no such kind, None for any other op (and for
    the ops that only wait on or wrap a collective's result)."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "_c10d_functional_autograd",
                  "_dtensor"):
        return None
    name = func._opname
    if name in _COLLECTIVE_NO_TRAFFIC:
        return None
    return _KIND_OF.get(name, name)


def _add_collective(coll: Dict[str, float], func, out) -> None:
    """Add ``out``'s bytes to ``coll`` under ``func``'s kind, if it is a
    collective."""
    kind = collective_kind(func)
    if kind is not None:
        coll[kind] = coll.get(kind, 0.0) + sum(
            _nbytes(t) for t in tree_leaves(out))


def weighted_total(coll: Dict[str, float]) -> float:
    """The collectives' bytes with an all-reduce twice its size, as it
    moves on a ring (the reference's ``total_weighted``)."""
    return sum(v * (2.0 if k == "all-reduce" else 1.0)
               for k, v in coll.items() if k != "total_weighted")


class CollectiveCounter(TorchDispatchMode):
    """The result bytes of each collective by kind (``collectives``) of
    a run on real tensors, DTensor's ops passed through to it: what a
    sharded step moves between ranks, with no other count."""

    def __init__(self):
        super().__init__()
        self.collectives = {k: 0.0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        _add_collective(self.collectives, func, out)
        return out


class MeshCounter(ByteCounter):
    """:class:`ByteCounter` at one rank's shapes under DTensor, with the
    FLOPs of ``FlopCounterMode``'s formulas (``flops``) and the result
    bytes of each collective by kind (``collectives``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives = {k: 0.0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor's sharding propagation runs an op once at the
            # global shapes on fake tensors to learn its output: no
            # work of the step
            return func(*args, **(kwargs or {}))
        if func._opname in _COLLECTIVE_NO_TRAFFIC:
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **(kwargs or {}),
                                                out_val=out)
        _add_collective(self.collectives, func, out)
        return out


def count(fn: Callable[[], object], base_bytes: int = 0,
          mesh: bool = False) -> Dict[str, float]:
    """Run ``fn()`` (its tensors on ``meta``) and count it: {flops,
    hbm_bytes, peak_bytes (``base_bytes`` plus the peak of live
    results), phase_peaks (each :func:`phase`'s peak, on top of
    ``base_bytes`` as well), ops (aten ops dispatched)}.  ``mesh``: its
    tensors are DTensors, counted at this rank's shapes
    (:class:`MeshCounter`), and the counts add ``collectives`` (bytes by
    kind and ``total_weighted``)."""
    counter = MeshCounter() if mesh else ByteCounter()
    flops = None if mesh else FlopCounterMode(display=False)
    _ACTIVE.append(counter)
    try:
        with flops or contextlib.nullcontext(), counter:
            out = fn()
            del out
    finally:
        _ACTIVE.remove(counter)
    res = {"flops": float(counter.flops if mesh
                          else flops.get_total_flops()),
           "hbm_bytes": float(counter.bytes),
           "peak_bytes": float(base_bytes + counter.peak),
           "phase_peaks": {k: float(base_bytes + v)
                           for k, v in counter.phase_peaks.items()},
           "ops": counter.ops}
    if mesh:
        coll = dict(counter.collectives)
        coll["total_weighted"] = weighted_total(coll)
        res["collectives"] = coll
    return res

