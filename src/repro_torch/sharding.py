"""Sharding policy: logical-axis rules mapping params and activations
onto a device mesh, the port of the reference's ``sharding.py``, with
``DTensor`` placements where the reference has ``PartitionSpec``s.

* Params: FSDP over the data-parallel axes + tensor-parallel over
  'model', chosen per leaf by ordered path rules with a divisibility
  fallback (the seamless 256,206 vocab cannot shard 16 ways and stays
  replicated on that dim).  DTensor's uneven sharding is never used.
* Activations: the models call :func:`constrain` with logical names;
  outside a policy (unit tests, one device) it does nothing.  Inside
  one it redistributes a ``DTensor`` to the spec's placements, the
  counterpart of ``with_sharding_constraint``.
* Attention: heads shard over 'model' when they divide (Megatron),
  otherwise the query sequence does (sequence parallelism): needed by
  deepseek-coder-33b (56 heads) and mixtral-8x22b (48 heads).

A spec is a tuple in the reference's ``PartitionSpec`` layout: an entry
a tensor dim, each None, one mesh axis name or a tuple of names (major
first).  :func:`placements` turns it into one ``Shard``/``Replicate``
a mesh dim.
"""
from __future__ import annotations

import re
from collections import Counter
from contextlib import contextmanager
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

# ---------------------------------------------------------------------------
# Policy
# ---------------------------------------------------------------------------


class ShardingPolicy:
    """Maps logical axis names -> mesh axis names for one mesh.

    ``mode`` selects the parallelism scheme:
      "2d"   — FSDP over (pod, data) × tensor-parallel over 'model'
      "fsdp" — every mesh axis is a data/FSDP axis; params are fully
               sharded and gathered layer by layer, activations never
               cross ranks
      "ep"   — experts over 'pod', batch over 'data', ff over 'model'
    """

    def __init__(self, mesh, mode: str = "2d"):
        if mode not in ("2d", "fsdp", "ep"):
            raise ValueError(f"unknown sharding mode {mode!r}")
        self.mesh = mesh
        self.mode = mode
        names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(names, mesh.shape))
        self.ep_axis: Optional[str] = None
        if mode == "fsdp":
            self.dp_axes = tuple(a for a in ("pod", "data", "model")
                                 if a in names)
            self.tp_axis = None
        elif mode == "ep":
            self.dp_axes = ("data",) if "data" in names else ()
            self.tp_axis = "model" if "model" in names else None
            self.ep_axis = "pod" if "pod" in names else None
        else:
            self.dp_axes: Tuple[str, ...] = tuple(
                a for a in ("pod", "data") if a in names)
            self.tp_axis: Optional[str] = ("model" if "model" in names
                                           else None)
        self.logical = {
            "expert": self.ep_axis,
            "batch": self.dp_axes or None,
            "fsdp": self.dp_axes or None,
            "tp": self.tp_axis,
            "ff": self.tp_axis,
            "heads": self.tp_axis,
            "vocab": self.tp_axis,
            "qseq": self.tp_axis,       # sequence parallelism (attention)
            "kvseq": self.dp_axes or None,  # long-context cache sharding
            "seq": None,
            "embed": None,
        }

    def axis_size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def resolve(self, dim: int, logical_name):
        """Mesh axes for one dim, or None when not divisible/unmapped."""
        if logical_name is None:
            return None
        axes = self.logical.get(logical_name)
        if axes is None:
            return None
        if dim % self.axis_size(axes) != 0:
            return None
        return axes

    def spec(self, shape: Sequence[int],
             logical: Sequence[Optional[str]]) -> tuple:
        assert len(shape) == len(logical), (shape, logical)
        return _spec(self.resolve(d, n) for d, n in zip(shape, logical))


def _spec(entries) -> tuple:
    """A spec of these entries, a tuple of one axis name given as the
    name, as ``PartitionSpec`` keeps it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def placements(spec: tuple, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    each mesh dim that dim d of the spec names, ``Replicate()`` on the
    others.  A dim over several axes shards over them major first, as
    JAX orders them, which is DTensor's order where the axes come in
    the mesh's order.  A mesh dim of size 1 replicates: a shard over one
    rank is the whole tensor, and so no collective ever runs over it."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return out


_CURRENT: Optional[ShardingPolicy] = None


#: the ops DTensor could not shard, by name, and how often each ran
#: replicated instead (:class:`ReplicateFallback`)
REPLICATED_OPS: Counter = Counter()
#: the views DTensor chose on global strides its local shard did not
#: share, by name, and how often each viewed a contiguous copy
COPIED_VIEWS: Counter = Counter()


_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)


class ReplicateFallback(TorchDispatchMode):
    """Runs a DTensor op that DTensor has no sharding strategy for (or
    whose strategy fails) on replicated operands: each DTensor operand
    is gathered whole, the op runs on the local tensors, and its result
    is a replicated DTensor (an in-place op writes its result back to
    its operand's own placements).  GSPMD replicates such an op the
    same way.  Each op so run is counted in :data:`REPLICATED_OPS`.  A
    view DTensor chose on the global strides that the local shard does
    not share (a permuted shard) views a contiguous copy instead,
    counted in :data:`COPIED_VIEWS`."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except (NotImplementedError, RuntimeError, AssertionError) as e:
            if func in _VIEWS and "view size is not compatible" in str(e):
                # DTensor chose a view on the global strides that a
                # permuted shard does not share: view a contiguous copy
                COPIED_VIEWS[str(func.overloadpacket)] += 1
                x = args[0]
                x = DTensor.from_local(x.to_local().contiguous(),
                                       x.device_mesh, x.placements,
                                       run_check=False, shape=x.shape,
                                       stride=x.stride())
                return func(x, *args[1:], **kwargs)
            if not any(w in str(e).lower() for w in (
                    "strateg", "shard", "partial", "redistribut")):
                raise
        REPLICATED_OPS[str(func.overloadpacket)] += 1
        dts = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, DTensor)]
        mesh = dts[0].device_mesh
        whole = [Replicate()] * mesh.ndim

        def local(a):
            return (a.redistribute(mesh, whole).to_local()
                    if isinstance(a, DTensor) else a)

        out = func(*tree_map(local, args), **tree_map(local, kwargs))
        mutated = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if mutated:
            target = kwargs.get(mutated[0], args[0] if args else None)
            if isinstance(target, DTensor):
                back = DTensor.from_local(out, mesh, whole, run_check=False)
                target.to_local().copy_(back.redistribute(
                    mesh, target.placements).to_local())
                return target
        return tree_map(lambda o: DTensor.from_local(o, mesh, whole,
                                                     run_check=False)
                        if isinstance(o, torch.Tensor) else o, out)


@contextmanager
def use_policy(policy: Optional[ShardingPolicy]):
    """Run the block under ``policy``: :func:`constrain` applies it, a
    plain tensor that meets a DTensor in an op (a constant the model
    builds, such as RoPE's angles) counts as replicated, as a constant
    is under GSPMD, and an op DTensor cannot shard runs replicated
    (:class:`ReplicateFallback`)."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, policy
    try:
        if policy is None:
            yield policy
        else:
            with implicit_replication(), ReplicateFallback():
                yield policy
    finally:
        _CURRENT = prev


def current_policy() -> Optional[ShardingPolicy]:
    return _CURRENT


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``want``, and so is its gradient, as JAX
    constrains a cotangent to its primal's sharding: a partial sum
    arriving in the backward pass is reduced here, where the forward
    pass reduced, rather than carried back to where DTensor would
    gather a weight to meet it."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        if list(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and list(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def constrain(x, *logical):
    """Redistribute a DTensor, and its gradient, to the spec of its
    logical dim names (the reference's ``with_sharding_constraint``); a
    no-op outside a policy and on a plain tensor."""
    pol = _CURRENT
    if pol is None or not isinstance(x, DTensor):
        return x
    want = placements(pol.spec(x.shape, logical), pol.mesh)
    return _Constrain.apply(x, pol.mesh, want)


def constrain_attn_q(q):
    """q: (B, T, H, dh). Megatron head sharding if divisible, else query-
    sequence parallelism over the model axis."""
    pol = _CURRENT
    if pol is None:
        return q
    B, T, H, dh = q.shape
    tp = pol.tp_axis
    if tp is not None and H % pol.axis_size(tp) == 0:
        return constrain(q, "batch", "seq", "heads", None)
    if tp is not None and T % pol.axis_size(tp) == 0 and T > 1:
        return constrain(q, "batch", "qseq", None, None)
    return constrain(q, "batch", "seq", None, None)


def replicate_dim(x, dim: int):
    """``x`` with no mesh dim sharding tensor dim ``dim`` (an
    all-gather over those), the others kept: what slicing or splitting
    along a sharded dim needs first.  A plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.dim()
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def _contiguous_stride(shape) -> tuple:
    return torch.empty(tuple(shape), device="meta").stride()


def _put(local, mesh, where, shape):
    """A DTensor of global ``shape`` (contiguous) over this rank's
    ``local`` shard, placed ``where``."""
    shape = tuple(shape)
    return DTensor.from_local(local, mesh, where, run_check=False,
                              shape=shape, stride=_contiguous_stride(shape))


def unbind_layers(x):
    """``torch.unbind(x, 0)`` of a stacked leaf (layers on dim 0); a
    DTensor's layer dim gathered first (``replicate_dim``), then its
    local shard split, each slice a DTensor with the other dims'
    sharding (DTensor's own unbind gathers every dim)."""
    if not isinstance(x, DTensor):
        return torch.unbind(x, 0)
    x = replicate_dim(x, 0)
    mesh = x.device_mesh
    inner = [Shard(p.dim - 1) if isinstance(p, Shard) else p
             for p in x.placements]
    return tuple(_put(t, mesh, inner, x.shape[1:])
                 for t in x.to_local().unbind(0))


def split_heads(t, heads: int, dh: int):
    """``t`` (B, T, heads·dh) as (B, T, heads, dh).  Where a DTensor's
    features are sharded over a mesh dim whose size does not divide
    the heads (a shard would cut a head), that sharding moves to the
    sequence first (an all-to-all), or is gathered where the sequence
    does not divide either; DTensor's own view gathers it whole."""
    b, s = t.shape[:2]
    if isinstance(t, DTensor):
        mesh = t.device_mesh
        want = list(t.placements)
        on_seq = 1
        for i, p in enumerate(want):
            if isinstance(p, Shard) and p.dim == 1:
                on_seq *= mesh.size(i)
        for i, p in enumerate(want):
            n = mesh.size(i)
            if isinstance(p, Shard) and p.dim == 2 and heads % n:
                fits = s % (on_seq * n) == 0
                want[i] = Shard(1) if fits else Replicate()
                on_seq *= n if fits else 1
        if want != list(t.placements):
            t = t.redistribute(mesh, want)
        return _local_reshape(t, (b, s, heads, dh))
    return t.reshape(b, s, heads, dh)


def merge_heads(t):
    """``t`` (B, T, H, dh) as (B, T, H·dh), a DTensor's shards reshaped
    on each rank (its heads' sharding becomes the features').  A
    sharded query sequence then moves to the features (an all-to-all),
    as Megatron's row-parallel output product takes them: the product
    flattens (B, T), which DTensor cannot do with T sharded (torch
    2.11 gathers it whole)."""
    b, s, h, dh = t.shape
    if not isinstance(t, DTensor):
        return t.reshape(b, s, h * dh)
    mesh = t.device_mesh
    t = t.redistribute(mesh, [
        p if isinstance(p, Shard) and p.dim < 3 else Replicate()
        for p in t.placements])
    t = _local_reshape(t, (b, s, h * dh))
    want, n = [], 1
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == 2:
            n *= mesh.size(i)
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and p.dim == 1:
            fits = (h * dh) % (n * mesh.size(i)) == 0
            n *= mesh.size(i) if fits else 1
            p = Shard(2) if fits else Replicate()
        want.append(p)
    return t if want == list(t.placements) else t.redistribute(mesh, want)


def _local_reshape(t, shape):
    """A DTensor reshaped on each rank: its sharded dims stay where
    they are and only the last dims split or merge, so the shards'
    placements carry over (DTensor's own view strategy gathers some
    such views whole, by torch version)."""
    sizes = list(shape)
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            sizes[p.dim] //= t.device_mesh.size(i)
    return _put(t.to_local().reshape(sizes), t.device_mesh, t.placements,
                shape)


def _shard_offset(x, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` of
    a DTensor (0 where no mesh dim shards it)."""
    mesh, off, size = x.device_mesh, 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(i)
            off += mesh.get_local_rank(i) * size
    return off


def _sharded_on(x, dim: int) -> list:
    """The mesh dims that shard tensor dim ``dim`` of a DTensor."""
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a shard's
    gradient re-enters DTensor, whose views need a contiguous local
    tensor."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def local_attention(attend, q, k, v):
    """``attend(q, k, v, q0)`` on each rank's shard, for q (B, Tq, H,
    dh) sharded over batch and over heads or the query sequence, and k,
    v (B, Tk, KV, dh): k and v take q's batch sharding, shard their KV
    heads where q shards its heads and KV divides, and are whole on
    every other mesh dim; ``q0`` is the global position of the rank's
    first query.  Each rank's heads keep their GQA group (a rank with
    fewer heads than a group takes its one KV head).  The result has
    q's placements.  The attention itself, chunks and all, runs on
    local tensors, with no DTensor op inside."""
    mesh = q.device_mesh
    qp = [p if isinstance(p, Shard) and p.dim in (0, 1, 2) else Replicate()
          for p in q.placements]
    q = q.redistribute(mesh, qp)
    h, kv = q.shape[2], k.shape[2]
    group = h // kv
    heads = _sharded_on(q, 2)
    n_heads = 1
    for i in heads:
        n_heads *= mesh.size(i)
    h_local = h // n_heads
    kv_split = kv % n_heads == 0
    kp = []
    for i, p in enumerate(qp):
        if isinstance(p, Shard) and p.dim == 0:
            kp.append(Shard(0))
        elif isinstance(p, Shard) and p.dim == 2 and kv_split:
            kp.append(Shard(2))
        else:
            kp.append(Replicate())
    if heads and not kv_split and not (h_local % group == 0
                                       or group % h_local == 0):
        raise ValueError(f"{h_local} heads a rank split GQA groups of "
                         f"{group}")
    # a rank's gradient of a K/V it holds whole but uses in part
    grad = [Partial() if isinstance(a, Shard) and isinstance(b, Replicate)
            else b for a, b in zip(qp, kp)]
    k, v = (t.redistribute(mesh, kp) for t in (k, v))
    ql = _ContiguousGrad.apply(q.to_local())
    kl = _ContiguousGrad.apply(k.to_local(grad_placements=grad))
    vl = _ContiguousGrad.apply(v.to_local(grad_placements=grad))
    if heads and not kv_split:
        first = _shard_offset(q, 2) // group
        n = max(1, h_local // group)
        kl, vl = kl[:, :, first:first + n], vl[:, :, first:first + n]
    return _put(attend(ql, kl, vl, _shard_offset(q, 1)), mesh, qp, q.shape)


def rowwise(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` of tensors whose rows (dim 0) are
    independent, as the MoE dispatch's batch rows are: each DTensor
    argument is placed as the first one shards its rows (over the same
    mesh dims, whole on the others), ``fn`` runs on each rank's rows,
    and its result is placed so.  DTensor's own index ops gather such
    operands whole.  Plain tensors as they are."""
    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return fn(*args, **kwargs)
    mesh = dts[0].device_mesh
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in dts[0].placements]
    local = [_ContiguousGrad.apply(a.redistribute(mesh, rows).to_local())
             if isinstance(a, DTensor) else a for a in args]
    out = fn(*local, **kwargs)
    n = 1
    for i, p in enumerate(rows):
        if isinstance(p, Shard):
            n *= mesh.size(i)
    return _put(out, mesh, rows, (out.shape[0] * n, *out.shape[1:]))


def local_decode_attention(attend, q, k_cache, v_cache):
    """One-token attention ``attend(q, k, v, s0) -> (scores, p_v)`` on
    each rank's shard of a cache laid out by :func:`cache_pspecs`:
    batch over the data axes, KV heads over 'model' or, where they do
    not divide, the cache's positions.  q (B, 1, H, dh) takes the
    cache's batch and head sharding; where positions are sharded each
    rank attends to its own (``s0`` its first) and the softmax is
    merged across them with all-reduces of the max, the sum and the
    weighted values (flash-decoding).  ``attend`` returns the masked f32
    scores (B, KV, G, 1, S_local) and a function of the probabilities
    giving their product with v (B, 1, H, dh)."""
    mesh = k_cache.device_mesh
    cp = list(k_cache.placements)
    qp = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else
          Shard(2) if isinstance(p, Shard) and p.dim == 2 else Replicate()
          for p in cp]
    q = q.redistribute(mesh, qp)
    seq = _sharded_on(k_cache, 1)
    s, pv = attend(q.to_local(), k_cache.to_local(), v_cache.to_local(),
                   _shard_offset(k_cache, 1))
    if not seq:     # every position on this rank: the softmax as it is
        out = pv(torch.softmax(s, dim=-1))
    else:
        groups = [(mesh, i) for i in seq]
        m = torch.amax(s, dim=-1, keepdim=True)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        e = torch.exp(s - m)
        den = e.sum(dim=-1, keepdim=True)
        for g in groups:
            den = funcol.all_reduce(den, "sum", g)
        out = pv(e / den)
        dt = out.dtype
        out = out.float()
        for g in groups:
            out = funcol.all_reduce(out, "sum", g)
        out = out.to(dt)
    return _put(out, mesh, qp, (q.shape[0], 1, q.shape[2], q.shape[3]))


def _vocab_layout(logits):
    """(logits placed with only their rows and vocabulary sharded, the
    mesh dims sharding the vocabulary, the rows' placements)."""
    mesh = logits.device_mesh
    lp = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in logits.placements]
    logits = logits.redistribute(mesh, lp)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in lp]
    return logits, _sharded_on(logits, 2), rows


def vocab_terms(logits, targets):
    """(logsumexp over the vocabulary, the target's logit; each (B, C))
    of logits (B, C, V): ``torch.logsumexp`` and ``gather``.  On a
    DTensor each rank computes its own rows (DTensor's gather would
    build its gradient at the global shape), and where the vocabulary
    is sharded (the head's vocab-parallel product) the logsumexp is
    reduced across the shards (its max shift detached) and the target
    logit taken on the rank holding it (0 elsewhere, then summed across
    the shards); no shard of the logits moves."""
    if not isinstance(logits, DTensor):
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, targets.long()[..., None])[..., 0])
    mesh = logits.device_mesh
    logits, split, rows = _vocab_layout(logits)
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
    t = targets.redistribute(mesh, rows).to_local().long()[..., None]
    local = logits.to_local()
    shape = tuple(logits.shape[:2])
    if not split:
        return (_put(torch.logsumexp(local, dim=-1), mesh, rows, shape),
                _put(local.gather(-1, t)[..., 0], mesh, rows, shape))
    m = logits.detach().amax(dim=-1, keepdim=True)
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    v0, n = _shard_offset(logits, 2), local.shape[-1]
    inside = (t >= v0) & (t < v0 + n)
    tgt = local.gather(-1, torch.clamp(t - v0, 0, n - 1)) * inside
    tgt = _put(tgt[..., 0], mesh, [Partial() if i in split else p
                                   for i, p in enumerate(rows)], shape)
    return logz, tgt.redistribute(mesh, rows)


def vocab_argmax(logits):
    """``logits.argmax(-1)`` of logits (B, C, V), ties to the lower
    index; of a DTensor each rank's rows, and of a sharded vocabulary
    the shards' maxima merged with all-reduces (the value, then the
    lowest index holding it)."""
    if not isinstance(logits, DTensor):
        return logits.argmax(dim=-1)
    mesh = logits.device_mesh
    logits, split, rows = _vocab_layout(logits)
    local = logits.to_local()
    shape = tuple(logits.shape[:2])
    with torch.no_grad():
        if not split:
            return _put(local.argmax(dim=-1), mesh, rows, shape)
        v0 = _shard_offset(logits, 2)
        best, idx = local.max(dim=-1)
        top = best
        for i in split:
            top = funcol.all_reduce(top, "max", (mesh, i))
        idx = torch.where(best == top, idx + v0, logits.shape[-1])
        for i in split:
            idx = funcol.all_reduce(idx, "min", (mesh, i))
    return _put(idx, mesh, rows, shape)


def write_slot(cache, new, idx: int):
    """Write ``new`` (B, 1, KV, dh) at position ``idx`` of a DTensor
    cache (B, S, KV, dh) in place: ``new`` takes the cache's batch and
    head placements, and only the rank whose positions hold ``idx``
    writes."""
    mesh = cache.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in cache.placements]
    local = new.redistribute(mesh, want).to_local()
    s0, n = _shard_offset(cache, 1), cache.to_local().shape[1]
    if s0 <= idx < s0 + n:
        cache.to_local()[:, idx - s0] = local[:, 0].to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Param partition rules (ordered; first match wins)
# ---------------------------------------------------------------------------

# Each rule: (path_regex, logical names for the TRAILING dims). Leading
# (stacked-layer) dims get None. "fsdp" -> dp axes, "tp" -> model axis.
_PARAM_RULES = [
    (r"embed$",            ("fsdp", "tp")),       # (V, d)
    (r"lm_head/w$",        ("fsdp", "tp")),       # (d, V): V -> model
    (r"lm_head/b$",        ("tp",)),              # (V,)
    (r"projector/w$",      ("fsdp", "tp")),
    (r"(wq|wk|wv|wi0|wi1|in_proj|w1|key|receptance|value_ff|gate)$",
                           ("fsdp", "tp")),
    (r"(wo|out_proj|w2|value_out)$", ("tp", "fsdp")),
    (r"router$",           ("fsdp", None)),
    # Expert weights: in "2d" mode shard only over 'model' (ff); in
    # "fsdp" mode there is no tp axis and the experts must not
    # replicate (mixtral: 141B params), so d shards over the fsdp axes
    # instead — see _MOE_FSDP_RULES.
    (r"moe/wi[01]$",       (None, None, "tp")),   # (E, d, ff)
    (r"moe/wo$",           (None, "tp", None)),   # (E, ff, d)
    (r"conv_w$",           ("tp", None)),          # (conv_dim, width)
]

_MOE_FSDP_RULES = [
    (r"moe/wi[01]$",       (None, "fsdp", None)),  # (E, d, ff)
    (r"moe/wo$",           (None, None, "fsdp")),  # (E, ff, d)
]

_MOE_EP_RULES = [
    (r"moe/wi[01]$",       ("expert", None, "tp")),  # (E, d, ff)
    (r"moe/wo$",           ("expert", "tp", None)),  # (E, ff, d)
]


def _leaf_logical(path: str, ndim: int,
                  mode: str = "2d") -> Tuple[Optional[str], ...]:
    if mode == "fsdp":
        rules = _MOE_FSDP_RULES + _PARAM_RULES
    elif mode == "ep":
        rules = _MOE_EP_RULES + _PARAM_RULES
    else:
        rules = _PARAM_RULES
    for pat, trailing in rules:
        if re.search(pat, path):
            t = tuple(trailing)
            if len(t) > ndim:
                t = t[-ndim:]
            return (None,) * (ndim - len(t)) + t
    if ndim >= 2:   # generic fallback: FSDP x TP on the last two dims
        return (None,) * (ndim - 2) + ("fsdp", "tp")
    return (None,) * ndim


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, the
    path its keys joined by '/' as the reference's ``_path_str``."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else
                                 str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, f"{prefix}/{i}" if prefix
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def gather_for_compute(params, prefix: str = ""):
    """A layer's params as the step computes with them: each DTensor
    leaf gathered over the FSDP axes (its spec with "fsdp" dropped),
    its tensor-parallel and expert sharding kept (ZeRO-3's all-gather
    of a layer before use; its gradient comes back as a reduce-scatter).
    The leaves' paths are the layer's own ('attn/wq', 'moe/wi0'), which
    the rules match by their last names, after ``prefix`` (a leaf's own
    name where ``params`` is one tensor, as 'embed').  As it is outside
    a policy."""
    pol = _CURRENT
    if pol is None:
        return params

    def leaf(path, t):
        if not isinstance(t, DTensor):
            return t
        logical = tuple(None if n == "fsdp" else n for n in
                        _leaf_logical(path, t.dim(), pol.mode))
        want = placements(pol.spec(t.shape, logical), pol.mesh)
        if list(t.placements) == want:
            return t
        return t.redistribute(pol.mesh, want)
    return map_with_path(leaf, params, prefix)


def embed_table(params):
    """The token embedding table, gathered for compute."""
    return gather_for_compute(params["embed"], "embed")


def embed_lookup(params, tokens):
    """``params['embed'][tokens]``: under a policy each rank looks up its
    own tokens in the table gathered for compute, so the gradient is a
    local scatter-add reduced over the data axes (DTensor's own index
    gathers every rank's tokens and gradients)."""
    table = embed_table(params)
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    tp, out, grad = list(table.placements), [], []
    for i, (t, w) in enumerate(zip(tokens.placements, tp)):
        if isinstance(w, Shard) and w.dim == 0:
            raise ValueError("the embedding's vocabulary must be whole")
        by_tok = isinstance(t, Shard) and t.dim == 0
        out.append(Shard(0) if by_tok else
                   Shard(tokens.dim()) if isinstance(w, Shard) else
                   Replicate())
        grad.append(Partial() if by_tok and isinstance(w, Replicate)
                    else w)
    if any(isinstance(t, Shard) and t.dim == 0 and isinstance(w, Shard)
           for t, w in zip(tokens.placements, tp)):
        raise ValueError("tokens and the embedding are sharded on one axis")
    local = table.to_local(grad_placements=grad)[tokens.to_local().long()]
    return _put(local, mesh, out, (*tokens.shape, table.shape[1]))


def param_pspecs(params, policy: ShardingPolicy):
    """The spec tree matching ``params`` (any leaves with a shape)."""
    def leaf_spec(path, leaf):
        logical = _leaf_logical(path, len(leaf.shape), policy.mode)
        return policy.spec(leaf.shape, logical)
    return map_with_path(leaf_spec, params)


# ---------------------------------------------------------------------------
# Batch / cache partition specs (dry-run + drivers)
# ---------------------------------------------------------------------------


def batch_pspecs(batch, policy: ShardingPolicy):
    """Inputs: leading dim is global batch (dp-sharded when divisible);
    a leaf with no shape (decode's ``pos``) gets None."""
    def leaf_spec(path, leaf):
        if not hasattr(leaf, "shape"):
            return None
        if len(leaf.shape) == 0:
            return ()
        dp = policy.resolve(leaf.shape[0], "batch")
        return _spec((dp, *([None] * (len(leaf.shape) - 1))))
    return map_with_path(leaf_spec, batch)


def _kv_cache_spec(shape, policy: ShardingPolicy) -> tuple:
    """(L, B, S, KV, dh): batch->dp, heads->tp, with fallbacks onto S."""
    _, B, S, KV, _ = shape
    dp = policy.resolve(B, "batch")
    s_axes = []
    if dp is None and policy.dp_axes:
        s_axes.extend(policy.dp_axes)
    tp = policy.tp_axis
    kv_ax = None
    if tp is not None:
        if KV % policy.axis_size(tp) == 0:
            kv_ax = tp
        else:
            s_axes.append(tp)
    s_ax = tuple(s_axes) or None
    if s_ax is not None and S % policy.axis_size(s_ax) != 0:
        s_ax = None
    return _spec((None, dp, s_ax, kv_ax, None))


def constrain_kv(t):
    """One layer's prefill K or V (B, T, KV, dh) placed as the decode
    cache lays it out (:func:`_kv_cache_spec`: batch over the data
    axes, KV heads over 'model' or, where they do not divide, the
    positions), so that the prefill's cache is born sharded; a no-op
    outside a policy."""
    pol = _CURRENT
    if pol is None or not isinstance(t, DTensor):
        return t
    spec = _kv_cache_spec((1, *t.shape), pol)[1:]
    return _Constrain.apply(t, pol.mesh, placements(spec, pol.mesh))


def cache_pspecs(cache, policy: ShardingPolicy):
    """Decode-cache tree specs (KV caches, SSM states, conv states)."""
    def leaf_spec(path, leaf):
        name = path.split("/")[-1]
        shp = tuple(leaf.shape)
        ndim = len(shp)
        if name in ("k", "v", "xk", "xv") and ndim == 5:
            return _kv_cache_spec(shp, policy)
        if name == "state" and ndim == 5:      # (L, B, H, *, *)
            dp = policy.resolve(shp[1], "batch")
            tp = policy.resolve(shp[2], "heads")
            return _spec((None, dp, tp, None, None))
        if name == "conv" and ndim == 4:       # (L, B, W-1, C)
            dp = policy.resolve(shp[1], "batch")
            tp = policy.resolve(shp[3], "ff")
            return _spec((None, dp, None, tp))
        if ndim >= 2:                          # e.g. xp_att (L, B, d)
            dp = policy.resolve(shp[1], "batch") if ndim >= 3 else None
            return _spec((None, dp, *([None] * (ndim - 2))))
        return (None,) * ndim
    return map_with_path(leaf_spec, cache)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def to_shardings(tree, pspecs, policy: ShardingPolicy):
    """Distribute each tensor of ``tree`` (meta tensors included) over
    the policy's mesh by its spec in ``pspecs``, as DTensors; a leaf
    that is no tensor, or whose spec is None, stays as it is.  On a
    real process group every rank takes rank 0's values; on a mesh of
    one rank the DTensor wraps the tensor itself."""
    mesh = policy.mesh

    def put(leaf, spec):
        if not isinstance(leaf, torch.Tensor) or spec is None:
            return leaf
        where = placements(spec, mesh)
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, where)
        if mesh.size() == 1:      # one rank: the tensor itself, no copy
            return DTensor.from_local(leaf, mesh, where, run_check=False)
        return distribute_tensor(leaf, mesh, where)
    return _zip_map(put, tree, pspecs)


def local_bytes(tree) -> int:
    """The bytes of this rank's shards of a tree's tensors (a plain
    tensor whole)."""
    n = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def gather(tree):
    """A tree of DTensors as plain full tensors (an all-gather each)."""
    return torch.utils._pytree.tree_map(
        lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)
