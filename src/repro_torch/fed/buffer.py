"""Fixed-capacity ring buffer for buffered-async FL, on the device.

The port of the reference's ``fed/buffer.py``: the async server's
aggregation queue.  Arrived client contributions (local params and Δb
row, tagged with client id and dispatch version) wait here until the
fill threshold fires.  A :class:`RingBuffer` is a named tuple of
fixed-shape tensors, so it rides the async tick's carry (and its CUDA
graph), and all three operations are shape-static and read nothing on
the host.

Invariants:

  * capacity B is static; ``fill`` ∈ [0, B]; the oldest entry lives at
    ``head``, the ``i``-th oldest at ``(head + i) mod B``.
  * ``push`` accepts masked candidate rows IN ROW ORDER (the caller
    orders them oldest-dispatch-first), appends until full, and counts
    the overflow it drops: arrivals are never silently lost.
  * ``pop(m)`` removes exactly the ``m`` oldest entries (FIFO).

The reference drops the overflow through an out-of-range scatter index
(``mode="drop"``), which torch has no form of.  The port writes by
gather instead: each slot finds the one accepted row that targets it
(accepted rows have distinct slots) and keeps its old value when none
does, so rejected rows are never written anywhere.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.optim import tree_leaves, tree_map


class RingBuffer(NamedTuple):
    """Fixed-capacity FIFO of client contributions.

    payload : dict tree with (B, ...) leaves (local params and a Δb row
              for the async server; opaque here).
    ids     : (B,) int32 — contributing client per slot.
    version : (B,) int32 — server version at the entry's dispatch.
    head    : () int32 — slot of the oldest entry.
    fill    : () int32 — live entries.
    """
    payload: Any
    ids: torch.Tensor
    version: torch.Tensor
    head: torch.Tensor
    fill: torch.Tensor


def buffer_init(capacity: int, payload_proto: Any) -> RingBuffer:
    """An empty buffer whose payload leaves are ``(B,) + proto.shape``
    zeros on the proto's device; ``payload_proto`` is ONE entry's tree
    (e.g. a params dict and a (C,) Δb row)."""
    b = int(capacity)
    if b < 1:
        raise ValueError(f"ring buffer capacity must be >= 1, got {b}")
    payload = tree_map(lambda l: torch.zeros((b,) + tuple(l.shape),
                                             dtype=l.dtype, device=l.device),
                       payload_proto)
    dev = tree_leaves(payload)[0].device
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return RingBuffer(payload=payload,
                      ids=torch.zeros(b, dtype=torch.int32, device=dev),
                      version=torch.zeros(b, dtype=torch.int32, device=dev),
                      head=z, fill=z.clone())


def buffer_push(buf: RingBuffer, mask: torch.Tensor, payload_rows: Any,
                ids: torch.Tensor, version: torch.Tensor,
                row_index: Optional[torch.Tensor] = None
                ) -> Tuple[RingBuffer, torch.Tensor, torch.Tensor]:
    """Append the masked candidate rows in row order; drop overflow.

    mask         : (R,) bool — which candidate rows arrived this tick.
    payload_rows : tree with leaves whose rows candidate r's payload is
                   row ``row_index[r]`` of (default r: (R, ...) leaves).
    ids, version : (R,) int.

    Returns ``(buffer, accepted, dropped)`` (0-d int32), accepted +
    dropped = mask.sum().  Rows are appended oldest-row-first, so the
    caller's row order IS the FIFO order.  Only the B slots' new rows
    are gathered from ``payload_rows``."""
    b = buf.ids.shape[0]
    dev = buf.ids.device
    mask = mask.to(torch.bool)
    seq = torch.cumsum(mask.to(torch.int32), 0) - 1  # rank among arrivals
    free = b - buf.fill
    accept = mask & (seq < free)
    slot = torch.remainder(buf.head + buf.fill + seq, b)
    # (B, R): candidate r fills slot j; at most one r a slot
    hit = accept[None, :] & (slot[None, :] == torch.arange(
        b, dtype=slot.dtype, device=dev)[:, None])
    has = hit.any(dim=1)
    src = torch.argmax(hit.to(torch.float32), dim=1)            # (B,)
    rows = src if row_index is None else row_index.index_select(0, src)

    def write(dst: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
        new = leaf.index_select(0, rows)
        keep = has.reshape((b,) + (1,) * (dst.dim() - 1))
        return torch.where(keep, new.to(dst.dtype), dst)

    accepted = accept.to(torch.int32).sum().to(torch.int32)
    dropped = mask.to(torch.int32).sum().to(torch.int32) - accepted
    buf = buf._replace(
        payload=tree_map(write, buf.payload, payload_rows),
        ids=torch.where(has, ids.to(torch.int32).index_select(0, src),
                        buf.ids),
        version=torch.where(has, version.to(torch.int32).index_select(
            0, src), buf.version),
        fill=buf.fill + accepted)
    return buf, accepted, dropped


def buffer_pop(buf: RingBuffer, m: int
               ) -> Tuple[Any, torch.Tensor, torch.Tensor, RingBuffer]:
    """Remove and return the ``m`` (static) oldest entries.

    Returns ``(payload, ids, version, buffer)`` with payload leaves
    ``(m, ...)`` in FIFO order.  The caller guarantees ``fill >= m``
    (the async server's fire condition does; its idle branch discards
    a pop it ran anyway)."""
    m = int(m)
    b = buf.ids.shape[0]
    idx = torch.remainder(buf.head + torch.arange(
        m, dtype=torch.int32, device=buf.ids.device), b).long()
    payload = tree_map(lambda l: l.index_select(0, idx), buf.payload)
    out_ids = buf.ids.index_select(0, idx)
    out_ver = buf.version.index_select(0, idx)
    buf = buf._replace(head=torch.remainder(buf.head + m, b),
                       fill=buf.fill - m)
    return payload, out_ids, out_ver, buf
