"""One-token GQA attention against a (B, S, KV, dh) cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:
_decode_kernel`` (via ``decode_attention_pallas``) with
``csrc/decode_attention.cu``, a flash-decoding kernel for the H100: S
is split into :func:`decode_splits` runs of 32-position tiles, one
block per (batch, KV head, chunk of its query heads, split); each warp
streams its rows of every tile through a ``cp.async`` ring in the
cache's stored type and applies each staged K and V value, read once,
to all the chunk's query heads held in registers; a second launch
merges the splits' partial (m, l, acc) in increasing split order.
:func:`decode_plan` chunks a KV head's G query heads so that the
registers hold them (one chunk for every registered config) and picks
the lane width and the ring's stages for any dh from 1 to 512, as the
TPU kernel takes: a dh off the 16-byte rows pads its ring rows to a
multiple of 8 values and copies them 4 (f32) or 2 (bf16) bytes at a time
(:attr:`DecodePlan.copy_bytes`).  It reads the valid part of K and V once,
so on the H100 it is bound by memory bytes.  The source's note says
what each part of the design does about that.

On CPU tensors :func:`decode_attention` takes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); on CUDA tensors
it launches the kernel or raises.  The two differ at length 0: the
kernel returns 0 (it divides by max(l, 1e-30), as the TPU kernel does),
the plain version NaN (a softmax over all -inf).
:func:`repro_torch.kernels.ref.decode_attention_split_ref` is the plain
version of the split itself.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import build, ref

#: shared memory a block may use on Hopper (227 KB), and what one SM
#: holds for its resident blocks (228 KB, 1 KB of it reserved a block)
SMEM_LIMIT = 232_448
SM_SMEM = 233_472
BLOCK_RESERVED = 1024
WARPS, PW, STAGES = 4, 8, 3   # as in csrc/decode_attention.cu
BS = ref.DECODE_TILE          # = WARPS * PW cache positions per tile
#: the kernel's ``__launch_bounds__(128, 3)``: registers for 3 blocks
MAX_RESIDENT = 3
#: fewest tiles a split takes when there is more than one split
MIN_SPLIT_TILES = 2
#: the share of whole waves the blocks must fill before more splits
#: stop paying for themselves
WAVE_FILL = 0.9
#: the stored row widths the kernel is built for with a compile-time
#: row width; any other dh up to :data:`MAX_HEAD_DIM` takes the runtime
#: width
HEAD_DIMS = (64, 112, 128, 256)
MAX_HEAD_DIM = 512
#: GP·32·E, the values of q (and of the accumulators) the registers of
#: a warp hold: 32 floats a lane (zamba2's G 1 -> GP 2 at E 4: 256)
MAX_GROUP_WIDTH = 1024


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How the kernel lays out one KV head's G query heads of width dh:
    ``chunks`` blocks of ``gc`` heads (the last may hold fewer), each
    padded to ``gp``; ``e`` values a lane; ``stages`` tiles in each
    warp's ring; ``fixed`` for the registered widths' compile-time
    row; ``copy_bytes`` the bytes of one copy of a K/V row into the
    ring: 16 where dh is a multiple of 8, else 4 (f32) or 2 (bf16), the
    ring row then padded to :func:`ring_row`."""
    g: int
    dh: int
    gc: int
    chunks: int
    gp: int
    e: int
    stages: int
    fixed: bool
    copy_bytes: int = 16


def group_pad(g: int) -> int:
    """GP, the kernel's head count: G padded to a power of two, >= 2."""
    return max(2, 1 << (g - 1).bit_length())


def lane_width(dh: int) -> int:
    """E, the values of a row a lane holds: ceil(dh / 32) rounded up to
    a power of two, at least 2 (dh 64: 2; 80 to 128: 4; 192, 256: 8;
    264 to 512: 16)."""
    return max(2, 1 << (-(-dh // 32) - 1).bit_length())


def ring_row(dh: int) -> int:
    """The values of a K/V row in the kernel's ring: dh, or dh rounded
    up to 8 where it is not a multiple of 8."""
    return -(-dh // 8) * 8


def row_copy_bytes(dh: int, elt: int) -> int:
    """The bytes of one copy of a row into the ring (``DecodePlan``)."""
    if dh % 8 == 0:
        return 16
    return 4 if elt == 4 else 2


def _smem(gp: int, dh: int, elt: int, stages: int) -> int:
    ring = WARPS * stages * 2 * PW * ring_row(dh) * elt
    merge = 4 * WARPS * gp * (dh + 2)
    return max(ring, merge) + WARPS * PW * gp * 4


def decode_plan(g: int, dh: int, elt: int) -> DecodePlan:
    """The kernel's plan for G query heads a KV head at width dh, K/V
    of ``elt`` bytes a value.  Raises for a dh outside 1 to 512."""
    if g < 1:
        raise ValueError(f"need G >= 1, got {g}")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(
            f"the kernel takes a dh from 1 to {MAX_HEAD_DIM}, got dh={dh}")
    e = lane_width(dh)
    gp_max = min(16, MAX_GROUP_WIDTH // (32 * e))
    chunks = -(-g // gp_max)
    gc = -(-g // chunks)
    gp = group_pad(gc)
    stages = next((st for st in (STAGES, 2, 1)
                   if _smem(gp, dh, elt, st) <= SMEM_LIMIT), 0)
    if not stages:
        raise ValueError(f"G={g}, dh={dh} needs {_smem(gp, dh, elt, 1)} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    return DecodePlan(g, dh, gc, chunks, gp, e, stages, dh in HEAD_DIMS,
                      row_copy_bytes(dh, elt))


def smem_bytes(g: int, dh: int, elt: int) -> int:
    """The kernel's dynamic shared memory, as ``Layout::smem`` in the
    source: each warp's ring of the plan's stages of PW K rows and PW V
    rows of :func:`ring_row` values in the stored type (``elt`` bytes a
    value), or the warps'
    merge area where that is larger, then each warp's probabilities
    (PW·GP f32)."""
    plan = decode_plan(g, dh, elt)
    return _smem(plan.gp, dh, elt, plan.stages)


def resident_blocks(g: int, dh: int, elt: int) -> int:
    """Blocks of the kernel an SM holds: shared memory's count, capped
    by the registers' (:data:`MAX_RESIDENT`)."""
    return min(MAX_RESIDENT, SM_SMEM // (smem_bytes(g, dh, elt)
                                         + BLOCK_RESERVED))


def decode_splits(b: int, kv: int, s: int, sms: int = 132,
                  resident: int = 2, chunks: int = 1) -> int:
    """P, the runs of tiles S is split into: the fewest that give at
    least one full wave of ``sms · resident`` blocks and fill whole
    waves to :data:`WAVE_FILL` (every block does the same work, so a
    ragged last wave idles the rest of the card), each split at least
    :data:`MIN_SPLIT_TILES` tiles."""
    tiles = -(-s // BS)
    most = max(1, tiles // MIN_SPLIT_TILES)
    slots = sms * resident
    units = max(1, b * kv * chunks)
    p = max(1, -(-slots // units))
    while p < most:
        blocks = units * p
        if blocks / (-(-blocks // slots) * slots) >= WAVE_FILL:
            break
        p += 1
    return min(p, most)


def kernel_splits(q: torch.Tensor, k: torch.Tensor) -> int:
    """:func:`decode_splits` for these operands on their card."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    plan = decode_plan(h // kv, dh, k.element_size())
    return decode_splits(b, kv, s, build.sm_count(q.device.index),
                         resident_blocks(h // kv, dh, k.element_size()),
                         plan.chunks)


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            scale: float,
                            plan: DecodePlan | None = None) -> torch.Tensor:
    """Launch the kernel: q (B, H, dh) f32, k/v (B, S, KV, dh) both f32
    or both bf16, lengths (B,) int32 -> (B, H, dh) f32, S split into
    :func:`kernel_splits` runs of tiles, laid out by ``plan``
    (:func:`decode_plan`'s when None)."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k must be float32 or bfloat16, got {k.dtype}")
    build.require(q, "q", (b, h, dh))
    build.require(k, "k", (b, s, kv, dh), k.dtype)
    build.require(v, "v", (b, s, kv, dh), k.dtype)
    build.require(lengths, "lengths", (b,), torch.int32)
    if h % kv:
        raise ValueError(f"need H % KV == 0, got H={h} KV={kv}")
    g = h // kv
    if plan is None:
        plan = decode_plan(g, dh, k.element_size())
    if (plan.g, plan.dh) != (g, dh):
        raise ValueError(f"the plan is for G={plan.g} dh={plan.dh}, "
                         f"not G={g} dh={dh}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    splits = kernel_splits(q, k)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    ws = (torch.empty((b * kv * plan.chunks * splits, plan.gc * (dh + 2)),
                      dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    build.launch("decode_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), b, s, kv, g,
                 plan.gc, plan.chunks, dh, plan.gp, plan.e, plan.stages,
                 int(plan.fixed), splits, float(scale),
                 int(k.dtype == torch.bfloat16))
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, scale: float | None = None) -> torch.Tensor:
    """q (B, H, dh); k/v (B, S, KV, dh); length () or (B,) valid cache
    length (an int or a tensor) -> (B, H, dh) f32."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, length, scale=scale)
    b, _, dh = q.shape
    scale = dh ** -0.5 if scale is None else scale
    lengths = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    lengths = lengths.reshape(-1).expand(b).contiguous()
    if k.dtype != torch.bfloat16:
        k, v = k.float(), v.float()
    return decode_attention_kernel(q.float().contiguous(), k.contiguous(),
                                   v.to(k.dtype).contiguous(), lengths,
                                   scale)
