"""One-token GQA attention against a (B, S, KV, dh) cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:
_decode_kernel`` (via ``decode_attention_pallas``) with
``csrc/decode_attention.cu``, a flash-decoding kernel for the H100: S
is split into :func:`decode_splits` runs of 32-position tiles, one
block per (batch, KV head, split); each warp streams its rows of every
tile through a 3-stage ``cp.async`` ring in the cache's stored type and
applies each staged K and V value, read once, to all G query heads held
in registers; a second launch merges the splits' partial (m, l, acc)
in increasing split order.  It reads the valid part of K and V once,
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
#: the stored row widths the kernel is built for; a lane holds
#: E = ceil(dh / 32) values (dh 112, zamba2's shared attention: E = 4
#: on 28 lanes, the other 4 hold zeros)
HEAD_DIMS = (64, 112, 128, 256)
#: GP·dh the registers hold (q and the accumulators, 32 floats a lane;
#: zamba2's G 1 -> GP 2 needs 2 · 112 = 224)
MAX_GROUP_WIDTH = 1024


def group_pad(g: int) -> int:
    """GP, the kernel's head count: G padded to a power of two, >= 2."""
    return max(2, 1 << (g - 1).bit_length())


def smem_bytes(g: int, dh: int, elt: int) -> int:
    """The kernel's dynamic shared memory, as ``Layout::SMEM`` in the
    source: each warp's ring of STAGES stages of PW K rows and PW V rows
    in the stored type (``elt`` bytes a value), then each warp's
    probabilities (PW·GP f32).  The merge of the warps reuses the
    ring."""
    return WARPS * STAGES * 2 * PW * dh * elt + WARPS * PW * group_pad(g) * 4


def resident_blocks(g: int, dh: int, elt: int) -> int:
    """Blocks of the kernel an SM holds: shared memory's count, capped
    by the registers' (:data:`MAX_RESIDENT`)."""
    return min(MAX_RESIDENT, SM_SMEM // (smem_bytes(g, dh, elt)
                                         + BLOCK_RESERVED))


def decode_splits(b: int, kv: int, s: int, sms: int = 132,
                  resident: int = 2) -> int:
    """P, the runs of tiles S is split into: the fewest that give at
    least one full wave of ``sms · resident`` blocks and fill whole
    waves to :data:`WAVE_FILL` (every block does the same work, so a
    ragged last wave idles the rest of the card), each split at least
    :data:`MIN_SPLIT_TILES` tiles."""
    tiles = -(-s // BS)
    most = max(1, tiles // MIN_SPLIT_TILES)
    slots = sms * resident
    units = max(1, b * kv)
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
    return decode_splits(b, kv, s, build.sm_count(q.device.index),
                         resident_blocks(h // kv, dh, k.element_size()))


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Launch the kernel: q (B, H, dh) f32, k/v (B, S, KV, dh) both f32
    or both bf16, lengths (B,) int32 -> (B, H, dh) f32, S split into
    :func:`kernel_splits` runs of tiles."""
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
    if dh not in HEAD_DIMS or group_pad(g) * dh > MAX_GROUP_WIDTH:
        raise ValueError(
            f"the kernel holds q and the accumulators of the G={g} heads "
            f"in registers: it takes dh in {HEAD_DIMS} and "
            f"G·dh <= {MAX_GROUP_WIDTH} (G padded to {group_pad(g)}), got "
            f"dh={dh}")
    elt = k.element_size()
    if smem_bytes(g, dh, elt) > SMEM_LIMIT:
        raise ValueError(f"G={g}, dh={dh} needs {smem_bytes(g, dh, elt)} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    splits = kernel_splits(q, k)
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    ws = (torch.empty((b * kv * splits, g * (dh + 2)), dtype=torch.float32,
                      device=q.device) if splits > 1 else None)
    build.launch("decode_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), b, s, kv, g, dh,
                 splits, float(scale), int(k.dtype == torch.bfloat16))
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
