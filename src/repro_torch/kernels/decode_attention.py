"""One-token GQA attention against a (B, S, KV, dh) cache.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:
_decode_kernel`` (via ``decode_attention_pallas``) with
``csrc/decode_attention.cu``: one block per (batch, KV head) carries
the G = H / KV query heads of the group together through the cache in
tiles of 64 positions, staged through shared memory as f32, with an
online softmax masked at each row's length.  It reads the valid part of
K and V once, so on the H100 it is bound by memory bytes.

On CPU tensors :func:`decode_attention` takes the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); on CUDA tensors
it launches the kernel or raises.  The two differ at length 0: the
kernel returns 0 (it divides by max(l, 1e-30), as the TPU kernel does),
the plain version NaN (a softmax over all -inf).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

#: shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232_448
BS = 64        # cache positions per tile, as in csrc/decode_attention.cu


def smem_bytes(g: int, dh: int) -> int:
    """The kernel's dynamic shared memory, as ``smem_bytes`` in the
    source: q and acc (g·dh each), the K tile with padded rows, the V
    tile, the logits (g·BS) and three stats of g."""
    return 4 * (2 * g * dh + BS * (dh + 4) + BS * dh + g * BS + 3 * g)


def decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, lengths: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """Launch the kernel: q (B, H, dh) f32, k/v (B, S, KV, dh) both f32
    or both bf16, lengths (B,) int32 -> (B, H, dh) f32."""
    b, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k must be float32 or bfloat16, got {k.dtype}")
    if h % kv or dh % 8:
        raise ValueError(f"need H % KV == 0 and dh % 8 == 0, got H={h} "
                         f"KV={kv} dh={dh}")
    g = h // kv
    if smem_bytes(g, dh) > SMEM_LIMIT:
        raise ValueError(f"G={g}, dh={dh} needs {smem_bytes(g, dh)} "
                         f"bytes of shared memory, over {SMEM_LIMIT}")
    build.require(q, "q", (b, h, dh))
    build.require(k, "k", (b, s, kv, dh), k.dtype)
    build.require(v, "v", (b, s, kv, dh), k.dtype)
    build.require(lengths, "lengths", (b,), torch.int32)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty((b, h, dh), dtype=torch.float32, device=q.device)
    build.launch("decode_attention", q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, s, kv,
                 g, dh, float(scale), int(k.dtype == torch.bfloat16))
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
