"""Ĥ = H(softmax(x / T)) of each row of (N, C), f32 or bf16 in.

Replaces the TPU kernel ``src/repro/kernels/hetero_entropy.py:
_entropy_kernel`` (via ``entropy_pallas``) with
``csrc/hetero_entropy.cu``.  It reads (N, C) once and writes N floats,
so on the H100 it is bound by the bytes of x.  Each row is split across
the :func:`repro_torch.kernels.fused_stats.stats_splits` blocks of one
thread-block cluster, each walking its slice in 16-byte loads (4 f32 or
8 bf16) with one expf a column, and rank 0 merges the blocks' carries
(m, Z, S) in rank order (``entropy_carry.cuh``), so 64 rows at vocab
width stream x on most of the SMs and bf16 reads half the bytes of
f32.  x / T is the IEEE quotient, formed with one reciprocal a thread
and two fmas a column (``carry::divide``): a divide instruction a
column made the kernel instruction-bound.  No padding: the kernel
stops at C.

On a CPU tensor :func:`entropy` takes the plain version
(:func:`repro_torch.kernels.ref.entropy_ref`); on a CUDA tensor it
launches the kernel or raises.  :func:`repro_torch.kernels.ref.
entropy_split_ref` is the plain version of the split itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_stats import check_splits


def entropy_rows(x: torch.Tensor, temperature: float,
                 splits: int | None = None) -> torch.Tensor:
    """Launch the kernel: x (N, C) f32 or bf16 -> (N,) f32.  ``splits``
    (default the plan for this card) is P."""
    n, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    build.require(x, "x", (n, c), x.dtype)
    splits = check_splits(n, c, x, splits)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    build.launch("hetero_entropy", x.data_ptr(), out.data_ptr(), n, c,
                 splits, float(temperature),
                 int(x.dtype == torch.bfloat16))
    return out


def entropy(updates: torch.Tensor, temperature: float) -> torch.Tensor:
    """(N, C) -> (N,) f32 entropies of the tempered softmax."""
    if updates.device.type == "cpu":
        return ref.entropy_ref(updates, temperature)
    x = updates if updates.dtype == torch.bfloat16 else updates.float()
    return entropy_rows(x.contiguous(), temperature)
