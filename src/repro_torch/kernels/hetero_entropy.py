"""Ĥ = H(softmax(x / T)) of each row of (N, C), f32 or bf16 in.

Replaces the TPU kernel ``src/repro/kernels/hetero_entropy.py:
_entropy_kernel`` (via ``entropy_pallas``) with
``csrc/hetero_entropy.cu``: one block of 512 threads per row carries
the online softmax state (m, Z, S) over the row, one rescale per chunk
of 8 columns a thread, and the 512 carries merge by shuffle and through
shared memory.  It reads (N, C) once and writes N floats, so on the
H100 it is bound by memory bytes.  No padding: the kernel stops at C.

On a CPU tensor :func:`entropy` takes the plain version
(:func:`repro_torch.kernels.ref.entropy_ref`); on a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref


def entropy_rows(x: torch.Tensor, temperature: float) -> torch.Tensor:
    """Launch the kernel: x (N, C) f32 or bf16 -> (N,) f32."""
    n, c = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    build.require(x, "x", (n, c), x.dtype)
    out = torch.empty(n, dtype=torch.float32, device=x.device)
    build.launch("hetero_entropy", x.data_ptr(), out.data_ptr(), n, c,
                 float(temperature), int(x.dtype == torch.bfloat16))
    return out


def entropy(updates: torch.Tensor, temperature: float) -> torch.Tensor:
    """(N, C) -> (N,) f32 entropies of the tempered softmax."""
    if updates.device.type == "cpu":
        return ref.entropy_ref(updates, temperature)
    x = updates if updates.dtype == torch.bfloat16 else updates.float()
    return entropy_rows(x.contiguous(), temperature)
