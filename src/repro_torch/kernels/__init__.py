"""Hand-written CUDA kernels of the port and their plain versions.

  fused_stats  — single-sweep Ĥ + L2 norm + RMS over (N, C)
  gram_update  — K×N distance strip (Eq. 9, cosine or l2) for the
                 incremental distance caches
  pairwise     — full (N, N) Eq. 9 matrix
  hetero_entropy   — Ĥ of each row of (N, C), f32 or bf16
  decode_attention — one-token GQA attention against a KV cache
  ref          — plain PyTorch versions (the CPU path and the oracle)
  build        — nvcc build of ``csrc/*.cu`` and the ctypes binding
  ops          — the public API, with an explicit device

Importing this package needs neither nvcc nor a card: a kernel is
built and loaded at its first launch.
"""
from repro_torch.kernels.ops import (cached_feature_step,
                                     estimate_entropies, fused_row_stats,
                                     gqa_decode_attention, gram_row_update,
                                     hics_selection_step,
                                     hics_selection_step_cached,
                                     pairwise_distances)

__all__ = ["cached_feature_step", "estimate_entropies", "fused_row_stats",
           "gqa_decode_attention", "gram_row_update", "hics_selection_step",
           "hics_selection_step_cached", "pairwise_distances"]
