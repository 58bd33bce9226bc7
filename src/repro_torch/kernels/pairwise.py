"""Full Eq. 9 distance matrix and the from-scratch selection step.

Replaces the TPU kernel ``src/repro/kernels/pairwise.py:
_pairwise_kernel`` with both operand modes (via ``_pairwise_padded``,
``pairwise_distance_pallas`` and ``hics_selection_step_pallas``) with
``csrc/pairwise.cu``, one launch a call.  Its grid runs over the
upper triangle's 64×64 output tiles, each unordered pair computed once
and written to (i, j) and (j, i), so the matrix is bit-symmetric by
construction, and each tile's C is split into :func:`pairwise_splits`
slices of whole 32-column chunks.  With S > 1 the last block of a tile
to finish adds the slices' partial sums in slice order with Kahan
compensation and applies the epilogue, in the same launch; the wrapper
allocates the (S, T, 64, 64) workspace and keeps the per-tile
counters, which every launch leaves at 0.  The operands are staged by
the Tensor Memory Accelerator.  f32 runs on the CUDA cores
(register-tiled, no TF32) and is bound by its operations at wide C;
``gram_in_bf16`` rounds the staged f32 to bf16 as the tensor cores'
fragments are loaded (``mma.sync`` m16n8k16, f32 sums), bound by the
bytes of x, which stays f32.  At the slice's N = 50, C = 10 the call is
paced by the host.

:func:`hics_selection_step` mirrors ``hics_selection_step_pallas``:
fused stats over all rows (one launch, ``normalize`` included), then
this kernel.  On a CPU tensor it takes the plain
:func:`repro_torch.kernels.ref.selection_step_ref`, f32 whatever
``gram_in_bf16`` says, as the reference's CPU oracle;
:func:`repro_torch.kernels.ref.pairwise_split_ref` is the plain
version of the kernel's split.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fused_stats import fused_stats_rows

EPS = 1e-8

#: output rows and columns a tile (csrc/pairwise.cu: TILE)
TILE = 64
#: blocks an SM the plan fills in one wave (the kernel's
#: ``__launch_bounds__``; its ring lets three share an SM), and the
#: fewest 32-column chunks a slice keeps (four staged steps)
RESIDENT, MIN_SLICE_CHUNKS = 3, 4
#: the most slices a tile takes (bounds the workspace)
MAX_SPLITS = 1024


class PairwisePlan(NamedTuple):
    """One launch: ``tiles`` the (bi, bj) output tiles in the kernel's
    order (block b takes tile b % T and slice b // T), ``splits`` S and
    ``slices`` the (begin, end) columns of each slice."""
    tiles: list
    splits: int
    slices: list


def tile_pairs(n: int) -> list:
    """The upper triangle's tiles of an (n, n) matrix, row-major
    (csrc/pairwise.cu: tile_of)."""
    nb = -(-n // TILE)
    return [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]


def tile_count(n: int) -> int:
    """T, the upper triangle's tiles of an (n, n) matrix."""
    nb = -(-n // TILE)
    return nb * (nb + 1) // 2


@functools.lru_cache(maxsize=256)
def pairwise_splits(n: int, c: int, sms: int = 132) -> int:
    """S, the most slices a tile for which every block is resident in
    one wave (:data:`RESIDENT` an SM), each slice at least
    :data:`MIN_SLICE_CHUNKS` chunks, so that C of a few chunks is one
    slice (S = 1 at 50×10)."""
    fit = RESIDENT * sms // max(1, tile_count(n))
    return max(1, min(fit, -(-c // ref.GRAM_CHUNK) // MIN_SLICE_CHUNKS))


def check_splits(splits: int) -> int:
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must lie in [1, {MAX_SPLITS}], got "
                         f"{splits}")
    return splits


def pairwise_plan(n: int, c: int, sms: int = 132,
                  splits: int | None = None) -> PairwisePlan:
    """The launch for (n, c) on ``sms`` SMs (:func:`pairwise_splits`);
    ``splits`` forces S (a slice may then be empty)."""
    splits = check_splits(pairwise_splits(n, c, sms) if splits is None
                          else splits)
    return PairwisePlan(tile_pairs(n), splits,
                        ref.gram_slice_ranges(c, splits))


#: per (device, stream): the kernel's per-tile counters, zeroed once;
#: every launch leaves the counters it used at 0
_counters: dict = {}


def tile_counters(device: torch.device, tiles: int) -> torch.Tensor:
    """At least ``tiles`` int32 counters, all 0, for launches on the
    current stream (of ``device``, the current device)."""
    key = (device.index, torch.cuda.current_stream().cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def pairwise(x: torch.Tensor, stats: torch.Tensor, lam: float,
             eps: float = EPS, gram_in_bf16: bool = False,
             splits: int | None = None) -> torch.Tensor:
    """Launch the kernel: x (N, C) f32, stats (N, 2) = [norm, Ĥ] f32
    -> (N, N) f32; ``gram_in_bf16`` rounds the operands to bf16;
    ``splits`` forces S (default :func:`pairwise_splits` for this
    card)."""
    n, c = x.shape
    build.require(x, "x", (n, c))
    build.require(stats, "stats", (n, 2))
    splits = check_splits(
        pairwise_splits(n, c, build.sm_count(x.device.index))
        if splits is None else splits)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    ws = cnt = None
    if splits > 1 and n > 0:
        tiles = tile_count(n)
        ws = torch.empty(splits * tiles * TILE * TILE, dtype=torch.float32,
                         device=x.device)
        cnt = tile_counters(x.device, tiles)
    build.launch("pairwise", x.data_ptr(), stats.data_ptr(),
                 out.data_ptr(), None if ws is None else ws.data_ptr(),
                 None if cnt is None else cnt.data_ptr(), n, c,
                 splits if ws is not None else 1, float(lam), float(eps),
                 int(bool(gram_in_bf16)),
                 operands=build.OPERANDS[bool(gram_in_bf16)])
    return out


def hics_selection_step(updates: torch.Tensor, temperature: float,
                        lam: float = 10.0, normalize: bool = False,
                        gram_in_bf16: bool = False):
    """From-scratch HiCS step: (N, C) -> (Ĥ (N,), Eq. 9 D (N, N))."""
    if updates.device.type == "cpu":
        return ref.selection_step_ref(updates, temperature, lam,
                                      normalize=normalize)
    x = updates.float().contiguous()
    ent, norm, _ = fused_stats_rows(x, temperature, normalize=normalize)
    stats = torch.stack([norm, ent], dim=-1).contiguous()
    return ent, pairwise(x, stats, lam, gram_in_bf16=gram_in_bf16)
