// Full (N, N) Eq. 9 distance matrix with the diagonal zeroed.
//
// Replaces src/repro/kernels/pairwise.py:_pairwise_kernel with both of
// its operand modes (gram_in_bf16, pairwise.py:116-117,159), the mode a
// template parameter chosen at run time by the code the C entry takes.
//
// Bound.  The matrix needs one dot product over C per unordered pair,
// N(N-1)/2 · 2C operations, on x (N, C) read once.  With f32 operands,
// on the CUDA cores (67 TFLOP/s), that is bound by the operations at
// any N past a few rows (256×151,936: 0.148 ms, the bytes 0.046 ms).
// With bf16 operands on the tensor cores (989 TFLOP/s dense) the same
// work is bound by the bytes of x, which stays f32 in device memory.
//
// Design, against what bounds it:
// * Each unordered pair once.  The grid runs over the upper triangle's
//   64×64 output tiles (bi <= bj, row-major, tile_of), and each pair's
//   value is written to (i, j) and (j, i) from one register.  A diagonal
//   tile stages its 64 rows once (they are both operands), writes its
//   i < j elements to both places and 0 on the diagonal, and its warp
//   whose 32×32 quarter lies wholly below the diagonal does no
//   arithmetic.  Exact symmetry holds by construction, whatever the
//   order of the sums.
// * C split across blocks, merged in the same launch.  Tile counts are
//   small (10 at N = 256, 36 at N = 512), so each tile's C is cut into
//   S slices of whole 32-column chunks (gram::slice_range; a slice may
//   be empty), S from kernels/pairwise.py: pairwise_splits (one wave of
//   three blocks an SM).  Block b takes tile b % T and slice b / T:
//   slices slow, tiles fast, so the blocks that read one slice of x run
//   together and x comes from device memory about once.  With S > 1
//   each block writes its 64×64 partial sums to a workspace (S, T, 64,
//   64), and the last block of a tile to finish (a per-tile counter,
//   atomicAdd after a fence) adds the S partials in slice order with
//   Kahan compensation, applies Eq. 9 and resets the counter to 0 for
//   the next launch.  No atomic enters a sum: two calls are bit-equal.
// * Operands staged by the Tensor Memory Accelerator.  A step is 32
//   columns of the tile's rows: one TMA box of 64 rows × 128 bytes for
//   its rows and one for its columns (one on a diagonal tile), issued
//   by one thread STAGES - 1 steps ahead into a ring of STAGES buffers,
//   in the 128-byte swizzle (16-byte word w of row r at word
//   w ^ (r % 8)) so that the compute's shared loads hit distinct
//   banks.  The copy engine zero-fills rows past N and columns past C.
//   A buffer's `full` mbarrier says its boxes landed; its `empty`
//   mbarrier, that all 128 threads are done with it, and only then does
//   thread 0 refill it: the warps are joined by no barrier a step.  With
//   copies issued thread by thread (cp.async, the first design) every
//   warp stalled in the issue once the SM's queue of outstanding loads
//   was full, and the arithmetic could not overlap those stalls.  Where
//   rows do not start on 16 bytes (C not a multiple of 4, which TMA
//   cannot address) each value is copied on its own (4-byte cp.async)
//   into the same swizzled layout, with a barrier a step.  The slices' partial sums come back
//   for the merge by 16 KB bulk copies, MSLOTS - 1 ahead, over the ring.
// * f32 (the CUDA cores, no TF32): register tiling.  The 4 warps split
//   the tile 2×2; a lane owns 8 rows × 4 columns of its warp's 32×32,
//   rows 4 apart and columns 8 apart.  Per 4 columns a lane loads 12
//   float4 for 128 fmaf.
// * bf16 (gram_in_bf16; the tensor cores): each warp's 32×32 runs as
//   2×4 mma.m16n8k16 (row.col, f32 accumulators) per 16 columns, its
//   fragments read from the staged f32 and rounded to bf16 in registers
//   (round to nearest even, as gram_tile.cuh: operand), so no second
//   buffer and no barrier stand between the copy and the products.
//   Products of bf16 values are exact in f32: the kernel and the plain
//   bf16 version differ only in the order of the sums.
// * Sums are two-level in both modes: fmaf (or the tensor core's f32
//   accumulator) over KAHAN_STEPS steps (128 columns) in increasing c,
//   those chunk sums added with Kahan compensation, then the slices'
//   totals in slice order with Kahan again (gram_tile.cuh's scheme, its
//   chunk four times longer to cut Kahan's share of the instructions).
// * The epilogue computes Eq. 9 of a thread's 32 sums before it stores
//   any, and the two write passes load all their values before they
//   store: loads queued behind stores had made a lone block's epilogue
//   take longer than its sums.
#include <cuda.h>
#include <limits.h>
#include <stdint.h>

#include "gram_tile.cuh"

namespace {

constexpr int TILE = 64;             // output rows and columns a tile
constexpr int THREADS = 128;         // 4 warps, 2×2 over the tile
constexpr int TK = gram::TC;         // columns a step stages: one chunk
constexpr int STAGES = 4;            // steps in the shared-memory ring
constexpr int KAHAN_STEPS = 4;       // steps summed before a Kahan add
constexpr int ROWS = 2 * TILE;       // staged rows: the tile's rows, columns
constexpr int STAGE = ROWS * TK;     // floats a ring buffer (128-byte rows)
constexpr int BOX_BYTES = TILE * TK * 4;  // one TMA box: 64 rows
constexpr int WORDS = TK / 4;        // 16-byte words a staged row segment
constexpr int LOADS = ROWS * WORDS / THREADS;  // words a thread a step
constexpr int STAGE_BYTES = STAGE * 4;
constexpr int ALIGN = 1024;          // the 128-byte swizzle's period
constexpr int OUTS = 32;             // sums a thread owns
constexpr int MSLOTS = 4;            // slices' partials staged at once
constexpr int PART_BYTES = TILE * TILE * 4;
constexpr int TPITCH = TILE + 1;     // the finished tile, in the ring
static_assert(TILE * TPITCH * 4 <= MSLOTS * PART_BYTES, "the tile fits");
static_assert(TK * 4 == 128, "a staged row is one 128-byte swizzle row");
static_assert(ROWS * WORDS % THREADS == 0, "whole words a thread");

// The ring while the block sums; the merge's slots, then the finished
// tile, over it after.
constexpr int SMEM_BYTES = ALIGN + STAGES * STAGE_BYTES;
static_assert(MSLOTS * PART_BYTES <= STAGES * STAGE_BYTES, "slots fit");

// Float offset of 16-byte word w of staged row r (128-byte swizzle).
__device__ __forceinline__ int swz(int r, int w) {
  return r * TK + ((w ^ (r & 7)) << 2);
}

// cp.async of 4 bytes from global src to the shared address dst.
__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// The issuing thread's arrival, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
// TMA: the box at (column col, row row) of the tensor map into dst.
__device__ __forceinline__ void tma_box(unsigned dst, const CUtensorMap* map,
                                        int col, int row, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}
// Bulk copy of `bytes` contiguous bytes from global src into dst.
__device__ __forceinline__ void bulk_copy(unsigned dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Tile t of the upper triangle of nb × nb tiles, row-major:
// (0, 0), (0, 1), ..., (0, nb-1), (1, 1), ...  kernels/pairwise.py:
// tile_pairs lists the same order.
__device__ inline void tile_of(int t, int nb, int* bi, int* bj) {
  int i = 0;
  while (t >= nb - i) {
    t -= nb - i;
    ++i;
  }
  *bi = i;
  *bj = i + t;
}

// (il, jl) in the tile of sum q of this lane.
template <bool BF16>
__device__ __forceinline__ void elem(int q, int warp, int lane, int* il,
                                     int* jl) {
  const int wm = warp >> 1, wn = warp & 1;
  if (BF16) {
    // q = (mt·4 + nt)·4 + e: accumulator e of m-tile mt, n-tile nt
    const int mt = q >> 4, nt = (q >> 2) & 3, e = q & 3;
    *il = wm * 32 + mt * 16 + (lane >> 2) + 8 * (e >> 1);
    *jl = wn * 32 + nt * 8 + 2 * (lane & 3) + (e & 1);
  } else {
    // q = ii·4 + jj: rows 4 apart, columns 8 apart
    const int ii = q >> 2, jj = q & 3;
    *il = wm * 32 + (lane >> 3) + 4 * ii;
    *jl = wn * 32 + (lane & 7) + 8 * jj;
  }
}

// One f32 step: part[ii·4 + jj] += <a row, b row> over the TK columns
// in increasing c.  brow: the staged row of the tile's first column.
// A quarter-warp reads one row of A (a broadcast) and 8 rows of B whose
// word k/4 the swizzle puts in 8 distinct groups of banks.
__device__ __forceinline__ void fma_step(const float* buf, int brow,
                                         int warp, int lane, float* part) {
  const int wm = warp >> 1, wn = warp & 1, ty = lane >> 3, tx = lane & 7;
  const float* a = buf + (wm * 32 + ty) * TK;
  const float* b = buf + (brow + wn * 32 + tx) * TK;
#pragma unroll
  for (int k = 0; k < TK; k += 4) {
    // row r of A is ty + 4 ii (mod 8), of B tx (mod 8)
    const int wb = ((k >> 2) ^ tx) << 2;
    const int wa0 = ((k >> 2) ^ ty) << 2, wa1 = ((k >> 2) ^ (ty + 4)) << 2;
    float4 bv[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      bv[jj] = *reinterpret_cast<const float4*>(b + 8 * jj * TK + wb);
    }
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float4 av = *reinterpret_cast<const float4*>(
          a + 4 * ii * TK + ((ii & 1) ? wa1 : wa0));
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float& p = part[ii * 4 + jj];
        p = fmaf(av.x, bv[jj].x, p);
        p = fmaf(av.y, bv[jj].y, p);
        p = fmaf(av.z, bv[jj].z, p);
        p = fmaf(av.w, bv[jj].w, p);
      }
    }
  }
}

// Two f32 values (row r, columns k, k + 1; k even) of a staged ring
// buffer, rounded to a pair of bf16 (round to nearest even, as
// gram_tile.cuh: operand), the lower column in the lower half: one
// register of an mma fragment.
__device__ __forceinline__ unsigned bf16_pair(const float* buf, int r,
                                              int k) {
  const float2 v = *reinterpret_cast<const float2*>(
      buf + r * TK + (((k >> 2) ^ (r & 7)) << 2) + (k & 3));
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void mma16816(float* d, const unsigned* a,
                                         const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One bf16 step on the tensor cores: the warp's 32×32 as 2 m-tiles ×
// 4 n-tiles of m16n8, k16 twice, its fragments read from the staged
// f32 rows and rounded to bf16 in registers (x rows are both the .row
// A operand and the .col B operand).  Every row a lane reads is g
// (mod 8), so the swizzle spreads a fragment load over the banks.
__device__ __forceinline__ void mma_step(const float* buf, int brow,
                                         int warp, int lane, float* part) {
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, t2 = 2 * (lane & 3);
#pragma unroll
  for (int k = 0; k < TK; k += 16) {
    unsigned a[2][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + g;
      a[mt][0] = bf16_pair(buf, r, k + t2);
      a[mt][1] = bf16_pair(buf, r + 8, k + t2);
      a[mt][2] = bf16_pair(buf, r, k + 8 + t2);
      a[mt][3] = bf16_pair(buf, r + 8, k + 8 + t2);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = brow + wn * 32 + nt * 8 + g;
      b[nt][0] = bf16_pair(buf, r, k + t2);
      b[nt][1] = bf16_pair(buf, r, k + 8 + t2);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        mma16816(part + (mt * 4 + nt) * 4, a[mt], b[nt]);
      }
    }
  }
}

// One (tile, slice) block.  TMA: rows start on 16 bytes and `map`
// describes x (otherwise it is not read).  ws (S, T, 64, 64) and
// counters (T,) are read only when splits > 1.
template <bool BF16, bool TMA>
__global__ void __launch_bounds__(THREADS, 3)
pairwise_kernel(const __grid_constant__ CUtensorMap map,
                const float* __restrict__ x, const float* __restrict__ stats,
                float* __restrict__ out, float* __restrict__ ws,
                int* __restrict__ counters, int n, int c, int nb, int tiles,
                int splits, float lam, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float2 srow[TILE], scol[TILE];  // [norm, Ĥ] of the tile's rows
  __shared__ __align__(8) unsigned long long full[STAGES], empty[STAGES],
      mfull[MSLOTS];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x % tiles, s = blockIdx.x / tiles;
  int bi, bj;
  tile_of(t, nb, &bi, &bj);
  const int row0 = bi * TILE, col0 = bj * TILE;
  const bool diag = bi == bj;
  const int staged = diag ? TILE : ROWS;
  const int brow = diag ? 0 : TILE;
  const bool idle = diag && (warp >> 1) > (warp & 1);
  int f_begin, f_end;
  gram::slice_range(c, splits, s, &f_begin, &f_end);
  const int steps = (f_end - f_begin + TK - 1) / TK;
  // the ring starts on the swizzle's 1024-byte period
  const unsigned raw = (unsigned)__cvta_generic_to_shared(smem);
  const unsigned pad = (ALIGN - (raw & (ALIGN - 1))) & (ALIGN - 1);
  float* sh = reinterpret_cast<float*>(smem + pad);
  const unsigned sh_addr = raw + pad;
  const unsigned full_addr = (unsigned)__cvta_generic_to_shared(full);
  const unsigned empty_addr = (unsigned)__cvta_generic_to_shared(empty);
  const unsigned mfull_addr = (unsigned)__cvta_generic_to_shared(mfull);
  if (tid < 2 * TILE) {  // read here, used after the main loop's barriers
    const int r = tid % TILE, g = (tid < TILE ? row0 : col0) + r;
    const float2 v = g < n ? make_float2(stats[2 * g], stats[2 * g + 1])
                           : make_float2(0.0f, 0.0f);
    (tid < TILE ? srow : scol)[r] = v;
  }
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(full_addr + 8u * k, 1);
      mbar_init(empty_addr + 8u * k, THREADS);
    }
    for (int k = 0; k < MSLOTS; ++k) mbar_init(mfull_addr + 8u * k, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // copy step st of the staged rows into ring buffer buf: with TMA one
  // thread issues the boxes; otherwise every thread copies its values,
  // zero-filling what lies past N or past the slice without a read
  auto issue = [&](int st, int buf) {
    const int col = f_begin + st * TK;
    if (TMA) {
      const unsigned bar = full_addr + 8u * buf;
      mbar_expect(bar, (diag ? 1u : 2u) * BOX_BYTES);
      tma_box(sh_addr + 4u * buf * STAGE, &map, col, row0, bar);
      if (!diag) {
        tma_box(sh_addr + 4u * (buf * STAGE + TILE * TK), &map, col, col0,
                bar);
      }
    } else {
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int id = tid + i * THREADS;
        const int r = id / WORDS, w = id % WORDS;
        if (r < staged) {
          const int g = r < TILE ? row0 + r : col0 + r - TILE;
          const int cc = col + 4 * w;
          const int o = buf * STAGE + swz(r, w);
          const float* src = x + (size_t)g * c + cc;
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (g < n && cc + m < f_end) {
              copy4(sh_addr + 4u * (o + m), src + m);
            } else {
              sh[o + m] = 0.0f;
            }
          }
        }
      }
    }
  };

  float acc[OUTS], comp[OUTS], part[OUTS];
#pragma unroll
  for (int q = 0; q < OUTS; ++q) acc[q] = comp[q] = part[q] = 0.0f;
  auto kahan_step = [&](int st) {
    if (st % KAHAN_STEPS == KAHAN_STEPS - 1 || st == steps - 1) {
#pragma unroll
      for (int q = 0; q < OUTS; ++q) {
        gram::kahan_add(acc[q], comp[q], part[q]);
        part[q] = 0.0f;
      }
    }
  };
  const auto compute = [&](int st) {
    if (!idle) {
      const float* buf = sh + (st % STAGES) * STAGE;
      if (BF16) {
        mma_step(buf, brow, warp, lane, part);
      } else {
        fma_step(buf, brow, warp, lane, part);
      }
    }
    kahan_step(st);
  };
  if (TMA) {
    // full[b]: step st's boxes landed in buffer b = st % STAGES;
    // empty[b]: every thread is done with it.  Thread 0 refills buffer
    // b once step st - 1's buffer is empty, so warps run up to
    // STAGES - 1 steps apart and no barrier joins them a step.
    if (tid == 0) {
      for (int st = 0; st < STAGES - 1 && st < steps; ++st) issue(st, st);
    }
    for (int st = 0; st < steps; ++st) {
      const int buf = st % STAGES;
      mbar_wait(full_addr + 8u * buf, (unsigned)(st / STAGES) & 1u);
      compute(st);
      mbar_arrive(empty_addr + 8u * buf);
      const int next = st + STAGES - 1;
      if (tid == 0 && next < steps) {
        if (st >= 1) {
          mbar_wait(empty_addr + 8u * (next % STAGES),
                    (unsigned)((st - 1) / STAGES) & 1u);
        }
        issue(next, next % STAGES);
      }
    }
  } else {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps) issue(st, st);
      copy_commit();
    }
    for (int st = 0; st < steps; ++st) {
      copy_wait<STAGES - 2>();  // this thread's copies of step st landed
      // every thread's copies of step st are in, and every thread is
      // done with step st - 1, whose ring buffer the next copy reuses
      __syncthreads();
      if (st + STAGES - 1 < steps) {
        issue(st + STAGES - 1, (st + STAGES - 1) % STAGES);
      }
      copy_commit();
      compute(st);
    }
  }
  if (!TMA) copy_wait<0>();
  __syncthreads();

  // Eq. 9 of this thread's sums, all computed before any is stored
  // (independent chains, none waiting on a store), kept in the tile
  // over the ring, which is free; q -> (il, jl) as `at` says
  float* tile = sh;
  auto finish = [&](auto at) {
#pragma unroll
    for (int q = 0; q < OUTS; ++q) {
      int il, jl;
      at(q, &il, &jl);
      const float2 a = srow[il], b = scol[jl];
      acc[q] = gram::eq9(acc[q], a.x, b.x, a.y, b.y, row0 + il == col0 + jl,
                         lam, eps);
    }
#pragma unroll
    for (int q = 0; q < OUTS; ++q) {
      int il, jl;
      at(q, &il, &jl);
      tile[il * TPITCH + jl] = acc[q];
    }
  };
  if (splits == 1) {
    if (!idle) {
      finish([&](int q, int* il, int* jl) {
        elem<BF16>(q, warp, lane, il, jl);
      });
    }
  } else {
    float* mine = ws + ((size_t)s * tiles + t) * (TILE * TILE);
    if (!idle) {
#pragma unroll
      for (int q = 0; q < OUTS; ++q) {
        int il, jl;
        elem<BF16>(q, warp, lane, &il, &jl);
        mine[il * TILE + jl] = acc[q];
      }
    }
    // after the barrier thread 0's count releases the block's partials
    // and, for the last block, acquires every other slice's
    __syncthreads();
    if (tid == 0) {
      int old;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(old)
                   : "l"(counters + t)
                   : "memory");
      last = old == splits - 1;
    }
    __syncthreads();
    if (!last) return;
    // the S partials of the tile in slice order, Kahan-compensated,
    // brought in by one thread's bulk copies into MSLOTS slots (over
    // the ring) MSLOTS - 1 slices ahead; this thread adds elements
    // tid + q·THREADS (below a diagonal tile's diagonal what was never
    // written, which is not used)
#pragma unroll
    for (int q = 0; q < OUTS; ++q) acc[q] = comp[q] = 0.0f;
    const float* part0 = ws + (size_t)t * (TILE * TILE);
    auto fetch = [&](int ss) {
      const unsigned bar = mfull_addr + 8u * (ss % MSLOTS);
      mbar_expect(bar, PART_BYTES);
      bulk_copy(sh_addr + (unsigned)(ss % MSLOTS) * PART_BYTES,
                part0 + (size_t)ss * tiles * (TILE * TILE), PART_BYTES, bar);
    };
    if (tid == 0) {
      // the generic proxy's writes and reads come before the copies'
      asm volatile("fence.proxy.async;\n" ::: "memory");
      for (int ss = 0; ss < MSLOTS - 1 && ss < splits; ++ss) fetch(ss);
    }
    for (int ss = 0; ss < splits; ++ss) {
      mbar_wait(mfull_addr + 8u * (ss % MSLOTS),
                (unsigned)(ss / MSLOTS) & 1u);
      __syncthreads();  // every thread is done with the slot of ss - 1
      if (tid == 0 && ss + MSLOTS - 1 < splits) fetch(ss + MSLOTS - 1);
      const float* slot = sh + (ss % MSLOTS) * (TILE * TILE);
#pragma unroll
      for (int q = 0; q < OUTS; ++q) {
        gram::kahan_add(acc[q], comp[q], slot[tid + q * THREADS]);
      }
    }
    __syncthreads();
    finish([&](int q, int* il, int* jl) {
      *il = (tid + q * THREADS) / TILE;
      *jl = (tid + q * THREADS) % TILE;
    });
    if (tid == 0) counters[t] = 0;  // ready for the next launch
  }
  __syncthreads();
  // each pair written at (i, j) and at (j, i) from the tile, neighbouring
  // threads on neighbouring addresses, a thread's loads all issued before
  // its stores; on a diagonal tile only i <= j
  float v[OUTS];
#pragma unroll
  for (int q = 0; q < OUTS; ++q) {
    const int e = tid + q * THREADS;
    v[q] = tile[(e / TILE) * TPITCH + e % TILE];
  }
#pragma unroll
  for (int q = 0; q < OUTS; ++q) {
    const int e = tid + q * THREADS;
    const int il = e / TILE, jl = e % TILE, i = row0 + il, j = col0 + jl;
    if (i < n && j < n && (!diag || il <= jl)) out[(size_t)i * n + j] = v[q];
  }
#pragma unroll
  for (int q = 0; q < OUTS; ++q) {
    const int e = tid + q * THREADS;
    v[q] = tile[(e % TILE) * TPITCH + e / TILE];
  }
#pragma unroll
  for (int q = 0; q < OUTS; ++q) {
    const int e = tid + q * THREADS;
    const int jl = e / TILE, il = e % TILE, i = row0 + il, j = col0 + jl;
    if (i < n && j < n && (!diag || il < jl)) out[(size_t)j * n + i] = v[q];
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return (EncodeTiled) nullptr;
    }
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess) {
      return (EncodeTiled) nullptr;
    }
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

template <bool BF16, bool TMA>
int launch(const CUtensorMap& map, const float* x, const float* stats,
           float* out, float* ws, int* counters, int n, int c, int nb,
           int tiles, int splits, float lam, float eps, cudaStream_t s) {
  // the ring is above the 48 KB of static shared memory: opt in once
  static const int opt_in = (int)cudaFuncSetAttribute(
      pairwise_kernel<BF16, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (opt_in != 0) return opt_in;
  pairwise_kernel<BF16, TMA>
      <<<(unsigned)(tiles * splits), THREADS, SMEM_BYTES, s>>>(
          map, x, stats, out, ws, counters, n, c, nb, tiles, splits, lam,
          eps);
  return (int)cudaGetLastError();
}

}  // namespace

// x (n, c) f32, stats (n, 2) f32 = [norm, entropy]; out (n, n) f32;
// splits >= 1 slices of C a tile; with splits > 1 a workspace of
// splits · T · 64 · 64 f32 and T int32 counters, all 0 at the first
// launch and left 0 by every launch (T = nb(nb + 1)/2, nb = ceil(n/64));
// bf16 0 (f32 operands) or 1 (bf16 operands).  Returns
// cudaErrorInvalidValue for another code, for splits > 1 without the
// workspace or the counters, for more than INT_MAX blocks, or where the
// tensor map of x cannot be made.
extern "C" int pairwise_launch(const void* x, const void* stats, void* out,
                               void* workspace, void* counters, int n, int c,
                               int splits, float lam, float eps, int bf16,
                               void* stream) {
  if ((bf16 != 0 && bf16 != 1) || n < 0 || c < 0 || splits < 1 ||
      (splits > 1 && (workspace == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > 0) {
    const int nb = (n + TILE - 1) / TILE;
    const long long tiles = (long long)nb * (nb + 1) / 2;
    if (tiles * splits > INT_MAX) return (int)cudaErrorInvalidValue;
    const float *xx = (const float*)x, *st = (const float*)stats;
    float *o = (float*)out, *ws = (float*)workspace;
    int* cnt = (int*)counters;
    const cudaStream_t s = (cudaStream_t)stream;
    const int T = (int)tiles;
    // TMA addresses rows that start on 16 bytes
    const bool tma = c > 0 && c % 4 == 0 && ((uintptr_t)x & 15) == 0;
    CUtensorMap map = {};
    if (tma) {
      const EncodeTiled encode = encoder();
      const cuuint64_t dims[2] = {(cuuint64_t)c, (cuuint64_t)n};
      const cuuint64_t strides[1] = {(cuuint64_t)c * 4};
      const cuuint32_t box[2] = {TK, TILE};
      const cuuint32_t unit[2] = {1, 1};
      if (encode == nullptr ||
          encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)x, dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
        return (int)cudaErrorInvalidValue;
      }
    }
    if (bf16) {
      return tma ? launch<true, true>(map, xx, st, o, ws, cnt, n, c, nb, T,
                                      splits, lam, eps, s)
                 : launch<true, false>(map, xx, st, o, ws, cnt, n, c, nb, T,
                                       splits, lam, eps, s);
    }
    return tma ? launch<false, true>(map, xx, st, o, ws, cnt, n, c, nb, T,
                                     splits, lam, eps, s)
               : launch<false, false>(map, xx, st, o, ws, cnt, n, c, nb, T,
                                      splits, lam, eps, s);
  }
  return (int)cudaGetLastError();
}
