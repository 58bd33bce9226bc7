// K x N distance strip: the refreshed rows against every row.
//
// Replaces src/repro/kernels/gram_update.py:_gram_row_kernel with all
// three of its epilogues (EPILOGUES, gram_update.py:53-59) and both of
// its operand modes (gram_in_bf16, gram_update.py:165-167), chosen at
// run time by the codes the C entry takes (the operand mode and the
// split as template parameters, the epilogue by a switch):
//   0 arccos  out[u, j] = eq9(<rows[u], x[j]>, stats_rows[u],
//             stats_all[j]) (HiCS, Eq. 9);
//   1 cosine  the angle alone; lanes [:, 1] of the stats are not read
//             (Clustered Sampling);
//   2 l2      sqrt(|a|² + |b|² − 2<a, b>) from the cached norms (DivFL);
// bf16 = 1 rounds both operands to bf16 as they are loaded (one pass
// over the f32 buffer; gram_tile.cuh: operand).  Every epilogue is
// zeroed where row_ids[u] == j.
//
// Bound: bytes.  The strip reads x (N, C) and the K rows once and does
// 2·K·N·C operations on them, about 2 operations a byte at K = 5, far
// below the ~20 f32 operations a byte at which this card's arithmetic
// would be the limit.  At the baselines' K5×N50×F158,570 that is 35 MB,
// 10.4 µs at 3.35 TB/s.
//
// Design, against what bounds it:
// * C is split across blocks so that every SM streams x: the grid is
//   (N tiles of JT = 16 columns, K tiles of KT = 8 rows, S slices of C),
//   S from kernels/gram_update.py: strip_splits (two blocks an SM, one
//   wave, at the baselines' shape; 1 at C of a few chunks).  Each slice
//   is whole 32-column chunks (gram_tile.cuh: slice_range).  With S = 1 the block
//   applies the epilogue itself; otherwise it writes its slice's partial
//   sums to an (S, K, N) f32 workspace, and a merge pass, one thread per
//   (u, j), adds the S partials in increasing slice order with Kahan
//   compensation, then applies the epilogue.  Every (u, j) sees the same
//   order of columns, slices and additions, so <a_u, a_v> == <a_v, a_u>
//   bit for bit and the scattered K x K block stays exactly symmetric.
//   Both launches go out from one C entry.
// * No thread is spent on a padded row: each of the block's 8 warps
//   owns JW = 2 columns j and all KT rows u of the tile, 16 sums a lane.
// * x is streamed with 16-byte cp.async copies into a ring of STAGES = 4
//   shared-memory buffers, three steps ahead of the FMAs, so that three
//   steps of every block are in flight at once.  A step stages TS = 128
//   columns of the KT rows and of the JT rows of x.  Rows of x start at
//   any 4-byte offset (C need not be a multiple of 4): each row segment
//   is moved as the aligned 16-byte words that cover it, the words
//   stored as they are, and the compute reads the row shifted by its
//   offset in its first word.  A word only partly inside the slice is
//   copied element by element, the rest zero-filled without a read, so
//   no copy reads outside its tensor.  In bf16 mode each thread rounds
//   the words it copied once they land, before any thread reads them.
// * Few instructions a byte, since the FMAs of 16 sums a lane would
//   otherwise outrun the copies: a lane adds its fmaf sum into its total
//   with Kahan compensation every KAHAN_STEPS = 4 steps, not every
//   step; the step loop is compiled for each count of live rows in the
//   tile (1..KT), so that at K = 5 no FMA, load or shuffle is spent on
//   the 3 padded rows; a word wholly inside the slice takes one branch.
// * Sum order: lane l sums columns f0 + l + 32v (v = 0..3) of
//   KAHAN_STEPS steps with fmaf, adds that sum to its total with Kahan
//   compensation, and the lanes' totals are added by a butterfly of
//   shuffles.
#include <stdint.h>

#include "gram_tile.cuh"

enum Epilogue { kArccos = 0, kCosine = 1, kL2 = 2 };

namespace {

constexpr int KT = 8;                 // rows u per block
constexpr int WARPS = 8;
constexpr int JW = 2;                 // columns j per warp
constexpr int JT = WARPS * JW;        // columns j per block
constexpr int THREADS = WARPS * 32;
constexpr int TS = 128;               // columns of C staged per step
constexpr int STAGES = 4;             // steps in the shared-memory ring
constexpr int KAHAN_STEPS = 4;        // steps summed before a Kahan add
constexpr int VPL = TS / 32;          // columns a lane sums per step
constexpr int SLOTS = TS / 4 + 1;     // 16-byte words covering a segment
constexpr int SROW = SLOTS * 4;       // floats per staged row
constexpr int TROWS = KT + JT;        // staged rows: the KT rows, then x
constexpr int TILE = TROWS * SROW;    // floats per ring buffer
constexpr int LOADS = (TROWS * SLOTS + THREADS - 1) / THREADS;
constexpr int RING_BYTES = STAGES * TILE * 4;  // dynamic shared memory
constexpr int MERGE_THREADS = 256;
constexpr int MERGE_OUTS = 32;        // (u, j) per merge block, one warp
constexpr int MERGE_SLICES = 64;      // partial sums staged at once

template <int V>
struct Int {
  static constexpr int value = V;
};

// cp.async of 16 (or 4) bytes from global src to the shared address
// dst, both aligned to the size.
__device__ __forceinline__ void copy16(unsigned dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void copy4(unsigned dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ inline float finish(int epilogue, float dot, int u, int j,
                               const float* __restrict__ stats_rows,
                               const float* __restrict__ stats_all,
                               const int* __restrict__ row_ids, float lam,
                               float eps) {
  const float nr = stats_rows[2 * u], nc = stats_all[2 * j];
  const bool diag = row_ids[u] == j;
  if (epilogue == kArccos) {
    return gram::eq9(dot, nr, nc, stats_rows[2 * u + 1],
                     stats_all[2 * j + 1], diag, lam, eps);
  } else if (epilogue == kCosine) {
    return gram::angle(dot, nr, nc, diag, eps);
  }
  return gram::l2(dot, nr, nc, diag);
}

// One (N tile, K tile, slice) block.  SPLIT writes the slice's partial
// sums to ws (S, K, N); otherwise (S = 1) the distances to out (K, N).
template <bool BF16, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 2)
gram_strip_kernel(const float* __restrict__ rows, const float* __restrict__ x,
                  const float* __restrict__ stats_rows,
                  const float* __restrict__ stats_all,
                  const int* __restrict__ row_ids, float* __restrict__ out,
                  float* __restrict__ ws, int k, int n, int c, int splits,
                  int epilogue, float lam, float eps) {
  extern __shared__ __align__(16) float sh[];  // STAGES * TILE floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * JT, u0 = blockIdx.y * KT, s = blockIdx.z;
  int f_begin, f_end;
  gram::slice_range(c, splits, s, &f_begin, &f_end);
  const int mis_r = (int)(((uintptr_t)rows >> 2) & 3);
  const int mis_x = (int)(((uintptr_t)x >> 2) & 3);
  const unsigned sh_addr = (unsigned)__cvta_generic_to_shared(sh);

  // This thread's words of a step: slot i moves word t of staged row r
  // to sh[buf·TILE + off[i]].  At step st the word's first element is
  // e[i] + st·TS of its matrix (a 16-byte aligned address), and its
  // element m lies rel0[i] + m columns into the step.  whole[i]: the
  // word lies inside the slice whenever the step is not its last.
  const float* src[LOADS];
  long long e[LOADS];
  int rel0[LOADS], off[LOADS];
  bool ok[LOADS], live[LOADS], whole[LOADS];
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const int id = tid + i * THREADS;
    const int r = id / SLOTS, t = id - r * SLOTS;
    const bool is_row = r < KT;
    const int g = is_row ? u0 + r : j0 + r - KT;
    const long long e0 = (long long)g * c + f_begin;
    const int d = (int)((e0 + (is_row ? mis_r : mis_x)) & 3);
    live[i] = id < TROWS * SLOTS;
    ok[i] = live[i] && g < (is_row ? k : n);
    src[i] = is_row ? rows : x;
    e[i] = e0 - d + 4 * t;
    rel0[i] = 4 * t - d;
    off[i] = r * SROW + 4 * t;
    whole[i] = ok[i] && rel0[i] >= 0;
  }
  // where this lane reads its rows u and its warp's columns j: the
  // staged row, shifted by the row's offset in its first word
  int ro[KT], xo[JW];
#pragma unroll
  for (int u = 0; u < KT; ++u) {
    const long long e0 = (long long)(u0 + u) * c + f_begin;
    ro[u] = u * SROW + (int)((e0 + mis_r) & 3) + lane;
  }
#pragma unroll
  for (int jj = 0; jj < JW; ++jj) {
    const long long e0 = (long long)(j0 + warp * JW + jj) * c + f_begin;
    xo[jj] = (KT + warp * JW + jj) * SROW + (int)((e0 + mis_x) & 3) + lane;
  }

  // copy step st into ring buffer buf: a whole word with one 16-byte
  // copy, a word only partly inside the slice element by element, and
  // zeros stored (nothing read) for what lies outside it
  auto issue = [&](int st, int buf) {
    const int lim = f_end - f_begin - st * TS;  // columns left, from here
    const bool last = lim < TS + 4;  // a word may cross the slice's end
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      if (!live[i]) continue;
      const int o = buf * TILE + off[i];
      const unsigned dst = sh_addr + 4u * (unsigned)o;
      const long long ee = e[i] + (long long)st * TS;
      const int rel = rel0[i];
      if (whole[i] && !last) {
        copy16(dst, src[i] + ee);
      } else if (!ok[i] || rel + 3 < 0 || rel >= lim) {
        *reinterpret_cast<float4*>(&sh[o]) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else if (rel >= 0 && rel + 3 < lim) {
        copy16(dst, src[i] + ee);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (rel + m >= 0 && rel + m < lim) {
            copy4(dst + 4u * m, src[i] + (ee + m));
          } else {
            sh[o + m] = 0.0f;
          }
        }
      }
    }
  };

  const int steps = (f_end - f_begin + TS - 1) / TS;
  // the step loop for KU live rows of the tile; returns this lane's sum
  // (u, jj) for lane u·JW + jj < KU·JW
  auto run = [&](auto ku) -> float {
    constexpr int KU = decltype(ku)::value;
    float acc[KU][JW], comp[KU][JW], part[KU][JW];
#pragma unroll
    for (int u = 0; u < KU; ++u) {
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) {
        acc[u][jj] = comp[u][jj] = part[u][jj] = 0.0f;
      }
    }
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < steps) issue(st, st);
      copy_commit();
    }
    for (int st = 0; st < steps; ++st) {
      const int buf = st % STAGES;
      copy_wait<STAGES - 2>();  // this thread's copies of step st landed
      if (BF16) {
#pragma unroll
        for (int i = 0; i < LOADS; ++i) {
          if (live[i]) {
            float4* w = reinterpret_cast<float4*>(&sh[buf * TILE + off[i]]);
            const float4 v = *w;
            *w = make_float4(gram::operand<BF16>(v.x),
                             gram::operand<BF16>(v.y),
                             gram::operand<BF16>(v.z),
                             gram::operand<BF16>(v.w));
          }
        }
      }
      // every thread's copies of step st are in, and every thread is
      // done with step st - 1, whose buffer the next copy reuses
      __syncthreads();
      if (st + STAGES - 1 < steps) {
        issue(st + STAGES - 1, (st + STAGES - 1) % STAGES);
      }
      copy_commit();
      const float* shb = sh + buf * TILE;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        float xv[JW];
#pragma unroll
        for (int jj = 0; jj < JW; ++jj) xv[jj] = shb[xo[jj] + 32 * v];
#pragma unroll
        for (int u = 0; u < KU; ++u) {
          const float rv = shb[ro[u] + 32 * v];
#pragma unroll
          for (int jj = 0; jj < JW; ++jj) {
            part[u][jj] = fmaf(rv, xv[jj], part[u][jj]);
          }
        }
      }
      if (st % KAHAN_STEPS == KAHAN_STEPS - 1 || st == steps - 1) {
#pragma unroll
        for (int u = 0; u < KU; ++u) {
#pragma unroll
          for (int jj = 0; jj < JW; ++jj) {
            gram::kahan_add(acc[u][jj], comp[u][jj], part[u][jj]);
            part[u][jj] = 0.0f;
          }
        }
      }
    }
    copy_wait<0>();
    // the lanes' totals, by a butterfly: every lane ends with the same
    // sum; lane u·JW + jj keeps sum (u, jj)
    float mine = 0.0f;
#pragma unroll
    for (int u = 0; u < KU; ++u) {
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) {
        float t = acc[u][jj];
#pragma unroll
        for (int m = 16; m > 0; m >>= 1) {
          t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, m));
        }
        if (lane == u * JW + jj) mine = t;
      }
    }
    return mine;
  };

  const int ku = min(KT, k - u0);
  float mine;
  switch (ku) {
    case 1: mine = run(Int<1>()); break;
    case 2: mine = run(Int<2>()); break;
    case 3: mine = run(Int<3>()); break;
    case 4: mine = run(Int<4>()); break;
    case 5: mine = run(Int<5>()); break;
    case 6: mine = run(Int<6>()); break;
    case 7: mine = run(Int<7>()); break;
    default: mine = run(Int<KT>()); break;
  }
  if (lane < ku * JW) {
    const int u = u0 + lane / JW, j = j0 + warp * JW + lane % JW;
    if (j < n) {
      if (SPLIT) {
        ws[((size_t)s * k + u) * n + j] = mine;
      } else {
        out[(size_t)u * n + j] = finish(epilogue, mine, u, j, stats_rows,
                                        stats_all, row_ids, lam, eps);
      }
    }
  }
}

// The slices' partial sums of (u, j) in increasing slice order, with
// Kahan compensation, then the epilogue.  A block takes MERGE_OUTS
// consecutive (u, j): all its threads stage MERGE_SLICES slices of their
// partial sums in shared memory at a time, and one warp adds them, a
// lane per (u, j), in slice order.
__global__ void gram_strip_merge_kernel(const float* __restrict__ ws,
                                        const float* __restrict__ stats_rows,
                                        const float* __restrict__ stats_all,
                                        const int* __restrict__ row_ids,
                                        float* __restrict__ out, int k, int n,
                                        int splits, int epilogue, float lam,
                                        float eps) {
  __shared__ float part[MERGE_SLICES][MERGE_OUTS];
  const long long kn = (long long)k * n;
  const long long idx0 = (long long)blockIdx.x * MERGE_OUTS;
  const int tid = threadIdx.x;
  float acc = 0.0f, comp = 0.0f;
  for (int s0 = 0; s0 < splits; s0 += MERGE_SLICES) {
    for (int e = tid; e < MERGE_SLICES * MERGE_OUTS; e += MERGE_THREADS) {
      const int ss = s0 + e / MERGE_OUTS;
      const long long idx = idx0 + e % MERGE_OUTS;
      part[e / MERGE_OUTS][e % MERGE_OUTS] =
          ss < splits && idx < kn ? ws[ss * kn + idx] : 0.0f;
    }
    __syncthreads();
    if (tid < MERGE_OUTS) {
      const int last = min(MERGE_SLICES, splits - s0);
#pragma unroll 8
      for (int ss = 0; ss < last; ++ss) {
        gram::kahan_add(acc, comp, part[ss][tid]);
      }
    }
    __syncthreads();
  }
  const long long idx = idx0 + tid;
  if (tid < MERGE_OUTS && idx < kn) {
    const int u = (int)(idx / n), j = (int)(idx % n);
    out[idx] = finish(epilogue, acc, u, j, stats_rows, stats_all, row_ids,
                      lam, eps);
  }
}

template <bool BF16>
int launch(const float* rows, const float* x, const float* sr,
           const float* sa, const int* ids, float* out, float* ws, int k,
           int n, int c, int splits, int epilogue, float lam, float eps,
           cudaStream_t s) {
  // the ring is above the 48 KB of static shared memory: opt in once
  static const int opt_in = [] {
    const int a = (int)cudaFuncSetAttribute(
        gram_strip_kernel<BF16, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    const int b = (int)cudaFuncSetAttribute(
        gram_strip_kernel<BF16, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, RING_BYTES);
    return a != 0 ? a : b;
  }();
  if (opt_in != 0) return opt_in;
  const dim3 grid((n + JT - 1) / JT, (k + KT - 1) / KT, splits);
  if (splits == 1) {
    gram_strip_kernel<BF16, false><<<grid, THREADS, RING_BYTES, s>>>(
        rows, x, sr, sa, ids, out, nullptr, k, n, c, 1, epilogue, lam, eps);
    return (int)cudaGetLastError();
  }
  gram_strip_kernel<BF16, true><<<grid, THREADS, RING_BYTES, s>>>(
      rows, x, sr, sa, ids, nullptr, ws, k, n, c, splits, epilogue, lam, eps);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long kn = (long long)k * n;
  gram_strip_merge_kernel<<<(unsigned)((kn + MERGE_OUTS - 1) / MERGE_OUTS),
                            MERGE_THREADS, 0, s>>>(ws, sr, sa, ids, out, k, n,
                                                   splits, epilogue, lam, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (k, c), x (n, c), stats_rows (k, 2), stats_all (n, 2) f32 with
// lanes [norm, entropy]; row_ids (k,) int32; out (k, n) f32; workspace
// (splits, k, n) f32, unread when splits == 1; splits in [1, 65535];
// epilogue 0 arccos, 1 cosine, 2 l2; bf16 0 (f32 operands) or 1 (bf16
// operands).  Returns cudaErrorInvalidValue for another code, or for
// splits > 1 without a workspace.
extern "C" int gram_strip_launch(const void* rows, const void* x,
                                 const void* stats_rows,
                                 const void* stats_all, const void* row_ids,
                                 void* out, void* workspace, int k, int n,
                                 int c, int splits, float lam, float eps,
                                 int epilogue, int bf16, void* stream) {
  if (epilogue < kArccos || epilogue > kL2 || (bf16 != 0 && bf16 != 1) ||
      splits < 1 || splits > 65535 || (splits > 1 && workspace == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (k > 0 && n > 0) {
    const float *r = (const float*)rows, *xx = (const float*)x,
                *sr = (const float*)stats_rows, *sa = (const float*)stats_all;
    const int* ids = (const int*)row_ids;
    float *o = (float*)out, *ws = (float*)workspace;
    const cudaStream_t s = (cudaStream_t)stream;
    return bf16 ? launch<true>(r, xx, sr, sa, ids, o, ws, k, n, c, splits,
                               epilogue, lam, eps, s)
                : launch<false>(r, xx, sr, sa, ids, o, ws, k, n, c, splits,
                                epilogue, lam, eps, s);
  }
  return (int)cudaGetLastError();
}
