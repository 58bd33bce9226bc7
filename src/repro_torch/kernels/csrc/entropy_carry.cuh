// The split-row online-softmax sweep shared by fused_stats.cu and
// hetero_entropy.cu.
//
// A carry (m, Z, S) describes a set of values u by their running max
// m, Z = sum exp(u - m) and S = sum exp(u - m) (u - m); the entropy of
// softmax(u) is ln Z - S / Z.  Two carries merge at m' = max(m, m_o):
// each Z is rescaled by exp(m_i - m'), each S by the same factor after
// a shift of (m_i - m') Z_i.  An empty carry is (NEG, 0, 0): NEG is a
// finite -inf, so merging it costs no NaN.
//
// Both kernels read each row of x once and write a few floats, so on
// the H100 they are bound by the bytes of x.  One block a row (or one
// warp) leaves most of the 132 SMs idle at the row counts the callers
// have (2 to 64 rows), so here each row is split across the P blocks of
// one thread-block cluster (P <= 8, the portable cluster size):
//
//  * block `rank` of a cluster takes columns [lo, hi) of the row
//    (slice_range: whole UNIT-column units, the last cut at C; a slice
//    may be empty).  It walks them in 16-byte vector loads, UNROLL in
//    flight a thread, neighbouring threads on neighbouring vectors; the
//    columns before the slice's first 16-byte boundary and after its
//    last whole vector (a row of width C starts at any 4- or 2-byte
//    offset) are read one a thread.
//  * each thread keeps its own carry and rescales it once per chunk by
//    the chunk's max, so a column costs one expf.  The softmax reads
//    the reference's u: x * scale (fused_stats) or x / T
//    (hetero_entropy), the quotient computed without a divide a column
//    (divide() below).
//  * the block reduces to one carry (shuffles, then shared memory),
//    plus its sum of squares.
//  * after cluster.sync(), rank 0 reads the P carries from distributed
//    shared memory in rank order, merges them and writes the row's
//    outputs; a second cluster.sync() keeps every block's shared memory
//    alive until then.  No global scratch, no atomics: two calls are
//    bit-equal.
//  * normalize (fused_stats): pass 1 sums x² over the slice, the
//    cluster adds the P sums in rank order so that every block holds
//    the row's RMS, and pass 2 runs the carry over x * scale,
//    scale = 1 / (max(RMS, 1e-12) * T), in the same launch.  The
//    first chunk of a thread's share stays in registers between the
//    passes (all of it at the slice's C = 10); the rest is read again,
//    from L2.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace carry {

namespace cg = cooperative_groups;

constexpr float NEG = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNIT = 32;       // slice boundaries fall on UNIT columns
constexpr int MAX_SPLITS = 8;  // the portable cluster size

__device__ inline void merge(float& m, float& z, float& s, float m_o,
                             float z_o, float s_o) {
  const float m_new = fmaxf(m, m_o);
  const float a = expf(m - m_new), b = expf(m_o - m_new);
  s = (s + (m - m_new) * z) * a + (s_o + (m_o - m_new) * z_o) * b;
  z = z * a + z_o * b;
  m = m_new;
}

// Merge the 32 lanes' carries of a warp; every lane ends with the sum.
__device__ inline void warp_merge(float& m, float& z, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float z_o = __shfl_xor_sync(0xffffffffu, z, off);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, off);
    merge(m, z, s, m_o, z_o, s_o);
  }
}

__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Columns [lo, hi) of slice `rank` of `splits`: whole UNIT-column units,
// the last cut at c.  ref.py: stats_slice_ranges.
__device__ inline void slice_range(int c, int splits, int rank, int& lo,
                                   int& hi) {
  const long long units = (c + UNIT - 1) / UNIT;
  lo = static_cast<int>(units * rank / splits) * UNIT;
  hi = min(static_cast<int>(units * (rank + 1) / splits) * UNIT, c);
}

// 16-byte loads widened to f32: 4 f32 or 8 bf16 (bf16 -> f32 is exact:
// the bf16 bits are the top half of the f32).  A thread loads UNROLL
// vectors a chunk, 16 values of either type: 32 bf16 values a chunk
// took 54 registers a thread and ran slower on the H100, and so did a
// prefetch of the next chunk (more registers, fewer resident blocks).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4, UNROLL = 4;
  __device__ static void load(const float* p, float (&v)[N]) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static float scalar(const float* p) { return __ldg(p); }
};

template <>
struct Vec<uint16_t> {
  static constexpr int N = 8, UNROLL = 2;
  __device__ static void load(const uint16_t* p, float (&v)[N]) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static float scalar(const uint16_t* p) {
    return __uint_as_float(static_cast<unsigned>(__ldg(p)) << 16);
  }
};

// One block's slice [lo, hi) of a row: the scalar head up to the first
// 16-byte boundary a, nv whole vectors from a, the scalar tail from
// `tail` to hi.
template <typename T>
struct Slice {
  static constexpr int N = Vec<T>::N, UNROLL = Vec<T>::UNROLL;
  const T* row;
  int lo, hi, a, nv, tail;

  __device__ Slice(const T* row_, int lo_, int hi_)
      : row(row_), lo(lo_), hi(hi_) {
    const uintptr_t addr = reinterpret_cast<uintptr_t>(row + lo);
    const int head = static_cast<int>(((16 - (addr & 15)) & 15) / sizeof(T));
    a = lo + min(head, hi - lo);
    nv = (hi - a) / N;
    tail = a + nv * N;
  }

  // thread t's column of the head and tail (at most 2N - 2 in all), or -1
  __device__ int leftover(int t) const {
    const int head = a - lo;
    if (t < head) return lo + t;
    t -= head;
    return t < hi - tail ? tail + t : -1;
  }

  __device__ int chunks() const {
    return (nv + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  }

  // this thread's vectors of chunk k: k·THREADS·UNROLL + i·THREADS + tid
  __device__ void load(int k, float (&v)[UNROLL][N], bool (&ok)[UNROLL])
      const {
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int j = (k * UNROLL + i) * THREADS + threadIdx.x;
      ok[i] = j < nv;
      if (ok[i]) {
        Vec<T>::load(row + a + static_cast<size_t>(j) * N, v[i]);
      } else {
#pragma unroll
        for (int e = 0; e < N; ++e) v[i][e] = 0.0f;
      }
    }
  }
};

// Fold R·N values u (row i valid where ok[i]) into the thread's carry:
// one rescale by the values' max, then one expf a value.
template <int R, int N>
__device__ inline void fold(float& m, float& z, float& s,
                           const float (&u)[R][N], const bool (&ok)[R]) {
  float mc = NEG;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok[i]) mc = fmaxf(mc, u[i][e]);
  const float mn = fmaxf(m, mc);
  const float a = expf(m - mn);
  s = (s + (m - mn) * z) * a;
  z *= a;
  m = mn;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok[i]) {
        const float d = u[i][e] - m;
        const float ex = expf(d);
        z += ex;
        s = fmaf(ex, d, s);
      }
}

template <int R, int N>
__device__ inline void sum_squares(float& ss, const float (&v)[R][N],
                                   const bool (&ok)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (ok[i]) ss = fmaf(v[i][e], v[i][e], ss);
}

// Block reductions: shuffles within each warp, then warp 0 over the
// warps' results in `part` (rows 0-2 the carry, row 3 the sum, so the
// two can follow each other without a barrier); thread 0 ends with the
// block's value.
__device__ inline void block_merge(float& m, float& z, float& s,
                                   float (&part)[4][WARPS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  warp_merge(m, z, s);
  if (lane == 0) {
    part[0][warp] = m;
    part[1][warp] = z;
    part[2][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < WARPS;
    m = has ? part[0][lane] : NEG;
    z = has ? part[1][lane] : 0.0f;
    s = has ? part[2][lane] : 0.0f;
    warp_merge(m, z, s);
  }
}

__device__ inline float block_sum(float v, float (&part)[4][WARPS]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) part[3][warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_sum(lane < WARPS ? part[3][lane] : 0.0f);
  return v;
}

// What the softmax reads: x / T (hetero_entropy, as the reference's
// _entropy_kernel), x * scale (fused_stats, with a per-row scale, 1/T,
// or, under normalize, 1 / (max(RMS, 1e-12) T) from pass 1).
enum Mode { kEntropy = 0, kStats = 1, kNormalize = 2 };

// x / T without a divide a column: q = x r with r = 1/T rounded once,
// then Markstein's correction q + (x - q T) r, whose remainder x - q T
// an fma gives exactly.  That is IEEE x / T, bit for bit, unless the
// remainder underflows (|x| below ~1e-31, where the two may differ by
// one ulp of a value under 1e-29).  The IEEE divide, ~10 instructions
// and a branch a column, made hetero_entropy instruction-bound on the H100:
// bf16 took longer than f32, which reads twice the bytes.
__device__ inline float divide(float v, float t, float r) {
  const float q = v * r;
  return fmaf(fmaf(-q, t, v), r, q);
}

template <int MODE>
__device__ inline float transform(float v, float k, float r) {
  return MODE == kEntropy ? divide(v, k, r) : v * k;
}

template <int MODE, int R, int N>
__device__ inline void fold_scaled(float& m, float& z, float& s,
                                   const float (&v)[R][N],
                                   const bool (&ok)[R], float k, float r) {
  float u[R][N];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < N; ++e) u[i][e] = transform<MODE>(v[i][e], k, r);
  fold(m, z, s, u, ok);
}

// One row per cluster of `splits` blocks (grid = N·splits blocks,
// cluster dims (splits, 1, 1)).  `k` is T (kEntropy) or 1/T (kStats,
// when row_scale is null); `temperature` is T under kNormalize.  ent
// always; norm and rms unless kEntropy.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS)
split_row_kernel(const T* __restrict__ x, int c, int splits, float k,
                 const float* __restrict__ row_scale, float temperature,
                 float* __restrict__ ent, float* __restrict__ norm,
                 float* __restrict__ rms) {
  constexpr int N = Vec<T>::N, UNROLL = Vec<T>::UNROLL;
  __shared__ float part[4][WARPS];
  __shared__ float mine[4];  // this block's (m, Z, S, sum x²)
  __shared__ float row_k;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / splits;
  int lo, hi;
  slice_range(c, splits, rank, lo, hi);
  const Slice<T> sl(x + static_cast<size_t>(row) * c, lo, hi);
  const int nch = sl.chunks();

  float lv[1][1] = {{0.0f}};
  bool lok[1] = {false};
  const int lcol = sl.leftover(threadIdx.x);
  if (lcol >= 0) {
    lv[0][0] = Vec<T>::scalar(sl.row + lcol);
    lok[0] = true;
  }
  float v[UNROLL][N];
  bool ok[UNROLL];
  sl.load(0, v, ok);

  float m = NEG, z = 0.0f, s = 0.0f, ss = 0.0f;
  if (MODE == kNormalize) {
    // pass 1: the row's sum of squares, across the cluster
    sum_squares(ss, lv, lok);
    sum_squares(ss, v, ok);
    for (int ch = 1; ch < nch; ++ch) {
      float w[UNROLL][N];
      bool okw[UNROLL];
      sl.load(ch, w, okw);
      sum_squares(ss, w, okw);
    }
    ss = block_sum(ss, part);
    if (threadIdx.x == 0) mine[3] = ss;
    cluster.sync();
    if (threadIdx.x == 0) {
      float tot = 0.0f;
      for (int b = 0; b < splits; ++b)
        tot += *cluster.map_shared_rank(&mine[3], b);
      ss = tot;
      row_k = 1.0f / (fmaxf(sqrtf(tot / static_cast<float>(c)), 1e-12f) *
                      temperature);
    }
    __syncthreads();
    k = row_k;
  } else if (MODE == kStats) {
    if (row_scale != nullptr) k = row_scale[row];
    sum_squares(ss, lv, lok);
    sum_squares(ss, v, ok);
  }
  // the carry over the slice (pass 2 under normalize)
  const float r = MODE == kEntropy ? 1.0f / k : 0.0f;
  fold_scaled<MODE>(m, z, s, lv, lok, k, r);
  fold_scaled<MODE>(m, z, s, v, ok, k, r);
  for (int ch = 1; ch < nch; ++ch) {
    sl.load(ch, v, ok);
    if (MODE == kStats) sum_squares(ss, v, ok);
    fold_scaled<MODE>(m, z, s, v, ok, k, r);
  }
  block_merge(m, z, s, part);
  if (MODE == kStats) ss = block_sum(ss, part);
  if (threadIdx.x == 0) {
    mine[0] = m;
    mine[1] = z;
    mine[2] = s;
    if (MODE == kStats) mine[3] = ss;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float tot = MODE == kStats ? mine[3] : ss;
    for (int b = 1; b < splits; ++b) {
      const float* o = cluster.map_shared_rank(mine, b);
      merge(m, z, s, o[0], o[1], o[2]);
      if (MODE == kStats) tot += o[3];
    }
    ent[row] = logf(z) - s / z;
    if (MODE != kEntropy) {
      norm[row] = sqrtf(tot);
      rms[row] = sqrtf(tot / static_cast<float>(c));
    }
  }
  // no block exits while rank 0 may still read its shared memory
  cluster.sync();
}

// Launch `kernel` over n rows of `splits` blocks each, one cluster a
// row.  The cluster size is a field of this call's launch config (P <=
// 8 is portable, so no function attribute is needed); a cluster the
// card cannot schedule is refused here, and the error returned.
template <typename... Exp, typename... Act>
inline int launch_split_rows(void (*kernel)(Exp...), int n, int splits,
                             cudaStream_t stream, Act&&... args) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (splits < 1 || splits > MAX_SPLITS ||
      static_cast<long long>(n) * splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(n * splits));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Act&&>(args)...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace carry
