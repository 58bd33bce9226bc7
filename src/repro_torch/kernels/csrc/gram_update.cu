// K x N distance strip: the refreshed rows against every row.
//
// Replaces src/repro/kernels/gram_update.py:_gram_row_kernel with all
// three of its epilogues (EPILOGUES, gram_update.py:53-59), chosen at
// compile time by the template parameter and at run time by the code
// the C entry takes:
//   0 arccos  out[u, j] = eq9(<rows[u], x[j]>, stats_rows[u],
//             stats_all[j]) (HiCS, Eq. 9);
//   1 cosine  the angle alone; lanes [:, 1] of the stats are not read
//             (Clustered Sampling);
//   2 l2      sqrt(|a|² + |b|² − 2<a, b>) from the cached norms (DivFL).
// Every epilogue is zeroed where row_ids[u] == j.  The dot product is
// gram::tile_dot's fixed-order fmaf sum, so <a_u, a_v> == <a_v, a_u>
// bit for bit, and each epilogue keeps that symmetry (gram_tile.cuh).
//
// One block per 16 x 16 output tile walks the whole of C, so a strip of
// K <= 16 rows runs ceil(N / 16) blocks: 4 at the baselines' N = 50,
// each reading its 16 columns of x once (4,956 chunks of 32 columns at
// F = 158,570).  That leaves 128 of the 132 SMs idle, and the kernel is
// bound by each block's load latency, not by device memory; splitting
// C across blocks would need a merge whose order breaks the exact
// symmetry.  At the HiCS slice's C = 10 the time is the launch.
#include "gram_tile.cuh"

enum Epilogue { kArccos = 0, kCosine = 1, kL2 = 2 };

template <int EPI>
__global__ void gram_strip_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ x,
                                  const float* __restrict__ stats_rows,
                                  const float* __restrict__ stats_all,
                                  const int* __restrict__ row_ids,
                                  float* __restrict__ out, int k, int n,
                                  int c, float lam, float eps) {
  const int row0 = blockIdx.y * gram::TM, col0 = blockIdx.x * gram::TN;
  const float acc = gram::tile_dot(rows, k, x, n, c, row0, col0);
  const int u = row0 + threadIdx.y, j = col0 + threadIdx.x;
  if (u < k && j < n) {
    const float nr = stats_rows[2 * u], nc = stats_all[2 * j];
    const bool diag = row_ids[u] == j;
    float d;
    if (EPI == kArccos) {
      d = gram::eq9(acc, nr, nc, stats_rows[2 * u + 1],
                    stats_all[2 * j + 1], diag, lam, eps);
    } else if (EPI == kCosine) {
      d = gram::angle(acc, nr, nc, diag, eps);
    } else {
      d = gram::l2(acc, nr, nc, diag);
    }
    out[(size_t)u * n + j] = d;
  }
}

// rows (k, c), x (n, c), stats_rows (k, 2), stats_all (n, 2) f32 with
// lanes [norm, entropy]; row_ids (k,) int32; out (k, n) f32; epilogue
// 0 arccos, 1 cosine, 2 l2.  Returns cudaErrorInvalidValue for another
// epilogue code.
extern "C" int gram_strip_launch(const void* rows, const void* x,
                                 const void* stats_rows,
                                 const void* stats_all, const void* row_ids,
                                 void* out, int k, int n, int c, float lam,
                                 float eps, int epilogue, void* stream) {
  if (epilogue < kArccos || epilogue > kL2) {
    return (int)cudaErrorInvalidValue;
  }
  if (k > 0 && n > 0) {
    const dim3 block(gram::TN, gram::TM);
    const dim3 grid((n + gram::TN - 1) / gram::TN,
                    (k + gram::TM - 1) / gram::TM);
    const cudaStream_t s = (cudaStream_t)stream;
    const float *r = (const float*)rows, *xx = (const float*)x,
                *sr = (const float*)stats_rows, *sa = (const float*)stats_all;
    const int* ids = (const int*)row_ids;
    float* o = (float*)out;
    if (epilogue == kArccos) {
      gram_strip_kernel<kArccos><<<grid, block, 0, s>>>(
          r, xx, sr, sa, ids, o, k, n, c, lam, eps);
    } else if (epilogue == kCosine) {
      gram_strip_kernel<kCosine><<<grid, block, 0, s>>>(
          r, xx, sr, sa, ids, o, k, n, c, lam, eps);
    } else {
      gram_strip_kernel<kL2><<<grid, block, 0, s>>>(
          r, xx, sr, sa, ids, o, k, n, c, lam, eps);
    }
  }
  return (int)cudaGetLastError();
}
