// K x N Eq. 9 distance strip: the refreshed rows against every row.
//
// Replaces src/repro/kernels/gram_update.py:_gram_row_kernel (arccos
// epilogue).  out[u, j] = eq9(<rows[u], x[j]>, stats_rows[u],
// stats_all[j]) with the angle zeroed where row_ids[u] == j.  At the
// slice's shapes (K=5, N=50, C=10) the work is a few thousand flops and
// the time is launch latency; at K=10, N=512, C=1024 it reads x once
// per row tile (one tile for K <= 16), so it is bound by the bytes of x.
#include "gram_tile.cuh"

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
    out[(size_t)u * n + j] = gram::eq9(
        acc, stats_rows[2 * u], stats_all[2 * j], stats_rows[2 * u + 1],
        stats_all[2 * j + 1], row_ids[u] == j, lam, eps);
  }
}

// rows (k, c), x (n, c), stats_rows (k, 2), stats_all (n, 2) f32 with
// lanes [norm, entropy]; row_ids (k,) int32; out (k, n) f32.
extern "C" int gram_strip_launch(const void* rows, const void* x,
                                 const void* stats_rows,
                                 const void* stats_all, const void* row_ids,
                                 void* out, int k, int n, int c, float lam,
                                 float eps, void* stream) {
  if (k > 0 && n > 0) {
    const dim3 block(gram::TN, gram::TM);
    const dim3 grid((n + gram::TN - 1) / gram::TN,
                    (k + gram::TM - 1) / gram::TM);
    gram_strip_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const float*)x, (const float*)stats_rows,
        (const float*)stats_all, (const int*)row_ids, (float*)out, k, n, c,
        lam, eps);
  }
  return (int)cudaGetLastError();
}
