// Full (N, N) Eq. 9 distance matrix with the diagonal zeroed.
//
// Replaces src/repro/kernels/pairwise.py:_pairwise_kernel.  The same
// tile loop as the strip kernel over (N tiles, N tiles).  At the slice's
// shape (N=50, C=10) the time is launch latency; at N=512, C=1024 each
// block reads two 16-row tiles, so x is read N/16 times from L2 and the
// kernel is bound by its loads from shared memory, not by device memory.
#include "gram_tile.cuh"

__global__ void pairwise_kernel(const float* __restrict__ x,
                                const float* __restrict__ stats,
                                float* __restrict__ out, int n, int c,
                                float lam, float eps) {
  const int row0 = blockIdx.y * gram::TM, col0 = blockIdx.x * gram::TN;
  const float acc = gram::tile_dot(x, n, x, n, c, row0, col0);
  const int i = row0 + threadIdx.y, j = col0 + threadIdx.x;
  if (i < n && j < n) {
    out[(size_t)i * n + j] =
        gram::eq9(acc, stats[2 * i], stats[2 * j], stats[2 * i + 1],
                  stats[2 * j + 1], i == j, lam, eps);
  }
}

// x (n, c) f32, stats (n, 2) f32 = [norm, entropy]; out (n, n) f32.
extern "C" int pairwise_launch(const void* x, const void* stats, void* out,
                               int n, int c, float lam, float eps,
                               void* stream) {
  if (n > 0) {
    const dim3 block(gram::TN, gram::TM);
    const dim3 grid((n + gram::TN - 1) / gram::TN,
                    (n + gram::TM - 1) / gram::TM);
    pairwise_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)stats, (float*)out, n, c, lam, eps);
  }
  return (int)cudaGetLastError();
}
