// Full (N, N) Eq. 9 distance matrix with the diagonal zeroed.
//
// Replaces src/repro/kernels/pairwise.py:_pairwise_kernel with both of
// its operand modes (gram_in_bf16, pairwise.py:116-117,159): the
// operand mode is a template parameter, chosen at run time by the code
// the C entry takes.  gram_tile.cuh's tile loop over (N tiles,
// N tiles).  At the slice's shape (N=50, C=10) the time is launch
// latency; at N=512, C=1024 each block reads two 16-row tiles, so x is
// read N/16 times from L2 and the kernel is bound by its loads from
// shared memory, not by device memory.
#include "gram_tile.cuh"

template <bool BF16>
__global__ void pairwise_kernel(const float* __restrict__ x,
                                const float* __restrict__ stats,
                                float* __restrict__ out, int n, int c,
                                float lam, float eps) {
  const int row0 = blockIdx.y * gram::TM, col0 = blockIdx.x * gram::TN;
  const float acc = gram::tile_dot<BF16>(x, n, x, n, c, row0, col0);
  const int i = row0 + threadIdx.y, j = col0 + threadIdx.x;
  if (i < n && j < n) {
    out[(size_t)i * n + j] =
        gram::eq9(acc, stats[2 * i], stats[2 * j], stats[2 * i + 1],
                  stats[2 * j + 1], i == j, lam, eps);
  }
}

// x (n, c) f32, stats (n, 2) f32 = [norm, entropy]; out (n, n) f32;
// bf16 0 (f32 operands) or 1 (bf16 operands), cudaErrorInvalidValue
// for another code.
extern "C" int pairwise_launch(const void* x, const void* stats, void* out,
                               int n, int c, float lam, float eps, int bf16,
                               void* stream) {
  if (bf16 != 0 && bf16 != 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const dim3 block(gram::TN, gram::TM);
    const dim3 grid((n + gram::TN - 1) / gram::TN,
                    (n + gram::TM - 1) / gram::TM);
    const cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
      pairwise_kernel<true><<<grid, block, 0, s>>>(
          (const float*)x, (const float*)stats, (float*)out, n, c, lam, eps);
    } else {
      pairwise_kernel<false><<<grid, block, 0, s>>>(
          (const float*)x, (const float*)stats, (float*)out, n, c, lam, eps);
    }
  }
  return (int)cudaGetLastError();
}
