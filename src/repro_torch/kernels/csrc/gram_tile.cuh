// Shared tile loop and Eq. 9 epilogue of the two Gram kernels
// (gram_update.cu, pairwise.cu).
//
// One block of TN x TM threads computes a TM x TN tile of A·Bᵀ.  Row
// and column tiles of the operands are staged through shared memory in
// chunks of TC columns, and each thread keeps its output's sum in one
// f32 register.  The sum over C is taken in one fixed order, one fmaf
// per column in increasing c, with no split-K and no atomics.  fmaf's
// two factors commute exactly, so <a_u, a_v> and <a_v, a_u> are
// bit-equal, and so are the distances built from them: the K x K block
// of the scattered cache and the pairwise matrix are exactly symmetric.
#pragma once

#include <cuda_runtime.h>

namespace gram {

constexpr int TM = 16;  // output rows per block (threadIdx.y)
constexpr int TN = 16;  // output columns per block (threadIdx.x)
constexpr int TC = 32;  // columns of C staged per chunk

// Eq. 9 clip bounds, the f32 values of the reference's python floats.
constexpr float COS_LO = static_cast<float>(-1.0 + 1e-7);
constexpr float COS_HI = static_cast<float>(1.0 - 1e-7);

// <a[row0 + threadIdx.y], b[col0 + threadIdx.x]> over c in [0, c).
// a is (ra, c) and b is (rb, c), both row-major f32.  Out-of-range rows
// read zeros; their results are discarded by the caller.
__device__ inline float tile_dot(const float* __restrict__ a, int ra,
                                 const float* __restrict__ b, int rb,
                                 int c, int row0, int col0) {
  __shared__ float as[TM][TC + 1];
  __shared__ float bs[TN][TC + 1];
  const int tid = threadIdx.y * TN + threadIdx.x;
  float acc = 0.0f;
  for (int c0 = 0; c0 < c; c0 += TC) {
    // neighbouring threads read neighbouring columns of one row
    for (int e = tid; e < TM * TC; e += TM * TN) {
      const int r = e / TC, cc = e % TC;
      const int gr = row0 + r, gc = c0 + cc;
      as[r][cc] = (gr < ra && gc < c) ? a[(size_t)gr * c + gc] : 0.0f;
    }
    for (int e = tid; e < TN * TC; e += TM * TN) {
      const int r = e / TC, cc = e % TC;
      const int gr = col0 + r, gc = c0 + cc;
      bs[r][cc] = (gr < rb && gc < c) ? b[(size_t)gr * c + gc] : 0.0f;
    }
    __syncthreads();
    const int lim = min(TC, c - c0);
    for (int kk = 0; kk < lim; ++kk) {
      acc = fmaf(as[threadIdx.y][kk], bs[threadIdx.x][kk], acc);
    }
    __syncthreads();
  }
  return acc;
}

// arccos(clip(dot / (max(|a|, eps) max(|b|, eps)))) + lam |Ĥa - Ĥb|,
// with the angle zeroed on the true diagonal.  Divides after the dot,
// as the TPU kernel does.
__device__ inline float eq9(float dot, float na, float nb, float ha,
                            float hb, bool diag, float lam, float eps) {
  const float denom = fmaxf(na, eps) * fmaxf(nb, eps);
  const float cs = fminf(fmaxf(dot / denom, COS_LO), COS_HI);
  const float ang = diag ? 0.0f : acosf(cs);
  return ang + lam * fabsf(ha - hb);
}

}  // namespace gram
