// One pass per row of x: entropy of softmax(x * scale), L2 norm, RMS.
//
// Replaces src/repro/kernels/fused_stats.py:_fused_stats_kernel.  One
// warp per row.  Each lane walks the row's columns lane, lane + 32, ...
// with an online-softmax carry (m, Z, S) of u = x * scale plus the sum
// of squares, where Z = sum exp(u - m) and S = sum exp(u - m) (u - m).
// The 32 carries are merged by shuffle (entropy_carry.cuh).  Outputs
// Ĥ = ln Z - S / Z, sqrt(sum x²) and sqrt(sum x² / C).  It reads
// (N, C) once and writes 3N floats, so it is bound by memory bytes;
// at the slice's C=10 the time is launch latency.
#include <cuda_runtime.h>

#include "entropy_carry.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void fused_stats_kernel(const float* __restrict__ x,
                                   const float* __restrict__ scale,
                                   float* __restrict__ ent,
                                   float* __restrict__ norm,
                                   float* __restrict__ rms, int n, int c) {
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;  // uniform across the warp
  const float* xr = x + (size_t)row * c;
  const float sc = scale[row];
  float m = carry::NEG, z = 0.0f, s = 0.0f, ss = 0.0f;
  for (int j = lane; j < c; j += 32) {
    const float v = xr[j];
    carry::merge(m, z, s, v * sc, 1.0f, 0.0f);
    ss = fmaf(v, v, ss);
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float z_o = __shfl_xor_sync(0xffffffffu, z, off);
    const float s_o = __shfl_xor_sync(0xffffffffu, s, off);
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
    carry::merge(m, z, s, m_o, z_o, s_o);
  }
  if (lane == 0) {
    ent[row] = logf(z) - s / z;
    norm[row] = sqrtf(ss);
    rms[row] = sqrtf(ss / (float)c);
  }
}

}  // namespace

// x (n, c) f32, scale (n,) f32; ent, norm, rms (n,) f32.
extern "C" int fused_stats_launch(const void* x, const void* scale,
                                  void* ent, void* norm, void* rms, int n,
                                  int c, void* stream) {
  if (n > 0) {
    const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    fused_stats_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                         (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (float*)ent, (float*)norm,
        (float*)rms, n, c);
  }
  return (int)cudaGetLastError();
}
