// H(softmax(x / T)) of each row of x (N, C), f32 or bf16 in, f32 out.
//
// Replaces src/repro/kernels/hetero_entropy.py:_entropy_kernel
// (entropy_pallas).  The TPU kernel walks C in 512-wide blocks in grid
// order and carries (m, Z, S) in VMEM scratch from block to block.
// Here one block of 512 threads takes one row: each thread walks the
// row in chunks of UNROLL columns strided by the block (neighbouring
// threads on neighbouring columns), holds its own carry, and rescales
// it once per chunk by the chunk's max, so a column costs one expf.
// The 512 carries merge by shuffle within each warp and then through
// shared memory (entropy_carry.cuh).  Columns past C are masked
// explicitly: they never enter Z or S, whatever the running max is.
//
// The function reads N·C elements once and writes N floats, so on the
// H100 it is bound by memory bytes.  One block per row fills the card
// only when N is in the hundreds; at N = 64 it uses 64 of 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy_carry.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 8;

__device__ inline float load(const float* x, int j) { return x[j]; }

// bf16 -> f32 is exact: the bf16 bits are the top half of the f32.
__device__ inline float load(const uint16_t* x, int j) {
  return __uint_as_float(static_cast<unsigned>(x[j]) << 16);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
entropy_kernel(const T* __restrict__ x, float* __restrict__ out, int c,
               float temperature) {
  __shared__ float part[3][THREADS / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * c;
  const int tid = threadIdx.x;
  float m = carry::NEG, z = 0.0f, s = 0.0f;
  for (int base = 0; base < c; base += THREADS * UNROLL) {
    float u[UNROLL];
    float m_chunk = carry::NEG;
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      const int j = base + i * THREADS + tid;
      u[i] = j < c ? load(xr, j) / temperature : carry::NEG;
      m_chunk = fmaxf(m_chunk, u[i]);
    }
    const float m_new = fmaxf(m, m_chunk);
    const float a = expf(m - m_new);
    s = (s + (m - m_new) * z) * a;
    z *= a;
    m = m_new;
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      if (base + i * THREADS + tid < c) {
        const float d = u[i] - m;
        const float e = expf(d);
        z += e;
        s = fmaf(e, d, s);
      }
    }
  }
  carry::warp_merge(m, z, s);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    part[0][warp] = m;
    part[1][warp] = z;
    part[2][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < THREADS / 32;
    m = has ? part[0][lane] : carry::NEG;
    z = has ? part[1][lane] : 0.0f;
    s = has ? part[2][lane] : 0.0f;
    carry::warp_merge(m, z, s);
    if (lane == 0) out[blockIdx.x] = logf(z) - s / z;
  }
}

}  // namespace

// x (n, c) row-major, f32 (bf16 == 0) or bf16 (bf16 != 0); out (n,) f32.
extern "C" int entropy_launch(const void* x, void* out, int n, int c,
                              float temperature, int bf16, void* stream) {
  if (n > 0 && c > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16) {
      entropy_kernel<uint16_t><<<n, THREADS, 0, st>>>(
          static_cast<const uint16_t*>(x), static_cast<float*>(out), c,
          temperature);
    } else {
      entropy_kernel<float><<<n, THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<float*>(out), c,
          temperature);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
