// The online-softmax entropy carry shared by fused_stats.cu and
// hetero_entropy.cu.
//
// A carry (m, Z, S) describes a set of values u by their running max
// m, Z = sum exp(u - m) and S = sum exp(u - m) (u - m); the entropy of
// softmax(u) is ln Z - S / Z.  Two carries merge at m' = max(m, m_o):
// each Z is rescaled by exp(m_i - m'), each S by the same factor after
// a shift of (m_i - m') Z_i.  An empty carry is (NEG, 0, 0): NEG is a
// finite -inf, so merging it costs no NaN.
#pragma once

#include <cuda_runtime.h>

namespace carry {

constexpr float NEG = -1e30f;

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

}  // namespace carry
