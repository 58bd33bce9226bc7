// Shared pieces of the two Gram kernels (gram_update.cu, pairwise.cu):
// the operand mode, the ranges of the F-slices, the Kahan step and the
// distance epilogues (Eq. 9, the angle alone, the Euclidean distance).
//
// Sum order.  Every dot product over C is summed in an order that
// depends on the column index alone, never on which operand is the row
// and which the column: fmaf products in a fixed sequence of columns
// within a chunk, the chunks' sums added with Kahan compensation (a
// two-level sum, as the TPU kernel's per-block partial products are,
// whose error stays near that of a short sum at any C: a single
// running sum over C = 158,570 columns was ~175x less accurate than
// cuBLAS's), and, where C is split across blocks, the slices' partial
// sums merged in increasing slice order, again with Kahan compensation.
// fmaf's two factors commute exactly, so <a_u, a_v> and <a_v, a_u> are
// bit-equal and so are the distances built from them: the K x K block
// of the scattered cache is exactly symmetric (pairwise.cu computes each
// unordered pair once and writes it to both places).  No atomics enter
// a sum.
//
// Operand mode.  With BF16 every operand value is rounded to bf16
// (round to nearest even, as the reference's astype(jnp.bfloat16)) as
// it is loaded from the f32 buffer (pairwise.cu: as it is staged, for
// the tensor cores); the sums stay f32.  A product of two bf16 values is exact in f32, so the
// kernels and their plain versions differ only in the order of the
// sums.  The norms and Ĥ in the stats are the f32 rows' own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gram {

constexpr int TC = 32;  // columns of C per chunk; a slice is whole chunks

// Eq. 9 clip bounds, the f32 values of the reference's python floats.
constexpr float COS_LO = static_cast<float>(-1.0 + 1e-7);
constexpr float COS_HI = static_cast<float>(1.0 - 1e-7);

// The value a Gram product reads: v itself, or v rounded to bf16.
template <bool BF16>
__device__ __forceinline__ float operand(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Columns [*begin, *end) of slice s of `splits`: chunks
// [nch*s/splits, nch*(s+1)/splits) of the nch = ceil(c/TC) chunks, the
// last one cut at c.  The slices cover [0, c) without overlap; with
// splits <= nch none is empty.  kernels/gram_update.py: slice_ranges
// computes the same.
__host__ __device__ inline void slice_range(int c, int splits, int s,
                                            int* begin, int* end) {
  const long long nch = (c + TC - 1) / TC;
  const long long lo = nch * s / splits, hi = nch * (s + 1) / splits;
  *begin = (int)(lo * TC);
  *end = (int)(hi * TC < c ? hi * TC : c);
}

// Kahan step: (acc, comp) += v.  Each step rounded on its own: nothing
// here may be reassociated or contracted.
__device__ __forceinline__ void kahan_add(float& acc, float& comp, float v) {
  const float y = __fsub_rn(v, comp);
  const float t = __fadd_rn(acc, y);
  comp = __fsub_rn(__fsub_rn(t, acc), y);
  acc = t;
}

// arccos(clip(dot / (max(|a|, eps) max(|b|, eps)))), zeroed on the
// true diagonal: the angular distance.  Divides after the dot, as the
// TPU kernel does.
__device__ inline float angle(float dot, float na, float nb, bool diag,
                              float eps) {
  const float denom = fmaxf(na, eps) * fmaxf(nb, eps);
  const float cs = fminf(fmaxf(dot / denom, COS_LO), COS_HI);
  return diag ? 0.0f : acosf(cs);
}

// Eq. 9: angle(...) + lam |Ĥa - Ĥb|.
__device__ inline float eq9(float dot, float na, float nb, float ha,
                            float hb, bool diag, float lam, float eps) {
  return angle(dot, na, nb, diag, eps) + lam * fabsf(ha - hb);
}

// Euclidean distance from the cached norms,
// sqrt(max((|a|² + |b|²) − 2<a, b>, 0)), zeroed on the true diagonal.
// Each step is rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn
// are never contracted into an fma), in the reference's order.  nvcc
// would otherwise contract na·na + nb·nb into fmaf(na, na, nb·nb),
// whose operands do not commute, and (u, v) and (v, u) could differ by
// an ulp; written out, the sum commutes exactly, so the distance of
// (u, v) is bit-equal to that of (v, u) as the dot product is.
__device__ inline float l2(float dot, float na, float nb, bool diag) {
  const float sq = __fadd_rn(__fmul_rn(na, na), __fmul_rn(nb, nb));
  const float d2 = __fsub_rn(sq, __fmul_rn(2.0f, dot));
  return diag ? 0.0f : sqrtf(fmaxf(d2, 0.0f));
}

}  // namespace gram
