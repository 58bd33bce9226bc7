// One-token GQA attention against a (B, S, KV, dh) cache, f32 q, f32 or
// bf16 K/V, f32 out: o = softmax(q·Kᵀ·scale, masked at length) · V.
//
// Replaces src/repro/kernels/decode_attention.py:_decode_kernel
// (decode_attention_pallas).  As there, one block takes one
// (batch, KV head) and its G = H / KV query heads together, so each K/V
// position is read from device memory once per group, and the softmax
// is online: per tile of BS positions,
//     m' = max(m, max logits);  l' = l·e^{m−m'} + Σ p;
//     acc' = acc·e^{m−m'} + p·V_tile,   p = e^{logits−m'}.
// The TPU kernel's sequential grid axis over S becomes a loop inside
// the block.  Each tile of K and V is staged through shared memory as
// f32 (16-byte loads, bf16 widened exactly); the G×BS logits, the
// (G, dh) accumulator and the (m, l) stats stay in shared memory.
// Positions at or past length are masked explicitly (p = 0), and tiles
// wholly past length are not read: they would add p = 0 and rescale by
// e^0 = 1.  The output is acc / max(l, 1e-30), 0 for length 0.
//
// The function reads the valid part of K and V once, so on the H100 it
// is bound by memory bytes.  This first version does not overlap a
// tile's loads with the previous tile's arithmetic, has one block per
// (batch, KV head) and no split over S, and reads each staged K row
// once per query head.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BS = 64;           // cache positions per tile
constexpr float NEG_INF = -1e30f;

// 16 bytes of K or V -> f32 in shared memory (16-byte aligned dst).
__device__ inline void stage(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ inline void stage(const uint16_t* src, float* dst) {
  const uint4 w = *reinterpret_cast<const uint4*>(src);
  const unsigned hi = 0xffff0000u;
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & hi),
                  __uint_as_float(w.y << 16), __uint_as_float(w.y & hi));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(w.z << 16), __uint_as_float(w.z & hi),
                  __uint_as_float(w.w << 16), __uint_as_float(w.w & hi));
}

__device__ inline float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ inline float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory, in floats: q (g·dh), K tile (BS·(dh+4), rows padded so
// that neighbouring rows start in other banks), V tile (BS·dh), p
// (g·BS), acc (g·dh), then m, l and the rescale factor (g each).
inline size_t smem_bytes(int g, int dh) {
  return sizeof(float) * (static_cast<size_t>(g) * dh * 2 +
                          static_cast<size_t>(BS) * (dh + 4) +
                          static_cast<size_t>(BS) * dh +
                          static_cast<size_t>(g) * BS + 3 * g);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ out, int s_len, int kv, int g, int dh,
              float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int ldk = dh + 4;
  float* ks = qs + g * dh;
  float* vs = ks + BS * ldk;
  float* ps = vs + BS * dh;
  float* acc = ps + g * BS;
  float* ms = acc + g * dh;
  float* ls = ms + g;
  float* al = ls + g;

  const int h = blockIdx.x % kv, b = blockIdx.x / kv, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gd = g * dh, dh4 = dh / 4;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const int nv = dh / VEC;

  // the g query heads of this KV head are contiguous in q (B, H, dh)
  const float* qb = q + (static_cast<size_t>(b) * kv + h) * gd;
  for (int i = tid; i < gd; i += THREADS) {
    qs[i] = qb[i];
    acc[i] = 0.0f;
  }
  for (int i = tid; i < g; i += THREADS) {
    ms[i] = NEG_INF;
    ls[i] = 0.0f;
  }
  const int len = min(max(lengths[b], 0), s_len);
  const size_t pos_stride = static_cast<size_t>(kv) * dh;
  const size_t head0 = (static_cast<size_t>(b) * s_len * kv + h) * dh;
  const T* kb = k + head0;
  const T* vb = v + head0;
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += BS) {
    const int n = min(BS, len - s0);
    for (int i = tid; i < n * nv; i += THREADS) {
      const int r = i / nv, c = (i - r * nv) * VEC;
      const size_t off = (s0 + r) * pos_stride + c;
      stage(kb + off, ks + r * ldk + c);
      stage(vb + off, vs + r * dh + c);
    }
    __syncthreads();

    // logits of the g heads at the n valid positions of the tile
    for (int i = tid; i < g * BS; i += THREADS) {
      const int gg = i / BS, r = i - gg * BS;
      float logit = NEG_INF;
      if (r < n) {
        const float4* q4 = reinterpret_cast<const float4*>(qs + gg * dh);
        const float4* k4 = reinterpret_cast<const float4*>(ks + r * ldk);
        float dot = 0.0f;
        for (int d = 0; d < dh4; ++d) {
          const float4 a = q4[d], kk = k4[d];
          dot = fmaf(a.x, kk.x, dot);
          dot = fmaf(a.y, kk.y, dot);
          dot = fmaf(a.z, kk.z, dot);
          dot = fmaf(a.w, kk.w, dot);
        }
        logit = dot * scale;
      }
      ps[i] = logit;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int gg = warp; gg < g; gg += THREADS / 32) {
      float* pg = ps + gg * BS;
      float mb = NEG_INF;
      for (int r = lane; r < BS; r += 32) mb = fmaxf(mb, pg[r]);
      const float m_prev = ms[gg];
      const float m_new = fmaxf(m_prev, warp_max(mb));
      float sum = 0.0f;
      for (int r = lane; r < BS; r += 32) {
        const float p = r < n ? expf(pg[r] - m_new) : 0.0f;
        pg[r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[gg] = alpha;
        ls[gg] = ls[gg] * alpha + sum;
        ms[gg] = m_new;
      }
    }
    __syncthreads();

    // acc = acc·alpha + p·V, four output columns per thread
    for (int i = tid; i < g * dh4; i += THREADS) {
      const int gg = i / dh4, d = (i - gg * dh4) * 4;
      const float* pg = ps + gg * BS;
      float4 a = *reinterpret_cast<float4*>(acc + gg * dh + d);
      const float alpha = al[gg];
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
      for (int r = 0; r < n; ++r) {
        const float p = pg[r];
        const float4 vv = *reinterpret_cast<const float4*>(vs + r * dh + d);
        a.x = fmaf(p, vv.x, a.x);
        a.y = fmaf(p, vv.y, a.y);
        a.z = fmaf(p, vv.z, a.z);
        a.w = fmaf(p, vv.w, a.w);
      }
      *reinterpret_cast<float4*>(acc + gg * dh + d) = a;
    }
    __syncthreads();
  }

  float* ob = out + (static_cast<size_t>(b) * kv + h) * gd;
  for (int i = tid; i < gd; i += THREADS)
    ob[i] = acc[i] / fmaxf(ls[i / dh], 1e-30f);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int b, int s_len, int kv, int g, int dh, float scale,
           cudaStream_t st) {
  const size_t smem = smem_bytes(g, dh);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T><<<b * kv, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<float*>(out), s_len, kv, g, dh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (b, kv·g, dh) f32; k, v (b, s_len, kv, dh) f32 (bf16 == 0) or bf16;
// lengths (b,) int32; out (b, kv·g, dh) f32.  dh % 8 == 0 and every
// pointer 16-byte aligned (the wrapper checks both).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, int b, int s_len, int kv,
                                       int g, int dh, float scale, int bf16,
                                       void* stream) {
  if (b == 0 || kv == 0 || g == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(q, k, v, lengths, out, b, s_len, kv, g, dh,
                                 scale, st)
              : launch<float>(q, k, v, lengths, out, b, s_len, kv, g, dh,
                              scale, st);
}
