// One-token GQA attention against a (B, S, KV, dh) cache, f32 q, f32 or
// bf16 K/V, f32 out: o = softmax(q·Kᵀ·scale, masked at length) · V.
//
// Replaces src/repro/kernels/decode_attention.py:_decode_kernel
// (decode_attention_pallas).  As there, the G = H / KV query heads of
// one KV head ride together, so each valid K/V byte is read from device
// memory once, and the softmax is online in f32: per run of positions,
//     m' = max(m, max logits);  l' = l·e^{m−m'} + Σ p;
//     acc' = acc·e^{m−m'} + p·V,   p = e^{logits−m'}  (0 past length).
// The output is acc / max(l, 1e-30), 0 for length 0.
//
// Bound: bytes.  The function reads the valid K and V once (decode_32k:
// 4.29 GB of bf16, 1.28 ms at 3.35 TB/s) and does 4·dh + 5 f32
// operations per valid position and query head (0.52 ms at 67 TFLOP/s).
// So the kernel is near its bound only if its loads never wait for its
// arithmetic and its arithmetic issues few instructions a byte.  The
// design, against that:
//
// * S is split across blocks (flash-decoding).  The grid is
//   (B·KV) × P; block (bh, p) takes the contiguous tiles
//   [T·p/P, T·(p+1)/P) of the T = ceil(S / BS) tiles of BS = 32
//   positions, clipped at its row's length, so a split wholly past the
//   length reads nothing.  P comes from kernels/decode_attention.py:
//   decode_splits (the resident blocks of the card in near-whole waves).
//   With P = 1 the block writes the output; otherwise it writes its
//   partial (acc[G, dh], m[G], l[G]) to an f32 workspace, and a second
//   launch, one block per (batch, KV head), merges the P partials in
//   increasing split order: M = max m_p, l = Σ l_p·e^{m_p−M},
//   acc = Σ acc_p·e^{m_p−M}.  A second launch rather than a last-block
//   merge inside the kernel: the partials are a few KB a block, the
//   launch on the same stream orders the merge after every split with
//   no atomics, fences or counters that would have to be kept per
//   stream, and the merge order, hence the output, is the same bit for
//   bit in every call.  An empty split's partial (m = −1e30, l = 0,
//   acc = 0) merges with weight e^{−1e30−M} = 0, or 1 with l = 0 when
//   every split is empty (length 0), so nothing is NaN.
// * Each of the block's 4 warps streams its own 8 positions of every
//   tile through a ring of STAGES = 3 tiles in shared memory, in the
//   cache's stored type (bf16 stays 2 bytes), with 16-byte
//   cp.async.cg copies and commit/wait groups: while a warp computes
//   tile t, its copies of tiles t+1 and t+2 are in flight.  A warp
//   reads only rows it copied itself, so the loop needs no block
//   barrier, only __syncwarp; rows at or past the length are
//   zero-filled without a read (cp.async's src-size 0).  Each warp
//   keeps its own online (m, l, acc) and the 4 are merged in warp
//   order through shared memory once, at the end.
// * q of the block's G heads lives in registers, E values a lane
//   (E = ceil(dh / 32) rounded up to a power of two, at least 2; G
//   padded to GP, a power of two, with zero heads; where 32·E > dh, as
//   at dh 112 (E = 4), the lanes at and past dh / E hold zeros in q,
//   read no K or V and drop their accumulators), so each staged K and V
//   value is read from shared memory once by one lane and feeds all G
//   heads: per K row, G·E FMAs into G partial dot products; per V row,
//   G·E FMAs into the G accumulators.  The G·RS partial dot products of
//   RS = 32 / GP rows are summed across the warp by one reduce-scatter
//   butterfly (31 shuffles and adds for 32 sums, not 5 of each a sum,
//   and no select: each lane lays its products out XOR its own logit
//   index), which leaves lane l the logit of head l / RS, row l % RS.
//   The max and sum of the softmax are then a few shuffles within each
//   head's lanes: every lane works, none waits.  The probabilities go
//   to the warp through PW·GP floats of shared memory, read back as
//   broadcast vectors, and the accumulators are rescaled only when a
//   head's max moved.
// * Any G and any dh that is a multiple of 8 up to 512.  The registers
//   hold GP·E <= 32 values of q and as many accumulators a lane, so a
//   KV head's G query heads are split into C = ceil(G / GPmax) chunks
//   of gc = ceil(G / C) heads (GPmax = 32 / E, at most 16), one block a
//   chunk, each reading the head's K and V once: G 16 at dh 128 is two
//   blocks of 8.  The registered widths (dh 64, 112, 128, 256) keep a
//   compile-time row width; any other takes the runtime width dh with
//   the same E rule (dh 80 and 96: E 4 on 20 and 24 lanes; 192: E 8 on
//   24; 264: E 16, the last lane 8 values), a 16-byte chunk loop for
//   the copies, and 3 stages in the ring where they fit in shared
//   memory (f32 rows wider than 302 values take 2, wider than 453 one).
// * Any other dh from 1 to 512, as the TPU kernel takes.  Such a row is
//   not whole 16-byte chunks, in device memory or in the ring, so it
//   takes the runtime width with a narrower copy: its ring rows are
//   padded to SR = dh rounded up to 8 values (every vector load of the
//   loop stays aligned), the padding is zero-filled like a row past the
//   length, and each f32 value is one 4-byte cp.async.ca; bf16 rows
//   (2-byte aligned at an odd dh, below cp.async's smallest copy) are
//   loaded and stored by the lanes themselves, a tile ahead as the
//   copies are, one instantiation for every such dh.  The lanes past
//   dh hold zeros in q and drop their accumulators, as at dh 112, so
//   the padding adds nothing.  The 16-byte widths' code is unchanged.
// * bf16 is widened in registers, a shift or a mask a value, as the
//   values leave shared memory.
// * The arithmetic is f32 FMA on the CUDA cores, no tensor-core
//   product: bf16 or TF32 operands would round the f32 q, and the kernel
//   is held to 5e-5 of its plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PW = 8;                 // positions of a tile per warp
constexpr int BS = WARPS * PW;        // cache positions per tile
constexpr int STAGES = 3;             // tiles in each warp's ring
constexpr int MERGE_THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// cp.async of 16 bytes, of which `bytes` (16 or 0) are read and the
// rest zero-filled.
__device__ __forceinline__ void copy16(unsigned dst, const void* src,
                                       unsigned bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// cp.async of 4 bytes, `bytes` (4 or 0) of them read.
__device__ __forceinline__ void copy4(unsigned dst, const void* src,
                                      unsigned bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E consecutive values of a staged row -> f32 registers.
__device__ __forceinline__ void load_row(const float* p, float (&r)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 c = *reinterpret_cast<const float4*>(p + 4);
  r[0] = a.x;
  r[1] = a.y;
  r[2] = a.z;
  r[3] = a.w;
  r[4] = c.x;
  r[5] = c.y;
  r[6] = c.z;
  r[7] = c.w;
}
__device__ __forceinline__ void load_row(const float* p, float (&r)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x;
  r[1] = t.y;
  r[2] = t.z;
  r[3] = t.w;
}
__device__ __forceinline__ void load_row(const float* p, float (&r)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  r[0] = t.x;
  r[1] = t.y;
}
// bf16 -> f32 is exact: the bf16 bits are the top half of the f32.
__device__ __forceinline__ void load_row(const uint16_t* p, float (&r)[8]) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned hi = 0xffff0000u;
  r[0] = __uint_as_float(w.x << 16);
  r[1] = __uint_as_float(w.x & hi);
  r[2] = __uint_as_float(w.y << 16);
  r[3] = __uint_as_float(w.y & hi);
  r[4] = __uint_as_float(w.z << 16);
  r[5] = __uint_as_float(w.z & hi);
  r[6] = __uint_as_float(w.w << 16);
  r[7] = __uint_as_float(w.w & hi);
}
__device__ __forceinline__ void load_row(const uint16_t* p, float (&r)[4]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  const unsigned hi = 0xffff0000u;
  r[0] = __uint_as_float(w.x << 16);
  r[1] = __uint_as_float(w.x & hi);
  r[2] = __uint_as_float(w.y << 16);
  r[3] = __uint_as_float(w.y & hi);
}
__device__ __forceinline__ void load_row(const uint16_t* p, float (&r)[2]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  r[0] = __uint_as_float(w << 16);
  r[1] = __uint_as_float(w & 0xffff0000u);
}

// The GP probabilities of one position, contiguous in shared memory.
template <int GP>
__device__ __forceinline__ void load_probs(const float* p, float (&r)[GP]) {
  if constexpr (GP == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x;
    r[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < GP; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      r[i] = t.x;
      r[i + 1] = t.y;
      r[i + 2] = t.z;
      r[i + 3] = t.w;
    }
  }
}

// Sum the N values of every lane across the warp, without a select:
// lane l holds, in its register ρ, the partial sum of logical value
// ρ XOR (l >> (5 − log2 N)) (the caller lays its products out so).  So
// at each level a lane keeps its lower half and adds the partner's
// upper half, which holds the same logical values.  After log2(N)
// levels v[0] of lane l is the warp's sum of value l >> (5 − log2 N);
// with N < 32 the remaining levels add the lanes that share it.
template <int HALF, int MASK, int N>
__device__ __forceinline__ void scatter_level(float (&v)[N]) {
#pragma unroll
  for (int j = 0; j < HALF; ++j)
    v[j] += __shfl_xor_sync(FULL, v[j + HALF], MASK);
  if constexpr (HALF > 1) scatter_level<HALF / 2, MASK / 2>(v);
}

template <int N>
__device__ __forceinline__ void reduce_scatter(float (&v)[N]) {
  scatter_level<N / 2, 16>(v);
#pragma unroll
  for (int mask = 16 / N; mask > 0; mask >>= 1)
    v[0] += __shfl_xor_sync(FULL, v[0], mask);
}

// E values of a staged row -> f32 registers, where the lane may hold
// fewer (E = 16 on the runtime-width path: a row whose width is 8 mod
// 16 leaves its last lane 8 values, the rest read as zeros).
template <typename T, int E>
__device__ __forceinline__ void load_lane(const T* p, float (&r)[E],
                                          int nval) {
  if constexpr (E == 16) {
    float lo[8], hi[8] = {};
    load_row(p, lo);
    if (nval > 8) load_row(p + 8, hi);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      r[e] = lo[e];
      r[e + 8] = hi[e];
    }
  } else {
    load_row(p, r);
  }
}

// 16-byte chunk c of a warp's PW K rows then PW V rows (CH chunks a
// row of DH values) into its stage; a row at or past len is zero-filled.
template <typename T>
__device__ __forceinline__ void copy_chunk(unsigned base, const T* kb,
                                           const T* vb, int c, int ch,
                                           int dh, int pos0, int len,
                                           size_t pos_stride) {
  constexpr int VEC = 16 / sizeof(T);
  const int row = c / ch, col = c % ch;
  const int pos = pos0 + row % PW;
  const bool ok = pos < len;
  const T* src = (row < PW ? kb : vb) +
                 (ok ? static_cast<size_t>(pos) * pos_stride + col * VEC : 0);
  copy16(base + static_cast<unsigned>((row * dh + col * VEC) * sizeof(T)),
         src, ok ? 16u : 0u);
}

// One warp's BS / WARPS = PW positions of a tile, K rows then V rows,
// into one stage of its ring.  With CB = 16 a row is DH values, a whole
// number of 16-byte chunks (dh 112: 28 f32 or 14 bf16 chunks, 14 or 7 a
// lane): unrolled where DH is a template constant, a loop over the
// lanes where it is the runtime width (DH_ = 0).  With CB = 4 or 2 a
// row is dh values in device memory and sr (dh rounded up to 8) in the
// ring, copied CB bytes at a time, the padding zero-filled: 4-byte
// cp.async copies, or (CB = 2, an odd dh's bf16 rows) loads and stores.
template <typename T, int DH_, int CB>
__device__ __forceinline__ void load_tile(T* stage, const T* kb, const T* vb,
                                          int pos0, int len,
                                          size_t pos_stride, int lane,
                                          int dh, int sr) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(stage));
  if constexpr (CB != 16) {
    constexpr int W = CB / sizeof(T);    // values a copy
    const int ch = sr / W;               // copies a ring row
    for (int c = lane; c < 2 * PW * ch; c += 32) {
      const int row = c / ch, col = (c - row * ch) * W;
      const int pos = pos0 + row % PW;
      const bool ok = pos < len && col < dh;
      const T* src = (row < PW ? kb : vb) +
                     (ok ? static_cast<size_t>(pos) * pos_stride + col : 0);
      if constexpr (CB == 4) {
        copy4(base + static_cast<unsigned>((row * sr + col) * sizeof(T)), src,
              ok ? 4u : 0u);
      } else {
        stage[row * sr + col] = ok ? *src : T(0);
      }
    }
  } else if constexpr (DH_ != 0) {
    constexpr int CH = DH_ / VEC;     // 16-byte chunks a row
    static_assert(DH_ % VEC == 0 && (2 * PW * CH) % 32 == 0,
                  "a tile's rows must split into whole 16-byte chunks a lane");
    constexpr int PER_LANE = 2 * PW * CH / 32;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i)
      copy_chunk<T>(base, kb, vb, lane + 32 * i, CH, DH_, pos0, len,
                    pos_stride);
  } else {
    const int ch = dh / VEC;
    for (int c = lane; c < 2 * PW * ch; c += 32)
      copy_chunk<T>(base, kb, vb, c, ch, dh, pos0, len, pos_stride);
  }
}

// The block's shared memory for row width dh, ring rows of sr values
// (sr = dh but on the narrow copies' path): each warp's ring of STAGES
// stages of PW K rows and PW V rows in T, then each warp's PW·GP
// probabilities.  The merge of the warps' (acc, m, l) reuses the ring,
// or runs past it where the ring is the smaller (few stages, few
// lanes), so the probabilities start after the larger of the two.
template <typename T, int GP, int STAGES>
struct Layout {
  __host__ __device__ static constexpr size_t stage(int sr) {
    return static_cast<size_t>(2 * PW) * sr;   // elements of T
  }
  __host__ __device__ static constexpr size_t ring(int sr) {
    return sizeof(T) * WARPS * STAGES * stage(sr);
  }
  __host__ __device__ static constexpr size_t merge(int dh) {
    return sizeof(float) * WARPS * GP * (dh + 2);
  }
  __host__ __device__ static constexpr size_t probs_at(int sr, int dh) {
    return ring(sr) > merge(dh) ? ring(sr) : merge(dh);
  }
  __host__ __device__ static constexpr size_t smem(int sr, int dh) {
    return probs_at(sr, dh) + sizeof(float) * WARPS * PW * GP;
  }
};

// The ring's row width: dh, or dh rounded up to 8 values where the rows
// are copied in narrower pieces than 16 bytes (CB < 16).
template <int CB>
__host__ __device__ constexpr int ring_row(int dh) {
  return CB == 16 ? dh : (dh + 7) & ~7;
}

// Block (bhc, split) of the (B·KV·C) × P grid, bhc = (b·KV + h)·C + c:
// the partial of split `split` of chunk c of (batch b, KV head h), or
// its output when P = 1.  Chunk c holds the query heads
// [c·gc, min((c+1)·gc, g)) of the KV head's g (C = ceil(g / gc) chunks;
// one chunk, gc = g, for every registered config).  DH_ is the stored
// row width as a template constant, or 0 for the runtime width dh; E
// the values a lane (E | dh wherever DH_ is set); CB the bytes of one
// copy into the ring (16, or 4 and 2 on the narrow path).
template <typename T, int GP, int E, int DH_, int STAGES, int CB>
__global__ void __launch_bounds__(THREADS, 3)
decode_split_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ out, float* __restrict__ ws,
                    int s_len, int kv, int g, int gc, int chunks, int dh,
                    int splits, float scale) {
  using L = Layout<T, GP, STAGES>;
  const int DH = DH_ ? DH_ : dh;
  const int SR = DH_ ? DH_ : ring_row<CB>(dh);   // a ring row's values
  constexpr int RS = PW < 32 / GP ? PW : 32 / GP;  // rows a logit step
  constexpr int NS = PW / RS;                      // logit steps a tile
  constexpr int N = GP * RS;                       // partial sums a step
  constexpr int DUP = 32 / N;                      // lanes sharing a logit
  constexpr int GL = 32 / GP;                      // lanes of one head
  static_assert(DH_ == 0 || DH_ % E == 0, "E must divide a fixed DH");

  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stage = static_cast<int>(L::stage(SR));
  T* my_ring = ring + warp * STAGES * stage;
  float* probs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) +
                                          L::probs_at(SR, DH)) +
                 warp * PW * GP;

  const int bhc = blockIdx.x / splits, split = blockIdx.x - bhc * splits;
  const int bh = bhc / chunks, c = bhc - bh * chunks;
  const int h = bh % kv, b = bh / kv;
  const int gcount = min(gc, g - c * gc);   // the chunk's heads
  const int len = min(max(lengths[b], 0), s_len);
  const int tiles = (s_len + BS - 1) / BS;
  const int t0 = static_cast<int>(static_cast<long long>(tiles) * split /
                                  splits);
  const int t1 = static_cast<int>(static_cast<long long>(tiles) *
                                  (split + 1) / splits);
  const int n_tiles = max(0, min(t1, (len + BS - 1) / BS) - t0);

  // this lane's values: [lane·E, lane·E + nval) of the row (nval = E or
  // 0 wherever E | dh; the runtime width's last lane may hold 8 of 16)
  const int nval = min(max(DH - lane * E, 0), E);
  const bool holds = nval > 0;
  const int idx = lane / DUP;   // this lane's logit: head idx / RS,
  const int row_of = idx % RS;  // row s·RS + idx % RS of the warp's PW
  // The chunk's query heads are contiguous in q (B, H, dh).  Register
  // gg holds head gg XOR (idx / RS), and the partial sum of register r
  // row r XOR row_of, so that partial (gg, r) holds logical value
  // (gg·RS + r) XOR idx, as reduce_scatter takes it.
  float qr[GP][E];
  const size_t head_row = static_cast<size_t>(bh) * g + c * gc;
  const float* qb = q + head_row * DH + lane * E;
#pragma unroll
  for (int gg = 0; gg < GP; ++gg) {
    const int head = gg ^ (idx / RS);
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[gg][e] = head < gcount && e < nval ? qb[head * DH + e] : 0.0f;
  }

  float acc[GP][E];
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gg][e] = 0.0f;
  float m = NEG_INF, l = 0.0f;  // of head lane / GL = idx / RS

  const size_t pos_stride = static_cast<size_t>(kv) * DH;
  const size_t head0 = (static_cast<size_t>(b) * s_len * kv + h) * DH;
  const T* kb = k + head0;
  const T* vb = v + head0;
  const int pos_w = t0 * BS + warp * PW;

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles)
      load_tile<T, DH_, CB>(my_ring + i * stage, kb, vb, pos_w + i * BS,
                            len, pos_stride, lane, DH, SR);
    copy_commit();
  }

  for (int i = 0; i < n_tiles; ++i) {
    __syncwarp();  // every lane is done with tile i−1's stage and probs
    const int nxt = i + STAGES - 1;
    if (nxt < n_tiles)
      load_tile<T, DH_, CB>(my_ring + (nxt % STAGES) * stage, kb, vb,
                            pos_w + nxt * BS, len, pos_stride, lane, DH, SR);
    copy_commit();
    copy_wait<STAGES - 1>();  // this lane's copies of tile i landed
    __syncwarp();             // and every lane's
    const T* ks = my_ring + (i % STAGES) * stage;
    const T* vs = ks + PW * SR;
    const int pos0 = pos_w + i * BS;

    // logits: one read of each K value, G partial dot products
    float logit[NS];
    bool valid[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float part[N];
#pragma unroll
      for (int r = 0; r < RS; ++r) {
        float kr[E] = {};
        if (holds)
          load_lane<T, E>(ks + (s * RS + (r ^ row_of)) * SR + lane * E, kr,
                          nval);
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) {
          float d = qr[gg][0] * kr[0];
#pragma unroll
          for (int e = 1; e < E; ++e) d = fmaf(qr[gg][e], kr[e], d);
          part[gg * RS + r] = d;
        }
      }
      reduce_scatter<N>(part);
      valid[s] = pos0 + s * RS + row_of < len;
      logit[s] = valid[s] ? part[0] * scale : NEG_INF;
    }

    // online softmax of each head over the warp's PW rows
    float mt = logit[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) mt = fmaxf(mt, logit[s]);
#pragma unroll
    for (int mask = DUP; mask < GL; mask <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(FULL, mt, mask));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float p[NS], psum = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      p[s] = valid[s] ? expf(logit[s] - m_new) : 0.0f;
      psum += p[s];
    }
#pragma unroll
    for (int mask = DUP; mask < GL; mask <<= 1)
      psum += __shfl_xor_sync(FULL, psum, mask);
    l = l * alpha + psum;
    m = m_new;
    if ((lane & (DUP - 1)) == 0) {
#pragma unroll
      for (int s = 0; s < NS; ++s)
        probs[(s * RS + row_of) * GP + idx / RS] = p[s];
    }
    if (!__all_sync(FULL, alpha == 1.0f)) {  // a head's max moved
#pragma unroll
      for (int gg = 0; gg < GP; ++gg) {
        const float a = __shfl_sync(FULL, alpha, gg * GL);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gg][e] *= a;
      }
    }
    __syncwarp();

    // p·V: one read of each V value, G accumulators
#pragma unroll
    for (int j = 0; j < PW; ++j) {
      float vr[E] = {};
      if (holds) load_lane<T, E>(vs + j * SR + lane * E, vr, nval);
      float pj[GP];
      load_probs<GP>(probs + j * GP, pj);
#pragma unroll
      for (int gg = 0; gg < GP; ++gg)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[gg][e] = fmaf(pj[gg], vr[e], acc[gg][e]);
    }
  }

  // merge the warps' (m, l, acc) in warp order
  copy_wait<0>();
  __syncthreads();  // every warp is done with the ring
  float* macc = reinterpret_cast<float*>(smem4);  // [WARPS][GP][DH]
  float* mm = macc + WARPS * GP * DH;              // [WARPS][GP]
  float* ml = mm + WARPS * GP;
#pragma unroll
  for (int gg = 0; gg < GP; ++gg)
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (e < nval) macc[(warp * GP + gg) * DH + lane * E + e] = acc[gg][e];
  if (lane % GL == 0) {
    mm[warp * GP + lane / GL] = m;
    ml[warp * GP + lane / GL] = l;
  }
  __syncthreads();
  const int gdh = gcount * DH;
  for (int i = threadIdx.x; i < gdh; i += THREADS) {
    const int gg = i / DH, d = i - gg * DH;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, mm[w * GP + gg]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(mm[w * GP + gg] - mx);
      ls += ml[w * GP + gg] * wt;
      as += macc[(w * GP + gg) * DH + d] * wt;
    }
    if (splits == 1) {
      out[head_row * DH + i] = as / fmaxf(ls, 1e-30f);
    } else {
      // a record of gc heads a block, whatever the chunk's count
      float* rec = ws + static_cast<size_t>(blockIdx.x) * gc * (DH + 2);
      rec[i] = as;
      if (d == 0) {
        rec[gc * DH + gg] = mx;
        rec[gc * DH + gc + gg] = ls;
      }
    }
  }
}

// Block (bhc, y): outputs [y·MERGE_THREADS, (y+1)·MERGE_THREADS) of
// chunk c of (batch, KV head) bh, bhc = bh·C + c, one a thread, each the
// P partials (acc[gc, dh], m[gc], l[gc]) of ws merged in increasing
// split order.  The loop over the splits is unrolled so that its loads
// are in flight together.
__global__ void __launch_bounds__(MERGE_THREADS)
decode_merge_kernel(const float* __restrict__ ws, float* __restrict__ out,
                    int splits, int g, int gc, int chunks, int dh) {
  const int bh = blockIdx.x / chunks, c = blockIdx.x - bh * chunks;
  const int gdh = min(gc, g - c * gc) * dh, rec = gc * (dh + 2);
  const int i = blockIdx.y * MERGE_THREADS + threadIdx.x;
  if (i >= gdh) return;
  const float* r0 = ws + static_cast<size_t>(blockIdx.x) * splits * rec;
  const float* mp = r0 + gc * dh + i / dh;  // m of head i / dh, split 0
  float mx = NEG_INF;
#pragma unroll 4
  for (int p = 0; p < splits; ++p) mx = fmaxf(mx, mp[p * rec]);
  float ls = 0.0f, as = 0.0f;
#pragma unroll 4
  for (int p = 0; p < splits; ++p) {
    const float wt = expf(mp[p * rec] - mx);
    ls += mp[p * rec + gc] * wt;
    as += r0[p * rec + i] * wt;
  }
  out[(static_cast<size_t>(bh) * g + c * gc) * dh + i] =
      as / fmaxf(ls, 1e-30f);
}

template <typename T, int GP, int E, int DH, int STAGES, int CB>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, void* ws, int b, int s_len, int kv, int g, int gc,
           int chunks, int dh, int splits, float scale, cudaStream_t st) {
  const size_t smem =
      Layout<T, GP, STAGES>::smem(DH ? DH : ring_row<CB>(dh), dh);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, GP, E, DH, STAGES, CB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_split_kernel<T, GP, E, DH, STAGES, CB>
      <<<b * kv * chunks * splits, THREADS, smem, st>>>(
          static_cast<const float*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(lengths),
          static_cast<float*>(out), static_cast<float*>(ws), s_len, kv, g,
          gc, chunks, dh, splits, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const dim3 merge_grid(b * kv * chunks,
                        (gc * dh + MERGE_THREADS - 1) / MERGE_THREADS);
  decode_merge_kernel<<<merge_grid, MERGE_THREADS, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), splits, g,
      gc, chunks, dh);
  return static_cast<int>(cudaGetLastError());
}

#define DECODE_LAUNCH(GP, E, DH, STAGES, CB)                            \
  return launch<T, GP, E, DH, STAGES, CB>(q, k, v, lengths, out, ws, b,   \
                                          s_len, kv, g, gc, chunks, dh,   \
                                          splits, scale, st)

// The runtime row width, copied CB bytes at a time: 3 stages in the
// ring where they fit, and the f32 ring of a row wider than 302 values
// 2 stages, of one wider than 453 one (bf16 fits 3 up to 512).
template <typename T, int CB>
int runtime_width(const void* q, const void* k, const void* v,
                  const void* lengths, void* out, void* ws, int b,
                  int s_len, int kv, int g, int gc, int chunks, int dh,
                  int gp, int e, int stages, int splits, float scale,
                  cudaStream_t st) {
  if (stages == 3) {
    switch (e * 100 + gp) {
      case 202: DECODE_LAUNCH(2, 2, 0, 3, CB);
      case 204: DECODE_LAUNCH(4, 2, 0, 3, CB);
      case 208: DECODE_LAUNCH(8, 2, 0, 3, CB);
      case 216: DECODE_LAUNCH(16, 2, 0, 3, CB);
      case 402: DECODE_LAUNCH(2, 4, 0, 3, CB);
      case 404: DECODE_LAUNCH(4, 4, 0, 3, CB);
      case 408: DECODE_LAUNCH(8, 4, 0, 3, CB);
      case 802: DECODE_LAUNCH(2, 8, 0, 3, CB);
      case 804: DECODE_LAUNCH(4, 8, 0, 3, CB);
      case 1602: DECODE_LAUNCH(2, 16, 0, 3, CB);
    }
  }
  if constexpr (sizeof(T) == 4) {
    if (e == 16 && gp == 2 && stages == 2) DECODE_LAUNCH(2, 16, 0, 2, CB);
    if (e == 16 && gp == 2 && stages == 1) DECODE_LAUNCH(2, 16, 0, 1, CB);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan comes from kernels/decode_attention.py: decode_plan.  GP is
// the chunk's gc padded to a power of two in {2, 4, 8, 16}, E = max(2,
// ceil(dh / 32) rounded up to a power of two), GP·E <= 32 (q and the
// accumulators stay in registers).  The registered widths dh 64, 112,
// 128 and 256 (fixed = 1) keep their compile-time row width and 3
// stages; every other dh from 1 to 512 takes the runtime width, with
// 16-byte copies where dh is a multiple of 8, else 4-byte copies (f32)
// or 2-byte loads (bf16).
template <typename T>
int dispatch(const void* q, const void* k, const void* v,
             const void* lengths, void* out, void* ws, int b, int s_len,
             int kv, int g, int gc, int chunks, int dh, int gp, int e,
             int stages, int fixed, int splits, float scale,
             cudaStream_t st) {
  if (fixed && stages == 3) {
    constexpr int CB = 16;
    if (dh == 64 && e == 2) {
      switch (gp) {
        case 2: DECODE_LAUNCH(2, 2, 64, 3, CB);
        case 4: DECODE_LAUNCH(4, 2, 64, 3, CB);
        case 8: DECODE_LAUNCH(8, 2, 64, 3, CB);
        case 16: DECODE_LAUNCH(16, 2, 64, 3, CB);
      }
    }
    if (dh == 112 && e == 4) {
      switch (gp) {
        case 2: DECODE_LAUNCH(2, 4, 112, 3, CB);
        case 4: DECODE_LAUNCH(4, 4, 112, 3, CB);
        case 8: DECODE_LAUNCH(8, 4, 112, 3, CB);
      }
    }
    if (dh == 128 && e == 4) {
      switch (gp) {
        case 2: DECODE_LAUNCH(2, 4, 128, 3, CB);
        case 4: DECODE_LAUNCH(4, 4, 128, 3, CB);
        case 8: DECODE_LAUNCH(8, 4, 128, 3, CB);
      }
    }
    if (dh == 256 && e == 8) {
      switch (gp) {
        case 2: DECODE_LAUNCH(2, 8, 256, 3, CB);
        case 4: DECODE_LAUNCH(4, 8, 256, 3, CB);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fixed || dh < 1 || dh > 32 * e)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dh % 8 == 0)
    return runtime_width<T, 16>(q, k, v, lengths, out, ws, b, s_len, kv, g,
                                gc, chunks, dh, gp, e, stages, splits, scale,
                                st);
  if constexpr (sizeof(T) == 4)
    return runtime_width<T, 4>(q, k, v, lengths, out, ws, b, s_len, kv, g,
                               gc, chunks, dh, gp, e, stages, splits, scale,
                               st);
  else
    return runtime_width<T, 2>(q, k, v, lengths, out, ws, b, s_len, kv, g,
                               gc, chunks, dh, gp, e, stages, splits, scale,
                               st);
}
#undef DECODE_LAUNCH

}  // namespace

// q (b, kv·g, dh) f32; k, v (b, s_len, kv, dh) f32 (bf16 == 0) or bf16;
// lengths (b,) int32; out (b, kv·g, dh) f32; ws the splits' partials,
// (b·kv·chunks·splits, gc·(dh + 2)) f32, unused (may be null) when
// splits == 1.  The plan (gc heads a chunk, chunks = ceil(g / gc), GP,
// E, stages, fixed) is decode_plan's; every pointer 16-byte aligned,
// 1 <= splits <= ceil(s_len / 32).
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* out, void* ws, int b, int s_len,
                                       int kv, int g, int gc, int chunks,
                                       int dh, int gp, int e, int stages,
                                       int fixed, int splits, float scale,
                                       int bf16, void* stream) {
  if (b == 0 || kv == 0 || g == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<uint16_t>(q, k, v, lengths, out, ws, b, s_len, kv, g,
                                   gc, chunks, dh, gp, e, stages, fixed,
                                   splits, scale, st)
              : dispatch<float>(q, k, v, lengths, out, ws, b, s_len, kv, g,
                                gc, chunks, dh, gp, e, stages, fixed, splits,
                                scale, st);
}
