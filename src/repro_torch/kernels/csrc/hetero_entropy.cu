// H(softmax(x / T)) of each row of x (N, C), f32 or bf16 in, f32 out.
//
// Replaces src/repro/kernels/hetero_entropy.py:_entropy_kernel
// (entropy_pallas).  The TPU kernel walks C in 512-wide blocks in grid
// order and carries (m, Z, S) in VMEM scratch from block to block.  It
// reads N·C elements once and writes N floats, so on the H100 it is
// bound by the bytes of x; one block a row would use 64 of the 132 SMs
// at N = 64 and leave bf16 as slow as f32.  Here each row is split
// across the P blocks of one thread-block cluster (entropy_carry.cuh):
// every block walks its slice in 16-byte loads (4 f32 or 8 bf16, the
// bf16 widened exactly), one expf a column, and rank 0 merges the P
// carries from distributed shared memory in rank order.  Columns past
// a slice are never read, so they never enter Z or S.  x / T is the
// IEEE quotient, formed with one reciprocal a thread and two fmas a
// column (carry::divide): the divide instruction made the kernel
// instruction-bound.
#include <cuda_runtime.h>
#include <stdint.h>

#include "entropy_carry.cuh"

// x (n, c) row-major, f32 (bf16 == 0) or bf16 (bf16 != 0); out (n,)
// f32; splits P in [1, 8].
extern "C" int entropy_launch(const void* x, void* out, int n, int c,
                              int splits, float temperature, int bf16,
                              void* stream) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* none = nullptr;
  if (bf16)
    return carry::launch_split_rows(
        carry::split_row_kernel<uint16_t, carry::kEntropy>, n, splits, st,
        static_cast<const uint16_t*>(x), c, splits, temperature, none,
        temperature, o, static_cast<float*>(nullptr),
        static_cast<float*>(nullptr));
  return carry::launch_split_rows(
      carry::split_row_kernel<float, carry::kEntropy>, n, splits, st,
      static_cast<const float*>(x), c, splits, temperature, none,
      temperature, o, static_cast<float*>(nullptr),
      static_cast<float*>(nullptr));
}
