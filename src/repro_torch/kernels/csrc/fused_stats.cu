// One pass per row of x: entropy of softmax(x * scale), L2 norm, RMS.
//
// Replaces src/repro/kernels/fused_stats.py:_fused_stats_kernel, with
// its per-row scale and the normalize step that its callers
// (cached_selection_step_pallas, hics_selection_step_pallas) run as a
// second sweep.  It reads (N, C) f32 once and writes 3N floats, so on
// the H100 it is bound by the bytes of x.  The design is
// entropy_carry.cuh's: each row split across the P blocks of one
// thread-block cluster, 16-byte loads, one expf a column, the P
// carries and sums of squares merged in rank order from distributed
// shared memory.  Under normalize the cluster first adds the row's sum
// of squares, so that every block scales x by 1 / (max(RMS, 1e-12) T)
// in the same launch: one launch where the reference makes two, with
// no torch op between them.  Outputs Ĥ = ln Z - S / Z, sqrt(sum x²)
// and sqrt(sum x² / C).
#include <cuda_runtime.h>

#include "entropy_carry.cuh"

// x (n, c) f32; ent, norm, rms (n,) f32; splits P in [1, 8].  The
// softmax reads x * s: s = row_scale[row] when row_scale is not null
// (it carries 1/T), 1 / (max(RMS, 1e-12) * temperature) when normalize
// is set, else inv_t.
extern "C" int fused_stats_launch(const void* x, const void* row_scale,
                                  void* ent, void* norm, void* rms, int n,
                                  int c, int splits, float inv_t,
                                  float temperature, int normalize,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* rs = static_cast<const float*>(row_scale);
  float* e = static_cast<float*>(ent);
  float* nr = static_cast<float*>(norm);
  float* r = static_cast<float*>(rms);
  if (c <= 0 || (normalize && rs != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (normalize)
    return carry::launch_split_rows(
        carry::split_row_kernel<float, carry::kNormalize>, n, splits, st,
        xf, c, splits, inv_t, rs, temperature, e, nr, r);
  return carry::launch_split_rows(
      carry::split_row_kernel<float, carry::kStats>, n, splits, st, xf, c,
      splits, inv_t, rs, temperature, e, nr, r);
}
