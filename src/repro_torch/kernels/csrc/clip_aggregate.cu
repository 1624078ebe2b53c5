// Pass 2 of the fused server step: clip factors applied in registers,
// Bucketing's row gather and bucket means, then the masked coordinate
// median or trimmed mean.  With s = 1, no factors and rows in order it is
// the standalone masked CM/TM.  The device code and its design note are
// in select.cuh.
//
// Replaces _clip_agg_kernel and _clip_bucket_agg_kernel, launched by
// clip_then_aggregate (src/repro/kernels/clip_aggregate.py), and _cm_kernel
// and _tm_kernel, launched by coordinate_median
// (src/repro/kernels/coordinate_median.py).
#include "select.cuh"

// x: (n, d) row-major (dtype 0 = f32, 1 = bf16); factor: (n,) f32 or null
// for 1; mask: (n,) f32; idx: (n,) int32 row gather or null for rows in
// order; out: (d,) f32.
// n_p = n rounded up to a multiple of s, nb = n_p / s <= nb_cap.
extern "C" int clip_bucket_select_launch(const void* x, const void* factor, const void* mask,
                                         const void* idx, void* out, int dtype, int n,
                                         int n_p, long long d, int s, int nb,
                                         float trim_ratio, int nb_cap, void* stream) {
  if (s < 1 || n_p != nb * s || n_p < n) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::launch_select(x, factor, mask, idx, out, dtype, n, n_p, d, s,
                                               nb, trim_ratio, nb_cap,
                                               static_cast<cudaStream_t>(stream)));
}
