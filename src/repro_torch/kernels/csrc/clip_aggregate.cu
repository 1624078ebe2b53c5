// Pass 2 of the fused server step: clip factors applied in registers,
// Bucketing's row gather and bucket means, then the masked coordinate
// median or trimmed mean.  With s = 1, no factors and rows in order it is
// the standalone masked CM/TM; with unit factors and a permutation of the
// padded slots as the bucket order it is Bucketing o CM.  The device code
// and its design note are in select.cuh.
//
// Replaces _clip_agg_kernel and _clip_bucket_agg_kernel, launched by
// clip_then_aggregate (src/repro/kernels/clip_aggregate.py), and _cm_kernel
// and _tm_kernel, launched by coordinate_median
// (src/repro/kernels/coordinate_median.py), and _bucket_cm_kernel, launched
// by bucketed_coordinate_median (src/repro/kernels/bucketing.py).
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
  return static_cast<int>(repro::launch_select(x, factor, mask, idx, out, dtype, n, n_p, n, d,
                                               s, nb, trim_ratio, nb_cap,
                                               static_cast<cudaStream_t>(stream)));
}

// Bucketing(s) o masked coordinate median with an explicit permutation:
// x: (n, d) row-major (dtype 0 = f32, 1 = bf16); mask: (n,) f32 row weights;
// perm: (n_p,) int32 order of the n_p = nb * s padded slots, an index
// outside [0, n) an empty slot; out: (d,) f32.  Unit factors; empty buckets
// hold 3.4e37 and the numpy median is taken over the non-empty ones.
extern "C" int bucketed_cm_launch(const void* x, const void* mask, const void* perm,
                                  void* out, int dtype, int n, int n_p, long long d, int s,
                                  int nb, int nb_cap, void* stream) {
  if (s < 1 || n_p != nb * s || n_p < n || n_p - n >= s || perm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(repro::launch_select(x, nullptr, mask, perm, out, dtype, n, n_p, n_p,
                                               d, s, nb, -1.f, nb_cap,
                                               static_cast<cudaStream_t>(stream)));
}
