// CenteredClip (Karimireddy et al., 2021) over the clipped rows x_i f_i or,
// under Bucketing, over their mask-weighted bucket means:
//
//   v <- v + sum_i s_i (x_i - v) / den,  s_i = m_i min(1, tau / sqrt(||x_i - v||^2 + 1e-30))
//
// from v0 = sum_i m_i x_i / den, den = max(sum_i m_i, 1).
//
// Replaces two TPU kernel bodies:
//   cclip_resident  _cclip_resident_kernel (src/repro/kernels/centered_clip.py),
//                   launched by _run_resident (centered_clip.py)
//   cclip_update    _cclip_update_kernel, launched by _cclip_tiled
//                   (centered_clip.py)
// The tiled schedule's per-row distances are diff_row_ssq's
// (geometric_median.cu), and its bucket means bucket_means'.
//
// What bounds them on the H100:
//   cclip_resident  at the widths it takes (the rows fit in one block's shared
//                   memory, <= 227 KB) it reads at most a few hundred KB and is
//                   bound by latency: one block walks all iterations.  Its bound
//                   is bytes (the input read once), a few microseconds.
//   cclip_update    bytes: it reads the (rows, d) input and z once and writes
//                   z' once (4 or 2 bytes a value), a few flops per value.
//
// Design:
//   cclip_resident  one block of kResThreads threads on the staging it shares
//                   with the geometric median (resident.cuh): rows or bucket
//                   means written once into dynamic shared memory, v0 the
//                   masked mean, then every step there, two barriers a step.
//                   Its w holds the scales s_i.  The host picks it when its
//                   count of cclip_resident_smem_floats(rows, d) fits the
//                   card's opt-in shared memory per block and passes that count
//                   to the launch, which checks it.
//   cclip_update    one thread per coordinate, rows walked in order; the
//                   scales, factors and den are read on the device (no host
//                   sync between the tiled schedule's launches).  A null z is
//                   the zero vector: with s = m it gives v0.
// Every sum runs in a fixed order, and the kernels are built with
// --fmad=false, so a kernel and its plain PyTorch version differ only by the
// order of their sums.
#include <stdint.h>

#include "resident.cuh"

namespace repro {

constexpr int kUpdThreads = 256;

// floats of dynamic shared memory cclip_resident takes for `rows` rows of
// width d: the shared resident layout (resident.cuh), its w holding the
// scales s_i.
__host__ __device__ inline long long cclip_resident_smem_floats(int rows, long long d) {
  return resident_smem_floats(rows, d);
}

// x: (n, d); factor: (n_p,) or null for 1; mask: (n_p,); idx: (n_p,) row
// order (slots holding an index outside [0, n) are empty); out: (d,) f32.
// rows = n when s = 1 (idx unused), else n_p / s buckets.
template <typename T>
__global__ void __launch_bounds__(kResThreads)
cclip_resident_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                      const float* __restrict__ mask, const int* __restrict__ idx,
                      float* __restrict__ out, int n, int64_t d, int s, int rows, int iters,
                      float tau) {
  extern __shared__ float smem[];
  const Resident r = resident_layout(smem, rows, d);
  const int tid = threadIdx.x;
  resident_stage(r, x, factor, mask, idx, n, s);
  const float den = resident_masked_mean(r);
  for (int it = 0; it < iters; ++it) {
    resident_row_partials(r);  // also: every thread is done with w
    for (int i = tid; i < rows; i += kResThreads) {
      const float nrm = sqrtf(resident_row_ssq(r, i) + 1e-30f);
      r.w[i] = fminf(1.f, tau / nrm) * r.m[i];
    }
    __syncthreads();
    for (int64_t j = tid; j < d; j += kResThreads) {
      const float zj = r.z[j];
      float acc = 0.f;
      for (int i = 0; i < rows; ++i) acc += (r.xs[i * d + j] - zj) * r.w[i];
      r.z[j] = zj + acc / den;
    }
  }
  for (int64_t j = tid; j < d; j += kResThreads) out[j] = r.z[j];
}

// out[j] = z[j] + (sum_i (x[i, j] f[i] - z[j]) sc[i]) / den, den a device
// scalar, z null for 0.
template <typename T>
__global__ void __launch_bounds__(kUpdThreads)
cclip_update_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                    const float* __restrict__ sc, const float* __restrict__ z,
                    const float* __restrict__ den, float* __restrict__ out, int n, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kUpdThreads + threadIdx.x;
  if (j >= d) return;
  const float zj = z != nullptr ? z[j] : 0.f;
  float acc = 0.f;
  for (int i = 0; i < n; ++i)
    acc += (to_f32(x[static_cast<int64_t>(i) * d + j]) * factor_of(factor, i) - zj) * sc[i];
  out[j] = zj + acc / *den;
}

template <typename T>
cudaError_t launch_cclip_resident(const void* x, const float* factor, const float* mask,
                                  const int* idx, float* out, int n, long long d, int s,
                                  int rows, int iters, float tau, long long smem_bytes,
                                  cudaStream_t st) {
  // the host's count of the layout must be this kernel's: the host decides
  // the dispatch with it, so a drift between the two copies fails here
  if (smem_bytes != 4 * cclip_resident_smem_floats(rows, d)) return cudaErrorInvalidValue;
  cclip_resident_kernel<T><<<1, kResThreads, static_cast<size_t>(smem_bytes), st>>>(
      static_cast<const T*>(x), factor, mask, idx, out, n, d, s, rows, iters, tau);
  return cudaGetLastError();
}

}  // namespace repro

// The opt-in shared memory per block of the current device, in bytes (0 on
// error): the budget cclip_resident must fit.  It also lets both
// cclip_resident instantiations take that much dynamic shared memory on this
// device, so the host calls it once per device before the first launch there.
extern "C" int cclip_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  if (cudaFuncSetAttribute(repro::cclip_resident_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess ||
      cudaFuncSetAttribute(repro::cclip_resident_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess)
    return 0;
  return optin;
}

// x: (n, d) row-major, dtype 0 = f32, 1 = bf16; factor: (n_p,) f32 or null;
// mask: (n_p,) f32; idx: (n_p,) int32 (unused when s = 1); out: (d,) f32;
// smem_bytes: the host's count of the dynamic shared memory, which must equal
// cclip_resident_smem_floats(n_p / s, d) * 4 and fit what cclip_smem_optin
// allowed.
extern "C" int cclip_resident_launch(const void* x, const void* factor, const void* mask,
                                     const void* idx, void* out, int dtype, int n, int n_p,
                                     long long d, int s, int iters, float tau,
                                     long long smem_bytes, void* stream) {
  if (n <= 0 || d <= 0 || s < 1 || iters < 0 || n_p < n || n_p % s != 0 ||
      (s == 1 && n_p != n) || (s > 1 && idx == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n_p / s;
  const auto* f = static_cast<const float*>(factor);
  const auto* m = static_cast<const float*>(mask);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(repro::launch_cclip_resident<float>(
        x, f, m, ix, o, n, d, s, rows, iters, tau, smem_bytes, st));
  if (dtype == 1)
    return static_cast<int>(repro::launch_cclip_resident<__nv_bfloat16>(
        x, f, m, ix, o, n, d, s, rows, iters, tau, smem_bytes, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (n, d); factor: (n,) f32 or null; sc: (n,) f32 scales; z: (d,) f32 or
// null for 0; den: a device f32 scalar; out: (d,) f32.
extern "C" int cclip_update_launch(const void* x, const void* factor, const void* sc,
                                   const void* z, const void* den, void* out, int dtype, int n,
                                   long long d, void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(factor);
  const auto* s = static_cast<const float*>(sc);
  const auto* zz = static_cast<const float*>(z);
  const auto* dn = static_cast<const float*>(den);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks =
      static_cast<unsigned>((d + repro::kUpdThreads - 1) / repro::kUpdThreads);
  if (dtype == 0) {
    repro::cclip_update_kernel<float><<<blocks, repro::kUpdThreads, 0, st>>>(
        static_cast<const float*>(x), f, s, zz, dn, o, n, d);
  } else if (dtype == 1) {
    repro::cclip_update_kernel<__nv_bfloat16><<<blocks, repro::kUpdThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), f, s, zz, dn, o, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
