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
//   cclip_resident  latency: at the widths it takes (the rows fit in one
//                   block's shared memory, <= 227 KB) it reads at most a few
//                   hundred KB and one block walks all iterations
//                   (resident.cuh).
//   cclip_update    bytes: it reads the (rows, d) input and z once and writes
//                   z' once (4 or 2 bytes a value), a few flops per value.
//
// Design:
//   cclip_resident  the one-block resident driver it shares with the geometric
//                   median (resident.cuh): a block sized to d, rows or bucket
//                   means staged once with every load in flight into registers
//                   or dynamic shared memory, v0 the masked mean, then every
//                   step with one barrier a step.  This file gives only the step
//                   body, CClipStep.  The host picks it when its count of
//                   resident_smem_floats(rows, d) fits the card's opt-in shared
//                   memory per block and passes that count to the launch, which
//                   checks it.
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

// The CenteredClip step: s_i = m_i min(1, tau / sqrt(||x_i - v||^2 + 1e-30)),
// v <- v + sum_i (x_i - v) s_i / den.
struct CClipStep {
  float tau;
  static constexpr bool kWeightSum = false;
  __device__ float weight(float ssq, float m) const {
    return fminf(1.f, tau / sqrtf(ssq + 1e-30f)) * m;
  }
  __device__ float divisor(float, float den) const { return den; }
  __device__ float term(float x, float z, float w) const { return (x - z) * w; }
  __device__ float next(float z, float acc, float div) const { return z + acc / div; }
};

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

}  // namespace repro

// The opt-in shared memory per block of the current device, in bytes (0 on
// error): the budget cclip_resident must fit.  It also lets cclip_resident's
// shared-memory instantiations take that much dynamic shared memory on this
// device, so the host calls it once per device before the first launch there.
extern "C" int cclip_smem_optin() { return repro::resident_optin<repro::CClipStep>(); }

// x: (n, d) row-major, dtype 0 = f32, 1 = bf16; factor: (n_p,) f32 or null;
// mask: (n_p,) f32; idx: (n_p,) int32 (unused when s = 1); out: (d,) f32;
// smem_bytes: the host's count of the dynamic shared memory, which must equal
// resident_smem_floats(n_p / s, d) * 4 and fit what cclip_smem_optin allowed.
extern "C" int cclip_resident_launch(const void* x, const void* factor, const void* mask,
                                     const void* idx, void* out, int dtype, int n, int n_p,
                                     long long d, int s, int iters, float tau,
                                     long long smem_bytes, void* stream) {
  return repro::resident_entry(x, factor, mask, idx, out, dtype, n, n_p, d, s, iters,
                               repro::CClipStep{tau}, smem_bytes, stream);
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
