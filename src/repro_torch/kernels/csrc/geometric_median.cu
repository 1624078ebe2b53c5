// The smoothed Weiszfeld geometric median (RFA) and the coordinate-tiled
// helpers it shares with CenteredClip:
//
//   z <- sum_i w_i x_i / max(sum_i w_i, eps),  w_i = m_i / sqrt(||x_i - z||^2 + eps)
//
// from z0 = sum_i m_i x_i / max(sum_i m_i, 1), over the clipped rows x_i f_i
// or, under Bucketing, over their mask-weighted bucket means.
//
// Replaces four TPU kernel bodies:
//   gm_resident   _gm_resident_kernel (src/repro/kernels/geometric_median.py),
//                 launched by _run_resident (src/repro/kernels/centered_clip.py)
//   diff_row_ssq  _diff_ssq_kernel, launched by diff_row_ssq (centered_clip.py)
//   bucket_means  _bucket_means_kernel, launched by bucket_means_tiled
//                 (centered_clip.py)
//   gm_update     _gm_update_kernel, launched by _gm_tiled (geometric_median.py)
//
// What bounds them on the H100:
//   gm_resident   at the widths it takes (the rows fit in one block's shared
//                 memory, <= 227 KB) it reads at most a few hundred KB and is
//                 bound by latency: one block walks all iterations.  Its bound
//                 is bytes (the input read once) and is a few microseconds.
//   diff_row_ssq, bucket_means, gm_update
//                 bytes: each reads its (rows, d) input once (4 or 2 bytes a
//                 value) and does a few flops per value.
//
// Design:
//   gm_resident   one block of kResThreads threads.  The staging it shares
//                 with CenteredClip (resident.cuh) writes the clipped rows
//                 (s = 1) or their bucket means (s >= 2, gathered through the
//                 row order idx, padded slots never read) into dynamic shared
//                 memory once and forms z0; every iteration runs there (two
//                 barriers per iteration).  The host picks it when its count
//                 of gm_resident_smem_floats(rows, d) fits the card's opt-in
//                 shared memory per block, and passes that count to the
//                 launch, which checks it.
//   diff_row_ssq  grid of column chunks of kSsqChunk; a block keeps its chunk
//                 of z in registers, walks all rows and writes partial[i, c]:
//                 no atomics, so runs repeat bit for bit, and z is read once
//                 (a grid over (chunks, rows) would read the d-wide z n times,
//                 and at d = 2^24 z does not fit in L2).
//   bucket_means, gm_update
//                 one thread per coordinate, rows walked in order; the row
//                 auxiliaries are broadcast loads.
// Every sum runs in a fixed order, and the kernels are built with
// --fmad=false, so a kernel and its plain PyTorch version differ only by the
// order of their sums.
#include <stdint.h>

#include "resident.cuh"

namespace repro {

constexpr int kSsqThreads = 256;
constexpr int kSsqPerThread = 8;
constexpr int kSsqChunk = kSsqThreads * kSsqPerThread;  // columns per block
constexpr int kSsqRowBatch = 32;  // rows whose warp sums share the buffer
constexpr int kColThreads = 256;

// floats of dynamic shared memory gm_resident takes for `rows` rows of width
// d: the shared resident layout (resident.cuh), its w holding the Weiszfeld
// weights.
__host__ __device__ inline long long gm_resident_smem_floats(int rows, long long d) {
  return resident_smem_floats(rows, d);
}

// x: (n, d); factor: (n_p,) or null for 1; mask: (n_p,); idx: (n_p,) row
// order (slots holding an index outside [0, n) are empty); out: (d,) f32.
// rows = n when s = 1 (idx unused), else n_p / s buckets.
template <typename T>
__global__ void __launch_bounds__(kResThreads)
gm_resident_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                   const float* __restrict__ mask, const int* __restrict__ idx,
                   float* __restrict__ out, int n, int64_t d, int s, int rows, int iters,
                   float eps) {
  extern __shared__ float smem[];
  const Resident r = resident_layout(smem, rows, d);
  const int tid = threadIdx.x;
  resident_stage(r, x, factor, mask, idx, n, s);
  resident_masked_mean(r);
  for (int it = 0; it < iters; ++it) {
    resident_row_partials(r);  // also: every thread is done with w
    for (int i = tid; i < rows; i += kResThreads)
      r.w[i] = r.m[i] / sqrtf(resident_row_ssq(r, i) + eps);
    __syncthreads();
    float wsum = 0.f;
    for (int i = 0; i < rows; ++i) wsum += r.w[i];
    wsum = fmaxf(wsum, eps);
    for (int64_t j = tid; j < d; j += kResThreads) {
      float acc = 0.f;
      for (int i = 0; i < rows; ++i) acc += r.xs[i * d + j] * r.w[i];
      r.z[j] = acc / wsum;
    }
  }
  for (int64_t j = tid; j < d; j += kResThreads) out[j] = r.z[j];
}

// partial[i, c] = sum over the columns j of chunk c of (x[i, j] f[i] - z[j])^2.
template <typename T>
__global__ void __launch_bounds__(kSsqThreads)
diff_row_ssq_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                    const float* __restrict__ z, float* __restrict__ partial, int n, int64_t d,
                    int chunks) {
  __shared__ float red[kSsqRowBatch][kSsqThreads / 32];
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t start = static_cast<int64_t>(chunk) * kSsqChunk + threadIdx.x;
  float zr[kSsqPerThread];
#pragma unroll
  for (int k = 0; k < kSsqPerThread; ++k) {
    const int64_t j = start + k * kSsqThreads;
    zr[k] = j < d ? z[j] : 0.f;
  }
  for (int i0 = 0; i0 < n; i0 += kSsqRowBatch) {
    const int batch = n - i0 < kSsqRowBatch ? n - i0 : kSsqRowBatch;
    for (int r = 0; r < batch; ++r) {
      const int64_t i = i0 + r;
      const float f = factor_of(factor, i);
      const T* xr = x + i * d;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kSsqPerThread; ++k) {
        const int64_t j = start + k * kSsqThreads;
        if (j < d) {
          const float diff = to_f32(xr[j]) * f - zr[k];
          acc += diff * diff;
        }
      }
      acc = warp_sum(acc);
      if (lane == 0) red[r][warp] = acc;
    }
    __syncthreads();
    if (threadIdx.x < batch) {
      float total = 0.f;
#pragma unroll
      for (int k = 0; k < kSsqThreads / 32; ++k) total += red[threadIdx.x][k];
      partial[static_cast<int64_t>(i0 + threadIdx.x) * chunks + chunk] = total;
    }
    __syncthreads();
  }
}

// out[b, j] = sum_t (x[r_t, j] f[r_t]) m[r_t] / max(sum_t m[r_t], 1) over the
// slots t of bucket b that hold a row r_t in [0, n).
template <typename T>
__global__ void __launch_bounds__(kColThreads)
bucket_means_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                    const float* __restrict__ mask, const int* __restrict__ idx,
                    float* __restrict__ out, int n, int64_t d, int s, int nb) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kColThreads + threadIdx.x;
  if (j >= d) return;
  for (int b = 0; b < nb; ++b) {
    float acc = 0.f, cnt = 0.f;
    for (int t = 0; t < s; ++t) {
      const int r = idx[b * s + t];
      if (r < 0 || r >= n) continue;  // an empty slot: never read
      const float mr = mask[r];
      acc += (to_f32(x[static_cast<int64_t>(r) * d + j]) * factor_of(factor, r)) * mr;
      cnt += mr;
    }
    out[static_cast<int64_t>(b) * d + j] = acc / fmaxf(cnt, 1.f);
  }
}

// out[j] = sum_i (x[i, j] f[i]) w[i] / wsum, wsum a device scalar.
template <typename T>
__global__ void __launch_bounds__(kColThreads)
gm_update_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                 const float* __restrict__ wt, const float* __restrict__ wsum,
                 float* __restrict__ out, int n, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kColThreads + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
  for (int i = 0; i < n; ++i)
    acc += (to_f32(x[static_cast<int64_t>(i) * d + j]) * factor_of(factor, i)) * wt[i];
  out[j] = acc / *wsum;
}

inline unsigned col_blocks(long long d) {
  return static_cast<unsigned>((d + kColThreads - 1) / kColThreads);
}

template <typename T>
cudaError_t launch_resident(const void* x, const float* factor, const float* mask,
                            const int* idx, float* out, int n, long long d, int s, int rows,
                            int iters, float eps, long long smem_bytes, cudaStream_t st) {
  // the host's count of the layout must be this kernel's: the host decides
  // the dispatch with it, so a drift between the two copies fails here
  if (smem_bytes != 4 * gm_resident_smem_floats(rows, d)) return cudaErrorInvalidValue;
  gm_resident_kernel<T><<<1, kResThreads, static_cast<size_t>(smem_bytes), st>>>(
      static_cast<const T*>(x), factor, mask, idx, out, n, d, s, rows, iters, eps);
  return cudaGetLastError();
}

}  // namespace repro

// The opt-in shared memory per block of the current device, in bytes (0 on
// error): the budget gm_resident must fit.  It also lets both gm_resident
// instantiations take that much dynamic shared memory on this device, so the
// host calls it once per device before the first gm_resident launch there.
extern "C" int gm_smem_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  if (cudaFuncSetAttribute(repro::gm_resident_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess ||
      cudaFuncSetAttribute(repro::gm_resident_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess)
    return 0;
  return optin;
}

// x: (n, d) row-major, dtype 0 = f32, 1 = bf16; factor: (n_p,) f32 or null;
// mask: (n_p,) f32; idx: (n_p,) int32 (unused when s = 1); out: (d,) f32;
// smem_bytes: the host's count of the dynamic shared memory, which must equal
// gm_resident_smem_floats(n_p / s, d) * 4 and fit what gm_smem_optin allowed.
extern "C" int gm_resident_launch(const void* x, const void* factor, const void* mask,
                                  const void* idx, void* out, int dtype, int n, int n_p,
                                  long long d, int s, int iters, float eps,
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
    return static_cast<int>(
        repro::launch_resident<float>(x, f, m, ix, o, n, d, s, rows, iters, eps,
                                      smem_bytes, st));
  if (dtype == 1)
    return static_cast<int>(
        repro::launch_resident<__nv_bfloat16>(x, f, m, ix, o, n, d, s, rows, iters,
                                              eps, smem_bytes, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int diff_row_ssq_chunk() { return repro::kSsqChunk; }

// x: (n, d); factor: (n,) f32 or null; z: (d,) f32; partial: (n, chunks) f32
// with chunks = ceil(d / diff_row_ssq_chunk()).
extern "C" int diff_row_ssq_launch(const void* x, const void* factor, const void* z,
                                   void* partial, int dtype, int n, long long d, int chunks,
                                   void* stream) {
  if (n <= 0 || d <= 0 || chunks != (d + repro::kSsqChunk - 1) / repro::kSsqChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(factor);
  const auto* zz = static_cast<const float*>(z);
  auto* p = static_cast<float*>(partial);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    repro::diff_row_ssq_kernel<float><<<chunks, repro::kSsqThreads, 0, st>>>(
        static_cast<const float*>(x), f, zz, p, n, d, chunks);
  } else if (dtype == 1) {
    repro::diff_row_ssq_kernel<__nv_bfloat16><<<chunks, repro::kSsqThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), f, zz, p, n, d, chunks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (n, d); factor, mask, idx: (n_p,) with n_p = nb * s; out: (nb, d) f32.
extern "C" int bucket_means_launch(const void* x, const void* factor, const void* mask,
                                   const void* idx, void* out, int dtype, int n, long long d,
                                   int s, int nb, void* stream) {
  if (n <= 0 || d <= 0 || s < 1 || nb < 1 || static_cast<long long>(nb) * s < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(factor);
  const auto* m = static_cast<const float*>(mask);
  const auto* ix = static_cast<const int*>(idx);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = repro::col_blocks(d);
  if (dtype == 0) {
    repro::bucket_means_kernel<float><<<blocks, repro::kColThreads, 0, st>>>(
        static_cast<const float*>(x), f, m, ix, o, n, d, s, nb);
  } else if (dtype == 1) {
    repro::bucket_means_kernel<__nv_bfloat16><<<blocks, repro::kColThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), f, m, ix, o, n, d, s, nb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (n, d); factor: (n,) f32 or null; w: (n,) f32; wsum: a device f32
// scalar; out: (d,) f32.
extern "C" int gm_update_launch(const void* x, const void* factor, const void* w,
                                const void* wsum, void* out, int dtype, int n, long long d,
                                void* stream) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* f = static_cast<const float*>(factor);
  const auto* wt = static_cast<const float*>(w);
  const auto* ws = static_cast<const float*>(wsum);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = repro::col_blocks(d);
  if (dtype == 0) {
    repro::gm_update_kernel<float><<<blocks, repro::kColThreads, 0, st>>>(
        static_cast<const float*>(x), f, wt, ws, o, n, d);
  } else if (dtype == 1) {
    repro::gm_update_kernel<__nv_bfloat16><<<blocks, repro::kColThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), f, wt, ws, o, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
