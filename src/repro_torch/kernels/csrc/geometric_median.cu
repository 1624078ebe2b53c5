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
//   gm_resident   latency: at the widths it takes (the rows fit in one block's
//                 shared memory, <= 227 KB) it reads at most a few hundred KB
//                 and one block walks all iterations (resident.cuh).
//   diff_row_ssq, bucket_means, gm_update
//                 bytes: each reads its (rows, d) input once (4 or 2 bytes a
//                 value) and does a few flops per value.
//
// Design:
//   gm_resident   the one-block resident driver it shares with CenteredClip
//                 (resident.cuh): a block sized to d stages the clipped rows
//                 (s = 1) or their bucket means (s >= 2, gathered through the
//                 row order idx, padded slots never read) with every load in
//                 flight, into registers (rows <= 10 and d <= 768) or
//                 dynamic shared memory, forms z0 and runs every step with one
//                 barrier a step.  This file gives only the step body,
//                 GmStep.  The host picks it when its count of
//                 resident_smem_floats(rows, d) fits the card's opt-in shared
//                 memory per block, and passes that count to the launch, which
//                 checks it.
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

// The Weiszfeld step: w_i = m_i / sqrt(||x_i - z||^2 + eps),
// z <- sum_i x_i w_i / max(sum_i w_i, eps).
struct GmStep {
  float eps;
  static constexpr bool kWeightSum = true;
  __device__ float weight(float ssq, float m) const { return m / sqrtf(ssq + eps); }
  __device__ float divisor(float wsum, float) const { return fmaxf(wsum, eps); }
  __device__ float term(float x, float, float w) const { return x * w; }
  __device__ float next(float, float acc, float div) const { return acc / div; }
};

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

}  // namespace repro

// The opt-in shared memory per block of the current device, in bytes (0 on
// error): the budget gm_resident must fit.  It also lets gm_resident's
// shared-memory instantiations take that much dynamic shared memory on this
// device, so the host calls it once per device before the first gm_resident
// launch there.
extern "C" int gm_smem_optin() { return repro::resident_optin<repro::GmStep>(); }

// x: (n, d) row-major, dtype 0 = f32, 1 = bf16; factor: (n_p,) f32 or null;
// mask: (n_p,) f32; idx: (n_p,) int32 (unused when s = 1); out: (d,) f32;
// smem_bytes: the host's count of the dynamic shared memory, which must equal
// resident_smem_floats(n_p / s, d) * 4 and fit what gm_smem_optin allowed.
extern "C" int gm_resident_launch(const void* x, const void* factor, const void* mask,
                                  const void* idx, void* out, int dtype, int n, int n_p,
                                  long long d, int s, int iters, float eps,
                                  long long smem_bytes, void* stream) {
  return repro::resident_entry(x, factor, mask, idx, out, dtype, n, n_p, d, s, iters,
                               repro::GmStep{eps}, smem_bytes, stream);
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
