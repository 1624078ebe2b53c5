// The resident staging that the iterative rules share: the Weiszfeld
// geometric median (gm_resident, geometric_median.cu) and CenteredClip
// (cclip_resident, centered_clip.cu) each keep the whole problem in one
// block's dynamic shared memory and differ only in their iteration body.
//
// Layout (floats): the rows or bucket means xs (rows, d), the iterate
// z (d,), two per-row weights m and w, and the warp sums of each row's
// squared distance red (rows, kResWarps).  The host counts the same floats
// (kernels/centered_clip.py ``resident_smem_bytes``) to decide the
// schedule, and each launch refuses a count that differs.
//
// Every thread owns the coordinates j = tid + k*kResThreads, so z[j] is read
// and written by one thread only; per-row sums are warp-shuffle trees whose
// warp sums meet in shared memory, always in the same order.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kResThreads = 512;
constexpr int kResWarps = kResThreads / 32;

// floats of dynamic shared memory a resident kernel takes for `rows` rows
// of width d: the rows, z, the row weights m and w, and the warp sums.
__host__ __device__ inline long long resident_smem_floats(int rows, long long d) {
  return static_cast<long long>(rows) * d + d + static_cast<long long>(rows) * (kResWarps + 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the total in lane 0
}

__device__ __forceinline__ float factor_of(const float* __restrict__ factor, int64_t r) {
  return factor != nullptr ? factor[r] : 1.f;
}

struct Resident {
  float* xs;   // (rows, d)
  float* z;    // (d,)
  float* m;    // (rows,) row weights: the mask, or 1 for a non-empty bucket
  float* w;    // (rows,) the rule's per-row weights of one iteration
  float* red;  // (rows, kResWarps)
  int rows;
  int64_t d;
};

__device__ __forceinline__ Resident resident_layout(float* smem, int rows, int64_t d) {
  Resident r;
  r.xs = smem;
  r.z = r.xs + static_cast<int64_t>(rows) * d;
  r.m = r.z + d;
  r.w = r.m + rows;
  r.red = r.w + rows;
  r.rows = rows;
  r.d = d;
  return r;
}

// x: (n, d); factor: (n_p,) or null for 1; mask: (n_p,); idx: (n_p,) row
// order (slots holding an index outside [0, n) are empty).  Writes the row
// weights m and the clipped rows (s = 1) or their bucket means (s >= 2,
// padded slots never read), then waits for the block.
template <typename T>
__device__ __forceinline__ void resident_stage(const Resident& r, const T* __restrict__ x,
                                               const float* __restrict__ factor,
                                               const float* __restrict__ mask,
                                               const int* __restrict__ idx, int n, int s) {
  const int tid = threadIdx.x;
  const int64_t d = r.d;
  for (int b = tid; b < r.rows; b += kResThreads) {
    if (s == 1) {
      r.m[b] = mask[b];
    } else {
      float cnt = 0.f;
      for (int t = 0; t < s; ++t) {
        const int row = idx[b * s + t];
        if (row >= 0 && row < n) cnt += mask[row];
      }
      r.m[b] = cnt > 0.5f ? 1.f : 0.f;
    }
  }
  for (int64_t j = tid; j < d; j += kResThreads) {
    if (s == 1) {
      for (int i = 0; i < r.rows; ++i)
        r.xs[i * d + j] = to_f32(x[i * d + j]) * factor_of(factor, i);
    } else {
      for (int b = 0; b < r.rows; ++b) {
        float acc = 0.f, cnt = 0.f;
        for (int t = 0; t < s; ++t) {
          const int row = idx[b * s + t];
          if (row < 0 || row >= n) continue;  // an empty slot: never read
          const float mr = mask[row];
          acc += (to_f32(x[static_cast<int64_t>(row) * d + j]) * factor_of(factor, row)) * mr;
          cnt += mr;
        }
        r.xs[b * d + j] = acc / fmaxf(cnt, 1.f);
      }
    }
  }
  __syncthreads();
}

// z0 = sum_i xs_i m_i / max(sum_i m_i, 1), the masked mean; returns the
// denominator.  z[j] belongs to the thread that owns j.
__device__ __forceinline__ float resident_masked_mean(const Resident& r) {
  float msum = 0.f;
  for (int i = 0; i < r.rows; ++i) msum += r.m[i];
  const float den = fmaxf(msum, 1.f);
  for (int64_t j = threadIdx.x; j < r.d; j += kResThreads) {
    float acc = 0.f;
    for (int i = 0; i < r.rows; ++i) acc += r.xs[i * r.d + j] * r.m[i];
    r.z[j] = acc / den;
  }
  return den;
}

// The warp sums of every row's sum_j (xs_ij - z_j)^2 into red, then waits
// for the block: afterwards resident_row_ssq(r, i) reads row i's total.
__device__ __forceinline__ void resident_row_partials(const Resident& r) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = 0; i < r.rows; ++i) {
    float acc = 0.f;
    for (int64_t j = threadIdx.x; j < r.d; j += kResThreads) {
      const float diff = r.xs[i * r.d + j] - r.z[j];
      acc += diff * diff;
    }
    acc = warp_sum(acc);
    if (lane == 0) r.red[i * kResWarps + warp] = acc;
  }
  __syncthreads();
}

__device__ __forceinline__ float resident_row_ssq(const Resident& r, int i) {
  float ssq = 0.f;
  for (int k = 0; k < kResWarps; ++k) ssq += r.red[i * kResWarps + k];
  return ssq;
}

}  // namespace repro
