// The one-block resident kernels that the iterative rules share: the
// Weiszfeld geometric median (gm_resident, geometric_median.cu) and
// CenteredClip (cclip_resident, centered_clip.cu).  One launch stages the
// clipped rows (s = 1) or their bucket means (s >= 2), forms the masked mean
// z0 and runs every step; each rule supplies only its step body, a struct
// with four members:
//
//   weight(ssq, m)      row i's weight from its squared distance to z and m_i
//   divisor(wsum, den)  what the update divides by (wsum = sum_i w_i, taken
//                       only when kWeightSum; den = max(sum_i m_i, 1))
//   term(x, z, w)       row i's summand of the update at one coordinate
//   next(z, acc, div)   the new z_j from the summands' total
//
// What bounds them on the H100: latency.  One block does all the work, so
// the time is the launch, one trip to L2 to stage the rows, and per step a
// reduction of every row's distance across the block and a broadcast of the
// weights; the bytes (the input read once) take a few nanoseconds.
//
// Design.  The block is sized to d: kResCoords coordinates a thread,
// threads = min(kResMaxThreads, 32 ceil(ceil(d / kResCoords) / 32)), and
// thread t owns the coordinates j = t + k * threads.  Only the owner ever
// touches column j, so the staged rows and z need no barrier; the one
// exchange a step is each row's sum of squares, and every warp computes
// every row's weight itself from the warp sums.
//   - Staging: the loads of a tile of rows and coordinates are all issued
//     before any is used (load_now; a slot's row, mask and factor are
//     broadcast loads through L1).
//   - Row sums: a thread sums its coordinates for kResRows rows at once,
//     then one transposing shuffle reduction (15 shuffles and a last one for
//     16 rows) leaves row r's warp sum in lanes 2r and 2r + 1.
//   - One barrier a step: the warp sums go to a buffer chosen by the
//     step's parity, so a warp that runs ahead into the next step never
//     writes over sums another warp is still reading.  A one-warp block
//     takes them by shuffle and has no barrier at all.
//   - Two code paths, chosen by the launcher from (rows, d): with
//     rows <= kResRegRows and at most kResRegK coordinates a thread (the
//     shapes Fig. 1 and Fig. 2 run: ten rows, two or three coordinates),
//     the rows and z live in registers (resident_regs_kernel, built for two
//     and for three coordinates) and shared memory holds only the warp
//     sums; every other (rows, d) keeps the rows and z in dynamic shared
//     memory in the layout below (resident_smem_kernel), each thread
//     reading only its own columns.
//
// Layout (floats) of the shared-memory path: the rows or bucket means xs
// (rows, d), the iterate z (d,), the row weights m and a spare word a row
// (unused; the host's count, and with it the dispatch threshold, include
// it), and kResRedWords words a row of warp sums: two buffers of at most
// kResMaxWarps warps.  The host counts the same floats
// (kernels/centered_clip.py ``resident_smem_bytes``) to decide the
// schedule, and each launch refuses a count that differs.
//
// Every sum runs in an order set by (rows, d) alone, and the sources are
// built with --fmad=false, so repeat calls are bit for bit equal and a kernel
// differs from its plain PyTorch version only by the order of its sums.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kResMaxWarps = 8;
constexpr int kResMaxThreads = 32 * kResMaxWarps;
constexpr int kResRedWords = 2 * kResMaxWarps;  // warp sums a row, both parities
constexpr int kResCoords = 3;  // coordinates a thread the block is sized for
constexpr int kResRows = 16;   // rows a tile and a shuffle reduction hold
constexpr int kResRegRows = 10;  // the register path's rows: Fig. 1 and 2's buckets
constexpr int kResRegK = 3;    // the most coordinates a thread keeps in registers
constexpr int kResStageK = 8;  // coordinates of a staging tile (smem path)
constexpr int kResStageRows = 4;  // rows of a staging tile (smem path)
constexpr unsigned kFull = 0xffffffffu;

// floats of dynamic shared memory a resident kernel takes for `rows` rows
// of width d: the rows, z, the row weights m (and a spare word) and the
// warp sums.
__host__ __device__ inline long long resident_smem_floats(int rows, long long d) {
  return static_cast<long long>(rows) * d + d + static_cast<long long>(rows) * (kResRedWords + 2);
}

// The block the launcher picks for width d.
inline int resident_threads(long long d) {
  const long long per = (d + kResCoords - 1) / kResCoords;
  const long long threads = 32 * ((per + 31) / 32);
  return threads > kResMaxThreads ? kResMaxThreads : static_cast<int>(threads);
}

__device__ __forceinline__ float factor_of(const float* __restrict__ factor, int64_t r) {
  return factor != nullptr ? factor[r] : 1.f;
}

__device__ __forceinline__ void block_sync(int warps) {
  if (warps > 1)
    __syncthreads();
  else
    __syncwarp();
}

// The sum of v over the warp, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// The sum of v over the warp, the same in every lane (xor butterfly).
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One level of transpose_sum: lanes that differ in bit 2 * HALF swap the
// half of v[0 .. 2 * HALF) that the other keeps, and add it to their own.
template <int HALF>
__device__ __forceinline__ void transpose_level(float (&v)[kResRows], int lane) {
  const bool upper = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int h = 0; h < HALF; ++h) {
    const float send = upper ? v[h] : v[h + HALF];
    const float keep = upper ? v[h + HALF] : v[h];
    v[h] = keep + __shfl_xor_sync(kFull, send, 2 * HALF);
  }
  if constexpr (HALF > 1) transpose_level<HALF / 2>(v, lane);
}

// Sums each of v[0..15] over the warp at once: each level sends half of the
// remaining values to the partner lane and keeps the other half (15
// shuffles, and one more for the last pair).  Returns, in lanes 2r and
// 2r + 1, the warp's total of v[r].
__device__ __forceinline__ float transpose_sum(float (&v)[kResRows]) {
  static_assert(kResRows == 16, "the levels pair lanes 16, 8, 4, 2 apart");
  transpose_level<kResRows / 2>(v, threadIdx.x & 31);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// Loads the compiler issues where they stand: it may neither drop them nor
// move them behind a branch, so a staging tile's loads are all in flight
// before the first is used (a load behind a branch on a loaded row index
// waits for that index, and holds every later load back).
__device__ __forceinline__ int load_now(const int* p) {
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_now(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_now(const __nv_bfloat16* p) {
  unsigned short v;
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // bf16 is f32's high half
}

// Stages rows b0 .. b0 + RB - 1 at this thread's coordinates
// j0 + k * stride (k < KC) into acc, 0 past `rows` or past d, and their row
// weights into m, 0 past `rows`: the clipped rows x_i f_i with m_i = mask_i
// (s = 1), or the bucket means sum_t (x_r f_r) mask_r / max(cnt, 1) over the
// slots t of the bucket that hold a row r in [0, n), with m = 1 where the
// bucket holds a sampled row (s >= 2).  Every address is clamped into the
// input and every value selected, and the loads are load_now's: a slot's
// row indices first, then all its rows' mask, factor and x loads.  An
// empty slot's values are selected away, never summed.
template <typename T, int KC, int RB>
__device__ __forceinline__ void stage_tile(float (&acc)[RB][KC], float (&m)[RB],
                                           const T* __restrict__ x,
                                           const float* __restrict__ factor,
                                           const float* __restrict__ mask,
                                           const int* __restrict__ idx, int n, int64_t d, int s,
                                           int rows, int b0, int64_t j0, int64_t stride) {
  int64_t jc[KC];
  bool jin[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    const int64_t j = j0 + k * stride;
    jin[k] = j < d;
    jc[k] = jin[k] ? j : d - 1;
  }
  if (s == 1) {
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const bool in = b0 + i < rows;
      const int b = in ? b0 + i : rows - 1;
      const float f = factor != nullptr ? load_now(factor + b) : 1.f;
      const float mb = load_now(mask + b);
      const T* xr = x + static_cast<int64_t>(b) * d;
      m[i] = in ? mb : 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = load_now(xr + jc[k]) * f;
        acc[i][k] = in && jin[k] ? v : 0.f;
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    m[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[i][k] = 0.f;
  }
  for (int t = 0; t < s; ++t) {
    int row[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) row[i] = load_now(idx + (b0 + i < rows ? b0 + i : rows - 1) * s + t);
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const bool ok = b0 + i < rows && row[i] >= 0 && row[i] < n;
      const int rc = ok ? row[i] : 0;
      const float mr = load_now(mask + rc);
      const float f = factor != nullptr ? load_now(factor + rc) : 1.f;
      const T* xr = x + static_cast<int64_t>(rc) * d;
      m[i] += ok ? mr : 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float v = (load_now(xr + jc[k]) * f) * mr;
        acc[i][k] += ok && jin[k] ? v : 0.f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const float inv = 1.f / fmaxf(m[i], 1.f);  // exact for the counts 1, 2, 4, ...
#pragma unroll
    for (int k = 0; k < KC; ++k) acc[i][k] *= inv;
    m[i] = m[i] > 0.5f ? 1.f : 0.f;
  }
}

// rows <= kResRegRows, K * blockDim.x >= d: the rows and z in registers,
// kResRegRows of them (rows past `rows` hold 0 and weigh 0, so no step
// branches on the row count).
// x: (n, d); factor: (n_p,) or null for 1; mask: (n_p,); idx: (n_p,) row
// order; out: (d,) f32; dynamic shared memory: 2 * rows * warps floats of
// warp sums.
template <typename T, class Step, int K>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_regs_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                     const float* __restrict__ mask, const int* __restrict__ idx,
                     float* __restrict__ out, int n, int64_t d, int s, int rows, int iters,
                     Step step) {
  extern __shared__ float red[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = blockDim.x;
  constexpr int R = kResRegRows;
  float xr[R][K], m[R];
  stage_tile<T, K, R>(xr, m, x, factor, mask, idx, n, d, s, rows, 0, threadIdx.x, stride);
  float msum = 0.f, my_m = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    msum += m[i];
    if (i == lane) my_m = m[i];
  }
  const float den = fmaxf(msum, 1.f);
  float z[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) acc += xr[i][k] * m[i];
    z[k] = acc / den;
  }
  for (int it = 0; it < iters; ++it) {
    float part[kResRows];
#pragma unroll
    for (int i = 0; i < kResRows; ++i) {
      part[i] = 0.f;
      if (i < R) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float diff = xr[i][k] - z[k];
          part[i] += diff * diff;
        }
      }
    }
    const float v = transpose_sum(part);
    float ssq = 0.f;
    if (warps == 1) {
      ssq = __shfl_sync(kFull, v, (2 * lane) & 31);
    } else {
      float* buf = red + (it & 1) * rows * warps;
      if ((lane & 1) == 0 && (lane >> 1) < rows) buf[(lane >> 1) * warps + warp] = v;
      __syncthreads();
      if (lane < rows)
        for (int w = 0; w < warps; ++w) ssq += buf[lane * warps + w];
    }
    const float wl = lane < rows ? step.weight(ssq, my_m) : 0.f;
    const float div = step.divisor(Step::kWeightSum ? warp_allsum(wl) : 0.f, den);
    float w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = __shfl_sync(kFull, wl, i);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) acc += step.term(xr[i][k], z[k], w[i]);
      z[k] = step.next(z[k], acc, div);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t j = threadIdx.x + static_cast<int64_t>(k) * stride;
    if (j < d) out[j] = z[k];
  }
}

// Row r's weight from the warp sums in buf (warps a row), or 0 past rows.
template <class Step>
__device__ __forceinline__ float row_weight(const Step& step, const float* buf,
                                            const float* m, int r, int rows, int warps) {
  if (r >= rows) return 0.f;
  float ssq = 0.f;
  for (int w = 0; w < warps; ++w) ssq += buf[r * warps + w];
  return step.weight(ssq, m[r]);
}

// The shared-memory path's staging in tiles of kResStageRows rows by
// kResStageK coordinates (stage_tile): xs, m, and z0's numerators
// sum_i xs_ij m_i (rows in order) in z.
template <typename T>
__device__ __forceinline__ void stage_tiles(float* xs, float* z, float* m,
                                            const T* __restrict__ x,
                                            const float* __restrict__ factor,
                                            const float* __restrict__ mask,
                                            const int* __restrict__ idx, int n, int d, int s,
                                            int rows) {
  const int stride = blockDim.x;
  const int chunk = kResStageK * stride;
  for (int j0 = 0; j0 < d; j0 += chunk) {
    float zn[kResStageK];  // z0's numerators sum_i xs_ij m_i, rows in order
#pragma unroll
    for (int k = 0; k < kResStageK; ++k) zn[k] = 0.f;
    for (int b0 = 0; b0 < rows; b0 += kResStageRows) {
      float acc[kResStageRows][kResStageK], mt[kResStageRows];
      stage_tile<T, kResStageK, kResStageRows>(acc, mt, x, factor, mask, idx, n, d, s, rows,
                                               b0, j0 + threadIdx.x, stride);
#pragma unroll
      for (int i = 0; i < kResStageRows; ++i) {
        if (b0 + i < rows) {
#pragma unroll
          for (int k = 0; k < kResStageK; ++k) {
            const int j = j0 + threadIdx.x + k * stride;
            if (j < d) xs[(b0 + i) * d + j] = acc[i][k];
            zn[k] += acc[i][k] * mt[i];
          }
          if (j0 == 0 && threadIdx.x == 0) m[b0 + i] = mt[i];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kResStageK; ++k) {
      const int j = j0 + threadIdx.x + k * stride;
      if (j < d) z[j] = zn[k];
    }
  }
}

// Any rows and d the layout admits: xs, z and m in dynamic shared memory
// (the layout above), each thread reading only its own columns of xs and z.
// Staging goes in tiles of kResStageRows rows by kResStageK coordinates and
// sums z0's numerators on the way; a step walks the thread's coordinates
// with the rows of one kResRows tile unrolled, in groups of 4 (rows past
// `rows` in the last group read row rows - 1 and weigh 0: that row's own
// term at the same coordinate is non-finite whenever the copy's is, so the
// result's non-finite entries stay where the plain version has them).
template <typename T, class Step>
__global__ void __launch_bounds__(kResMaxThreads, 1)
resident_smem_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                     const float* __restrict__ mask, const int* __restrict__ idx,
                     float* __restrict__ out, int n, int64_t d64, int s, int rows, int iters,
                     Step step) {
  extern __shared__ float smem[];
  const int d = static_cast<int>(d64);  // the layout holds < 2^16 floats
  float* xs = smem;
  float* z = xs + rows * d;
  float* m = z + d;
  float* red = m + 2 * rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int stride = blockDim.x;
  stage_tiles(xs, z, m, x, factor, mask, idx, n, d, s, rows);
  block_sync(warps);
  float msum = 0.f;
  for (int i = 0; i < rows; ++i) msum += m[i];
  const float den = fmaxf(msum, 1.f);
  for (int j = threadIdx.x; j < d; j += stride) z[j] /= den;
  for (int it = 0; it < iters; ++it) {
    float* buf = red + (it & 1) * rows * warps;
    for (int b0 = 0; b0 < rows; b0 += kResRows) {
      int off[kResRows];
#pragma unroll
      for (int i = 0; i < kResRows; ++i) off[i] = (b0 + i < rows ? b0 + i : rows - 1) * d;
      float part[kResRows];
#pragma unroll
      for (int i = 0; i < kResRows; ++i) part[i] = 0.f;
      for (int j = threadIdx.x; j < d; j += 2 * stride) {  // two coordinates at once
        const bool two = j + stride < d;
        const int j2 = two ? j + stride : j;
        const float zj = z[j], zj2 = z[j2];
#pragma unroll
        for (int g = 0; g < kResRows; g += 4) {
          if (b0 + g < rows) {  // the same in every thread: rows in groups of 4
#pragma unroll
            for (int i = g; i < g + 4; ++i) {
              const float diff = xs[off[i] + j] - zj;
              const float diff2 = xs[off[i] + j2] - zj2;
              part[i] += diff * diff;
              part[i] += two ? diff2 * diff2 : 0.f;
            }
          }
        }
      }
      const float v = transpose_sum(part);
      const int r = b0 + (lane >> 1);
      if ((lane & 1) == 0 && r < rows) buf[r * warps + warp] = v;
    }
    block_sync(warps);
    // lane l holds the weights of rows l, l + 32, ...; the first two row
    // tiles' weights are broadcast once a step, a later tile's per coordinate
    float w0 = 0.f, wsum = 0.f;
    for (int g = 0; g < rows; g += 32) {
      const float wl = row_weight(step, buf, m, g + lane, rows, warps);
      if (g == 0) w0 = wl;
      wsum += wl;
    }
    const float div = step.divisor(Step::kWeightSum ? warp_allsum(wsum) : 0.f, den);
    float wt[2][kResRows];
#pragma unroll
    for (int i = 0; i < kResRows; ++i) {
      wt[0][i] = __shfl_sync(kFull, w0, i);
      wt[1][i] = __shfl_sync(kFull, w0, kResRows + i);
    }
    // the coordinate loop runs the same count in every lane, for the
    // shuffles of a third row tile
    const int per = (d + stride - 1) / stride;
    for (int k = 0; k < per; k += 2) {  // two coordinates at once
      const int j = threadIdx.x + k * stride;
      const int j2 = j + stride;
      const int jc = j < d ? j : d - 1;  // no step writes xs: its reads may clamp
      const int jc2 = j2 < d ? j2 : d - 1;
      // z only at this thread's own columns (z[d - 1] is another thread's)
      const float zj = j < d ? z[j] : 0.f, zj2 = j2 < d ? z[j2] : 0.f;
      float acc = 0.f, acc2 = 0.f;
      for (int b0 = 0; b0 < rows; b0 += kResRows) {
        float w[kResRows];
        if (b0 < 2 * kResRows) {
#pragma unroll
          for (int i = 0; i < kResRows; ++i) w[i] = b0 == 0 ? wt[0][i] : wt[1][i];
        } else {
          const float wl = row_weight(step, buf, m, (b0 & ~31) + lane, rows, warps);
#pragma unroll
          for (int i = 0; i < kResRows; ++i) w[i] = __shfl_sync(kFull, wl, (b0 & 31) + i);
        }
#pragma unroll
        for (int g = 0; g < kResRows; g += 4) {
          if (b0 + g < rows) {
#pragma unroll
            for (int i = g; i < g + 4; ++i) {
              const int b = b0 + i < rows ? b0 + i : rows - 1;
              acc += step.term(xs[b * d + jc], zj, w[i]);
              acc2 += step.term(xs[b * d + jc2], zj2, w[i]);
            }
          }
        }
      }
      if (j < d) z[j] = step.next(zj, acc, div);
      if (j2 < d) z[j2] = step.next(zj2, acc2, div);
    }
  }
  for (int j = threadIdx.x; j < d; j += stride) out[j] = z[j];
}

// Lets both shared-memory instantiations of Step take the card's opt-in
// shared memory per block; returns it in bytes (0 on error).
template <class Step>
int resident_optin() {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  if (cudaFuncSetAttribute(resident_smem_kernel<float, Step>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess ||
      cudaFuncSetAttribute(resident_smem_kernel<__nv_bfloat16, Step>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess)
    return 0;
  return optin;
}

// One launch of Step's resident kernel on the path (rows, d) selects.
// smem_bytes: the host's count of the layout, which must be this source's:
// the host decides the dispatch with it, so a drift between the two copies
// fails here.
template <typename T, class Step>
cudaError_t launch_resident(const void* x, const float* factor, const float* mask,
                            const int* idx, float* out, int n, long long d, int s, int rows,
                            int iters, Step step, long long smem_bytes, cudaStream_t st) {
  if (smem_bytes != 4 * resident_smem_floats(rows, d)) return cudaErrorInvalidValue;
  const int threads = resident_threads(d);
  const long long per_thread = (d + threads - 1) / threads;
  const T* xt = static_cast<const T*>(x);
  if (rows <= kResRegRows && per_thread <= kResRegK) {
    const size_t red_bytes = sizeof(float) * 2 * rows * (threads / 32);
    auto* kernel = per_thread <= 2 ? resident_regs_kernel<T, Step, 2>
                                   : resident_regs_kernel<T, Step, kResRegK>;
    kernel<<<1, threads, red_bytes, st>>>(xt, factor, mask, idx, out, n, d, s, rows, iters,
                                          step);
  } else {
    resident_smem_kernel<T, Step><<<1, threads, static_cast<size_t>(smem_bytes), st>>>(
        xt, factor, mask, idx, out, n, d, s, rows, iters, step);
  }
  return cudaGetLastError();
}

// The C entry point's checks and dtype dispatch, shared by both rules.
// x: (n, d) row-major, dtype 0 = f32, 1 = bf16; factor: (n_p,) f32 or null;
// mask: (n_p,) f32; idx: (n_p,) int32 (unused when s = 1); out: (d,) f32.
template <class Step>
int resident_entry(const void* x, const void* factor, const void* mask, const void* idx,
                   void* out, int dtype, int n, int n_p, long long d, int s, int iters,
                   Step step, long long smem_bytes, void* stream) {
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
    return static_cast<int>(launch_resident<float, Step>(x, f, m, ix, o, n, d, s, rows, iters,
                                                         step, smem_bytes, st));
  if (dtype == 1)
    return static_cast<int>(launch_resident<__nv_bfloat16, Step>(
        x, f, m, ix, o, n, d, s, rows, iters, step, smem_bytes, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro
