// Krum's d-sized passes: the Gram matrix G = X X^T, the cross-Gram A B^T,
// the weighted row-sum sum_i w_i x_i and the single-row select x[r] * s.
// Everything else Krum does is (n, n) algebra on the Gram, in PyTorch.
//
// Replaces four TPU kernel bodies (src/repro/kernels/krum.py):
//   gram_matrix       _gram_kernel, launched by gram_matrix
//   cross_gram        _cross_gram_kernel, launched by cross_gram
//   weighted_row_sum  _row_combine_kernel, launched by weighted_row_sum
//   select_row        _select_row_kernel, launched by select_row
//
// What bounds them on the H100 (n rows of width d, n <= 128):
//   gram, cross_gram  bytes at the widths the server runs: n*d inputs read
//                     once (one operand for the Gram, two for the cross-Gram)
//                     against n(n+1)/2 resp. n^2 products per coordinate;
//                     at n = 20 that is 5-10 f32 operations per byte, below
//                     the card's 20 operations per byte.
//   weighted_row_sum  bytes: the rows with a non-zero weight, read once.
//   select_row        bytes: one row read, one written.
//
// Design:
//   gram, cross_gram  one template.  The coordinate axis is dealt into
//                     sub-slices of gram_sub_coords(n) = 32 * ceil8(n)
//                     coordinates, runs of 16 dealt round-robin, the same
//                     cut for both entry points (so that the blocks of a
//                     wave read neighbouring runs of every row).  A
//                     thread owns a 4 x 4 tile of entries of one sub-slice
//                     and adds its products coordinate by coordinate, in
//                     coordinate order (one fused multiply-add each), from
//                     operands staged in shared memory 16 coordinates at a
//                     time; it writes the tile's sums into
//                     partial[entry][sub-slice].  A second launch sums each
//                     entry's partials in a fixed tree (256 strided threads,
//                     warp shuffles, the warps in order).  So every entry is
//                     summed over the coordinates in an order that depends on
//                     the coordinate index alone, never on (i, j) or on the
//                     other rows, and fma(x_ik, x_jk, g) == fma(x_jk, x_ik, g):
//                     the Gram is
//                     symmetric bit for bit, and cross_gram(x, x) == gram(x)
//                     bit for bit, which the streaming server's incremental
//                     Gram needs.  No atomics: runs repeat bit for bit.  The
//                     Gram computes the tiles on and above the diagonal and
//                     mirrors them.  Small n leave tiles for few threads, so a
//                     block runs `group` sub-slices side by side (that only
//                     maps work to threads and does not change any sum).
//   weighted_row_sum  one thread per coordinate walks the rows in order; a row
//                     whose weight is 0 is not read and adds exactly 0 (an inf
//                     in an unselected row cannot turn into NaN).  The weights
//                     are read from device memory.
//   select_row        eight coordinates per thread; the row index (clamped to
//                     [0, n-1]) and the scale are read from device memory, so
//                     the host never waits for the selection; scale 0 gives 0.
// Built with --fmad=false: the row-sum and select multiply and add as their
// plain PyTorch versions do (the row-sum matches its plain version bit for
// bit); the Gram kernels fuse on purpose (__fmaf_rn), which the exactness
// above does not need to forbid, and agree with their plain version to the
// rounding of their sums.
#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kGramThreads = 256;
constexpr int kTile = 4;          // a thread's tile: kTile x kTile entries
constexpr int kStep = 16;         // coordinates staged in shared memory at once
constexpr int kGramMaxN = 128;    // the tiles of n <= 128 fit 4 per thread
constexpr int kMaxGroup = 32;     // sub-slices a block runs side by side (<= 48 KB)
constexpr int kSumThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kSelectPerThread = 8;  // select_row: columns a thread copies

__host__ __device__ inline int gram_pad_rows(int n) { return (n + kTile - 1) / kTile * kTile; }
// coordinates of one sub-slice: the partial sums are about 1/32 of the input
__host__ __device__ inline int gram_sub_coords(int n) { return 32 * ((n + 7) / 8 * 8); }
__host__ __device__ inline int gram_tiles(int n, int sym) {
  const int t = gram_pad_rows(n) / kTile;
  return sym ? t * (t + 1) / 2 : t * t;
}
inline int gram_group(int tiles) {
  const int g = tiles <= kGramThreads ? kGramThreads / tiles : 1;
  return g < kMaxGroup ? g : kMaxGroup;
}
// floats of one staged operand of one sub-slice (padded: float4 aligned, and
// consecutive sub-slices start on other banks)
__host__ __device__ inline int gram_pstride(int n) { return kStep * gram_pad_rows(n) + 4; }

__device__ __forceinline__ float krum_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the total in lane 0
}

// tile t -> (I, J): row-major over all tiles, or over those with I <= J
__device__ inline void tile_coords(int t, int nt, int sym, int& ti, int& tj) {
  if (!sym) {
    ti = t / nt;
    tj = t % nt;
    return;
  }
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// partial[(i * n + j) * slices + s] = sum over the coordinates k of sub-slice
// s, in order, of a[i, k] * b[j, k]; for sym (b == a) only entries i <= j.
// Sub-slice s of `slices` holds the gram_sub_coords(n) coordinates
// (t * slices + s) * kStep + kk, t = 0, 1, ..., kk < kStep.
template <typename T, int TPT>
__global__ void __launch_bounds__(kGramThreads)
gram_slices_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ partial,
                   int n, int64_t d, int slices, int sub, int group, int sym) {
  extern __shared__ __align__(16) float smem[];
  const int npad = gram_pad_rows(n);
  const int pstride = gram_pstride(n);
  float* sa = smem;
  float* sb = sym ? smem : smem + group * pstride;
  const int nt = npad / kTile;
  const int tiles = gram_tiles(n, sym);
  const int tid = threadIdx.x;
  // this thread's sub-slice p of the block and its first tile
  const int p = TPT == 1 ? tid / tiles : 0;
  const int first = TPT == 1 ? tid % tiles : tid;
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * group + p;
  const bool active = p < group && slice < slices;
  int ti[TPT], tj[TPT];
  bool has[TPT];
#pragma unroll
  for (int q = 0; q < TPT; ++q) {
    const int t = first + q * kGramThreads;
    has[q] = active && t < tiles;
    ti[q] = tj[q] = 0;
    if (has[q]) tile_coords(t, nt, sym, ti[q], tj[q]);
  }
  float acc[TPT][kTile][kTile];
#pragma unroll
  for (int q = 0; q < TPT; ++q)
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[q][r][c] = 0.f;

  // Sub-slice s holds the coordinates (t * slices + s) * kStep + kk for its
  // steps t and kk < kStep, in that order: at every step the block's `group`
  // sub-slices are one contiguous run of width = group * kStep coordinates
  // of each row, and the blocks of a wave read neighbouring runs.  Thread
  // tid stages the values e = tid + m * kGramThreads of a step, e = (row,
  // column c of the run); offsets advance by additions.
  const int width = group * kStep;
  const int per = npad * width;
  const int c0 = tid % width;
  const int i0 = tid / width;
  const int64_t first_col = static_cast<int64_t>(blockIdx.x) * width;
  const int64_t step_cols = static_cast<int64_t>(slices) * kStep;
  for (int k0 = 0; k0 < sub; k0 += kStep) {
    // stage [sub-slice][coordinate][row]; padded rows and coordinates past d are 0
    const int64_t run = (k0 / kStep) * step_cols + first_col;
    int c = c0, i = i0;
    int64_t row_off = static_cast<int64_t>(i0) * d;
    for (int e = tid; e < per; e += kGramThreads) {
      const int q = c / kStep;
      const int kk = c % kStep;
      const int64_t k = run + c;
      float va = 0.f, vb = 0.f;
      if (i < n && static_cast<int64_t>(blockIdx.x) * group + q < slices && k < d) {
        va = to_f32(a[row_off + k]);
        if (!sym) vb = to_f32(b[row_off + k]);
      }
      const int sidx = q * pstride + kk * npad + i;
      sa[sidx] = va;
      if (!sym) sb[sidx] = vb;
      c += kGramThreads;
      while (c >= width) {  // on to the next row
        c -= width;
        ++i;
        row_off += d;
      }
    }
    __syncthreads();
    if (active) {
      const float* pa = sa + p * pstride;
      const float* pb = sb + p * pstride;
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
#pragma unroll
        for (int q = 0; q < TPT; ++q) {
          if (!has[q]) continue;
          const float4 av = *reinterpret_cast<const float4*>(pa + kk * npad + kTile * ti[q]);
          const float4 bv = *reinterpret_cast<const float4*>(pb + kk * npad + kTile * tj[q]);
          const float ar[kTile] = {av.x, av.y, av.z, av.w};
          const float br[kTile] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < kTile; ++r)
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[q][r][c] = __fmaf_rn(ar[r], br[c], acc[q][r][c]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int q = 0; q < TPT; ++q) {
    if (!has[q]) continue;
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int i = kTile * ti[q] + r;
        const int j = kTile * tj[q] + c;
        if (i < n && j < n && (!sym || i <= j))
          partial[static_cast<int64_t>(i * n + j) * slices + slice] = acc[q][r][c];
      }
    }
  }
}

// out[i, j] = the sum of entry (i, j)'s partials in a fixed tree; for sym the
// blocks of i <= j write both (i, j) and (j, i).
__global__ void __launch_bounds__(kSumThreads)
gram_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int n, int slices,
                int sym) {
  __shared__ float red[kSumThreads / 32];
  const int i = blockIdx.x / n;
  const int j = blockIdx.x % n;
  if (sym && i > j) return;  // the whole block
  const float* src = partial + static_cast<int64_t>(blockIdx.x) * slices;
  float acc = 0.f;
  for (int s = threadIdx.x; s < slices; s += kSumThreads) acc += src[s];
  acc = krum_warp_sum(acc);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < kSumThreads / 32; ++w) total += red[w];
    out[i * n + j] = total;
    if (sym) out[j * n + i] = total;
  }
}

template <typename T, int TPT>
cudaError_t launch_gram(const void* a, const void* b, float* partial, float* out, int n,
                        long long d, int slices, int sym, cudaStream_t st) {
  const int sub = gram_sub_coords(n);
  const int group = gram_group(gram_tiles(n, sym));
  const unsigned blocks = static_cast<unsigned>((slices + group - 1) / group);
  const size_t smem = static_cast<size_t>(sym ? 1 : 2) * group * gram_pstride(n) * sizeof(float);
  gram_slices_kernel<T, TPT><<<blocks, kGramThreads, smem, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), partial, n, d, slices, sub, group, sym);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_sum_kernel<<<n * n, kSumThreads, 0, st>>>(partial, out, n, slices, sym);
  return cudaGetLastError();
}

// out[j] = sum over the rows i in order of (w[i] != 0 ? x[i, j] * w[i] : 0).
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_combine_kernel(const T* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
                   int n, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kRowThreads + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    const float wi = w[i];  // the same for every thread: no divergence
    acc += wi != 0.f ? to_f32(x[static_cast<int64_t>(i) * d + j]) * wi : 0.f;
  }
  out[j] = acc;
}

// out[j] = s != 0 ? x[r, j] * s : 0 with r = clamp(*row, 0, n - 1), s = *scale.
// A thread copies kSelectPerThread columns, kRowThreads apart, so that its
// loads are in flight together once the row index has arrived.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
select_row_kernel(const T* __restrict__ x, const int* __restrict__ row,
                  const float* __restrict__ scale, float* __restrict__ out, int n, int64_t d) {
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x) * kRowThreads * kSelectPerThread + threadIdx.x;
  int r = *row;
  r = r < 0 ? 0 : (r > n - 1 ? n - 1 : r);
  const float s = *scale;
  const T* xr = x + static_cast<int64_t>(r) * d;
#pragma unroll
  for (int k = 0; k < kSelectPerThread; ++k) {
    const int64_t j = j0 + k * kRowThreads;
    if (j < d) out[j] = s != 0.f ? to_f32(xr[j]) * s : 0.f;
  }
}

inline unsigned row_blocks(long long d, int per_thread = 1) {
  const long long cols = static_cast<long long>(kRowThreads) * per_thread;
  return static_cast<unsigned>((d + cols - 1) / cols);
}

}  // namespace repro

// a, b: (n, d) row-major, dtype 0 = f32, 1 = bf16; sym = 1 computes the Gram of
// a (b must be a); partial: (n * n, slices) f32 scratch with slices =
// ceil(d / gram_sub_coords(n)), which the launch checks; out: (n, n) f32.
extern "C" int krum_gram_launch(const void* a, const void* b, void* partial, void* out, int dtype,
                                int n, long long d, int slices, int sym, void* stream) {
  if (n < 1 || n > repro::kGramMaxN || d < 1 || (sym && a != b) ||
      static_cast<long long>(slices) !=
          (d + repro::gram_sub_coords(n) - 1) / repro::gram_sub_coords(n))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* p = static_cast<float*>(partial);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = repro::gram_tiles(n, sym) > repro::kGramThreads;
  if (dtype == 0)
    return static_cast<int>(
        wide ? repro::launch_gram<float, 4>(a, b, p, o, n, d, slices, sym, st)
             : repro::launch_gram<float, 1>(a, b, p, o, n, d, slices, sym, st));
  if (dtype == 1)
    return static_cast<int>(
        wide ? repro::launch_gram<__nv_bfloat16, 4>(a, b, p, o, n, d, slices, sym, st)
             : repro::launch_gram<__nv_bfloat16, 1>(a, b, p, o, n, d, slices, sym, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// x: (n, d); w: (n,) f32 on the device; out: (d,) f32.
extern "C" int weighted_row_sum_launch(const void* x, const void* w, void* out, int dtype, int n,
                                       long long d, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wt = static_cast<const float*>(w);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = repro::row_blocks(d);
  if (dtype == 0) {
    repro::row_combine_kernel<float><<<blocks, repro::kRowThreads, 0, st>>>(
        static_cast<const float*>(x), wt, o, n, d);
  } else if (dtype == 1) {
    repro::row_combine_kernel<__nv_bfloat16><<<blocks, repro::kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), wt, o, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: (n, d); row: a device int32; scale: a device f32; out: (d,) f32.
extern "C" int select_row_launch(const void* x, const void* row, const void* scale, void* out,
                                 int dtype, int n, long long d, void* stream) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* r = static_cast<const int*>(row);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned blocks = repro::row_blocks(d, repro::kSelectPerThread);
  if (dtype == 0) {
    repro::select_row_kernel<float><<<blocks, repro::kRowThreads, 0, st>>>(
        static_cast<const float*>(x), r, s, o, n, d);
  } else if (dtype == 1) {
    repro::select_row_kernel<__nv_bfloat16><<<blocks, repro::kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), r, s, o, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
