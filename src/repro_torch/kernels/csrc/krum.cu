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
//                     the card's 20 operations per byte.  At the serve shape
//                     (n = 16, d = 4,096) the launch itself.
//   weighted_row_sum  bytes: the rows with a non-zero weight, read once.
//   select_row        bytes: one row read, one written.
//
// Design of the Gram template (gram and cross_gram, one kernel):
//   The cut.  The coordinate axis is dealt into sub-slices of
//     gram_sub_coords(n, d) coordinates: runs of kRun = 16 coordinates dealt
//     round-robin, so that sub-slice s of `slices` holds the coordinates
//     (t * slices + s) * kRun + kk, t = 0, 1, ..., kk < kRun.  At most
//     32 * ceil8(n) coordinates (the partial sums stay within 1/32 of the
//     input; 768 at n = 20), and fewer when d is small, so that about
//     kTargetSlices sub-slices spread over the card (at the serve shape 256
//     sub-slices of one run, where the cut of n alone made 8).  The cut
//     depends on (n, d) alone, the same for both entry points.
//   The sums.  A thread owns a 4 x 4 tile of entries of one sub-slice and
//     adds its products coordinate by coordinate, in coordinate order, one
//     __fmaf_rn each; it writes the tile's sums into
//     partial[entry][sub-slice], and a second launch sums each entry's
//     partials in a fixed tree (256 strided threads, warp shuffles, the warps
//     in order).  So every entry is summed in an order fixed by (n, d),
//     never by (i, j) or by the other rows, and fma(a, b, g) == fma(b, a, g):
//     the Gram is symmetric bit for bit and cross_gram(x, x) == gram(x) bit
//     for bit, which the streaming server's incremental Gram needs.  No
//     atomics: runs repeat bit for bit.  The Gram computes the tiles on and
//     above the diagonal and mirrors them.  The multiply-adds stay f32 on the
//     CUDA cores: wgmma on f32 operands rounds them to TF32.
//   The copies.  A block runs `group` sub-slices side by side (this only
//     maps work to threads and changes no sum), so at every step its
//     sub-slices are one contiguous span of group * kRun coordinates of each
//     row.  The spans go into a ring of kStages = 3 shared-memory stages by
//     cp.async, which bypasses registers: the copy of step t + 2 is issued
//     before the multiply-adds of step t, one barrier a step.  Every warp
//     copies whole rows, its lanes on consecutive 4-byte units of the span,
//     so a unit costs the copy and two additions; only a step that reaches
//     past d or past the step's sub-slices checks each unit's coordinates.
//     (Two or four warps that only copy, with 4- or 16-byte copies, were
//     slower on the H100: a warp keeps only a few KB of copies in flight, so
//     the copies need all 8 warps.)
//   Alignment.  The rows do not start on 16-byte boundaries (row r starts
//     r*d values in; a 2-D tensor map cannot describe them either), and a
//     16-byte copy would land a row 1-3 values off a 16-byte word in shared
//     memory.  4-byte copies land every f32 row's span on a word, so the tile
//     reads 4 coordinates of a row as one float4 (8 float4 loads feed 64
//     multiply-adds).  A bf16 row that starts on an odd value lands one value
//     late (its units start on the 4-byte boundary below), and the tile reads
//     it value by value.  A unit's values at coordinates past d, or past the
//     step's sub-slices, are zero-filled by the copy (its source size), never
//     read: nothing is read past the end of the operand, and only the 2 bytes
//     below an odd bf16 row's start are read before it, inside the same
//     4-byte word.  Rows are padded to a multiple of 4 with zero rows;
//     shared-memory rows are an odd number of 16-byte words apart plus one
//     word every 4 rows, so the float4 loads of a warp's tiles spread over
//     the banks.
//   The second pass.  gram_sum_kernel, unchanged.
// weighted_row_sum: one thread per coordinate walks the rows in order; a row
//   whose weight is 0 is not read and adds exactly 0 (an inf in an unselected
//   row cannot turn into NaN).  The weights are read from device memory.
// select_row: eight coordinates per thread; the row index (clamped to
//   [0, n-1]) and the scale are read from device memory, so the host never
//   waits for the selection; scale 0 gives 0.
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
constexpr int kRun = 16;          // coordinates of one run, dealt round-robin to the sub-slices
constexpr int kStages = 3;        // the shared-memory ring: copies run two steps ahead
constexpr int kGramMaxN = 128;    // the tiles of n <= 128 fit 4 per thread
constexpr int kMaxGroup = 16;     // sub-slices a block runs side by side: spans <= 256 values
constexpr long long kTargetSlices = 1024;  // sub-slices of a small d
constexpr int kSpreadBlocks = 264;         // blocks wanted for a small d: 2 on each of 132 SMs
constexpr int kSumThreads = 256;
constexpr int kRowThreads = 256;
constexpr int kSelectPerThread = 8;  // select_row: columns a thread copies

__host__ __device__ inline int gram_pad_rows(int n) { return (n + kTile - 1) / kTile * kTile; }
// coordinates of one sub-slice at (n, d) (the design note; kernels/krum.py
// mirrors it): a whole number of runs, at least one, at most 32 * ceil8(n)
__host__ __device__ inline long long gram_sub_coords(int n, long long d) {
  const long long cap = 32LL * ((n + 7) / 8 * 8);
  const long long want = kRun * ((d + kRun * kTargetSlices - 1) / (kRun * kTargetSlices));
  return want < cap ? want : cap;
}
__host__ __device__ inline int gram_tiles(int n, int sym) {
  const int t = gram_pad_rows(n) / kTile;
  return sym ? t * (t + 1) / 2 : t * t;
}
// 4-byte copy units of one row's span of group * kRun values
__host__ __device__ inline int gram_units(int group, int size) { return group * kRun * size / 4; }
// bytes between two shared-memory rows: the span (and for bf16 the unit of a
// row that lands one value late), rounded to 32 bytes, plus 16: an odd number
// of 16-byte words
__host__ __device__ inline int gram_pitch(int group, int size) {
  const int units = gram_units(group, size) + (size == 2 ? 1 : 0);
  return (4 * units + 31) / 32 * 32 + 16;
}
// byte offset of row i in one operand's stage: one more word every 4 rows
__host__ __device__ inline int gram_row_off(int i, int pitch) { return i * pitch + (i >> 2) * 16; }
// bytes of one operand's stage
__host__ __device__ inline int gram_region(int n, int group, int size) {
  const int npad = gram_pad_rows(n);
  return gram_row_off(npad, gram_pitch(group, size));
}

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

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  // copies `bytes` (0-4) and zero-fills the rest of the 4
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// values by which a row's data lands late in its shared-memory row: its
// units start on the 4-byte boundary at or below it (0 for f32; every span
// starts a multiple of 32 bytes past the row's start)
template <typename T>
__device__ __forceinline__ int gram_shift(const T* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3u) / static_cast<int>(sizeof(T));
}

// copy a row's span into shared memory, lane by lane on consecutive 4-byte
// units from the 4-byte boundary at or below `at`, the row's value at
// coordinate k0; with `whole` every unit lies below `limit`, else a unit's
// values at coordinates >= limit are zero-filled and not read
template <typename T>
__device__ __forceinline__ void gram_copy_row(uint32_t to, const T* at, const T* safe, int lane,
                                              int nunits, bool whole, int64_t k0, int64_t limit) {
  constexpr int kSz = sizeof(T);
  const auto* from = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(at) & ~uintptr_t{3});
  if (whole) {
    for (int u = lane; u < nunits; u += 32) cp_async4(to + 4 * u, from + 4 * u, 4);
    return;
  }
  const int64_t c0 = k0 - gram_shift(at);  // the coordinate of the first unit's first value
  for (int u = lane; u < nunits; u += 32) {
    const int64_t left = (limit - (c0 + u * (4 / kSz))) * kSz;
    const int bytes = left <= 0 ? 0 : (left < 4 ? static_cast<int>(left) : 4);
    cp_async4(to + 4 * u, bytes ? static_cast<const void*>(from + 4 * u) : safe, bytes);
  }
}

// 4 consecutive coordinates of one row in shared memory, as f32
template <typename T>
__device__ __forceinline__ void gram_load4(const unsigned char* p, float v[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    const T* q = reinterpret_cast<const T*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = to_f32(q[k]);
  }
}

// partial[(i * n + j) * slices + s] = sum over the coordinates k of sub-slice
// s, in order, of a[i, k] * b[j, k]; for sym (b == a) only entries i <= j.
// `steps` = gram_sub_coords(n, d) / kRun runs a sub-slice.
template <typename T, int TPT>
__global__ void __launch_bounds__(kGramThreads, TPT == 1 ? 2 : 1)
gram_slices_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ partial,
                   int n, int64_t d, int slices, int steps, int group, int sym) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kSz = sizeof(T);
  const int tid = threadIdx.x;
  const int npad = gram_pad_rows(n);
  const int nt = npad / kTile;
  const int tiles = gram_tiles(n, sym);
  const int ops = sym ? 1 : 2;
  const int pitch = gram_pitch(group, kSz);
  const int region = gram_region(n, group, kSz);

  // the padded rows of every stage are zero; no copy writes them
  const int words = pitch / 16, pad = npad - n;
  for (int e = tid; e < kStages * ops * pad * words; e += kGramThreads) {
    const int rest = e / words;
    *reinterpret_cast<uint4*>(smem + rest / pad * region + gram_row_off(n + rest % pad, pitch) +
                              16 * (e % words)) = make_uint4(0u, 0u, 0u, 0u);
  }

  // the copies: warp w copies the rows w, w + 8, ... of the operands, its
  // lanes on consecutive units of the row's span
  const int warp = tid >> 5, lane = tid & 31;
  const int width = group * kRun;
  const int nunits = gram_units(group, kSz) + (kSz == 2 ? 1 : 0);
  const int64_t step_cols = static_cast<int64_t>(slices) * kRun;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * group * kRun;
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  auto issue = [&](int t) {  // step t's spans into stage t % kStages
    const int64_t k0 = t * step_cols + first;
    const int64_t end = (t + 1) * step_cols;  // the step's last sub-slice ends here
    const int64_t limit = end < d ? end : d;
    // the units of a row reach coordinate k0 + width - 1 (f32) or k0 + width + 1
    const bool whole = k0 + width + (kSz == 2 ? 2 : 0) <= limit;
    const uint32_t stage = ring + (t % kStages) * ops * region;
    for (int q = warp; q < ops * n; q += kGramThreads / 32) {
      const int o = q >= n, i = q - o * n;
      gram_copy_row(stage + o * region + gram_row_off(i, pitch), (o ? b : a) + i * d + k0, a, lane,
                    nunits, whole, k0, limit);
    }
  };

  // the sums: this thread's sub-slice p of the block and its tiles
  const int p = TPT == 1 ? tid / tiles : 0;
  const int first_tile = TPT == 1 ? tid % tiles : tid;
  const int64_t slice = static_cast<int64_t>(blockIdx.x) * group + p;
  const bool active = p < group && slice < slices;
  int ti[TPT], tj[TPT];
  int base_a[TPT], base_b[TPT];  // bytes into a stage of row 4 ti (4 tj) at the sub-slice
  int late[TPT];                 // bf16: bit r (r + 4) set when row 4 ti + r (4 tj + r) lands late
  bool has[TPT];
#pragma unroll
  for (int q = 0; q < TPT; ++q) {
    const int t = first_tile + q * kGramThreads;
    has[q] = active && t < tiles;
    ti[q] = tj[q] = 0;
    if (has[q]) tile_coords(t, nt, sym, ti[q], tj[q]);
    base_a[q] = gram_row_off(kTile * ti[q], pitch) + p * kRun * kSz;
    base_b[q] = (sym ? 0 : region) + gram_row_off(kTile * tj[q], pitch) + p * kRun * kSz;
    late[q] = 0;
    if (kSz == 2) {
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        const int i = kTile * ti[q] + r, j = kTile * tj[q] + r;
        if (i < n) late[q] |= gram_shift(a + i * d) << r;
        if (j < n) late[q] |= gram_shift(b + j * d) << (r + kTile);
      }
    }
  }
  float acc[TPT][kTile][kTile];
#pragma unroll
  for (int q = 0; q < TPT; ++q)
#pragma unroll
    for (int r = 0; r < kTile; ++r)
#pragma unroll
      for (int c = 0; c < kTile; ++c) acc[q][r][c] = 0.f;

  for (int t = 0; t < kStages - 1; ++t) {
    if (t < steps) issue(t);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of step t have landed
    __syncthreads();               // everyone's, and step t - 1's stage is free
    if (t + kStages - 1 < steps) issue(t + kStages - 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* stage = smem + (t % kStages) * ops * region;
#pragma unroll
    for (int q = 0; q < TPT; ++q) {
      if (!has[q]) continue;
      const unsigned char* pa = stage + base_a[q];
      const unsigned char* pb = stage + base_b[q];
#pragma unroll
      for (int u = 0; u < kRun; u += 4) {
        float av[kTile][4], bv[kTile][4];
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          gram_load4<T>(pa + r * pitch + (((late[q] >> r) & 1) + u) * kSz, av[r]);
          gram_load4<T>(pb + r * pitch + (((late[q] >> (r + kTile)) & 1) + u) * kSz, bv[r]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int r = 0; r < kTile; ++r)
#pragma unroll
            for (int c = 0; c < kTile; ++c)
              acc[q][r][c] = __fmaf_rn(av[r][k], bv[c][k], acc[q][r][c]);
      }
    }
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

// sub-slices a block runs side by side: as many as its threads have tiles
// for (at most kMaxGroup), and fewer when the sub-slices are few, so that a
// small d still spreads over the card.  Maps work to threads only: no sum
// depends on it.
inline int gram_group(int tiles, int slices) {
  int g = kGramThreads / tiles;
  g = g < kMaxGroup ? g : kMaxGroup;
  const int spread = slices / kSpreadBlocks;
  g = g < spread ? g : spread;
  return g > 1 ? g : 1;
}

template <typename T, int TPT>
cudaError_t launch_gram(const void* a, const void* b, float* partial, float* out, int n,
                        long long d, int slices, int sym, cudaStream_t st) {
  const int steps = static_cast<int>(gram_sub_coords(n, d) / kRun);
  const int group = gram_group(gram_tiles(n, sym), slices);
  const unsigned blocks = static_cast<unsigned>((slices + group - 1) / group);
  const int smem = kStages * (sym ? 1 : 2) * gram_region(n, group, sizeof(T));
  auto kernel = gram_slices_kernel<T, TPT>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kGramThreads, smem, st>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                             partial, n, d, slices, steps, group, sym);
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
// ceil(d / gram_sub_coords(n, d)), which the launch checks; out: (n, n) f32.
extern "C" int krum_gram_launch(const void* a, const void* b, void* partial, void* out, int dtype,
                                int n, long long d, int slices, int sym, void* stream) {
  if (n < 1 || n > repro::kGramMaxN || d < 1 || (sym && a != b) ||
      static_cast<long long>(slices) !=
          (d + repro::gram_sub_coords(n, d) - 1) / repro::gram_sub_coords(n, d))
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
