// Shared device code of the order-statistic kernels: the fused
// clip -> Bucketing -> CM/TM pass and the standalone masked CM/TM (s = 1,
// rows in order, no clip factors) are one template behind one C entry
// point (clip_aggregate.cu).
//
// Replaces the TPU kernels _clip_agg_kernel / _clip_bucket_agg_kernel
// (src/repro/kernels/clip_aggregate.py) and _cm_kernel / _tm_kernel
// (src/repro/kernels/coordinate_median.py), which share _select_masked.
//
// Bound on the H100: bytes.  The function reads the rows it needs (at
// s = 1 only the rows the mask keeps; at s >= 2 every row of a bucket with
// a kept row, since a masked inf or NaN there still makes the mean NaN)
// and writes d*4 bytes.  The sort is integer min/max at half the f32 rate,
// so a network over every slot (a bitonic network over 32 slots runs 480
// min/max a coordinate at n = 20) outlasts the loads: the design cuts the
// network and the per-slot work until the loads set the time, at every
// mask.
//
// Design, one thread per coordinate (a warp reads 32 neighbouring columns
// of a row, coalesced):
// - Each block first stages its slots in shared memory, once: the row
//   offset (row * d), the clip factor and the mask weight of each slot, 16
//   bytes, so that a thread reads a slot with one load.  At s = 1 the block
//   packs the kept rows in slot order (a ballot and a count a warp) and the
//   count cnt beside them: a thread loads cnt rows and puts 3.4e37 in the
//   other slots without a load.  At s >= 2 each bucket gets its count c of
//   kept rows, and a bucket with no kept row is not read.  A block then
//   takes kSelectTiles column tiles, so the staging is paid once for them.
// - All of a thread's row loads are issued before the first is used
//   (loads, then keys), for the widths whose values fit in registers.
// - No divide where a multiply is exact: at s = 1 a kept value is x * f
//   (the mean of one row, which the divide by 1 left as it was); at s >= 2
//   a bucket whose max(c, 1) is a power of two (c = 1 or 2 with 0/1 masks)
//   multiplies by its inverse, which is the correctly rounded value of the
//   same real number as the quotient, subnormals included.  Other counts
//   (fractional weights) keep the IEEE divide.
// - Where (nb, s) is one of REPRO_EXACT_WIDTHS the keys go through a
//   network of exactly nb wires (select_networks.cuh): Batcher's odd-even
//   merge sort with every comparator ascending, those touching a wire past
//   nb dropped at compile time; for the median also those that cannot
//   reach wires 0..nb/2, the only ones it reads (at nb = 20, 175 min/max).
//   Other nb run the bitonic network of the least NB_CAPS width >= nb, its
//   slots past nb holding INT_MAX.
// - The median at s = 1 of an exact width goes further: cnt is the same in
//   every block of a launch, so the kernel holds one code path for each
//   count 0..nb (a chain of block-uniform tests picks it) and sorts only
//   the cnt kept keys with a network that reaches just the two wires the
//   median reads (MedianNetwork<C>: 66 min/max for 13 kept rows, 8 for 4).
//   The nb - cnt empty slots' 3.4e37 would sort above both wires, unless a
//   kept key lies above 3.4e37 (+inf, a NaN): then that coordinate takes
//   the nb-wire network with the empty slots, so the semantics below hold.
//   With few kept rows a thread loads up to four tiles together, so that
//   it still has about 12 or more loads in flight.
// - The median reads positions (cnt-1)/2 and cnt/2: off two fixed wires
//   on the per-count path, off wires 0..nb/2 only on the others.
//
// Semantics kept from the TPU kernel: the values _select_masked picks by
// unique rank are the sorted values at those positions.  Empty buckets
// (and masked rows when s = 1) hold +3.4e37, not +inf, so that 3.4e37 * 0
// stays 0, as in the reference.  The networks sort order-preserving int32
// keys of the values, not the floats: fminf/fmaxf would drop a NaN (a
// Byzantine worker can send one) and duplicate another value in its
// place.  Under the keys every NaN sorts after +inf (and after 3.4e37), as
// torch.sort and jnp.sort order it, -0 before +0, and a selected NaN comes
// out as NaN.
#pragma once

#include <stdint.h>

#include "common.cuh"
#include "select_networks.cuh"

namespace repro {

constexpr float kBig = 3.4e37f;
constexpr int kSelectThreads = 256;
constexpr int kSelectTiles = 4;  // column tiles a block takes
constexpr int kKeyLast = 0x7fffffff;  // sorts after every float's key
constexpr int kRegSlots = 32;  // at most this many values a thread loads up front

// a < b as floats iff sort_key(a) < sort_key(b) as ints; -0 < +0, and
// every NaN maps to the key of the positive quiet NaN, above +inf.
__device__ __forceinline__ int sort_key(float v) {
  const int b = isnan(v) ? 0x7fc00000 : __float_as_int(v);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
}

// Ascending bitonic sort of a register array (NB a power of two).
template <int NB>
__device__ __forceinline__ void bitonic_sort(int (&v)[NB]) {
#pragma unroll
  for (int k = 2; k <= NB; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const int a = v[i], b = v[l];
          const bool up = (i & k) == 0;
          v[i] = up ? min(a, b) : max(a, b);
          v[l] = up ? max(a, b) : min(a, b);
        }
      }
    }
  }
}

// The numpy median of cnt sorted keys: the mean of positions (cnt-1)//2
// and cnt//2 (cnt = 0 reads position 0, +3.4e37, the jnp reference's
// answer).  Both are < LIVE, the wires the network sorted.
template <int N, int LIVE>
__device__ __forceinline__ float median_sorted(const int (&v)[N], int cnt) {
  const int lo = max((cnt - 1) >> 1, 0);  // floor division, also for cnt = 0
  const int hi = cnt >> 1;
  int a = v[0], b = v[0];
#pragma unroll
  for (int k = 1; k < LIVE; ++k) {
    if (k == lo) a = v[k];
    if (k == hi) b = v[k];
  }
  return 0.5f * (key_value(a) + key_value(b));
}

// The trimmed mean of cnt sorted keys: t = min(ceil(r*cnt), (cnt-1)//2)
// values dropped at each end, the rest summed in ascending order.
template <int N>
__device__ __forceinline__ float trimmed_sorted(const int (&v)[N], int cnt, float trim_ratio) {
  const int half_lo = (cnt - 1) >> 1;
  const int t = min(static_cast<int>(ceilf(trim_ratio * static_cast<float>(cnt))), half_lo);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= t && k < cnt - t) acc += key_value(v[k]);
  }
  return acc / static_cast<float>(max(cnt - 2 * t, 1));
}

// One row slot: its row's offset (row * d; -1 for an empty slot), clip
// factor and mask weight, read by a thread as one 16-byte load.
struct alignas(16) Slot {
  long long off;
  float f;
  float m;
};

// One bucket (s >= 2): mode 0 holds no kept row (3.4e37); mode 1 takes
// its mean as acc * scale, scale = 1 / max(c, 1) exactly (a power of two);
// mode 2 as acc / scale, scale = max(c, 1).
struct alignas(8) Bucket {
  float scale;
  int mode;
};

// Slot j: row idx[j] (row j when idx is null) for j < idx_slots; an index
// outside [0, n), or j >= idx_slots, is an empty slot (mask 0, never read).
__device__ __forceinline__ Slot slot_of(int j, const float* factor, const float* mask,
                                        const int* idx, int n, int idx_slots, int64_t d) {
  Slot e{-1, 1.f, 0.f};
  if (j < idx_slots) {
    const int r = idx != nullptr ? idx[j] : j;
    if (r >= 0 && r < n) {
      e.off = static_cast<long long>(r) * d;
      e.f = factor != nullptr ? factor[r] : 1.f;
      e.m = mask[r];
    }
  }
  return e;
}

// Stages the block's slots (and buckets) in shared memory and returns cnt,
// the number of values the selection counts: kept rows (S = 1, packed at
// the front of s_slot in slot order) or buckets with a kept row.  Every
// thread of the block calls it; it ends with a barrier.  At S = 1 the
// caller guarantees n_p <= kSelectThreads; at S != 1, nb <= kSelectThreads.
// *any_div: whether a kept bucket needs the divide (mode 2).
template <int S>
__device__ __forceinline__ int stage_slots(const float* factor, const float* mask,
                                           const int* idx, int n, int n_p, int idx_slots,
                                           int64_t d, int s, int nb, Slot* s_slot,
                                           Bucket* s_bucket, int* s_warp, bool* any_div) {
  const int tid = threadIdx.x;
  if constexpr (S == 1) {
    Slot e{-1, 1.f, 0.f};
    if (tid < n_p) e = slot_of(tid, factor, mask, idx, n, idx_slots, d);
    const bool keep = e.off >= 0 && e.m > 0.5f;
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    const int lane = tid & 31, warp = tid >> 5;
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int rank = __popc(ballot & ((1u << lane) - 1u)), cnt = 0;
#pragma unroll
    for (int w = 0; w < kSelectThreads / 32; ++w) {
      const int c = s_warp[w];
      rank += w < warp ? c : 0;
      cnt += c;
    }
    if (keep) s_slot[rank] = e;
    __syncthreads();
    *any_div = false;
    return cnt;
  }
  for (int j = tid; j < n_p; j += kSelectThreads)
    s_slot[j] = slot_of(j, factor, mask, idx, n, idx_slots, d);
  __syncthreads();
  bool ok = false, div = false;
  if (tid < nb) {
    float c = 0.f;  // summed in slot order, as the plain version does
    for (int t = 0; t < s; ++t) c += s_slot[tid * s + t].m;
    const float cc = fmaxf(c, 1.f);
    ok = c > 0.5f;
    div = ok && (__float_as_uint(cc) & 0x007fffffu) != 0u;
    s_bucket[tid] = !ok ? Bucket{0.f, 0} : (div ? Bucket{cc, 2} : Bucket{1.f / cc, 1});
  }
  *any_div = __syncthreads_or(div) != 0;
  return __syncthreads_count(ok);
}

// Keys of the kept rows (S = 1): slot k < cnt holds x[row_k, col] * f_k,
// the others 3.4e37 up to nb and INT_MAX past it (the generic width).
template <typename T, int NB, bool EXACT>
__device__ __forceinline__ void keys_of_rows(const T* x, const Slot* s_slot, int cnt, int nb,
                                             int64_t col, int (&v)[NB]) {
  const int big = sort_key(kBig);
  if constexpr (NB <= kRegSlots) {
    float xv[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {  // every load in flight before the first use
      xv[k] = 0.f;
      if (k < cnt) xv[k] = to_f32(x[s_slot[k].off + col]);
    }
#pragma unroll
    for (int k = 0; k < NB; ++k)
      v[k] = k < cnt ? sort_key(xv[k] * s_slot[k].f) : (EXACT || k < nb ? big : kKeyLast);
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      int key = EXACT || k < nb ? big : kKeyLast;
      if (k < cnt) {
        const Slot e = s_slot[k];
        key = sort_key(to_f32(x[e.off + col]) * e.f);
      }
      v[k] = key;
    }
  }
}

// The key of a bucket from acc, the sum of its slots' products (taken in
// slot order from 0, as the plain version does).  DIV: some bucket of the
// block needs the divide.
template <bool DIV>
__device__ __forceinline__ int bucket_key(float acc, Bucket bk) {
  if (bk.mode == 0) return sort_key(kBig);
  if (DIV && bk.mode == 2) return sort_key(acc / bk.scale);
  return sort_key(acc * bk.scale);
}

// Keys of the buckets (S != 1): bucket b < nb holds the mean of its slots'
// (x * f) * m, or 3.4e37 when no row of it is kept; INT_MAX past nb.  A
// bucket with no kept row reads nothing.
template <typename T, int NB, int S, bool EXACT, bool DIV>
__device__ __forceinline__ void keys_of_buckets(const T* x, const Slot* s_slot,
                                                const Bucket* s_bucket, int s, int nb,
                                                int64_t col, int (&v)[NB]) {
  if constexpr (S > 0 && NB * S <= kRegSlots) {
    float p[NB * S];
#pragma unroll
    for (int b = 0; b < NB; ++b) {  // every load in flight before the first use
#pragma unroll
      for (int t = 0; t < S; ++t) {
        p[b * S + t] = 0.f;
        if ((EXACT || b < nb) && s_bucket[b].mode != 0) {
          const long long off = s_slot[b * S + t].off;
          if (off >= 0) p[b * S + t] = to_f32(x[off + col]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int key = kKeyLast;
      if (EXACT || b < nb) {
        float acc = 0.f;
#pragma unroll
        for (int t = 0; t < S; ++t) {
          const Slot e = s_slot[b * S + t];
          acc += (p[b * S + t] * e.f) * e.m;
        }
        key = bucket_key<DIV>(acc, s_bucket[b]);
      }
      v[b] = key;
    }
  } else {
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      int key = kKeyLast;
      if (EXACT || b < nb) {
        const Bucket bk = s_bucket[b];
        float acc = 0.f;
        if (bk.mode != 0) {
#pragma unroll
          for (int t = 0; t < (S > 0 ? S : s); ++t) {
            const Slot e = s_slot[b * s + t];
            const float xv = e.off >= 0 ? to_f32(x[e.off + col]) : 0.f;
            acc += (xv * e.f) * e.m;
          }
        }
        key = bucket_key<DIV>(acc, bk);
      }
      v[b] = key;
    }
  }
}

// KIND: kGeneric runs the bitonic network over NB >= nb slots and reads
// trim_ratio at run time; kMedian / kTrimmed run the exact network of
// NB == nb wires (select_networks.cuh) for the median / trimmed mean.
enum SelectKind { kGeneric = 0, kMedian = 1, kTrimmed = 2 };

template <typename T, int NB, int S, int KIND>
__device__ __forceinline__ float select_one(const T* x, const Slot* s_slot,
                                            const Bucket* s_bucket, int cnt, bool any_div,
                                            int s, int nb, float trim_ratio, int64_t col) {
  constexpr bool kExact = KIND != kGeneric;
  int v[NB];
  if constexpr (S == 1) {
    keys_of_rows<T, NB, kExact>(x, s_slot, cnt, nb, col, v);
  } else if (any_div) {
    keys_of_buckets<T, NB, S, kExact, true>(x, s_slot, s_bucket, s, nb, col, v);
  } else {
    keys_of_buckets<T, NB, S, kExact, false>(x, s_slot, s_bucket, s, nb, col, v);
  }
  if constexpr (KIND == kMedian) {
    Network<NB, true>::apply(v);
    return median_sorted<NB, NB / 2 + 1>(v, cnt);
  } else if constexpr (KIND == kTrimmed) {
    Network<NB, false>::apply(v);
    return trimmed_sorted(v, cnt, trim_ratio);
  } else {
    bitonic_sort(v);
    return trim_ratio < 0.f ? median_sorted<NB, NB / 2 + 1>(v, cnt)
                            : trimmed_sorted(v, cnt, trim_ratio);
  }
}

// The exact-width median at s = 1 of one coordinate the slow way: all W
// slots (kBig in the W - cnt empty ones) through Network<W, true>.  Taken
// where a kept value sorts above 3.4e37 (+inf, a NaN, a value past it), so
// that the empty slots' 3.4e37 sit below it as in the plain version.
template <typename T, int W>
__device__ __noinline__ float median_rows_wide(const T* x, const Slot* s_slot, int cnt,
                                               int64_t col) {
  int v[W];
  keys_of_rows<T, W, true>(x, s_slot, cnt, W, col, v);
  Network<W, true>::apply(v);
  return median_sorted<W, W / 2 + 1>(v, cnt);
}

// The median at s = 1 of the block's tiles when C rows are kept (C fixed
// at compile time; the block's slots hold them packed).  The C keys go
// through MedianNetwork<C>, which sorts only wires (C-1)/2 and C/2, the
// positions the median reads: the W - C empty slots' 3.4e37 would sort
// above both unless a kept key lies above 3.4e37, and then the coordinate
// takes median_rows_wide.  kGroup tiles are loaded together so that a
// thread has at least about 12 loads in flight when few rows are kept.
template <typename T, int W, int C>
__device__ __forceinline__ void median_rows_tiles(const T* x, const Slot* s_slot,
                                                  float* out, int64_t first, int64_t d) {
  constexpr int kWant = C >= 12 ? 1 : (C >= 6 ? 2 : 4);
  constexpr int kGroup = kWant < kSelectTiles ? kWant : kSelectTiles;
  static_assert(kSelectTiles % kGroup == 0, "groups of whole tiles");
  const int big = sort_key(kBig);
#pragma unroll 1
  for (int t0 = 0; t0 < kSelectTiles; t0 += kGroup) {
    float xv[kGroup][C > 0 ? C : 1];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {  // every load in flight before the first use
      const int64_t col = first + static_cast<int64_t>(t0 + g) * kSelectThreads;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        xv[g][k] = 0.f;
        if (col < d) xv[g][k] = to_f32(x[s_slot[k].off + col]);
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int64_t col = first + static_cast<int64_t>(t0 + g) * kSelectThreads;
      if (col >= d) break;
      float r = kBig;  // no kept row: the median of the empty slots
      if constexpr (C > 0) {
        int v[C];
#pragma unroll
        for (int k = 0; k < C; ++k) v[k] = sort_key(xv[g][k] * s_slot[k].f);
        MedianNetwork<C>::apply(v);
        constexpr int lo = (C - 1) / 2, hi = C / 2;
        r = v[hi] <= big ? 0.5f * (key_value(v[lo]) + key_value(v[hi]))
                         : median_rows_wide<T, W>(x, s_slot, C, col);
      }
      out[col] = r;
    }
  }
}

// median_rows_tiles for the block's cnt: a chain of block-uniform tests,
// each count its own code (every block of a launch takes the same one).
template <typename T, int W, int C = 0>
__device__ __forceinline__ void median_rows(int cnt, const T* x, const Slot* s_slot,
                                            float* out, int64_t first, int64_t d) {
  if (cnt == C) {
    median_rows_tiles<T, W, C>(x, s_slot, out, first, d);
  } else if constexpr (C < W) {
    median_rows<T, W, C + 1>(cnt, x, s_slot, out, first, d);
  }
}

// out[c] = Select_{b < nb}( sum_{j < s} (x[row(b*s+j), c] * f) * m / max(cnt_b, 1) ).
// Slot j < idx_slots reads row idx[j] (row j when idx is null); slots
// idx_slots..n_p-1 and indices outside [0, n) are empty (mask 0, never
// read).  Pass 2 gives idx_slots = n (an (n,) row order, padding after
// it); bucketed CM gives n_p (a permutation of all n_p slots).  A null
// factor means 1.  S is s when the launch fixes it (1, 2, or the exact
// widths' s), else 0 and s is read at run time.  Dynamic shared memory:
// n_p Slots and nb Buckets.
template <typename T, int NB, int S, int KIND>
__global__ void __launch_bounds__(kSelectThreads)
clip_bucket_select_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                          const float* __restrict__ mask, const int* __restrict__ idx,
                          float* __restrict__ out, int n, int n_p, int idx_slots,
                          int64_t d, int s_rt, int nb, float trim_ratio) {
  const int s = S > 0 ? S : s_rt;
  extern __shared__ __align__(16) unsigned char smem[];
  Slot* s_slot = reinterpret_cast<Slot*>(smem);
  Bucket* s_bucket = reinterpret_cast<Bucket*>(s_slot + n_p);
  __shared__ int s_warp[kSelectThreads / 32];
  bool any_div;
  const int cnt = stage_slots<S>(factor, mask, idx, n, n_p, idx_slots, d, s, nb, s_slot,
                                 s_bucket, s_warp, &any_div);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kSelectTiles * kSelectThreads) +
                        threadIdx.x;
  if constexpr (S == 1 && KIND == kMedian) {
    median_rows<T, NB>(cnt, x, s_slot, out, first, d);
  } else {
#pragma unroll 1
    for (int tile = 0; tile < kSelectTiles; ++tile) {
      const int64_t col = first + static_cast<int64_t>(tile) * kSelectThreads;
      if (col >= d) break;
      out[col] = select_one<T, NB, S, KIND>(x, s_slot, s_bucket, cnt, any_div, s, nb,
                                            trim_ratio, col);
    }
  }
}

template <typename T, int NB, int S, int KIND>
cudaError_t launch_select_s(const void* x, const void* factor, const void* mask,
                            const void* idx, void* out, int n, int n_p, int idx_slots,
                            int64_t d, int s, int nb, float trim_ratio, cudaStream_t stream) {
  const size_t shmem = static_cast<size_t>(n_p) * sizeof(Slot) + nb * sizeof(Bucket);
  const int64_t per_block = static_cast<int64_t>(kSelectThreads) * kSelectTiles;
  const int64_t blocks = (d + per_block - 1) / per_block;
  clip_bucket_select_kernel<T, NB, S, KIND>
      <<<static_cast<unsigned>(blocks), kSelectThreads, shmem, stream>>>(
          static_cast<const T*>(x), static_cast<const float*>(factor),
          static_cast<const float*>(mask), static_cast<const int*>(idx),
          static_cast<float*>(out), n, n_p, idx_slots, d, s, nb, trim_ratio);
  return cudaGetLastError();
}

template <typename T, int NB>
cudaError_t launch_select_nb(const void* x, const void* factor, const void* mask,
                             const void* idx, void* out, int n, int n_p, int idx_slots,
                             int64_t d, int s, int nb, float trim_ratio, cudaStream_t stream) {
  if (s == 1)
    return launch_select_s<T, NB, 1, kGeneric>(x, factor, mask, idx, out, n, n_p, idx_slots,
                                               d, s, nb, trim_ratio, stream);
  if (s == 2)
    return launch_select_s<T, NB, 2, kGeneric>(x, factor, mask, idx, out, n, n_p, idx_slots,
                                               d, s, nb, trim_ratio, stream);
  return launch_select_s<T, NB, 0, kGeneric>(x, factor, mask, idx, out, n, n_p, idx_slots, d,
                                             s, nb, trim_ratio, stream);
}

// The exact-width kernel of (nb, s) when REPRO_EXACT_WIDTHS lists it, else
// the generic one of the NB_CAPS width nb_cap (16/32/64/128, >= nb).
template <typename T>
cudaError_t launch_select_dtype(const void* x, const void* factor, const void* mask,
                                const void* idx, void* out, int n, int n_p, int idx_slots,
                                int64_t d, int s, int nb, float trim_ratio, int nb_cap,
                                cudaStream_t stream) {
#define REPRO_EXACT_CASE(W, S)                                                                \
  if (nb == W && s == S)                                                                      \
    return trim_ratio < 0.f                                                                   \
               ? launch_select_s<T, W, S, kMedian>(x, factor, mask, idx, out, n, n_p,         \
                                                   idx_slots, d, s, nb, trim_ratio, stream)   \
               : launch_select_s<T, W, S, kTrimmed>(x, factor, mask, idx, out, n, n_p,        \
                                                    idx_slots, d, s, nb, trim_ratio, stream);
  REPRO_EXACT_WIDTHS(REPRO_EXACT_CASE)
#undef REPRO_EXACT_CASE
  switch (nb_cap) {
    case 16: return launch_select_nb<T, 16>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb, trim_ratio, stream);
    case 32: return launch_select_nb<T, 32>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb, trim_ratio, stream);
    case 64: return launch_select_nb<T, 64>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb, trim_ratio, stream);
    case 128: return launch_select_nb<T, 128>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb, trim_ratio, stream);
    default: return cudaErrorInvalidValue;
  }
}

// idx_slots: how many leading slots read idx (n for pass 2's row order, n_p
// for a permutation of every slot).
inline cudaError_t launch_select(const void* x, const void* factor, const void* mask,
                                 const void* idx, void* out, int dtype, int n, int n_p,
                                 int idx_slots, int64_t d, int s, int nb, float trim_ratio,
                                 int nb_cap, cudaStream_t stream) {
  if (d <= 0 || n <= 0 || nb <= 0 || nb > nb_cap || nb_cap > kSelectThreads ||
      idx_slots < 0 || idx_slots > n_p)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_select_dtype<float>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb,
                                      trim_ratio, nb_cap, stream);
  if (dtype == 1)
    return launch_select_dtype<__nv_bfloat16>(x, factor, mask, idx, out, n, n_p, idx_slots, d,
                                              s, nb, trim_ratio, nb_cap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace repro
