// Shared device code of the order-statistic kernels: the fused
// clip -> Bucketing -> CM/TM pass and the standalone masked CM/TM (s = 1,
// rows in order, no clip factors) are one template behind one C entry
// point (clip_aggregate.cu).
//
// Replaces the TPU kernels _clip_agg_kernel / _clip_bucket_agg_kernel
// (src/repro/kernels/clip_aggregate.py) and _cm_kernel / _tm_kernel
// (src/repro/kernels/coordinate_median.py), which share _select_masked.
//
// Bound on the H100: bytes.  The kernel reads each of the n*d inputs once
// (n*d*4 bytes in f32) and writes d*4 bytes; per coordinate it does about
// 3*n_p multiplies/adds, nb divides and a bitonic network of
// NB/4*log2(NB)*(log2(NB)+1) compare-exchanges.  At n = 20 that is far
// below the card's f32 rate, so the time is set by how well the row
// streams are read.
//
// Design: one thread per coordinate, so the 32 threads of a warp read 32
// neighbouring columns of the same row (coalesced).  The row gather of
// Bucketing, the per-row clip factors and the mask live in shared memory.
// The bucket size is a template argument for s = 1 and s = 2 (0 = read at
// run time), so that the loads of all buckets unroll and are in flight
// together: with s read at run time the kernel took 35% longer at s = 2
// and 39% at s = 1 (n = 20, d = 2^24+37, H100; tools/select_variants.py).  Each thread forms its nb bucket means in a register array of
// compile-time size NB >= nb, sorts them with a bitonic network, and reads
// the order statistics off the sorted array.  Sorting keeps the TPU
// kernel's semantics: the values _select_masked picks by unique rank are
// the sorted values at those positions.  Empty buckets (and masked rows
// when s = 1) hold +3.4e37, not +inf, so that 3.4e37 * 0 stays 0, as in
// the reference.
//
// The network sorts order-preserving int32 keys of the means, not the
// floats: fminf/fmaxf would drop a NaN (a Byzantine worker can send one)
// and duplicate another value in its place.  Under the keys every NaN
// sorts after +inf, as torch.sort and jnp.sort order it, and a selected
// NaN comes out as NaN.  Slots past nb hold INT_MAX and sort last.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr float kBig = 3.4e37f;
constexpr int kSelectThreads = 256;
constexpr int kKeyLast = 0x7fffffff;  // sorts after every float's key

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

// Order statistics of the sorted keys, cnt of which are valid.
// trim_ratio < 0: the numpy median, the mean of positions (cnt-1)//2 and
// cnt//2 (cnt = 0 reads slot 0, +3.4e37, the jnp reference's answer).
// Otherwise the trimmed mean: t = min(ceil(r*cnt), (cnt-1)//2) values
// dropped at each end, the rest summed in ascending order.
template <int NB>
__device__ __forceinline__ float select_sorted(const int (&v)[NB], int cnt,
                                               float trim_ratio) {
  const int half_lo = (cnt - 1) >> 1;  // floor division, also for cnt = 0
  if (trim_ratio < 0.f) {
    const int lo = half_lo < 0 ? 0 : half_lo;
    const int hi = cnt >> 1;
    int a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k == lo) a = v[k];
      if (k == hi) b = v[k];
    }
    return 0.5f * (key_value(a) + key_value(b));
  }
  const int t = min(static_cast<int>(ceilf(trim_ratio * static_cast<float>(cnt))), half_lo);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    if (k >= t && k < cnt - t) acc += key_value(v[k]);
  }
  return acc / static_cast<float>(max(cnt - 2 * t, 1));
}

// out[c] = Select_{b < nb}( sum_{j < s} (x[row(b*s+j), c] * f) * m / max(cnt_b, 1) ).
// Slot j < idx_slots reads row idx[j] (row j when idx is null); slots
// idx_slots..n_p-1 and indices outside [0, n) are empty (mask 0, never
// read).  Pass 2 gives idx_slots = n (an (n,) row order, padding after
// it); bucketed CM gives n_p (a permutation of all n_p slots).  A null
// factor means 1.  S is s when it is 1 or 2, else 0 and s is read at run
// time.  Dynamic shared memory: 3*n_p + nb words.
template <typename T, int NB, int S>
__global__ void __launch_bounds__(kSelectThreads)
clip_bucket_select_kernel(const T* __restrict__ x, const float* __restrict__ factor,
                          const float* __restrict__ mask, const int* __restrict__ idx,
                          float* __restrict__ out, int n, int n_p, int idx_slots,
                          int64_t d, int s_rt, int nb, float trim_ratio) {
  const int s = S > 0 ? S : s_rt;
  extern __shared__ float smem[];
  int* s_row = reinterpret_cast<int*>(smem);
  float* s_f = smem + n_p;
  float* s_m = s_f + n_p;
  float* s_cnt = s_m + n_p;
  __shared__ int s_nok;

  for (int j = threadIdx.x; j < n_p; j += blockDim.x) {
    int r = j < idx_slots ? (idx != nullptr ? idx[j] : j) : -1;
    if (r >= n) r = -1;
    s_row[j] = r;
    s_f[j] = (r >= 0 && factor != nullptr) ? factor[r] : 1.f;
    s_m[j] = r >= 0 ? mask[r] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nok = 0;
    for (int b = 0; b < nb; ++b) {
      float c = 0.f;
      for (int j = 0; j < s; ++j) c += s_m[b * s + j];
      s_cnt[b] = c;
      nok += c > 0.5f ? 1 : 0;
    }
    s_nok = nok;
  }
  __syncthreads();

  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= d) return;
  int v[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    int key = kKeyLast;  // slots past nb sort last
    if (b < nb) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < (S > 0 ? S : s); ++j) {
        const int slot = b * s + j;
        const int r = s_row[slot];
        const float xv = r >= 0 ? to_f32(x[static_cast<int64_t>(r) * d + col]) : 0.f;
        acc += (xv * s_f[slot]) * s_m[slot];
      }
      const float c = s_cnt[b];
      key = sort_key(c > 0.5f ? acc / fmaxf(c, 1.f) : kBig);
    }
    v[b] = key;
  }
  bitonic_sort(v);
  out[col] = select_sorted(v, s_nok, trim_ratio);
}

template <typename T, int NB, int S>
cudaError_t launch_select_s(const void* x, const void* factor, const void* mask,
                            const void* idx, void* out, int n, int n_p, int idx_slots,
                            int64_t d, int s, int nb, float trim_ratio, cudaStream_t stream) {
  const size_t shmem = (3 * static_cast<size_t>(n_p) + nb) * sizeof(float);
  const int64_t blocks = (d + kSelectThreads - 1) / kSelectThreads;
  clip_bucket_select_kernel<T, NB, S>
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
    return launch_select_s<T, NB, 1>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb,
                                     trim_ratio, stream);
  if (s == 2)
    return launch_select_s<T, NB, 2>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb,
                                     trim_ratio, stream);
  return launch_select_s<T, NB, 0>(x, factor, mask, idx, out, n, n_p, idx_slots, d, s, nb,
                                   trim_ratio, stream);
}

// dtype 0 = f32, 1 = bf16; nb_cap is one of 16/32/64/128 and >= nb.
template <typename T>
cudaError_t launch_select_dtype(const void* x, const void* factor, const void* mask,
                                const void* idx, void* out, int n, int n_p, int idx_slots,
                                int64_t d, int s, int nb, float trim_ratio, int nb_cap,
                                cudaStream_t stream) {
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
  if (d <= 0 || n <= 0 || nb <= 0 || nb > nb_cap || idx_slots < 0 || idx_slots > n_p)
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
