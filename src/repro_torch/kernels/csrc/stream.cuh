// Streaming a vector on the H100 with 16-byte loads and stores and enough
// bytes in flight to cover the memory's latency.  Used by clipped_diff_scale
// (clipped_diff.cu).
//
// What bounds such a pass on the card: bytes.  Little's law: 3.35 TB/s times
// a DRAM latency of about 0.7 us is about 2.3 MB in flight over the card, or
// about 18 KB a streaming multiprocessor (SM).  A block of kStreamThreads
// threads takes kStreamSpan consecutive 16-byte words; each thread issues its
// kStreamUnroll loads (neighbouring threads on neighbouring words) before it
// waits on any, so a block has 256 * 4 * 16 B = 16 KB in flight, and the 5-8
// blocks that fit on a SM (32-44 registers a thread) 80-128 KB, 4-7 times
// the 18 KB.  Blocks are short and many (one a span): a block that finishes
// makes room for the next while the others' loads are in flight, with no
// loop that drains each thread between steps (a grid-stride loop over 4
// blocks a SM with the same loads a step reached 76-78% of the bound, these
// short blocks 82-84%, on an H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// Alignment.  The words are whole 16-byte words of source and output alike:
// the caller passes both starting on a 16-byte boundary and handles the
// values before it (a scalar head) and the last len % kN (a scalar tail).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kStreamThreads = 256;
constexpr int kStreamUnroll = 4;  // 16-byte loads a thread issues before it waits
constexpr int kStreamSpan = kStreamThreads * kStreamUnroll;  // words of a block

// kN values of T make one 16-byte word.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kN = 4;
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The word's values as f32, exactly (a bf16 value is the high half of its f32).
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[4]) {
  v[0] = __uint_as_float(w.x);
  v[1] = __uint_as_float(w.y);
  v[2] = __uint_as_float(w.z);
  v[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void unpack(const uint4& w, float (&v)[8]) {
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// Store one 16-byte word of T, given as f32 values, at a 16-byte aligned p.
__device__ __forceinline__ void store_word(float* p, const float (&v)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                            __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ void store_word(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 w;
  w.x = bf16_bits(v[0]) | (bf16_bits(v[1]) << 16);
  w.y = bf16_bits(v[2]) | (bf16_bits(v[3]) << 16);
  w.z = bf16_bits(v[4]) | (bf16_bits(v[5]) << 16);
  w.w = bf16_bits(v[6]) | (bf16_bits(v[7]) << 16);
  *reinterpret_cast<uint4*>(p) = w;
}

// Issue this thread's loads of words k0 + u * kStreamThreads (u <
// kStreamUnroll) of `words`, of which there are `full`; a word past the end
// is left 0.  Nothing waits on them here.
__device__ __forceinline__ void issue_words(const uint4* __restrict__ words, int64_t k0,
                                            int64_t full, uint4 (&w)[kStreamUnroll]) {
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u) {
    const int64_t k = k0 + u * kStreamThreads;
    w[u] = k < full ? __ldg(words + k) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Blocks for len values of T: one a span of whole words, at least 1.
template <typename T>
inline unsigned stream_blocks(long long len) {
  const long long words = len / Word<T>::kN;
  const long long blocks = (words + kStreamSpan - 1) / kStreamSpan;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// How many values of T lie between p and the next 16-byte boundary (0 on one).
template <typename T>
inline int to_boundary(const void* p) {
  const unsigned past = static_cast<unsigned>(reinterpret_cast<uintptr_t>(p) & 15u);
  return static_cast<int>(((16u - past) & 15u) / sizeof(T));
}

}  // namespace repro
