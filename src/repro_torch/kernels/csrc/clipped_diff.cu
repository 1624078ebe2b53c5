// The worker side of Algorithm 1, line 8: the gradient difference, RandK's
// keep mask and its scale, then the clip, fused into two passes:
//
//   d = (g_new - g_old) * keep * scale,  stored in g's dtype
//   out = d * min(1, r / max(||d||, 1e-30)),  ||d|| from the f32 d
//
// Replaces two TPU kernel bodies, launched by clipped_diff
// (src/repro/kernels/clipped_diff.py):
//   clipped_diff_ssq    _diff_kernel: d and one partial sum of d^2 per block
//   clipped_diff_scale  _scale_kernel: d times the clip factor
//
// What bounds them on the H100: bytes.  The first reads g_new, g_old and the
// keep mask and writes d (a few flops a value); the second reads d and writes
// out.  In bf16 d is rounded to g's dtype before the clip, as the reference
// stores it; the norm is taken from the f32 d before that rounding.
//
// Design of clipped_diff_ssq: grid-stride loops over the flattened vector, a
// fixed grid of at most kMaxBlocks blocks of kThreads threads, neighbouring
// threads on neighbouring values.  Each block writes one partial sum (a
// warp-shuffle tree, then the warp sums in order): no atomics, so a run
// repeats bit for bit.  The wrapper sums the partials, takes the norm and the
// factor on the device (no host sync), and the second pass reads the factor
// there.  The keep mask is bytes (a bool tensor) or g's dtype, as the
// reference casts it.
//
// Design of clipped_diff_scale: the streaming loads of stream.cuh.  Its first
// design (a grid-stride loop with one 4-byte load a thread per step over at
// most 1,024 blocks: about 8 KB of loads in flight a SM against the ~18 KB
// the card's latency needs) reached 73% of its bound by device time; now a
// short block a span of 16-byte words, each thread's four loads issued
// before it waits on one (64-128 KB in flight a SM), and the factor read
// once a block, by thread 0, behind the block's loads.  The entry point's d
// is a fresh allocation, so it starts on a 16-byte boundary.  A d that does
// not (a direct call on a view) gets an output that lies as far past one
// (the wrapper allocates it so), so that after a scalar head of the values
// before the boundary, loads and stores are whole words alike.
//
// Built with --fmad=false, so d and out are bit for bit the plain PyTorch
// version's, given the same factor.
#include <stdint.h>

#include "common.cuh"
#include "stream.cuh"

namespace repro {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

inline unsigned grid_of(long long len) {
  const long long blocks = (len + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// dout[i] = (gn[i] - go[i]) * keep[i] * scale in T; partial[b] = the block's
// sum of the f32 d^2.
template <typename T, typename K>
__global__ void __launch_bounds__(kThreads)
clipped_diff_ssq_kernel(const T* __restrict__ gn, const T* __restrict__ go,
                        const K* __restrict__ keep, float scale, T* __restrict__ dout,
                        float* __restrict__ partial, int64_t len) {
  __shared__ float warp_sums[kThreads / 32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float acc = 0.f;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < len;
       i += stride) {
    const float dv = (to_f32(gn[i]) - to_f32(go[i])) * to_f32(keep[i]) * scale;
    dout[i] = from_f32<T>(dv);
    acc += dv * dv;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    partial[blockIdx.x] = total;
  }
}

// out[i] = T(f32(d[i]) * f), d and out `head` values short of a 16-byte
// boundary: the head and the last values past the whole words are scalar.
// Thread 0 reads f = *factor once a block, after the block's loads are
// issued, so that its latency hides behind theirs.
template <typename T>
__global__ void __launch_bounds__(kStreamThreads)
clipped_diff_scale_kernel(const T* __restrict__ d, const float* __restrict__ factor,
                          T* __restrict__ out, int head, int64_t len) {
  constexpr int kN = Word<T>::kN;
  __shared__ float s_factor;
  const int64_t full = (len - head) / kN;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * kStreamSpan + threadIdx.x;
  uint4 w[kStreamUnroll];
  issue_words(reinterpret_cast<const uint4*>(d + head), k0, full, w);
  if (threadIdx.x == 0) s_factor = *factor;
  __syncthreads();
  const float f = s_factor;
  T* body = out + head;
#pragma unroll
  for (int u = 0; u < kStreamUnroll; ++u) {
    const int64_t k = k0 + u * kStreamThreads;
    if (k < full) {
      float v[kN];
      unpack(w[u], v);
#pragma unroll
      for (int i = 0; i < kN; ++i) v[i] *= f;
      store_word(body + k * kN, v);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < head)
    out[threadIdx.x] = from_f32<T>(to_f32(d[threadIdx.x]) * f);
  const int64_t tail = head + full * kN;  // the last (len - head) % kN values
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x < len - tail)
    out[tail + threadIdx.x] = from_f32<T>(to_f32(d[tail + threadIdx.x]) * f);
}

template <typename T>
cudaError_t launch_scale(const void* d, const void* factor, void* out, long long len,
                         cudaStream_t st) {
  const uintptr_t pd = reinterpret_cast<uintptr_t>(d), po = reinterpret_cast<uintptr_t>(out);
  if (pd % sizeof(T) != 0 || (pd & 15u) != (po & 15u)) return cudaErrorInvalidValue;
  const int boundary = to_boundary<T>(d);
  const int head = boundary < len ? boundary : static_cast<int>(len);
  clipped_diff_scale_kernel<T><<<stream_blocks<T>(len - head), kStreamThreads, 0, st>>>(
      static_cast<const T*>(d), static_cast<const float*>(factor), static_cast<T*>(out), head,
      len);
  return cudaGetLastError();
}

template <typename T, typename K>
cudaError_t launch_ssq(const void* gn, const void* go, const void* keep, float scale, void* dout,
                       void* partial, long long len, cudaStream_t st) {
  clipped_diff_ssq_kernel<T, K><<<grid_of(len), kThreads, 0, st>>>(
      static_cast<const T*>(gn), static_cast<const T*>(go), static_cast<const K*>(keep), scale,
      static_cast<T*>(dout), static_cast<float*>(partial), len);
  return cudaGetLastError();
}

}  // namespace repro

// The number of partial sums (blocks) clipped_diff_ssq writes for len values.
extern "C" int clipped_diff_blocks(long long len) {
  return len > 0 ? static_cast<int>(repro::grid_of(len)) : 0;
}

// gn, go, dout: len values of dtype 0 = f32, 1 = bf16; keep: len values of
// keep_bytes = 1 (bool) or of g's dtype (keep_bytes = 0); partial:
// clipped_diff_blocks(len) f32.
extern "C" int clipped_diff_ssq_launch(const void* gn, const void* go, const void* keep,
                                       float scale, void* dout, void* partial, int dtype,
                                       int keep_bytes, long long len, void* stream) {
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = keep_bytes ? repro::launch_ssq<float, uint8_t>(gn, go, keep, scale, dout, partial, len, st)
                    : repro::launch_ssq<float, float>(gn, go, keep, scale, dout, partial, len, st);
  else if (dtype == 1)
    rc = keep_bytes
             ? repro::launch_ssq<__nv_bfloat16, uint8_t>(gn, go, keep, scale, dout, partial,
                                                         len, st)
             : repro::launch_ssq<__nv_bfloat16, __nv_bfloat16>(gn, go, keep, scale, dout,
                                                               partial, len, st);
  return static_cast<int>(rc);
}

// d, out: len values of dtype 0 = f32, 1 = bf16, out as far past a 16-byte
// boundary as d; factor: a device f32 scalar.
extern "C" int clipped_diff_scale_launch(const void* d, const void* factor, void* out, int dtype,
                                         long long len, void* stream) {
  if (len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(repro::launch_scale<float>(d, factor, out, len, st));
  if (dtype == 1)
    return static_cast<int>(repro::launch_scale<__nv_bfloat16>(d, factor, out, len, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
