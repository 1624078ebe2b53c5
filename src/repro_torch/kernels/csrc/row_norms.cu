// Pass 1 of the fused server clip: per-row partial sums of squares.
//
// Replaces the TPU kernel _rownorm_kernel, launched by _row_norms
// (src/repro/kernels/clip_aggregate.py).
//
// Bound on the H100: bytes.  It reads the n*d inputs once (n*d*4 bytes
// in f32) and does 2*n*d flops, so at 3.35 TB/s the read is the whole
// cost.
//
// Design: grid (chunks, n).  Block (c, i) reduces columns
// [c*kChunk, (c+1)*kChunk) of row i: coalesced strided loads, four in
// flight per thread, a warp-shuffle tree and one shared-memory step, and
// writes partial[i, c].  There are no atomics, so a run is reproducible;
// the wrapper sums the partials and takes the square root in torch, as
// _row_norms does outside its kernel.
#include <stdint.h>

#include "common.cuh"

namespace repro {

constexpr int kRowThreads = 256;
constexpr int kChunk = 8192;  // columns per block: 32 per thread

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
row_ssq_kernel(const T* __restrict__ x, float* __restrict__ partial, int64_t d, int chunks) {
  const int row = blockIdx.y;
  const int chunk = blockIdx.x;
  const T* xr = x + static_cast<int64_t>(row) * d;
  const int64_t start = static_cast<int64_t>(chunk) * kChunk;
  const int64_t end = start + kChunk < d ? start + kChunk : d;
  float acc = 0.f;
#pragma unroll 4
  for (int64_t i = start + threadIdx.x; i < end; i += kRowThreads) {
    const float v = to_f32(xr[i]);
    acc += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  __shared__ float warp_sums[kRowThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kRowThreads / 32; ++w) total += warp_sums[w];
    partial[static_cast<int64_t>(row) * chunks + chunk] = total;
  }
}

}  // namespace repro

// x: (n, d) row-major, dtype 0 = f32, 1 = bf16.  partial: (n, chunks) f32
// with chunks = ceil(d / row_ssq_chunk()).
extern "C" int row_ssq_chunk() { return repro::kChunk; }

extern "C" int row_ssq_launch(const void* x, void* partial, int dtype, int n, long long d,
                              int chunks, void* stream) {
  if (n <= 0 || n > 65535 || d <= 0 || chunks != (d + repro::kChunk - 1) / repro::kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(n));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    repro::row_ssq_kernel<float><<<grid, repro::kRowThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(partial), d, chunks);
  } else if (dtype == 1) {
    repro::row_ssq_kernel<__nv_bfloat16><<<grid, repro::kRowThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partial), d, chunks);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
