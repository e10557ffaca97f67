// 256-bin digit histogram for the fire-path radix select.
//
// Replaces: flink_tpu/ops/pallas_topk.py::_hist_kernel (called through
// histogram256_pallas). It counts ((u >> shift) & 0xFF) over the rows
// where valid holds. The radix select (flink_tpu_torch/ops/radix_topk.py)
// runs one launch per 8-bit digit to pin the exact k-th value.
//
// Bound on the H100: device memory. Each row is read once, a 4-byte word
// and a 1-byte valid flag, so about 5 B per row and no reuse: 2^21 rows
// move 10.5 MB (3.1 us at 3.35 TB/s), 2^24 rows 84 MB (25 us). The
// arithmetic is one shift, one mask and one counter update per row.
//
// Design. The TPU kernel built a one-hot [block, 256] tile and summed it,
// because the TPU has no fast scatter and its grid runs in order, carrying
// the sum in VMEM. Hopper has fast shared-memory atomics and runs blocks
// in parallel, so:
//  * each block keeps its own 256-bin histogram in shared memory and walks
//    the rows with a grid-stride loop, enough blocks to fill every SM;
//  * a warp reads 4 x 32 consecutive rows per step (coalesced, four loads
//    in flight per thread before any atomic), keeps the valid flag as a
//    byte and never widens it;
//  * lanes of a warp that hit the same bin are merged with
//    __match_any_sync and one leader adds the popcount, so skewed digits
//    (the top digit of small counts is almost always 0) cost one shared
//    atomic per warp instead of 32 serialised ones;
//  * at the end each block adds its non-zero bins to the zeroed [256]
//    output with one global atomic per bin. The result is exact.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads)
hist256_kernel(const int32_t* __restrict__ u,
               const uint8_t* __restrict__ valid, long long n, int shift,
               int32_t* __restrict__ out) {
  __shared__ int32_t bins[kBins];
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) bins[b] = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * (blockDim.x >> 5) +
                         (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * (blockDim.x >> 5);
  const long long span = 32LL * kUnroll;
  // every lane of a warp shares `base`, so the loop test is warp-uniform
  // and the full-mask __match_any_sync below is legal
  for (long long base = warp * span; base < n; base += n_warps * span) {
    int bin[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const long long i = base + j * 32 + lane;
      bin[j] = -1;
      if (i < n && valid[i]) {
        bin[j] = (int)(((uint32_t)u[i] >> shift) & 0xFFu);
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const unsigned peers = __match_any_sync(0xffffffffu, bin[j]);
      if (bin[j] >= 0 && lane == __ffs(peers) - 1) {
        atomicAdd(&bins[bin[j]], __popc(peers));
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kBins; b += blockDim.x) {
    const int c = bins[b];
    if (c) atomicAdd(&out[b], c);
  }
}

}  // namespace

// out must be a zeroed [256] int32 buffer; u an [n] int32 buffer and valid
// an [n] byte buffer (bool). Launches on `stream`; returns cudaGetLastError.
extern "C" int hist256_launch(const void* u, const void* valid, long long n,
                              int shift, void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long rows_per_block = (long long)kThreads * kUnroll;
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  hist256_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)u, (const uint8_t*)valid, n, shift, (int32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* hist256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
