// The card's own rate for the scattered accesses of the slice window's
// ingest step (flink_tpu_torch/csrc/hash_table.cu), one access a thread
// at the addresses of an index array, so the order of the addresses is
// the caller's: random, or bucketed into contiguous spans, or sorted.
//
// Ops (the step's accesses, each on its own):
//  0 read8   an 8-byte L2 read (__ldcg), as the probe reads the table
//  1 probe8  that read, then a 64-bit CAS on the same slot when it holds
//            `fill` (a key new to the table claims an empty slot)
//  2 cas8    a 64-bit CAS from `fill`, result used
//  3 red4    a 4-byte atomicAdd whose result is unused (a count plane)
//  4 red8    an 8-byte atomicAdd whose result is unused (a sum plane)
//  5 store4  a plain 4-byte store
//  6 store8  a plain 8-byte store
//
// Built by chip_smoke.py with the flags of flink_tpu_torch/ops/kernels.py
// into the package's build directory; not part of the package.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kMagic = 0x5EC7025EC7025EC7ull;

__global__ void __launch_bounds__(kThreads)
sector_rate_kernel(int op, void* base, const long long* __restrict__ idx,
                   long long n, unsigned long long fill,
                   unsigned long long* sink) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long at = __ldg(idx + i);
  unsigned long long* p8 = static_cast<unsigned long long*>(base) + at;
  unsigned* p4 = static_cast<unsigned*>(base) + at;
  unsigned long long seen = 0;
  switch (op) {
    case 0:
      seen = __ldcg(p8);
      break;
    case 1:
      seen = __ldcg(p8);
      if (seen == fill) seen = atomicCAS(p8, fill, (unsigned long long)i);
      break;
    case 2:
      seen = atomicCAS(p8, fill, (unsigned long long)i);
      break;
    case 3:
      atomicAdd(p4, 1u);
      break;
    case 4:
      atomicAdd(p8, 1ull);
      break;
    case 5:
      *p4 = (unsigned)i;
      break;
    default:
      *p8 = (unsigned long long)i;
      break;
  }
  if (seen == kMagic) *sink = seen;  // keeps the reads; never true
}

}  // namespace

// n accesses of `op` at base's cells idx[0..n) (int64 indices into cells
// of the op's width). fill: the value a CAS expects. sink: one int64.
// Returns cudaGetLastError.
extern "C" int sector_rate_launch(int op, void* base, const void* idx,
                                  long long n, unsigned long long fill,
                                  void* sink, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (op < 0 || op > 6) return (int)cudaErrorInvalidValue;
  sector_rate_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads,
                       0, (cudaStream_t)stream>>>(
      op, base, (const long long*)idx, n, fill,
      (unsigned long long*)sink);
  return (int)cudaGetLastError();
}
