// The mesh's keyBy exchange as it was before its Hopper redesign
// (flink_tpu_torch/csrc/exchange.cu), kept buildable so that one call
// can time it beside the package's kernel: tools/exchange_designs.py builds
// this file with the package's flags (-I flink_tpu_torch/csrc) and binds
// exchange_bucket_earlier_launch. Only the C entries' names differ from
// that source.
//
// Two device operations a call: a memset of the [S, D] counts, then one
// thread a row over S x ceil(B / 256) blocks. A warp ranks its rows within
// their bucket by __match_any_sync, the block takes its base in each
// bucket with one global atomic a destination, and each row writes at
// base + rank. Rows within a bucket come in the order the blocks' atomics
// land, not in batch order.
#include <cstdint>
#include <cuda_runtime.h>

#include "keygroup.cuh"

namespace {

using keygroup::key_group;
constexpr int kThreads = 256;
constexpr int kMaxDest = 256;
constexpr int kMaxCols = 7;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kEmpty = 0x7FFFFFFFFFFFFFFFll;

struct Args {
  const long long* keys;  // [S, B]
  const long long* ts;    // [S, B]
  const uint8_t* valid;   // [S, B] bytes, or null
  long long n_valid;      // rows of the flattened block that may be in
  long long B;
  long long pane, offset;
  int D, maxp, base_start, base_len;
  int n_cols;
  const void* cols[kMaxCols];  // [S, B] each
  int col_size[kMaxCols];      // bytes of an element: 1, 2, 4 or 8
  long long* out_keys;         // [D, out_stride]
  long long* out_panes;        // [D, out_stride]
  void* out_cols[kMaxCols];    // [D, out_stride] each
  long long out_stride;        // S * B
  unsigned long long* counts;  // [S, D], zeroed by the launch
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ void copy_col(const void* src, void* dst,
                                         int size, long long from,
                                         long long to) {
  switch (size) {
    case 8:
      static_cast<long long*>(dst)[to] =
          __ldg(static_cast<const long long*>(src) + from);
      break;
    case 4:
      static_cast<int*>(dst)[to] = __ldg(static_cast<const int*>(src) + from);
      break;
    case 2:
      static_cast<short*>(dst)[to] =
          __ldg(static_cast<const short*>(src) + from);
      break;
    default:
      static_cast<unsigned char*>(dst)[to] =
          __ldg(static_cast<const unsigned char*>(src) + from);
      break;
  }
}

__global__ void __launch_bounds__(kThreads) exchange_bucket_kernel(Args a) {
  __shared__ int block_cnt[kMaxDest];
  __shared__ long long block_base[kMaxDest];
  const int s = blockIdx.y;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (int d = threadIdx.x; d < a.D; d += kThreads) block_cnt[d] = 0;
  __syncthreads();
  const long long r = (long long)s * a.B + i;
  bool on = i < a.B && r < a.n_valid && (a.valid == nullptr || a.valid[r]);
  long long key = 0, ts = 0;
  int dest = -1;
  if (on) {
    key = __ldg(a.keys + r);
    ts = __ldg(a.ts + r);
    const long long rel =
        (long long)key_group((unsigned long long)key, a.maxp) - a.base_start;
    if (rel >= 0 && rel < a.base_len)
      dest = (int)(rel * a.D / a.base_len);
    else
      on = false;
  }
  // the row's rank among the block's rows of its destination
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, on ? dest : -1);
  int rank = 0;
  if (on) {
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&block_cnt[dest], __popc(peers));
    base = __shfl_sync(peers, base, leader);
    rank = base + __popc(peers & ((1u << lane) - 1u));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    const int c = block_cnt[d];
    block_base[d] =
        c ? (long long)atomicAdd(a.counts + (long long)s * a.D + d,
                                 (unsigned long long)c)
          : 0;
  }
  __syncthreads();
  if (!on) return;
  const long long pos = (long long)dest * a.out_stride + (long long)s * a.B +
                        block_base[dest] + rank;
  a.out_keys[pos] = key == kEmpty ? kEmpty - 1 : key;
  a.out_panes[pos] = floor_div(
      (long long)((unsigned long long)ts - (unsigned long long)a.offset),
      a.pane);
  for (int c = 0; c < a.n_cols; ++c)
    copy_col(a.cols[c], a.out_cols[c], a.col_size[c], r, pos);
}

}  // namespace

// S source blocks of B rows: keys [S, B] int64, ts [S, B] int64, valid
// [S, B] bytes or null, n_valid the rows of the flattened block that may be
// in; cols[c] [S, B] of col_size[c] bytes. D destinations (1 to 256); a row
// routes by its key group against [base_start, base_start + base_len) of
// max parallelism maxp. Writes out_keys, out_panes and out_cols[c], each
// [D, S * B], and counts [S, D] int64 (zeroed first). Returns
// cudaGetLastError.
extern "C" int exchange_bucket_earlier_launch(
    const void* keys, const void* ts, const void* valid, long long n_valid,
    long long S, long long B, long long pane, long long offset, int D,
    int maxp, int base_start, int base_len, int n_cols,
    const void* const* cols, const int* col_size, void* out_keys,
    void* out_panes, void* const* out_cols, void* counts, void* stream) {
  if (S <= 0 || B <= 0 || D < 1 || D > kMaxDest || maxp < 1 || pane <= 0 ||
      base_len < 1 || n_cols < 0 || n_cols > kMaxCols ||
      S > 65535 || (B + kThreads - 1) / kThreads > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.keys = (const long long*)keys;
  a.ts = (const long long*)ts;
  a.valid = (const uint8_t*)valid;
  a.n_valid = n_valid;
  a.B = B;
  a.pane = pane;
  a.offset = offset;
  a.D = D;
  a.maxp = maxp;
  a.base_start = base_start;
  a.base_len = base_len;
  a.n_cols = n_cols;
  for (int c = 0; c < n_cols; ++c) {
    const int sz = col_size[c];
    if (sz != 1 && sz != 2 && sz != 4 && sz != 8)
      return (int)cudaErrorInvalidValue;
    a.cols[c] = cols[c];
    a.col_size[c] = sz;
    a.out_cols[c] = out_cols[c];
  }
  a.out_keys = (long long*)out_keys;
  a.out_panes = (long long*)out_panes;
  a.out_stride = S * B;
  a.counts = (unsigned long long*)counts;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (size_t)(S * D) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  if (n_valid <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((B + kThreads - 1) / kThreads), (unsigned)S);
  exchange_bucket_kernel<<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* exchange_earlier_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
