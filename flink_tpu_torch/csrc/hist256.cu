// Radix-select digit pass and 256-bin histogram for the fire-path top-k.
//
// Replaces: flink_tpu/ops/pallas_topk.py::_hist_kernel (called through
// histogram256_pallas) together with the glue XLA fused around it in
// _topk_pallas: the order-key map, the candidate update and the choice of
// the digit bin that holds the k-th largest value.
//
// Two entries share one kernel:
//  * radix_pass_launch, the select pass. It reads the ranked values of
//    their own dtype (int32, int64, float32, float64, uint8/bool), maps
//    each to its uint64 order word in registers (order_key(v) ^ 2^63, as
//    ops/radix_topk.py defines it), counts the 8-bit digit at `shift` of
//    the rows that are valid and whose bits under `mask` equal the prefix
//    fixed by the earlier passes, and lets the last block to finish pick
//    the digit bin bstar that holds the k-th largest value. That block
//    updates the device state (prefix, above, kk), so the next pass needs
//    nothing from the host and no other launch in between.
//  * hist256_launch, the TPU kernel's own contract: a [256] int32
//    histogram of ((u >> shift) & 0xFF) over the rows where valid holds.
//
// Bound on the H100: device memory. A pass reads each value and its valid
// byte once: 9 B a row for int64 counts (18.9 MB at 2^21 rows, 5.6 us at
// 3.35 TB/s), 5 B a row for the int32 histogram. Per row the arithmetic
// is a few integer operations and at most one shared-memory atomic.
//
// Design:
//  * each lane takes 16 consecutive rows per step: one 16-byte load of the
//    valid bytes and 16-byte loads of the values, all issued before any is
//    used; the order word, the prefix test and the digit stay in registers;
//  * each warp owns a 256-bin sub-histogram in shared memory. A lane first
//    merges runs of equal digits among its 16 rows in a register, and a
//    change of digit costs one shared atomic; the last run of every lane
//    merges across the warp with __match_any_sync and one leader adds the
//    group's sum, so a skewed digit (the top digit of small counts is
//    almost always 0) costs one atomic per warp and 16 x 32 rows, and a
//    uniform one pays the warp match once per 16 rows, not per row;
//  * the grid is persistent, one wave of resident blocks (its size is
//    asked once per process, radix_grid); each block stores its 256
//    partial counts to a [grid, 256] scratch, then __threadfence() and an
//    atomic ticket elect the last block, which sums the columns with
//    16-byte L2 loads, scans the 256 bins and updates the state. It puts
//    the ticket back to 0, so the scratch needs no memset between passes.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kRows = 16;  // rows per lane per step: one uint4 of valid bytes
constexpr int kPhases = kThreads / (kBins / 4);  // lanes per 4-bin column
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kSign = 1ull << 63;

enum Dtype { kI64 = 0, kI32 = 1, kF32 = 2, kF64 = 3, kU8 = 4 };

// uint64 order word: a < b  <=>  word(a) < word(b)
__device__ __forceinline__ unsigned long long word_of(long long v) {
  return (unsigned long long)v ^ kSign;
}
__device__ __forceinline__ unsigned long long word_of(int v) {
  return (unsigned long long)(long long)v ^ kSign;
}
__device__ __forceinline__ unsigned long long word_of(uint8_t v) {
  return (unsigned long long)v ^ kSign;
}
__device__ __forceinline__ unsigned long long word_of(float v) {
  const uint32_t u = __float_as_uint(v);
  return (unsigned long long)((u & 0x80000000u) ? ~u : (u | 0x80000000u))
         << 32;
}
__device__ __forceinline__ unsigned long long word_of(double v) {
  const unsigned long long u = (unsigned long long)__double_as_longlong(v);
  return (u & kSign) ? ~u : (u | kSign);
}

struct PassArgs {
  const void* values;
  const uint8_t* valid;
  long long n;
  int shift;               // digit position in the order word, 0..56
  int first;               // first pass: no prefix test, state written anew
  int vec;                 // values and valid are 16-byte aligned
  unsigned long long mask; // bits of the word that must equal the prefix
  unsigned long long seed; // prefix bits known before the first pass
  long long k;
  long long* state;        // [3]: prefix word, rows above it, kk (or null)
  int32_t* hist_out;       // [256] totals of this pass (or null)
  int32_t* partials;       // [grid, 256] scratch
  unsigned int* ticket;    // 0 on entry, 0 again on exit
};

// Add c rows of digit d (-1: nothing) to warp sub-histogram h. Called by
// all 32 lanes together: lanes holding the same digit merge, and one
// leader adds their sum, so a skewed digit costs one atomic per warp.
__device__ __forceinline__ void add_digit(int32_t* h, int d, int c) {
  if (__ballot_sync(kFull, d >= 0) == 0u) return;
  const unsigned peers = __match_any_sync(kFull, d);
  const int sum = __reduce_add_sync(peers, c);
  if (d >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) {
    atomicAdd(&h[d], sum);
  }
}

// Last block, warp 0: pick bstar, the largest bin b with
// above + (candidates in bins >= b) >= kk, and update the state.
__device__ void select_digit(const PassArgs& a, const long long* tot) {
  const int lane = threadIdx.x;
  long long hv[8], lane_total = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    hv[j] = tot[lane * 8 + j];
    lane_total += hv[j];
  }
  long long incl = lane_total;  // candidates in the bins of lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long t = __shfl_down_sync(kFull, incl, off);
    if (lane + off < 32) incl += t;
  }
  const long long total = __shfl_sync(kFull, incl, 0);
  long long kk, above;
  unsigned long long prefix;
  if (a.first) {
    kk = total < a.k ? total : a.k;
    above = 0;
    prefix = a.seed;
  } else {
    prefix = (unsigned long long)a.state[0];
    above = a.state[1];
    kk = a.state[2];
  }
  int best = -1;
  long long above_best = 0;
  long long r = incl - lane_total;  // candidates in the bins above lane's
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    if (best < 0 && above + r + hv[j] >= kk) {
      best = lane * 8 + j;
      above_best = above + r;
    }
    r += hv[j];
  }
  const int bstar = __reduce_max_sync(kFull, best);
  if (best >= 0 && best == bstar) {
    a.state[0] = (long long)(prefix | ((unsigned long long)bstar << a.shift));
    a.state[1] = above_best;
    a.state[2] = kk;
  }
}

template <typename T, bool kSelect>
__global__ void __launch_bounds__(kThreads, 1) radix_pass_kernel(PassArgs a) {
  __shared__ __align__(16) int32_t hist[kWarps * kBins];  // 16 KB
  __shared__ long long tot[kBins];
  __shared__ int is_last;
  for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) hist[i] = 0;
  const unsigned long long prefix =
      (kSelect && a.mask) ? (unsigned long long)a.state[0] : 0ull;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  int32_t* h = hist + (threadIdx.x >> 5) * kBins;
  const T* vals = static_cast<const T*>(a.values);
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_warps = (long long)gridDim.x * kWarps;
  const long long groups = a.vec ? a.n / kRows : 0;
  constexpr int kQ = kRows * (int)sizeof(T) / 16;  // uint4 loads of values
  // every lane of a warp shares g0, so the loop test is warp-uniform and
  // the full-mask warp votes in add_digit are legal
  for (long long g0 = warp * 32; g0 < groups; g0 += n_warps * 32) {
    const long long g = g0 + lane;
    union {
      uint4 q[kQ];
      T v[kRows];
    } vu;
    union {
      uint4 q;
      uint8_t b[16];
    } fu;
    if (g < groups) {
      const uint4* vp = reinterpret_cast<const uint4*>(vals + g * kRows);
#pragma unroll
      for (int j = 0; j < kQ; ++j) vu.q[j] = __ldg(vp + j);
      fu.q = __ldg(reinterpret_cast<const uint4*>(a.valid + g * kRows));
    } else {
#pragma unroll
      for (int j = 0; j < kQ; ++j) vu.q[j] = make_uint4(0, 0, 0, 0);
      fu.q = make_uint4(0, 0, 0, 0);
    }
    // a lane's rows are consecutive: equal digits in a row merge in a
    // register run, and only a change of digit costs a shared atomic
    int run_d = -1, run_c = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const unsigned long long w = word_of(vu.v[j]);
      const int d = (fu.b[j] && ((w ^ prefix) & a.mask) == 0)
                        ? (int)((w >> a.shift) & 0xFF) : -1;
      if (d != run_d) {
        if (run_d >= 0) atomicAdd(&h[run_d], run_c);
        run_d = d;
        run_c = 0;
      }
      ++run_c;
    }
    add_digit(h, run_d, run_c);
  }
  // the rows after the last whole group (all rows when unaligned), one a lane
  for (long long b0 = groups * kRows + warp * 32; b0 < a.n;
       b0 += n_warps * 32) {
    const long long i = b0 + lane;
    int d = -1;
    if (i < a.n && a.valid[i]) {
      const unsigned long long w = word_of(vals[i]);
      if (((w ^ prefix) & a.mask) == 0) d = (int)((w >> a.shift) & 0xFF);
    }
    add_digit(h, d, 1);
  }
  __syncthreads();

  if (threadIdx.x < kBins) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += hist[w * kBins + threadIdx.x];
    a.partials[(long long)blockIdx.x * kBins + threadIdx.x] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    is_last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // column sums: lane t adds bins 4q..4q+3 over the blocks g = ph mod kPhases
  {
    const int q = threadIdx.x % (kBins / 4), ph = threadIdx.x / (kBins / 4);
    int4 s = make_int4(0, 0, 0, 0);
    const int4* col = reinterpret_cast<const int4*>(a.partials) + q;
#pragma unroll 8
    for (int g = ph; g < (int)gridDim.x; g += kPhases) {
      const int4 v = __ldcg(col + (long long)g * (kBins / 4));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    int4* red = reinterpret_cast<int4*>(hist);  // the sub-histograms are spent
    red[ph * (kBins / 4) + q] = s;
    __syncthreads();
    if (threadIdx.x < kBins) {
      long long t = 0;
#pragma unroll
      for (int p = 0; p < kPhases; ++p) t += hist[p * kBins + threadIdx.x];
      tot[threadIdx.x] = t;
      if (a.hist_out) a.hist_out[threadIdx.x] = (int32_t)t;
    }
    __syncthreads();
  }
  if (kSelect && threadIdx.x < 32) select_digit(a, tot);
  if (threadIdx.x == 0) *a.ticket = 0u;
}

template <typename T, bool kSelect>
cudaError_t launch(const PassArgs& a, int grid, cudaStream_t stream) {
  radix_pass_kernel<T, kSelect><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int select, int* blocks) {
  return select ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, radix_pass_kernel<T, true>, kThreads, 0)
                : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                      blocks, radix_pass_kernel<T, false>, kThreads, 0);
}

}  // namespace

// Blocks of one resident wave of the pass kernel for value dtype `code`
// (select != 0) or of the int32 histogram (select == 0) on the current
// device, written to *grid. Asked once per process by the wrapper.
extern "C" int radix_grid(int code, int select, int* grid) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  switch (select ? code : kI32) {
    case kI64: err = occupancy<long long>(select, &blocks); break;
    case kI32: err = occupancy<int>(select, &blocks); break;
    case kF32: err = occupancy<float>(select, &blocks); break;
    case kF64: err = occupancy<double>(select, &blocks); break;
    case kU8: err = occupancy<uint8_t>(select, &blocks); break;
    default: return (int)cudaErrorInvalidValue;
  }
  *grid = sms * (blocks > 0 ? blocks : 1);
  return (int)err;
}

// One select pass over values [n] of dtype `code` and valid [n] bytes.
// state: [3] int64, written by the first pass and read by the later ones.
// hist_out: [256] int32 or null. partials: [grid, 256] int32. ticket: one
// uint32 that is 0. Launches on `stream`; returns cudaGetLastError.
extern "C" int radix_pass_launch(const void* values, int code,
                                 const void* valid, long long n, int shift,
                                 unsigned long long mask,
                                 unsigned long long seed, long long k,
                                 int first, int vec, void* state,
                                 void* hist_out, void* partials, void* ticket,
                                 int grid, void* stream) {
  if (n <= 0 || grid <= 0 || shift < 0 || shift > 56)
    return (int)cudaErrorInvalidValue;
  PassArgs a{values, (const uint8_t*)valid, n, shift, first, vec, mask, seed,
             k, (long long*)state, (int32_t*)hist_out, (int32_t*)partials,
             (unsigned int*)ticket};
  cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case kI64: return (int)launch<long long, true>(a, grid, s);
    case kI32: return (int)launch<int, true>(a, grid, s);
    case kF32: return (int)launch<float, true>(a, grid, s);
    case kF64: return (int)launch<double, true>(a, grid, s);
    case kU8: return (int)launch<uint8_t, true>(a, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The TPU kernel's contract: out [256] int32 = histogram of
// ((u >> shift) & 0xFF) over u [n] int32 where valid [n] bytes hold.
// The low 32 bits of an int32's order word are the value's own bits, so
// this is the pass kernel on int32 with no prefix test.
extern "C" int hist256_launch(const void* u, const void* valid, long long n,
                              int shift, int vec, void* out, void* partials,
                              void* ticket, int grid, void* stream) {
  if (n <= 0 || grid <= 0 || shift < 0 || shift > 24)
    return (int)cudaErrorInvalidValue;
  PassArgs a{u, (const uint8_t*)valid, n, shift, 1, vec, 0ull, 0ull, 0,
             nullptr, (int32_t*)out, (int32_t*)partials,
             (unsigned int*)ticket};
  return (int)launch<int, false>(a, grid, (cudaStream_t)stream);
}

extern "C" const char* hist256_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
