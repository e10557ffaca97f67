// The incremental fire engine's two device programs: the pane seal and the
// window rebuild of the slice-window operator.
//
// Replaces (no Pallas kernel on the TPU; each was one XLA program):
//  * window_seal_launch: flink_tpu/runtime/operators/device_window.py::
//    _seal_program. Once per steady-state fire it seals the newest pane into
//    the running window state and writes this fire's merged view:
//    - an invertible plane (sum, count, the sum of an avg) keeps a
//      [capacity] window accumulator: view = win + pane[new_row], then
//      win = view - pane[sub_row] when the retiring pane holds data;
//    - a min/max plane keeps a heap-ordered merge tree [2L, capacity] over
//      per-pane leaves (node 0 the identity, node 1 the root, leaf of pane p
//      at L + p % L): the retiring pane's leaf goes back to the identity,
//      the new pane's leaf takes its row, both ancestor paths are
//      recomputed, and the view is the root.
//  * window_rebuild_launch: device_window.py::_rebuild_program. After a
//    restore, a jump of the fire boundary or a write into a sealed pane, it
//    rebuilds the same state and view from the window's live pane rows.
//
// Bound on the H100: device memory, by streaming. Slot s of every output
// depends only on slot s of the pane rows and of the state, so one thread
// per slot does every plane of the signature in one launch, and a warp's
// loads and stores are 32 neighbouring elements of one row: each access is
// coalesced. A seal reads the window (or the tree nodes it needs), the new
// pane row and the retiring row once, and writes the view and the state
// once: for Q5 (int32 count, int64 revenue) 60 B a slot. Nothing is reused
// across slots, so nothing is staged in shared memory.
//
// Design:
//  * The plane signature comes by value in one parameter struct (at most 8
//    planes: pointers, kind, the pane's dtype and the accumulator's dtype),
//    with the host ints: the new and retiring rows and leaves, sub_valid.
//    It is a __grid_constant__
//    parameter, so the loops index it at run time without a local copy.
//  * The rebuild's live rows and the ring row of each tree leaf come in a
//    small int32 device buffer (n_rows + L entries) that every thread reads
//    alike, so no ring or tree size is capped by the parameter space. The
//    seal needs no such list.
//  * A pane row is converted to the accumulator's dtype as it is loaded (an
//    int32 sum plane keeps an int64 window); integer adds wrap like torch's.
//  * W = 1 (tumbling windows): the retiring row is the new row, which is
//    read once, before any write.
//  * The tree seal walks the union of the two ancestor paths bottom-up,
//    reads each sibling once, keeps the path values in registers and writes
//    each changed node once. The rebuild writes every node once: leaves in
//    order, each completed parent from a per-level stack of left children.
//  * Float sums fold in the order the plain version uses (the window's rows
//    in pane order, then one add and one subtract per seal), so the kernel
//    and the plain version agree bit for bit. min/max propagate NaN, as
//    torch.minimum/maximum do.
#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;
constexpr int kMaxLeaves = 1 << 30;  // tree leaves L
constexpr int kMaxLevels = 31;       // log2(kMaxLeaves) + 1

enum Dtype { kI64 = 0, kI32 = 1, kF32 = 2, kF64 = 3 };
enum Kind { kSum = 0, kMin = 1, kMax = 2 };

struct SealPlane {
  const void* pane;  // [ring, cap] of pane_dtype
  void* state;       // window [cap] (kSum) or tree [2L, cap] (kMin, kMax)
  void* view;        // [cap]
  int kind;
  int pane_dtype;
  int acc_dtype;     // of state and view
};

struct SealArgs {
  long long cap;
  int n_planes;
  int tree_leaves;   // L, a power of two
  int new_row, sub_row, sub_valid;
  int new_leaf, old_leaf;
  int n_rows;
  const int* rows;      // device: the window's live ring rows, in pane order
  const int* leaf_row;  // device: ring row of each tree leaf, -1: identity
  SealPlane planes[kMaxPlanes];
};

template <typename T> struct Lim;
template <> struct Lim<long long> {
  __device__ static long long hi() { return LLONG_MAX; }
  __device__ static long long lo() { return LLONG_MIN; }
};
template <> struct Lim<int> {
  __device__ static int hi() { return INT_MAX; }
  __device__ static int lo() { return INT_MIN; }
};
template <> struct Lim<float> {
  __device__ static float hi() { return FLT_MAX; }
  __device__ static float lo() { return -FLT_MAX; }
};
template <> struct Lim<double> {
  __device__ static double hi() { return DBL_MAX; }
  __device__ static double lo() { return -DBL_MAX; }
};

// integer adds and subtracts wrap, as torch's do
__device__ __forceinline__ long long add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ int add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ long long sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ int sub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ float sub(float a, float b) { return a - b; }
__device__ __forceinline__ double sub(double a, double b) { return a - b; }

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

template <typename T>
__device__ __forceinline__ T combine(T a, T b, int kind) {
  if (kind == kSum) return add(a, b);
  if (is_nan(a)) return a;
  if (is_nan(b)) return b;
  if (kind == kMin) return b < a ? b : a;
  return b > a ? b : a;
}

template <typename T>
__device__ __forceinline__ T identity(int kind) {
  return kind == kSum ? (T)0 : kind == kMin ? Lim<T>::hi() : Lim<T>::lo();
}

// element i of a pane plane of dtype `code`, as T
template <typename T>
__device__ __forceinline__ T load_as(const void* p, int code, long long i) {
  switch (code) {
    case kI64: return (T)__ldg(static_cast<const long long*>(p) + i);
    case kI32: return (T)__ldg(static_cast<const int*>(p) + i);
    case kF32: return (T)__ldg(static_cast<const float*>(p) + i);
    default: return (T)__ldg(static_cast<const double*>(p) + i);
  }
}

template <typename T>
__device__ void seal_plane(const SealArgs& a, const SealPlane& pl,
                           long long s) {
  const long long cap = a.cap;
  T* state = static_cast<T*>(pl.state);
  T* view = static_cast<T*>(pl.view);
  const T nv = load_as<T>(pl.pane, pl.pane_dtype, a.new_row * cap + s);
  if (pl.kind == kSum) {
    T r = (T)0;
    if (a.sub_valid)
      r = a.sub_row == a.new_row
              ? nv : load_as<T>(pl.pane, pl.pane_dtype, a.sub_row * cap + s);
    const T v = add(state[s], nv);
    view[s] = v;
    state[s] = a.sub_valid ? sub(v, r) : v;
    return;
  }
  // the union of the two leaf-to-root paths, bottom-up
  int na = a.tree_leaves + a.old_leaf, nb = a.tree_leaves + a.new_leaf;
  T va = identity<T>(pl.kind), vb = nv;
  state[na * cap + s] = va;
  state[nb * cap + s] = vb;
  while (na > 1) {
    if (na == nb) {               // the paths have met
      va = combine(va, state[(na ^ 1) * cap + s], pl.kind);
      na >>= 1;
      state[na * cap + s] = va;
    } else if ((na ^ 1) == nb) {  // siblings: their parent joins the paths
      va = combine(va, vb, pl.kind);
      na >>= 1;
      state[na * cap + s] = va;
    } else {
      va = combine(va, state[(na ^ 1) * cap + s], pl.kind);
      vb = combine(vb, state[(nb ^ 1) * cap + s], pl.kind);
      na >>= 1;
      nb >>= 1;
      state[na * cap + s] = va;
      state[nb * cap + s] = vb;
      continue;
    }
    nb = na;
    vb = va;
  }
  view[s] = va;
}

template <typename T>
__device__ void rebuild_plane(const SealArgs& a, const SealPlane& pl,
                              long long s) {
  const long long cap = a.cap;
  T* state = static_cast<T*>(pl.state);
  T* view = static_cast<T*>(pl.view);
  if (pl.kind == kSum) {
    T acc = (T)0, r = (T)0;
    bool have_sub = false;
    for (int i = 0; i < a.n_rows; ++i) {
      const int row = __ldg(a.rows + i);
      const T x = load_as<T>(pl.pane, pl.pane_dtype, row * cap + s);
      acc = add(acc, x);
      if (row == a.sub_row) {
        r = x;
        have_sub = true;
      }
    }
    if (a.sub_valid && !have_sub)
      r = load_as<T>(pl.pane, pl.pane_dtype, a.sub_row * cap + s);
    view[s] = acc;
    state[s] = a.sub_valid ? sub(acc, r) : acc;
    return;
  }
  // leaves in order; a right child completes its parent, whose left child
  // waits on the stack of its level
  const int L = a.tree_leaves;
  const T ident = identity<T>(pl.kind);
  T left[kMaxLevels];
  T v = ident;
  for (int j = 0; j < L; ++j) {
    const int row = __ldg(a.leaf_row + j);
    v = row >= 0 ? load_as<T>(pl.pane, pl.pane_dtype, row * cap + s) : ident;
    int node = L + j, lvl = 0;
    state[node * cap + s] = v;
    while ((node & 1) && node > 1) {
      v = combine(left[lvl], v, pl.kind);
      node >>= 1;
      ++lvl;
      state[node * cap + s] = v;
    }
    left[lvl] = v;
  }
  state[s] = ident;  // node 0
  view[s] = v;       // the last value completed is the root's
}

template <bool kSeal>
__global__ void __launch_bounds__(kThreads)
window_kernel(const __grid_constant__ SealArgs a) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= a.cap) return;
  for (int q = 0; q < a.n_planes; ++q) {
    const SealPlane& pl = a.planes[q];
    switch (pl.acc_dtype) {
      case kI64:
        kSeal ? seal_plane<long long>(a, pl, s)
              : rebuild_plane<long long>(a, pl, s);
        break;
      case kI32:
        kSeal ? seal_plane<int>(a, pl, s) : rebuild_plane<int>(a, pl, s);
        break;
      case kF32:
        kSeal ? seal_plane<float>(a, pl, s) : rebuild_plane<float>(a, pl, s);
        break;
      default:
        kSeal ? seal_plane<double>(a, pl, s)
              : rebuild_plane<double>(a, pl, s);
        break;
    }
  }
}

// fills and checks what both entries share; false: an argument is invalid
bool set_planes(SealArgs& a, long long cap, int n_planes, long long ring,
                int tree_leaves, void* const* pane, void* const* state,
                void* const* view, const int* kind, const int* pane_dtype,
                const int* acc_dtype) {
  if (cap <= 0 || n_planes < 1 || n_planes > kMaxPlanes || ring < 1 ||
      ring > INT_MAX || tree_leaves < 1 || tree_leaves > kMaxLeaves ||
      (tree_leaves & (tree_leaves - 1)))
    return false;
  a.cap = cap;
  a.n_planes = n_planes;
  a.tree_leaves = tree_leaves;
  for (int q = 0; q < n_planes; ++q) {
    if (kind[q] < kSum || kind[q] > kMax || pane_dtype[q] < kI64 ||
        pane_dtype[q] > kF64 || acc_dtype[q] < kI64 || acc_dtype[q] > kF64)
      return false;
    a.planes[q] = SealPlane{pane[q], state[q], view[q], kind[q],
                            pane_dtype[q], acc_dtype[q]};
  }
  return true;
}

template <bool kSeal>
cudaError_t launch(const SealArgs& a, cudaStream_t stream) {
  const long long blocks = (a.cap + kThreads - 1) / kThreads;
  window_kernel<kSeal><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plane q: pane[q] a [ring, cap] buffer of pane_dtype[q]; state[q] a [cap]
// window (kind 0: sum and count) or a [2 * tree_leaves, cap] merge tree
// (kind 1 min, 2 max) of acc_dtype[q]; view[q] a [cap] output of
// acc_dtype[q]. Dtype codes: 0 int64, 1 int32, 2 float32, 3 float64.
// The new pane sits at ring row new_row and tree leaf new_leaf; the pane
// that retires sits at ring row sub_row (subtracted when sub_valid) and at
// leaf old_leaf. Returns cudaGetLastError.
extern "C" int window_seal_launch(
    long long cap, long long ring, int n_planes, void* const* pane,
    void* const* state, void* const* view, const int* kind,
    const int* pane_dtype, const int* acc_dtype, int tree_leaves,
    int new_row, int sub_row, int sub_valid, int new_leaf, int old_leaf,
    void* stream) {
  SealArgs a{};
  if (!set_planes(a, cap, n_planes, ring, tree_leaves, pane, state, view,
                  kind, pane_dtype, acc_dtype) ||
      new_row < 0 || new_row >= ring || sub_row < 0 || sub_row >= ring ||
      new_leaf < 0 || new_leaf >= tree_leaves || old_leaf < 0 ||
      old_leaf >= tree_leaves || new_leaf == old_leaf)
    return (int)cudaErrorInvalidValue;
  a.new_row = new_row;
  a.sub_row = sub_row;
  a.sub_valid = sub_valid != 0;
  a.new_leaf = new_leaf;
  a.old_leaf = old_leaf;
  return (int)launch<true>(a, (cudaStream_t)stream);
}

// The same planes; index a device int32 buffer of n_rows + tree_leaves
// entries: first the window's live ring rows in pane order, each in
// [0, ring), then for each tree leaf the ring row it holds, or -1 for the
// identity (the caller checks the entries; the kernel reads them as given).
// Returns cudaGetLastError.
extern "C" int window_rebuild_launch(
    long long cap, long long ring, int n_planes, void* const* pane,
    void* const* state, void* const* view, const int* kind,
    const int* pane_dtype, const int* acc_dtype, int tree_leaves, int n_rows,
    const int* index, int sub_row, int sub_valid, void* stream) {
  SealArgs a{};
  if (!set_planes(a, cap, n_planes, ring, tree_leaves, pane, state, view,
                  kind, pane_dtype, acc_dtype) ||
      n_rows < 0 || n_rows > ring || sub_row < 0 || sub_row >= ring ||
      index == nullptr)
    return (int)cudaErrorInvalidValue;
  a.n_rows = n_rows;
  a.rows = index;
  a.leaf_row = index + n_rows;
  a.sub_row = sub_row;
  a.sub_valid = sub_valid != 0;
  return (int)launch<false>(a, (cudaStream_t)stream);
}

extern "C" const char* window_seal_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
