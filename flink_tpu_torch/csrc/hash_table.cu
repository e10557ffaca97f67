// Device hash table probe: int64 key -> dense slot, find-or-claim.
//
// Replaces: flink_tpu/ops/hash_table.py::lookup_or_insert and ::lookup.
// On the TPU these were XLA while-loops (no Pallas kernel): each round
// gathered an 8-slot probe window for every unresolved key and claimed
// empty slots with a scatter-min. Eager PyTorch has no loop that runs on
// the device, so a port in torch ops would sync with the host once per
// probe round on every batch; this kernel resolves a whole batch in one
// launch with no host round trip.
//
// Bound on the H100: device memory, by random access. Each key reads its
// 8-byte key, touches one random 32-byte sector of the table (most keys
// resolve at their first probe at the load factors the backend keeps,
// <= 0.6) and writes a 4-byte slot and a 1-byte ok flag: about 45 B per
// key, 23.6 MB (7 us at 3.35 TB/s) for a 2^19-key batch. The table is
// 2^21..2^24 x 8 B, far above what the 50 MB L2 can keep for 2^24.
//
// Design: one thread per key. The slot hash is the murmur finalizer of
// hash_keys_device, in uint32, and probing is linear up to MAX_PROBES
// slots. An empty slot is claimed with a 64-bit atomicCAS from EMPTY_KEY:
//  * CAS won, or lost to the same key (a duplicate in the batch): found;
//  * lost to another key: keep probing.
// Slots only ever go EMPTY -> key, so a stale read of EMPTY is corrected
// by the CAS and a present key can never sit behind an empty slot in its
// probe sequence. The slot layout differs from the reference's scatter-
// min (the winner among racing keys is whoever's CAS lands first); the
// set of keys, key -> slot consistency and the ok contract are the same.
// Rows whose valid byte is 0 never probe (slot -1, ok 0); a key that
// exhausts MAX_PROBES reports slot -1, ok 0 so the host can grow.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = 0x7FFFFFFFFFFFFFFFull;  // int64 max
constexpr int kMaxProbes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t probe_hash(unsigned long long u) {
  uint32_t h = (uint32_t)(u ^ (u >> 32));
  h *= 0xCC9E2D51u;
  h = (h << 15) | (h >> 17);
  h *= 0x1B873593u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

__global__ void __launch_bounds__(kThreads)
hash_probe_kernel(unsigned long long* __restrict__ table,
                  unsigned long long mask,
                  const unsigned long long* __restrict__ keys,
                  const uint8_t* __restrict__ valid, long long n, int insert,
                  int32_t* __restrict__ slots, uint8_t* __restrict__ ok) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int32_t slot = -1;
  if (valid == nullptr || valid[i]) {
    const unsigned long long key = keys[i];
    const uint32_t h = probe_hash(key);
    for (int p = 0; p < kMaxProbes; ++p) {
      const unsigned long long s = (unsigned long long)(h + (uint32_t)p) & mask;
      const unsigned long long cur = table[s];
      if (cur == key) {
        slot = (int32_t)s;
        break;
      }
      if (cur == kEmpty) {
        if (!insert) break;  // first empty before any match: absent
        const unsigned long long prev = atomicCAS(&table[s], kEmpty, key);
        if (prev == kEmpty || prev == key) {
          slot = (int32_t)s;
          break;
        }
      }
    }
  }
  slots[i] = slot;
  if (ok != nullptr) ok[i] = slot >= 0 ? 1 : 0;
}

}  // namespace

// table: [capacity] int64 (power of two), updated in place when insert != 0.
// keys: [n] int64. valid: [n] bytes or null. slots: [n] int32 out.
// ok: [n] bytes out or null. Returns cudaGetLastError.
extern "C" int hash_probe_launch(void* table, long long capacity,
                                 const void* keys, const void* valid,
                                 long long n, int insert, void* slots,
                                 void* ok, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const long long blocks = (n + kThreads - 1) / kThreads;
  hash_probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (unsigned long long*)table, (unsigned long long)(capacity - 1),
      (const unsigned long long*)keys, (const uint8_t*)valid, n, insert,
      (int32_t*)slots, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

extern "C" const char* hash_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
