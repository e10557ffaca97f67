// The device hash table's probe, shared by every source that resolves an
// int64 key to its dense slot: hash_table.cu (the probe and the slice
// window's ingest step) and session_window.cu (the session step).
//
// The table is a power-of-two [capacity] int64 array, EMPTY_KEY (int64
// max) in free slots. The slot hash is the murmur finalizer of
// ops/hash_table.py::hash_keys_device, in uint32; probing is linear up to
// MAX_PROBES slots. An empty slot is claimed with a 64-bit atomicCAS from
// EMPTY_KEY:
//  * CAS won, or lost to the same key (a duplicate in the batch): found;
//  * lost to another key: keep probing.
// Slots only ever go EMPTY -> key, so a stale read of EMPTY is corrected
// by the CAS and a present key never sits behind an empty slot in its
// probe sequence.
#pragma once

#include <cstdint>

namespace probe_table {

constexpr unsigned long long kEmpty = 0x7FFFFFFFFFFFFFFFull;  // int64 max
constexpr int kMaxProbes = 128;

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

// The slot of `key`, or -1: absent (insert == false: the first empty
// slot before any match), or MAX_PROBES slots full of other keys.
// `claimed` is set when this call's CAS took the slot from EMPTY: the
// slot was never a key's before.
__device__ __forceinline__ int probe_claim(unsigned long long* table,
                                           unsigned long long mask,
                                           unsigned long long key,
                                           bool insert, bool& claimed) {
  const uint32_t h = probe_hash(key);
  claimed = false;
  for (int p = 0; p < kMaxProbes; ++p) {
    const unsigned long long s = (h + (uint32_t)p) & mask;
    const unsigned long long cur = __ldcg(table + s);
    if (cur == key) return (int)s;
    if (cur == kEmpty) {
      if (!insert) return -1;
      const unsigned long long prev = atomicCAS(table + s, kEmpty, key);
      claimed = prev == kEmpty;
      if (prev == kEmpty || prev == key) return (int)s;
    }
  }
  return -1;
}

__device__ __forceinline__ int probe(unsigned long long* table,
                                     unsigned long long mask,
                                     unsigned long long key, bool insert) {
  bool claimed;
  return probe_claim(table, mask, key, insert, claimed);
}

}  // namespace probe_table
