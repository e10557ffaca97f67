// The key group of an int64 key, shared by the sources that route or split
// rows by key group: hash_table.cu (the ingest step's spill split) and
// exchange.cu (the mesh's keyBy exchange).
//
// core/keygroups.py's murmur_mix of the Long.hashCode fold
// (v ^ (v >>> 32)), abs with INT_MIN -> 0, modulo max_parallelism: bit-equal
// to key_groups_for_hash_batch(hash_batch(keys), maxp), so snapshots and
// routing agree with the host and with the reference.
#pragma once

#include <climits>
#include <cstdint>

namespace keygroup {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ int key_group(unsigned long long u, int maxp) {
  uint32_t k = (uint32_t)(u ^ (u >> 32));
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  uint32_t h = rotl32(k, 13);
  h = h * 5u + 0xE6546B64u;
  h ^= 4u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  int v = (int)h;
  v = v == INT_MIN ? 0 : (v < 0 ? -v : v);
  return v % maxp;
}

}  // namespace keygroup
