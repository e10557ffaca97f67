"""Key groups: the unit of keyed-state sharding (numpy).

Copy of the batch paths of ``flink_tpu/core/keygroups.py``. Snapshots
carry each key's group, so ``murmur_mix``, ``hash_batch`` and
``key_groups_for_hash_batch`` must stay bit-exact with the reference:
``key_group = murmur(hash(key)) % max_parallelism``, and subtask ``i`` of
``p`` owns ``[ceil(i*maxp/p), floor(((i+1)*maxp - 1)/p)]``.

``key_groups_device`` is the same map on torch int64 tensors (the port of
``flink_tpu/parallel/mesh.py::key_groups_device``): the canonical
snapshot order is computed with it on the card, and it is the plain
version of the group hash inside the ingest kernel's spill split.
"""

from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

__all__ = ["KeyGroupRange", "murmur_mix",
           "hash_batch", "key_groups_for_hash_batch",
           "key_group_range_for_operator", "key_groups_device"]

_C1 = np.uint32(0xCC9E2D51)
_C2 = np.uint32(0x1B873593)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def murmur_mix(code: "np.ndarray | int") -> "np.ndarray | int":
    """Murmur3_32 single-int round + finalizer, then abs() with MIN -> 0.
    Accepts scalars or uint32/int arrays."""
    scalar = np.isscalar(code) or (isinstance(code, np.ndarray)
                                   and code.ndim == 0)
    k = np.asarray(code, dtype=np.uint32)
    with np.errstate(over="ignore"):
        k = k * _C1
        k = _rotl32(k, 15)
        k = k * _C2
        h = _rotl32(k, 13)
        h = h * np.uint32(5) + np.uint32(0xE6546B64)
        h = h ^ np.uint32(4)  # len(bytes) == 4
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        h = h ^ (h >> np.uint32(16))
    out = h.astype(np.int32)
    out = np.where(out == np.int32(-2147483648), np.int32(0), np.abs(out))
    return int(out) if scalar else out


def key_group_range_for_operator(max_parallelism: int, parallelism: int,
                                 operator_index: int) -> "KeyGroupRange":
    start = (operator_index * max_parallelism + parallelism - 1) // parallelism
    end = ((operator_index + 1) * max_parallelism - 1) // parallelism
    return KeyGroupRange(start, end)


@dataclass(frozen=True, order=True)
class KeyGroupRange:
    """Inclusive contiguous range of key groups."""

    start: int
    end: int  # inclusive

    def __post_init__(self):
        if self.end < self.start and not (self.start == 0 and self.end == -1):
            raise ValueError(f"Invalid key group range [{self.start}, {self.end}]")

    def __contains__(self, key_group: int) -> bool:
        return self.start <= key_group <= self.end


def hash_batch(keys: np.ndarray) -> np.ndarray:
    """uint32 hash of int64 keys: the Long.hashCode fold v ^ (v >>> 32)."""
    u = np.asarray(keys).astype(np.int64).view(np.uint64)
    return ((u ^ (u >> np.uint64(32))) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def key_groups_for_hash_batch(hashes: np.ndarray,
                              max_parallelism: int) -> np.ndarray:
    """uint32 hashes -> int32 key groups."""
    return (murmur_mix(hashes.astype(np.uint32))
            % np.int32(max_parallelism)).astype(np.int32)


_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) in int64, split at 16 bits so
    no partial product overflows."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _rotl32_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def key_groups_device(keys: torch.Tensor,
                      max_parallelism: int) -> torch.Tensor:
    """int64 keys -> int32 key groups on the keys' device, bit-equal to
    ``key_groups_for_hash_batch(hash_batch(keys), max_parallelism)``:
    the Long.hashCode fold and the murmur round in int64 with 32-bit
    masks (torch has no uint32 multiply to trust)."""
    u = keys.to(torch.int64)
    k = (u ^ ((u >> 32) & _M32)) & _M32
    k = _mul32(k, 0xCC9E2D51)
    k = _rotl32_t(k, 15)
    k = _mul32(k, 0x1B873593)
    h = _rotl32_t(k, 13)
    h = (_mul32(h, 5) + 0xE6546B64) & _M32
    h = h ^ 4
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    # int32 reinterpretation, abs with MIN -> 0
    s = torch.where(h >= (1 << 31), h - (1 << 32), h)
    s = torch.where(s == -(1 << 31), torch.zeros_like(s), s.abs())
    return (s % max_parallelism).to(torch.int32)
