"""Device open-addressing hash table: int64 key -> dense slot.

Port of ``flink_tpu/ops/hash_table.py``. The table is a power-of-two
``[capacity]`` int64 tensor with ``EMPTY_KEY`` (int64 max) in free slots;
keyed state lives in dense planes indexed by slot.

* On a CUDA tensor ``lookup_or_insert`` / ``lookup`` launch the
  hand-written probe kernel (``csrc/hash_table.cu``): one thread per key,
  linear probing, 64-bit ``atomicCAS`` claims. One launch per batch, no
  host round trip. The table is updated IN PLACE (the returned table is
  the tensor passed in).
* On a CPU tensor they run the plain version: the reference's algorithm
  (8-slot probe windows, claims by scatter-min, smallest key wins) as a
  host loop over probe rounds, which is fine on the CPU and gives the
  reference's slot layout.

Contract (both): rows where ``valid`` is False never probe (slot -1, ok
False); a key that exhausts ``MAX_PROBES`` reports ok False, slot -1, and
the caller grows the table. ``hash_keys_device`` is bit-equal to the
reference's uint32 murmur finalizer, computed in int64 with 32-bit masks
(torch has no uint32/uint64 multiply it can be trusted with).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import note_launch

__all__ = ["EMPTY_KEY", "MAX_PROBES", "sanitize_keys_device", "make_table",
           "hash_keys_device", "lookup", "lookup_or_insert",
           "lookup_or_insert_plain", "lookup_plain"]

EMPTY_KEY = int(np.iinfo(np.int64).max)
MAX_PROBES = 128
CHUNK = 8  # plain version: probe-window width, as in the reference
_M32 = 0xFFFFFFFF


def sanitize_keys_device(keys: torch.Tensor) -> torch.Tensor:
    """Remap the EMPTY sentinel (int64 max) to int64 max - 1."""
    keys = keys.to(torch.int64)
    return torch.where(keys == EMPTY_KEY, EMPTY_KEY - 1, keys)


def make_table(capacity: int, device) -> torch.Tensor:
    """capacity must be a power of two."""
    if capacity <= 0 or capacity & (capacity - 1):
        raise ValueError(f"capacity {capacity} not a power of two")
    return torch.full((capacity,), EMPTY_KEY, dtype=torch.int64,
                      device=device)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), without int64 overflow: the
    product is split at 16 bits so no partial exceeds 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keys_device(keys: torch.Tensor) -> torch.Tensor:
    """Murmur-style finalizer over int64 keys; returns int64 tensors
    holding the reference's uint32 hash values (bit-equal)."""
    u = keys.to(torch.int64)
    h = (u ^ (u >> 32)) & _M32
    h = _mul32(h, 0xCC9E2D51)
    h = ((h << 15) | (h >> 17)) & _M32
    h = _mul32(h, 0x1B873593)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h


def _check(table: torch.Tensor, keys: torch.Tensor,
           valid: Optional[torch.Tensor]) -> None:
    if table.dtype != torch.int64 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D int64 tensor")
    cap = table.numel()
    if cap & (cap - 1):
        raise ValueError(f"table capacity {cap} not a power of two")
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 1-D int64 tensor")
    if keys.device != table.device:
        raise ValueError("keys and table must be on one device")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != keys.shape
                              or valid.device != keys.device
                              or not valid.is_contiguous()):
        raise ValueError("valid must be a contiguous bool tensor shaped "
                         "like keys, on the keys' device")


def _probe_cuda(table, keys, valid, insert: bool):
    from . import kernels

    n = keys.numel()
    slots = torch.empty(n, dtype=torch.int32, device=keys.device)
    ok = torch.empty(n, dtype=torch.bool, device=keys.device) \
        if insert else None
    if n:
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = kernels.library("hash_table").hash_probe_launch(
            table.data_ptr(), table.numel(), keys.data_ptr(),
            valid.data_ptr() if valid is not None else None, n,
            1 if insert else 0, slots.data_ptr(),
            ok.data_ptr() if ok is not None else None, stream)
        kernels.check("hash_table", rc)
        note_launch("hash_probe")
    return slots, ok


def lookup_or_insert(table: torch.Tensor, keys: torch.Tensor,
                     valid: Optional[torch.Tensor] = None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Find-or-claim slots for a batch of keys; ``table`` is updated in
    place. Returns (table, slots int32, ok bool)."""
    _check(table, keys, valid)
    if table.device.type == "cpu":
        return lookup_or_insert_plain(table, keys, valid)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    slots, ok = _probe_cuda(table, keys, valid, insert=True)
    return table, slots, ok


def lookup(table: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Slots for keys; -1 where absent."""
    _check(table, keys, None)
    if table.device.type == "cpu":
        return lookup_plain(table, keys)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    slots, _ = _probe_cuda(table, keys, None, insert=False)
    return slots


def _windows(table, keys, h0, base, mask):
    """One probe round: the [n, CHUNK] window of slots per key, with the
    first matching and first empty position in each."""
    offs = torch.arange(CHUNK, dtype=torch.int64, device=keys.device)
    idx = ((h0 + base)[:, None] + offs[None, :]) & mask
    entry = table[idx]
    rng = offs[None, :]
    pos_found = torch.where(entry == keys[:, None], rng, CHUNK).amin(1)
    pos_empty = torch.where(entry == EMPTY_KEY, rng, CHUNK).amin(1)
    return idx, pos_found, pos_empty


def lookup_or_insert_plain(table, keys, valid=None):
    """Plain version: the reference's probe rounds, looped on the host
    (one host sync per round; any device)."""
    mask = table.numel() - 1
    h0 = hash_keys_device(keys) & mask
    n = keys.numel()
    dev = keys.device
    base = torch.zeros(n, dtype=torch.int64, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    done = (torch.zeros(n, dtype=torch.bool, device=dev) if valid is None
            else ~valid)
    while bool(((~done) & (base < MAX_PROBES)).any()):
        idx, pos_found, pos_empty = _windows(table, keys, h0, base, mask)
        found = ~done & (pos_found < pos_empty)
        fslot = idx.gather(1, pos_found.clamp(max=CHUNK - 1)[:, None])[:, 0]
        want = ~done & ~found & (pos_empty < CHUNK)
        cslot = idx.gather(1, pos_empty.clamp(max=CHUNK - 1)[:, None])[:, 0]
        table.scatter_reduce_(0, torch.where(want, cslot, 0),
                              torch.where(want, keys, EMPTY_KEY), "amin")
        won = want & (table[cslot] == keys)
        slot = torch.where(found, fslot, slot)
        slot = torch.where(won, cslot, slot)
        done = done | found | won
        base = torch.where(done, base,
                           base + torch.where(want, pos_empty, CHUNK))
    return table, slot.to(torch.int32), done & (slot >= 0)


def lookup_plain(table, keys):
    """Plain version of ``lookup`` (first empty before a match: absent)."""
    mask = table.numel() - 1
    h0 = hash_keys_device(keys) & mask
    n = keys.numel()
    dev = keys.device
    base = torch.zeros(n, dtype=torch.int64, device=dev)
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    while bool(((~done) & (base < MAX_PROBES)).any()):
        idx, pos_found, pos_empty = _windows(table, keys, h0, base, mask)
        found = ~done & (pos_found < pos_empty)
        fslot = idx.gather(1, pos_found.clamp(max=CHUNK - 1)[:, None])[:, 0]
        slot = torch.where(found, fslot, slot)
        done = done | found | (pos_empty < CHUNK)
        base = torch.where(done, base, base + CHUNK)
    return slot.to(torch.int32)
