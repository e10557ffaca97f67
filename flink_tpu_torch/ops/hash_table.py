"""Device open-addressing hash table: int64 key -> dense slot, and the
fused ingest step built on it.

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
* ``ingest_step`` is the slice-window operator's whole per-batch step
  (the reference's ``_step_body``): pane and late mask, key sanitising,
  lookup-or-insert and one fold per aggregate plane into ``[ring,
  capacity]`` planes, with the late and dropped rows counted on the
  device. Two optional parts: dirty marking of the snapshot's slot blocks
  (``dirty``), and the deferred-spill split under an HBM budget
  (``spill``, a ``StepSpill``): rows of spilled key groups and failed
  inserts go to staging buffers for the host tier, and a per-group clock
  records the batch. On a CUDA tensor it is one launch of the same
  source's fused kernel (the spill form's zeroes its look-back words
  first); its plain version is the chain of the probe's plain version and
  ``scatter_fold`` per plane. Both stage in batch order, as the reference
  does. A third part, the counted form (``segments``), reads a
  destination shard's buffer from the mesh's keyBy exchange
  (``ops/exchange.py``): S segments of rows, each holding at its front the
  count of rows the exchange left on the device, so the step needs no host
  read of the counts and no round loop.

Contract (both): rows where ``valid`` is False never probe (slot -1, ok
False); a key that exhausts ``MAX_PROBES`` reports ok False, slot -1, and
the caller grows the table. ``hash_keys_device`` is bit-equal to the
reference's uint32 murmur finalizer, computed in int64 with 32-bit masks
(torch has no uint32/uint64 multiply it can be trusted with).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.keygroups import key_groups_device
from ..device import note_launch
from .segment_ops import scatter_fold

__all__ = ["EMPTY_KEY", "MAX_PROBES", "sanitize_keys_device", "make_table",
           "ordered_table",
           "hash_keys_device", "lookup", "lookup_or_insert",
           "lookup_or_insert_plain", "lookup_plain", "ingest_step",
           "ingest_step_plain", "StepSpill", "step_cost"]

EMPTY_KEY = int(np.iinfo(np.int64).max)
MAX_PROBES = 128


def step_cost(n: int, capacity: int, ring: int, plane_sizes: tuple,
              column_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of one ingest step over ``n`` rows, from the shapes
    alone (the device-time ledger's cost model; the step's ledger samples
    carry (rows, capacity, ring, plane item sizes, column item sizes)):
    every column read once
    (timestamps, keys, each value column), each row's table slot read once
    (8 bytes) and its element of every plane read and written once;
    operations: one hash and one fold a plane per row. The table's and the
    planes' sizes do not enter: a step touches at most ``n`` slots."""
    return (n * (1 + len(plane_sizes)),
            n * (sum(column_sizes) + 8 + 2 * sum(plane_sizes)))
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


def ordered_table(keys: torch.Tensor, capacity: int
                  ) -> Optional[tuple[torch.Tensor, torch.Tensor]]:
    """A table of ``capacity`` holding the distinct ``keys`` in home-slot
    order, and the keys' int64 slots; None when a key would sit
    ``MAX_PROBES`` or more past its home.

    Each key takes the first free slot at or after its home in the order
    of the homes: slot_i = max(home_i, slot_(i-1) + 1), a prefix maximum,
    so no probe runs and no claim order enters. This layout displaces no
    key further than any linear-probe layout of the same keys can (the
    greedy in order of the homes minimises the largest displacement), so
    keys that one table held within the probe window fit again at the same
    capacity, whatever order a probe would claim them in. Every slot from
    a key's home to its own is taken, so lookups that stop at an empty
    slot find it. Keys pushed past the end wrap to the front; the carry
    into slot 0 is iterated to its fixed point."""
    n = keys.numel()
    dev = keys.device
    table = make_table(capacity, dev)
    if n == 0:
        return table, torch.empty(0, dtype=torch.int64, device=dev)
    if n > capacity:
        return None
    home = hash_keys_device(keys).to(dev) & (capacity - 1)
    order = torch.argsort(home, stable=True)
    h = home[order]
    i = torch.arange(n, dtype=torch.int64, device=dev)
    reach = torch.cummax(h - i, 0).values      # max over j <= i of h_j - j
    carry = 0   # slots [0, carry) hold the keys that wrapped
    for _ in range(64):
        pos = i + reach.clamp(min=carry)
        wrapped = int((pos >= capacity).sum())
        if wrapped == carry:
            break
        carry = wrapped
    else:
        return None
    if int((pos - h).max()) >= MAX_PROBES:
        return None
    slot = pos & (capacity - 1)
    table[slot] = keys[order]
    slots = torch.empty(n, dtype=torch.int64, device=dev)
    slots[order] = slot
    return table, slots


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), without int64 overflow: the
    product is split at 16 bits so no partial exceeds 2^49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_keys_device(keys: torch.Tensor) -> torch.Tensor:
    """Murmur-style finalizer over int64 keys; returns int64 tensors
    holding the reference's uint32 hash values (bit-equal). On a CPU
    tensor the same steps run in numpy's wrapping uint32."""
    if keys.device.type == "cpu":
        u = keys.to(torch.int64).numpy().view(np.uint64)
        h = ((u ^ (u >> np.uint64(32))) & np.uint64(_M32)).astype(np.uint32)
        h *= np.uint32(0xCC9E2D51)
        h = (h << np.uint32(15)) | (h >> np.uint32(17))
        h *= np.uint32(0x1B873593)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        return torch.from_numpy(h.astype(np.int64))
    u = keys.to(torch.int64)
    h = (u ^ (u >> 32)) & _M32
    h = _mul32(h, 0xCC9E2D51)
    h = ((h << 15) | (h >> 17)) & _M32
    h = _mul32(h, 0x1B873593)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h


def _check_table(table: torch.Tensor) -> None:
    if table.dtype != torch.int64 or table.dim() != 1 \
            or not table.is_contiguous():
        raise ValueError("table must be a contiguous 1-D int64 tensor")
    cap = table.numel()
    if cap & (cap - 1):
        raise ValueError(f"table capacity {cap} not a power of two")


def _check(table: torch.Tensor, keys: torch.Tensor,
           valid: Optional[torch.Tensor]) -> None:
    _check_table(table)
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
    # positions in uint8: the reduction over 8 columns is many times
    # cheaper than in int64 on the CPU
    rng = offs.to(torch.uint8)[None, :]
    none = torch.full((), CHUNK, dtype=torch.uint8, device=keys.device)
    pos_found = torch.where(entry == keys[:, None], rng, none).amin(1)
    pos_empty = torch.where(entry == EMPTY_KEY, rng, none).amin(1)
    return idx, pos_found.long(), pos_empty.long()


def lookup_or_insert_plain(table, keys, valid=None):
    """Plain version: the reference's probe rounds, looped on the host
    (one host sync per round; any device). Each round works on the rows
    still unresolved only, which changes no claim: a resolved row neither
    probes nor claims again."""
    mask = table.numel() - 1
    n = keys.numel()
    dev = keys.device
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pend = (torch.arange(n, device=dev) if valid is None
            else torch.nonzero(valid).flatten())
    k = keys[pend]
    h0 = hash_keys_device(k) & mask
    base = torch.zeros(pend.numel(), dtype=torch.int64, device=dev)
    while pend.numel() and bool((base < MAX_PROBES).any()):
        idx, pos_found, pos_empty = _windows(table, k, h0, base, mask)
        found = pos_found < pos_empty
        fslot = idx.gather(1, pos_found.clamp(max=CHUNK - 1)[:, None])[:, 0]
        want = ~found & (pos_empty < CHUNK)
        cslot = idx.gather(1, pos_empty.clamp(max=CHUNK - 1)[:, None])[:, 0]
        table.scatter_reduce_(0, cslot[want], k[want], "amin")
        won = want & (table[cslot] == k)
        slot[pend[found]] = fslot[found]
        slot[pend[won]] = cslot[won]
        keep = ~(found | won)
        base = (base + torch.where(want, pos_empty, CHUNK))[keep]
        pend, k, h0 = pend[keep], k[keep], h0[keep]
    return table, slot.to(torch.int32), slot >= 0


def lookup_plain(table, keys):
    """Plain version of ``lookup`` (first empty before a match: absent),
    each round on the rows still unresolved."""
    mask = table.numel() - 1
    n = keys.numel()
    dev = keys.device
    slot = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pend = torch.arange(n, device=dev)
    k = keys
    h0 = hash_keys_device(k) & mask
    base = torch.zeros(n, dtype=torch.int64, device=dev)
    while pend.numel() and bool((base < MAX_PROBES).any()):
        idx, pos_found, pos_empty = _windows(table, k, h0, base, mask)
        found = pos_found < pos_empty
        fslot = idx.gather(1, pos_found.clamp(max=CHUNK - 1)[:, None])[:, 0]
        slot[pend[found]] = fslot[found]
        keep = ~(found | (pos_empty < CHUNK))
        base = (base + CHUNK)[keep]
        pend, k, h0 = pend[keep], k[keep], h0[keep]
    return slot.to(torch.int32)


@dataclass
class StepSpill:
    """The deferred-spill part of an ingest step (HBM budget): ``spilled``
    [max_parallelism] bool marks the key groups on the host; ``touch``
    [max_parallelism] int64 takes max(``batch_no``) over every row's
    group; ``count`` is the int64 device scalar of rows staged so far (it
    keeps counting past the capacity); ``keys`` [S] int64 and ``ring`` [S]
    int32 take the staged rows' keys and ring rows, and ``values[q]`` [S]
    plane q's value in the plane's dtype (None for the count plane)."""

    spilled: torch.Tensor
    touch: torch.Tensor
    batch_no: int
    count: torch.Tensor
    keys: torch.Tensor
    ring: torch.Tensor
    values: list

    @property
    def max_parallelism(self) -> int:
        return self.spilled.numel()


#: torch dtype -> dtype code of csrc/hash_table.cu
_CODES = {torch.int64: 0, torch.int32: 1, torch.float32: 2,
          torch.float64: 3, torch.uint8: 4, torch.bool: 5}
#: aggregate kind -> fold code of csrc/hash_table.cu (a count adds +1)
_KINDS = {"sum": 0, "count": 0, "min": 1, "max": 2}
_MAX_PLANES, _MAX_COLS = 8, 7


def _check_step(table, planes, ts, keys, first_open, late, dropped) -> None:
    dev = table.device
    _check_table(table)
    if ts.dtype != torch.int64 or ts.dim() != 1 or not ts.is_contiguous():
        raise ValueError("ts must be a contiguous 1-D int64 tensor")
    if keys.dtype not in (torch.int64, torch.int32, torch.uint8, torch.bool) \
            or keys.shape != ts.shape or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous integer tensor shaped "
                         "like ts")
    if not 0 < len(planes) <= _MAX_PLANES:
        raise ValueError(f"1 to {_MAX_PLANES} planes, not {len(planes)}")
    ring = planes[0][1].shape[0]
    for kind, arr, values in planes:
        # no bool plane: the eager fold has no min/max identity for one and
        # its sum promotes to int64
        if kind not in _KINDS or arr.dtype not in _CODES \
                or arr.dtype == torch.bool \
                or arr.shape != (ring, table.numel()) \
                or not arr.is_contiguous() or arr.device != dev:
            raise ValueError(f"plane ({kind}, {arr.dtype}, "
                             f"{tuple(arr.shape)}) is not a contiguous "
                             f"[{ring}, {table.numel()}] plane of a known "
                             "kind and dtype on the table's device")
        if values is not None and (values.dtype not in _CODES
                                   or values.shape != ts.shape
                                   or not values.is_contiguous()
                                   or values.device != dev):
            raise ValueError("values must be contiguous and shaped like ts")
    for t in (ts, keys, late, dropped):
        if t.device != dev:
            raise ValueError("every input must be on the table's device")
    for c in (late, dropped):
        if c.dtype != torch.int64 or c.numel() != 1:
            raise ValueError("late and dropped must be int64 scalars")
    if isinstance(first_open, torch.Tensor) and (
            first_open.dtype != torch.int64 or first_open.dim() != 0
            or first_open.device != dev):
        raise ValueError("first_open is an int or a 0-d int64 tensor on the "
                         "table's device")


def _check_segments(ts, segments, spill) -> int:
    """The counted form's (counts, seg_len): ``counts`` a 1-D int64 view
    on the table's device (one count a segment, any stride), the rows
    ``len(counts) * seg_len``. Returns the stride of ``counts``."""
    counts = segments
    if (counts.dtype != torch.int64 or counts.dim() != 1
            or counts.device != ts.device or counts.numel() == 0
            or ts.numel() % counts.numel() or spill is not None):
        raise ValueError("segments: a 1-D int64 tensor of one count a "
                         "segment, on the table's device, dividing the rows "
                         "evenly; not with the spill split")
    return counts.stride(0)


def _check_parts(table, planes, dirty, dirty_shift, spill) -> None:
    dev = table.device
    if dirty is not None and (
            dirty.dtype != torch.uint8 or dirty.dim() != 1
            or not dirty.is_contiguous() or dirty.device != dev
            or not 0 <= dirty_shift <= 30
            or dirty.numel() < (table.numel() + (1 << dirty_shift) - 1)
            >> dirty_shift):
        raise ValueError("dirty must be a contiguous uint8 tensor of one "
                         "byte per block of 2^dirty_shift slots, on the "
                         "table's device")
    if spill is None:
        return
    S = spill.keys.numel()
    ok = (spill.spilled.dtype == torch.bool and spill.spilled.dim() == 1
          and spill.spilled.numel() > 0
          and spill.touch.dtype == torch.int64
          and spill.touch.shape == spill.spilled.shape
          and spill.count.dtype == torch.int64 and spill.count.dim() == 0
          and spill.keys.dtype == torch.int64 and spill.keys.dim() == 1
          and spill.ring.dtype == torch.int32 and spill.ring.shape == (S,)
          and len(spill.values) == len(planes))
    tensors = [spill.spilled, spill.touch, spill.count, spill.keys,
               spill.ring]
    for (_kind, arr, values), col in zip(planes, spill.values):
        if col is None:
            continue
        ok = ok and (col.dtype == arr.dtype and col.shape == (S,))
        tensors.append(col)
    if not ok or any(t.device != dev or not t.is_contiguous()
                     for t in tensors):
        raise ValueError("spill: bool mask and int64 clock of one length, "
                         "an int64 count scalar, [S] int64 keys, [S] int32 "
                         "ring rows and one [S] column per plane in its "
                         "dtype (or None), contiguous on the table's device")


def ingest_step_plain(table: torch.Tensor, planes: Sequence[tuple],
                      ts: torch.Tensor, keys: torch.Tensor, pane: int,
                      offset: int, first_open, late: torch.Tensor,
                      dropped: torch.Tensor,
                      dirty: Optional[torch.Tensor] = None,
                      dirty_shift: int = 0,
                      spill: Optional[StepSpill] = None,
                      segments: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``ingest_step`` (any device): the chain of the
    probe's plain version and one ``scatter_fold`` per plane, in the
    reference's batch order (staging positions by ``cumsum``). A tensor
    ``first_open`` is compared on the device, as the kernel reads it."""
    panes = torch.div(ts - offset, pane, rounding_mode="floor")
    fresh = panes >= first_open
    if segments is not None:
        seg_len = ts.numel() // segments.numel()
        i = torch.arange(ts.numel(), device=ts.device)
        inrow = (i % seg_len) < segments[i // seg_len]
        late += (inrow & ~fresh).sum()
        fresh = fresh & inrow
    else:
        late += (~fresh).sum()
    skeys = sanitize_keys_device(keys)
    ring = planes[0][1].shape[0]
    ring_idx = panes % ring
    valid = fresh
    if spill is not None:
        groups = key_groups_device(skeys, spill.max_parallelism).to(
            torch.int64)
        spill.touch.scatter_reduce_(
            0, groups, torch.full_like(groups, int(spill.batch_no)), "amax")
        sp = spill.spilled[groups]
        valid = fresh & ~sp
    _, slots, ok = lookup_or_insert_plain(table, skeys, valid)
    if spill is not None:
        to_host = fresh & (sp | ~ok)
        S = spill.keys.numel()
        pos = spill.count + torch.cumsum(to_host.to(torch.int64), 0) - 1
        can = to_host & (pos < S)
        dropped += (to_host & ~can).sum()
        at = pos[can]
        spill.keys[at] = skeys[can]
        spill.ring[at] = ring_idx[can].to(torch.int32)
        for (_kind, arr, values), col in zip(planes, spill.values):
            if col is not None:
                col[at] = values[can].to(col.dtype)
        spill.count += to_host.sum()
    else:
        dropped += (fresh & ~ok).sum()
    flat = ring_idx * table.numel() + slots.to(torch.int64).clamp(min=0)
    for kind, arr, values in planes:
        scatter_fold(kind, arr.view(-1), flat,
                     torch.ones_like(slots) if values is None else values, ok)
    if dirty is not None:
        dirty[slots[ok].to(torch.int64) >> dirty_shift] = 1


def ingest_step(table: torch.Tensor, planes: Sequence[tuple],
                ts: torch.Tensor, keys: torch.Tensor, pane: int, offset: int,
                first_open, late: torch.Tensor,
                dropped: torch.Tensor,
                dirty: Optional[torch.Tensor] = None,
                dirty_shift: int = 0,
                spill: Optional[StepSpill] = None,
                segments: Optional[torch.Tensor] = None) -> None:
    """One ingest step of a micro-batch, IN PLACE, with no host sync.

    Row i falls in pane p = floor((ts[i] - offset) / pane); a row with p <
    ``first_open`` is late and only counts into ``late``. The others
    find-or-claim their sanitized key in ``table``; a row whose insert
    fails counts into ``dropped``, and every other row folds into ring
    row p mod ring at its slot of each plane. ``planes``: (kind, [ring,
    capacity] array, values [n] or None) with kind in sum|count|min|max;
    values None folds +1 (the count plane). ``late``, ``dropped``: int64
    scalars on the device, added to. ``first_open`` is an int, or a 0-d
    int64 tensor on the device that the kernel reads when it runs: the
    form a CUDA graph replays, whose by-value arguments are frozen at
    capture (``runtime/compiled.py``). Either way it is one launch.

    ``dirty`` (uint8, one byte per block of ``2^dirty_shift`` slots): the
    block of every slot a row folds into is set to 1. ``spill``: the
    deferred-spill split (``StepSpill``); rows of spilled groups never
    probe, and they and the fresh rows whose insert fails go to the stage
    (``dropped`` then counts the rows past the stage's capacity). Both
    the kernel and the plain version stage in batch order, as the
    reference's ``cumsum`` does: position by position the same rows, and
    the same rows dropped when the stage overflows.

    ``segments``: the counted form. The n rows are ``len(segments)``
    segments of equal length; segment j holds ``segments[j]`` rows at its
    front (an int64 count on the device, any stride: the column of a
    destination in the exchange's ``[S, D]`` counts) and its other rows
    are no rows at all: neither late nor folded."""
    _check_step(table, planes, ts, keys, first_open, late, dropped)
    _check_parts(table, planes, dirty, dirty_shift, spill)
    seg_stride = (_check_segments(ts, segments, spill)
                  if segments is not None else 0)
    if table.device.type == "cpu":
        return ingest_step_plain(table, planes, ts, keys, pane, offset,
                                 first_open, late, dropped, dirty,
                                 dirty_shift, spill, segments)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from . import kernels

    cols: list[torch.Tensor] = []
    plane_col = []
    for _kind, _arr, values in planes:
        if values is None:
            plane_col.append(-1)
            continue
        for c, col in enumerate(cols):
            if col is values:
                plane_col.append(c)
                break
        else:
            cols.append(values)
            plane_col.append(len(cols) - 1)
    if len(cols) > _MAX_COLS:
        raise ValueError(f"at most {_MAX_COLS} value columns, not "
                         f"{len(cols)}")
    n = ts.numel()
    if n == 0:
        return
    n_p, n_c = len(planes), len(cols)
    ints = ctypes.c_int * n_p
    at = isinstance(first_open, torch.Tensor)
    lib = kernels.library("hash_table")
    # the spill form's look-back words and tile counter (zeroed by the
    # launch)
    scratch = None if spill is None else torch.empty(
        lib.ingest_step_scratch_words(n), dtype=torch.int64,
        device=table.device)
    rc = lib.ingest_step_launch(
        table.data_ptr(), table.numel(), ts.data_ptr(), keys.data_ptr(),
        _CODES[keys.dtype], n, int(pane), int(offset),
        0 if at else int(first_open), first_open.data_ptr() if at else None,
        planes[0][1].shape[0], late.data_ptr(), dropped.data_ptr(), n_p,
        (ctypes.c_void_p * n_p)(*[arr.data_ptr() for _k, arr, _v in planes]),
        ints(*[_KINDS[kind] for kind, _a, _v in planes]),
        ints(*[_CODES[arr.dtype] for _k, arr, _v in planes]),
        ints(*plane_col), n_c,
        (ctypes.c_void_p * max(n_c, 1))(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * max(n_c, 1))(*[_CODES[c.dtype] for c in cols]),
        dirty.data_ptr() if dirty is not None else None, int(dirty_shift),
        spill.max_parallelism if spill is not None else 0,
        *((spill.spilled.data_ptr(), spill.touch.data_ptr(),
           int(spill.batch_no), spill.count.data_ptr(), spill.keys.numel(),
           spill.keys.data_ptr(), spill.ring.data_ptr(),
           (ctypes.c_void_p * n_p)(*[None if c is None else c.data_ptr()
                                     for c in spill.values]))
          if spill is not None else (None, None, 0, None, 0, None, None,
                                     None)),
        scratch.data_ptr() if scratch is not None else None,
        segments.data_ptr() if segments is not None else None,
        n // segments.numel() if segments is not None else 0, seg_stride,
        torch.cuda.current_stream(table.device).cuda_stream)
    kernels.check("hash_table", rc)
    note_launch("ingest_step")
    if segments is not None:
        note_launch("ingest_step_counted")
    if spill is not None:
        note_launch("ingest_step_spill")
    elif dirty is not None:
        note_launch("ingest_step_dirty")
