"""The keyed backend's row plane: four programs, each a hand-written
kernel (``csrc/row_state.cu``) with its plain PyTorch version beside it.

Port of the row programs of ``flink_tpu/state/tpu_backend.py``. The
state: ``table`` [capacity] int64 (``ops/hash_table.py``), a value plane
``vals`` [capacity] of any numeric dtype, ``presence`` [capacity] int8
and an optional TTL clock ``last_ts`` [capacity] int64 (None: no TTL).
``dedup_first`` and ``row_set`` find each slot's first (last) row of the
batch: the kernels in a batch map (``new_batch_map``: ``MAP_HEAD`` zero
words, then at least ``batch_map_entries(n)`` entries of -1, as every
call leaves them; the backend keeps one that grows with its largest
batch, and a wrapper on the card raises without one), the plain
versions by ``scatter_reduce_`` into a fresh ``[capacity + 1]`` tensor,
as the reference does.

* ``dedup_first`` (``_dedup_first``, ``:189``): keep-first admission.
  Lookup-or-insert of the valid rows; fresh = ok and not was and first,
  where ``was`` reads presence and the clock (``ts - last_ts <= ttl``) as
  they stood before the batch and a row is first when it has the lowest
  row index of its slot in the batch; presence := 1 for every ok row,
  ``last_ts`` := ts for the fresh ones, the dirty blocks of the ok rows'
  slots marked. When a valid row finds no slot, presence and the clock
  are left as they were (the table keeps the claims of the batch's other
  keys, with presence 0) and no row is fresh: the caller grows the table
  and runs the batch again. Returns (fresh bool [n], slots int32 [n], -1
  for invalid and failed rows, status int64 [3]: failed rows, slots
  claimed, fresh rows). One launch. The kernel leaves a slot whose
  presence and clock do not change unwritten and may leave its dirty
  block unmarked; the plain version marks every ok row's block.
* ``row_set`` (``_rows_set``, ``:111``): the last row of each slot writes
  its value (cast to the plane's dtype), presence := 1 and, with a clock,
  ``now`` (an int, or an int64 tensor of a value a row). One launch.
* ``row_get`` (``_rows_get``, ``:127``): (values, present) for keys: the
  value at the key's slot (slot 0's for an absent key, as the
  reference's gather), present = found and presence and ``now - last_ts
  <= ttl``. One launch, the lookup fused.
* ``row_unset`` (``_rows_unset``, ``:157``): presence := 0 at each found
  key's slot; returns the slots (-1: absent). One launch, the lookup
  fused.

Keys are sanitised (``sanitize_keys_device``) by every program. TTL
arithmetic is int64 as the reference's: a clock of int64 max never
expires, and ``ts - last_ts == ttl`` is still seen. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel
or raises. The kernel places new keys where its CAS lands, the plain
version where the reference's probe rounds do, so results compare key by
key.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from ..device import note_launch
from .hash_table import EMPTY_KEY, lookup_or_insert_plain, lookup_plain, \
    sanitize_keys_device

__all__ = ["MAP_HEAD", "batch_map_entries", "new_batch_map", "dedup_first",
           "dedup_first_plain", "row_set", "row_set_plain", "row_get",
           "row_get_plain", "row_unset", "row_unset_plain"]

#: zero words at the head of a batch map (the kernels' counts and ticket)
MAP_HEAD = 4
#: entries below which a batch of more rows gets up to 16 entries a row
SPARSE_MAP_ENTRIES = 1 << 17


def batch_map_entries(n: int) -> int:
    """Entries of the batch map for n rows: the least power of two at or
    above 2n and, for a batch of more rows than the kernels' one-block
    launch takes (the library's ``row_state_block_rows``), at or above
    min(16n, 2^17). A small batch's call waits on its longest probe chain,
    which a sparser map shortens; a large batch's is held by the map walk,
    which a denser map shortens (tools/row_designs.py, map_2n to map_16n:
    at 2^12 rows 16n is the fastest, at 2^15 4n, at 2^19 2n)."""
    from . import kernels

    want = 2 * n
    if n > kernels.library("row_state").row_state_block_rows():
        want = max(want, min(16 * n, SPARSE_MAP_ENTRIES))
    return 1 << max(1, (want - 1).bit_length())


def new_batch_map(n: int, device) -> torch.Tensor:
    """A batch map for up to n rows, as the kernels leave it."""
    m = torch.full((MAP_HEAD + batch_map_entries(n),), -1, dtype=torch.int64,
                   device=device)
    m[:MAP_HEAD] = 0
    return m


def _map_entries(batch_map: Optional[torch.Tensor], n: int,
                 like: torch.Tensor) -> int:
    """The entries of ``batch_map`` that a launch for n rows uses."""
    entries = batch_map_entries(n)
    if (batch_map is None or batch_map.dtype != torch.int64
            or batch_map.dim() != 1 or not batch_map.is_contiguous()
            or batch_map.device != like.device
            or batch_map.numel() < MAP_HEAD + entries):
        raise ValueError(f"batch_map must be a contiguous int64 tensor of at "
                         f"least {MAP_HEAD + entries} words on the state's "
                         "device (new_batch_map)")
    return entries


def _check_table(table: torch.Tensor) -> None:
    cap = table.numel()
    if table.dtype != torch.int64 or table.dim() != 1 or not cap \
            or cap & (cap - 1) or not table.is_contiguous():
        raise ValueError("table must be a contiguous power-of-two int64 "
                         "tensor")


_PLANE_DTYPES = {"presence": torch.int8, "last_ts": torch.int64,
                 "dirty": torch.uint8}
_BATCH_DTYPES = {"keys": torch.int64, "ts": torch.int64, "now": torch.int64,
                 "valid": torch.bool, "slots": torch.int32}


def _check_rows(like: torch.Tensor, planes: dict, batch: dict) -> None:
    """Planes [capacity] (``like``'s length; the dirty bitmap any length)
    and batch columns of one length, contiguous on ``like``'s device."""
    n = None
    for name, t in planes.items():
        if t is None:
            continue
        if (t.dim() != 1 or not t.is_contiguous() or t.device != like.device
                or (name in _PLANE_DTYPES and t.dtype != _PLANE_DTYPES[name])
                or (name != "dirty" and t.numel() != like.numel())):
            raise ValueError(f"{name} must be a contiguous [capacity] "
                             f"{_PLANE_DTYPES.get(name, 'plane')} tensor on "
                             "the state's device")
    for name, t in batch.items():
        if t is None:
            continue
        n = t.numel() if n is None else n
        if (t.dim() != 1 or not t.is_contiguous() or t.device != like.device
                or (name in _BATCH_DTYPES and t.dtype != _BATCH_DTYPES[name])
                or t.numel() != n):
            raise ValueError(f"{name} must be a contiguous 1-D "
                             f"{_BATCH_DTYPES.get(name, '')} tensor of the "
                             "batch's length on the state's device")


def _launcher(t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    from . import kernels
    return kernels, kernels.library("row_state"), \
        torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# -- dedup_first -------------------------------------------------------------
def dedup_first(table: torch.Tensor, presence: torch.Tensor,
                last_ts: Optional[torch.Tensor], keys: torch.Tensor,
                valid: Optional[torch.Tensor], ts: torch.Tensor, ttl: int,
                dirty: torch.Tensor, dirty_shift: int,
                batch_map: Optional[torch.Tensor] = None):
    """Keep-first admission of a batch (module docstring). ``dirty``: the
    backend's dirty bitmap, one byte a block of 2^dirty_shift slots;
    ``batch_map``: required on the card, unused on the CPU."""
    _check_table(table)
    _check_rows(table, {"presence": presence, "last_ts": last_ts,
                        "dirty": dirty},
                {"keys": keys, "valid": valid, "ts": ts})
    if table.device.type == "cpu":
        return dedup_first_plain(table, presence, last_ts, keys, valid, ts,
                                 ttl, dirty, dirty_shift)
    kernels, lib, stream = _launcher(table)
    n = keys.numel()
    entries = _map_entries(batch_map, n, table)
    slots = torch.empty(n, dtype=torch.int32, device=keys.device)
    fresh = torch.empty(n, dtype=torch.bool, device=keys.device)
    status = torch.empty(3, dtype=torch.int64, device=keys.device)
    kernels.check("row_state", lib.dedup_first_launch(
        table.data_ptr(), table.numel(), keys.data_ptr(), _ptr(valid),
        ts.data_ptr(), n, presence.data_ptr(), _ptr(last_ts), int(ttl),
        batch_map.data_ptr(), entries, dirty.data_ptr(), int(dirty_shift),
        slots.data_ptr(), fresh.data_ptr(), status.data_ptr(), stream))
    note_launch("dedup_first")
    return fresh, slots, status


def dedup_first_plain(table, presence, last_ts, keys, valid, ts, ttl, dirty,
                      dirty_shift):
    """Plain version of ``dedup_first``: the reference's probe rounds, each
    slot's first row by ``scatter_reduce_`` amin into a fresh
    ``[capacity + 1]`` tensor (the reference's ``firstpos``)."""
    dev = keys.device
    n = keys.numel()
    cap = table.numel()
    before = int((table != EMPTY_KEY).sum())
    _, slots, ok = lookup_or_insert_plain(table, sanitize_keys_device(keys),
                                          valid)
    claims = int((table != EMPTY_KEY).sum()) - before
    failed = int((~ok).sum() if valid is None else (valid & ~ok).sum())
    s = slots.to(torch.int64)
    sc = s.clamp(min=0)
    was = (presence[sc] > 0) & ok
    if last_ts is not None:
        was &= (ts - last_ts[sc]) <= int(ttl)
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    widx = torch.where(ok, s, cap)
    firstpos = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    firstpos.scatter_reduce_(0, widx, rows, "amin")
    fresh = ok & ~was & (firstpos[widx] == rows)
    if failed:
        fresh.zero_()
    else:
        so = s[ok]
        presence[so] = 1
        if last_ts is not None:
            last_ts[s[fresh]] = ts[fresh]
        dirty[so >> dirty_shift] = 1
    status = torch.tensor([failed, claims, int(fresh.sum())],
                          dtype=torch.int64, device=dev)
    return fresh, slots, status


# -- row_set -----------------------------------------------------------------
def row_set(vals: torch.Tensor, presence: torch.Tensor,
            last_ts: Optional[torch.Tensor], slots: torch.Tensor,
            new_vals: torch.Tensor, now: Union[int, torch.Tensor],
            batch_map: Optional[torch.Tensor] = None) -> None:
    """Last row of each slot wins (module docstring); in place.
    ``batch_map``: required on the card, unused on the CPU."""
    now_rows = now if isinstance(now, torch.Tensor) else None
    _check_rows(vals, {"vals": vals, "presence": presence,
                       "last_ts": last_ts},
                {"slots": slots, "new_vals": new_vals, "now": now_rows})
    new_vals = new_vals.to(vals.dtype).contiguous()
    if vals.device.type == "cpu":
        return row_set_plain(vals, presence, last_ts, slots, new_vals, now)
    kernels, lib, stream = _launcher(vals)
    n = slots.numel()
    entries = _map_entries(batch_map, n, vals)
    kernels.check("row_state", lib.row_set_launch(
        slots.data_ptr(), n, vals.data_ptr(), new_vals.data_ptr(),
        vals.element_size(), presence.data_ptr(), _ptr(last_ts),
        _ptr(now_rows), 0 if now_rows is not None else int(now),
        batch_map.data_ptr(), entries, stream))
    note_launch("row_set")


def row_set_plain(vals, presence, last_ts, slots, new_vals, now):
    """Plain version of ``row_set``: each slot's last row by
    ``scatter_reduce_`` amax into a fresh ``[capacity + 1]`` tensor (the
    reference's ``lastpos``)."""
    n = slots.numel()
    cap = vals.numel()
    s = slots.to(torch.int64)
    rows = torch.arange(n, dtype=torch.int32, device=s.device)
    widx = torch.where(s >= 0, s, cap)
    lastpos = torch.full((cap + 1,), -1, dtype=torch.int32, device=s.device)
    lastpos.scatter_reduce_(0, widx, rows, "amax")
    win = (s >= 0) & (lastpos[widx] == rows)
    ws = s[win]
    vals[ws] = new_vals.to(vals.dtype)[win]
    presence[ws] = 1
    if last_ts is not None:
        last_ts[ws] = now[win] if isinstance(now, torch.Tensor) else int(now)


# -- row_get / row_unset -----------------------------------------------------
def row_get(table: torch.Tensor, vals: torch.Tensor, presence: torch.Tensor,
            last_ts: Optional[torch.Tensor], keys: torch.Tensor, now: int,
            ttl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values [n] of the plane's dtype, present bool [n])."""
    _check_table(table)
    _check_rows(table, {"vals": vals, "presence": presence,
                        "last_ts": last_ts}, {"keys": keys})
    if table.device.type == "cpu":
        return row_get_plain(table, vals, presence, last_ts, keys, now, ttl)
    kernels, lib, stream = _launcher(table)
    n = keys.numel()
    out = torch.empty(n, dtype=vals.dtype, device=keys.device)
    present = torch.empty(n, dtype=torch.bool, device=keys.device)
    kernels.check("row_state", lib.row_get_launch(
        table.data_ptr(), table.numel(), keys.data_ptr(), n, vals.data_ptr(),
        vals.element_size(), presence.data_ptr(), _ptr(last_ts), int(now),
        int(ttl), out.data_ptr(), present.data_ptr(), stream))
    note_launch("row_get")
    return out, present


def row_get_plain(table, vals, presence, last_ts, keys, now, ttl):
    s = lookup_plain(table, sanitize_keys_device(keys)).to(torch.int64)
    sc = s.clamp(min=0)
    present = (s >= 0) & (presence[sc] > 0)
    if last_ts is not None:
        present &= (int(now) - last_ts[sc]) <= int(ttl)
    return vals[sc], present


def row_unset(table: torch.Tensor, presence: torch.Tensor,
              keys: torch.Tensor) -> torch.Tensor:
    """presence := 0 at the keys found; their slots int32 (-1: absent)."""
    _check_table(table)
    _check_rows(table, {"presence": presence}, {"keys": keys})
    if table.device.type == "cpu":
        return row_unset_plain(table, presence, keys)
    kernels, lib, stream = _launcher(table)
    n = keys.numel()
    slots = torch.empty(n, dtype=torch.int32, device=keys.device)
    kernels.check("row_state", lib.row_unset_launch(
        table.data_ptr(), table.numel(), keys.data_ptr(), n,
        presence.data_ptr(), slots.data_ptr(), stream))
    note_launch("row_unset")
    return slots


def row_unset_plain(table, presence, keys):
    slots = lookup_plain(table, sanitize_keys_device(keys))
    s = slots.to(torch.int64)
    presence[s[s >= 0]] = 0
    return slots
