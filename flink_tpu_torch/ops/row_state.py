"""The keyed backend's row plane: four programs, each a hand-written
kernel (``csrc/row_state.cu``) with its plain PyTorch version beside it.

Port of the row programs of ``flink_tpu/state/tpu_backend.py``. The
state: ``table`` [capacity] int64 (``ops/hash_table.py``), a value plane
``vals`` [capacity] of any numeric dtype, ``presence`` [capacity] int8,
an optional TTL clock ``last_ts`` [capacity] int64 (None: no TTL), and
``scratch`` [capacity] int32 (``new_row_scratch``), ``ROW_NONE`` in every
entry between calls: each call restores the entries it touches.

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
  claimed, fresh rows). Two launches (resolve, then admit).
* ``row_set`` (``_rows_set``, ``:111``): the last row of each slot writes
  its value (cast to the plane's dtype), presence := 1 and, with a clock,
  ``now`` (an int, or an int64 tensor of a value a row). Two launches.
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

__all__ = ["ROW_NONE", "new_row_scratch", "dedup_first", "dedup_first_plain",
           "row_set", "row_set_plain", "row_get", "row_get_plain",
           "row_unset", "row_unset_plain"]

#: a scratch entry no row holds
ROW_NONE = (1 << 31) - 1


def new_row_scratch(capacity: int, device) -> torch.Tensor:
    return torch.full((capacity,), ROW_NONE, dtype=torch.int32, device=device)


def _check_table(table: torch.Tensor) -> None:
    cap = table.numel()
    if table.dtype != torch.int64 or table.dim() != 1 or not cap \
            or cap & (cap - 1) or not table.is_contiguous():
        raise ValueError("table must be a contiguous power-of-two int64 "
                         "tensor")


_PLANE_DTYPES = {"presence": torch.int8, "last_ts": torch.int64,
                 "scratch": torch.int32, "dirty": torch.uint8}
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
                scratch: torch.Tensor, dirty: torch.Tensor, dirty_shift: int):
    """Keep-first admission of a batch (module docstring). ``dirty``: the
    backend's dirty bitmap, one byte a block of 2^dirty_shift slots."""
    _check_table(table)
    _check_rows(table, {"presence": presence, "last_ts": last_ts,
                        "scratch": scratch, "dirty": dirty},
                {"keys": keys, "valid": valid, "ts": ts})
    if table.device.type == "cpu":
        return dedup_first_plain(table, presence, last_ts, keys, valid, ts,
                                 ttl, scratch, dirty, dirty_shift)
    kernels, lib, stream = _launcher(table)
    n = keys.numel()
    slots = torch.empty(n, dtype=torch.int32, device=keys.device)
    fresh = torch.empty(n, dtype=torch.bool, device=keys.device)
    status = torch.empty(3, dtype=torch.int64, device=keys.device)
    kernels.check("row_state", lib.dedup_first_launch(
        table.data_ptr(), table.numel(), keys.data_ptr(), _ptr(valid),
        ts.data_ptr(), n, presence.data_ptr(), _ptr(last_ts), int(ttl),
        scratch.data_ptr(), dirty.data_ptr(), int(dirty_shift),
        slots.data_ptr(), fresh.data_ptr(), status.data_ptr(), stream))
    note_launch("dedup_first")
    return fresh, slots, status


def dedup_first_plain(table, presence, last_ts, keys, valid, ts, ttl,
                      scratch, dirty, dirty_shift):
    """Plain version of ``dedup_first``: the reference's probe rounds, the
    first rows found through the same scratch."""
    dev = keys.device
    n = keys.numel()
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
    so = s[ok]
    scratch.scatter_reduce_(0, so, rows[ok], "amin")
    first = torch.zeros(n, dtype=torch.bool, device=dev)
    first[ok] = scratch[so] == rows[ok]
    scratch[so] = ROW_NONE
    fresh = ok & ~was & first
    if failed:
        fresh.zero_()
    else:
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
            scratch: torch.Tensor) -> None:
    """Last row of each slot wins (module docstring); in place."""
    now_rows = now if isinstance(now, torch.Tensor) else None
    _check_rows(vals, {"vals": vals, "presence": presence,
                       "last_ts": last_ts, "scratch": scratch},
                {"slots": slots, "new_vals": new_vals, "now": now_rows})
    new_vals = new_vals.to(vals.dtype).contiguous()
    if vals.device.type == "cpu":
        return row_set_plain(vals, presence, last_ts, slots, new_vals, now,
                             scratch)
    kernels, lib, stream = _launcher(vals)
    kernels.check("row_state", lib.row_set_launch(
        slots.data_ptr(), slots.numel(), vals.data_ptr(), new_vals.data_ptr(),
        vals.element_size(), presence.data_ptr(), _ptr(last_ts),
        _ptr(now_rows), 0 if now_rows is not None else int(now),
        scratch.data_ptr(), stream))
    note_launch("row_set")


def row_set_plain(vals, presence, last_ts, slots, new_vals, now, scratch):
    """Plain version of ``row_set``: the last rows found through the same
    scratch (each row's n - 1 - i under amin)."""
    n = slots.numel()
    s = slots.to(torch.int64)
    ok = s >= 0
    so = s[ok]
    rank = (n - 1 - torch.arange(n, dtype=torch.int64, device=s.device)
            ).to(torch.int32)
    scratch.scatter_reduce_(0, so, rank[ok], "amin")
    win = torch.zeros(n, dtype=torch.bool, device=s.device)
    win[ok] = scratch[so] == rank[ok]
    scratch[so] = ROW_NONE
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
