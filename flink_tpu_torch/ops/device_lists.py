"""Device list state: the three programs of the per-key row lists, each a
hand-written kernel (``csrc/device_lists.cu``) with its plain PyTorch
version beside it.

Port of the programs of ``flink_tpu/state/device_lists.py``. The state:
``table`` [capacity] int64 (the hash table of ``ops/hash_table.py``),
``rows`` [capacity, L, C] int64 (column 0 a row's event time, floats as
their int64 bits), ``counts`` [capacity] int32, and ``hits`` [capacity]
int64, a scratch that is zero between calls (the kernels' own; the plain
versions do not read it).

* ``list_append`` (``_append_prog``, ``:44``): lookup-or-insert each key;
  each row's stable rank among the batch's rows of its slot; the row
  written at ``counts[slot] + rank`` if that is below L; counts bumped by
  the rows that fit. Returns ``flags`` int64 [3] (list full, insert
  failed, keys inserted) and ``failed`` bool [n], on the device. A slot
  an insert claims has its whole list zeroed, so a fresh slot reads as
  the reference's freshly zeroed block.
* ``list_probe`` (``_probe_slots`` + ``_probe_gather``, ``:77``/``:86``,
  with the interval join's host mask, ``flink_tpu/sql/join.py:349-357``):
  each key looked up read-only; the live rows whose ts lies in
  ``[ts + lo_off, ts + hi_off]`` (every live row when ``ts`` is None),
  as (batch row int64 [M], packed row [M, C]) in (batch row, list
  position) order, np.nonzero's order, and each row's match count int32
  [n]. One host read of M sizes the output.
* ``list_prune`` (``_prune_prog``, ``:91``): each key's live rows
  partitioned stably into those with ts >= horizon first and the others
  after them (the reference's ``argsort(~keep, stable)``), counts set to
  the kept rows; returns the keys left with a live row (int64 device
  scalar). The kernel reads counts first and touches live rows only.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The kernel places new keys where its CAS
lands, the plain version where the reference's probe rounds do: lists and
counts compare key by key, matches row by row.
"""

from __future__ import annotations

import torch

from ..device import note_launch
from .hash_table import EMPTY_KEY, lookup_or_insert_plain, lookup_plain, \
    sanitize_keys_device

__all__ = ["list_append", "list_append_plain", "list_probe",
           "list_probe_plain", "list_prune", "list_prune_plain",
           "check_list_shape"]

#: most int64 words of one list (L * C): the prune stages a list in
#: shared memory, 227 KiB on the H100
MAX_LIST_WORDS = 28_000


def check_list_shape(L: int, C: int) -> None:
    if L <= 0 or C <= 0 or L * C > MAX_LIST_WORDS:
        raise ValueError(f"a list of {L} rows of {C} columns is outside "
                         f"1 to {MAX_LIST_WORDS} int64 words")


def _check_state(table, rows, counts, hits) -> None:
    cap = table.numel()
    ok = (table.dtype == torch.int64 and table.dim() == 1
          and cap and not cap & (cap - 1)
          and rows.dtype == torch.int64 and rows.dim() == 3
          and rows.shape[0] == cap and counts.dtype == torch.int32
          and counts.shape == (cap,)
          and (hits is None or (hits.dtype == torch.int64
                                and hits.shape == (cap,))))
    tensors = [table, rows, counts] + ([hits] if hits is not None else [])
    if not ok or any(t.device != table.device or not t.is_contiguous()
                     for t in tensors):
        raise ValueError("list state: a power-of-two int64 table, int64 rows "
                         "[capacity, L, C], int32 counts and int64 hits "
                         "[capacity], contiguous on one device")
    check_list_shape(rows.shape[1], rows.shape[2])


def _check_batch(table, keys, *cols) -> None:
    if keys.dtype != torch.int64 or keys.dim() != 1 \
            or not keys.is_contiguous() or keys.device != table.device:
        raise ValueError("keys must be a contiguous 1-D int64 tensor on the "
                         "state's device")
    for c in cols:
        if c is not None and (c.dtype != torch.int64 or c.shape[0] != keys.numel()
                              or not c.is_contiguous()
                              or c.device != table.device):
            raise ValueError("batch columns must be contiguous int64 tensors "
                             "of the keys' length on the state's device")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- append -----------------------------------------------------------------
def list_append_plain(table, rows, counts, keys, packed):
    """Plain version of ``list_append`` (any device): the reference's
    program, its rank by a stable sort of the batch by slot."""
    n = keys.numel()
    cap, L, _C = rows.shape
    dev = keys.device
    before = table.clone()
    table, slots, ok = lookup_or_insert_plain(table, sanitize_keys_device(keys))
    sc = slots.to(torch.int64).clamp(min=0)
    claimed = torch.unique(sc[ok & (before[sc] == EMPTY_KEY)])
    rows[claimed] = 0            # a claimed slot starts from a zero list
    rslot = torch.where(ok, sc, cap)
    order = torch.sort(rslot, stable=True).indices
    ss = rslot[order]
    first = torch.searchsorted(ss, ss, side="left")
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev) - first
    pos = counts[sc].to(torch.int64) + rank
    can = ok & (pos < L)
    rows.view(cap * L, -1)[sc[can] * L + pos[can]] = packed[can]
    counts.index_add_(0, sc[can], torch.ones_like(sc[can], dtype=torch.int32))
    flags = torch.stack([(ok & (pos >= L)).any().to(torch.int64),
                         (~ok).any().to(torch.int64),
                         torch.tensor(claimed.numel(), device=dev)])
    return flags, ~ok


def list_append(table, rows, counts, hits, keys, packed):
    """Append row i of ``packed`` [n, C] int64 to the list of ``keys[i]``
    (sanitized), IN PLACE on the state. Returns (flags int64 [3]: list
    full, insert failed, keys inserted; failed bool [n]), on the device,
    with no host wait."""
    _check_state(table, rows, counts, hits)
    _check_batch(table, keys)
    if packed.dtype != torch.int64 or packed.shape != (keys.numel(),
                                                       rows.shape[2]) \
            or not packed.is_contiguous() or packed.device != table.device:
        raise ValueError("packed must be a contiguous int64 [n, C] tensor on "
                         "the state's device")
    if table.device.type == "cpu":
        return list_append_plain(table, rows, counts, keys, packed)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from . import kernels

    n = keys.numel()
    dev = table.device
    scratch = torch.empty(4 * max(n, 1), dtype=torch.int32, device=dev)
    failed = torch.empty(n, dtype=torch.bool, device=dev)
    flags = torch.empty(5, dtype=torch.int64, device=dev)
    rc = kernels.library("device_lists").list_append_launch(
        table.data_ptr(), table.numel(), rows.data_ptr(), rows.shape[1],
        rows.shape[2], counts.data_ptr(), hits.data_ptr(), keys.data_ptr(),
        packed.data_ptr(), n, scratch.data_ptr(), failed.data_ptr(),
        flags.data_ptr(), _stream(table))
    kernels.check("device_lists", rc)
    if n:
        note_launch("list_append")
    return flags[:3], failed


# -- probe ------------------------------------------------------------------
def list_probe_plain(table, rows, counts, keys, ts=None, lo_off: int = 0,
                     hi_off: int = 0):
    """Plain version of ``list_probe`` (any device): lookup, the gather of
    [n, L_eff, C] candidate rows, the live and interval mask, nonzero."""
    n = keys.numel()
    C = rows.shape[2]
    slots = lookup_plain(table, sanitize_keys_device(keys)).to(torch.int64)
    found = slots >= 0
    sc = slots.clamp(min=0)
    cnt = torch.where(found, counts[sc], torch.zeros_like(counts[sc]))
    l_eff = int(cnt.max()) if n else 0
    if l_eff == 0:
        return (torch.zeros(0, dtype=torch.int64, device=keys.device),
                torch.zeros((0, C), dtype=torch.int64, device=keys.device),
                cnt.to(torch.int32))
    cand = rows[sc, :l_eff, :]
    m = torch.arange(l_eff, device=keys.device)[None, :] < cnt[:, None]
    if ts is not None:
        ots = cand[:, :, 0]
        m &= (ots >= (ts + lo_off)[:, None]) & (ots <= (ts + hi_off)[:, None])
    bi, li = torch.nonzero(m, as_tuple=True)
    return bi, cand[bi, li], m.sum(1).to(torch.int32)


def list_probe(table, rows, counts, keys, ts=None, lo_off: int = 0,
               hi_off: int = 0):
    """The rows of ``keys``' lists whose ts (column 0) lies in [ts[i] +
    lo_off, ts[i] + hi_off] (every live row when ``ts`` is None), read
    only: (batch row int64 [M], packed row int64 [M, C], matches a row
    int32 [n]), in (batch row, list position) order. One host read of M
    between the count and the write."""
    _check_state(table, rows, counts, None)
    _check_batch(table, keys, ts)
    if table.device.type == "cpu":
        return list_probe_plain(table, rows, counts, keys, ts, lo_off, hi_off)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from . import kernels

    lib = kernels.library("device_lists")
    n = keys.numel()
    dev = table.device
    L, C = rows.shape[1], rows.shape[2]
    nb = lib.list_probe_blocks(n)
    m = torch.empty(n, dtype=torch.int32, device=dev)
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    block_off = torch.empty(nb + 1, dtype=torch.int64, device=dev)
    ts_ptr = ts.data_ptr() if ts is not None else None
    stream = _stream(table)
    rc = lib.list_probe_count_launch(
        table.data_ptr(), table.numel(), rows.data_ptr(), L, C,
        counts.data_ptr(), keys.data_ptr(), n, ts_ptr, int(lo_off),
        int(hi_off), m.data_ptr(), slots.data_ptr(), block_off.data_ptr(),
        stream)
    kernels.check("device_lists", rc)
    total = int(block_off[nb])
    out_idx = torch.empty(total, dtype=torch.int64, device=dev)
    out_packed = torch.empty((total, C), dtype=torch.int64, device=dev)
    if total:
        rc = lib.list_probe_write_launch(
            rows.data_ptr(), L, C, counts.data_ptr(), n, ts_ptr, int(lo_off),
            int(hi_off), m.data_ptr(), slots.data_ptr(),
            block_off.data_ptr(), out_idx.data_ptr(), out_packed.data_ptr(),
            stream)
        kernels.check("device_lists", rc)
    if n:
        note_launch("list_probe")
    return out_idx, out_packed, m


# -- prune ------------------------------------------------------------------
def list_prune_plain(rows, counts, horizon: int, ts_col: int = 0):
    """Plain version of ``list_prune`` (any device): the reference's
    stable argsort of ~keep, over the live slots' lists only (a slot with
    no live row keeps its order under that sort)."""
    L = rows.shape[1]
    live = torch.nonzero(counts > 0).flatten()
    if live.numel():
        sub = rows[live]
        keep = (torch.arange(L, device=rows.device)[None, :]
                < counts[live][:, None].to(torch.int64)) \
            & (sub[:, :, ts_col] >= horizon)
        perm = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
        rows[live] = torch.take_along_dim(sub, perm[:, :, None], dim=1)
        counts[live] = keep.sum(1).to(torch.int32)
    return (counts > 0).sum().to(torch.int64)


def list_prune(rows, counts, hits, horizon: int, ts_col: int = 0):
    """Drop every list's rows with ts (column ``ts_col``) below
    ``horizon``, IN PLACE; the kept rows move first in their order, the
    dropped ones after them. Returns the keys left with a live row, an
    int64 device scalar."""
    if rows.dtype != torch.int64 or rows.dim() != 3 \
            or counts.dtype != torch.int32 \
            or counts.shape != (rows.shape[0],) \
            or hits.shape != counts.shape or hits.dtype != torch.int64 \
            or not (rows.is_contiguous() and counts.is_contiguous()
                    and hits.is_contiguous()) \
            or not rows.device == counts.device == hits.device \
            or not 0 <= ts_col < rows.shape[2]:
        raise ValueError("prune: int64 rows [capacity, L, C], int32 counts "
                         "and int64 hits [capacity], contiguous on one "
                         "device, and a column of C")
    check_list_shape(rows.shape[1], rows.shape[2])
    if rows.device.type == "cpu":
        return list_prune_plain(rows, counts, horizon, ts_col)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from . import kernels

    result = torch.empty(2, dtype=torch.int64, device=rows.device)
    rc = kernels.library("device_lists").list_prune_launch(
        rows.data_ptr(), rows.shape[1], rows.shape[2], counts.data_ptr(),
        rows.shape[0], int(horizon), int(ts_col), hits.data_ptr(),
        result.data_ptr(), _stream(rows))
    kernels.check("device_lists", rc)
    note_launch("list_prune")
    return result[0]
