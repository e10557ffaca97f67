"""Device list state: the three programs of the per-key row lists, each a
hand-written kernel (``csrc/device_lists.cu``) with its plain PyTorch
version beside it.

Port of the programs of ``flink_tpu/state/device_lists.py``. The state:
``table`` [capacity] int64 (the hash table of ``ops/hash_table.py``),
``rows`` [capacity, L, C] int64 (column 0 a row's event time, floats as
their int64 bits), ``counts`` [capacity] int32, ``hits`` [capacity] int64,
a scratch that is zero between calls (the kernels' own; the plain
versions do not read it), and ``tiles`` [3, capacity / T] int64, the tile
summary of T slots a tile (``TILE_SLOTS``; the kernels read T from
the shapes): ``tiles[0]`` a lower and ``tiles[1]`` an upper bound on
column 0 of every live row of the tile, ``tiles[2]`` the tile's slots
with a nonzero count, exact. An empty tile holds (int64 max, int64 min,
0). The summary is derived state, never snapshotted.

* ``list_append`` (``_append_prog``, ``:44``): lookup-or-insert each key;
  each row's stable rank among the batch's rows of its slot; the row
  written at ``counts[slot] + rank`` if that is below L; counts bumped by
  the rows that fit; each written row widens its tile's bounds, a count
  leaving 0 adds a live slot. Returns ``flags`` int64 [3] (list full,
  insert failed, keys inserted) and ``failed`` bool [n], on the device.
  A slot an insert claims has its whole list written (the row, zeros
  after it), so a fresh slot reads as the reference's zeroed block. One
  cooperative launch.
* ``list_probe`` (``_probe_slots`` + ``_probe_gather``, ``:77``/``:86``,
  with the interval join's host mask, ``flink_tpu/sql/join.py:349-357``):
  each key looked up read-only; the live rows whose ts lies in
  ``[ts + lo_off, ts + hi_off]`` (every live row when ``ts`` is None),
  as (batch row int64 [M], packed row [M, C]) in (batch row, list
  position) order, np.nonzero's order, and each row's match count int32
  [n]. One launch that reads each list once and one host read of M; a
  second launch only when M passes the output's room.
* ``list_prune`` (``_prune_prog``, ``:91``): each key's live rows
  partitioned stably into those with ts >= horizon first and the others
  after them (the reference's ``argsort(~keep, stable)``), counts set to
  the kept rows; returns the keys left with a live row (int64 device
  scalar). The kernel skips a tile whose lower bound is at the horizon
  or above, zeroes the counts of one whose upper bound is below it, and
  visits the rest, leaving their bounds exact. One launch.

On a CPU tensor a wrapper runs its plain version; on a CUDA tensor it
launches the kernel or raises. The kernel places new keys where its CAS
lands, the plain version where the reference's probe rounds do: lists and
counts compare key by key, matches row by row. The plain versions keep
the summary with tensor ops, the prune's bounds exact on every tile.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import note_launch
from .hash_table import EMPTY_KEY, lookup_or_insert_plain, lookup_plain, \
    sanitize_keys_device

__all__ = ["list_append", "list_append_plain", "list_probe",
           "list_probe_plain", "list_prune", "list_prune_plain",
           "check_list_shape", "TILE_SLOTS", "make_tiles",
           "tiles_from_counts", "tile_summary"]

#: most int64 words of one list (L * C): the prune stages a list in
#: shared memory, 227 KiB on the H100
MAX_LIST_WORDS = 28_000
#: slots a tile of the list state's summary covers (a power of two)
TILE_SLOTS = 128
#: live lists the plain prune permutes at a time (its temporaries are
#: about three copies of that many lists)
_PRUNE_CHUNK = 1 << 20
_INT64_MAX, _INT64_MIN = (1 << 63) - 1, -(1 << 63)
#: (device, stream) -> the probe's look-back words, zero between launches
_PROBE_STATUS: dict = {}


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


# -- the tile summary --------------------------------------------------------
def _empty_tiles(n_tiles: int, device) -> torch.Tensor:
    t = torch.empty((3, n_tiles), dtype=torch.int64, device=device)
    t[0] = _INT64_MAX
    t[1] = _INT64_MIN
    t[2] = 0
    return t


def make_tiles(capacity: int, device) -> torch.Tensor:
    """The summary of an empty state of ``capacity`` slots: [3, tiles]
    int64, tiles of ``TILE_SLOTS``, every tile (int64 max, int64 min, 0).
    A state smaller than a tile is one tile."""
    return _empty_tiles(max(1, capacity // TILE_SLOTS), device)


def tiles_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """The summary of a state just loaded (a restore, a rehash, a dead-key
    rebuild), from its counts alone: each tile's live slots exact, its
    bounds the widest (int64 min, int64 max) where it has a live slot, so
    the next prune visits it and makes them exact."""
    t = make_tiles(counts.numel(), counts.device)
    live = (counts > 0).view(t.shape[1], -1).sum(1)
    t[0] = torch.where(live > 0, _INT64_MIN, _INT64_MAX)
    t[1] = torch.where(live > 0, _INT64_MAX, _INT64_MIN)
    t[2] = live
    return t


def tile_summary(rows: torch.Tensor, counts: torch.Tensor, n_tiles: int
                 ) -> torch.Tensor:
    """The exact summary of a state: each tile's least and largest column
    0 over its live rows and its live slots (the plain prune's result,
    and what a kernel's bounds must hold against)."""
    cap, L = rows.shape[0], rows.shape[1]
    t = _empty_tiles(n_tiles, rows.device)
    live = torch.nonzero(counts > 0).flatten()
    if live.numel():
        ts = rows[live, :, 0]
        on = torch.arange(L, device=rows.device)[None, :] \
            < counts[live][:, None].to(torch.int64)
        tile = live // (cap // n_tiles)
        t[0].scatter_reduce_(0, tile, torch.where(on, ts, _INT64_MAX)
                             .amin(1), "amin")
        t[1].scatter_reduce_(0, tile, torch.where(on, ts, _INT64_MIN)
                             .amax(1), "amax")
    t[2] = (counts > 0).view(n_tiles, -1).sum(1)
    return t


def _tile_shift(tiles, cap: int) -> int:
    """log2 of the slots a tile; raises on a summary that does not fit a
    state of ``cap`` slots."""
    n = tiles.shape[1] if tiles.dim() == 2 else 0
    if tiles.dtype != torch.int64 or tiles.dim() != 2 \
            or tiles.shape[0] != 3 or not n or cap % n \
            or (cap // n) & (cap // n - 1) or not tiles.is_contiguous():
        raise ValueError("tiles: a contiguous int64 [3, n] summary, n "
                         "dividing the capacity into power-of-two tiles")
    return (cap // n).bit_length() - 1


# -- append -----------------------------------------------------------------
def list_append_plain(table, rows, counts, tiles, keys, packed):
    """Plain version of ``list_append`` (any device): the reference's
    program, its rank by a stable sort of the batch by slot; the summary
    by ``scatter_reduce_`` over the written rows and a sum of live slots
    a tile."""
    n = keys.numel()
    cap, L, _C = rows.shape
    dev = keys.device
    shift = _tile_shift(tiles, cap)
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
    tile, ts = sc[can] >> shift, packed[can, 0]
    tiles[0].scatter_reduce_(0, tile, ts, "amin")
    tiles[1].scatter_reduce_(0, tile, ts, "amax")
    tiles[2] = (counts > 0).view(tiles.shape[1], -1).sum(1)
    flags = torch.stack([(ok & (pos >= L)).any().to(torch.int64),
                         (~ok).any().to(torch.int64),
                         torch.tensor(claimed.numel(), device=dev)])
    return flags, ~ok


def list_append(table, rows, counts, tiles, hits, keys, packed):
    """Append row i of ``packed`` [n, C] int64 to the list of ``keys[i]``
    (sanitized), IN PLACE on the state and its tile summary ``tiles``;
    ``hits`` is the kernel's scratch, zero before and after. Returns
    (flags int64 [3]: list full, insert failed, keys inserted; failed bool
    [n]), on the device, with no host wait."""
    _check_state(table, rows, counts, hits)
    _check_batch(table, keys)
    shift = _tile_shift(tiles, table.numel())
    if packed.dtype != torch.int64 or packed.shape != (keys.numel(),
                                                       rows.shape[2]) \
            or not packed.is_contiguous() or packed.device != table.device \
            or tiles.device != table.device:
        raise ValueError("packed must be a contiguous int64 [n, C] tensor on "
                         "the state's device, the tiles on it too")
    if table.device.type == "cpu":
        return list_append_plain(table, rows, counts, tiles, keys, packed)
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
        rows.shape[2], counts.data_ptr(), hits.data_ptr(), tiles.data_ptr(),
        tiles.shape[1], shift, keys.data_ptr(), packed.data_ptr(), n,
        scratch.data_ptr(), failed.data_ptr(), flags.data_ptr(),
        _stream(table))
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


def _probe_status(lib, dev, stream, n: int) -> torch.Tensor:
    """The probe's look-back words for n rows on ``stream``: kept a
    stream, zero between launches (a launch leaves them zero), grown to
    a power of two when short."""
    words = lib.list_probe_status_words(n)
    key = (dev, stream)
    have = _PROBE_STATUS.get(key)
    if have is None or have.numel() < words:
        have = torch.zeros(1 << (words - 1).bit_length(), dtype=torch.int64,
                           device=dev)
        _PROBE_STATUS[key] = have
    return have


def list_probe(table, rows, counts, keys, ts=None, lo_off: int = 0,
               hi_off: int = 0, hint: int = 0,
               capacity: Optional[int] = None):
    """The rows of ``keys``' lists whose ts (column 0) lies in [ts[i] +
    lo_off, ts[i] + hi_off] (every live row when ``ts`` is None), read
    only: (batch row int64 [M], packed row int64 [M, C], matches a row
    int32 [n]), in (batch row, list position) order; the first two are
    views into buffers of this call. One launch and one host read of M:
    the launch has room for ``capacity`` matches (by default the larger
    of n and ``hint``, the caller's largest M so far) and, when M passes
    it, runs again with room for M."""
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
    m = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty((0, C), dtype=torch.int64, device=dev), m)
    cap = max(n, int(hint)) if capacity is None else int(capacity)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    ts_ptr = ts.data_ptr() if ts is not None else None
    stream = _stream(table)
    status = _probe_status(lib, dev, stream, n)

    def launch(room: int):
        out_idx = torch.empty(room, dtype=torch.int64, device=dev)
        out_packed = torch.empty((room, C), dtype=torch.int64, device=dev)
        rc = lib.list_probe_launch(
            table.data_ptr(), table.numel(), rows.data_ptr(), L, C,
            counts.data_ptr(), keys.data_ptr(), n, ts_ptr, int(lo_off),
            int(hi_off), room, m.data_ptr(), total.data_ptr(),
            out_idx.data_ptr(), out_packed.data_ptr(), status.data_ptr(),
            stream)
        if rc:       # the scratch may hold a failed launch's words
            _PROBE_STATUS.pop((dev, stream), None)
        kernels.check("device_lists", rc)
        note_launch("list_probe")
        return out_idx, out_packed

    out_idx, out_packed = launch(cap)
    got = int(total)
    if got > cap:
        out_idx, out_packed = launch(got)
    return out_idx[:got], out_packed[:got], m


# -- prune ------------------------------------------------------------------
def list_prune_plain(rows, counts, tiles, horizon: int, ts_col: int = 0):
    """Plain version of ``list_prune`` (any device): the reference's
    stable argsort of ~keep, over the live slots' lists only (a slot with
    no live row keeps its order under that sort), ``_PRUNE_CHUNK`` lists
    at a time; the summary made exact on every tile. It skips nothing: it
    is the semantics."""
    L = rows.shape[1]
    _tile_shift(tiles, rows.shape[0])
    pos = torch.arange(L, device=rows.device)[None, :]
    for live in torch.nonzero(counts > 0).flatten().split(_PRUNE_CHUNK):
        sub = rows[live]
        keep = (pos < counts[live][:, None].to(torch.int64)) \
            & (sub[:, :, ts_col] >= horizon)
        perm = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices
        rows[live] = torch.take_along_dim(sub, perm[:, :, None], dim=1)
        counts[live] = keep.sum(1).to(torch.int32)
        del sub, keep, perm
    tiles.copy_(tile_summary(rows, counts, tiles.shape[1]))
    return (counts > 0).sum().to(torch.int64)


def list_prune(rows, counts, tiles, hits, horizon: int, ts_col: int = 0):
    """Drop every list's rows with ts (column ``ts_col``) below
    ``horizon``, IN PLACE; the kept rows move first in their order, the
    dropped ones after them. ``tiles`` is the state's summary (column 0):
    tiles it proves unchanged are skipped, tiles it proves emptied have
    their counts zeroed unread, and the tiles visited get exact bounds;
    ``hits`` is the kernel's scratch, zero before and after. Returns the
    keys left with a live row, an int64 device scalar."""
    if rows.dtype != torch.int64 or rows.dim() != 3 \
            or counts.dtype != torch.int32 \
            or counts.shape != (rows.shape[0],) \
            or hits.shape != counts.shape or hits.dtype != torch.int64 \
            or not (rows.is_contiguous() and counts.is_contiguous()
                    and hits.is_contiguous()) \
            or not rows.device == counts.device == hits.device \
            == tiles.device \
            or not 0 <= ts_col < rows.shape[2]:
        raise ValueError("prune: int64 rows [capacity, L, C], int32 counts "
                         "and int64 hits [capacity] and the tiles, "
                         "contiguous on one device, and a column of C")
    check_list_shape(rows.shape[1], rows.shape[2])
    shift = _tile_shift(tiles, rows.shape[0])
    if rows.device.type == "cpu":
        return list_prune_plain(rows, counts, tiles, horizon, ts_col)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    from . import kernels

    n_tiles = tiles.shape[1]
    part = torch.empty(n_tiles, dtype=torch.int64, device=rows.device)
    result = torch.empty(1, dtype=torch.int64, device=rows.device)
    rc = kernels.library("device_lists").list_prune_launch(
        rows.data_ptr(), rows.shape[1], rows.shape[2], counts.data_ptr(),
        rows.shape[0], tiles.data_ptr(), n_tiles, shift, int(horizon),
        int(ts_col), hits.data_ptr(), part.data_ptr(), result.data_ptr(),
        _stream(rows))
    kernels.check("device_lists", rc)
    note_launch("list_prune")
    return result[0]
