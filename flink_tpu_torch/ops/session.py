"""Session-window step and fire: the device programs of the session
operator (port of ``_sess_step`` and ``_sess_fire`` of
``flink_tpu/runtime/operators/device_session.py``).

Every key slot owns L session lanes: ``[L, capacity]`` planes ``start``
(int64, min), ``end`` (int64, max), ``open`` (int8, max) and ``count``
(int64), one more per aggregate, and an int32 ``cur_lane`` per slot.

* ``session_step`` takes one batch sorted by (key, ts): it finds or
  claims each key's slot, checks every event against all L lanes of its
  key as they stood before the batch (overlap within ``gap``), drops
  late events, cuts the key's events into segments where the gap to the
  previous event is at least ``gap`` (or a late event intervenes), and
  folds each segment's totals into a lane: the lane it merges into, or
  the j-th free lane for the key's j-th new segment, rotating from
  ``cur_lane + 1``. A segment that no non-late event could still reach
  (``end + 2 gap <= fired_boundary``, neither merging nor its key's last)
  bypasses the lanes: it is emitted into compact buffers for the host.
  Failed inserts and segments without a free lane count into
  ``dropped``, late events into ``late``; the dirty blocks of the slots
  it writes are marked.
* ``session_fire`` compacts every open lane with ``end + gap <=
  boundary`` (key, start, end, count and each aggregate, avg = sum /
  max(count, 1)) into ``[capacity]`` buffers in lane-major order, resets
  the lanes it compacted to the planes' identities and marks their dirty
  blocks. It returns [fired, overflow]: lanes due beyond the buffer stay
  open for the next round.

On a CUDA tensor each is one launch of its hand-written kernel
(``csrc/session_window.cu``); a failed build or launch raises. On a CPU
tensor they run the plain versions, ``session_step_plain`` and
``session_fire_plain``, which follow the reference programs line for line
(the probe's plain version included, so slots land where the reference
puts them). The kernel emits settled segments in atomic order and the
plain version in batch order: the rows are equal as a multiset.

Unlike the reference's fire, both forms mark the dirty blocks of the
lanes a fire resets: an incremental snapshot taken after a fire must not
bring a fired session back.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from ..device import note_launch
from .hash_table import _check_table, lookup_or_insert_plain, \
    sanitize_keys_device
from .segment_ops import scatter_fold

__all__ = ["session_step", "session_step_plain", "session_fire",
           "session_fire_plain", "SessionRows", "FiredRows", "MAX_LANES",
           "MAX_FOLDS"]

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)
MAX_LANES = 64   # the kernel keeps a key's open lanes in a 64-bit mask
MAX_FOLDS = 8
#: torch dtype -> dtype code of csrc/session_window.cu
_CODES = {torch.int64: 0, torch.int32: 1, torch.float32: 2, torch.float64: 3}
_KINDS = {"sum": 0, "min": 1, "max": 2}
#: output kind -> code of csrc/session_window.cu (a count aliases ``count``)
_OUT_KINDS = {"avg": 0, "sum": 1, "min": 1, "max": 1}


class SessionRows(NamedTuple):
    """Settled segments of one step: ``n`` (0-d int64 tensor) rows at the
    front of each [batch] buffer; ``values`` per fold plane."""

    n: torch.Tensor
    key: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    count: torch.Tensor
    values: list


class FiredRows(NamedTuple):
    """Fired sessions of one fire round: ``counts`` [fired, overflow]
    (int64 tensor), ``fired`` rows at the front of each [capacity]
    buffer; ``values`` per requested output."""

    counts: torch.Tensor
    key: torch.Tensor
    start: torch.Tensor
    end: torch.Tensor
    count: torch.Tensor
    values: list


def _ident_max(dtype: torch.dtype):
    return float("inf") if dtype.is_floating_point else torch.iinfo(dtype).max


def _ident_min(dtype: torch.dtype):
    return -float("inf") if dtype.is_floating_point \
        else torch.iinfo(dtype).min


def _reset_value(kind: str, dtype: torch.dtype):
    """The identity a fired lane returns to (the reference's fire resets
    float min/max planes to +-inf)."""
    return (_ident_max(dtype) if kind == "min"
            else _ident_min(dtype) if kind == "max" else 0)


def _check_lanes(table, start, end, open_, count, cur_lane, folds) -> int:
    _check_table(table)
    cap = table.numel()
    L = start.shape[0] if start.dim() == 2 else 0
    if not 0 < L <= MAX_LANES:
        raise ValueError(f"1 to {MAX_LANES} lanes, not {L}")
    for name, arr, dtype in (("start", start, torch.int64),
                             ("end", end, torch.int64),
                             ("open", open_, torch.int8),
                             ("count", count, torch.int64)):
        if (arr.dtype != dtype or arr.shape != (L, cap)
                or not arr.is_contiguous() or arr.device != table.device):
            raise ValueError(f"{name} must be a contiguous [{L}, {cap}] "
                             f"{dtype} plane on the table's device")
    if cur_lane is not None and (
            cur_lane.dtype != torch.int32 or cur_lane.shape != (cap,)
            or not cur_lane.is_contiguous()
            or cur_lane.device != table.device):
        raise ValueError(f"cur_lane must be a contiguous [{cap}] int32 "
                         "tensor on the table's device")
    if len(folds) > MAX_FOLDS:
        raise ValueError(f"at most {MAX_FOLDS} aggregate planes, not "
                         f"{len(folds)}")
    for kind, plane, *_ in folds:
        if (kind not in _KINDS or plane.dtype not in _CODES
                or plane.shape != (L, cap) or not plane.is_contiguous()
                or plane.device != table.device):
            raise ValueError(f"aggregate plane ({kind}, {plane.dtype}, "
                             f"{tuple(plane.shape)}) is not a contiguous "
                             f"[{L}, {cap}] sum|min|max plane of int32, "
                             "int64, float32 or float64")
    return L


def _check_dirty(table, dirty, dirty_shift) -> None:
    if dirty is not None and (
            dirty.dtype != torch.uint8 or dirty.dim() != 1
            or not dirty.is_contiguous() or dirty.device != table.device
            or not 0 <= dirty_shift <= 30
            or dirty.numel() < (table.numel() + (1 << dirty_shift) - 1)
            >> dirty_shift):
        raise ValueError("dirty must be a contiguous uint8 tensor of one "
                         "byte per block of 2^dirty_shift slots, on the "
                         "table's device")


# -- the step ---------------------------------------------------------------
def session_step_plain(table, start, end, open_, count, folds, cur_lane,
                       keys, ts, gap: int, fired_boundary: int, dropped,
                       late, dirty=None, dirty_shift: int = 0) -> SessionRows:
    """Plain version of ``session_step`` (any device): the reference's
    ``_sess_step`` line for line, with the probe's plain version, every
    plane updated in place."""
    B = keys.numel()
    cap = cur_lane.numel()
    L = start.shape[0]
    dev = keys.device
    keys = sanitize_keys_device(keys)
    _, kslot, ok = lookup_or_insert_plain(table, keys)
    kslot = kslot.to(torch.int64)
    valid = ok
    dropped += (~ok).sum()
    gs = kslot.clamp(min=0)
    idx = torch.arange(B, dtype=torch.int64, device=dev)
    # first occurrence per key slot in this (sorted) batch
    widx0 = torch.where(valid, kslot, cap)
    firstpos = torch.full((cap + 1,), B, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, widx0, idx, "amin")
    first = valid & (idx == firstpos[widx0])
    # merge check against ALL open lanes of the key, as they stood before
    # the batch: [ts, ts + gap) meets [s, e + gap) iff ts < e + gap and
    # s < ts + gap
    mg = torch.stack([(open_[ln, gs] > 0) & (ts > start[ln, gs] - gap)
                      & (ts < end[ln, gs] + gap) for ln in range(L)], 1)
    can_merge = mg.any(1)
    merge_lane = mg.to(torch.uint8).argmax(1)
    # late: no open session absorbs it and its own window closed already
    is_late = valid & ~can_merge & (ts + gap <= fired_boundary)
    late += is_late.sum()
    valid = valid & ~is_late
    # anchors: key-first, an in-batch jump >= gap, or the first survivor
    # after a late-dropped predecessor
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    prev_ts = torch.cat([ts[:1], ts[:-1]])
    prev_same = torch.cat([no, keys[1:] == keys[:-1]]) & ~first
    prev_late = torch.cat([no, is_late[:-1]])
    in_jump = prev_same & ((ts - prev_ts >= gap) | prev_late)
    is_anchor = valid & (first | in_jump)
    # events -> per-segment totals at the anchor's row
    last_anchor = torch.cummax(torch.where(is_anchor, idx, -1), 0).values
    seg_ok = valid & (last_anchor >= 0)
    seg_id = torch.where(seg_ok, last_anchor, B)
    sstart = torch.full((B + 1,), INT64_MAX, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, seg_id, ts, "amin")[:B]
    send = torch.full((B + 1,), INT64_MIN, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, seg_id, ts, "amax")[:B]
    scount = torch.zeros(B + 1, dtype=torch.int64, device=dev).index_add_(
        0, seg_id, torch.ones_like(seg_id))[:B]
    svals = []
    for kind, plane, values in folds:
        v = values.to(plane.dtype)
        if kind == "sum":
            buf = torch.zeros(B + 1, dtype=v.dtype, device=dev) \
                .index_add_(0, seg_id, v)
        else:
            buf = torch.full((B + 1,), _ident_max(v.dtype) if kind == "min"
                             else _ident_min(v.dtype), dtype=v.dtype,
                             device=dev).scatter_reduce_(
                0, seg_id, v, "amin" if kind == "min" else "amax")
        svals.append(buf[:B])
    seg_here = is_anchor
    smerge = can_merge & seg_here
    lastseg = torch.full((cap + 1,), -1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, torch.where(seg_here, kslot, cap), idx, "amax")
    seg_is_last = seg_here & (idx == lastseg[widx0])
    # a segment bypasses the lanes only when SETTLED: no non-late event
    # could still merge into it
    settled = send + 2 * gap <= fired_boundary
    seg_to_lane = seg_here & (smerge | seg_is_last | ~settled)
    seg_emit = seg_here & ~smerge & ~seg_is_last & settled
    # lane allocation: the j-th free lane for a key's j-th new segment
    need_alloc = seg_to_lane & ~smerge
    na = need_alloc.to(torch.int64)
    cs = torch.cumsum(na, 0)
    base = torch.zeros(cap + 1, dtype=torch.int64, device=dev) \
        .scatter_reduce_(0, torch.where(first, kslot, cap), cs - na, "amax")
    ordn = torch.where(need_alloc, cs - base[widx0] - 1, 0)
    cl = cur_lane[gs].to(torch.int64)
    open_bl = torch.stack([open_[ln, gs] > 0 for ln in range(L)], 1)
    rot = (cl[:, None] + 1 + torch.arange(L, device=dev)[None, :]) % L
    rot_free = ~torch.take_along_dim(open_bl, rot, 1)
    free_rank = torch.cumsum(rot_free.to(torch.int64), 1)
    pick = rot_free & (free_rank == (ordn + 1)[:, None])
    alloc_lane = torch.take_along_dim(
        rot, pick.to(torch.uint8).argmax(1)[:, None], 1)[:, 0]
    no_free = need_alloc & ~pick.any(1)
    dropped += no_free.sum()
    seg_to_lane = seg_to_lane & ~no_free
    lane_t = torch.where(smerge, merge_lane, alloc_lane)
    # fold the surviving segment totals into (lane, slot)
    flat = lane_t * cap + gs
    sel = seg_to_lane
    scatter_fold("min", start.view(-1), flat, sstart, sel)
    scatter_fold("max", end.view(-1), flat, send, sel)
    scatter_fold("max", open_.view(-1), flat,
                 torch.ones(B, dtype=torch.int8, device=dev), sel)
    scatter_fold("count", count.view(-1), flat, scount, sel)
    for (kind, plane, _v), sv in zip(folds, svals):
        scatter_fold(kind, plane.view(-1), flat, sv, sel)
    # cur_lane := lane of the key's last segment (when it got a lane)
    last_lane = seg_is_last & seg_to_lane
    cur_lane[kslot[last_lane]] = lane_t[last_lane].to(torch.int32)
    if dirty is not None:   # the blocks of every slot the batch touched
        dirty[kslot[ok] >> dirty_shift] = 1
    # compact the settled segments for the host's pending buffer
    n_emit = seg_emit.sum()
    outs = []
    for col, dtype in ((keys, torch.int64), (sstart, torch.int64),
                       (send, torch.int64), (scount, torch.int64),
                       *[(sv, sv.dtype) for sv in svals]):
        buf = torch.zeros(B, dtype=dtype, device=dev)
        picked = col[seg_emit]
        buf[:picked.numel()] = picked
        outs.append(buf)
    return SessionRows(n_emit, *outs[:4], outs[4:])


def session_step(table: torch.Tensor, start: torch.Tensor,
                 end: torch.Tensor, open_: torch.Tensor, count: torch.Tensor,
                 folds: Sequence[tuple], cur_lane: torch.Tensor,
                 keys: torch.Tensor, ts: torch.Tensor, gap: int,
                 fired_boundary: int, dropped: torch.Tensor,
                 late: torch.Tensor, dirty: Optional[torch.Tensor] = None,
                 dirty_shift: int = 0) -> SessionRows:
    """One session step of a batch sorted by (key, ts), IN PLACE, with no
    host sync. ``folds``: (kind, [L, capacity] plane, values [n] in the
    plane's dtype) per aggregate plane, kind in sum|min|max. ``dropped``,
    ``late``: int64 device scalars, added to. ``dirty`` (uint8, one byte
    per block of ``2^dirty_shift`` slots): the blocks of the slots the
    batch touches are set to 1. Returns the settled segments."""
    L = _check_lanes(table, start, end, open_, count, cur_lane, folds)
    n = keys.numel()
    for t, what in ((keys, "keys"), (ts, "ts")):
        if (t.dtype != torch.int64 or t.dim() != 1 or t.numel() != n
                or not t.is_contiguous() or t.device != table.device):
            raise ValueError(f"{what} must be a contiguous 1-D int64 tensor "
                             "of the batch's length on the table's device")
    for _kind, plane, values in folds:
        if (values.dtype != plane.dtype or values.shape != (n,)
                or not values.is_contiguous()
                or values.device != table.device):
            raise ValueError("each aggregate's values must be a contiguous "
                             "[n] tensor in its plane's dtype")
    for c in (dropped, late):
        if c.dtype != torch.int64 or c.numel() != 1 \
                or c.device != table.device:
            raise ValueError("dropped and late must be int64 scalars on the "
                             "table's device")
    _check_dirty(table, dirty, dirty_shift)
    if table.device.type == "cpu":
        return session_step_plain(table, start, end, open_, count, folds,
                                  cur_lane, keys, ts, gap, fired_boundary,
                                  dropped, late, dirty, dirty_shift)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    from . import kernels

    dev = table.device
    n_emit = torch.empty((), dtype=torch.int64, device=dev)
    rows = [torch.empty(n, dtype=torch.int64, device=dev) for _ in range(4)]
    evals = [torch.empty(n, dtype=plane.dtype, device=dev)
             for _k, plane, _v in folds]
    q = len(folds)
    ptrs = ctypes.c_void_p * max(q, 1)
    ints = ctypes.c_int * max(q, 1)
    rc = kernels.library("session_window").session_step_launch(
        table.data_ptr(), table.numel(), keys.data_ptr(), ts.data_ptr(), n,
        int(gap), int(fired_boundary), L, start.data_ptr(), end.data_ptr(),
        open_.data_ptr(), count.data_ptr(), cur_lane.data_ptr(), q,
        ptrs(*[p.data_ptr() for _k, p, _v in folds]),
        ints(*[_KINDS[k] for k, _p, _v in folds]),
        ints(*[_CODES[p.dtype] for _k, p, _v in folds]),
        ptrs(*[v.data_ptr() for _k, _p, v in folds]),
        dropped.data_ptr(), late.data_ptr(),
        dirty.data_ptr() if dirty is not None else None, int(dirty_shift),
        n_emit.data_ptr(), *[r.data_ptr() for r in rows],
        ptrs(*[e.data_ptr() for e in evals]),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("session_window", rc)
    note_launch("session_step")
    return SessionRows(n_emit, *rows, evals)


# -- the fire ---------------------------------------------------------------
def session_fire_plain(table, start, end, open_, count, resets, outs,
                       gap: int, boundary: int, dirty=None,
                       dirty_shift: int = 0) -> FiredRows:
    """Plain version of ``session_fire`` (any device): the reference's
    ``_sess_fire`` line for line, the planes reset in place, plus the
    dirty blocks of the reset lanes."""
    L, cap = open_.shape
    dev = open_.device
    fire_mask = ((open_ > 0) & (end + gap <= boundary)).reshape(-1)
    keys_flat = table.repeat(L)
    pos = torch.cumsum(fire_mask.to(torch.int64), 0) - 1
    n_fired = fire_mask.sum()
    can = fire_mask & (pos < cap)
    overflow = n_fired - can.sum()
    tgt = torch.where(can, pos, cap)

    def compact(src: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(cap + 1, dtype=src.dtype, device=dev)
        out[tgt[can]] = src.reshape(-1)[can]
        return out[:cap]

    out_count = compact(count)
    values = []
    for kind, plane in outs:
        if kind == "count":
            values.append(out_count)
        elif kind == "avg":
            s = compact(plane)
            values.append(s / out_count.clamp(min=1).to(s.dtype))
        else:
            values.append(compact(plane))
    rows = FiredRows(torch.stack([n_fired.clamp(max=cap), overflow]),
                     compact(keys_flat), compact(start), compact(end),
                     out_count, values)
    # reset the lanes that fit the buffer this round
    rs = can.reshape(L, cap)
    open_[rs] = 0
    start[rs] = INT64_MAX
    end[rs] = INT64_MIN
    count[rs] = 0
    for kind, plane in resets:
        plane[rs] = _reset_value(kind, plane.dtype)
    if dirty is not None:
        dirty[torch.nonzero(rs.any(0)).flatten() >> dirty_shift] = 1
    return rows


def session_fire(table: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
                 open_: torch.Tensor, count: torch.Tensor,
                 resets: Sequence[tuple], outs: Sequence[tuple], gap: int,
                 boundary: int, dirty: Optional[torch.Tensor] = None,
                 dirty_shift: int = 0) -> FiredRows:
    """One fire round, IN PLACE. ``resets``: (kind, [L, capacity] plane)
    of every aggregate plane, reset to its kind's identity where a lane
    fires. ``outs``: (kind, plane) per output column, kind in
    count|avg|sum|min|max (the count plane for count, the sum plane for
    avg). ``dirty`` as in ``session_step``. Returns the fired rows."""
    _check_lanes(table, start, end, open_, count, None,
                 [(k, p) for k, p in resets])
    for kind, plane in outs:
        if kind == "count":
            continue
        if kind not in _OUT_KINDS or plane.dtype not in _CODES \
                or plane.shape != start.shape or not plane.is_contiguous() \
                or plane.device != table.device:
            raise ValueError(f"output ({kind}, {plane.dtype}) is not a "
                             "count|avg|sum|min|max output of a contiguous "
                             "plane shaped like the lanes")
    if len(outs) > 2 * MAX_FOLDS:
        raise ValueError(f"at most {2 * MAX_FOLDS} outputs")
    _check_dirty(table, dirty, dirty_shift)
    if table.device.type == "cpu":
        return session_fire_plain(table, start, end, open_, count, resets,
                                  outs, gap, boundary, dirty, dirty_shift)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    for t in (start, end, open_, count, *[p for _k, p in resets]):
        if t.data_ptr() % 16:
            raise ValueError("session_fire reads the planes 16 bytes at a "
                             "time: each must start on a 16-byte boundary")
    from . import kernels

    lib = kernels.library("session_window")
    dev = table.device
    L, cap = open_.shape
    rows = [torch.empty(cap, dtype=torch.int64, device=dev)
            for _ in range(4)]
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.session_fire_scratch_words(L * cap),
                          dtype=torch.int64, device=dev)
    values, kernel_outs = [], []
    for kind, plane in outs:
        if kind == "count":
            values.append(rows[3])
            continue
        out = torch.empty(cap, dtype=plane.dtype, device=dev)
        values.append(out)
        kernel_outs.append((_OUT_KINDS[kind], plane, out))
    q, o = len(resets), len(kernel_outs)
    rc = lib.session_fire_launch(
        table.data_ptr(), cap, L, int(gap), int(boundary), start.data_ptr(),
        end.data_ptr(), open_.data_ptr(), count.data_ptr(), q,
        (ctypes.c_void_p * max(q, 1))(*[p.data_ptr() for _k, p in resets]),
        (ctypes.c_int * max(q, 1))(*[_KINDS[k] for k, _p in resets]),
        (ctypes.c_int * max(q, 1))(*[_CODES[p.dtype] for _k, p in resets]),
        o, (ctypes.c_int * max(o, 1))(*[k for k, _p, _o in kernel_outs]),
        (ctypes.c_void_p * max(o, 1))(*[p.data_ptr()
                                        for _k, p, _o in kernel_outs]),
        (ctypes.c_int * max(o, 1))(*[_CODES[p.dtype]
                                     for _k, p, _o in kernel_outs]),
        (ctypes.c_void_p * max(o, 1))(*[out.data_ptr()
                                        for _k, _p, out in kernel_outs]),
        *[r.data_ptr() for r in rows],
        dirty.data_ptr() if dirty is not None else None, int(dirty_shift),
        counts.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("session_window", rc)
    note_launch("session_fire")
    return FiredRows(counts, *rows, values)
