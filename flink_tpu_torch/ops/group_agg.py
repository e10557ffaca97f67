"""The device GROUP BY step: one micro-batch of the changelog aggregation
on float64 accumulator planes (port of
``flink_tpu/sql/device_group_agg.py::_gagg_program``).

A step reads the PREV values of every touched group, folds the batch,
resets the groups whose signed row count drained to <= 0 to their
identities, reads the NEW values, and compacts one row per touched group,
in the order of each group's first row in the batch:

* ``planes``: float64 ``[capacity]`` tensors, updated in place; plane 0 is
  the signed row count (``__rc__``). ``kinds`` names each plane's fold,
  ``sum`` (``value * sign``, or the sign itself where ``cols`` is -1: a
  COUNT plane), ``min`` or ``max`` (the raw value; the sign is ignored, the
  reference's append-only degradation). A drained group's planes go to 0,
  +inf and -inf.
* ``slots`` int32 ``[n]`` (-1: the row folds nowhere), ``sign`` float64
  ``[n]`` (-1 for UPDATE_BEFORE and DELETE rows), ``vals`` float64
  ``[n_cols, n]``, ``n_valid``: rows at or past it fold nowhere.
* ``rowpos``, an int32 ``[capacity, 2]`` persistent scratch that holds
  (``NO_ROW``, ``NO_LAST``) everywhere between steps (a step restores what
  it touched): the first and the last row of each touched slot (views
  ``firstpos`` and ``lastpos`` of a step), and, once a group of several
  rows is compacted, its position (``~position`` in the first-row half, a
  value no row index equals). One 8-byte entry a slot: both halves share a
  32-byte sector.
* ``dirty`` (the state backend's block bitmap, or None): the blocks of
  the touched slots are marked.
* Out: ``n_groups`` (int64 ``[1]`` on the device), ``row_idx`` int32
  ``[n]`` and ``comp`` float64 ``[n, 2 * planes]`` (PREV values, then NEW),
  valid in their first ``n_groups`` rows.

min and max fold with the reference's semantics (XLA's scatter-min and
scatter-max on the CPU): a NaN wins, -0.0 is below +0.0.

The step runs four stages in order: ``first`` (each touched slot's first
and last row), ``compact`` (the groups in first-row order, their PREV
values), ``fold`` and ``emit`` (a drained group's reset and NEW, at the
group's last row). The compaction finishes a group whose first row is
also its last (its only row in the batch): the fold, a drained group's
reset and NEW; the fold and the emit skip its row (``single``). Each stage
is a kernel of ``csrc/group_agg.cu`` on a CUDA tensor (``group_agg_first``,
``_compact``, ``_fold``, ``_emit``, each launch counted in
``KERNEL_LAUNCHES``; a batch of no rows launches nothing) and its plain
PyTorch version on a CPU tensor; ``group_agg_step`` runs the four (one call
enqueues them all on the card), ``group_agg_step_plain`` runs the plain
versions on any device.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..device import note_launch

__all__ = ["NO_ROW", "NO_LAST", "GroupAggStep", "make_step",
           "group_agg_first", "group_agg_compact",
           "group_agg_fold", "group_agg_emit", "group_agg_step",
           "group_agg_first_plain", "group_agg_compact_plain",
           "group_agg_fold_plain", "group_agg_emit_plain",
           "group_agg_step_plain", "new_rowpos"]

NO_ROW = (1 << 31) - 1
NO_LAST = -1
MAX_PLANES = 32
_KINDS = {"sum": 0, "min": 1, "max": 2}
_STAGES = ("first", "compact", "fold", "emit", "step")
_IDENTITY = {"sum": 0.0, "min": float("inf"), "max": float("-inf")}
_I64_MAX = (1 << 63) - 1


@dataclass
class GroupAggStep:
    """One step's tensors: inputs, the scratches and outputs."""

    planes: list
    kinds: list
    cols: list
    slots: torch.Tensor
    sign: torch.Tensor
    vals: torch.Tensor
    n_valid: int
    rowpos: torch.Tensor
    single: torch.Tensor
    dirty: Optional[torch.Tensor]
    dirty_shift: int
    row_idx: torch.Tensor
    comp: torch.Tensor
    n_groups: torch.Tensor
    status: Optional[torch.Tensor]

    @property
    def firstpos(self) -> torch.Tensor:
        return self.rowpos[:, 0]

    @property
    def lastpos(self) -> torch.Tensor:
        return self.rowpos[:, 1]


def new_rowpos(capacity: int, device) -> torch.Tensor:
    out = torch.empty((capacity, 2), dtype=torch.int32, device=device)
    out[:, 0] = NO_ROW
    out[:, 1] = NO_LAST
    return out


def _check(planes, kinds, cols, slots, sign, vals, n_valid, rowpos,
           dirty) -> None:
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, not {len(planes)}")
    if len(kinds) != len(planes) or len(cols) != len(planes):
        raise ValueError("one kind and one column per plane")
    if kinds[0] != "sum" or cols[0] != -1:
        raise ValueError("plane 0 is the signed row count: sum of the sign")
    dev = slots.device
    cap = planes[0].numel()
    n = slots.numel()
    for p, k, c in zip(planes, kinds, cols):
        if (p.dtype != torch.float64 or p.dim() != 1 or p.numel() != cap
                or not p.is_contiguous() or p.device != dev):
            raise ValueError("planes are contiguous float64 [capacity] "
                             "tensors on the slots' device")
        if k not in _KINDS:
            raise ValueError(f"unknown fold {k!r}")
        if k != "sum" and c < 0:
            raise ValueError(f"a {k} plane folds a value column")
        if c >= vals.shape[0]:
            raise ValueError(f"value column {c} of {vals.shape[0]}")
    for name, t, dtype, shape in (
            ("slots", slots, torch.int32, (n,)),
            ("sign", sign, torch.float64, (n,)),
            ("vals", vals, torch.float64, (vals.shape[0], n)),
            ("rowpos", rowpos, torch.int32, (cap, 2))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor "
                             f"of shape {shape} on {dev}")
    if dirty is not None and (dirty.dtype != torch.uint8
                              or dirty.device != dev
                              or not dirty.is_contiguous()):
        raise ValueError("dirty is a contiguous uint8 tensor on the slots' "
                         "device")
    if not 0 <= n_valid <= n:
        raise ValueError(f"n_valid {n_valid} outside [0, {n}]")


def make_step(planes: Sequence[torch.Tensor], kinds: Sequence[str],
              cols: Sequence[int], slots: torch.Tensor, sign: torch.Tensor,
              vals: torch.Tensor, n_valid: int, rowpos: torch.Tensor,
              dirty: Optional[torch.Tensor] = None,
              dirty_shift: int = 9) -> GroupAggStep:
    """Check the inputs and allocate the outputs (and, on the card, the
    compaction's look-back scratch)."""
    _check(planes, kinds, cols, slots, sign, vals, n_valid, rowpos, dirty)
    dev = slots.device
    n = slots.numel()
    status = None
    if dev.type == "cuda":
        from . import kernels

        words = kernels.library("group_agg").group_agg_scratch_words(n)
        status = torch.empty(words, dtype=torch.int64, device=dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return GroupAggStep(
        list(planes), list(kinds), [int(c) for c in cols], slots, sign,
        vals, int(n_valid), rowpos,
        torch.empty(n, dtype=torch.uint8, device=dev), dirty,
        int(dirty_shift),
        torch.empty(n, dtype=torch.int32, device=dev),
        torch.empty((n, 2 * len(planes)), dtype=torch.float64, device=dev),
        torch.zeros(1, dtype=torch.int64, device=dev), status)


def _launch(stage: str, st: GroupAggStep) -> None:
    from . import kernels

    P = len(st.planes)
    dev = st.slots.device
    rc = kernels.library("group_agg").group_agg_launch(
        _STAGES.index(stage),
        (ctypes.c_void_p * P)(*[p.data_ptr() for p in st.planes]),
        (ctypes.c_int * P)(*[_KINDS[k] for k in st.kinds]),
        (ctypes.c_int * P)(*st.cols), P, st.planes[0].numel(),
        st.slots.data_ptr(), st.sign.data_ptr(),
        st.vals.data_ptr() if st.vals.numel() else None,
        st.slots.numel(), st.n_valid, st.rowpos.data_ptr(),
        st.single.data_ptr(),
        st.dirty.data_ptr() if st.dirty is not None else None,
        st.dirty_shift, st.row_idx.data_ptr(), st.comp.data_ptr(),
        st.n_groups.data_ptr(), st.status.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("group_agg", rc)
    for name in _STAGES[:4] if stage == "step" else (stage,):
        note_launch(f"group_agg_{name}")


def _on_card(st: GroupAggStep) -> bool:
    return st.slots.device.type != "cpu" and st.slots.numel() > 0


def _stage(stage: str, plain):
    def run(st: GroupAggStep) -> None:
        if st.slots.device.type == "cpu":
            plain(st)
        elif _on_card(st):
            _launch(stage, st)

    run.__name__ = f"group_agg_{stage}"
    run.__doc__ = (f"The {stage} stage: its kernel on a CUDA tensor, "
                   f"``group_agg_{stage}_plain`` on a CPU tensor.")
    return run


# -- plain versions ----------------------------------------------------------
def _valid(st: GroupAggStep):
    i = torch.arange(st.slots.numel(), device=st.slots.device)
    return (st.slots >= 0) & (i < st.n_valid), i


def group_agg_first_plain(st: GroupAggStep) -> None:
    """rowpos[slot] = (min(first, row), max(last, row)) over the batch's
    valid rows."""
    valid, i = _valid(st)
    s = st.slots[valid].long()
    rows = i[valid].to(torch.int32)
    st.firstpos.scatter_reduce_(0, s, rows, "amin")
    st.lastpos.scatter_reduce_(0, s, rows, "amax")


def group_agg_compact_plain(st: GroupAggStep) -> None:
    """The rows that are their slot's first, in batch order: their index
    and every plane's value before the fold. A group whose first row is
    also its last (its only row in the batch) takes the whole step here:
    the fold, a drained group's reset, NEW, the dirty block and both
    scratches restored; its row is marked in ``single``. Every other
    group's position is left in firstpos as ``~position``."""
    valid, i = _valid(st)
    s = st.slots.long().clamp(min=0)
    first = valid & (st.firstpos[s] == i)
    single = first & (st.lastpos[s] == i)
    st.single.copy_(single)
    rows = i[first]
    g = rows.numel()
    st.row_idx[:g] = rows.to(torch.int32)
    ss = st.slots[rows].long()
    for q, plane in enumerate(st.planes):
        st.comp[:g, q] = plane[ss]
    pos = torch.arange(g, device=ss.device)
    one = single[first]
    st.firstpos[ss[~one]] = ~pos[~one].to(torch.int32)
    _fold_rows(st, rows[one])
    _emit_groups(st, ss[one], pos[one])
    st.n_groups.fill_(g)


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 whose signed order is the floats' total order
    (-0.0 below +0.0); its own inverse on the bits."""
    b = x.view(torch.int64)
    return torch.where(b < 0, b ^ _I64_MAX, b)


def _fold_extreme(plane: torch.Tensor, idx: torch.Tensor, v: torch.Tensor,
                  kind: str) -> None:
    """plane[idx] = min or max(plane[idx], v) with NaN winning and -0.0
    below +0.0, on the touched slots only."""
    u, inv = torch.unique(idx, return_inverse=True)
    old = plane[u]
    key = _order_key(old)
    key.scatter_reduce_(0, inv, _order_key(v.contiguous()),
                        "amin" if kind == "min" else "amax")
    out = _order_key(key).view(torch.float64)
    nan_hit = torch.zeros(u.numel(), dtype=torch.bool, device=plane.device)
    nan_hit[inv[torch.isnan(v)]] = True
    out = torch.where(torch.isnan(old), old,
                      torch.where(nan_hit, torch.full_like(out, torch.nan),
                                  out))
    plane[u] = out


def _fold_rows(st: GroupAggStep, rows: torch.Tensor) -> None:
    """Rows ``rows`` (valid ones) fold into their slots, plane by plane."""
    s = st.slots[rows].long()
    sign = st.sign[rows]
    for plane, kind, c in zip(st.planes, st.kinds, st.cols):
        if kind == "sum":
            plane.index_add_(0, s, sign if c < 0 else st.vals[c][rows] * sign)
        elif s.numel():
            _fold_extreme(plane, s, st.vals[c][rows], kind)


def _emit_groups(st: GroupAggStep, s: torch.Tensor,
                 pos: torch.Tensor) -> None:
    """Groups at slots ``s`` after their last fold: drained (count <= 0)
    planes to their identities, the NEW values at positions ``pos``, the
    dirty blocks, and both scratches restored."""
    P = len(st.planes)
    ds = s[st.planes[0][s] <= 0]
    for q, (plane, kind) in enumerate(zip(st.planes, st.kinds)):
        plane[ds] = _IDENTITY[kind]
        st.comp[pos, P + q] = plane[s]
    if st.dirty is not None:
        st.dirty[s >> st.dirty_shift] = 1
    st.firstpos[s] = NO_ROW
    st.lastpos[s] = NO_LAST


def _others(st: GroupAggStep):
    """The valid rows that the compaction did not take, and the row
    indices."""
    valid, i = _valid(st)
    return valid & (st.single == 0), i


def group_agg_fold_plain(st: GroupAggStep) -> None:
    """Every valid row folds into its slot, plane by plane, but the rows
    the compaction took."""
    rows, i = _others(st)
    _fold_rows(st, i[rows])


def group_agg_emit_plain(st: GroupAggStep) -> None:
    """Per group of more than one row (the compaction emitted the others),
    at its last row: drained (count <= 0) planes to their identities, the
    NEW values at the group's position, the dirty block, and both
    scratches restored."""
    rows, i = _others(st)
    s = st.slots.long().clamp(min=0)
    s = s[rows & (st.lastpos[s] == i)]
    _emit_groups(st, s, (~st.firstpos[s]).long())


group_agg_first = _stage("first", group_agg_first_plain)
group_agg_compact = _stage("compact", group_agg_compact_plain)
group_agg_fold = _stage("fold", group_agg_fold_plain)
group_agg_emit = _stage("emit", group_agg_emit_plain)


def _plain_schedule(st: GroupAggStep) -> None:
    group_agg_first_plain(st)
    group_agg_compact_plain(st)
    group_agg_fold_plain(st)
    group_agg_emit_plain(st)


def group_agg_step(*args, **kw) -> GroupAggStep:
    """One step (``make_step``'s arguments): the four stages in order, as
    kernels on a CUDA tensor (one call enqueues them all). Returns the
    step with its outputs."""
    st = make_step(*args, **kw)
    if st.slots.device.type == "cpu":
        _plain_schedule(st)
    elif _on_card(st):
        _launch("step", st)
    return st


def group_agg_step_plain(*args, **kw) -> GroupAggStep:
    """The plain version of ``group_agg_step``, on any device: the same
    schedule in PyTorch operators."""
    st = make_step(*args, **kw)
    _plain_schedule(st)
    return st
