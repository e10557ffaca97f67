"""The incremental fire engine's device programs: the pane seal and the
window rebuild (port of ``_seal_program`` and ``_rebuild_program`` in
``flink_tpu/runtime/operators/device_window.py``).

A plane signature is a list of ``(kind, pane, state, view)``:

* ``pane``: the ``[ring, capacity]`` pane plane of the aggregate;
* ``state``: for an invertible kind (sum, count) the running window
  accumulator ``[capacity]``; for min/max the heap-ordered merge tree
  ``[2L, capacity]`` (``segment_ops.merge_tree_build``), L a power of two
  at least the ring;
* ``view``: ``[capacity]``, written with this fire's merged window.

``state`` and ``view`` share one dtype, which may be wider than the
pane's (an int32 sum plane keeps an int64 window). Both programs update
``state`` IN PLACE and write ``view``; rows, leaves and ``sub_valid`` are
host ints, so neither waits for the card (the rebuild's row and leaf list
goes to the card as a non-blocking copy from pinned memory, so the ring
and the tree take any size).

On a CUDA tensor each is one launch of its hand-written kernel
(``csrc/window_seal.cu``); on a CPU tensor it runs the plain version, the
reference's algorithm step by step. The plain rebuild folds the rows in
pane order, as the kernel does, so the two agree bit for bit on floats
too.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ..device import note_launch
from .segment_ops import AGG_COMBINE2, AGG_INVERT, INVERTIBLE_KINDS, \
    identity, merge_tree_build, merge_tree_update

__all__ = ["seal", "rebuild", "seal_plain", "rebuild_plain", "MAX_PLANES"]

#: torch dtype -> dtype code of csrc/window_seal.cu
_CODES = {torch.int64: 0, torch.int32: 1, torch.float32: 2,
          torch.float64: 3}
#: aggregate kind -> kind code of csrc/window_seal.cu
_KINDS = {"sum": 0, "count": 0, "min": 1, "max": 2}
MAX_PLANES = 8


def _check(planes: Sequence[tuple]) -> tuple[int, int]:
    """Validate a plane signature; returns (ring, tree leaves L or 0)."""
    if not 0 < len(planes) <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, not {len(planes)}")
    dev = planes[0][1].device
    ring, cap = planes[0][1].shape
    leaves = 0
    for kind, pane, state, view in planes:
        if kind not in _KINDS:
            raise ValueError(f"unknown aggregate kind {kind!r}")
        if pane.shape != (ring, cap) or pane.dtype not in _CODES:
            raise ValueError(f"pane plane ({pane.dtype}, {tuple(pane.shape)})"
                             f" is not a [{ring}, {cap}] plane of a known "
                             "dtype")
        if kind in INVERTIBLE_KINDS:
            want = (cap,)
        else:
            if state.dim() != 2 or state.shape[0] < 2 * ring \
                    or state.shape[0] & (state.shape[0] - 1):
                raise ValueError("a merge tree is [2L, capacity] with L a "
                                 "power of two at least the ring")
            if leaves and state.shape[0] // 2 != leaves:
                raise ValueError("every merge tree needs the same L")
            leaves = state.shape[0] // 2
            want = (2 * leaves, cap)
        if state.shape != want or view.shape != (cap,) \
                or state.dtype != view.dtype or state.dtype not in _CODES:
            raise ValueError(f"state {tuple(state.shape)} and view "
                             f"{tuple(view.shape)} must be {want} and "
                             f"({cap},) of one known dtype")
        if state.dtype.is_floating_point != pane.dtype.is_floating_point \
                or state.element_size() < pane.element_size():
            raise ValueError(f"a {pane.dtype} pane plane cannot accumulate "
                             f"in {state.dtype}")
        for t in (pane, state, view):
            if t.device != dev or not t.is_contiguous():
                raise ValueError("planes must be contiguous, on one device")
    return ring, leaves


def seal_plain(planes: Sequence[tuple], new_row: int, sub_row: int,
               sub_valid: bool, new_leaf: int, old_leaf: int) -> None:
    """Plain version of ``seal`` (any device)."""
    for kind, pane, state, view in planes:
        new = pane[new_row].to(state.dtype)
        if kind in INVERTIBLE_KINDS:
            v = AGG_COMBINE2[kind](state, new)
            view.copy_(v)
            state.copy_(AGG_INVERT[kind](v, pane[sub_row].to(state.dtype))
                        if sub_valid else v)
        else:
            # clear the retiring leaf first: no live pane shares its leaf
            merge_tree_update(kind, state, old_leaf,
                              identity(kind, state.dtype))
            merge_tree_update(kind, state, new_leaf, new)
            view.copy_(state[1])


def rebuild_plain(planes: Sequence[tuple], rows: Sequence[int],
                  leaves: Sequence[int], sub_row: int,
                  sub_valid: bool) -> None:
    """Plain version of ``rebuild`` (any device): the rows fold in pane
    order."""
    for kind, pane, state, view in planes:
        ident = identity(kind, state.dtype)
        if kind in INVERTIBLE_KINDS:
            acc = torch.full_like(view, ident)
            for r in rows:
                acc = AGG_COMBINE2[kind](acc, pane[r].to(state.dtype))
            view.copy_(acc)
            state.copy_(AGG_INVERT[kind](acc, pane[sub_row].to(state.dtype))
                        if sub_valid else acc)
        else:
            L = state.shape[0] // 2
            leaf_rows = torch.full((L,) + tuple(view.shape), ident,
                                   dtype=state.dtype, device=state.device)
            for r, leaf in zip(rows, leaves):
                leaf_rows[leaf] = pane[r]
            state.copy_(merge_tree_build(kind, leaf_rows))
            view.copy_(state[1])


def _launch_args(planes, ring: int, leaves: int) -> list:
    n = len(planes)
    ptrs = ctypes.c_void_p * n
    ints = ctypes.c_int * n
    return [planes[0][1].shape[1], ring, n,
            ptrs(*[p.data_ptr() for _k, p, _s, _v in planes]),
            ptrs(*[s.data_ptr() for _k, _p, s, _v in planes]),
            ptrs(*[v.data_ptr() for _k, _p, _s, v in planes]),
            ints(*[_KINDS[k] for k, _p, _s, _v in planes]),
            ints(*[_CODES[p.dtype] for _k, p, _s, _v in planes]),
            ints(*[_CODES[s.dtype] for _k, _p, s, _v in planes]),
            leaves]


def _require_cuda(planes) -> None:
    dev = planes[0][1].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")


def _tree_leaves(ring: int, leaves: int) -> int:
    """L for the kernel: the trees' own, or any valid one when the
    signature has no tree."""
    if leaves:
        return leaves
    return 1 << (ring - 1).bit_length() if ring > 1 else 2


def seal(planes: Sequence[tuple], new_row: int, sub_row: int,
         sub_valid: bool, new_leaf: int, old_leaf: int) -> None:
    """Seal the pane at ring row ``new_row`` (tree leaf ``new_leaf``) into
    every plane's state and write the window's view; the pane at ring row
    ``sub_row`` (leaf ``old_leaf``) leaves the window. Its row is
    subtracted only when ``sub_valid``: a pane below the first one seen
    holds no data and its ring row may alias a live pane."""
    ring, leaves = _check(planes)
    if planes[0][1].device.type == "cpu":
        return seal_plain(planes, new_row, sub_row, sub_valid, new_leaf,
                          old_leaf)
    _require_cuda(planes)
    from . import kernels

    L = _tree_leaves(ring, leaves)
    rc = kernels.library("window_seal").window_seal_launch(
        *_launch_args(planes, ring, L), int(new_row), int(sub_row),
        1 if sub_valid else 0, int(new_leaf) % L, int(old_leaf) % L,
        torch.cuda.current_stream(planes[0][1].device).cuda_stream)
    kernels.check("window_seal", rc)
    note_launch("window_seal")


def rebuild(planes: Sequence[tuple], rows: Sequence[int],
            leaves: Sequence[int], sub_row: int, sub_valid: bool) -> None:
    """Rebuild every plane's state and view from the window's live pane
    rows ``rows`` (in pane order; ``leaves[i]`` is the tree leaf of
    ``rows[i]``), then retire ``sub_row`` from the invertible windows when
    ``sub_valid``."""
    ring, tree_leaves = _check(planes)
    if len(rows) != len(leaves):
        raise ValueError("one leaf per row")
    if planes[0][1].device.type == "cpu":
        return rebuild_plain(planes, rows, leaves, sub_row, sub_valid)
    _require_cuda(planes)
    from . import kernels

    L = _tree_leaves(ring, tree_leaves)
    rows = [int(r) for r in rows]
    leaf_row = [-1] * L
    for r, leaf in zip(rows, leaves):
        leaf = int(leaf) % L
        if not 0 <= r < ring or (tree_leaves and leaf_row[leaf] >= 0):
            raise ValueError(f"rows {rows} must lie in the ring of {ring} "
                             f"and take distinct leaves of {L}")
        leaf_row[leaf] = r
    dev = planes[0][1].device
    # the live rows, then the ring row of each leaf; the pinned source lets
    # the copy queue on the stream without a wait, and the host allocator
    # keeps the buffer until the copy has run
    index = torch.tensor(rows + leaf_row, dtype=torch.int32).pin_memory() \
        .to(dev, non_blocking=True)
    rc = kernels.library("window_seal").window_rebuild_launch(
        *_launch_args(planes, ring, L), len(rows), index.data_ptr(),
        int(sub_row), 1 if sub_valid else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    kernels.check("window_seal", rc)
    note_launch("window_rebuild")
