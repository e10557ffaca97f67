"""Segment folds: the device aggregation primitives (port of
``flink_tpu/ops/segment_ops.py``).

Each micro-batch folds into per-(pane, slot) accumulators with one
scatter per aggregate; a window fire merges pane rows with one reduction.
The port updates accumulators IN PLACE (``index_add_`` /
``scatter_reduce_``) where the reference rebuilt them functionally and
donated the old buffer. These stay PyTorch operators in this slice: on the
TPU the fold was an XLA scatter, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["AGG_INITS", "AGG_FOLDS", "AGG_MERGES", "AGG_COMBINE2",
           "AGG_INVERT", "INVERTIBLE_KINDS", "identity", "make_accumulator",
           "scatter_fold", "pow2_ceil", "merge_rows", "merge_tree_build",
           "merge_tree_update", "merge_tree_root", "fire_cost",
           "seal_cost"]


def _max_of(dtype: torch.dtype):
    return (torch.finfo(dtype).max if dtype.is_floating_point
            else torch.iinfo(dtype).max)


def _min_of(dtype: torch.dtype):
    return (torch.finfo(dtype).min if dtype.is_floating_point
            else torch.iinfo(dtype).min)


#: kind -> identity element (a Python scalar) of an accumulator dtype
AGG_INITS = {
    "sum": lambda dtype: 0,
    "count": lambda dtype: 0,
    "min": _max_of,
    "max": _min_of,
}


def _fold_add(acc, idx, vals):
    return acc.index_add_(0, idx, vals)


def _fold_min(acc, idx, vals):
    return acc.scatter_reduce_(0, idx, vals, "amin")


def _fold_max(acc, idx, vals):
    return acc.scatter_reduce_(0, idx, vals, "amax")


#: kind -> in-place scatter fold acc[idx] op= vals
AGG_FOLDS = {"sum": _fold_add, "count": _fold_add, "min": _fold_min,
             "max": _fold_max}

#: kind -> reduction over axis 0 of a [rows, capacity] block; integer
#: sums widen to int64 as the reference's jnp.sum does (an int32 count
#: plane merges into int64 window counts)
AGG_MERGES = {
    "sum": lambda x: x.sum(0),
    "count": lambda x: x.sum(0),
    "min": lambda x: x.amin(0),
    "max": lambda x: x.amax(0),
}

#: kind -> elementwise pairwise combine a (+) b: the binary form of the
#: pane merge, used by the incremental fire engine (running window
#: accumulators and merge-tree levels)
AGG_COMBINE2 = {"sum": torch.add, "count": torch.add,
                "min": torch.minimum, "max": torch.maximum}

#: kind -> inverse combine a (-) b, for invertible aggregates only
AGG_INVERT = {"sum": torch.sub, "count": torch.sub}

#: kinds whose combine has an inverse: a running window accumulator can
#: retire a pane by subtraction. min/max use a merge tree instead.
INVERTIBLE_KINDS = frozenset(AGG_INVERT)


def identity(kind: str, dtype: torch.dtype):
    return AGG_INITS[kind](dtype)


def make_accumulator(kind: str, shape: tuple, dtype: torch.dtype,
                     device) -> torch.Tensor:
    return torch.full(shape, identity(kind, dtype), dtype=dtype,
                      device=device)


def scatter_fold(kind: str, acc: torch.Tensor, flat_idx: torch.Tensor,
                 values: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Fold a batch into a flat accumulator IN PLACE: acc[flat_idx] op=
    values, masked by ``valid`` (invalid rows fold the identity into slot
    0, the reference's rule). Returns ``acc``."""
    ident = identity(kind, acc.dtype)
    idx = torch.where(valid, flat_idx.to(torch.int64), 0)
    vals = torch.where(valid, values.to(acc.dtype), ident)
    return AGG_FOLDS[kind](acc, idx, vals)


def _runs(rows: list[int]) -> list[tuple[int, int]]:
    """Consecutive ring rows as [start, stop) runs (a window wraps the ring
    at most once), so a merge reads each row once through slicing and
    needs no index tensor on the device."""
    runs: list[tuple[int, int]] = []
    for r in rows:
        if runs and runs[-1][1] == r:
            runs[-1] = (runs[-1][0], r + 1)
        else:
            runs.append((r, r + 1))
    return runs


def merge_rows(kind: str, arr: torch.Tensor, rows: list[int],
               idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge the pane rows ``rows`` of a [ring, capacity] plane; with
    ``idx``, only at those slots (the winner-only merge of a top-k fire):
    the full fire of the window operators."""
    out = None
    for a, b in _runs(rows):
        block = arr[a:b] if idx is None else arr[a:b].index_select(1, idx)
        part = AGG_MERGES[kind](block)
        out = part if out is None else AGG_COMBINE2[kind](out, part)
    return out


def merge_tree_build(kind: str, leaves: torch.Tensor) -> torch.Tensor:
    """Heap-ordered merge tree [2L, capacity] over ``leaves`` [L, capacity]
    (L a power of two): node 0 is the identity, node 1 the root, the
    children of node i are 2i and 2i + 1, and the leaves are rows [L, 2L).
    A window fire reads the root; a pane seal rewrites one leaf and its
    log2(L) ancestors."""
    combine = AGG_COMBINE2[kind]
    levels = [leaves]
    cur = leaves
    while cur.shape[0] > 1:
        cur = combine(cur[0::2], cur[1::2])
        levels.append(cur)
    ident = torch.full((1,) + tuple(leaves.shape[1:]),
                       identity(kind, leaves.dtype), dtype=leaves.dtype,
                       device=leaves.device)
    return torch.cat([ident] + list(reversed(levels)), 0)


def merge_tree_update(kind: str, tree: torch.Tensor, leaf_pos: int,
                      value: torch.Tensor) -> torch.Tensor:
    """Set leaf ``leaf_pos`` (in [0, L)) of a heap tree [2L, capacity] to
    ``value`` [capacity] and recompute its ancestor path, IN PLACE.
    Returns ``tree``."""
    L = tree.shape[0] // 2
    combine = AGG_COMBINE2[kind]
    idx = int(leaf_pos) + L
    tree[idx] = value
    while idx > 1:
        idx //= 2
        tree[idx] = combine(tree[2 * idx], tree[2 * idx + 1])
    return tree


def merge_tree_root(tree: torch.Tensor) -> torch.Tensor:
    """The full-tree merge: root of a heap-ordered merge tree."""
    return tree[1]


def pow2_ceil(n: int) -> int:
    """Next power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def fire_cost(n_rows: int, capacity: int, plane_sizes: tuple, topk: int,
              out_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a fire from its shapes: every plane's ``n_rows``
    pane rows (1: an incremental fire's sealed view) read once, the table
    read once (8 bytes a slot), the emit mask written (1 byte a slot) and
    the outputs written once: the winners' keys and columns under top k,
    else a [capacity] column each; one operation a merged element. The
    select inside a top-k fire is ``ops.pallas_topk``'s own sample."""
    merged = n_rows * capacity * sum(plane_sizes)
    rows_out = topk if topk else capacity
    return (n_rows * capacity * len(plane_sizes),
            merged + capacity * 9 + rows_out * (8 + sum(out_sizes)))


def seal_cost(capacity: int, rows: int, tree_size: int,
              planes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a seal or rebuild from its shapes: ``rows`` pane
    rows of every plane read once (a seal: the newest and the retiring
    row), the running state read and written once (an invertible
    aggregate's [capacity] accumulator; a merge tree's path of
    log2(2 * tree_size) nodes a slot, or its 2 * tree_size nodes when a
    rebuild writes it whole) and the view written once; one operation an
    element moved. ``planes``: (is_tree, pane item size, state item size)
    per plane."""
    depth = max(1, (2 * tree_size).bit_length() - 1)
    nbytes = flops = 0
    for is_tree, s_pane, s_state in planes:
        state = (2 * tree_size if rows > 2 else depth) if is_tree else 1
        elems = rows + 2 * state + 1
        nbytes += capacity * (rows * s_pane + (2 * state + 1) * s_state)
        flops += capacity * elems
    return flops, nbytes
