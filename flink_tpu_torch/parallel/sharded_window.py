"""Sharded slice-window aggregation over the mesh (port of
``flink_tpu/parallel/sharded_window.py``).

Each shard holds the keyed state of its contiguous key-group range
(``mesh.shard_ranges``): a ``[capacity]`` hash table, one ``[ring,
capacity]`` plane per aggregate and a dropped counter, as tensors of its
own on its shard's device. A step of S source blocks of B rows is

    one ``exchange_bucket`` launch (key groups of the raw keys, routing by
    ownership, each row written into its destination's buffer, in batch
    order within its source's segment, as the reference's stable
    argsort leaves it)                                                 ->
    one counted ``ingest_step`` launch per shard (lookup-or-insert and
    one fold per plane, the rows counted on the device)

which replaces the reference's ``_step_program`` (routing, the capacity-
bounded ``all_to_all`` rounds in ``lax.while_loop`` with a ``pmax`` of the
round count, the probe and the scatter folds). The buffers are sized for
the worst case, so the step runs no rounds and reads nothing on the host.

A fire merges each shard's window (``segment_ops.merge_rows``, the
single-device fire's row-run merge), builds the emit mask and the health
scalars (total drops, the largest shard's occupancy), and, for a top k,
runs the two-phase ``global_topk``: the radix select per shard
(``hist256``), then over the D * k candidates. The incremental planes seal and rebuild shard
by shard with ``csrc/window_seal.cu``; the retire is one ``fill_`` a
shard's ring row. Nothing here reads the device on the host except
``snapshot``.

Program caching: the reference keys every program by
``local_signature`` so a rescale that keeps local shapes compiles nothing.
The port compiles nothing per shape (its kernels build once per process);
``local_signature`` is kept as the same key for the same contract.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..core.keygroups import key_groups_device
from ..device import numpy_dtype, torch_dtype
from ..ops.exchange import ExchangeBuffers, exchange_bucket
from ..ops.hash_table import EMPTY_KEY, ingest_step, lookup_or_insert, \
    make_table
from ..ops.segment_ops import INVERTIBLE_KINDS, fire_cost, identity, \
    seal_cost, \
    make_accumulator, merge_rows, pow2_ceil
from ..metrics.profiler import DEVICE_LEDGER
from ..ops.topk import masked_topk
from ..ops.window_seal import rebuild, seal
from .mesh import shard_ranges

__all__ = ["AggDef", "ShardedWindowState", "ShardedWindowAgg",
           "global_topk", "local_signature"]

#: first open pane before any fire: nothing is late
MIN_PANE = -(1 << 62)



def mesh_step_cost(rows: int, n_dev: int, col_sizes: tuple,
                   plane_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a mesh step over ``rows`` rows from its shapes:
    the exchange reads each row's key, timestamp and value columns once
    and writes them once into its shard's bucket; each shard's step reads
    them back once, reads the row's table slot (8 bytes) and reads and
    writes its element of every plane once; operations: the routing, the
    hash and one fold a plane per row."""
    row = 16 + sum(col_sizes)
    return (rows * (2 + len(plane_sizes)),
            rows * (3 * row + 8 + 2 * sum(plane_sizes)))


def mesh_fire_cost(n_dev: int, n_rows: int, capacity: int,
                   plane_sizes: tuple, topk: int,
                   out_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a mesh fire: every shard's fire
    (``ops/segment_ops.py::fire_cost``)."""
    flops, nbytes = fire_cost(n_rows, capacity, plane_sizes, topk,
                              out_sizes)
    return n_dev * flops, n_dev * nbytes


def mesh_seal_cost(n_dev: int, capacity: int, rows: int, tree_size: int,
                   planes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a mesh seal or rebuild: every shard's
    (``ops/segment_ops.py::seal_cost``)."""
    flops, nbytes = seal_cost(capacity, rows, tree_size, planes)
    return n_dev * flops, n_dev * nbytes


def mesh_retire_cost(n_dev: int, capacity: int,
                     plane_sizes: tuple) -> tuple[int, int]:
    """(flops, bytes) of a mesh pane retirement: one ring row of every
    plane of every shard written once."""
    return 0, n_dev * capacity * sum(plane_sizes)

class AggDef(NamedTuple):
    """One aggregate plane: kind in sum|count|min|max. ``count`` needs no
    input column; the others fold the column named ``name``."""
    name: str
    kind: str
    dtype: Any = torch.float32


@dataclass
class ShardedWindowState:
    """Per shard: ``table`` [capacity] int64, ``accs[name]`` [ring,
    capacity], ``dropped`` an int64 scalar (rows lost to a full table) and
    ``late`` an int64 scalar (rows a device step found behind the first
    open pane; the port's own, never snapshotted), each on its shard's
    device."""
    table: list
    accs: dict
    dropped: list
    late: list = field(default_factory=list)


def local_signature(aggs: Sequence[AggDef], capacity: int, ring: int
                    ) -> tuple:
    """The local-shard key: the aggregate schema and per-shard dims, never
    the shard count (a rescale that keeps it keeps every shape)."""
    return ("local",
            tuple((a.name, a.kind, str(torch_dtype(a.dtype)).split(".")[-1])
                  for a in aggs),
            int(capacity), int(ring))


def _window_dtype(kind: str, dtype: torch.dtype) -> torch.dtype:
    """An integer sum's window widens to int64, as the full merge does."""
    if kind == "sum" and not dtype.is_floating_point:
        return torch.int64
    return dtype


def _shard_topk(values: list, valid: list, k: int, value_bits: int
                ) -> list[tuple]:
    """Phase one: each shard's top k, (values, local indices, ok)."""
    return [masked_topk(v, m, k, value_bits=value_bits)
            for v, m in zip(values, valid)]


def global_topk(values, valid, k: int, value_bits: int = 64
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase global top k over per-shard values: the select per shard,
    then over the D * k candidates. ``values``/``valid``: a [D, capacity]
    tensor or a list of D [capacity] tensors. Returns (values [k'], flat
    indices [k'] into the [D * capacity] layout, ok [k']), k' = min(k,
    D * min(k, capacity)), descending. Ties at the k-th value take the
    lowest indices in each phase (shard order, then slot order); a seat
    with ok False is padding: filter on ``ok``."""
    values, valid = list(values), list(valid)
    dev, cap = values[0].device, values[0].numel()
    parts = _shard_topk(values, valid, k, value_bits)
    flat = torch.cat([li.to(dev).to(torch.int64) + d * cap
                      for d, (_v, li, _o) in enumerate(parts)])
    v, sel, ok = masked_topk(torch.cat([p[0].to(dev) for p in parts]),
                             torch.cat([p[2].to(dev) for p in parts]), k,
                             value_bits=value_bits)
    return v, flat[sel], ok


class ShardedWindowAgg:
    """The sharded programs for one (mesh, aggregate schema). The mesh and
    the key-group ownership are per instance: an instance rebuilt on a new
    mesh (grow, restore, live rescale) runs the same kernels."""

    def __init__(self, mesh: Sequence, aggs: Sequence[AggDef],
                 capacity: int = 1 << 16, ring: int = 64,
                 max_parallelism: int = 128, base_range=None):
        """``mesh``: the shards' devices (``make_mesh``). ``base_range``:
        restrict the mesh to one subtask's key-group range (the two-level
        split); None is the whole space."""
        if capacity <= 0 or capacity & (capacity - 1):
            raise ValueError("capacity must be a power of two")
        self.mesh = [torch.device(d) for d in mesh]
        self.n_dev = len(self.mesh)
        if max_parallelism < self.n_dev:
            raise ValueError("max_parallelism must be >= mesh size")
        self.aggs = [AggDef(a.name, a.kind, torch_dtype(a.dtype))
                     for a in aggs]
        if not any(a.kind == "count" for a in self.aggs):
            self.aggs.append(AggDef("__count__", "count", torch.int64))
        names = [a.name for a in self.aggs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate aggregate names: {names}")
        self.capacity = int(capacity)
        self.ring = int(ring)
        self.max_parallelism = int(max_parallelism)
        self.count_name = next(a.name for a in self.aggs
                               if a.kind == "count")
        # incremental planes: a running [capacity] window per invertible
        # aggregate, a [2L, capacity] merge tree per min/max; L follows the
        # ring, so shapes do not depend on the window width
        self.tree_size = pow2_ceil(self.ring)
        self.inv_sig = tuple((a.kind, a.name) for a in self.aggs
                             if a.kind in INVERTIBLE_KINDS)
        self.tree_sig = tuple((a.kind, a.name) for a in self.aggs
                              if a.kind not in INVERTIBLE_KINDS)
        self._buffers: dict = {}
        self.set_base_range(base_range)

    # ------------------------------------------------------------------
    def set_base_range(self, base_range) -> None:
        """Point this mesh at a (new) subtask key-group range: ownership is
        a pair of launch arguments."""
        self.base_range = base_range
        self.shard_ranges = shard_ranges(self.max_parallelism, self.n_dev,
                                         base_range)
        start = self.shard_ranges[0].start
        self._base_start = int(start)
        self._base_len = int(self.shard_ranges[-1].end - start + 1)

    @property
    def sig(self) -> tuple:
        return local_signature(self.aggs, self.capacity, self.ring)

    @property
    def value_aggs(self) -> list[AggDef]:
        """The planes that fold an input column (all but the counts)."""
        return [a for a in self.aggs if a.kind != "count"]

    def init_state(self) -> ShardedWindowState:
        cap, ring = self.capacity, self.ring
        return ShardedWindowState(
            [make_table(cap, dev) for dev in self.mesh],
            {a.name: [make_accumulator(a.kind, (ring, cap), a.dtype, dev)
                      for dev in self.mesh] for a in self.aggs},
            [torch.zeros((), dtype=torch.int64, device=dev)
             for dev in self.mesh],
            [torch.zeros((), dtype=torch.int64, device=dev)
             for dev in self.mesh])

    # -- the step -----------------------------------------------------------
    def _exchange_buffers(self, n_src: int, block: int, dtypes: tuple,
                          device) -> ExchangeBuffers:
        key = (n_src, block, dtypes, str(device))
        buf = self._buffers.get(key)
        if buf is None:
            # one shape at a time: a padded tail or a new block size
            # replaces it
            self._buffers.clear()
            buf = self._buffers[key] = ExchangeBuffers.allocate(
                self.n_dev, n_src, block, list(dtypes), device)
        return buf

    def step_block(self, state: ShardedWindowState, keys: torch.Tensor,
                   ts: torch.Tensor, cols: dict, n_valid: Optional[int] = None,
                   valid: Optional[torch.Tensor] = None, pane: int = 1,
                   offset: int = 0, first_open: int = MIN_PANE) -> None:
        """Fold S source blocks in place: ``keys``, ``ts`` [S, B] int64 on
        the first shard's device, ``cols`` {plane name: [S, B]} for every
        non-count plane. A row's pane is floor((ts - offset) / pane); rows
        behind ``first_open`` count as late. One ``exchange_bucket``
        launch, then one counted ``ingest_step`` launch per shard."""
        names = [a.name for a in self.value_aggs]
        col_list = [cols[n].contiguous() for n in names]
        S, B = keys.shape
        src_dev = keys.device
        tok = DEVICE_LEDGER.begin("mesh.step", src_dev) \
            if DEVICE_LEDGER.enabled else None
        buf = self._exchange_buffers(S, B, tuple(c.dtype for c in col_list),
                                     src_dev)
        exchange_bucket(keys.contiguous(), ts.contiguous(), col_list, buf,
                        n_valid=n_valid, valid=valid, pane=pane,
                        offset=offset, n_dest=self.n_dev,
                        max_parallelism=self.max_parallelism,
                        base_start=self._base_start, base_len=self._base_len)
        for d, dev in enumerate(self.mesh):
            k, p = buf.keys[d], buf.panes[d]
            vals = dict(zip(names, (c[d] for c in buf.cols)))
            counts = buf.counts[:, d]
            if dev != src_dev:
                # a shard on another card: its block copied over on its
                # own stream (not tried on one card)
                with torch.cuda.stream(torch.cuda.current_stream(dev)):
                    k, p = k.to(dev, non_blocking=True), \
                        p.to(dev, non_blocking=True)
                    vals = {n: v.to(dev, non_blocking=True)
                            for n, v in vals.items()}
                    counts = counts.to(dev, non_blocking=True)
            planes = [(a.kind, state.accs[a.name][d],
                       None if a.kind == "count" else vals[a.name])
                      for a in self.aggs]
            ingest_step(state.table[d], planes, p, k, 1, 0, int(first_open),
                        state.late[d], state.dropped[d], segments=counts)
        if tok is not None:
            DEVICE_LEDGER.end(tok, (
                S * B, self.n_dev, tuple(c.element_size() for c in col_list),
                tuple(state.accs[a.name][0].element_size()
                      for a in self.aggs)), mesh_step_cost)

    def step(self, state: ShardedWindowState, keys, cols: dict, panes,
             valid=None) -> tuple[ShardedWindowState, torch.Tensor]:
        """The reference's step: fold one [D, B] micro-batch of pane
        indices; ``valid`` [D, B] bool (None: every row). Returns (state,
        processed), processed an int64 device scalar: the rows folded."""
        dev = self.mesh[0]
        keys = torch.as_tensor(keys).to(dev, torch.int64)
        panes = torch.as_tensor(panes).to(dev, torch.int64)
        cols = {n: torch.as_tensor(c).to(dev) for n, c in cols.items()}
        if valid is not None:
            valid = torch.as_tensor(valid).to(dev, torch.bool)
        before = self._lost(state)
        self.step_block(state, keys, panes, cols, valid=valid)
        buf = next(iter(self._buffers.values()))
        processed = buf.counts.sum() - (self._lost(state) - before)
        return state, processed

    def _lost(self, state: ShardedWindowState) -> torch.Tensor:
        dev = self.mesh[0]
        return (torch.stack([t.to(dev) for t in state.dropped]).sum()
                + torch.stack([t.to(dev) for t in state.late]).sum())

    # -- fires ----------------------------------------------------------------
    def _health(self, state: ShardedWindowState) -> tuple:
        dev = self.mesh[0]
        dropped = torch.stack([t.to(dev) for t in state.dropped]).sum()
        occ = torch.stack([(t != EMPTY_KEY).sum().to(dev)
                           for t in state.table]).max()
        return dropped, occ

    def fire(self, state: ShardedWindowState, pane_rows,
             rows_valid=None) -> tuple[dict, list]:
        """Merge the given ring rows into per-key window results ({name:
        [capacity] per shard}) and the emit masks (per shard)."""
        rows = self._rows(pane_rows, rows_valid)
        tok = DEVICE_LEDGER.begin("mesh.fire_full", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        out = {a.name: [merge_rows(a.kind, state.accs[a.name][d], rows)
                        for d in range(self.n_dev)] for a in self.aggs}
        emit = [(state.table[d] != EMPTY_KEY) & (out[self.count_name][d] > 0)
                for d in range(self.n_dev)]
        if tok is not None:
            DEVICE_LEDGER.end(tok, self._fire_sig(len(rows), 0),
                              mesh_fire_cost)
        return out, emit

    @staticmethod
    def _rows(pane_rows, rows_valid) -> list[int]:
        """The valid entries of ``pane_rows``: at least one."""
        rows = [int(r) for r in np.asarray(pane_rows).reshape(-1)]
        if rows_valid is not None:
            rows = [r for r, v in zip(
                rows, np.asarray(rows_valid).reshape(-1)) if v]
        if not rows:
            raise ValueError("a fire or rebuild needs at least one pane row")
        return rows

    def fire_compact(self, state: ShardedWindowState, pane_rows,
                     rows_valid, rank_name: Optional[str],
                     topk: Optional[int], value_bits: int = 64):
        """The whole fire on the device: each shard's merge, the emit
        masks, the health scalars and, with ``topk``, the global top k on
        ``rank_name``. Without a top k: (tables, emits, {name: merged},
        dropped, occupancy), per shard; with one: (keys [k'], ok [k'],
        {name: [k']}, dropped, occupancy), ranked descending."""
        rows = self._rows(pane_rows, rows_valid)

        def merged(kind, name, d, idx=None):
            return merge_rows(kind, state.accs[name][d], rows, idx)

        tok = DEVICE_LEDGER.begin("mesh.fire", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        out = self._fire_outputs(state, merged, rank_name, topk, value_bits)
        if tok is not None:
            DEVICE_LEDGER.end(tok, self._fire_sig(len(rows), topk or 0),
                              mesh_fire_cost)
        return out

    def _fire_outputs(self, state, merged, rank_name, topk, value_bits):
        D = self.n_dev
        kinds = {a.name: a.kind for a in self.aggs}
        count = [merged("count", self.count_name, d) for d in range(D)]
        emit = [(state.table[d] != EMPTY_KEY) & (count[d] > 0)
                for d in range(D)]
        dropped, occ = self._health(state)
        if topk is None:
            out = {a.name: (count if a.name == self.count_name else
                            [merged(a.kind, a.name, d) for d in range(D)])
                   for a in self.aggs}
            return list(state.table), emit, out, dropped, occ
        rank = (count if rank_name == self.count_name else
                [merged(kinds[rank_name], rank_name, d) for d in range(D)])
        dev = self.mesh[0]
        cand_v, cand_ok, keys_c, res_c = [], [], [], {n: [] for n in kinds}
        for d, (lv, li, lo) in enumerate(_shard_topk(rank, emit, topk,
                                                     value_bits)):
            cand_v.append(lv.to(dev))
            cand_ok.append(lo.to(dev))
            keys_c.append(state.table[d][li].to(dev))
            for n, kind in kinds.items():
                v = (rank[d][li] if n == rank_name else
                     count[d][li] if n == self.count_name else
                     merged(kind, n, d, li))
                res_c[n].append(v.to(dev))
        _v, sel, ok = masked_topk(torch.cat(cand_v), torch.cat(cand_ok),
                                  topk, value_bits=value_bits)
        res = {n: torch.cat(v)[sel] for n, v in res_c.items()}
        return torch.cat(keys_c)[sel], ok, res, dropped, occ

    # -- the incremental fire engine ------------------------------------------
    def _inc_planes(self, state, wins: dict, trees: dict) -> list:
        """Per shard: the (kind, pane, state, view) signature of
        ``ops.window_seal``, with fresh views."""
        per_shard = []
        for d in range(self.n_dev):
            planes, view = [], {}
            for kind, name in self.inv_sig + self.tree_sig:
                st = (wins if kind in INVERTIBLE_KINDS else trees)[name][d]
                view[name] = torch.empty(st.shape[-1], dtype=st.dtype,
                                         device=st.device)
                planes.append((kind, state.accs[name][d], st, view[name]))
            per_shard.append((planes, view))
        return per_shard

    def _views(self, per_shard) -> dict:
        return {name: [view[name] for _p, view in per_shard]
                for _k, name in self.inv_sig + self.tree_sig}

    def new_inc_planes(self) -> tuple[dict, dict]:
        """Fresh incremental planes: ({name: [capacity] per shard},
        {name: [2L, capacity] per shard})."""
        cap, L = self.capacity, self.tree_size
        dt = {a.name: a.dtype for a in self.aggs}
        wins = {name: [make_accumulator(kind, (cap,),
                                        _window_dtype(kind, dt[name]), dev)
                       for dev in self.mesh]
                for kind, name in self.inv_sig}
        trees = {name: [make_accumulator(kind, (2 * L, cap), dt[name], dev)
                        for dev in self.mesh]
                 for kind, name in self.tree_sig}
        return wins, trees

    def seal_inc(self, state: ShardedWindowState, wins: dict, trees: dict,
                 new_row: int, sub_row: int, sub_valid: bool, new_leaf: int,
                 old_leaf: int) -> tuple[dict, dict, dict]:
        """Seal one pane into the incremental planes (updated in place),
        one ``window_seal`` launch a shard. Returns (view {name: [capacity]
        per shard}, wins, trees)."""
        per_shard = self._inc_planes(state, wins, trees)
        tok = DEVICE_LEDGER.begin("mesh.seal_inc", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        for planes, _view in per_shard:
            seal(planes, int(new_row), int(sub_row), bool(sub_valid),
                 int(new_leaf), int(old_leaf))
        if tok is not None:
            DEVICE_LEDGER.end(tok, self._seal_sig(
                per_shard, 2 if sub_valid else 1), mesh_seal_cost)
        return self._views(per_shard), wins, trees

    def rebuild_inc(self, state: ShardedWindowState, pane_rows, rows_valid,
                    pane_leaves, sub_row: int, sub_valid: bool
                    ) -> tuple[dict, dict, dict]:
        """Build the incremental planes from the pane planes, one
        ``window_rebuild`` launch a shard; ``pane_rows``/``pane_leaves``
        may be padded, ``rows_valid`` marking the real entries."""
        rows = self._rows(pane_rows, rows_valid)
        leaves = self._rows(pane_leaves, rows_valid)
        wins, trees = self.new_inc_planes()
        per_shard = self._inc_planes(state, wins, trees)
        tok = DEVICE_LEDGER.begin("mesh.rebuild_inc", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        for planes, _view in per_shard:
            rebuild(planes, rows, leaves, int(sub_row), bool(sub_valid))
        if tok is not None:
            DEVICE_LEDGER.end(tok, self._seal_sig(per_shard, len(rows)),
                              mesh_seal_cost)
        return self._views(per_shard), wins, trees

    def fire_inc(self, state: ShardedWindowState, view: dict,
                 rank_name: Optional[str], topk: Optional[int],
                 value_bits: int = 64):
        """The fire over an incremental view; the outputs of
        ``fire_compact``."""
        def merged(_kind, name, d, idx=None):
            v = view[name][d]
            return v if idx is None else v[idx]

        tok = DEVICE_LEDGER.begin("mesh.fire_inc", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        out = self._fire_outputs(state, merged, rank_name, topk, value_bits)
        if tok is not None:
            DEVICE_LEDGER.end(tok, self._fire_sig(1, topk or 0),
                              mesh_fire_cost)
        return out

    def retire_row(self, state: ShardedWindowState,
                   row: int) -> ShardedWindowState:
        """Reset one ring row of every plane of every shard."""
        tok = DEVICE_LEDGER.begin("mesh.retire", self.mesh[0]) \
            if DEVICE_LEDGER.enabled else None
        for a in self.aggs:
            for arr in state.accs[a.name]:
                arr[int(row)].fill_(identity(a.kind, arr.dtype))
        if tok is not None:
            DEVICE_LEDGER.end(tok, (self.n_dev, self.capacity, tuple(
                state.accs[a.name][0].element_size() for a in self.aggs)),
                mesh_retire_cost)
        return state

    def _fire_sig(self, n_rows: int, topk: int) -> tuple:
        """(shards, pane rows merged, capacity, item size of each plane,
        top k or 0, item size of each output column): a mesh fire's
        cost."""
        return (self.n_dev, n_rows, self.capacity,
                tuple(a.dtype.itemsize
                      for a in self.aggs), topk, tuple(8 for _a in self.aggs))

    def _seal_sig(self, per_shard: list, rows: int) -> tuple:
        """(shards, capacity, pane rows read, tree size, (is_tree, pane
        item size, state item size) per plane): a seal's or rebuild's
        cost."""
        planes, _view = per_shard[0]
        return (self.n_dev, self.capacity, rows, self.tree_size,
                tuple((kind not in INVERTIBLE_KINDS, pane.element_size(),
                       st.element_size()) for kind, pane, st, _v in planes))

    # -- snapshots ------------------------------------------------------------
    def snapshot(self, state: ShardedWindowState) -> dict:
        """The keyed state in the reference's schema ``{"kind": "tpu",
        keys, key_groups, max_parallelism, states}``, canonical (group,
        key) order, ordered on the first shard's device."""
        dev = self.mesh[0]
        keys, vals = [], {a.name: [] for a in self.aggs}
        for d in range(self.n_dev):
            slots = torch.nonzero(state.table[d] != EMPTY_KEY).flatten()
            keys.append(state.table[d][slots].to(dev))
            for a in self.aggs:
                vals[a.name].append(state.accs[a.name][d][:, slots].to(dev))
        keys = torch.cat(keys)
        groups = key_groups_device(keys, self.max_parallelism)
        o1 = torch.argsort(keys, stable=True)
        order = o1[torch.argsort(groups[o1], stable=True)]
        states = {a.name: {"kind": a.kind,
                           "dtype": str(numpy_dtype(a.dtype)),
                           "ring": self.ring,
                           "values": torch.cat(vals[a.name], 1)[:, order]
                           .cpu().numpy()}
                  for a in self.aggs}
        return {"kind": "tpu", "keys": keys[order].cpu().numpy(),
                "key_groups": groups[order].cpu().numpy(),
                "max_parallelism": self.max_parallelism, "states": states}

    def load(self, keys: np.ndarray, groups: np.ndarray,
             values: dict) -> ShardedWindowState:
        """A state holding ``keys`` (with their ``groups``) and their
        ``values`` ({plane: [ring, n]} on this ring), each key on the shard
        owning its group; keys no shard owns are left out."""
        state = self.init_state()
        for d, rng in enumerate(self.shard_ranges):
            sel = (groups >= rng.start) & (groups <= rng.end)
            if not sel.any():
                continue
            dev = self.mesh[d]
            dkeys = torch.from_numpy(np.ascontiguousarray(
                keys[sel].astype(np.int64))).to(dev)
            _, slots, ok = lookup_or_insert(state.table[d], dkeys)
            if not bool(ok.all()):
                raise RuntimeError("mesh restore overflow: raise capacity")
            slots = slots.to(torch.int64)
            for a in self.aggs:
                v = values.get(a.name)
                if v is None:
                    continue
                state.accs[a.name][d][:, slots] = torch.from_numpy(
                    np.ascontiguousarray(v[:, sel])).to(dev, a.dtype)
        return state
