"""Fused-chain lowering: the runtime half of the fusion certifier (port of
``flink_tpu/runtime/compiled.py``).

``graph/fusion.py`` proves, before deployment, that a chained ``source
decode -> window step`` prefix may run as one dispatch, and records it in
the job's ``FusionCertificate``. ``FusedChain`` is what that buys: the
device datagen decode (the user's ``gen_fn`` on torch tensors), the
reader's monotonicity check and the window operator's ingest step (with
its dirty marking of the snapshot's slot blocks) run as ONE dispatch per
micro-batch.

* On the card that dispatch is a CUDA graph replay. One graph is captured
  per batch length: the decode's operators, the monotonicity check ORed
  into the reader's device flag, and the one ``ingest_step`` launch
  (``csrc/hash_table.cu``). A graph replays its kernels' by-value
  arguments frozen at capture, so the per-batch scalars (the decode's
  ``start`` and ``prev_last``, the step's ``first_open``) come from a
  3-element int64 device buffer that the host refills before each replay
  with a non-blocking copy from pinned memory; the kernel reads
  ``first_open`` from it.
* A graph also freezes every pointer it was captured with. The cache of a
  batch length is keyed on the ``data_ptr()`` of the table, every pane
  plane, the dirty bitmap, the counters and the buffers, so a table that
  grew (a rehash, a restore), a re-seated ring or a bitmap reallocated
  with the table is captured anew, never replayed into freed memory.
* On the CPU the same class runs the decode and the plain step eagerly,
  reading the same scalar buffer.

Each micro-batch counts one ``chain_fused_dispatches_total``; a replay
counts the one ``ingest_step`` launch it holds. There is no fallback: on
the card the chain captures and replays, or it raises.

The graphs are an in-memory program cache: ``aot.in-memory-max-programs``
(``AOT.in_memory_max_programs``; 0: unbounded) caps them with LRU
eviction, counted in ``aot_in_memory_evictions_total``; a recapture after
an eviction is a capture (``captures``), never a kernel build. Each
capture is a ``note_build`` of the device-time ledger with the graph key's
parts (batch length, the table's capacity, ...), so a recapture names the
dimension that changed. The ledger times each micro-batch as one
``chain.fused_step`` sample: one event pair around the replay on the card
(nothing is recorded inside a capture; the site's first dispatch in the
process is charged as compile), and a zero-ms ``chain.fused_prelude``
compile marker at each capture, as the reference records its prelude.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from ..device import note_launch, torch_dtype
from ..metrics.device import DEVICE_STATS
from ..metrics.profiler import DEVICE_LEDGER
from ..ops.hash_table import ingest_step, step_cost

__all__ = ["FusedChain"]


class FusedChain:
    """Decode + ingest step of one certified chain, one CUDA graph per
    batch length on the card."""

    def __init__(self, source, subtask: int, parallelism: int,
                 key_column: str, pane: int, offset: int,
                 device: torch.device):
        self._src = source
        self._subtask = int(subtask)
        self._parallelism = int(parallelism)
        self._key_column = key_column
        self._pane = int(pane)
        self._offset = int(offset)
        self._dev = torch.device(device)
        self._cuda = self._dev.type == "cuda"
        # [start, prev_last, first_open] of the batch being dispatched
        self._scal = torch.zeros(3, dtype=torch.int64, device=self._dev)
        self._iota: dict[int, torch.Tensor] = {}
        #: batch length -> (pointer key, graph), least recently used first
        self._graphs: OrderedDict[int, tuple[tuple, torch.cuda.CUDAGraph]] \
            = OrderedDict()
        #: graphs captured (a grown table or a new batch length recaptures)
        self.captures = 0

    def _body(self, n: int, viol: torch.Tensor, table: torch.Tensor,
              planes: list, late: torch.Tensor, dropped: torch.Tensor,
              dirty: torch.Tensor, dirty_shift: int) -> None:
        """The decode and the step of one batch, from the scalar buffer:
        the reader's decode index math and casts, then ``ingest_step``.
        ``planes``: (kind, [ring, capacity] array, field or None)."""
        s = self._src
        scal = self._scal
        idx = (scal[0] + self._iota[n]) * self._parallelism + self._subtask
        cols = s._gen(idx)
        out = {f.name: torch.as_tensor(cols[f.name], device=self._dev).to(
                   torch_dtype(f.dtype))
               for f in s.schema.fields}
        ts = out[s._ts_col].to(torch.int64)
        viol |= (ts[1:] < ts[:-1]).any() | (ts[0] < scal[1])
        ingest_step(table, [(kind, arr, None if field is None else out[field])
                            for kind, arr, field in planes],
                    ts, out[self._key_column], self._pane, self._offset,
                    scal[2], late, dropped, dirty, dirty_shift)

    def run(self, batch, table: torch.Tensor, planes: list,
            late: torch.Tensor, dropped: torch.Tensor, first_open: int,
            dirty: torch.Tensor, dirty_shift: int) -> None:
        """Decode ``batch`` (a ``LazyDeviceBatch``) and fold it into the
        state in place, marking the dirty blocks of ``dirty`` (one byte per
        block of 2^``dirty_shift`` slots): one graph replay on the card."""
        n = batch.n
        host = torch.tensor([batch.start, batch.prev_last, first_open],
                            dtype=torch.int64)
        if n not in self._iota:
            self._iota[n] = torch.arange(n, dtype=torch.int64,
                                         device=self._dev)
        viol = batch.reader._viol
        sig = (n, table.numel(), planes[0][1].shape[0],
               tuple(arr.element_size() for _k, arr, _f in planes),
               self._column_sizes(planes))
        if not self._cuda:
            tok = DEVICE_LEDGER.begin("chain.fused_step", self._dev) \
                if DEVICE_LEDGER.enabled else None
            self._scal.copy_(host)
            self._body(n, viol, table, planes, late, dropped, dirty,
                       dirty_shift)
            if tok is not None:
                DEVICE_LEDGER.end(tok, sig, step_cost)
            batch.reader._viol_checked = False
            DEVICE_STATS.note_chain_dispatch()
            return
        self._scal.copy_(host.pin_memory(), non_blocking=True)
        key = (table.data_ptr(),
               tuple(arr.data_ptr() for _k, arr, _f in planes),
               late.data_ptr(), dropped.data_ptr(), viol.data_ptr(),
               dirty.data_ptr(), dirty_shift)
        entry = self._graphs.get(n)
        if entry is None or entry[0] != key:
            self._graphs.pop(n, None)   # frees a stale graph's pool first
            if DEVICE_LEDGER.enabled:
                DEVICE_LEDGER.note_build(
                    "chain.fused_step", repr(sig), _graph_key,
                    (n, table.numel(), planes[0][1].shape[0],
                     tuple(str(arr.dtype) for _k, arr, _f in planes),
                     dirty_shift), {})
                DEVICE_LEDGER.record("chain.fused_prelude", 0.0,
                                     shape_sig=repr(sig), kind="compile")
            entry = (key, self._capture(n, viol, table, planes, late,
                                        dropped, dirty, dirty_shift))
            self._graphs[n] = entry
            self._evict()
        else:
            self._graphs.move_to_end(n)
        tok = DEVICE_LEDGER.begin("chain.fused_step", self._dev) \
            if DEVICE_LEDGER.enabled else None
        entry[1].replay()
        if tok is not None:
            DEVICE_LEDGER.end(tok, sig, step_cost)
        batch.reader._viol_checked = False
        note_launch("ingest_step")
        note_launch("ingest_step_dirty")
        DEVICE_STATS.note_chain_dispatch()

    def _column_sizes(self, planes: list) -> tuple:
        """Item sizes of the decoded columns the step reads: timestamps,
        keys, then each non-count plane's field."""
        import numpy as np
        dt = {f.name: np.dtype(f.dtype).itemsize
              for f in self._src.schema.fields}
        return (8, dt[self._key_column]) + tuple(
            dt[field] for _k, _a, field in planes if field is not None)

    def _evict(self) -> None:
        """LRU eviction past ``aot.in-memory-max-programs``."""
        from .aot import AOT
        cap = AOT.in_memory_max_programs
        evicted = 0
        while cap and len(self._graphs) > cap:
            self._graphs.popitem(last=False)
            evicted += 1
        if evicted:
            DEVICE_STATS.note_aot_eviction(evicted)

    def _capture(self, n: int, viol, table, planes, late, dropped, dirty,
                 dirty_shift: int) -> torch.cuda.CUDAGraph:
        """Record the body into a new graph on a side stream ordered after
        the current one; nothing runs until the first replay."""
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self._dev)
        side.wait_stream(torch.cuda.current_stream(self._dev))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body(n, viol, table, planes, late, dropped, dirty,
                           dirty_shift)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self._dev).wait_stream(side)
        self.captures += 1
        return graph


def _graph_key(batch_length: int, capacity: int, ring: int,
               plane_dtypes: tuple, dirty_shift: int) -> None:
    """The parts of a graph's key the ledger's recompile attribution
    diffs (the pointers themselves change with every allocation)."""
