"""Fused-chain lowering: the runtime half of the fusion certifier (port of
``flink_tpu/runtime/compiled.py``).

``graph/fusion.py`` proves, before deployment, that a chained ``source
decode -> window step`` prefix may run as one dispatch, and records it in
the job's ``FusionCertificate``. ``FusedChain`` is what that buys: the
device datagen decode (the user's ``gen_fn`` on torch tensors), the
reader's monotonicity check and the window operator's ingest step run as
ONE dispatch per micro-batch.

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
  plane, the counters and the buffers, so a table that grew (a rehash, a
  restore) or a re-seated ring is captured anew, never replayed into
  freed memory.
* On the CPU the same class runs the decode and the plain step eagerly,
  reading the same scalar buffer.

Each micro-batch counts one ``chain_fused_dispatches_total``; a replay
counts the one ``ingest_step`` launch it holds. There is no fallback: on
the card the chain captures and replays, or it raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import note_launch, torch_dtype
from ..metrics.device import DEVICE_STATS
from ..ops.hash_table import ingest_step

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
        #: batch length -> (pointer key, graph)
        self._graphs: dict[int, tuple[tuple, torch.cuda.CUDAGraph]] = {}
        #: graphs captured (a grown table or a new batch length recaptures)
        self.captures = 0

    def _body(self, n: int, viol: torch.Tensor, table: torch.Tensor,
              planes: list, late: torch.Tensor,
              dropped: torch.Tensor) -> None:
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
                    scal[2], late, dropped)

    def run(self, batch, table: torch.Tensor, planes: list,
            late: torch.Tensor, dropped: torch.Tensor,
            first_open: int) -> None:
        """Decode ``batch`` (a ``LazyDeviceBatch``) and fold it into the
        state in place: one graph replay on the card."""
        n = batch.n
        host = torch.tensor([batch.start, batch.prev_last, first_open],
                            dtype=torch.int64)
        if n not in self._iota:
            self._iota[n] = torch.arange(n, dtype=torch.int64,
                                         device=self._dev)
        viol = batch.reader._viol
        if not self._cuda:
            self._scal.copy_(host)
            self._body(n, viol, table, planes, late, dropped)
            batch.reader._viol_checked = False
            DEVICE_STATS.note_chain_dispatch()
            return
        self._scal.copy_(host.pin_memory(), non_blocking=True)
        key = (table.data_ptr(),
               tuple(arr.data_ptr() for _k, arr, _f in planes),
               late.data_ptr(), dropped.data_ptr(), viol.data_ptr())
        entry = self._graphs.get(n)
        if entry is None or entry[0] != key:
            self._graphs.pop(n, None)   # frees a stale graph's pool first
            entry = (key, self._capture(n, viol, table, planes, late,
                                        dropped))
            self._graphs[n] = entry
        entry[1].replay()
        batch.reader._viol_checked = False
        note_launch("ingest_step")
        DEVICE_STATS.note_chain_dispatch()

    def _capture(self, n: int, viol, table, planes, late,
                 dropped) -> torch.cuda.CUDAGraph:
        """Record the body into a new graph on a side stream ordered after
        the current one; nothing runs until the first replay."""
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(self._dev)
        side.wait_stream(torch.cuda.current_stream(self._dev))
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._body(n, viol, table, planes, late, dropped)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(self._dev).wait_stream(side)
        self.captures += 1
        return graph
