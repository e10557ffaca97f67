"""The mesh's keyBy exchange on the device: ``exchange_bucket`` (port of
``flink_tpu/parallel/exchange.py::plan_exchange`` and ``exchange_round``
with the routing of ``sharded_window.py``'s step, ``:143-169``).

S source blocks of B rows go to D destination shards. Destination d's
buffer (``ExchangeBuffers``) holds S segments of B rows; segment s holds,
at its front, the rows of block s whose key group d owns, and
``counts[s, d]`` is how many. Each row carries its sanitised key, its pane
and its value columns. The buffer is sized for the worst case (a whole
block to one destination), so one call routes any batch: the reference's
capacity rounds (``bucket_capacity``, a skewed batch taking more rounds)
become one launch, and the destination's ingest step reads the counts on
the device (``ingest_step(..., segments=counts[:, d])``).

* On a CUDA tensor: one launch of the hand-written kernel
  (``csrc/exchange.cu``) over all S blocks, which zeroes the counts first.
  The order of rows within a bucket is the order the kernel's atomics
  land; the destination's fold is atomic, so the state is the same.
* On a CPU tensor: the plain version, a stable ``argsort`` by (source,
  destination) and a scatter (the reference's algorithm), which keeps
  batch order within a bucket.

Routing (``flink_tpu/parallel/mesh.py``): a row's key group is the murmur
of ``core/keygroups.py`` over its RAW key; it is valid when its group lies
in ``[base_start, base_start + base_len)`` (a subtask's range, or the
whole space) and goes to ``(kg - base_start) * D // base_len``. Rows not
valid (padding, a mask, another subtask's groups) vanish.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from ..core.keygroups import key_groups_device
from ..device import note_launch
from .hash_table import sanitize_keys_device

__all__ = ["ExchangeBuffers", "exchange_bucket", "exchange_bucket_plain",
           "MAX_DEST", "MAX_COLS"]

MAX_DEST = 256
MAX_COLS = 7


@dataclass
class ExchangeBuffers:
    """A destination-major exchange buffer for S blocks of B rows to D
    shards: ``keys`` and ``panes`` [D, S * B] int64, ``cols`` one [D, S *
    B] tensor a value column, ``counts`` [S, D] int64."""

    keys: torch.Tensor
    panes: torch.Tensor
    cols: list
    counts: torch.Tensor

    @classmethod
    def allocate(cls, n_dest: int, n_src: int, block: int,
                 col_dtypes: Sequence[torch.dtype], device
                 ) -> "ExchangeBuffers":
        """Zeroed on the CPU (the plain version reads whole rows), left
        unset on the card (only the counted rows are ever read)."""
        make = torch.zeros if torch.device(device).type == "cpu" \
            else torch.empty
        shape = (n_dest, n_src * block)
        return cls(make(shape, dtype=torch.int64, device=device),
                   make(shape, dtype=torch.int64, device=device),
                   [make(shape, dtype=dt, device=device)
                    for dt in col_dtypes],
                   torch.zeros((n_src, n_dest), dtype=torch.int64,
                               device=device))

    @property
    def n_dest(self) -> int:
        return self.keys.shape[0]

    @property
    def n_src(self) -> int:
        return self.counts.shape[0]

    @property
    def block(self) -> int:
        return self.keys.shape[1] // self.n_src


def _check(keys, ts, cols, valid, out: ExchangeBuffers, n_valid: int,
           n_dest: int, max_parallelism: int, base_len: int) -> None:
    dev = keys.device
    if keys.dtype != torch.int64 or keys.dim() != 2 \
            or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous [S, B] int64 tensor")
    S, B = keys.shape
    if ts.dtype != torch.int64 or ts.shape != keys.shape \
            or not ts.is_contiguous() or ts.device != dev:
        raise ValueError("ts must be a contiguous [S, B] int64 tensor on "
                         "the keys' device")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != keys.shape
                              or not valid.is_contiguous()
                              or valid.device != dev):
        raise ValueError("valid must be a contiguous [S, B] bool tensor")
    if not 1 <= n_dest <= MAX_DEST or len(cols) > MAX_COLS:
        raise ValueError(f"1 to {MAX_DEST} destinations and at most "
                         f"{MAX_COLS} value columns")
    if max_parallelism < 1 or base_len < 1:
        raise ValueError("max_parallelism and base_len must be positive")
    if (out.keys.shape != (n_dest, S * B) or out.panes.shape != out.keys.shape
            or out.counts.shape != (S, n_dest)
            or out.counts.dtype != torch.int64
            or len(out.cols) != len(cols)
            or any(t.device != dev or not t.is_contiguous()
                   for t in [out.keys, out.panes, out.counts, *out.cols])):
        raise ValueError("out must be ExchangeBuffers of D destinations for "
                         "these S blocks of B rows, on the keys' device")
    for c, o in zip(cols, out.cols):
        if c.shape != keys.shape or not c.is_contiguous() \
                or c.device != dev or o.dtype != c.dtype \
                or c.element_size() not in (1, 2, 4, 8):
            raise ValueError("each value column must be a contiguous [S, B] "
                             "tensor of 1, 2, 4 or 8-byte elements, with its "
                             "output of the same dtype")


def exchange_bucket_plain(keys: torch.Tensor, ts: torch.Tensor,
                          cols: Sequence[torch.Tensor],
                          out: ExchangeBuffers, n_valid: int,
                          valid: Optional[torch.Tensor], pane: int,
                          offset: int, n_dest: int, max_parallelism: int,
                          base_start: int, base_len: int) -> None:
    """Plain version (any device): the reference's stable argsort by
    destination, per source block, then one scatter a column."""
    S, B = keys.shape
    D = n_dest
    dev = keys.device
    flat = keys.reshape(-1)
    r = torch.arange(S * B, device=dev)
    ok = r < n_valid
    if valid is not None:
        ok &= valid.reshape(-1)
    rel = key_groups_device(flat, max_parallelism).to(torch.int64) \
        - base_start
    ok &= (rel >= 0) & (rel < base_len)
    dest = torch.where(ok, rel * D // base_len, D)
    src = r // B
    code = src * (D + 1) + dest
    order = torch.argsort(code, stable=True)
    sc = code[order]
    counts = torch.bincount(code, minlength=S * (D + 1))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(S * B, device=dev) - starts[sc]
    keep = (sc % (D + 1)) < D
    o = order[keep]
    d_o, s_o = (sc % (D + 1))[keep], (sc // (D + 1))[keep]
    pos = d_o * (S * B) + s_o * B + rank[keep]
    out.keys.view(-1)[pos] = sanitize_keys_device(flat[o])
    out.panes.view(-1)[pos] = torch.div(ts.reshape(-1)[o] - offset, pane,
                                        rounding_mode="floor")
    for c, oc in zip(cols, out.cols):
        oc.view(-1)[pos] = c.reshape(-1)[o]
    out.counts.copy_(counts.view(S, D + 1)[:, :D])


def exchange_bucket(keys: torch.Tensor, ts: torch.Tensor,
                    cols: Sequence[torch.Tensor], out: ExchangeBuffers,
                    n_valid: Optional[int] = None,
                    valid: Optional[torch.Tensor] = None, pane: int = 1,
                    offset: int = 0, *, n_dest: int, max_parallelism: int,
                    base_start: int = 0,
                    base_len: Optional[int] = None) -> None:
    """Bucket S source blocks of B rows by destination shard into ``out``
    (see the module doc). ``keys``, ``ts`` and each of ``cols``: [S, B]
    contiguous; ``n_valid``: rows of the flattened block that may be in
    (default all); ``valid``: [S, B] bool, or None. A row's pane is
    floor((ts - offset) / pane): pass panes with pane 1 and offset 0."""
    n_valid = keys.numel() if n_valid is None else int(n_valid)
    base_len = max_parallelism if base_len is None else int(base_len)
    _check(keys, ts, cols, valid, out, n_valid, n_dest, max_parallelism,
           base_len)
    if int(pane) <= 0:
        raise ValueError("pane must be positive")
    if keys.device.type == "cpu":
        return exchange_bucket_plain(keys, ts, cols, out, n_valid, valid,
                                     pane, offset, n_dest, max_parallelism,
                                     base_start, base_len)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    from . import kernels

    S, B = keys.shape
    n_c = len(cols)
    rc = kernels.library("exchange").exchange_bucket_launch(
        keys.data_ptr(), ts.data_ptr(),
        valid.data_ptr() if valid is not None else None, n_valid, S, B,
        int(pane), int(offset), int(n_dest), int(max_parallelism),
        int(base_start), int(base_len), n_c,
        (ctypes.c_void_p * max(n_c, 1))(*[c.data_ptr() for c in cols]),
        (ctypes.c_int * max(n_c, 1))(*[c.element_size() for c in cols]),
        out.keys.data_ptr(), out.panes.data_ptr(),
        (ctypes.c_void_p * max(n_c, 1))(*[c.data_ptr() for c in out.cols]),
        out.counts.data_ptr(),
        torch.cuda.current_stream(keys.device).cuda_stream)
    kernels.check("exchange", rc)
    if n_valid > 0:
        note_launch("exchange_bucket")
