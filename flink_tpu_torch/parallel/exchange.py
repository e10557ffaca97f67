"""The keyBy exchange between shards (port of
``flink_tpu/parallel/exchange.py``).

The reference buckets each device's batch by destination and rides one
``lax.all_to_all`` over ICI. The port's mesh is one process holding D
shards, so the collective becomes a device operation of the controller:
one ``exchange_bucket`` launch (``ops/exchange.py``, ``csrc/exchange.cu``)
routes S source blocks by the key group of each row and writes every row
into its destination's buffer. With every shard on one card this costs no
copy; a destination on another card gets its block by ``copy_``
(``sharded_window.py``).

The reference's two forms, with their contracts (invalid rows vanish, no
record is ever lost, rows arrive grouped by source):

* ``keyby_exchange``: the worst-case-width form; each destination gets S
  segments of B rows and a valid mask of [S * B].
* ``plan_exchange`` + ``exchange_round``: the capacity-bounded form, rounds
  of ``cap`` rows a (source, destination) pair until the deepest bucket is
  drained (``ExchangePlan.n_rounds``); a skewed batch takes more rounds.

Unlike the reference, a destination here is computed from the key inside
the kernel (the sharded step's routing, ``sharded_window.py:143-151``),
not passed in; so both forms take the keys and the ownership bounds.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.exchange import ExchangeBuffers, exchange_bucket

__all__ = ["keyby_exchange", "plan_exchange", "exchange_round",
           "ExchangePlan", "bucket_capacity"]


def bucket_capacity(batch: int, n_dev: int) -> int:
    """Per-destination round capacity for a local batch of ``batch``: the
    mean bucket depth batch / n_dev plus 25% (at least 16) of headroom, so
    a uniformly keyed batch takes one round with high probability and a
    skewed one more rounds."""
    per = -(-batch // n_dev)
    return int(min(batch, max(32, per + max(per // 4, 16))))


def _route(keys: torch.Tensor, payload: dict, valid: Optional[torch.Tensor],
           n_dev: int, max_parallelism: int, base_start: int,
           base_len: Optional[int]) -> tuple[ExchangeBuffers, list]:
    """One bucket launch of [S, B] keys and payload columns ("__pane__",
    when present, rides as the pane with pane 1 and offset 0)."""
    keys = keys.to(torch.int64).contiguous()
    S, B = keys.shape
    names = [n for n in payload if n not in ("__key__", "__pane__")]
    cols = [payload[n].contiguous() for n in names]
    panes = payload.get("__pane__")
    ts = (panes.to(torch.int64).contiguous() if panes is not None
          else keys)
    out = ExchangeBuffers.allocate(n_dev, S, B, [c.dtype for c in cols],
                                   keys.device)
    exchange_bucket(keys, ts, cols, out,
                    valid=None if valid is None else valid.contiguous(),
                    n_dest=n_dev, max_parallelism=max_parallelism,
                    base_start=base_start, base_len=base_len)
    return out, names


def _received(out: ExchangeBuffers, names: list, d: int, with_panes: bool,
              rows: Optional[torch.Tensor] = None) -> dict:
    sel = slice(None) if rows is None else rows
    got = {"__key__": out.keys[d][sel]}
    if with_panes:
        got["__pane__"] = out.panes[d][sel]
    for n, c in zip(names, out.cols):
        got[n] = c[d][sel]
    return got


def keyby_exchange(keys: torch.Tensor, payload: dict,
                   valid: Optional[torch.Tensor], n_dev: int,
                   max_parallelism: int, base_start: int = 0,
                   base_len: Optional[int] = None) -> tuple[list, list]:
    """Route S source blocks of [S, B] rows to ``n_dev`` shards in one
    launch. ``payload``: [S, B] columns ("__pane__" optional); ``valid``:
    [S, B] bool or None. Returns (routed, valid): per destination a dict of
    [S * B] columns ("__key__" the sanitised key) and a [S * B] bool mask,
    rows grouped by source (segment s holds source s's rows at its
    front)."""
    out, names = _route(keys, payload, valid, n_dev, max_parallelism,
                        base_start, base_len)
    S, B = out.n_src, out.block
    pos = torch.arange(B, device=out.keys.device)
    routed, masks = [], []
    for d in range(n_dev):
        routed.append(_received(out, names, d, "__pane__" in payload))
        masks.append((pos[None, :] < out.counts[:, d:d + 1]).reshape(S * B))
    return routed, masks


class ExchangePlan(NamedTuple):
    """The capacity-bounded exchange of one [S, B] block: the routed
    buffer, the payload's column names, whether panes ride, the round
    capacity, and ``n_rounds``, ceil(deepest (source, destination) bucket /
    cap), a device scalar (the reference's pmax'd round count)."""
    out: ExchangeBuffers
    names: list
    with_panes: bool
    cap: int
    n_rounds: torch.Tensor


def plan_exchange(keys: torch.Tensor, payload: dict,
                  valid: Optional[torch.Tensor], n_dev: int, cap: int,
                  max_parallelism: int, base_start: int = 0,
                  base_len: Optional[int] = None) -> ExchangePlan:
    """Bucket a [S, B] block for round-based exchange (one launch);
    ``bucket_capacity`` picks a good ``cap``."""
    out, names = _route(keys, payload, valid, n_dev, max_parallelism,
                        base_start, base_len)
    n_rounds = torch.div(out.counts.max() + (cap - 1), cap,
                         rounding_mode="floor")
    return ExchangePlan(out, names, "__pane__" in payload, int(cap),
                        n_rounds)


def exchange_round(plan: ExchangePlan, r: int) -> tuple[list, list]:
    """Round ``r`` of a planned exchange: per destination the rows of
    bucket rank [r*cap, (r+1)*cap) of each source, as [S * cap] columns
    and a [S * cap] valid mask (rows grouped by source)."""
    out, cap = plan.out, plan.cap
    S, B = out.n_src, out.block
    dev = out.keys.device
    rank = r * cap + torch.arange(cap, device=dev)
    rows = (torch.arange(S, device=dev)[:, None] * B
            + rank.clamp(max=B - 1)[None, :]).reshape(-1)
    routed, masks = [], []
    for d in range(out.n_dest):
        routed.append(_received(out, plan.names, d, plan.with_panes, rows))
        masks.append(((rank[None, :] < out.counts[:, d:d + 1])
                      & (rank[None, :] < B)).reshape(S * cap))
    return routed, masks
