"""The mesh's hand-written kernels on the card against their plain
versions: ``exchange_bucket`` (csrc/exchange.cu) and the counted form of
``ingest_step`` (csrc/hash_table.cu). Both skip without a card; the file
imports no JAX, so it runs on the card's machine (see README).

Run there with ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_exchange_kernels.py``."""

import numpy as np
import pytest
import torch

from flink_tpu_torch.ops.exchange import (ExchangeBuffers, exchange_bucket,
                                          exchange_bucket_plain)
from flink_tpu_torch.ops.hash_table import (EMPTY_KEY, ingest_step,
                                            ingest_step_plain, make_table)

MP = 128
CPU = torch.device("cpu")


def _keys(rng, n):
    """Negative, positive, huge and the sentinel keys."""
    return np.concatenate([
        np.array([0, 1, -1, EMPTY_KEY, EMPTY_KEY - 1, -(1 << 63)],
                 np.int64),
        rng.integers(-(1 << 62), 1 << 62, n, dtype=np.int64)])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("a CUDA kernel: needs the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_exchange_bucket_kernel_equals_plain_version():
    """exchange_bucket on the card against its plain version: the same
    counts, and each (source, destination) segment the same multiset of
    rows, on a random block, every key to one shard, an empty block and a
    base_range subset."""
    dev = _card()
    rng = np.random.default_rng(4)
    D, S, B = 4, 4, 1 << 12
    for flat, n_valid, start, length in (
            (_keys(rng, S * B - 6), None, 0, MP),
            (np.full(S * B, -77, np.int64), None, 0, MP),
            (_keys(rng, S * B - 6), 0, 0, MP),
            (_keys(rng, S * B - 6), S * B - 100, 16, 64)):
        keys = torch.from_numpy(flat.reshape(S, B))
        ts = torch.from_numpy(rng.integers(0, 9000, (S, B)))
        vals = torch.from_numpy(rng.integers(0, 99, (S, B)).astype(np.int32))
        outs = []
        for d_ in (CPU, dev):
            out = ExchangeBuffers.allocate(D, S, B, [torch.int32], d_)
            fn = exchange_bucket if d_.type == "cuda" else \
                exchange_bucket_plain
            args = (keys.to(d_), ts.to(d_), [vals.to(d_)], out)
            if d_.type == "cuda":
                fn(*args, n_valid=n_valid, pane=1000, offset=3, n_dest=D,
                   max_parallelism=MP, base_start=start, base_len=length)
            else:
                fn(*args, S * B if n_valid is None else n_valid, None, 1000,
                   3, D, MP, start, length)
            outs.append(out)
        torch.cuda.synchronize()
        want, got = outs[0], outs[1]
        assert torch.equal(got.counts.cpu(), want.counts)
        for s in range(S):
            for d in range(D):
                c = int(want.counts[s, d])
                seg = slice(s * B, s * B + c)
                rows = [torch.stack([o.keys[d][seg].cpu(),
                                     o.panes[d][seg].cpu(),
                                     o.cols[0][d][seg].cpu().long()], 1)
                        for o in (want, got)]
                assert sorted(map(tuple, rows[0].tolist())) == \
                    sorted(map(tuple, rows[1].tolist()))


@pytest.mark.cuda
def test_counted_ingest_step_equals_plain_version():
    """The counted form of ingest_step on the card against its plain
    version, from a bucketed buffer: the same keys, planes equal key by
    key, late and dropped equal (sums of integers: exact)."""
    dev = _card()
    rng = np.random.default_rng(8)
    D, S, B, cap = 4, 4, 1 << 12, 1 << 14
    keys = torch.from_numpy(rng.integers(-5000, 5000, (S, B)))
    ts = torch.from_numpy(rng.integers(0, 16_000, (S, B)))
    vals = torch.from_numpy(rng.integers(0, 99, (S, B)))
    results = []
    for d_ in (CPU, dev):
        out = ExchangeBuffers.allocate(D, S, B, [torch.int64], d_)
        exchange_bucket_plain(keys.to(d_), ts.to(d_), [vals.to(d_)], out,
                              S * B, None, 1000, 0, D, MP, 0, MP)
        fn = ingest_step if d_.type == "cuda" else ingest_step_plain
        shard = []
        for d in range(D):
            table = make_table(cap, d_)
            cnt = torch.zeros((16, cap), dtype=torch.int64, device=d_)
            s = torch.zeros((16, cap), dtype=torch.int64, device=d_)
            late = torch.zeros((), dtype=torch.int64, device=d_)
            dropped = torch.zeros((), dtype=torch.int64, device=d_)
            fn(table, [("count", cnt, None), ("sum", s, out.cols[0][d])],
               out.panes[d], out.keys[d], 1, 0, 5, late, dropped,
               segments=out.counts[:, d])
            t = table.cpu()
            slots = torch.nonzero(t != EMPTY_KEY).flatten()
            order = torch.argsort(t[slots])
            sl = slots[order]
            shard.append((t[sl], cnt.cpu()[:, sl], s.cpu()[:, sl],
                          int(late), int(dropped)))
        results.append(shard)
    for want, got in zip(*results):
        for a, b in zip(want, got):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b)
