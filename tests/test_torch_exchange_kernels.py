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


def _plain(keys, ts, cols, D, n_valid=None, valid=None, start=0,
           length=MP, mp=MP, pane=1000, offset=3):
    S, B = keys.shape
    out = ExchangeBuffers.allocate(D, S, B, [c.dtype for c in cols], CPU)
    exchange_bucket_plain(keys, ts, cols, out,
                          S * B if n_valid is None else n_valid, valid,
                          pane, offset, D, mp, start, length)
    return out


def _kernel(out, keys, ts, cols, D, n_valid=None, valid=None, start=0,
            length=MP, mp=MP, pane=1000, offset=3):
    dev = out.keys.device
    exchange_bucket(keys.to(dev), ts.to(dev), [c.to(dev) for c in cols],
                    out, n_valid=n_valid,
                    valid=None if valid is None else valid.to(dev),
                    pane=pane, offset=offset, n_dest=D, max_parallelism=mp,
                    base_start=start, base_len=length)


def _assert_equal(want, got, what):
    """The same counts, and every live row of every (source, destination)
    segment equal position by position: key, pane, every column."""
    counts = got.counts.cpu()
    assert torch.equal(counts, want.counts), what
    S, B, D = want.n_src, want.block, want.n_dest
    pos = torch.arange(S * B)
    for d in range(D):
        live = (pos % B) < counts[:, d].repeat_interleave(B)
        for a, b in zip([want.keys, want.panes, *want.cols],
                        [got.keys, got.panes, *got.cols]):
            assert torch.equal(a[d][live], b[d].cpu()[live]), (what, d)


def _batch(rng, S, B, col_dtypes=(torch.int32,)):
    keys = torch.from_numpy(_keys(rng, S * B - 6).reshape(S, B))
    ts = torch.from_numpy(rng.integers(-9000, 9000, (S, B)))
    cols = [torch.from_numpy(rng.integers(-99, 99, (S, B))).to(dt)
            for dt in col_dtypes]
    return keys, ts, cols


@pytest.mark.cuda
def test_exchange_bucket_kernel_equals_plain_version():
    """exchange_bucket on the card against its plain version: the same
    counts, and every live row of each (source, destination) segment equal
    position by position (both keep batch order), on a random block, every
    key to one shard, an empty block, a base_range subset, a mask with
    columns of 1, 2, 4 and 8 bytes, and a block whose rows are not 16-byte
    aligned (B odd, a ragged last tile)."""
    dev = _card()
    rng = np.random.default_rng(4)
    D, S, B = 4, 4, 1 << 12
    for name, S_, B_, flat, n_valid, mask, start, length, dts in (
            ("random", S, B, None, None, None, 0, MP, (torch.int32,)),
            ("one_shard", S, B, np.full(S * B, -77, np.int64), None, None,
             0, MP, (torch.int32,)),
            ("empty", S, B, None, 0, None, 0, MP, (torch.int32,)),
            ("base_subset", S, B, None, S * B - 100, None, 16, 64,
             (torch.int32,)),
            ("masked_widths", 3, 5001, None, None, 0.7, 0, MP,
             (torch.int8, torch.int16, torch.int32, torch.float64)),
            ("many_tiles", 2, 40_003, None, 2 * 40_003 - 999, None, 0, MP,
             (torch.int64,))):
        keys, ts, cols = _batch(rng, S_, B_, dts)
        if flat is not None:
            keys = torch.from_numpy(flat.reshape(S_, B_))
        valid = None if mask is None else torch.from_numpy(
            rng.random((S_, B_)) < mask)
        want = _plain(keys, ts, cols, D, n_valid, valid, start, length)
        got = ExchangeBuffers.allocate(D, S_, B_, [c.dtype for c in cols],
                                       dev)
        _kernel(got, keys, ts, cols, D, n_valid, valid, start, length)
        torch.cuda.synchronize()
        _assert_equal(want, got, name)


@pytest.mark.cuda
def test_exchange_bucket_back_to_back_and_after_a_shape_change():
    """Calls on the same buffers back to back (no synchronisation between
    them: the scratch each leaves is the next one's), each held to the
    plain version after its own call; then new buffers for a new shape, as
    the mesh replaces them, and the first buffers again."""
    dev = _card()
    rng = np.random.default_rng(19)
    D, S, B = 4, 4, 3 * 2048 + 5
    first = ExchangeBuffers.allocate(D, S, B, [torch.int32], dev)
    for shape in ((S, B), (S, B), (2, 1 << 13), (S, B)):
        S_, B_ = shape
        out = first if shape == (S, B) else ExchangeBuffers.allocate(
            D, S_, B_, [torch.int32], dev)
        batches = [_batch(rng, S_, B_) for _ in range(3)]
        wants = [_plain(*b, D) for b in batches]
        gots = []
        for b in batches:
            _kernel(out, *b, D)
            gots.append([t.clone() for t in (out.keys, out.panes,
                                             out.cols[0], out.counts)])
        torch.cuda.synchronize()
        for want, (k, p, c, n) in zip(wants, gots):
            _assert_equal(want, ExchangeBuffers(k, p, [c], n, out.scratch),
                          f"back to back at {shape}")


@pytest.mark.cuda
def test_exchange_bucket_256_destinations():
    """D = 256 (the most the kernel takes; one lane a destination in the
    look-back), max parallelism 1024 so every destination owns groups,
    held to the plain version position by position; and D = 3."""
    dev = _card()
    rng = np.random.default_rng(256)
    S, B, mp = 3, 3 * 2048 + 11, 1024
    for D in (256, 3):
        keys, ts, cols = _batch(rng, S, B, (torch.int64,))
        want = _plain(keys, ts, cols, D, mp=mp, length=mp)
        got = ExchangeBuffers.allocate(D, S, B, [torch.int64], dev)
        _kernel(got, keys, ts, cols, D, mp=mp, length=mp)
        torch.cuda.synchronize()
        _assert_equal(want, got, f"D = {D}")
        assert int((want.counts > 0).sum()) > D * S // 2


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
