"""The hand-written CUDA kernels of flink_tpu_torch against their plain
PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
card. The file imports neither jax nor flink_tpu, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Tolerance: exact (integer outputs); the hash kernel's slot layout differs
from the plain version's, so it is held to the set semantics.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.ops import hash_table as ht
from flink_tpu_torch.ops.radix_topk import histogram256, histogram256_plain
from flink_tpu_torch.ops.topk import masked_topk, masked_topk_sort

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [0, 1, 127, 1_000_003, 1 << 21])
@pytest.mark.parametrize("valid_dtype", [torch.bool, torch.uint8])
def test_histogram_kernel_equals_plain(dev, n, valid_dtype):
    rng = np.random.default_rng(n)
    u = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, n)
                         .astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.3).to(dev).to(valid_dtype)
    for shift in (0, 8, 16, 24):
        got = histogram256(u, valid, shift)
        assert got.dtype == torch.int32 and got.device.type == "cuda"
        assert torch.equal(got, histogram256_plain(u, valid, shift))


def test_histogram_kernel_skewed_digits(dev):
    """Mostly one bin (the top digit of small counts): the warp-merged
    shared-memory adds must still count every row."""
    u = torch.zeros(1 << 20, dtype=torch.int32, device=dev)
    u[::7] = 0x01020304
    valid = torch.ones(1 << 20, dtype=torch.bool, device=dev)
    for shift in (0, 24):
        assert torch.equal(histogram256(u, valid, shift),
                           histogram256_plain(u, valid, shift))


def _keys(seed, n, distinct):
    rng = np.random.default_rng(seed)
    i64 = np.iinfo(np.int64)
    pool = rng.integers(i64.min, i64.max, distinct, dtype=np.int64)
    pool[:4] = [0, -1, i64.min, i64.max - 1]
    return pool[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("cap", [1 << 12, 1 << 16])
def test_hash_kernel_set_semantics(dev, cap):
    keys = torch.from_numpy(_keys(3, 1 << 13, 1 << 11)).to(dev)
    valid = torch.from_numpy(
        np.random.default_rng(4).random(1 << 13) < 0.8).to(dev)
    table, slots, ok = ht.lookup_or_insert(ht.make_table(cap, dev), keys,
                                           valid)
    ptable, _ps, pok = ht.lookup_or_insert_plain(ht.make_table(cap, dev),
                                                 keys, valid)
    assert torch.equal(ok, pok) and torch.equal(ok, valid)
    assert bool((slots[~valid] == -1).all())
    occupied = torch.sort(table[table != ht.EMPTY_KEY]).values
    assert torch.equal(occupied,
                       torch.sort(ptable[ptable != ht.EMPTY_KEY]).values)
    assert torch.equal(occupied, torch.unique(keys[valid]))
    assert torch.equal(table[slots[valid].long()], keys[valid])
    found = ht.lookup(table, keys)
    assert torch.equal(found[valid], slots[valid])
    absent = torch.tensor([123456789, -987654321], device=dev)
    absent = absent[~torch.isin(absent, keys[valid])]
    assert bool((ht.lookup(table, absent) == -1).all())


def test_hash_kernel_overflow_reports_not_ok(dev):
    keys = torch.arange(20, dtype=torch.int64, device=dev) * 7919
    table, slots, ok = ht.lookup_or_insert(ht.make_table(8, dev), keys)
    assert int(ok.sum()) == 8 and bool((table != ht.EMPTY_KEY).all())
    assert bool((slots[~ok] == -1).all())
    assert torch.equal(table[slots[ok].long()], keys[ok])


@pytest.mark.parametrize("dtype,value_bits", [(torch.int32, 31),
                                              (torch.int64, 64),
                                              (torch.float32, 64)])
def test_masked_topk_on_card_follows_tie_rule(dev, dtype, value_bits):
    """The radix select with the histogram kernel against the sort-based
    reference: values and ok equal, the winners' values are theirs, keys
    strictly above the k-th value equal, keys at it from the tie class."""
    rng = np.random.default_rng(5)
    n, k = 1 << 18, 1000
    lo = 0 if value_bits == 31 else -5000
    vals = torch.from_numpy(rng.integers(lo, 5000, n)).to(dtype).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.6).to(dev)
    reset_launches()
    v, i, ok = masked_topk(vals, valid, k, value_bits=value_bits)
    assert KERNEL_LAUNCHES["hist256"] > 0
    sv, si, sok = masked_topk_sort(vals, valid, k)
    assert torch.equal(ok, sok) and torch.equal(v[ok], sv[sok])
    assert torch.equal(vals[i[ok]], v[ok]) and bool(valid[i[ok]].all())
    kth = v[ok][-1]
    assert set(i[ok][v[ok] > kth].tolist()) == \
        set(si[sok][sv[sok] > kth].tolist())
    ties = set(torch.nonzero(valid & (vals == kth)).flatten().tolist())
    assert set(i[ok][v[ok] == kth].tolist()) <= ties
