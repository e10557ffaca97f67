"""The hand-written CUDA kernels of flink_tpu_torch against their plain
PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a CUDA
card. The file imports neither jax nor flink_tpu, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py

Tolerance: exact. The histogram, the select state and the top k are
integers; the fused step's float values are multiples of 1/8 far below
2^20, so every sum is exact in any order. The hash kernel's slot layout
differs from the plain version's, so the table is held to the set
semantics and each plane is compared key by key.
"""

import numpy as np
import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.ops import hash_table as ht
from flink_tpu_torch.ops.radix_topk import digit_plan, histogram256, \
    histogram256_plain, radix_select, radix_select_plain
from flink_tpu_torch.ops.segment_ops import make_accumulator
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


I64 = torch.iinfo(torch.int64)


def _ranked(rng, dtype, n):
    """Values with many ties and negatives (uint8/bool: non-negative)."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.3)
    if dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    if dtype.is_floating_point:
        return torch.from_numpy(rng.integers(-4000, 4000, n) / 8.0).to(dtype)
    return torch.from_numpy(rng.integers(-5000, 5000, n)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64, torch.uint8, torch.bool])
@pytest.mark.parametrize("n", [1, 17, 4099, 1_000_003])
@pytest.mark.parametrize("offset", [0, 1])
def test_select_pass_kernel_equals_plain(dev, dtype, n, offset):
    """Every pass's histogram and state, then the top k, exactly as the
    plain version gives them; n not a multiple of the 16-row vector step,
    and (offset 1) buffers off the 16-byte alignment of vector loads."""
    rng = np.random.default_rng(n + offset)
    values = _ranked(rng, dtype, n + offset).to(dev)[offset:]
    valid = torch.from_numpy(rng.random(n + offset) < 0.6).to(dev)[offset:]
    k = min(1000, n)
    plan, _seed = digit_plan(dtype, 64)
    got_h = torch.zeros((len(plan), 256), dtype=torch.int32, device=dev)
    want_h = torch.zeros_like(got_h)
    reset_launches()
    got = radix_select(values, valid, k, 64, got_h)
    assert KERNEL_LAUNCHES["hist256"] == len(plan)
    want = radix_select_plain(values, valid, k, 64, want_h)
    assert torch.equal(got_h, want_h) and torch.equal(got, want)
    if dtype != torch.bool:
        cpu = masked_topk(values.cpu(), valid.cpu(), k)
        for g, w in zip(masked_topk(values, valid, k), cpu):
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("value_bits", [8, 31, 48])
def test_select_pass_kernel_bounded_domain(dev, value_bits):
    """Bounded non-negative integer domains skip the top digits: the
    passes start below value_bits with the seeded prefix word."""
    rng = np.random.default_rng(value_bits)
    n = 1 << 20
    values = torch.from_numpy(rng.integers(0, 1 << min(value_bits, 20), n)
                              ).to(dev)
    valid = torch.from_numpy(rng.random(n) < 0.5).to(dev)
    plan, _seed = digit_plan(values.dtype, value_bits)
    got_h = torch.zeros((len(plan), 256), dtype=torch.int32, device=dev)
    want_h = torch.zeros_like(got_h)
    got = radix_select(values, valid, 1000, value_bits, got_h)
    want = radix_select_plain(values, valid, 1000, value_bits, want_h)
    assert torch.equal(got_h, want_h) and torch.equal(got, want)


def test_select_pass_kernel_skewed_digits(dev):
    """Almost every row in one bin, as the top digits of small counts:
    the warp-merged shared-memory adds must count every row."""
    n = 1 << 20
    values = torch.zeros(n, dtype=torch.int64, device=dev)
    values[::7] = 3
    values[::1001] = 1 << 40
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    plan, _seed = digit_plan(values.dtype, 64)
    got_h = torch.zeros((len(plan), 256), dtype=torch.int32, device=dev)
    want_h = torch.zeros_like(got_h)
    got = radix_select(values, valid, 2000, 64, got_h)
    want = radix_select_plain(values, valid, 2000, 64, want_h)
    assert torch.equal(got_h, want_h) and torch.equal(got, want)
    assert int(got_h[-1].sum()) > 0


RING, PANE, OFFSET, FIRST_OPEN = 4, 100, -37, -4
STEP_DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64,
               torch.uint8, torch.bool]


def _step_batch(seed, n, distinct, dtype):
    rng = np.random.default_rng(seed)
    pool = rng.integers(I64.min, I64.max, distinct, dtype=np.int64)
    pool[:2] = [I64.max, I64.max - 1]
    keys = torch.from_numpy(pool[rng.integers(0, distinct, n)])
    ts = torch.from_numpy(rng.integers(-700, 600, n))
    return ts, keys, _ranked(rng, dtype, n)


def _run_step(dev, cap, planes_spec, batches, plain):
    table = ht.make_table(cap, dev)
    planes = [(kind, make_accumulator(kind, (RING, cap), dt, dev))
              for kind, dt, _col in planes_spec]
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    step = ht.ingest_step_plain if plain else ht.ingest_step
    for ts, keys, vals in batches:
        vals = vals.to(dev)
        step(table, [(kind, arr, None if col is None else vals)
                     for (kind, arr), (_k, _dt, col) in zip(planes,
                                                            planes_spec)],
             ts.to(dev), keys.to(dev), PANE, OFFSET, FIRST_OPEN, late,
             dropped)
    return table, [arr for _k, arr in planes], int(late), int(dropped)


def _by_key(table, planes):
    """Occupied keys in ascending order and each plane's [ring] column at
    their slots: what must agree whatever the slot layout."""
    occupied = torch.nonzero(table != ht.EMPTY_KEY).flatten()
    keys, order = torch.sort(table[occupied])
    slots = occupied[order]
    return keys, [arr[:, slots] for arr in planes]


@pytest.mark.parametrize("kind,dtype", [
    (kind, dt) for kind in ("sum", "min", "max") for dt in STEP_DTYPES
    if dt != torch.bool or kind == "sum"])
def test_ingest_kernel_equals_plain(dev, kind, dtype):
    """Every (kind, dtype) fold the eager path takes: the count plane, the
    value plane (none for a bool column, which the eager fold cannot hold
    in a bool plane) and a float32 sum of the same column, the avg plane,
    which shares the column. Two batches of 5001 rows: late rows, negative
    panes, the EMPTY_KEY sentinel; the counters equal too."""
    spec = [("count", torch.int32, None), ("sum", torch.float32, "v")]
    if dtype != torch.bool:
        spec.insert(1, (kind, dtype, "v"))
    batches = [_step_batch(s, 5001, 700, dtype) for s in (1, 2)]
    reset_launches()
    got = _run_step(dev, 2048, spec, batches, plain=False)
    assert KERNEL_LAUNCHES["ingest_step"] == 2
    assert KERNEL_LAUNCHES["hash_probe"] == 0
    want = _run_step(dev, 2048, spec, batches, plain=True)
    gk, gp = _by_key(got[0], got[1])
    wk, wp = _by_key(want[0], want[1])
    assert torch.equal(gk, wk)
    for g, w in zip(gp, wp):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert got[2:] == want[2:] and got[2] > 0 and got[3] == 0


def test_ingest_kernel_int64_extremes(dev):
    """int64 atomicMin/atomicMax and the wrapping int64 sum at the ends of
    the range."""
    n = 4096
    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.choice(
        np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max]),
        n))
    keys = torch.from_numpy(rng.integers(0, 50, n))
    ts = torch.zeros(n, dtype=torch.int64)
    spec = [("count", torch.int64, None), ("min", torch.int64, "v"),
            ("max", torch.int64, "v"), ("sum", torch.int64, "v")]
    got = _run_step(dev, 256, spec, [(ts, keys, vals)], plain=False)
    want = _run_step(dev, 256, spec, [(ts, keys, vals)], plain=True)
    gk, gp = _by_key(got[0], got[1])
    wk, wp = _by_key(want[0], want[1])
    assert torch.equal(gk, wk)
    assert all(torch.equal(g, w) for g, w in zip(gp, wp))
    assert int(gp[1].min()) == I64.min and int(gp[2].max()) == I64.max


def test_ingest_kernel_counts_dropped_rows(dev):
    """40 keys into 16 slots: which keys win differs from the plain
    version (whichever claim lands first), so the kernel is held to its
    own table: full, each folded key counted exactly, every other fresh
    row dropped."""
    rng = np.random.default_rng(4)
    n = 3000
    keys = torch.from_numpy(rng.integers(0, 40, n) * 7919)
    ts = torch.from_numpy(rng.integers(-700, 600, n))
    spec = [("count", torch.int64, None)]
    table, (count,), late, dropped = _run_step(
        dev, 16, spec, [(ts, keys, keys)], plain=False)
    assert bool((table != ht.EMPTY_KEY).all())
    panes = torch.div(ts - OFFSET, PANE, rounding_mode="floor")
    fresh = panes >= FIRST_OPEN
    inside = torch.isin(keys, table.cpu())
    assert late == int((~fresh).sum())
    assert dropped == int((fresh & ~inside).sum()) > 0
    slot_of = {int(k): s for s, k in enumerate(table.cpu().tolist())}
    want = torch.zeros(RING, 16, dtype=torch.int64)
    for k, p, f in zip(keys.tolist(), panes.tolist(), fresh.tolist()):
        if f and k in slot_of:
            want[p % RING, slot_of[k]] += 1
    assert torch.equal(count.cpu(), want)
