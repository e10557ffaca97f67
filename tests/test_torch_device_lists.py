"""Port parity: the device list store (flink_tpu_torch/state/device_lists.py
and its programs in flink_tpu_torch/ops/device_lists.py) against
flink_tpu/state/device_lists.py on the same seeded numpy input.

On the CPU the port runs the plain versions of its kernels, and its hash
table's plain version is the reference's probe, so slot layouts match
too; the comparisons are still made by key (snapshots after a canonical
sort by key) so that they hold the semantics, not the layout. Tolerance:
exact, every column being int64 or float bits. Rows past a key's count
(the rows a prune dropped, zeros in a fresh list) are compared too.

The plain versions keep the tile summary (``tiles``: per tile bounds on
the live rows' ts and the live slots); after every step it is held to
the rows (``chip_smoke.check_tiles``). The ``cuda`` cases hold the
kernels (csrc/device_lists.cu) against their plain versions on
chip_smoke.py's adversarial inputs (``LIST_EDGE_CASES``) and a store on
the card against one on the CPU;
they skip without a card. The reference package is imported inside the
``ref`` fixture, so they run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_device_lists.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flink_tpu_torch.core import KeyGroupRange
from flink_tpu_torch.state.device_lists import DeviceListStore

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

KGR = KeyGroupRange(0, 127)
DTYPES = [np.dtype(np.int64), np.dtype(np.float64)]


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from flink_tpu.core import KeyGroupRange as RefRange
    from flink_tpu.state.device_lists import DeviceListStore as RefStore
    return lambda *a, **kw: RefStore(RefRange(0, 127), 128, *a, **kw)


def port(*a, **kw):
    return DeviceListStore(KGR, 128, *a, device="cpu", **kw)


def _batch(rng, n, pool, t0=0, span=1000):
    keys = rng.choice(pool, n).astype(np.int64)
    ts = np.sort(rng.integers(t0, t0 + span, n)).astype(np.int64)
    cols = [rng.integers(-50, 50, n).astype(np.int64),
            rng.integers(0, 64, n) / 8.0]
    return keys, ts, cols


def _canon(snap: dict) -> dict:
    order = np.argsort(np.asarray(snap["keys"]), kind="stable")
    out = dict(snap)
    for f in ("keys", "key_groups", "rows", "counts"):
        out[f] = np.asarray(snap[f])[order]
    return out


def assert_snapshots_equal(a: dict, b: dict) -> None:
    """Field by field after a canonical sort by key."""
    a, b = _canon(a), _canon(b)
    assert a["kind"] == b["kind"] == "tpu-list"
    for f in ("L", "C", "dtypes"):
        assert a[f] == b[f], f
    for f in ("keys", "key_groups", "rows", "counts"):
        x, y = np.asarray(a[f]), np.asarray(b[f])
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f)


def _both(ref, seed, ops, dtypes=DTYPES, **kw):
    """Run the same ops (("append", keys, ts, cols) / ("prune", horizon))
    on a reference and a port store."""
    r, p = ref(dtypes, **kw), port(dtypes, **kw)
    for op in ops:
        for st in (r, p):
            if op[0] == "append":
                st.append_batch(*op[1:])
            else:
                st.prune(op[1])
    return r, p


def test_append_in_batch_duplicates_keep_batch_order(ref):
    """Positions follow batch order within a key: probes and snapshots
    equal the reference's, position by position."""
    rng = np.random.default_rng(1)
    ops = [("append", *_batch(rng, n, np.arange(12), t0=i * 100))
           for i, n in enumerate((7, 33, 1, 64, 5))]
    r, p = _both(ref, 1, ops, capacity=64, rows_per_key=32)
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    probe_keys = np.array([0, 3, 11, 99, 3], np.int64)
    rr, rc = r.probe_batch(probe_keys)
    pr, pc = p.probe_batch(probe_keys)
    np.testing.assert_array_equal(pc, rc)
    assert pr.shape == rr.shape
    live = np.arange(pr.shape[1])[None, :] < pc[:, None]
    np.testing.assert_array_equal(pr[live], rr[live])
    # the reference's own case: insertion order of a duplicated key
    p2 = port(DTYPES, capacity=64, rows_per_key=8)
    p2.append_batch(np.array([3, 3, 4, 3], np.int64),
                    np.array([10, 11, 12, 13], np.int64),
                    [np.array([1, 2, 3, 4], np.int64),
                     np.array([0.5, 1.5, 2.5, 3.5])])
    rows, counts = p2.probe_batch(np.array([3, 4, 9], np.int64))
    assert counts.tolist() == [3, 1, 0]
    assert rows[0, :3, 0].tolist() == [10, 11, 13]
    assert p2._unpack_col(rows[0, :3], 1).tolist() == [0.5, 1.5, 3.5]


def test_probe_batch_contract_and_empty(ref):
    """probe_batch keeps [B, L_eff, C] with L_eff a power of two, and the
    empty cases of the reference."""
    rng = np.random.default_rng(2)
    ops = [("append", *_batch(rng, 40, np.arange(5)))]
    r, p = _both(ref, 2, ops, capacity=32, rows_per_key=16)
    keys = np.arange(-2, 7, dtype=np.int64)
    (rr, rc), (pr, pc) = r.probe_batch(keys), p.probe_batch(keys)
    assert pr.shape == rr.shape and pr.dtype == rr.dtype
    np.testing.assert_array_equal(pc, rc)
    live = np.arange(pr.shape[1])[None, :] < pc[:, None]
    np.testing.assert_array_equal(pr[live], rr[live])
    for keys in (np.zeros(0, np.int64), np.array([1000], np.int64)):
        (rr, rc), (pr, pc) = r.probe_batch(keys), p.probe_batch(keys)
        assert pr.shape == rr.shape and pc.tolist() == rc.tolist()


def test_probe_range_is_the_reference_mask(ref):
    """The interval probe equals the reference's probe_batch followed by
    the join's host mask and np.nonzero, ts at the exact bounds
    included."""
    rng = np.random.default_rng(3)
    ops = [("append", *_batch(rng, 300, np.arange(40), span=500))]
    r, p = _both(ref, 3, ops, capacity=128, rows_per_key=32)
    keys = rng.integers(0, 45, 200).astype(np.int64)
    ts = rng.integers(0, 500, 200).astype(np.int64)
    # put probes exactly on stored ts, so lo and hi land on rows
    stored = ops[0][2]
    ts[:50] = stored[:50] + 20
    ts[50:100] = stored[50:100] - 30
    for lo_off, hi_off in ((-20, 30), (0, 0), (-500, 500), (5, 4)):
        packed, counts = r.probe_batch(keys)
        ots = packed[:, :, 0]
        live = np.arange(packed.shape[1])[None, :] < counts[:, None]
        m = live & (ots >= (ts + lo_off)[:, None]) \
            & (ots <= (ts + hi_off)[:, None])
        bi, li = np.nonzero(m)
        got_bi, got = p.probe_range(torch.from_numpy(keys),
                                    torch.from_numpy(ts), lo_off, hi_off)
        np.testing.assert_array_equal(got_bi.numpy(), bi)
        np.testing.assert_array_equal(got.numpy(), packed[bi, li])


@pytest.mark.parametrize("horizon", [0, 420, 10 ** 6])
def test_prune_matches_reference(ref, horizon):
    """Stable compaction, dropped rows after kept ones, lists in and out
    of ts order; a horizon that drops nothing, some, everything."""
    rng = np.random.default_rng(4)
    keys, ts, cols = _batch(rng, 200, np.arange(30))
    shuffled = rng.permutation(200)    # lists out of ts order
    ops = [("append", keys, ts, cols),
           ("append", keys[shuffled], ts[shuffled] + 300,
            [c[shuffled] for c in cols]),
           ("prune", horizon)]
    r, p = _both(ref, 4, ops, capacity=256, rows_per_key=32)
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    assert p.stats["prunes"] == (1 if horizon else 0)


def test_prune_skips_when_nothing_can_drop(ref):
    p = port([np.dtype(np.int64)], capacity=64, rows_per_key=8)
    p.append_batch(np.array([1] * 5, np.int64),
                   np.array([10, 20, 30, 40, 50], np.int64),
                   [np.arange(5, dtype=np.int64)])
    p.prune(5)
    assert p.stats == {"prunes": 0, "prunes_skipped": 1, "probes": 0,
                       "probes_skipped": 0, "rebuilds": 0, "rehashes": 0}
    p.prune(30)
    rows, counts = p.probe_batch(np.array([1], np.int64))
    assert counts[0] == 3 and rows[0, :3, 0].tolist() == [30, 40, 50]


def test_overflow_raises_the_reference_message(ref):
    msgs = []
    for st in (ref([np.dtype(np.int64)], capacity=64, rows_per_key=4),
               port([np.dtype(np.int64)], capacity=64, rows_per_key=4)):
        with pytest.raises(RuntimeError, match="list overflow") as e:
            st.append_batch(np.array([1] * 5, np.int64),
                            np.arange(5, dtype=np.int64),
                            [np.arange(5, dtype=np.int64)])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_rehash_growth_keeps_every_list(ref):
    keys = np.arange(200, dtype=np.int64)
    ops = [("append", keys, keys * 10, [keys * 100, keys / 4.0]),
           ("append", keys[::3], keys[::3] * 10 + 1,
            [keys[::3], keys[::3] / 2.0])]
    r, p = _both(ref, 5, ops, capacity=64, rows_per_key=4)
    assert p.capacity == r.capacity >= 256
    assert p.stats["rehashes"] >= 2
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    rows, counts = p.probe_batch(np.array([7, 151, 9], np.int64))
    assert counts.tolist() == [1, 1, 2]
    assert rows[0, 0, :2].tolist() == [70, 700]


def test_dead_key_rebuild_keeps_live_lists(ref):
    """Dead keys past 64 and half the occupancy rebuild the table without
    them; the live lists survive, and so does the capacity."""
    keys = np.arange(500, dtype=np.int64)
    ts = np.where(keys < 400, 10, 1000).astype(np.int64)
    ops = [("append", keys, ts, [keys, keys * 0.5]), ("prune", 500)]
    r, p = _both(ref, 6, ops, capacity=1024, rows_per_key=4)
    assert p.stats["rebuilds"] == 1 and p._occ == r._occ == 100
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    more = np.arange(450, 700, dtype=np.int64)
    for st in (r, p):
        st.append_batch(more, np.full(250, 1100, np.int64),
                        [more, more * 0.25])
    assert_snapshots_equal(r.snapshot(), p.snapshot())


def test_float_and_bool_columns_round_trip(ref):
    dtypes = [np.dtype(np.float32), np.dtype(np.bool_), np.dtype(np.int32),
              np.dtype(np.float64)]
    cols = [np.array([1.5, -0.0, np.inf, np.nan], np.float32),
            np.array([True, False, True, False]),
            np.array([-7, 0, 2 ** 31 - 1, 5], np.int32),
            np.array([np.nan, -np.inf, 1e300, -2.5])]
    keys = np.array([4, 4, 9, 4], np.int64)
    ts = np.array([1, 2, 3, 4], np.int64)
    r, p = _both(ref, 7, [("append", keys, ts, cols)], dtypes=dtypes,
                 capacity=16, rows_per_key=4)
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    rows, counts = p.probe_batch(np.array([4], np.int64))
    got = [p._unpack_col(rows[0, :3], i) for i in range(4)]
    want = [c[[0, 1, 3]] for c in cols]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_restore_across_packages_both_ways(ref):
    """A snapshot of either package restores into the other; restoring
    widens to a larger rows_per_key; a store rebuilt from it probes the
    same lists."""
    rng = np.random.default_rng(8)
    ops = [("append", *_batch(rng, 120, np.arange(25))), ("prune", 300)]
    r, p = _both(ref, 8, ops, capacity=64, rows_per_key=16)
    from flink_tpu.core import KeyGroupRange as RefRange
    from flink_tpu.state.device_lists import DeviceListStore as RefStore
    for L in (16, 32):
        p2 = DeviceListStore.from_snapshots(KGR, 128, [r.snapshot()],
                                            rows_per_key=L, capacity=64,
                                            device="cpu")
        r2 = RefStore.from_snapshots(RefRange(0, 127), 128, [p.snapshot()],
                                     rows_per_key=L, capacity=64)
        assert p2.L == r2.L == L
        assert_snapshots_equal(r2.snapshot(), p2.snapshot())
        keys = np.arange(30, dtype=np.int64)
        (a, ac), (b, bc) = r2.probe_batch(keys), p2.probe_batch(keys)
        np.testing.assert_array_equal(ac, bc)
    # a restore keeps only its key groups
    half = DeviceListStore(KeyGroupRange(0, 63), 128, DTYPES, device="cpu",
                           rows_per_key=16)
    half.restore([r.snapshot()])
    snap = half.snapshot()
    assert (np.asarray(snap["key_groups"]) <= 63).all()
    assert 0 < len(snap["keys"]) < len(r.snapshot()["keys"])


def test_restore_refuses_shape_mismatch(ref):
    r = ref(DTYPES, capacity=16, rows_per_key=8)
    r.append_batch(np.array([1], np.int64), np.array([5], np.int64),
                   [np.array([1], np.int64), np.array([0.5])])
    narrow = port([np.dtype(np.int64)], capacity=16, rows_per_key=8)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        narrow.restore([r.snapshot()])
    short = port(DTYPES, capacity=16, rows_per_key=4)
    with pytest.raises(RuntimeError, match="shape mismatch"):
        short.restore([r.snapshot()])
    p = port([np.dtype(np.int64)], capacity=16, rows_per_key=8)
    p.append_batch(np.array([1], np.int64), np.array([5], np.int64),
                   [np.array([1], np.int64)])
    with pytest.raises(RuntimeError, match="shape mismatch"):
        ref(DTYPES, capacity=16, rows_per_key=8).restore([p.snapshot()])


def test_plain_versions_on_edge_cases_match_reference(ref):
    """chip_smoke.py's adversarial list cases, run through the plain
    versions here, equal the reference store step by step."""
    for case in cs.LIST_EDGE_CASES:
        c = cs.list_edge_config(case)
        r, p = ref(c["dtypes"], capacity=c["capacity"],
                   rows_per_key=c["L"]), \
            port(c["dtypes"], capacity=c["capacity"], rows_per_key=c["L"])
        for op in c["ops"]:
            outs = []
            for st in (r, p):
                try:
                    outs.append(cs.apply_list_op(st, op))
                except RuntimeError as e:
                    outs.append(("raised", str(e)))
            assert outs[0] == outs[1], (case, op[0])
            assert_snapshots_equal(r.snapshot(), p.snapshot())
            _check_summary(p, exact=op[0] == "prune")


def _check_summary(store, exact: bool) -> dict:
    """The store's tile summary against its rows: live slots a tile
    exact, every live row's ts inside its tile's bounds (``exact``: the
    bounds equal the rows', as the plain prune leaves them)."""
    return cs.check_tiles(torch, {"rows": store.rows, "counts": store.counts,
                                  "tiles": store.tiles}, "summary",
                          exact=exact)


def test_sequences_equal_reference_with_tile_summary(ref):
    """chip_smoke.list_store_ops: seeded appends (in-batch duplicates, ts
    out of order, a hot key past L), a watermark after every batch with
    horizons below, inside and above every list, rehashes, dead-key
    rebuilds, probes and a restore across packages. After every step the
    outputs and snapshots equal the reference's, and the plain tile
    summary holds every live row's ts with its live slots exact (the
    bounds exact after a prune that ran and reloaded nothing)."""
    from flink_tpu.core import KeyGroupRange as RefRange
    from flink_tpu.state.device_lists import DeviceListStore as RefStore

    for seed in (1, 2, 3):
        r, p = ref(DTYPES, capacity=64, rows_per_key=16), \
            port(DTYPES, capacity=64, rows_per_key=16)
        for i, op in enumerate(cs.list_store_ops(seed)):
            before = dict(p.stats)
            if op[0] == "restore":
                r, p = (RefStore.from_snapshots(RefRange(0, 127), 128,
                                                [p.snapshot()], capacity=64),
                        DeviceListStore.from_snapshots(KGR, 128,
                                                       [r.snapshot()],
                                                       capacity=64,
                                                       device="cpu"))
            else:
                outs = []
                for st in (r, p):
                    try:
                        outs.append(cs.apply_list_op(st, op))
                    except RuntimeError as e:
                        outs.append(("raised", str(e)))
                assert outs[0] == outs[1], (seed, i, op[0])
            assert_snapshots_equal(r.snapshot(), p.snapshot())
            ran = op[0] == "prune" and p.stats == dict(
                before, prunes=before["prunes"] + 1)
            _check_summary(p, exact=ran)
        assert p.stats["prunes_skipped"] > 0


def test_probe_skips_equal_reference_on_seeded_sequences(ref):
    """chip_smoke.list_probe_skip_ops: appends, a rehash, prunes at a live
    row's ts, a dead-key rebuild, a prune that empties the store, appends
    and a restore across packages, with probes after every step whose
    interval lies before, ends on, spans, starts on and lies after the
    live rows' ts. Every probe (interval and probe_batch) equals the
    reference's probe_batch with the join's mask; the probes skipped are
    exactly those that miss the bounds or meet an empty store, none after
    the restore until an append."""
    from flink_tpu.core import KeyGroupRange as RefRange
    from flink_tpu.state.device_lists import DeviceListStore as RefStore

    for seed in (1, 2, 3):
        r, p = ref(DTYPES, capacity=64, rows_per_key=16), \
            port(DTYPES, capacity=64, rows_per_key=16)
        kinds = set()
        for i, op in enumerate(cs.list_probe_skip_ops(seed)):
            if op[0] == "skipped":
                assert p.stats["probes_skipped"] == op[1], (seed, i)
                continue
            if op[0] == "restore":
                assert p.stats["rebuilds"] == 1 and p.stats["rehashes"] >= 1
                r, p = (RefStore.from_snapshots(RefRange(0, 127), 128,
                                                [p.snapshot()], capacity=64),
                        DeviceListStore.from_snapshots(KGR, 128,
                                                       [r.snapshot()],
                                                       capacity=64,
                                                       device="cpu"))
                continue
            outs = [cs.apply_list_op(st, op) for st in (r, p)]
            assert outs[0] == outs[1], (seed, i, op[0])
            assert_snapshots_equal(r.snapshot(), p.snapshot())
            kinds.add(op[0])
        assert kinds == {"append", "prune", "probe", "probe_batch"}
        assert p.stats["probes_skipped"] > 0 and p.stats["probes"] > 0


def test_probe_skip_bounds_empty_and_restored_store(ref):
    """The skip on a store's bounds: an empty store skips every probe
    with no launch; intervals that touch the least or largest live ts
    run, those a step past them skip; after a restore nothing skips
    (the bounds are unknown) until an append, which takes them from the
    whole store, restored rows too; a prune that empties the store skips
    again. Results equal the reference's throughout."""
    keys = np.arange(10, dtype=np.int64)
    p = port(DTYPES, capacity=64, rows_per_key=8)
    r = ref(DTYPES, capacity=64, rows_per_key=8)

    def probe(st, lo, hi):
        t = np.array([lo, hi], np.int64)
        return cs.apply_list_op(st, ("probe", keys[:2], t, 0, 0))

    assert probe(p, 0, 10) == ([], [])
    assert p.stats["probes_skipped"] == 1 and p.stats["probes"] == 0
    assert p.probe_batch(keys)[1].tolist() == [0] * 10
    assert p.stats["probes_skipped"] == 2
    for st in (r, p):
        st.append_batch(keys, 100 + 10 * keys, [keys, keys * 0.5])
    cases = ((0, 99, True), (0, 100, False), (190, 300, False),
             (191, 300, True), (120, 150, False))
    for lo, hi, skips in cases:
        before = p.stats["probes_skipped"]
        assert probe(p, lo, hi) == probe(r, lo, hi), (lo, hi)
        assert p.stats["probes_skipped"] - before == skips, (lo, hi)
    p2 = DeviceListStore.from_snapshots(KGR, 128, [r.snapshot()],
                                        capacity=64, device="cpu")
    for lo, hi, _skips in cases:
        assert probe(p2, lo, hi) == probe(r, lo, hi)
    assert p2.stats["probes_skipped"] == 0
    more = np.array([3], np.int64)
    for st in (r, p2):       # a later row: the restored ones keep the low
        st.append_batch(more, np.array([500], np.int64), [more, more * 0.5])
    for lo, hi, skips in ((0, 99, True), (0, 100, False), (501, 600, True),
                          (500, 600, False)):
        before = p2.stats["probes_skipped"]
        assert probe(p2, lo, hi) == probe(r, lo, hi), (lo, hi)
        assert p2.stats["probes_skipped"] - before == skips, (lo, hi)
    for st in (r, p2):
        st.prune(10 ** 6)
    before = p2.stats["probes_skipped"]
    assert probe(p2, 0, 10 ** 7) == probe(r, 0, 10 ** 7) == ([], [])
    assert p2.stats["probes_skipped"] == before + 1


def test_prune_skips_an_emptied_store(ref):
    """A prune that leaves no live key marks the store empty: the next
    prunes are skipped (the reference's change nothing and rebuild
    nothing), the snapshots still equal the reference's, and an append
    makes the prune run again."""
    keys = np.arange(40, dtype=np.int64)
    r, p = _both(ref, 9, [("append", keys, keys * 10, [keys, keys * 0.5]),
                          ("prune", 10 ** 6)],
                 capacity=128, rows_per_key=4)
    assert p.stats == {"prunes": 1, "prunes_skipped": 0, "probes": 0,
                       "probes_skipped": 0, "rebuilds": 0, "rehashes": 0}
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    for h in (10 ** 6 + 1, 10 ** 7):
        for st in (r, p):
            st.prune(h)
        assert_snapshots_equal(r.snapshot(), p.snapshot())
    assert p.stats["prunes"] == 1 and p.stats["prunes_skipped"] == 2
    assert int(p.tiles[2].sum()) == 0
    more = np.array([3, 50], np.int64)
    for st in (r, p):
        st.append_batch(more, np.array([5, 2 * 10 ** 7], np.int64),
                        [more, more * 0.5])
        st.prune(10 ** 7)
    assert p.stats["prunes"] == 2 and p.stats["prunes_skipped"] == 2
    assert_snapshots_equal(r.snapshot(), p.snapshot())
    _check_summary(p, exact=True)
    rows, counts = p.probe_batch(more)
    assert counts.tolist() == [0, 1] and rows[1, 0, 0] == 2 * 10 ** 7


def test_device_required_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceListStore(KGR, 128, DTYPES)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_equal_plain_on_edge_cases(dev):
    for case in cs.LIST_EDGE_CASES:
        seen = cs.check_list_edge(torch, dev, case)
        assert seen["ops"] > 0, case


@pytest.mark.cuda
def test_cuda_store_equals_cpu_store(dev):
    """A store on the card (kernels) and one on the CPU (plain versions)
    through appends with duplicates, probes, prunes, rehashes and
    rebuilds, and ``list_store_ops``' sequences of many watermarks (a
    restore among them): outputs, snapshots and stats equal, the card's
    tile summary holding its rows."""
    got = cs.check_list_store(torch, dev)
    assert got["rehashes"] >= 1 and got["rebuilds"] >= 1
    assert got["prunes"] >= 20 and got["prunes_skipped"] >= 1
