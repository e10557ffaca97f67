"""Port parity: incremental checkpoints
(flink_tpu_torch/state/device_backend.py's dirty-block host mirror and
its snapshot ordered on the device, the dirty marking of
flink_tpu_torch/ops/hash_table.py's ingest step, and the chunked
incremental flink_tpu_torch/checkpoint/storage.py) against
flink_tpu/state/tpu_backend.py, flink_tpu/runtime/operators/
device_window.py::_step_body and the cases of
tests/test_incremental_checkpoint.py.

Every snapshot taken through the mirror is held, field by field, against
the whole-copy form (``snapshot_plain``) and against the reference
backend fed the same batches. Values are small integers (float sums
exact). Tolerance: exact. The reference package is imported inside the
``ref`` fixture, so the card-only cases run where JAX is not installed."""

import os
import types

import numpy as np
import pytest
import torch

from flink_tpu_torch.checkpoint.storage import CompletedCheckpoint, \
    CorruptArtifactError, FsCheckpointStorage, load_checkpoint
from flink_tpu_torch.core import KeyGroupRange, Schema
from flink_tpu_torch.core.device_records import DeviceRecordBatch
from flink_tpu_torch.ops import hash_table as port_ht
from flink_tpu_torch.ops.segment_ops import make_accumulator
from flink_tpu_torch.runtime import OneInputOperatorTestHarness
from flink_tpu_torch.runtime.operators import device_window as port_dw
from flink_tpu_torch.state.device_backend import DeviceKeyedStateBackend
from flink_tpu_torch.window import TumblingEventTimeWindows

EMPTY = int(np.iinfo(np.int64).max)
MAXP = 128


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from flink_tpu.ops.hash_table import ensure_x64
    from flink_tpu.runtime.operators.device_window import _step_body
    from flink_tpu.state.tpu_backend import TpuKeyedStateBackend
    ensure_x64()
    return types.SimpleNamespace(jnp=jnp, step_body=_step_body,
                                 Backend=TpuKeyedStateBackend)


def _snap_equal(a: dict, b: dict) -> None:
    assert a["kind"] == b["kind"] == "tpu"
    assert a["max_parallelism"] == b["max_parallelism"]
    for f in ("keys", "key_groups"):
        x, y = np.asarray(a[f]), np.asarray(b[f])
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a["states"].keys() == b["states"].keys()
    for name, sa in a["states"].items():
        sb = b["states"][name]
        assert (sa["kind"], sa["dtype"], sa["ring"]) == \
            (sb["kind"], sb["dtype"], sb["ring"]), name
        x, y = np.asarray(sa["values"]), np.asarray(sb["values"])
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def _port_backend(capacity=1 << 14, ring=None):
    b = DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP,
                                capacity=capacity, device="cpu")
    b.register_array_state("acc", "sum", torch.float64)
    if ring:
        b.register_array_state("cnt", "count", torch.int32, ring=ring)
    return b


def _ref_backend(ref, capacity=1 << 14, ring=None):
    b = ref.Backend(KeyGroupRange(0, MAXP - 1), MAXP, capacity=capacity)
    b.register_array_state("acc", "sum", ref.jnp.float64)
    if ring:
        b.register_array_state("cnt", "count", ref.jnp.int32, ring=ring)
    return b


def _fold(b, keys, vals, ring=None):
    """One host batch into a port (torch) or reference (numpy) backend."""
    if isinstance(b, DeviceKeyedStateBackend):
        slots = b.slots_for_batch(torch.from_numpy(keys))
        b.fold_batch("acc", slots, torch.from_numpy(vals), slots >= 0)
        if ring is not None:
            b.fold_batch("cnt", slots,
                         torch.ones(len(keys), dtype=torch.int32), slots >= 0,
                         torch.from_numpy(keys % ring))
        return
    slots = b.slots_for_batch(keys)
    b.fold_batch("acc", slots, vals, slots >= 0)
    if ring is not None:
        b.fold_batch("cnt", slots, np.ones(len(keys), np.int32), slots >= 0,
                     ring_idx=keys % ring)


RING, PANE, OFFSET, FIRST_OPEN, BLOCK = 4, 100, -37, -4, 8


def _step_batches(seed, n=200, count=3, distinct=300):
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(10 ** 12), 10 ** 12, distinct)
    pool[:2] = [EMPTY, EMPTY - 1]
    return [(pool[rng.integers(0, distinct, n)],
             rng.integers(-700, 300, n) + 150 * b,
             rng.integers(-50, 50, n)) for b in range(count)]


def _port_dirty_step(step, batches, cap, dev="cpu"):
    table = port_ht.make_table(cap, dev)
    count = make_accumulator("count", (RING, cap), torch.int32, dev)
    plane = make_accumulator("sum", (RING, cap), torch.int64, dev)
    late = torch.zeros((), dtype=torch.int64, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    dirty = torch.zeros(cap // BLOCK + 1, dtype=torch.uint8, device=dev)
    for keys, ts, vals in batches:
        step(table, [("count", count, None),
                     ("sum", plane, torch.from_numpy(vals).to(dev))],
             torch.from_numpy(ts).to(dev), torch.from_numpy(keys).to(dev),
             PANE, OFFSET, FIRST_OPEN, late, dropped, dirty, 3)
    return table, count, plane, late, dropped, dirty


def test_dirty_marking_matches_reference_step_body(ref):
    """``ingest_step_plain`` with dirty marking against ``_step_body``'s
    dirty mask: the same table, planes and counters, every block holding
    a folded slot marked, and no block the reference leaves clean (it
    also marks block 0 for the rows that do not fold)."""
    jnp = ref.jnp
    batches = _step_batches(2)
    for cap in (1024, 64):
        step = ref.step_body((("sum", "p", "v"),), RING, PANE, OFFSET, BLOCK)
        table = jnp.full(cap, EMPTY, jnp.int64)
        arrays = {"__count__": jnp.zeros((RING, cap), jnp.int32),
                  "p": jnp.zeros((RING, cap), jnp.int64)}
        dropped = late = jnp.int64(0)
        dirty = jnp.zeros(cap // BLOCK + 1, bool)
        for keys, ts, vals in batches:
            table, arrays, dropped, late, dirty, _s, _t, _ = step(
                table, arrays, dropped, late, dirty, None, None,
                jnp.asarray(keys), jnp.asarray(ts), {"v": jnp.asarray(vals)},
                None, 0, FIRST_OPEN, len(keys))
        pt, pc, pp, pl, pd, pdirty = _port_dirty_step(
            port_ht.ingest_step, batches, cap)
        assert np.array_equal(pt.numpy(), np.asarray(table))
        assert np.array_equal(pc.numpy(), np.asarray(arrays["__count__"]))
        assert np.array_equal(pp.numpy(), np.asarray(arrays["p"]))
        assert (int(pl), int(pd)) == (int(late), int(dropped))
        folded = set((np.flatnonzero((pc.numpy() > 0).any(0))
                      // BLOCK).tolist())
        mine = set(np.flatnonzero(pdirty.numpy()[:cap // BLOCK]).tolist())
        theirs = set(np.flatnonzero(
            np.asarray(dirty)[:cap // BLOCK]).tolist())
        assert folded == mine and mine <= theirs and mine


def test_delta_snapshots_equal_full_capture_and_reference(ref):
    """Across full captures, deltas, an idle snapshot, a rehash and ring
    retirements: every mirror snapshot equals the whole-copy snapshot
    and the reference backend's snapshot of the same batches."""
    rng = np.random.default_rng(4)
    pb = _port_backend(capacity=1 << 12, ring=4)
    rb = _ref_backend(ref, capacity=1 << 12, ring=4)
    shares = []
    for step in range(7):
        n = [1500, 30, 0, 100, 5, 3000, 3][step]
        if n:
            keys = rng.integers(0, 2000 if step < 5 else 8000, n)
            vals = rng.integers(1, 9, n).astype(np.float64)
            _fold(pb, keys, vals, ring=4)
            _fold(rb, keys, vals, ring=4)
        if step in (3, 6):
            pb.reset_ring_row(step % 4)
            rb.reset_ring_row(step % 4)
        got = pb.snapshot(step)
        _snap_equal(got, pb.snapshot_plain(step))
        _snap_equal(got, rb.snapshot(step))
        log = pb.snapshot_log[-1]
        assert log["checkpoint_id"] == step
        shares.append(log["dirty_share"])
    assert pb.capacity > 1 << 12     # the table grew on the way
    # full captures, block gathers and an idle capture all took place
    assert shares[0] == 1.0 and shares[2] == 0.0
    assert any(0.0 < x <= 0.5 for x in shares), shares


def test_ring_retirement_replays_on_the_host(ref):
    """reset_ring_row between two snapshots reaches the mirror with no
    block dirty: the second capture moves only the dirty mask."""
    pb = _port_backend(capacity=1 << 12, ring=4)
    rb = _ref_backend(ref, capacity=1 << 12, ring=4)
    keys = np.arange(1000, dtype=np.int64)
    for b in (pb, rb):
        _fold(b, keys, np.ones(1000), ring=4)
        b.snapshot(1)
        b.reset_ring_row(2)
    s2 = pb.snapshot(2)
    assert pb.last_snapshot_dma_bytes == pb.capacity // 512
    _snap_equal(s2, rb.snapshot(2))
    _snap_equal(s2, pb.snapshot_plain(2))
    vals = s2["states"]["cnt"]["values"]
    k = s2["keys"]
    assert np.array_equal(vals[k % 4, np.arange(len(k))],
                          np.where(k % 4 == 2, 0, 1))


def test_idle_heavy_checkpoint_dma_drops_10x():
    """The reference test's case: a delta that touches 64 of 200k keys
    moves under a tenth of the full capture's bytes, exactly."""
    b = _port_backend(capacity=1 << 19)
    keys = np.arange(200_000, dtype=np.int64)
    _fold(b, keys, np.ones(200_000))
    b.snapshot(1)
    full = b.last_snapshot_dma_bytes
    _fold(b, np.arange(64, dtype=np.int64), np.ones(64))
    s2 = b.snapshot(2)
    assert 0 < b.last_snapshot_dma_bytes < full / 10
    got = dict(zip(s2["keys"].tolist(),
                   s2["states"]["acc"]["values"].tolist()))
    assert got[0] == 2.0 and got[63] == 2.0 and got[100_000] == 1.0
    assert len(got) == 200_000
    b.snapshot(3)
    assert b.last_snapshot_dma_bytes == b.capacity // 512   # idle


def test_structural_changes_recapture_whole():
    """A rehash, a restore and a ring conform invalidate the mirror; the
    next snapshot captures everything and equals the whole copy."""
    rng = np.random.default_rng(8)
    b = _port_backend(capacity=64, ring=8)
    _fold(b, rng.integers(0, 30, 50), np.ones(50), ring=8)
    b.snapshot(1)
    _fold(b, rng.integers(0, 200, 300), np.ones(300), ring=8)  # rehash
    s = b.snapshot(2)
    assert b.snapshot_log[-1]["dirty_share"] == 1.0
    _snap_equal(s, b.snapshot_plain(2))
    b2 = _port_backend(capacity=64, ring=8)
    b2.restore([s])
    assert b2.snapshot_log.maxlen and b2._mirror_valid is False
    _snap_equal(b2.snapshot(3), s)
    b2.conform_ring(4, range(0, 4))
    assert b2._mirror_valid is False
    _snap_equal(b2.snapshot(4), b2.snapshot_plain(4))


def test_operator_step_marks_dirty():
    """The device window's one-launch step (device batches, deferred)
    keeps the mirror coherent: the delta snapshot holds every fold."""
    op = port_dw.DeviceWindowAggOperator(
        TumblingEventTimeWindows.of(1000), "k",
        [port_dw.AggSpec("sum", "v", out_name="s")], capacity=1 << 13,
        ring_size=8, defer_overflow=True, emit_window_bounds=False,
        device="cpu")
    h = OneInputOperatorTestHarness(op)
    h.open()
    schema = Schema([("k", np.int64), ("v", np.int64), ("ts", np.int64)])

    def dbatch(ks, vs, ts):
        cols = {"k": torch.tensor(ks, dtype=torch.int64),
                "v": torch.tensor(vs, dtype=torch.int64),
                "ts": torch.tensor(ts, dtype=torch.int64)}
        return DeviceRecordBatch(schema, cols, cols["ts"], min(ts), max(ts),
                                 ts_column="ts")

    h.process_batch(dbatch([1, 2], [10, 20], [100, 200]))
    op.snapshot_state(1)
    h.process_batch(dbatch([1, 3], [5, 7], [300, 400]))
    s2 = op.snapshot_state(2)["keyed"]["backend"]
    got = dict(zip(s2["keys"].tolist(),
                   s2["states"]["s"]["values"][0].tolist()))
    assert got == {1: 15, 2: 20, 3: 7}
    _snap_equal(s2, op.backend.snapshot_plain(2))
    assert op.backend.snapshot_log[-1]["dirty_share"] < 1.0


def _cp(cid, snap, savepoint=False):
    return CompletedCheckpoint(cid, 0.0, {"task#0": {"keyed": snap}},
                               is_savepoint=savepoint)


def test_fs_unchanged_state_rewrites_little(tmp_path):
    st = FsCheckpointStorage(str(tmp_path))
    b = _port_backend()
    _fold(b, np.arange(5000, dtype=np.int64), np.ones(5000))
    st.store(_cp(1, b.snapshot(1)))
    first = st.last_bytes_written
    st.store(_cp(2, b.snapshot(2)))
    assert 0 < st.last_bytes_written < first / 10


def test_fs_partial_change_rewrites_changed_pages_only(tmp_path):
    st = FsCheckpointStorage(str(tmp_path))
    b = _port_backend()
    _fold(b, np.arange(5000, dtype=np.int64), np.ones(5000))
    st.store(_cp(1, b.snapshot(1)))
    first = st.last_bytes_written
    _fold(b, np.arange(3, dtype=np.int64), np.ones(3))   # a few groups
    st.store(_cp(2, b.snapshot(2)))
    assert st.last_bytes_written < first / 2


def test_fs_restore_from_incremental_is_exact(ref, tmp_path):
    """Written paged, read back: the snapshot equals what was stored,
    and restores into both packages' backends exactly."""
    st = FsCheckpointStorage(str(tmp_path))
    b = _port_backend(ring=4)
    rng = np.random.default_rng(3)
    keys = rng.integers(-(1 << 40), 1 << 40, 2000)
    _fold(b, keys, rng.integers(1, 9, 2000).astype(np.float64), ring=4)
    snap = b.snapshot(1)
    cp = st.store(_cp(1, snap))
    back = st.load(cp.external_path).task_snapshots["task#0"]["keyed"]
    _snap_equal(back, snap)
    assert os.listdir(st.chunk_dir)
    b2 = _port_backend(ring=4)
    b2.restore([back])
    _snap_equal(b2.snapshot(2), snap)
    rb = _ref_backend(ref, ring=4)
    rb.restore([back])
    _snap_equal(rb.snapshot(2), snap)


def test_fs_chunk_gc_on_subsume(tmp_path):
    st = FsCheckpointStorage(str(tmp_path))
    b = _port_backend()
    _fold(b, np.arange(1000, dtype=np.int64), np.ones(1000))
    cp1 = st.store(_cp(1, b.snapshot(1)))
    n1 = len(os.listdir(st.chunk_dir))
    cp2 = st.store(_cp(2, b.snapshot(2)))     # the same pages: shared
    assert len(os.listdir(st.chunk_dir)) == n1
    st.discard(cp1)
    assert "task#0" in st.load(cp2.external_path).task_snapshots
    st.discard(cp2)
    assert [f for f in os.listdir(st.chunk_dir) if not f.startswith("_")] \
        == []
    # a new storage over the directory rebuilds the counts from manifests
    cp3 = st.store(_cp(3, b.snapshot(3)))
    st2 = FsCheckpointStorage(str(tmp_path))
    os.remove(st2._refs_path)
    st3 = FsCheckpointStorage(str(tmp_path))
    assert st3._refs and all(ids == {3} for ids in st3._refs.values())
    st3.discard(cp3)


def test_fs_savepoint_and_full_mode_stay_self_contained(tmp_path):
    """Savepoints, and every checkpoint of ``incremental=False``, write
    no chunk and load from their own directory."""
    b = _port_backend()
    _fold(b, np.arange(500, dtype=np.int64), np.ones(500))
    for st, cp in ((FsCheckpointStorage(str(tmp_path / "a")),
                    _cp(7, b.snapshot(7), savepoint=True)),
                   (FsCheckpointStorage(str(tmp_path / "b"),
                                        incremental=False),
                    _cp(8, b.snapshot(8)))):
        st.store(cp)
        assert [f for f in os.listdir(st.chunk_dir)
                if not f.startswith("_")] == []
        snap = load_checkpoint(cp.external_path).task_snapshots["task#0"]
        assert len(snap["keyed"]["keys"]) == 500


def test_fs_corrupt_chunk_is_detected(tmp_path):
    st = FsCheckpointStorage(str(tmp_path))
    b = _port_backend()
    _fold(b, np.arange(3000, dtype=np.int64), np.ones(3000))
    cp = st.store(_cp(1, b.snapshot(1)))
    chunk = max((os.path.join(st.chunk_dir, f)
                 for f in os.listdir(st.chunk_dir) if not f.startswith("_")),
                key=os.path.getsize)
    data = bytearray(open(chunk, "rb").read())
    data[len(data) // 2] ^= 1
    open(chunk, "wb").write(bytes(data))
    with pytest.raises(CorruptArtifactError, match="digest"):
        load_checkpoint(cp.external_path)
    os.remove(chunk)
    with pytest.raises(CorruptArtifactError, match="missing"):
        load_checkpoint(cp.external_path)


@pytest.mark.cuda
def test_dirty_step_kernel_equals_plain():
    """On the card: the dirty form of the kernel against its plain
    version: the same key set, planes equal key by key, counters equal,
    and the marked blocks cover every block the kernel wrote."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    batches = _step_batches(2, n=20000, distinct=9000)
    # tables that hold every key (with a full one, which keys win slots
    # follows the order of the claims)
    for cap in (1 << 15, 1 << 14):
        k = _port_dirty_step(port_ht.ingest_step, batches, cap, dev)
        p = _port_dirty_step(port_ht.ingest_step_plain, batches, cap, dev)
        torch.cuda.synchronize()
        kt, pt = k[0].cpu().numpy(), p[0].cpu().numpy()
        assert sorted(kt[kt != EMPTY]) == sorted(pt[pt != EMPTY])
        ks, ps = np.argsort(kt), np.argsort(pt)
        for a, b in ((k[1], p[1]), (k[2], p[2])):
            assert np.array_equal(a.cpu().numpy()[:, ks],
                                  b.cpu().numpy()[:, ps])
        assert [int(t) for t in k[3:5]] == [int(t) for t in p[3:5]]
        written = np.flatnonzero((k[1].cpu().numpy() > 0).any(0)) // BLOCK
        marked = np.flatnonzero(k[5].cpu().numpy()[:cap // BLOCK])
        assert set(written.tolist()) == set(marked.tolist())


@pytest.mark.cuda
def test_mirror_snapshots_on_the_card():
    """On the card: full capture, a delta, an idle capture and a
    retirement, each equal to the whole-copy snapshot."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b = DeviceKeyedStateBackend(KeyGroupRange(0, MAXP - 1), MAXP,
                                capacity=1 << 16, device="cuda")
    b.register_array_state("acc", "sum", torch.float64)
    b.register_array_state("cnt", "count", torch.int32, ring=4)
    rng = np.random.default_rng(6)
    for step, n in enumerate((30000, 200, 0, 5000)):
        if n:
            keys = torch.from_numpy(rng.integers(0, 40000, n)).cuda()
            slots = b.slots_for_batch(keys)
            b.fold_batch("acc", slots, torch.ones(n, dtype=torch.float64,
                                                  device="cuda"), slots >= 0)
            b.fold_batch("cnt", slots, torch.ones(n, dtype=torch.int32,
                                                  device="cuda"),
                         slots >= 0, keys % 4)
        if step == 3:
            b.reset_ring_row(1)
        _snap_equal(b.snapshot(step), b.snapshot_plain(step))
