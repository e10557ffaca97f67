"""Port parity: aligned checkpoints of the flink_tpu_torch runtime
(``checkpoint/coordinator.py``, ``checkpoint/storage.py``, the barrier
path of ``runtime/stream_task.py``) against flink_tpu.

* Periodic checkpoints complete: every task acknowledges each one, the
  coordinator keeps the newest, and the run's rows are unchanged.
* Memory and fs storage give back what they were given, the fs storage
  refuses a corrupt payload or manifest, and retention deletes old
  checkpoint directories.
* Checkpoint -> cancel -> restore -> end: the windows emitted after the
  restore, with those emitted before the cancel, are every window of the
  reference's uninterrupted run, each equal to it (a window emitted
  before the cancel may repeat, with equal values); unfused, fused, and
  incremental from an fs checkpoint directory.
* ``build_restore_map`` has the reference's shape: ``{vid}#{sub}`` ->
  ``reader`` and ``chain`` -> op key -> ``keyed_list``/``operator``.
* The window operator's snapshot in a port checkpoint restores into the
  reference operator through its harness, and a reference checkpoint's
  into the port operator: the rows after the restore complete the run.

Tolerance: exact (integer aggregates).
"""

import os
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.checkpoint.coordinator import \
    CheckpointCoordinator as RefCoordinator  # noqa: E402
from flink_tpu.checkpoint.coordinator import \
    build_restore_map as ref_restore_map  # noqa: E402
from flink_tpu.connectors.core import CollectSink as RefCollectSink  # noqa: E402
from flink_tpu.core import WatermarkStrategy as RefWS  # noqa: E402
from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators import device_window as ref_dw  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.checkpoint import CompletedCheckpoint, \
    CorruptArtifactError, FsCheckpointStorage, MemoryCheckpointStorage, \
    build_restore_map  # noqa: E402
from flink_tpu_torch.checkpoint.storage import load_checkpoint  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy  # noqa: E402
from flink_tpu_torch.core.elements import MAX_WATERMARK  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch  # noqa: E402
from flink_tpu_torch.runtime import OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import device_window as port_dw  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
N_EVENTS, N_KEYS, SPAN, BATCH = 8192, 300, 16_000, 1024
MULT = 0x9E3779B97F4A7C15
RATE = N_EVENTS / 0.8          # a paced run lasts about 0.8 s
WINDOW_OP = "0:DeviceWindowAgg"


def _numpy_gen(idx):
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": (u % np.uint64(N_KEYS)).astype(np.int64),
            "price": (idx % 997) + 1, "ts": (idx * SPAN) // N_EVENTS}


def _torch_gen(idx):
    """``_numpy_gen`` on int64 torch indices (uint64 product emulated)."""
    x = idx * (MULT - (1 << 64))
    auction = (((x >> 1) & ((1 << 63) - 1)) % N_KEYS * 2 + (x & 1)) % N_KEYS
    return {"auction": auction, "price": idx % 997 + 1,
            "ts": (idx * SPAN) // N_EVENTS}


def _port_q5(settings, rows, rate=None, device=True):
    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": BATCH, **settings}),
        device="cpu")
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    (env.datagen(_torch_gen if device else _numpy_gen, Schema(FIELDS),
                 count=N_EVENTS, rate_per_sec=rate, timestamp_column="ts",
                 watermark_strategy=ws, device=device)
        .key_by("auction")
        .window(SlidingEventTimeWindows.of(5000, 1000))
        .device_aggregate([port_dw.AggSpec("count", out_name="bids",
                                           value_bits=31),
                           port_dw.AggSpec("sum", "price",
                                           out_name="revenue")],
                          capacity=1 << 10, ring_size=32,
                          defer_overflow=True, async_fire=True)
        .add_sink(lambda b: rows.extend(b.iter_rows()), "Collect"))
    return env


def _ref_q5(sink, count=N_EVENTS, rate=None):
    env = RefEnv()
    env.set_state_backend("tpu")
    env.config.set("pipeline.micro-batch-size", BATCH)
    ws = RefWS.for_monotonous_timestamps().with_timestamp_column("ts")
    (env.datagen(_numpy_gen, RefSchema(FIELDS), count=count,
                 rate_per_sec=rate, timestamp_column="ts",
                 watermark_strategy=ws)
        .key_by("auction")
        .window(RefSliding.of(5000, 1000))
        .device_aggregate([ref_dw.AggSpec("count", out_name="bids",
                                          value_bits=31),
                           ref_dw.AggSpec("sum", "price",
                                          out_name="revenue")],
                          capacity=1 << 10, ring_size=32,
                          defer_overflow=True, async_fire=True)
        .add_sink(sink, "Collect"))
    return env


_FULL: list = []


def _reference_rows():
    if not _FULL:
        sink = RefCollectSink()
        _ref_q5(sink).execute("q5")
        _FULL.extend(tuple(int(v) for v in r) for r in sink.rows)
    return _FULL


def _by_window(rows):
    out = defaultdict(list)
    for r in rows:
        out[int(r[2])].append(tuple(int(v) for v in r))
    return out


def _assert_completes_run(before, after):
    """``before`` (rows up to the cancel) and ``after`` (rows of the
    restored run) hold every window of the uninterrupted reference run,
    each equal to it; a window in both is equal in both."""
    want, b, a = (_by_window(_reference_rows()), _by_window(before),
                  _by_window(after))
    assert a, "the restored run emitted nothing"
    assert sorted(set(b) | set(a)) == sorted(want)
    for end, rows in list(b.items()) + list(a.items()):
        assert rows == want[end], end


def _checkpoint_mid_run(env, min_next=3 * BATCH, timeout=30.0):
    """Start ``env``'s job, wait for a completed checkpoint whose source
    position is at least ``min_next`` records, cancel; returns (job,
    checkpoint). The checkpoint is read after ``cancel`` has joined the
    tasks: one in flight at the cancel may still complete and retire the
    one seen before it."""
    job = env.execute_async("q5-checkpointed")
    deadline = time.time() + timeout
    while time.time() < deadline and not job.failed:
        cp = job.coordinator.latest_checkpoint()
        if cp is not None and _reader_next(cp) >= min_next:
            break
        time.sleep(0.005)
    else:
        job.cancel()
        raise AssertionError("no checkpoint completed mid-run")
    job.cancel()
    return job, job.coordinator.latest_checkpoint()


def _reader_next(cp):
    """The source's next record index: a device reader snapshots a dict,
    a host reader its bare index."""
    states = [s["reader"] for s in cp.task_snapshots.values()
              if s.get("reader") is not None]
    return max(r["next"] if isinstance(r, dict) else int(r) for r in states)


def _window_snapshot(cp):
    (snap,) = [s["chain"][k] for s in cp.task_snapshots.values()
               for k in (s.get("chain") or {}) if k.endswith("DeviceWindowAgg")]
    return snap


def test_periodic_checkpoints_complete():
    rows = []
    env = _port_q5({"execution.checkpointing.interval": 0.05}, rows,
                   rate=RATE)
    job = env.execute("q5-periodic")
    stats = job.coordinator.stats
    assert len(stats) >= 3, stats
    assert all(not s.get("failed") for s in stats)
    assert [s["id"] for s in stats] == sorted(s["id"] for s in stats)
    for s in stats:
        assert s["tasks"] == len(job.tasks) == 2
        assert set(s["barrier_to_ack_s"]) == set(job.tasks)
        assert s["duration_s"] >= 0
    assert stats[-1]["bytes"] > 0    # the first may precede every key
    cp = job.coordinator.latest_checkpoint()
    assert cp.checkpoint_id == stats[-1]["id"]
    snap = _window_snapshot(cp)
    backend = snap["keyed"]["backend"]
    assert backend["kind"] == "tpu" and len(backend["keys"])
    assert job.operators[0].backend.last_snapshot_s.keys() == \
        {"capture", "order", "gather", "host_tier"}
    assert sorted(rows) == sorted(_reference_rows())


def _nested_equal(a, b):
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nested_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(
            _nested_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("kind", ["memory", "fs"])
def test_storage_round_trip(kind, tmp_path):
    rng = np.random.default_rng(2)
    snaps = {"v1#0": {"reader": {"next": 4096, "prev_last": -7,
                                 "viol": False}, "chain": None},
             "v2#0": {"chain": {WINDOW_OP: {
                 "keyed": {"kind": "tpu",
                           "keys": rng.integers(0, 1 << 40, 33),
                           "key_groups": rng.integers(0, 128, 33)
                           .astype(np.int32),
                           "max_parallelism": 128,
                           "states": {"bids": {
                               "kind": "count", "dtype": "int32", "ring": 8,
                               "values": rng.integers(0, 9, (8, 33))
                               .astype(np.int32)}}},
                 "operator": {"fired": 12, "pending": (1, [2.5, "x"])}}}}}
    storage = (MemoryCheckpointStorage() if kind == "memory"
               else FsCheckpointStorage(str(tmp_path)))
    cps = [CompletedCheckpoint(i, 1.0 + i, snaps, vertex_parallelism={
        "v1": 1, "v2": 1}, vertex_uids={"v1": "a", "v2": "b"})
        for i in (1, 2)]
    for cp in cps:
        storage.store(cp)
    back = storage.load(cps[1].external_path if kind == "fs" else 2)
    assert back.checkpoint_id == 2 and back.timestamp == 3.0
    assert back.vertex_uids == {"v1": "a", "v2": "b"}
    assert _nested_equal(back.task_snapshots, snaps)
    if kind == "memory":
        storage.discard(cps[0])
        with pytest.raises(KeyError):
            storage.load(1)
        return
    path = cps[1].external_path
    assert sorted(os.listdir(tmp_path)) == ["chk-1", "chk-2", "chunks"]
    storage.discard(cps[0])
    assert sorted(os.listdir(tmp_path)) == ["chk-2", "chunks"]
    payload = os.path.join(path, "a1.bin")
    data = bytearray(open(payload, "rb").read())
    data[0] ^= 1
    open(payload, "wb").write(bytes(data))
    with pytest.raises(CorruptArtifactError, match="digest"):
        load_checkpoint(path)
    with open(os.path.join(path, "_manifest.pkl"), "wb") as f:
        f.write(b"not a manifest")
    with pytest.raises(CorruptArtifactError, match="unreadable"):
        load_checkpoint(path)


RESTORE_CASES = {
    "unfused": ({}, False),
    "fused": ({"pipeline.fusion.enabled": True}, False),
    # incremental fires, checkpoints in a directory, the restore from the
    # directory's path
    "incremental_fs": ({"window.fire.incremental": True}, True),
}


@pytest.mark.parametrize("case", sorted(RESTORE_CASES))
def test_cancel_and_restore_completes_the_run(case, tmp_path):
    settings, on_disk = RESTORE_CASES[case]
    ckpt = {"execution.checkpointing.interval": 0.05}
    if on_disk:
        ckpt["execution.checkpointing.dir"] = str(tmp_path)
    before = []
    job, cp = _checkpoint_mid_run(_port_q5({**settings, **ckpt}, before,
                                           rate=RATE))
    assert _reader_next(cp) < N_EVENTS
    if on_disk:
        # one checkpoint is retained: only the newest directory is left
        assert sorted(os.listdir(tmp_path)) == [f"chk-{cp.checkpoint_id}",
                                                "chunks"]
    after = []
    env = _port_q5(settings, after)
    env.restore_from_checkpoint(cp.external_path if on_disk else cp)
    job2 = env.execute("q5-restored")
    (src,) = job2.source_tasks.values()
    assert src.records_in == N_EVENTS - _reader_next(cp)
    assert job2.fusion_declined == {}
    _assert_completes_run(before, after)


def test_restore_map_has_reference_shape():
    """A port checkpoint and a reference checkpoint of the same Q5 job map
    onto their job graphs the same way."""
    rows = []
    env = _port_q5({"execution.checkpointing.interval": 0.05}, rows,
                   rate=RATE)
    job, cp = _checkpoint_mid_run(env, min_next=BATCH)
    port_map = build_restore_map(cp, job.job_graph)

    sink = RefCollectSink()
    ref_env = _ref_q5(sink, count=None, rate=RATE)
    ref_job = ref_env.execute_async("q5-ref")
    ref_cp = RefCoordinator(ref_job, ref_env.config) \
        .trigger_savepoint(timeout=60)
    ref_job.cancel()
    ref_map = ref_restore_map(ref_cp, ref_job.job_graph)

    def shape(restore, jg):
        names = {vid: v.name for vid, v in jg.vertices.items()}
        out = {}
        for task_id, snap in restore.items():
            vid, sub = task_id.rsplit("#", 1)
            chain = snap.get("chain") or {}
            out[(names[vid], sub)] = (
                sorted(snap), "reader" in snap and snap["reader"] is not None,
                {k: (sorted(v), len(v["keyed_list"]),
                     v["operator"] is not None) for k, v in chain.items()})
        return out

    assert shape(port_map, job.job_graph) == shape(ref_map,
                                                   ref_job.job_graph)
    (win,) = [s["chain"][WINDOW_OP] for s in port_map.values()
              if WINDOW_OP in (s.get("chain") or {})]
    assert win["keyed_list"][0]["backend"]["kind"] == "tpu"


def _feed_rest(harness, batch_cls, schema, start):
    """The batches of the stream from reader index ``start``, each
    followed by the monotonous watermark, then the final watermark, as
    the restored job's source would emit them."""
    for lo in range(start, N_EVENTS, BATCH):
        idx = np.arange(lo, min(lo + BATCH, N_EVENTS), dtype=np.int64)
        cols = _numpy_gen(idx)
        harness.process_batch(batch_cls(schema, cols).with_timestamps(
            cols["ts"]))
        harness.process_watermark(int(cols["ts"].max()) - 1)
    harness.process_watermark(MAX_WATERMARK.timestamp)
    harness.close()
    return [tuple(int(v) for v in r) for b in harness.output.batches
            for r in b.iter_rows()]


@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_window_snapshot_restores_across_packages(direction):
    specs = [("count", None, "bids", 31), ("sum", "price", "revenue", None)]
    if direction == "port_to_reference":
        before = []
        _job, cp = _checkpoint_mid_run(_port_q5(
            {"execution.checkpointing.interval": 0.05}, before, rate=RATE))
        op = ref_dw.DeviceWindowAggOperator(
            RefSliding.of(5000, 1000), "auction",
            [ref_dw.AggSpec(k, f, out_name=n, value_bits=vb)
             for k, f, n, vb in specs],
            capacity=1 << 10, ring_size=32, defer_overflow=True,
            async_fire=True)
        harness = RefHarness.restored(lambda: op, _window_snapshot(cp),
                                      schema=RefSchema(FIELDS))
        after = _feed_rest(harness, RefBatch, RefSchema(FIELDS),
                           _reader_next(cp))
    else:
        _reference_rows()   # compiles the reference's programs first
        sink = RefCollectSink()
        env = _ref_q5(sink, rate=RATE)
        job = env.execute_async("q5-ref")
        (src,) = job.source_tasks.values()
        deadline = time.time() + 10
        while src.reader._next < 2 * BATCH and time.time() < deadline:
            time.sleep(0.002)   # two batches read: the run is underway
        cp = RefCoordinator(job, env.config).trigger_savepoint(timeout=10)
        job.cancel()
        before = list(sink.rows)
        assert 0 < _reader_next(cp) < N_EVENTS
        op = port_dw.DeviceWindowAggOperator(
            SlidingEventTimeWindows.of(5000, 1000), "auction",
            [port_dw.AggSpec(k, f, out_name=n, value_bits=vb)
             for k, f, n, vb in specs],
            capacity=1 << 10, ring_size=32, defer_overflow=True,
            async_fire=True, device="cpu")
        harness = OneInputOperatorTestHarness.restored(
            lambda: op, _window_snapshot(cp), schema=Schema(FIELDS))
        after = _feed_rest(harness, RecordBatch, Schema(FIELDS),
                           _reader_next(cp))
    _assert_completes_run(before, after)
