"""Port parity of unaligned checkpoints (``runtime/channels.py``'s
unaligned gate, ``runtime/stream_task.py``'s unaligned one- and two-input
tasks, ``checkpoint/coordinator.py``'s declines and in-flight restore map)
against the reference, on the unaligned half of
tests/test_unaligned_changelog.py:

* the gate: a barrier overtaking queued batches, post-barrier data not
  captured, the alignment timeout escalating to unaligned, a sibling
  gate's capture;
* the tasks: an ack carrying its in-flight batches, replayed before new
  input after a restore; the two-input case; a checkpoint overtaken before
  its capture finished declined; restores across the packages both ways;
* in-flight device batches: a ``DeviceRecordBatch`` and a
  ``LazyDeviceBatch`` pickle as host batches, through the fs storage too;
* the restore map: in-flight batches to the same subtask, a rescale
  refused; the coordinator aborting a declined checkpoint.

Each case runs the same script through both packages and compares what
each gate handed out, what each task acknowledged and what each operator
saw. Sleeps only pass alignment timeouts; nothing is timed.
"""

import pickle
import threading
import time
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import flink_tpu.checkpoint.coordinator as ref_coord  # noqa: E402
import flink_tpu.checkpoint.storage as ref_storage  # noqa: E402
import flink_tpu.core.elements as ref_el  # noqa: E402
import flink_tpu.core.records as ref_rec  # noqa: E402
import flink_tpu.graph.stream_graph as ref_graph  # noqa: E402
import flink_tpu.runtime.channels as ref_ch  # noqa: E402
import flink_tpu.runtime.operators.base as ref_base  # noqa: E402
import flink_tpu.runtime.operators.simple as ref_simple  # noqa: E402
import flink_tpu.runtime.stream_task as ref_st  # noqa: E402
import flink_tpu_torch.checkpoint.coordinator as port_coord  # noqa: E402
import flink_tpu_torch.checkpoint.storage as port_storage  # noqa: E402
import flink_tpu_torch.core.elements as port_el  # noqa: E402
import flink_tpu_torch.core.records as port_rec  # noqa: E402
import flink_tpu_torch.graph.stream_graph as port_graph  # noqa: E402
import flink_tpu_torch.runtime.channels as port_ch  # noqa: E402
import flink_tpu_torch.runtime.operators.base as port_base  # noqa: E402
import flink_tpu_torch.runtime.operators.simple as port_simple  # noqa: E402
import flink_tpu_torch.runtime.stream_task as port_st  # noqa: E402
from flink_tpu_torch.connectors.datagen import DataGenSource  # noqa: E402
from flink_tpu_torch.core.device_records import \
    DeviceRecordBatch  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(el=ref_el, rec=ref_rec, ch=ref_ch,
                                 base=ref_base, simple=ref_simple,
                                 st=ref_st, coord=ref_coord,
                                 storage=ref_storage, graph=ref_graph),
    "port": types.SimpleNamespace(el=port_el, rec=port_rec, ch=port_ch,
                                  base=port_base, simple=port_simple,
                                  st=port_st, coord=port_coord,
                                  storage=port_storage, graph=port_graph),
}
RNG_SEED = 24


def schema(side):
    return side.rec.Schema([("k", np.int64), ("v", np.int64)])


def seeded_rows(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [(int(k), int(v)) for k, v in
            zip(rng.integers(0, 50, n), rng.integers(-1000, 1000, n))]


def batch(side, rows, ts=None):
    return side.rec.RecordBatch.from_rows(schema(side), rows,
                                          ts or [0] * len(rows))


def rows_of(b) -> list:
    return [tuple(int(x) for x in r) for r in b.iter_rows()]


def element(side, spec):
    kind = spec[0]
    if kind == "batch":
        return batch(side, spec[1])
    if kind == "barrier":
        return side.el.CheckpointBarrier(spec[1], 0)
    if kind == "wm":
        return side.el.Watermark(spec[1])
    return side.el.EndOfInput()


def gate_trace(side, n_channels: int, script: list, **gate_kw) -> list:
    """Run ``script`` against a gate of ``n_channels`` local channels:
    ("put", ch, spec) queues an element, ("poll",) records the event the
    gate hands out, ("state",) its capture state, ("sleep", s) waits."""
    chans = [side.ch.LocalChannel() for _ in range(n_channels)]
    gate = side.ch.InputGate(chans, **gate_kw)
    out = []
    for step in script:
        if step[0] == "put":
            chans[step[1]].put(element(side, step[2]))
        elif step[0] == "sleep":
            time.sleep(step[1])
        elif step[0] == "poll":
            ev = gate.poll()
            if ev is None:
                out.append(None)
            elif ev.kind == "batch":
                out.append(("batch", ev.channel, rows_of(ev.value)))
            elif ev.kind == "barrier":
                out.append(("barrier", ev.value.checkpoint_id))
            else:
                out.append((ev.kind, getattr(ev.value, "timestamp", None)))
        elif step[0] == "take":
            out.append(("taken", [rows_of(b) for b in gate.take_captured()]))
        else:
            out.append(("state", gate.capture_active, gate.capture_complete,
                        [rows_of(b) for b in gate.captured]))
    return out


def both(fn, *a, **kw):
    got = {name: fn(side, *a, **kw) for name, side in SIDES.items()}
    assert got["ref"] == got["port"], got
    return got["port"]


# -- the gate ---------------------------------------------------------------

def test_unaligned_barrier_overtakes_queued_batches():
    b1, b2 = seeded_rows(3, RNG_SEED), seeded_rows(2, RNG_SEED + 1)
    script = [("put", 1, ("batch", b1)), ("put", 1, ("batch", b2)),
              ("put", 0, ("barrier", 1)), ("poll",), ("poll",), ("state",),
              ("poll",), ("poll",), ("state",),
              ("put", 1, ("barrier", 1)), ("poll",), ("state",), ("take",),
              ("state",)]
    got = both(gate_trace, 2, script, aligned=True, unaligned=True)
    # the barrier fires ahead of channel 1's queued batches, which are
    # delivered and captured; channel 1's barrier completes the capture
    assert ("barrier", 1) in got[:2]
    assert ("state", True, True, [b1, b2]) in got
    assert got[-2] == ("taken", [b1, b2])
    assert got[-1] == ("state", False, False, [])


def test_unaligned_post_barrier_data_not_captured():
    post = seeded_rows(4, RNG_SEED + 2)
    script = [("put", 0, ("barrier", 1)), ("poll",),
              ("put", 0, ("batch", post)), ("poll",), ("state",)]
    got = both(gate_trace, 2, script, aligned=True, unaligned=True)
    assert got == [("barrier", 1), ("batch", 0, post),
                   ("state", True, False, [])]


def test_alignment_timeout_escalates_to_unaligned():
    pre = seeded_rows(5, RNG_SEED + 3)
    script = [("put", 0, ("barrier", 5)), ("poll",),
              ("put", 1, ("batch", pre)), ("sleep", 0.05), ("poll",),
              ("poll",), ("state",), ("put", 1, ("barrier", 5)), ("poll",),
              ("state",)]
    got = both(gate_trace, 2, script, aligned=True,
               alignment_timeout_s=0.02)
    assert got[:3] == [None, ("barrier", 5), ("batch", 1, pre)]
    assert got[-1] == ("state", True, True, [pre])


def test_aligned_gate_without_timeout_keeps_blocking():
    pre = seeded_rows(3, RNG_SEED + 4)
    script = [("put", 0, ("barrier", 2)), ("put", 0, ("batch", pre)),
              ("poll",), ("poll",), ("put", 1, ("barrier", 2)), ("poll",),
              ("poll",), ("state",)]
    got = both(gate_trace, 2, script, aligned=True)
    assert got == [None, None, ("barrier", 2), ("batch", 0, pre),
                   ("state", False, False, [])]


def test_sibling_gate_capture_and_newer_barrier_overtaking_a_capture():
    def run(side):
        chans = [side.ch.LocalChannel() for _ in range(2)]
        gate = side.ch.InputGate(chans, aligned=True, unaligned=True)
        rows = seeded_rows(2, RNG_SEED + 5)
        chans[0].put(batch(side, rows))
        gate.begin_capture(side.el.CheckpointBarrier(3, 0))
        gate.begin_capture(side.el.CheckpointBarrier(2, 0))  # older: kept
        first = gate.poll()
        chans[1].put(side.el.CheckpointBarrier(4, 0))  # newer: overtakes
        second = gate.poll()
        return (rows_of(first.value), second.kind,
                second.value.checkpoint_id, gate.capture_complete,
                [rows_of(b) for b in gate.captured])

    got = both(run)
    assert got[1:] == ("barrier", 4, False, [])


def test_replayable_channel_rereads_and_seals_an_adopted_partition():
    def run(side):
        rows = seeded_rows(6, RNG_SEED + 6)
        part = side.ch.ReplayableChannel()
        for i in range(3):
            part.put(batch(side, rows[2 * i:2 * i + 2]))
        first = rows_of(part.poll())
        reader = part.clone_reader()          # a fresh cursor, same items
        reread = [rows_of(reader.poll()) for _ in range(3)]
        sizes = (part.size(), reader.size(), reader.poll())
        winner = side.ch.ReplayableChannel()
        winner.put(batch(side, rows[:1]))
        part.adopt_items(winner)
        part.put(batch(side, rows[1:2]))      # the losing attempt's late write
        adopted = [rows_of(part.poll()), part.poll(), part.size()]
        return first, reread, sizes, adopted

    got = both(run)
    rows = seeded_rows(6, RNG_SEED + 6)
    assert got == (rows[:2], [rows[:2], rows[2:4], rows[4:]], (2, 0, None),
                   [rows[:1], None, 0])


# -- the tasks ---------------------------------------------------------------

class Reporter:
    def __init__(self):
        self.acks, self.declines = {}, []
        self.failed = []

    def acknowledge_checkpoint(self, tid, cid, snap):
        self.acks[cid] = snap

    def declined_checkpoint(self, tid, cid, reason):
        self.declines.append((cid, reason))

    def task_finished(self, tid):
        pass

    def task_failed(self, tid, err):
        self.failed.append(err)


def one_input_task(side, name: str, rep, seen: list, n_channels: int = 2,
                   **gate_kw):
    chans = [side.ch.LocalChannel() for _ in range(n_channels)]
    ctx = side.base.OperatorContext("t", 0, 1, 128)
    op = side.simple.BatchFnOperator(
        lambda b: seen.extend(rows_of(b)) or None, "probe")
    gate = side.ch.InputGate(chans, aligned=True,
                             **(gate_kw or {"unaligned": True}))
    chain = side.base.OperatorChain([op], ctx,
                                    side.base.CollectingOutput())
    if side is SIDES["ref"]:
        task = side.st.OneInputStreamTask(name, ctx, gate, chain, [], rep)
    else:
        task = side.st.OneInputStreamTask(name, ctx, gate, [], rep)
        task.chain = chain
    return task, chans


def run_task(task) -> None:
    t = task.start()
    t.join(20)
    assert not t.is_alive()


def unaligned_ack(side, rows: list):
    rep, seen = Reporter(), []
    task, (c0, c1) = one_input_task(side, "t#0", rep, seen)
    c1.put(batch(side, rows))          # in flight when the barrier overtakes
    c0.put(side.el.CheckpointBarrier(1, 0))
    c0.put(side.el.EndOfInput())
    c1.put(side.el.CheckpointBarrier(1, 0))
    c1.put(side.el.EndOfInput())
    run_task(task)
    assert not rep.failed
    return rep.acks, seen


def replay(side, snapshot: dict, later_rows: list) -> list:
    rep, seen = Reporter(), []
    task, (d0, d1) = one_input_task(side, "t#0", rep, seen)
    task.restore_state(snapshot)
    d0.put(batch(side, later_rows))
    d0.put(side.el.EndOfInput())
    d1.put(side.el.EndOfInput())
    run_task(task)
    return seen


def test_unaligned_ack_carries_inflight_and_a_restore_replays_it_first():
    rows, later = seeded_rows(6, RNG_SEED + 6), seeded_rows(3, RNG_SEED + 7)

    def run(side):
        acks, seen = unaligned_ack(side, rows)
        inflight = acks[1]["inflight"]
        return (sorted(acks), [rows_of(b) for b in inflight], seen,
                replay(side, acks[1], later))

    got = both(run)
    assert got[1] == [rows] and got[2] == rows
    assert got[3] == rows + later      # replayed before any new input


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_unaligned_checkpoint_restores_across_the_packages(direction):
    rows, later = seeded_rows(7, RNG_SEED + 8), seeded_rows(2, RNG_SEED + 9)
    src, dst = (("ref", "port") if direction == "ref_to_port"
                else ("port", "ref"))
    acks, _ = unaligned_ack(SIDES[src], rows)
    # through pickle, as a checkpoint on disk would carry it
    snap = pickle.loads(pickle.dumps(acks[1]))
    assert replay(SIDES[dst], snap, later) == rows + later


def test_port_device_batch_in_flight_restores_into_the_reference():
    rows = seeded_rows(5, RNG_SEED + 10)
    rep, seen = Reporter(), []
    side = SIDES["port"]
    task, (c0, c1) = one_input_task(side, "t#0", rep, seen)
    host = batch(side, rows)
    dev = DeviceRecordBatch(host.schema, {k: torch.from_numpy(v.copy())
                                          for k, v in host.columns.items()},
                            torch.zeros(len(rows), dtype=torch.int64), 0, 0)
    c1.put(dev)
    c0.put(side.el.CheckpointBarrier(1, 0))
    c0.put(side.el.EndOfInput())
    c1.put(side.el.CheckpointBarrier(1, 0))
    c1.put(side.el.EndOfInput())
    run_task(task)
    (captured,) = rep.acks[1]["inflight"]
    assert captured is dev             # kept on its device until stored
    snap = pickle.loads(pickle.dumps(rep.acks[1]))
    assert type(snap["inflight"][0]) is port_rec.RecordBatch
    assert replay(SIDES["ref"], snap, []) == rows


def test_overtaken_unaligned_checkpoint_is_declined():
    rows = seeded_rows(4, RNG_SEED + 11)

    def run(side):
        rep, seen = Reporter(), []
        task, (c0, c1) = one_input_task(side, "t#0", rep, seen)
        c1.put(batch(side, rows))
        c0.put(side.el.CheckpointBarrier(1, 0))
        c0.put(side.el.CheckpointBarrier(2, 0))   # before c1's barrier 1
        c0.put(side.el.EndOfInput())
        c1.put(side.el.CheckpointBarrier(1, 0))
        c1.put(side.el.CheckpointBarrier(2, 0))
        c1.put(side.el.EndOfInput())
        run_task(task)
        return (rep.declines, sorted(rep.acks),
                {c: [rows_of(b) for b in s.get("inflight", [])]
                 for c, s in rep.acks.items()}, seen)

    got = both(run)
    assert got[0] == [(1, "overtaken by a newer unaligned checkpoint")]
    assert got[1] == [2] and got[3] == rows


class TwoSink:
    """Records each input's rows."""

    @staticmethod
    def make(side, seen: dict):
        class Op(side.base.TwoInputOperator):
            def process_batch1(self, b):
                seen[1].extend(rows_of(b))

            def process_batch2(self, b):
                seen[2].extend(rows_of(b))

        return Op("two")


def two_input_run(side, rows1: list, rows2: list, restore=None):
    rep, seen = Reporter(), {1: [], 2: []}
    ctx = side.base.OperatorContext("t2", 0, 1, 128)
    g = [[side.ch.LocalChannel()], [side.ch.LocalChannel()]]
    gates = [side.ch.InputGate(c, aligned=True, unaligned=True) for c in g]
    chain = side.base.OperatorChain([TwoSink.make(side, seen)], ctx,
                                    side.base.CollectingOutput())
    if side is SIDES["ref"]:
        task = side.st.TwoInputStreamTask("t2#0", ctx, gates[0], gates[1],
                                          chain, [], rep)
    else:
        task = side.st.TwoInputStreamTask("t2#0", ctx, gates[0], gates[1],
                                          [], rep)
        task.chain = chain
    if restore is not None:
        task.restore_state(restore)
    else:
        g[1][0].put(batch(side, rows2))     # in flight on input 2
        g[0][0].put(side.el.CheckpointBarrier(1, 0))
        g[1][0].put(side.el.CheckpointBarrier(1, 0))
    g[0][0].put(batch(side, rows1))
    for c in (g[0][0], g[1][0]):
        c.put(side.el.EndOfInput())
    run_task(task)
    assert not rep.failed
    return rep, seen


def test_two_input_unaligned_checkpoint_and_its_replay():
    rows1, rows2 = seeded_rows(3, RNG_SEED + 12), seeded_rows(4, RNG_SEED + 13)

    def run(side):
        rep, seen = two_input_run(side, rows1, rows2)
        snap = rep.acks[1]
        _, again = two_input_run(side, rows1, [], restore=snap)
        return ([rows_of(b) for b in snap["inflight1"]],
                [rows_of(b) for b in snap["inflight2"]], seen, again)

    got = both(run)
    assert got[0] == [] and got[1] == [rows2]
    assert got[3] == {1: rows1, 2: rows2}   # input 2 replayed first


# -- device batches ----------------------------------------------------------

def _gen(idx):
    return {"k": idx % 7, "v": idx * 3 - 5, "ts": idx // 4}


def test_device_and_lazy_batches_pickle_as_host_batches():
    sch = port_rec.Schema([("k", np.int64), ("v", np.int64),
                           ("ts", np.int64)])
    src = DataGenSource(_gen, sch, count=64, timestamp_column="ts",
                        device=True)
    (split,) = src.create_splits(1)
    reader = src.create_reader(split, torch.device("cpu"))
    dev = reader.read_batch(32)
    assert isinstance(dev, DeviceRecordBatch) and not dev.lazy
    lazy_reader = src.create_reader(split, torch.device("cpu"))
    assert lazy_reader.enable_fused()
    lazy_reader.read_batch(32)
    lazy = lazy_reader.read_batch(32)
    assert lazy.lazy and not lazy.realized
    idx = np.arange(64, dtype=np.int64)
    want = _gen(idx)
    for b, lo in ((dev, 0), (lazy, 32)):
        host = pickle.loads(pickle.dumps(b))
        assert type(host) is port_rec.RecordBatch
        for c in ("k", "v", "ts"):
            np.testing.assert_array_equal(host.column(c),
                                          want[c][lo:lo + 32])
        np.testing.assert_array_equal(host.timestamps, want["ts"][lo:lo + 32])
    assert lazy.realized


def test_fs_storage_stores_device_inflight_as_host_batches(tmp_path):
    rows = seeded_rows(8, RNG_SEED + 14)
    host = batch(SIDES["port"], rows)
    dev = DeviceRecordBatch(host.schema, {k: torch.from_numpy(v.copy())
                                          for k, v in host.columns.items()},
                            torch.arange(8, dtype=torch.int64), 0, 7)
    cp = port_storage.CompletedCheckpoint(
        3, 0.0, {"v1#0": {"chain": {}, "inflight": [dev]}},
        vertex_parallelism={"v1": 1})
    stored = port_storage.FsCheckpointStorage(str(tmp_path)).store(cp)
    back = port_storage.load_checkpoint(stored.external_path)
    (b,) = back.task_snapshots["v1#0"]["inflight"]
    assert rows_of(b) == rows
    np.testing.assert_array_equal(b.timestamps, np.arange(8))


# -- the restore map and the coordinator --------------------------------------

def _checkpoint(side, old_par: int, inflight_key: str = "inflight"):
    node = side.graph.StreamNode(1, "op", "one_input", 2, 128)
    jg = side.graph.JobGraph(name="j")
    jg.vertices["v1"] = side.graph.JobVertex("v1", "op", 2, 128, [node])
    cp = side.storage.CompletedCheckpoint(
        1, 0.0,
        {"v1#0": {"chain": {}, inflight_key: [batch(side, [(1, 1)])]},
         "v1#1": {"chain": {}}},
        vertex_parallelism={"v1": old_par})
    return cp, jg


@pytest.mark.parametrize("key", ["inflight", "inflight1", "inflight2"])
def test_restore_map_keeps_inflight_and_refuses_a_rescale(key):
    def run(side):
        cp, jg = _checkpoint(side, 2, key)
        restore = side.coord.build_restore_map(cp, jg)
        kept = {t: [rows_of(b) for b in s.get(key, [])]
                for t, s in restore.items()}
        cp3, jg3 = _checkpoint(side, 3, key)   # old par 3 != new par 2
        with pytest.raises(ValueError, match="unaligned"):
            side.coord.build_restore_map(cp3, jg3)
        return kept

    assert both(run) == {"v1#0": [[(1, 1)]], "v1#1": []}


def test_coordinator_aborts_a_declined_checkpoint():
    class Task:
        def __init__(self):
            self.aborted, self.chain = [], self

        def execute_in_mailbox(self, fn):
            fn()

        def notify_checkpoint_aborted(self, cid):
            self.aborted.append(cid)

        def trigger_checkpoint(self, barrier):
            self.barrier = barrier

    job = types.SimpleNamespace(tasks={"a": Task(), "b": Task()},
                                job_graph=types.SimpleNamespace(
                                    edges=[], vertices={}))
    job.source_tasks = {"a": job.tasks["a"]}
    from flink_tpu_torch.core.config import Configuration
    coord = port_coord.CheckpointCoordinator(
        job, Configuration({"execution.checkpointing.unaligned": True}))
    p = coord.trigger_checkpoint()
    assert job.tasks["a"].barrier.unaligned
    job.decline_listener("b", p.checkpoint_id, "overtaken")
    assert p.done.is_set() and p.completed is None and p.declined
    assert [t.aborted for t in job.tasks.values()] == [[1], [1]]
    # a late ack of the aborted checkpoint aborts it again
    coord._on_ack("a", p.checkpoint_id, {})
    assert job.tasks["a"].aborted == [1, 1]
    assert coord.stats[-1]["declined"] and coord.stats[-1]["task"] == "b"


def test_unaligned_checkpoint_of_a_job_restores_every_row_once():
    """A fast and a paced source into one slow task with unaligned
    barriers: the checkpoint captures the fast source's queued batches;
    after a cancel and a restore, the rows the task handled before the
    snapshot and the rows of the restored run (the in-flight ones
    replayed first) are every input row exactly once."""
    from flink_tpu_torch.api import StreamExecutionEnvironment
    from flink_tpu_torch.core import Configuration

    n_fast, n_slow = 1 << 14, 1 << 12
    sch = port_rec.Schema([("k", np.int64), ("ts", np.int64)])

    def build(seen: list, delay: float):
        env = StreamExecutionEnvironment(Configuration({
            "pipeline.micro-batch-size": 64,
            "execution.checkpointing.unaligned": True,
            "execution.checkpointing.interval": 3600.0,
            "pipeline.operator-chaining": False}), device="cpu")
        fast = env.datagen(lambda idx: {"k": idx, "ts": idx}, sch,
                           count=n_fast, name="fast")
        slow = env.datagen(lambda idx: {"k": idx + n_fast, "ts": idx}, sch,
                           count=n_slow, rate_per_sec=4000.0, name="slow")

        def handle(b):
            time.sleep(delay)
            seen.extend(int(k) for k in b.column("k"))

        fast.union(slow).transform(
            "handle", lambda: port_simple.BatchFnOperator(handle, "handle")
        ).add_sink(lambda b: None)
        return env

    before: list = []
    job = build(before, 0.002).execute_async("unaligned-job")
    deadline = time.time() + 60
    while len(before) < 1024 and time.time() < deadline:
        time.sleep(0.005)
    p = job.coordinator.trigger_checkpoint()
    assert p.done.wait(60) and p.completed is not None
    job.cancel()
    snaps = p.completed.task_snapshots
    # the handling task's in-flight batches: the fast source's queued ones
    inflight = [b for t, s in snaps.items()
                if job.tasks[t].ctx.task_name.startswith("handle")
                for b in s.get("inflight", [])]
    assert inflight
    pre = set()
    for tid, s in snaps.items():
        if "reader" in s:
            offset = 0 if job.tasks[tid].ctx.task_name == "fast" else n_fast
            pre |= set(range(offset, offset + s["reader"]))
    captured = {int(k) for b in inflight for k in b.column("k")}
    after: list = []
    env2 = build(after, 0.0)
    env2.restore_from_checkpoint(p.completed)
    env2.execute("unaligned-restored", timeout=120)
    assert after[:len(captured)] and set(after[:len(captured)]) == captured
    assert len(after) == len(set(after))
    every = set(range(n_fast + n_slow))
    assert set(after) == every - (pre - captured)
