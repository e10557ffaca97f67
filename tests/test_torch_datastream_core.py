"""Port parity: the DataStream core of flink_tpu_torch against flink_tpu's
(``core/functions.py``, ``runtime/operators/simple.py``,
``runtime/timers.py``, the partitioners of ``runtime/writer.py``, side
outputs and processing time in the tasks, ``api/datastream.py``).

Each job runs through ``env.execute()`` in both packages on the same
seeded numpy input and gives the same rows:

* ``map``, ``filter`` and ``flat_map``, vectorized and as row loops; the
  port's vectorized map and filter also on device batches (torch ops on
  the batch's device, the filter compacting in batch order), held to the
  reference's host rows in order;
* ``union`` and every partitioner into a map at parallelism 2 (rows as
  multisets; each partitioner's routing of one batch equal too);
* a keyed process function with ``ValueState`` and an event-time timer a
  key, on the device backend and on ``hashmap``, with a side output read
  back through ``get_side_output``; the rolling ``reduce``;
  ``count_window``; a window's ``late-data`` side output;
* event- and processing-time timers on the harness (a manual clock),
  with the operator's snapshot equal to the reference's and restored
  across the packages;
* the fusion certificate of a map -> filter -> window job;
* a WordCount and a KeyedProcessFunction job in a subprocess that cannot
  import jax or flink_tpu.

Tolerance: exact (integer values; the device backend's value plane is
float64, read back as integers).
"""

import pathlib
import subprocess
import sys
import types
from collections import Counter

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import flink_tpu.api as ref_api  # noqa: E402
import flink_tpu.connectors.core as ref_connectors  # noqa: E402
import flink_tpu.core as ref_core  # noqa: E402
import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.core.records as ref_records  # noqa: E402
import flink_tpu.graph.fusion as ref_fusion  # noqa: E402
import flink_tpu.graph.stream_graph as ref_graph  # noqa: E402
import flink_tpu.runtime.writer as ref_writer  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
import flink_tpu.window as ref_window  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.runtime.operators.simple import \
    KeyedProcessOperator as RefKeyedProcess  # noqa: E402
import flink_tpu_torch.api as port_api  # noqa: E402
import flink_tpu_torch.connectors.core as port_connectors  # noqa: E402
import flink_tpu_torch.core as port_core  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.core.records as port_records  # noqa: E402
import flink_tpu_torch.graph.fusion as port_fusion  # noqa: E402
import flink_tpu_torch.graph.stream_graph as port_graph  # noqa: E402
import flink_tpu_torch.runtime.writer as port_writer  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
import flink_tpu_torch.window as port_window  # noqa: E402
from flink_tpu_torch.core.device_records import DeviceRecordBatch  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.runtime.operators.simple import \
    KeyedProcessOperator  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
MULT = 0x9E3779B97F4A7C15
N, KEYS, SPAN, BATCH = 6000, 97, 12_000, 512
#: records of the process-function jobs (the device backend's plain row
#: plane reads and writes its whole table a call on the CPU)
N_PROCESS = 1500
FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]

PKGS = {
    "ref": types.SimpleNamespace(
        api=ref_api, core=ref_core, fn=ref_fn, rec=ref_records,
        w=ref_window, desc=ref_desc, writer=ref_writer, graph=ref_graph,
        fusion=ref_fusion, Harness=RefHarness, KP=RefKeyedProcess,
        Agg=RefAggSpec, Collect=ref_connectors.CollectSink),
    "port": types.SimpleNamespace(
        api=port_api, core=port_core, fn=port_fn, rec=port_records,
        w=port_window, desc=port_desc, writer=port_writer, graph=port_graph,
        fusion=port_fusion, Harness=OneInputOperatorTestHarness,
        KP=KeyedProcessOperator, Agg=AggSpec,
        Collect=port_connectors.CollectSink),
}


def _cols(idx: np.ndarray) -> dict:
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": ((u >> np.uint64(20)) % np.uint64(KEYS)).astype(
        np.int64), "price": (idx % 997) + 1, "ts": (idx * SPAN) // N}


def _torch_gen(idx: torch.Tensor) -> dict:
    """The same columns as ``_cols``, as torch ops on idx's device."""
    out = _cols(idx.cpu().numpy())
    return {k: torch.from_numpy(v).to(idx.device) for k, v in out.items()}


def _env(side: str, backend: str = "tpu", **settings):
    p = PKGS[side]
    if side == "ref":
        env = p.api.StreamExecutionEnvironment()
    else:
        env = p.api.StreamExecutionEnvironment(device="cpu")
    env.set_state_backend(backend)
    env.config.set("pipeline.micro-batch-size", BATCH)
    env.config.set("pipeline.auto-watermark-interval", 0)
    for k, v in settings.items():
        env.config.set(k, v)
    return env


def _source(side: str, env, device: bool = False, n: int = N):
    p = PKGS[side]
    ws = p.core.WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    gen = _torch_gen if device else _cols
    return env.datagen(gen, p.core.Schema(FIELDS), count=n,
                       timestamp_column="ts", watermark_strategy=ws,
                       device=device)


# -- functions of both packages ------------------------------------------------

def _functions(p):
    class Q1Map(p.fn.MapFunction):
        """Nexmark Q1's shape: the price times 0.908, as a batch op."""

        def map(self, row):
            return (row[0], row[1] * 908 // 1000, row[2])

        def map_batch(self, batch):
            if getattr(batch, "is_device", False):
                cols = dict(batch.dcolumns)
                cols["price"] = cols["price"] * 908 // 1000
                return DeviceRecordBatch(batch.schema, cols,
                                         batch.dtimestamps, batch.ts_min,
                                         batch.ts_max, batch.ts_column)
            cols = dict(batch.columns)
            cols["price"] = cols["price"] * 908 // 1000
            return p.rec.RecordBatch(batch.schema, cols, batch.timestamps)

    class Q2Filter(p.fn.FilterFunction):
        """Nexmark Q2's shape: auction % 7 == 3, as a batch mask."""

        def filter(self, row):
            return row[0] % 7 == 3

        def filter_batch(self, batch):
            if getattr(batch, "is_device", False):
                return batch.device_column("auction") % 7 == 3
            return batch.column("auction") % 7 == 3

    class RowMap(p.fn.MapFunction):
        def map(self, row):
            return (row[0], row[1] * 908 // 1000, row[2])

    class RowFilter(p.fn.FilterFunction):
        def filter(self, row):
            return row[0] % 7 == 3

    class CountWithTimer(p.fn.ProcessFunction):
        """A count a key in ValueState; the first record of a key sets an
        event-time timer 1000 ms on, which emits (key, count), clears
        the count and sends odd counts to a side output."""

        def open(self, ctx):
            self._ctx = ctx
            self._desc = p.desc.ValueStateDescriptor("count", default=0)

        def process_element(self, value, ctx, out):
            st = self._ctx.get_state(self._desc)
            c = int(st.value())
            if c == 0:
                ctx.timer_service.register_event_time_timer(
                    ctx.timestamp + 1000)
            st.update(c + 1)

        def on_timer(self, ts, ctx, out):
            st = self._ctx.get_state(self._desc)
            c = int(st.value())
            out.collect((ctx.current_key, c, ts), ts)
            if c % 2:
                ctx.output("odd", (ctx.current_key, c))
            st.clear()

    return types.SimpleNamespace(Q1Map=Q1Map, Q2Filter=Q2Filter,
                                 RowMap=RowMap, RowFilter=RowFilter,
                                 CountWithTimer=CountWithTimer)


FNS = {side: _functions(p) for side, p in PKGS.items()}


def _expected_q1_q2() -> list:
    c = _cols(np.arange(N))
    keep = c["auction"] % 7 == 3
    return list(zip(c["auction"][keep].tolist(),
                    (c["price"][keep] * 908 // 1000).tolist(),
                    c["ts"][keep].tolist()))


@pytest.mark.parametrize("form", ["vectorized", "row_loop", "device"])
def test_map_and_filter_equal_reference(form):
    """Q1 (map) then Q2 (filter): in order, the reference's rows, each
    form; the device form keeps the batches on the device."""
    got = {}
    for side in PKGS:
        f = FNS[side]
        env = _env(side)
        device = form == "device" and side == "port"
        mf, ff = ((f.RowMap(), f.RowFilter()) if form == "row_loop"
                  else (f.Q1Map(), f.Q2Filter()))
        seen = []
        s = _source(side, env, device=device).map(mf).filter(ff)
        if device:
            s = s.map(_Note(seen))
        got[side] = s.execute_and_collect("q1q2")
        if device:
            assert seen and all(seen)
    assert got["port"] == got["ref"] == _expected_q1_q2()


class _Note(port_fn.MapFunction):
    """Notes whether each batch it sees is a device batch not copied
    home, and passes it on."""

    def __init__(self, seen: list):
        self._seen = seen

    def map_batch(self, batch):
        self._seen.append(isinstance(batch, DeviceRecordBatch)
                          and batch._host is None)
        return batch


def test_flat_map_and_a_row_map_into_a_sink_function_equal_reference():
    """flat_map and a row map to a new schema, into a SinkFunction whose
    batch path declines (a call a row, with the row's timestamp)."""
    got = {}
    for side, p in PKGS.items():
        class Rows(p.fn.SinkFunction):
            def __init__(self):
                self.rows = []

            def invoke(self, value, timestamp=None):
                self.rows.append((value, timestamp))

        sink = Rows()
        env = _env(side)
        (_source(side, env, n=600)
         .flat_map(lambda r: [(r[0], i) for i in range(r[1] % 3)])
         .map(lambda r: (r[0] * 10 + r[1], r[1]))
         .add_sink(sink, "rows"))
        env.execute("flat")
        got[side] = sink.rows
    assert got["port"] == got["ref"]
    c = _cols(np.arange(600))
    assert len(got["port"]) == int((c["price"] % 3).sum())


@pytest.mark.parametrize("route", ["rebalance", "rescale", "shuffle",
                                   "broadcast", "forward", "global",
                                   "custom", "union"])
def test_partitioners_and_union_at_parallelism_2_equal_reference(route):
    got = {}
    for side, p in PKGS.items():
        env = _env(side)
        env.set_parallelism(2)
        s = _source(side, env, n=2000)
        if route == "union":
            s = s.union(_source(side, env, n=700))
        elif route == "custom":
            s = s.partition_custom(lambda k, n: k % n, "auction")
        else:
            s = getattr(s, route + ("_" if route == "global" else ""))()
        got[side] = Counter(s.map(lambda r: (r[0], r[1] + 1))
                            .execute_and_collect(route))
    assert got["port"] == got["ref"]
    assert sum(got["port"].values()) == {"broadcast": 4000,
                                         "union": 2700}.get(route, 2000)


def test_each_partitioner_routes_a_batch_as_the_reference():
    c = _cols(np.arange(300))
    rows = list(zip(*(c[k].tolist() for k, _ in FIELDS)))
    routed = {}
    for side, p in PKGS.items():
        batch = p.rec.RecordBatch.from_rows(p.core.Schema(FIELDS), rows)
        w = p.writer
        parts = [w.ForwardPartitioner(), w.RebalancePartitioner(),
                 w.RescalePartitioner(), w.BroadcastPartitioner(),
                 w.GlobalPartitioner(), w.ShufflePartitioner(seed=3),
                 w.CustomPartitioner(lambda k, n: (k * 7) % n,
                                     lambda b: b.column("auction"))]
        out = []
        for part in parts:
            for _rep in range(3):
                out.append([(ch, list(b.iter_rows()))
                            for ch, b in part.route(batch, 3, 1)])
            out.append(part.name)
        routed[side] = out
    assert routed["port"] == routed["ref"]


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_keyed_process_with_value_state_and_timers_equals_reference(backend):
    """The reference runs hashmap; the port runs the named backend (tpu:
    the device row plane, here on the CPU). Rows, and the side output
    read through get_side_output."""
    got = {}
    for side, p in PKGS.items():
        env = _env(side, "hashmap" if side == "ref" else backend)
        main = (_source(side, env, n=N_PROCESS).key_by("auction")
                .process(FNS[side].CountWithTimer()))
        odd = p.Collect()
        main.get_side_output("odd").add_sink(odd, "odd")
        got[side] = (sorted(main.execute_and_collect("kp")),
                     sorted(odd.rows))
    assert got["port"] == got["ref"]
    # every record counted once; the end of input fires every timer
    assert sum(n for _k, n, _t in got["port"][0]) == N_PROCESS
    assert got["port"][1] == sorted((k, n) for k, n, _t in got["port"][0]
                                    if n % 2)


def test_rolling_reduce_count_window_and_late_side_output_equal_reference():
    got = {}
    for side, p in PKGS.items():
        env = _env(side, "hashmap")
        rolling = (_source(side, env, n=1500).key_by("auction")
                   .reduce(lambda a, b: (a[0], a[1] + b[1], b[2]))
                   .execute_and_collect("rolling"))
        env = _env(side, "hashmap")
        counted = (_source(side, env, n=1500)
                   .map(lambda r: (r[0] % 5, r[1]))
                   .key_by(lambda r: r[0]).count_window(4)
                   .reduce(lambda a, b: (a[0], a[1] + b[1]))
                   .execute_and_collect("count_window"))
        env = _env(side, "hashmap")
        rows = [(1, 5), (2, 6), (1, 7), (3, 1), (1, 2)]
        ts = [100, 400, 700, 50, 900]
        ws = p.core.WatermarkStrategy.for_bounded_out_of_orderness(0)
        win = (env.from_collection(rows, p.core.Schema(
            [("k", np.int64), ("v", np.int64)]), timestamps=ts,
            watermark_strategy=ws)
            .key_by("k").window(p.w.TumblingEventTimeWindows.of(300))
            .side_output_late_data().sum("v"))
        late = p.Collect()
        win.get_side_output("late-data").add_sink(late, "late")
        got[side] = (rolling, [(k, _as_tuple(v)) for k, v in counted],
                     sorted(win.execute_and_collect("w")), late.rows)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 1500 and got["port"][1]


def _as_tuple(v):
    """The reference builds an object column of equal-length tuples with
    ``np.array(values, dtype=object)``, a 2-D array, so its row holds an
    array where the port's holds the tuple: the same values."""
    return tuple(v.tolist()) if isinstance(v, np.ndarray) else v


def _timer_harness(p, backend: str):
    class Timers(p.fn.ProcessFunction):
        def open(self, ctx):
            self._ctx = ctx
            self._desc = p.desc.ValueStateDescriptor("n", default=0)

        def process_element(self, value, ctx, out):
            st = self._ctx.get_state(self._desc)
            st.update(int(st.value()) + value[1])
            ctx.timer_service.register_event_time_timer(value[2] + 10)
            ctx.timer_service.register_processing_time_timer(
                value[1] * 100)
            if value[1] == 3:
                ctx.timer_service.delete_event_time_timer(value[2] + 10)

        def on_timer(self, ts, ctx, out):
            st = self._ctx.get_state(self._desc)
            out.collect((ctx.current_key, ctx.time_domain, ts,
                         int(st.value())), ts)

    config = p.core.Configuration()
    config.set("state.backend.type", backend)
    kw = {"device": "cpu"} if p is PKGS["port"] else {}
    op = p.KP(Timers(), lambda b: b.column("k"), **kw)
    return p.Harness(op, schema=p.core.Schema(
        [("k", np.int64), ("v", np.int64), ("t", np.int64)]), config=config)


def _timer_script(h):
    h.set_processing_time(0)
    h.process_elements([(1, 1, 5), (2, 3, 7), (1, 2, 20)], [5, 7, 20])
    h.process_watermark(16)
    h.set_processing_time(150)
    snap = h.snapshot()
    h.process_elements([(3, 4, 30)], [30])
    h.process_watermark(100)
    h.set_processing_time(1000)
    return snap


@pytest.mark.parametrize("backend", ["tpu", "hashmap"])
def test_event_and_processing_time_timers_equal_reference(backend):
    """On the harness with a manual clock: both timer domains, a deleted
    timer, the rows; on hashmap the snapshots are equal, and each
    package's snapshot restores into the other."""
    got, snaps = {}, {}
    for side, p in PKGS.items():
        h = _timer_harness(p, backend if side == "port" else "hashmap")
        snaps[side] = _timer_script(h)
        got[side] = (h.get_output(), h.get_watermarks())
    assert got["port"] == got["ref"]
    assert snaps["port"]["keyed"]["timers"] == snaps["ref"]["keyed"]["timers"]
    if backend == "hashmap":
        assert snaps["port"] == snaps["ref"]
        for src, dst in (("ref", "port"), ("port", "ref")):
            p = PKGS[dst]
            h = _timer_harness(p, "hashmap")
            h.open([snaps[src]["keyed"]])
            h.set_processing_time(150)
            h.process_elements([(3, 4, 30)], [30])
            h.process_watermark(100)
            h.set_processing_time(1000)
            home = _timer_harness(PKGS[src], "hashmap")
            home.open([snaps[src]["keyed"]])
            home.set_processing_time(150)
            home.process_elements([(3, 4, 30)], [30])
            home.process_watermark(100)
            home.set_processing_time(1000)
            assert h.get_output() == home.get_output()


def _cert_shape(cert, jg):
    names = {n.id: n.name for v in jg.vertices.values()
             for n in v.chained_nodes}
    return sorted(
        (c.name, c.parallelism, c.verdict, tuple(o.category for o in c.ops),
         tuple(tuple(names[i] for i in run) for run in c.certified),
         tuple(names[i] for i in c.lowered_prefix),
         tuple(f.rule for f in c.findings),
         tuple(f.symbol.split(":", 1)[1] for f in c.findings))
        for c in cert.chains)


@pytest.mark.parametrize("shape", ["vectorized_device_window",
                                   "row_loop_host_window"])
def test_fusion_certificate_of_map_filter_window_equals_reference(shape):
    shapes = []
    for side, p in PKGS.items():
        vec = shape.startswith("vectorized")
        # the host window: the hashmap backend takes sum() off the device
        env = _env(side, "tpu" if vec else "hashmap",
                   **{"pipeline.fusion.enabled": True})
        f = FNS[side]
        s = (_source(side, env, device=True)
             .map(f.Q1Map() if vec else f.RowMap())
             .filter(f.Q2Filter() if vec else f.RowFilter())
             .key_by("auction"))
        if vec:
            s = (s.window(p.w.SlidingEventTimeWindows.of(2000, 1000))
                 .device_aggregate([p.Agg("count", out_name="bids")],
                                   capacity=1 << 10, ring_size=32))
        else:
            s = s.window(p.w.TumblingEventTimeWindows.of(1000)).sum("price")
        s.add_sink(p.Collect(), "Sink")
        sg = p.graph.build_stream_graph(env._sinks, env.config)
        jg = p.graph.build_job_graph(sg, env.config, "job")
        saved = list(p.fusion.CERTIFICATE_LOG)
        cert = p.fusion.certify(sg, jg, env.config)
        p.fusion.CERTIFICATE_LOG.clear()
        p.fusion.CERTIFICATE_LOG.extend(saved)
        shapes.append(_cert_shape(cert, jg))
    assert shapes[1] == shapes[0]
    cats = [c for chain in shapes[0] for c in chain[3]]
    assert cats[1:4] == (["pure", "pure", "window-device"]
                         if shape.startswith("vec")
                         else ["serializer", "serializer", "timer"])


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
from collections import Counter
import numpy as np
from flink_tpu_torch.api import StreamExecutionEnvironment
from flink_tpu_torch.core import Schema, WatermarkStrategy
from flink_tpu_torch.core.functions import ProcessFunction
from flink_tpu_torch.state.descriptors import ValueStateDescriptor
from flink_tpu_torch.window import TumblingEventTimeWindows

words = np.array(["w%d" % i for i in range(50)], dtype=object)
n = 4000
def gen(idx):
    return {{"word": words[idx % 50], "one": np.ones(len(idx), np.int64),
             "ts": idx * 10}}
ws = WatermarkStrategy.for_monotonous_timestamps().with_timestamp_column("ts")
env = StreamExecutionEnvironment(device="cpu").set_state_backend("hashmap")
env.config.set("pipeline.micro-batch-size", 512)
rows = (env.datagen(gen, Schema([("word", object), ("one", np.int64),
                                 ("ts", np.int64)]), count=n,
                    timestamp_column="ts", watermark_strategy=ws)
        .key_by("word").window(TumblingEventTimeWindows.of(5000))
        .sum("one").execute_and_collect("wc"))
want = Counter()
for i in range(n):
    want[(str(words[i % 50]), i * 10 // 5000)] += 1
assert sorted(c for _w, c in rows) == sorted(want.values()), rows[:5]

class Count(ProcessFunction):
    def open(self, ctx):
        self._ctx = ctx
        self._d = ValueStateDescriptor("c", default=0)
    def process_element(self, v, ctx, out):
        st = self._ctx.get_state(self._d)
        if int(st.value()) == 0:
            ctx.timer_service.register_event_time_timer(ctx.timestamp + 500)
        st.update(int(st.value()) + 1)
    def on_timer(self, ts, ctx, out):
        st = self._ctx.get_state(self._d)
        out.collect((ctx.current_key, int(st.value())), ts)
        st.clear()

env = StreamExecutionEnvironment(device="cpu")
env.config.set("pipeline.micro-batch-size", 512)
def gen2(idx):
    return {{"k": idx % 13, "ts": idx * 3}}
rows = (env.datagen(gen2, Schema([("k", np.int64), ("ts", np.int64)]),
                    count=600, timestamp_column="ts", watermark_strategy=ws)
        .key_by("k").process(Count()).execute_and_collect("kp"))
assert sum(c for _k, c in rows) == 600, rows[:5]
assert "jax" not in sys.modules or sys.modules["jax"] is None
print("OK", len(rows))
"""


def test_wordcount_and_keyed_process_run_with_jax_and_flink_tpu_blocked():
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")
