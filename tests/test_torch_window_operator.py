"""Port parity: the host WindowOperator of flink_tpu_torch
(``runtime/operators/window.py``, with ``window/triggers.py``,
``runtime/timers.py`` and the heap backend) against flink_tpu's.

Every case of the reference's tests/test_window_operator.py runs through
both packages' ``WindowOperator`` on the harness with the same elements,
watermarks and processing times: the emitted rows (with their
timestamps), the side outputs and the snapshot at the end are equal, and
the reference test's own expectation holds on the port. Beside them: the
grouped path of builtin aggregates, the continuous trigger and the time
evictor, a session's merging-window set and a cumulate window's
snapshots restored across the packages in both directions, CUMULATE and
a string-keyed TUMBLE through SQL, and a tiny WordCount (BASELINE config
#1's shape) through ``env.execute()``.

A window namespace crosses the packages as it is: the port's
``TimeWindow`` equals the reference's of the same bounds. Tolerance:
exact (integer aggregates).
"""

import types
from collections import Counter

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.api as ref_api  # noqa: E402
import flink_tpu.core as ref_core  # noqa: E402
import flink_tpu.sql as ref_sql  # noqa: E402
import flink_tpu.window as ref_window  # noqa: E402
from flink_tpu.core.functions import \
    AggregateFunction as RefAggregateFunction  # noqa: E402
from flink_tpu.runtime import OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.runtime.operators.window import \
    LATE_DATA_TAG as REF_LATE  # noqa: E402
from flink_tpu.runtime.operators.window import \
    WindowOperator as RefWindowOperator  # noqa: E402
import flink_tpu_torch.api as port_api  # noqa: E402
import flink_tpu_torch.core as port_core  # noqa: E402
import flink_tpu_torch.sql as port_sql  # noqa: E402
import flink_tpu_torch.window as port_window  # noqa: E402
from flink_tpu_torch.core.functions import AggregateFunction  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.runtime.operators.window import LATE_DATA_TAG, \
    WindowOperator  # noqa: E402


def _sum_agg(base):
    class SumAgg(base):
        def create_accumulator(self):
            return 0

        def add(self, value, acc):
            return acc + value[1]

        def merge(self, a, b):
            return a + b

        def get_result(self, acc):
            return acc
    return SumAgg


PKGS = {
    "ref": types.SimpleNamespace(
        core=ref_core, w=ref_window, Harness=RefHarness,
        Window=RefWindowOperator, LATE=REF_LATE,
        SumAgg=_sum_agg(RefAggregateFunction), api=ref_api, sql=ref_sql,
        env=lambda: ref_api.StreamExecutionEnvironment()),
    "port": types.SimpleNamespace(
        core=port_core, w=port_window, Harness=OneInputOperatorTestHarness,
        Window=WindowOperator, LATE=LATE_DATA_TAG,
        SumAgg=_sum_agg(AggregateFunction), api=port_api, sql=port_sql,
        env=lambda: port_api.StreamExecutionEnvironment(device="cpu")),
}


def _extract(batch):
    return np.array([r[0] for r in batch.iter_rows()], dtype=object)


def _harness(p, assigner, agg=True, **kw):
    op = p.Window(assigner, _extract,
                  aggregate=p.SumAgg() if agg else None, **kw)
    return p.Harness(op, schema=p.core.Schema([("k", object),
                                               ("v", np.int64)]))


def _observe(h, p) -> dict:
    return {"rows": h.get_output(),
            "ts": [int(t) for b in h.output.batches for t in b.timestamps],
            "late": h.get_side_output(p.LATE),
            "snapshot": h.snapshot()}


# -- the reference test's cases: (name) -> fn(p) -> (observed, expected) ---------

def c_fire_on_watermark(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10))
    h.process_elements([("a", 1), ("a", 2), ("b", 5)], [1, 5, 3])
    before = h.get_output()
    h.process_watermark(9)
    return _observe(h, p), (before == [] and sorted(h.get_output())
                            == [("a", 3), ("b", 5)])


def c_multiple_windows(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10))
    h.process_elements([("a", 1), ("a", 2)], [1, 15])
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 1), ("a", 2)]


def c_state_cleared_after_fire(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10))
    h.process_element(("a", 1), 1)
    h.process_watermark(9)
    h.clear_output()
    h.process_element(("a", 9), 2)
    h.process_watermark(30)
    return _observe(h, p), h.get_output() == []


def c_allowed_lateness_refires(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10), allowed_lateness=10)
    h.process_element(("a", 1), 1)
    h.process_watermark(9)
    ok = h.get_output() == [("a", 1)]
    h.clear_output()
    h.process_element(("a", 2), 5)
    ok &= h.get_output() == [("a", 3)]
    h.process_watermark(19)
    h.clear_output()
    h.process_element(("a", 7), 5)
    h.process_watermark(50)
    return _observe(h, p), ok and h.get_output() == []


def c_late_data_side_output(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10), emit_late_data=True)
    h.process_element(("a", 1), 1)
    h.process_watermark(20)
    h.process_element(("a", 9), 2)
    return _observe(h, p), h.get_side_output(p.LATE) == [("a", 9)]


def c_window_fn_with_bounds(p):
    def wf(key, window, result):
        yield (key, window.start, window.end, result)
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10), window_fn=wf)
    h.process_element(("a", 1), 12)
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 10, 20, 1)]


def c_output_timestamp_is_window_max(p):
    h = _harness(p, p.w.TumblingEventTimeWindows.of(10))
    h.process_element(("a", 1), 3)
    h.process_watermark(100)
    return _observe(h, p), list(h.output.batches[0].timestamps) == [9]


def c_sliding_each_element(p):
    h = _harness(p, p.w.SlidingEventTimeWindows.of(10, 5))
    h.process_element(("a", 1), 7)
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 1), ("a", 1)]


def c_sliding_sums(p):
    h = _harness(p, p.w.SlidingEventTimeWindows.of(10, 5))
    h.process_elements([("a", 1), ("a", 2), ("a", 4)], [2, 7, 12])
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 1), ("a", 3), ("a", 6),
                                              ("a", 4)]


def c_session_merge(p):
    h = _harness(p, p.w.EventTimeSessionWindows.with_gap(10))
    h.process_elements([("a", 1), ("a", 2)], [0, 5])
    h.process_element(("a", 4), 30)
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 3), ("a", 4)]


def c_session_bridge_merge(p):
    h = _harness(p, p.w.EventTimeSessionWindows.with_gap(10))
    h.process_element(("a", 1), 0)
    h.process_element(("a", 2), 18)
    h.process_element(("a", 4), 9)
    h.process_watermark(100)
    return _observe(h, p), h.get_output() == [("a", 7)]


def c_session_keys_do_not_merge(p):
    h = _harness(p, p.w.EventTimeSessionWindows.with_gap(10))
    h.process_elements([("a", 1), ("b", 2)], [0, 5])
    h.process_watermark(100)
    return _observe(h, p), sorted(h.get_output()) == [("a", 1), ("b", 2)]


def c_count_trigger_purging(p):
    h = _harness(p, p.w.GlobalWindows.create(),
                 trigger=p.w.PurgingTrigger.of(p.w.CountTrigger.of(2)))
    h.process_elements([("a", 1), ("a", 2)], [1, 2])
    ok = h.get_output() == [("a", 3)]
    h.clear_output()
    h.process_elements([("a", 5), ("a", 5)], [3, 4])
    return _observe(h, p), ok and h.get_output() == [("a", 10)]


def c_count_evictor(p):
    h = _harness(p, p.w.GlobalWindows.create(),
                 trigger=p.w.CountTrigger.of(3),
                 evictor=p.w.CountEvictor.of(2))
    h.process_elements([("a", 1), ("a", 2), ("a", 3)], [1, 2, 3])
    return _observe(h, p), h.get_output() == [("a", 5)]


def c_processing_time_window(p):
    h = _harness(p, p.w.TumblingProcessingTimeWindows.of(1000))
    h.set_processing_time(500)
    h.process_element(("a", 1))
    h.process_element(("a", 2))
    ok = h.get_output() == []
    h.set_processing_time(1000)
    return _observe(h, p), ok and h.get_output() == [("a", 3)]


def c_stale_processing_time_cleanup(p):
    h = _harness(p, p.w.ProcessingTimeSessionWindows.with_gap(200),
                 trigger=p.w.EventTimeTrigger())
    h.set_processing_time(0)
    h.process_element(("a", 1))
    h.set_processing_time(100)
    h.process_element(("a", 2))
    h.set_processing_time(250)
    h.process_watermark(1_000)
    return _observe(h, p), h.get_output() == [("a", 3)]


def c_continuous_trigger_time_evictor(p):
    """Beyond the reference test: a continuous event-time trigger on a
    list-state window with a time evictor."""
    def wf(key, window, elements):
        yield (key, window.start, sum(v for _k, v in elements))
    h = _harness(p, p.w.TumblingEventTimeWindows.of(100), agg=False,
                 window_fn=wf,
                 trigger=p.w.ContinuousEventTimeTrigger.of(25),
                 evictor=p.w.TimeEvictor.of(30))
    h.process_elements([("a", 1), ("a", 2), ("b", 4)], [3, 20, 40])
    h.process_watermark(30)
    h.process_elements([("a", 8), ("b", 16)], [55, 60])
    h.process_watermark(120)
    return _observe(h, p), len(h.get_output()) > 2


CASES = {k[2:]: v for k, v in globals().items() if k.startswith("c_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_operator_case_equals_reference(case):
    got = {side: CASES[case](p) for side, p in PKGS.items()}
    (ref_obs, ref_ok), (port_obs, port_ok) = got["ref"], got["port"]
    assert ref_ok and port_ok
    assert port_obs == ref_obs


def test_builtin_aggregates_take_the_grouped_path_as_the_reference():
    """sum/min/max/count over one column on the grouped path (one state
    access a (key, window) of a batch): rows and snapshots equal, in
    sliding windows with a late record on the side output."""
    rng = np.random.default_rng(21)
    keys = rng.integers(0, 40, 3000)
    vals = rng.integers(-50, 50, 3000)
    ts = np.sort(rng.integers(0, 4000, 3000))
    out = {}
    for side, p in PKGS.items():
        ds_mod = p.api.datastream
        res = []
        for kind in ("sum", "min", "max", "count"):
            agg = _builtin(ds_mod, kind)
            op = p.Window(p.w.SlidingEventTimeWindows.of(400, 100),
                          lambda b: b.column("k"), aggregate=agg,
                          emit_late_data=True)
            h = p.Harness(op, schema=p.core.Schema([("k", np.int64),
                                                    ("v", np.int64)]))
            for lo in range(0, 3000, 500):
                h.process_elements(list(zip(keys[lo:lo + 500].tolist(),
                                            vals[lo:lo + 500].tolist())),
                                   ts[lo:lo + 500].tolist())
                h.process_watermark(int(ts[lo + 499]) - 150)
            h.process_elements([(1, 1)], [0])
            h.process_watermark(10_000)
            res.append((sorted(h.get_output()), h.get_side_output(p.LATE),
                        h.snapshot()))
        out[side] = res
    assert out["port"] == out["ref"]
    assert out["port"][0][1] == [(1, 1)]


def _builtin(ds_mod, kind):
    """The host builtin aggregate each package's ``WindowedStream``
    hands its host WindowOperator for ``kind`` (caught at ``_build``)."""
    ws = ds_mod.WindowedStream(None, None)
    built = {}

    def capture(name, aggregate=None, **kw):
        built["agg"] = aggregate
    ws._build = capture
    ws._try_device_agg = lambda *a: None
    ws._builtin_agg(kind, None if kind == "count" else "v", "w")
    return built["agg"]


def _run_restore_pair(first, second, assigner_of, script_a, script_b):
    """Drive ``first``'s operator through script_a, snapshot, restore the
    snapshot into ``second``'s operator and drive script_b; the rows of
    both phases."""
    h = _harness(first, assigner_of(first))
    script_a(h)
    rows = h.get_output()
    snap = h.snapshot()
    h2 = second.Harness.restored(
        lambda: second.Window(assigner_of(second), _extract,
                              aggregate=second.SumAgg()),
        {"keyed": snap["keyed"]},
        schema=second.core.Schema([("k", object), ("v", np.int64)]))
    script_b(h2)
    return rows, h2.get_output(), snap, h2.snapshot()


@pytest.mark.parametrize("shape", ["tumbling", "session", "cumulate"])
def test_snapshots_restore_across_the_packages_both_ways(shape):
    """A snapshot taken by either package restores into the other and
    goes on as a restore into its own package does: the merging-window
    set of a session and the trigger state cross unchanged."""
    def assigner_of(p):
        return {"tumbling": p.w.TumblingEventTimeWindows.of(10),
                "session": p.w.EventTimeSessionWindows.with_gap(10),
                "cumulate": p.w.CumulateWindows.of(20, 5)}[shape]

    def script_a(h):
        h.process_elements([("a", 1), ("b", 2), ("a", 4)], [1, 2, 14])
        h.process_watermark(4)

    def script_b(h):
        h.process_elements([("a", 10), ("b", 3)], [3, 8])
        h.process_watermark(100)

    runs = {(a, b): _run_restore_pair(PKGS[a], PKGS[b], assigner_of,
                                      script_a, script_b)
            for a in PKGS for b in PKGS}
    same = runs[("ref", "ref")]
    for pair, got in runs.items():
        assert got[:2] == same[:2], pair
        assert got[2] == same[2] and got[3] == same[3], pair
    assert same[1]


CUMULATE_SQL = ("SELECT auction, window_start, window_end, COUNT(*) AS c, "
                "SUM(price) AS s FROM CUMULATE(TABLE bid, DESCRIPTOR(ts), "
                "INTERVAL '2' SECOND, INTERVAL '10' SECOND) "
                "GROUP BY auction, window_start, window_end")


def _bids(n=3000, auctions=64, seed=5):
    rng = np.random.default_rng(seed)
    return [(int(a), int(p), int(t)) for a, p, t in zip(
        rng.integers(0, auctions, n), rng.integers(1, 100, n),
        np.sort(rng.integers(0, 25_000, n)))]


def test_cumulate_and_host_windows_through_sql_equal_reference():
    """CUMULATE (the host WindowOperator in both packages) and a TUMBLE
    keyed by a string column (the host route): rows equal, and the
    cumulate windows equal a numpy count of the same bids."""
    bids = _bids()
    fields = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
    tumble = ("SELECT name, window_start, COUNT(*) AS c FROM TUMBLE("
              "TABLE bid2, DESCRIPTOR(ts), INTERVAL '5' SECOND) GROUP BY "
              "name, window_start, window_end")
    got = {}
    for side, p in PKGS.items():
        env = p.env()
        t_env = p.sql.TableEnvironment(env)
        ws = p.core.WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        schema = p.core.Schema(fields)
        t_env.create_temporary_view("bid", env.from_collection(
            bids, schema, timestamps=[b[2] for b in bids],
            watermark_strategy=ws), schema)
        schema2 = p.core.Schema([("name", object), ("ts", np.int64)])
        rows2 = [(f"n{a % 7}", t) for a, _p, t in bids]
        t_env.create_temporary_view("bid2", env.from_collection(
            rows2, schema2, timestamps=[r[1] for r in rows2],
            watermark_strategy=ws), schema2)
        got[side] = (sorted(t_env.execute_sql(CUMULATE_SQL).collect()),
                     sorted(t_env.execute_sql(tumble).collect()))
    assert got["port"] == got["ref"]
    a = np.array(bids)
    want = set()
    for start in range(0, 30_000, 10_000):
        for end in range(start + 2000, start + 10_001, 2000):
            sel = a[(a[:, 2] >= start) & (a[:, 2] < end)]
            for auc in np.unique(sel[:, 0]):
                m = sel[:, 0] == auc
                want.add((int(auc), start, end, float(m.sum()),
                          float(sel[m, 1].sum())))
    assert {tuple(float(x) if i >= 3 else int(x) for i, x in enumerate(r))
            for r in got["port"][0]} == want


def _words(idx, n, vocab, span):
    u = idx.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    words = np.array([f"word{i:04d}" for i in range(vocab)], dtype=object)
    return words[((u >> np.uint64(32)) % np.uint64(vocab)).astype(
        np.int64)], (idx * span) // n


def _wordcount(p, n=20_000, vocab=300, span=40_000, batch=4096):
    def gen(idx):
        word, ts = _words(idx, n, vocab, span)
        return {"word": word, "one": np.ones(len(idx), np.int64), "ts": ts}

    env = p.env()
    env.set_state_backend("hashmap")
    env.config.set("pipeline.micro-batch-size", batch)
    ws = p.core.WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    return sorted(env.datagen(gen, p.core.Schema(
        [("word", object), ("one", np.int64), ("ts", np.int64)]),
        count=n, timestamp_column="ts", watermark_strategy=ws)
        .key_by("word")
        .window(p.w.TumblingEventTimeWindows.of(5000))
        .sum("one")
        .execute_and_collect("wordcount"))


def test_wordcount_through_execute_equals_reference_and_a_counter():
    """BASELINE config #1's shape, small: words through the hashmap
    backend and the host WindowOperator; the rows of every window equal a
    Counter of the same words, and the reference's rows."""
    got = {side: _wordcount(p) for side, p in PKGS.items()}
    assert got["port"] == got["ref"]
    word, ts = _words(np.arange(20_000), 20_000, 300, 40_000)
    want = []
    for w in range(8):
        sel = (ts // 5000) == w
        want += list(Counter(word[sel].tolist()).items())
    assert got["port"] == sorted(want)


def test_windowed_stream_builders_through_execute_equal_reference():
    """The WindowedStream's builders through ``env.execute()``:
    ``trigger`` with ``evictor`` into ``apply``, ``allowed_lateness`` with
    ``aggregate``, and ``reduce`` with a window function, each the
    reference's rows (a watermark a batch, batches of 64)."""
    rows = [(int(k), int(v)) for k, v in zip(
        np.random.default_rng(3).integers(0, 6, 700),
        np.random.default_rng(4).integers(1, 50, 700))]
    ts = [i * 7 for i in range(700)]
    ts[100::97] = [t - 150 for t in ts[100::97]]     # some late records
    got = {}
    for side, p in PKGS.items():
        out = []
        for job in ("apply", "aggregate", "reduce"):
            env = p.env()
            env.set_state_backend("hashmap")
            env.config.set("pipeline.micro-batch-size", 64)
            env.config.set("pipeline.auto-watermark-interval", 0)
            ws = p.core.WatermarkStrategy.for_bounded_out_of_orderness(0)
            w = (env.from_collection(
                rows, p.core.Schema([("k", np.int64), ("v", np.int64)]),
                timestamps=ts, watermark_strategy=ws)
                .key_by("k").window(p.w.TumblingEventTimeWindows.of(300)))
            if job == "apply":
                s = (w.trigger(p.w.CountTrigger.of(5))
                     .evictor(p.w.CountEvictor.of(3))
                     .apply(lambda k, win, els: [(k, win.start, sum(
                         v for _k, v in els))]))
            elif job == "aggregate":
                s = w.allowed_lateness(200).aggregate(p.SumAgg())
            else:
                s = w.reduce(lambda a, b: (a[0], max(a[1], b[1])),
                             window_fn=lambda k, win, r: [(k, win.end, r[1])])
            out.append(sorted(s.execute_and_collect(job)))
        got[side] = out
    assert got["port"] == got["ref"]
    assert all(got["port"])
