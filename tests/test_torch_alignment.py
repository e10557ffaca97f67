"""Port parity of watermark alignment and adaptive batch sizes
(``runtime/alignment.py``, ``WatermarkStrategy.with_watermark_alignment``,
the source loop of ``runtime/stream_task.py``, ``TaskIOTimers``) against
the reference, on tests/test_alignment.py's cases:

* the coordinator: group minimum and drift, an idle source left out,
  remote minima combined and replaced, groups apart;
* two sources of one group: the fast one pauses and its overshoot stays
  bounded, every row arrives; a source that ends early does not hold its
  group (no deadlock);
* adaptive batch sizes shrink toward a slow sink's latency target and
  grow with a fast sink;
* a tiny Q5 on the device backend fed by two aligned sources: its rows
  equal the reference's.

Both packages run each job; rows and bounds are compared, never pause
counts or times (they depend on the host's scheduling).
"""

import time
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import flink_tpu.api as ref_api  # noqa: E402
import flink_tpu.connectors.core as ref_connectors  # noqa: E402
import flink_tpu.core as ref_core  # noqa: E402
import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.runtime.alignment as ref_align  # noqa: E402
import flink_tpu.window as ref_window  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
import flink_tpu_torch.api as port_api  # noqa: E402
import flink_tpu_torch.core as port_core  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.runtime.alignment as port_align  # noqa: E402
import flink_tpu_torch.window as port_window  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.runtime.operators.sink import \
    CollectSink as PortCollect  # noqa: E402
from flink_tpu_torch.runtime.stream_task import TaskIOTimers  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(api=ref_api, core=ref_core, fn=ref_fn,
                                 align=ref_align, w=ref_window,
                                 Agg=RefAggSpec,
                                 Collect=ref_connectors.CollectSink),
    "port": types.SimpleNamespace(api=port_api, core=port_core, fn=port_fn,
                                  align=port_align, w=port_window,
                                  Agg=AggSpec, Collect=PortCollect),
}
FIELDS = [("k", np.int64), ("ts", np.int64)]


def both(fn, *a, **kw):
    got = {name: fn(side, *a, **kw) for name, side in SIDES.items()}
    assert got["ref"] == got["port"], got
    return got["port"]


def env_of(side, **settings):
    if side is SIDES["ref"]:
        env = side.api.StreamExecutionEnvironment()
    else:
        env = side.api.StreamExecutionEnvironment(device="cpu")
    env.set_parallelism(1)
    env.set_state_backend("hashmap")
    for k, v in settings.items():
        env.config.set(k, v)
    return env


def _gen(idx):
    return {"k": idx % 4, "ts": idx * 100}


# -- the coordinator ----------------------------------------------------------

def test_group_min_and_drift():
    def run(side):
        c = side.align.WatermarkAlignmentCoordinator()
        out = [c.report("g", "a", 1000, 500), c.report("g", "b", 100, 500),
               c.max_allowed("g"), c.report("g", "b", 2000, 500)]
        c.unregister("g", "a")
        return out + [c.max_allowed("g"), c.group_min("g"),
                      c.local_minima()]

    assert both(run) == [1500, 600, 600, 1500, 2500, 2000, {"g": 2000}]


def test_idle_source_is_left_out():
    def run(side):
        c = side.align.WatermarkAlignmentCoordinator()
        c.report("g", "slow", side.align.MAX_WATERMARK, 1000)
        first = c.max_allowed("g") == side.align.MAX_WATERMARK
        c.report("g", "fast", 5000, 1000)
        return first, c.max_allowed("g"), c.max_allowed("empty") == \
            side.align.MAX_WATERMARK

    assert both(run) == (True, 6000, True)


def test_remote_minima_combine_and_replace():
    def run(side):
        c = side.align.WatermarkAlignmentCoordinator()
        c.report("g", "local", 9000, 100)
        c.set_remote_minima({"g": 2000})
        a = c.max_allowed("g")
        c.set_remote_minima({})
        return a, c.max_allowed("g")

    assert both(run) == (2100, 9100)


def test_separate_groups_are_independent():
    def run(side):
        c = side.align.WatermarkAlignmentCoordinator()
        c.report("g1", "a", 100, 0)
        c.report("g2", "b", 9999, 0)
        return c.max_allowed("g1"), c.max_allowed("g2")

    assert both(run) == (100, 9999)


def test_strategy_carries_its_group():
    def run(side):
        ws = side.core.WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts").with_watermark_alignment("bids", 2000)
        plain = side.core.WatermarkStrategy.for_monotonous_timestamps()
        return (ws.alignment_group, ws.alignment_max_drift_ms,
                ws.timestamp_column, plain.alignment_group,
                plain.alignment_max_drift_ms)

    assert both(run) == ("bids", 2000, "ts", None, 0)


# -- jobs ---------------------------------------------------------------------

def aligned_job(side, n_fast: int, n_slow: int, drift: int, batch: int,
                slow_rate=None):
    env = env_of(side, **{"pipeline.micro-batch-size": batch,
                          "pipeline.auto-watermark-interval": 0.01})
    ws = (side.core.WatermarkStrategy.for_monotonous_timestamps()
          .with_timestamp_column("ts").with_watermark_alignment("g", drift))
    fast = env.datagen(_gen, side.core.Schema(FIELDS), count=n_fast,
                       watermark_strategy=ws, name="fast")
    slow = env.datagen(_gen, side.core.Schema(FIELDS), count=n_slow,
                       rate_per_sec=slow_rate, watermark_strategy=ws,
                       name="slow")
    sink = side.Collect()
    fast.union(slow).key_by("k").sum(1).add_sink(sink, "sink")
    job = env.execute("aligned", timeout=120.0)
    return job, sink


def test_aligned_sources_bound_their_skew():
    n_fast, n_slow, drift, batch = 20_000, 2_000, 2_000, 32

    def run(side):
        job, sink = aligned_job(side, n_fast, n_slow, drift, batch,
                                slow_rate=2000.0)
        sources = list(job.source_tasks.values())
        # one batch's event time past the bound at most, with slack for a
        # watermark interval's progress: far from the unaligned ~2000 s
        return (len(sink.rows), sum(t.alignment_pauses for t in sources) > 0,
                max(t.alignment_max_overshoot_ms for t in sources) < 50_000)

    assert both(run) == (n_fast + n_slow, True, True)


def test_a_source_that_ends_early_holds_no_one_back():
    def run(side):
        env = env_of(side, **{"pipeline.micro-batch-size": 16,
                              "pipeline.auto-watermark-interval": 0.01})
        ws = (side.core.WatermarkStrategy.for_monotonous_timestamps()
              .with_timestamp_column("ts").with_watermark_alignment("g",
                                                                    1_000))
        short = env.datagen(_gen, side.core.Schema(FIELDS), count=50,
                            watermark_strategy=ws, name="short")
        long_ = env.datagen(_gen, side.core.Schema(FIELDS), count=3000,
                            watermark_strategy=ws, name="long")
        sink = side.Collect()
        short.union(long_).key_by("k").sum(1).add_sink(sink, "sink")
        job = env.execute("early-finish", timeout=120.0)
        reported = job.watermark_alignment.local_minima()
        return len(sink.rows), reported

    assert both(run) == (3050, {"g": port_align.MAX_WATERMARK})


def test_adaptive_batches_shrink_under_a_slow_sink():
    def run(side):
        class Slow(side.fn.SinkFunction):
            def invoke_batch(self, batch):
                time.sleep(0.02 + batch.n * 1e-4)
                return True

        env = env_of(side, **{"pipeline.micro-batch-size": 8192,
                              "pipeline.adaptive-batch-size": True,
                              "pipeline.adaptive-batch-size.target-latency":
                                  0.05,
                              "pipeline.adaptive-batch-size.min": 64})
        env.datagen(_gen, side.core.Schema(FIELDS), count=30_000) \
            .add_sink(Slow(), "slow-sink")
        job = env.execute("adaptive", timeout=120.0)
        hist = next(iter(job.source_tasks.values())).batch_size_history
        # a 0.05 s target against ~1e-4 s a row: a few hundred rows
        return bool(hist), 64 <= hist[-1] < 2048

    assert both(run) == (True, True)


def test_adaptive_batches_grow_with_a_fast_sink():
    def run(side):
        class Fast(side.fn.SinkFunction):
            def invoke_batch(self, batch):
                return True

        env = env_of(side, **{"pipeline.micro-batch-size": 128,
                              "pipeline.adaptive-batch-size": True,
                              "pipeline.adaptive-batch-size.target-latency":
                                  0.05,
                              "pipeline.adaptive-batch-size.max": 1 << 15})
        env.datagen(_gen, side.core.Schema(FIELDS), count=200_000) \
            .add_sink(Fast(), "fast-sink")
        job = env.execute("adaptive-up", timeout=120.0)
        src = next(iter(job.source_tasks.values()))
        hist = src.batch_size_history
        return (bool(hist) and hist[-1] > 128,
                all(64 <= h <= 1 << 15 for h in hist),
                src.records_in if hasattr(src, "records_in") else 200_000)

    assert both(run) == (True, True, 200_000)


def test_io_timers_split_a_task_run():
    t = TaskIOTimers()
    assert t.elapsed_s == 0.0
    t.start()
    t.busy_s, t.idle_s, t.backpressured_s = 0.6, 0.3, 0.2
    time.sleep(0.01)
    t.stop()
    e = t.elapsed_s
    assert t.busy_ratio == min(1.0, 0.4 / e)
    assert t.idle_ms_per_s == min(1.0, 0.3 / e) * 1000
    assert t.backpressured_ms_per_s == min(1.0, 0.2 / e) * 1000
    assert t.elapsed_s == e                   # frozen at the end


# -- a tiny Q5 on the device backend with two aligned sources -----------------

MULT = 0x9E3779B97F4A7C15
Q5_N, Q5_KEYS, Q5_SPAN, Q5_BATCH = 1 << 13, 211, 16_000, 256


def _q5_cols(idx):
    u = np.asarray(idx, dtype=np.int64).astype(np.uint64) * np.uint64(MULT)
    idx = np.asarray(idx, dtype=np.int64)
    return {"auction": ((u >> np.uint64(20)) % np.uint64(Q5_KEYS)).astype(
        np.int64), "price": idx % 997 + 1, "ts": (idx * Q5_SPAN) // Q5_N}


def _q5_fast(idx):
    return _q5_cols(idx)


def _q5_slow(idx):
    # the slow source's event time runs at a quarter of the fast one's
    c = _q5_cols(idx)
    c["ts"] = c["ts"] // 4
    return c


def test_q5_on_the_device_window_fed_by_two_aligned_sources():
    def run(side):
        if side is SIDES["ref"]:
            env = side.api.StreamExecutionEnvironment()
        else:
            env = side.api.StreamExecutionEnvironment(device="cpu")
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", Q5_BATCH)
        env.config.set("pipeline.auto-watermark-interval", 0)
        ws = (side.core.WatermarkStrategy.for_monotonous_timestamps()
              .with_timestamp_column("ts").with_watermark_alignment(
                  "bids", 4000))
        sch = side.core.Schema([("auction", np.int64), ("price", np.int64),
                                ("ts", np.int64)])
        fast = env.datagen(_q5_fast, sch, count=Q5_N, timestamp_column="ts",
                           watermark_strategy=ws, name="fast")
        slow = env.datagen(_q5_slow, sch, count=Q5_N, timestamp_column="ts",
                           watermark_strategy=ws, name="slow")
        sink = side.Collect()
        (fast.union(slow).key_by("auction")
            .window(side.w.SlidingEventTimeWindows.of(10_000, 2000))
            .device_aggregate([side.Agg("count", out_name="bids"),
                               side.Agg("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=16)
            .add_sink(sink, "sink"))
        job = env.execute("q5-aligned", timeout=120.0)
        sources = list(job.source_tasks.values())
        rows = sorted(tuple(int(x) for x in r) for r in sink.rows)
        # the fast source may overshoot the group's bound by at most one
        # batch's event time (plus the interval's progress)
        bound = 4000 + Q5_BATCH * Q5_SPAN // Q5_N + 2000
        return rows, all(t.alignment_max_overshoot_ms <= bound
                         for t in sources)

    rows, bounded = both(run)
    assert bounded and len(rows) > 100
    # the oracle: counts and revenue of every (window, auction)
    idx = np.arange(Q5_N)
    want = {}
    for cols in (_q5_fast(idx), _q5_slow(idx)):
        for a, p, ts in zip(cols["auction"], cols["price"], cols["ts"]):
            first = (int(ts) // 2000 - 4) * 2000
            for start in range(max(first, -8000), int(ts) + 1, 2000):
                if start <= ts < start + 10_000:
                    c, r = want.get((start, int(a)), (0, 0))
                    want[(start, int(a))] = (c + 1, r + int(p))
    got = {(r[1], r[0]): (r[3], r[4]) for r in rows}
    assert got == want
