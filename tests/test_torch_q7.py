"""Port parity: Nexmark Q7 (the highest bid of each tumbling window) as
bench.py runs it: ``max(packed = (price << 20) | bidder, value_bits=34)``,
top 1, with window bounds, through the port's
``StreamExecutionEnvironment(device="cpu")`` (chip_smoke.py's ``run_q7``)
against the reference pipeline and the smoke's numpy oracle, in both fire
modes, at a tiny size. The winner of each window is unique, so rows are
compared exactly; the port's column dtypes are the reference's (int64)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.core import WatermarkStrategy as RefWS  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.window import TumblingEventTimeWindows as RefTumbling  # noqa: E402
from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches  # noqa: E402
from flink_tpu_torch.metrics import DEVICE_STATS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_KEYS, N_EVENTS, CAPACITY, BATCH = 500, 1 << 14, 1 << 10, 1 << 10
MULT = 0x9E3779B97F4A7C15


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _smoke()
SPAN = CS.q5_panes(N_EVENTS, BATCH) * CS.Q7_PANE_MS


def _numpy_gen(idx):
    """bench.py _run_q7's generator."""
    u = idx.astype(np.uint64)
    auction = ((u * np.uint64(MULT)) % np.uint64(N_KEYS)).astype(np.int64)
    price = (idx % 9973) + 1
    bidder = idx % (1 << 20)
    return {"auction": auction, "packed": (price << 20) | bidder,
            "ts": (idx * SPAN) // N_EVENTS}


@pytest.fixture(scope="module")
def reference_rows():
    """{fire mode: rows} of the reference pipeline."""
    out = {}
    for mode in ("full", "incremental"):
        env = RefEnv()
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", BATCH)
        env.config.set("window.fire.incremental", mode == "incremental")
        ws = RefWS.for_monotonous_timestamps().with_timestamp_column("ts")
        schema = RefSchema([("auction", np.int64), ("packed", np.int64),
                            ("ts", np.int64)])
        out[mode] = (env.datagen(_numpy_gen, schema, count=N_EVENTS,
                                 timestamp_column="ts",
                                 watermark_strategy=ws)
                     .key_by("auction")
                     .window(RefTumbling.of(CS.Q7_PANE_MS))
                     .device_aggregate([RefAggSpec("max", "packed",
                                                   out_name="best",
                                                   value_bits=34)],
                                       capacity=CAPACITY, ring_size=CS.RING,
                                       emit_window_bounds=True, emit_topk=1,
                                       defer_overflow=True, async_fire=True)
                     .execute_and_collect())
    return out


@pytest.mark.parametrize("mode", ["full", "incremental"])
def test_tiny_q7_matches_reference_and_oracle(mode, reference_rows):
    before = DEVICE_STATS.snapshot()["panes_sealed_total"]
    reset_launches()
    job, got, span = CS.run_q7(torch, torch.device("cpu"), N_KEYS, N_EVENTS,
                               CAPACITY, batch=BATCH, fire_mode=mode)
    assert span == SPAN
    assert sum(KERNEL_LAUNCHES.values()) == 0   # the CPU runs plain versions
    op = job.operators[0]
    assert op._inc_enabled == (mode == "incremental")
    rows = [tuple(int(c[0]) for c in cols) for _ts, *cols in got]
    assert rows == [tuple(r) for r in reference_rows[mode]]
    assert rows == [tuple(r) for r in reference_rows["full"]]
    windows = CS.q7_check(CS.q7_expected(N_KEYS, N_EVENTS, span), got)
    assert windows == 9
    sealed = DEVICE_STATS.snapshot()["panes_sealed_total"] - before
    if mode == "incremental":
        # tumbling windows: one rebuild at the first fire, then one seal
        # per fire, each of one pane
        assert op.inc_rebuilds == {"first fire": 1}
        assert sealed == windows
    else:
        assert sealed == 0


def test_q7_incremental_keeps_a_max_tree_and_emits_int64():
    """The max plane's merge tree is [2L, capacity] with L = 16 for the
    16-row ring, in the plane's dtype; every emitted column is int64, as
    the reference's."""
    job, got, _span = CS.run_q7(torch, torch.device("cpu"), N_KEYS,
                                N_EVENTS, CAPACITY, batch=BATCH,
                                fire_mode="incremental")
    tree = job.operators[0].backend.get_array("best.__tree__")
    assert tree.shape == (32, CAPACITY) and tree.dtype == torch.int64
    assert {c.dtype for _ts, *cols in got for c in cols} == \
        {np.dtype(np.int64)}


def test_q7_oracle_catches_a_wrong_winner():
    _job, got, span = CS.run_q7(torch, torch.device("cpu"), N_KEYS,
                                N_EVENTS, CAPACITY, batch=BATCH)
    expected = CS.q7_expected(N_KEYS, N_EVENTS, span)
    ts, auction, start, end, best = got[4]
    got[4] = (ts, auction, start, end, best - 1)
    with pytest.raises(AssertionError, match="Q7"):
        CS.q7_check(expected, got)
