"""Port parity: Nexmark Q5 end to end, and the rules of the port package.

* A tiny Q5 through flink_tpu_torch's StreamExecutionEnvironment
  (``device="cpu"``, ``datagen(device=True)`` with the torch generator of
  chip_smoke.py) against the reference pipeline on the same events. Full
  emission (count + sum, no top-k) must be equal row for row; the top-k
  fire follows the tie rule. Tolerance: exact (integer aggregates).
* chip_smoke.py's torch key generator equals bench.py's uint64 numpy
  generator, also past the wrap of the 64-bit product.
* core/keygroups.py is bit-exact with the reference.
* No module of flink_tpu_torch, nor chip_smoke.py, imports jax or
  flink_tpu (the scan covers the graph, the runtime, the local cluster
  and the checkpoint modules); the tiny Q5 runs in a subprocess where
  both are blocked, through ``env.execute()`` with checkpoints and the
  fused chain on.
* An entry point asked for no device needs CUDA and raises without it.
"""

import ast
import importlib.util
import pathlib
import subprocess
import sys
from collections import defaultdict

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.core import WatermarkStrategy as RefWS  # noqa: E402
from flink_tpu.core import keygroups as ref_kg  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
from flink_tpu.window import TumblingEventTimeWindows as RefTumbling  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.core import Configuration, Schema, WatermarkStrategy  # noqa: E402
from flink_tpu_torch.core import keygroups as port_kg  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows, \
    TumblingEventTimeWindows  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]
N_EVENTS, N_KEYS, SPAN, BATCH = 20_000, 500, 20_000, 4096
MULT = 0x9E3779B97F4A7C15


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_gen(idx):
    """bench.py / examples/nexmark_q5.py: the key mixer in uint64."""
    u = idx.astype(np.uint64) * np.uint64(MULT)
    return {"auction": (u % np.uint64(N_KEYS)).astype(np.int64),
            "price": (idx % 997) + 1, "ts": (idx * SPAN) // N_EVENTS}


def _ref_rows(topk):
    env = RefEnv()
    env.set_state_backend("tpu")
    env.config.set("pipeline.micro-batch-size", BATCH)
    ws = RefWS.for_monotonous_timestamps().with_timestamp_column("ts")
    return (env.datagen(_numpy_gen, RefSchema(FIELDS), count=N_EVENTS,
                        timestamp_column="ts", watermark_strategy=ws)
            .key_by("auction")
            .window(RefSliding.of(5000, 1000))
            .device_aggregate([RefAggSpec("count", out_name="bids",
                                          value_bits=31),
                               RefAggSpec("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=32,
                              emit_topk=topk, defer_overflow=True,
                              async_fire=True)
            .execute_and_collect())


def _port_rows(topk):
    env = StreamExecutionEnvironment(
        Configuration({"pipeline.micro-batch-size": BATCH}), device="cpu")
    env.set_state_backend("tpu")
    ws = WatermarkStrategy.for_monotonous_timestamps() \
        .with_timestamp_column("ts")
    gen = _smoke().q5_gen(N_KEYS, N_EVENTS, SPAN)
    return (env.datagen(gen, Schema(FIELDS), count=N_EVENTS,
                        timestamp_column="ts", watermark_strategy=ws,
                        device=True)
            .key_by("auction")
            .window(SlidingEventTimeWindows.of(5000, 1000))
            .device_aggregate([AggSpec("count", out_name="bids",
                                       value_bits=31),
                               AggSpec("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=32,
                              emit_topk=topk, defer_overflow=True,
                              async_fire=True)
            .execute_and_collect())


def _by_window(rows):
    """{window_end: [(auction, bids, revenue)]} in emission order."""
    out = defaultdict(list)
    for auction, _start, end, bids, revenue in rows:
        out[end].append((auction, bids, revenue))
    return out


def test_tiny_q5_matches_reference_pipeline():
    full = _ref_rows(None)
    assert len(full) > 100
    assert _port_rows(None) == full
    windows = _by_window(full)
    want, got = _by_window(_ref_rows(10)), _by_window(_port_rows(10))
    assert sorted(got) == sorted(want) == sorted(windows)
    for end, prows in got.items():
        rrows = want[end]
        assert [r[1] for r in prows] == [r[1] for r in rrows]
        kth = prows[-1][1]
        assert {r[0] for r in prows if r[1] > kth} == \
            {r[0] for r in rrows if r[1] > kth}
        ties = {a for a, bids, _rev in windows[end] if bids == kth}
        assert {r[0] for r in prows if r[1] == kth} <= ties
        exact = {a: (bids, rev) for a, bids, rev in windows[end]}
        assert all(exact[a] == (bids, rev) for a, bids, rev in prows)


def test_collection_pipeline_matches_reference():
    """Host batches through ``from_collection`` (tumbling windows, every
    aggregate kind, out-of-order rows behind a bounded watermark)."""
    rng = np.random.default_rng(9)
    n = 600
    rows = list(zip(rng.integers(0, 12, n).tolist(),
                    rng.integers(-100, 100, n).tolist()))
    ts = (np.arange(n) * 10 + rng.integers(0, 300, n)).tolist()
    kinds = [("count", None), ("sum", "v"), ("min", "v"), ("max", "v")]
    fields = [("k", np.int64), ("v", np.int64)]

    def run(env, schema, ws, tumbling, agg):
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", 64)
        return (env.from_collection(rows, schema(fields), ts,
                                    ws.for_bounded_out_of_orderness(200))
                .key_by("k").window(tumbling.of(1000))
                .device_aggregate([agg(k, f) for k, f in kinds],
                                  capacity=16, ring_size=8)
                .execute_and_collect())

    want = run(RefEnv(), RefSchema, RefWS, RefTumbling,
               lambda k, f: RefAggSpec(k, f, dtype=np.int64))
    got = run(StreamExecutionEnvironment(device="cpu"), Schema,
              WatermarkStrategy, TumblingEventTimeWindows,
              lambda k, f: AggSpec(k, f, dtype=np.int64))
    assert len(want) > 50
    assert got == want


@pytest.mark.parametrize("n_keys", [500, 1_000_000, 10_000_000,
                                    (1 << 31) - 1, (1 << 62) + 7])
def test_torch_key_generator_equals_numpy(n_keys):
    rng = np.random.default_rng(n_keys % 1000)
    idx = np.concatenate([np.arange(4096, dtype=np.int64),
                          rng.integers(0, 1 << 33, 20_000, dtype=np.int64),
                          (1 << 33) - np.arange(1, 64, dtype=np.int64)])
    gen = _smoke().q5_gen(n_keys, 1 << 34, 1 << 20)
    got = gen(torch.from_numpy(idx))
    want = ((idx.astype(np.uint64) * np.uint64(MULT))
            % np.uint64(n_keys)).astype(np.int64)
    np.testing.assert_array_equal(got["auction"].numpy(), want)
    np.testing.assert_array_equal(got["ts"].numpy(),
                                  (idx * (1 << 20)) // (1 << 34))


def test_keygroups_bit_exact():
    rng = np.random.default_rng(4)
    i64 = np.iinfo(np.int64)
    keys = np.concatenate([
        rng.integers(i64.min, i64.max, 5000, dtype=np.int64),
        np.array([0, 1, -1, i64.min, i64.max, 1 << 32, -(1 << 32)],
                 np.int64)])
    hashes = port_kg.hash_batch(keys)
    np.testing.assert_array_equal(hashes, ref_kg.hash_batch(keys))
    assert hashes.dtype == ref_kg.hash_batch(keys).dtype
    np.testing.assert_array_equal(port_kg.murmur_mix(hashes),
                                  ref_kg.murmur_mix(hashes))
    for code in (0, 1, 0xFFFFFFFF, 0x80000000, 12345):
        assert port_kg.murmur_mix(code) == ref_kg.murmur_mix(code)
    for maxp in (7, 128, 4096, 32768):
        got = port_kg.key_groups_for_hash_batch(hashes, maxp)
        want = ref_kg.key_groups_for_hash_batch(hashes, maxp)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        for par in (p for p in (1, 3, 7) if p <= maxp):
            for i in range(par):
                r = port_kg.key_group_range_for_operator(maxp, par, i)
                w = ref_kg.key_group_range_for_operator(maxp, par, i)
                assert (r.start, r.end) == (w.start, w.end)


def _port_sources():
    return sorted((ROOT / "flink_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_flink_tpu():
    banned = {"jax", "jaxlib", "flink_tpu"}
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                          for n in names if n.split(".")[0] in banned]
    scanned = {p.relative_to(ROOT).as_posix() for p in _port_sources()}
    assert {"flink_tpu_torch/graph/stream_graph.py",
            "flink_tpu_torch/graph/fusion.py",
            "flink_tpu_torch/graph/transformations.py",
            "flink_tpu_torch/runtime/stream_task.py",
            "flink_tpu_torch/runtime/channels.py",
            "flink_tpu_torch/runtime/writer.py",
            "flink_tpu_torch/runtime/compiled.py",
            "flink_tpu_torch/cluster/local.py",
            "flink_tpu_torch/checkpoint/coordinator.py",
            "flink_tpu_torch/checkpoint/storage.py",
            "flink_tpu_torch/state/spill.py"} <= scanned
    assert "flink_tpu_torch/runtime/local.py" not in scanned
    assert len(scanned) > 30
    assert not offenders, offenders


_BLOCKED_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
# through env.execute(): the fused chain, and a checkpoint every 20 ms of
# a source paced to last half a second
job, got, span = cs.run_q5(
    torch, torch.device("cpu"), 3000, 1 << 14, 1 << 13, batch=1 << 10,
    topk=20, fused=True, rate=(1 << 14) / 0.5,
    settings={{"execution.checkpointing.interval": 0.02}})
n = cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20)
assert sys.modules["jax"] is None and sys.modules["flink_tpu"] is None
assert any(m.startswith("flink_tpu_torch.") for m in sys.modules)
assert "flink_tpu_torch.cluster.local" in sys.modules
fused = len(job.job_graph.vertices) == 1 and not job.fusion_declined
# under an HBM budget: keys page to the host tier, staged in the step
job2, got2, span2 = cs.run_q5(
    torch, torch.device("cpu"), 3000, 1 << 14, 1 << 13, batch=1 << 10,
    topk=20, staging=1 << 10,
    settings={{"state.backend.tpu.hbm-budget-slots": 1 << 11}})
n2 = cs.q5_oracle_check(3000, 1 << 14, span2, got2, topk=20)
assert "flink_tpu_torch.state.spill" in sys.modules
assert sys.modules["jax"] is None and sys.modules["flink_tpu"] is None
print("windows", n, "late", job.operators[0].late_dropped,
      "checkpoints", int(len(job.coordinator.stats) > 0), "fused",
      int(fused and job.operators[0].fused_chain is not None),
      "spilled_windows", n2, int(job2.operators[0].backend.spill_active))
"""


def test_q5_runs_with_jax_and_flink_tpu_blocked():
    """chip_smoke.py's own Q5 path and numpy oracle, at a tiny size on the
    CPU, in a process that cannot import jax or flink_tpu: through
    ``env.execute()`` on the graph runtime, with the fused chain and
    periodic checkpoints, then again under an HBM budget (the host spill
    tier)."""
    out = subprocess.run([sys.executable, "-c",
                          _BLOCKED_RUN.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=240,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["windows", "13", "late", "0",
                                  "checkpoints", "1", "fused", "1",
                                  "spilled_windows", "13", "1"]


def test_smoke_oracle_catches_a_wrong_window():
    cs = _smoke()
    job, got, span = cs.run_q5(torch, torch.device("cpu"), 3000, 1 << 14,
                               1 << 13, batch=1 << 10, topk=20)
    assert cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20) == len(got)
    ts, keys, bids, revenue = got[3]
    got[3] = (ts, keys, bids, revenue + 1)
    with pytest.raises(AssertionError, match="numpy oracle"):
        cs.q5_oracle_check(3000, 1 << 14, span, got, topk=20)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamExecutionEnvironment()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamExecutionEnvironment(device="cuda")
    assert StreamExecutionEnvironment(device="cpu").device.type == "cpu"
