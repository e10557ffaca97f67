"""Port parity: the fused ingest step
(flink_tpu_torch/ops/hash_table.py::ingest_step, which runs its plain
version on the CPU) against the reference's per-batch step program,
flink_tpu/runtime/operators/device_window.py::_step_body, on the same
numpy batches.

The batches are made from a seed. Their timestamps are negative as well
as positive and the window offset is negative, so the pane and the ring
row must floor; rows in panes below the first open one are late; the
EMPTY_KEY sentinel is a key (it remaps to EMPTY_KEY - 1, which is a key
too); one case gives the table fewer slots than keys, so inserts fail and
count as dropped. Values are small integers, so every float sum is exact.
Tolerance: exact. The table (the plain probe is the reference's
algorithm, so slot layouts match), every plane, and the late and dropped
counters equal the reference's."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.ops.hash_table import make_table as ref_make_table  # noqa: E402
from flink_tpu.ops.segment_ops import make_accumulator as ref_acc  # noqa: E402
from flink_tpu.runtime.operators.device_window import _step_body  # noqa: E402
from flink_tpu_torch.ops import hash_table as port  # noqa: E402
from flink_tpu_torch.ops.segment_ops import make_accumulator  # noqa: E402

EMPTY = int(np.iinfo(np.int64).max)
RING, PANE, OFFSET, FIRST_OPEN = 4, 100, -37, -4

#: case -> (fold kind of the value plane, plane dtype, column dtype, count
#: plane dtype, capacity, distinct keys); "avg" folds an int64 column into
#: its float32 sum plane, as the operator registers it
CASES = {f"{kind}_{np.dtype(dt).name}": (kind, dt, dt, cdt, 64, 20)
         for kind in ("sum", "min", "max")
         for dt, cdt in ((np.int32, np.int32), (np.int64, np.int64),
                         (np.float32, np.int32), (np.float64, np.int64))}
CASES["avg_sum_from_int64"] = ("sum", np.float32, np.int64, np.int32, 64, 20)
CASES["table_too_small"] = ("sum", np.int64, np.int64, np.int64, 16, 40)


def _batches(seed: int, distinct: int, n: int = 160, count: int = 3):
    """[(keys, ts, values)]: panes -7..6 around the offset, so rows of
    panes -7..-5 are late (FIRST_OPEN = -4) and ring rows wrap."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(-(10 ** 12), 10 ** 12, distinct)
    pool[:2] = [EMPTY, EMPTY - 1]
    return [(pool[rng.integers(0, distinct, n)],
             rng.integers(-700, 300, n) + 150 * b,
             rng.integers(-50, 50, n)) for b in range(count)]


def _reference(case, batches):
    kind, dt, col_dt, cdt, cap, _d = case
    ensure_x64()
    step = _step_body(((kind, "p", "v"),), RING, PANE, OFFSET, 8)
    table = ref_make_table(cap)
    arrays = {"__count__": ref_acc("count", (RING, cap), jnp.dtype(cdt)),
              "p": ref_acc(kind, (RING, cap), jnp.dtype(dt))}
    dropped, late = jnp.int64(0), jnp.int64(0)
    dirty = jnp.zeros(cap // 8 + 1, bool)
    for keys, ts, vals in batches:
        table, arrays, dropped, late, dirty, _st, _to, _tok = step(
            table, arrays, dropped, late, dirty, None, None,
            jnp.asarray(keys), jnp.asarray(ts),
            {"v": jnp.asarray(vals.astype(col_dt))}, None, 0, FIRST_OPEN,
            len(keys))
    return (np.asarray(table), np.asarray(arrays["__count__"]),
            np.asarray(arrays["p"]), int(late), int(dropped))


def _port(case, batches):
    kind, dt, col_dt, cdt, cap, _d = case
    tdt = {np.int32: torch.int32, np.int64: torch.int64,
           np.float32: torch.float32, np.float64: torch.float64}
    table = port.make_table(cap, "cpu")
    count = make_accumulator("count", (RING, cap), tdt[cdt], "cpu")
    plane = make_accumulator(kind, (RING, cap), tdt[dt], "cpu")
    late = torch.zeros((), dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    for keys, ts, vals in batches:
        port.ingest_step(table, [("count", count, None),
                                 (kind, plane, torch.from_numpy(
                                     vals.astype(col_dt)))],
                         torch.from_numpy(ts), torch.from_numpy(keys), PANE,
                         OFFSET, FIRST_OPEN, late, dropped)
    return (table.numpy(), count.numpy(), plane.numpy(), int(late),
            int(dropped))


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_reference_step_body(case):
    c = CASES[case]
    batches = _batches(len(case), c[5])
    want = _reference(c, batches)
    got = _port(c, batches)
    for name, g, w in zip(("table", "count", "plane"), got[:3], want[:3]):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[3:] == want[3:]
    table, _count, _plane, late, dropped = got
    assert late > 0
    assert (dropped > 0) == (case == "table_too_small")
    if not dropped:   # the sentinel key and its remap share one slot
        assert EMPTY - 1 in table and EMPTY not in table[table != EMPTY]


def test_step_with_no_rows_changes_nothing():
    table = port.make_table(8, "cpu")
    count = make_accumulator("count", (RING, 8), torch.int32, "cpu")
    late = torch.zeros((), dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    empty = torch.zeros(0, dtype=torch.int64)
    port.ingest_step(table, [("count", count, None)], empty, empty, PANE,
                     OFFSET, FIRST_OPEN, late, dropped)
    assert (table == port.EMPTY_KEY).all() and (count == 0).all()
    assert int(late) == int(dropped) == 0


@pytest.mark.parametrize("bad", ["float_keys", "plane_shape", "kind"])
def test_step_refuses_what_the_kernel_cannot_take(bad):
    """The wrapper checks its inputs before it picks a path, so the CPU
    refuses what the card's kernel would refuse."""
    table = port.make_table(8, "cpu")
    count = make_accumulator("count", (RING, 8), torch.int32, "cpu")
    ts = torch.zeros(4, dtype=torch.int64)
    keys = ts.to(torch.float32) if bad == "float_keys" else ts.clone()
    planes = [("count", count, None)]
    if bad == "plane_shape":
        planes.append(("sum", torch.zeros(RING, 4), None))
    if bad == "kind":
        planes.append(("median", torch.zeros(RING, 8), None))
    with pytest.raises(ValueError):
        port.ingest_step(table, planes, ts, keys, PANE, OFFSET, FIRST_OPEN,
                         torch.zeros((), dtype=torch.int64),
                         torch.zeros((), dtype=torch.int64))


#: chip_smoke.py's adversarial inputs that the reference's step takes as
#: they are (the dirty form): every row one key, every key's home slot in
#: one 64th of the table, every row late, a table with no free slot
REF_EDGE_CASES = ("hot_key", "one_bucket", "all_late", "full_table")


def _chip_smoke():
    import importlib.util
    import pathlib

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plain_step_matches_reference_on_adversarial_input():
    """``ingest_step_plain`` against ``_step_body`` on the adversarial
    inputs the card's kernel is held to (tests/test_torch_ingest_kernels.py),
    one case after another (the file stays under the size at which its
    place among the largest test files would move): the table (the same
    prepared table for both, the same probe rounds), the count plane and
    every value plane, late and dropped, exactly."""
    cs = _chip_smoke()
    for case in REF_EDGE_CASES:
        _plain_matches_reference(cs, case)


def _plain_matches_reference(cs, case: str) -> None:
    (c,) = cs.ingest_edge_configs(case)
    cap, ring = c["cap"], c["ring"]
    (_c, count_dt, _none), *values = c["planes"]
    ensure_x64()
    step = _step_body(tuple((kind, f"p{q}", col)
                            for q, (kind, _dt, col) in enumerate(values)),
                      ring, cs.EDGE_PANE, cs.EDGE_OFFSET, 1 << cs.EDGE_SHIFT)
    table = (ref_make_table(cap) if c["prefill"] is None
             else jnp.asarray(c["prefill"]))
    arrays = {"__count__": ref_acc("count", (ring, cap), jnp.dtype(count_dt)),
              **{f"p{q}": ref_acc(kind, (ring, cap), jnp.dtype(dt))
                 for q, (kind, dt, _col) in enumerate(values)}}
    dropped, late = jnp.int64(0), jnp.int64(0)
    dirty = jnp.zeros((cap >> cs.EDGE_SHIFT) + 1, bool)
    for keys, ts, vals in c["batches"]:
        table, arrays, dropped, late, dirty, _st, _to, _tok = step(
            table, arrays, dropped, late, dirty, None, None,
            jnp.asarray(keys), jnp.asarray(ts),
            {k: jnp.asarray(v) for k, v in vals.items()}, None, 0,
            cs.EDGE_FIRST_OPEN, len(keys))
    got = cs.run_ingest_edge(torch, torch.device("cpu"), c, "dirty",
                             port.ingest_step_plain)
    np.testing.assert_array_equal(got["table"].numpy(), np.asarray(table),
                                  err_msg=case)
    want = [np.asarray(arrays["__count__"])] + [
        np.asarray(arrays[f"p{q}"]) for q in range(len(values))]
    for q, (g, w) in enumerate(zip(got["planes"], want)):
        assert g.numpy().dtype == w.dtype, (case, q)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{case} {q}")
    assert (got["late"], got["dropped"]) == (int(late), int(dropped)), case
    rows = sum(k.size for k, _t, _v in c["batches"])
    if case == "all_late":
        assert got["late"] == rows
    if case == "full_table":
        assert got["dropped"] > 0
    if case in ("hot_key", "one_bucket"):
        assert got["dropped"] == 0 and got["late"] > 0
