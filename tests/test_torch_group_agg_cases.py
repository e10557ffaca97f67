"""The device GROUP BY step's plain version
(``ops/group_agg.py::group_agg_step_plain``) against the reference's
``_gagg_program``, on the CPU, where its two paths meet: a group of one
row in the batch (finished by the compaction) and a group of several
(folded, then emitted at its last row).

On chip_smoke.py's cases (``GAGG_STEP_CASES``: a slot spread over the
whole batch, a group drained and re-inserted within a batch, batches not
a multiple of 256 rows, ``n_valid < n``, +-inf, -0.0 and NaN in min and
max, 32 planes with groups of one row and of several, batches with
nothing to fold, runs of one slot across warps and tiles, 32 planes of
one-row groups) the group count, row indices, PREV and NEW rows and every
plane equal the reference's bit for bit (NaN where NaN), and both halves
of the row scratch (first and last row) are back at their sentinels after
every step. Also: ``make_step``'s input checks, the stages run one by one
(as chip_smoke.py times them alone) against the step, and the operator
against the reference operator across a rehash and a restore.

Values are integers or specials, so every sum is exact in any order:
tolerance exact.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from flink_tpu.core.records import RecordBatch as RefBatch  # noqa: E402
from flink_tpu.core.records import Schema as RefSchema  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.runtime.harness import \
    OneInputOperatorTestHarness as RefHarness  # noqa: E402
from flink_tpu.sql.device_group_agg import \
    DeviceGroupAggOperator as RefOp  # noqa: E402
from flink_tpu.sql.device_group_agg import _gagg_program  # noqa: E402
from flink_tpu.sql.group_agg import SqlAggSpec as RefSpec  # noqa: E402
from flink_tpu_torch.core.records import RecordBatch, Schema  # noqa: E402
from flink_tpu_torch.ops import group_agg as ga  # noqa: E402
from flink_tpu_torch.runtime.harness import \
    OneInputOperatorTestHarness  # noqa: E402
from flink_tpu_torch.sql.device_group_agg import \
    DeviceGroupAggOperator  # noqa: E402
from flink_tpu_torch.sql.group_agg import SqlAggSpec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

CPU = torch.device("cpu")
KIND = "__rowkind__"


def _ref_run(c: dict) -> list:
    """The reference program over the case's batches; per batch (groups,
    row_idx, prev, new, planes)."""
    ensure_x64()
    names = [f"p{q}" for q in range(len(c["kinds"]))]
    names[0] = "__rc__"
    fold_sig = tuple((n, k, col) for n, k, col in
                     zip(names[1:], c["kinds"][1:], c["cols"][1:]))
    ident = {"sum": 0.0, "min": np.finfo(np.float64).max,
             "max": np.finfo(np.float64).min}
    planes = {n: jnp.full(c["cap"], ident[k], jnp.float64)
              for n, k in zip(names, c["kinds"])}
    dirty = jnp.zeros(c["cap"] // 8, bool)
    out = []
    for b in c["batches"]:
        vals = tuple(jnp.asarray(b["vals"][j])
                     for j in range(b["vals"].shape[0]))
        planes, dirty, g, row_idx, prev, new = _gagg_program(fold_sig, 8)(
            planes, dirty, jnp.asarray(b["slots"]), jnp.asarray(b["sign"]),
            vals, np.int64(b["n_valid"]))
        g = int(g)
        out.append((g, np.asarray(row_idx)[:g],
                    np.stack([np.asarray(prev[n])[:g] for n in names], 1),
                    np.stack([np.asarray(new[n])[:g] for n in names], 1),
                    [np.asarray(planes[n]) for n in names]))
    return out


def _port_run(c: dict) -> list:
    """The plain step over the case's batches; per batch (groups, row_idx,
    prev, new, planes)."""
    st = cs.gagg_state(torch, CPU, c)
    P = len(c["kinds"])
    out = []
    for raw in c["batches"]:
        b = cs.gagg_batch_on(torch, CPU, st, raw)
        step = cs.gagg_step_on(ga.group_agg_step_plain, c, st, b)
        g = int(step.n_groups[0])
        comp = step.comp[:g].numpy()
        out.append((g, step.row_idx[:g].numpy(), comp[:, :P], comp[:, P:],
                    [p.numpy().copy() for p in st["planes"]]))
        assert bool((st["firstpos"] == ga.NO_ROW).all())
        assert bool((st["lastpos"] == ga.NO_LAST).all())
    return out


def _assert_same(port: list, other: list, what: str) -> None:
    for j, (p, r) in enumerate(zip(port, other)):
        assert p[0] == r[0], f"{what} batch {j}: groups"
        assert np.array_equal(p[1], r[1]), f"{what} batch {j}: row indices"
        assert cs.same_bits(p[2], r[2]), f"{what} batch {j}: PREV rows"
        assert cs.same_bits(p[3], r[3]), f"{what} batch {j}: NEW rows"
        for q, (a, b) in enumerate(zip(p[4], r[4])):
            assert cs.same_bits(a, b), f"{what} batch {j}: plane {q}"


@pytest.mark.parametrize("case", cs.GAGG_STEP_CASES)
def test_step_case_equals_reference(case):
    c = cs.gagg_edge_config(case)
    port = _port_run(c)
    _assert_same(port, _ref_run(c), "reference")


def test_make_step_checks_its_inputs():
    c = cs.gagg_edge_config("odd_batches")
    st = cs.gagg_state(torch, CPU, c)
    b = cs.gagg_batch_on(torch, CPU, st, c["batches"][0])
    args = [st["planes"], c["kinds"], c["cols"], b["slots"], b["sign"],
            b["vals"], b["n_valid"], st["rowpos"]]
    step = ga.make_step(*args)
    assert step.status is None and step.n_valid == 3000
    assert step.comp.shape == (3000, 2 * len(c["kinds"]))
    bad = {
        "too many planes": (0, [st["planes"][0]] * 33),
        "plane 0 not the row count": (1, ("min",) + c["kinds"][1:]),
        "a min plane of the sign": (2, c["cols"][:3] + (-1,)
                                    + c["cols"][4:]),
        "int64 slots": (3, b["slots"].long()),
        "n_valid past n": (6, 3001),
        "a first-row scratch only": (7, st["rowpos"][:, 0].contiguous()),
    }
    for what, (k, value) in bad.items():
        with pytest.raises(ValueError):
            ga.make_step(*args[:k], value, *args[k + 1:])
            pytest.fail(what)


def test_stage_by_stage_equals_the_step():
    """Each stage, one after another (as the stages are timed alone),
    gives the step's outputs."""
    c = cs.gagg_edge_config("slot_spread")
    a, b = cs.gagg_state(torch, CPU, c), cs.gagg_state(torch, CPU, c)
    for raw in c["batches"]:
        batch = cs.gagg_batch_on(torch, CPU, a, raw)
        want = cs.gagg_outputs(torch, cs.gagg_step_on(
            ga.group_agg_step_plain, c, a, batch))
        st = cs.gagg_step_on(ga.make_step, c, b, batch)
        ga.group_agg_first(st)
        ga.group_agg_compact(st)
        ga.group_agg_fold(st)
        ga.group_agg_emit(st)
        got = cs.gagg_outputs(torch, st)
        assert got["groups"] == want["groups"]
        assert np.array_equal(got["row_idx"], want["row_idx"])
        assert cs.same_bits(got["comp"], want["comp"])
        for name in ("rowpos", "dirty"):
            assert torch.equal(a[name], b[name]), name
        for p, q in zip(a["planes"], b["planes"]):
            assert cs.same_bits(p.numpy(), q.numpy())


SCHEMA = [("k", np.int64), ("v", np.int64), (KIND, np.int8)]
AGGS = [("sum", "v", "s"), ("count", None, "c"), ("avg", "v", "a"),
        ("min", "v", "mn"), ("max", "v", "mx")]


def _port_op():
    return DeviceGroupAggOperator(["k"], [SqlAggSpec(*a) for a in AGGS],
                                  capacity=64, device="cpu")


def test_operator_across_rehash_and_restore_equals_reference():
    """Batches of groups of one row and of several: the changelog stays
    the reference's, across a rehash and a restore (each a fresh row
    scratch)."""
    rng = np.random.default_rng(11)
    port = OneInputOperatorTestHarness(_port_op(), Schema(SCHEMA))
    ref = RefHarness(RefOp(["k"], [RefSpec(*a) for a in AGGS], capacity=64),
                     RefSchema(SCHEMA))

    def feed(hs, t):
        n = 900
        cols = {"k": rng.integers(0, 150, n), "v": rng.integers(-40, 90, n),
                KIND: np.where(rng.random(n) < 0.3, 1, 0).astype(np.int8)}
        ts = np.full(n, t, np.int64)
        hs[0].process_batch(RecordBatch(Schema(SCHEMA), cols, ts))
        hs[1].process_batch(RefBatch(RefSchema(SCHEMA), cols, ts))

    for t in range(4):
        feed((port, ref), t)
    op = port.operator
    assert op.rehashes
    snap = port.snapshot()
    restored = OneInputOperatorTestHarness.restored(
        _port_op, snap, schema=Schema(SCHEMA))
    ref_restored = RefHarness.restored(
        lambda: RefOp(["k"], [RefSpec(*a) for a in AGGS], capacity=64), snap,
        schema=RefSchema(SCHEMA))
    for t in range(4, 6):
        feed((restored, ref_restored), t)

    def rows(h):
        return [tuple(float(x) if isinstance(x, float) else int(x)
                      for x in r) for bt in h.output.batches
                for r in bt.iter_rows()]

    assert rows(port) == rows(ref)
    assert rows(restored) == rows(ref_restored)
    assert restored.operator._rowpos.shape[0] == \
        restored.operator.backend.capacity
