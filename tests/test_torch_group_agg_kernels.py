"""The group aggregation kernels of csrc/group_agg.cu (the stages of
``ops/group_agg.py::group_agg_step``) against ``group_agg_step_plain``
on the card, on the adversarial inputs of chip_smoke.py
(``GAGG_EDGE_CASES``, ``GAGG_STEP_CASES``, ``GAGG_CARD_CASES``):

* every row on one key, across many warps and tiles;
* a group drained and re-inserted within one batch (no reset) and across
  batches (the planes reset to 0, +inf and -inf, and MIN/MAX restart);
* +-inf, -0.0, +0.0 and NaN in the sum, min and max planes, on fresh
  slots (at the state backend's identities) and after a reset;
* rows with slot -1 and rows past n_valid, next to a real slot 0;
* 0, 1, 255, 257 and 1000 rows; 2^16 rows over 6 groups; 32 planes;
* composite keys (two integer columns combined, then probed);
* groups of one row (finished by the compaction) and of several side by
  side: a slot spread over the whole batch, a group drained and
  re-inserted within a batch, batches of 3000, 2999 and 257 rows,
  n_valid < n, specials, 32 planes, batches with nothing to fold, runs of
  7 and 37 rows on one slot across warps and tiles;
* all 2^19 rows on one slot and on 6 slots (the fold's pre-fold table);
  64 slots a tile in 4-row peer sets, no slot shared between tiles (a
  fold block walks more distinct slots than its table holds);
  all-distinct rows at 2^24 slots.

Both sides get the same slots; the group count, row indices, PREV and
NEW rows, every plane, the dirty bitmap and both scratches are compared
bit for bit (values are integers or specials, so every sum is exact in
any order: tolerance exact). One further test runs the device GROUP BY
operator on the card and on the CPU over the same batches: the changelogs
must be equal row for row.

The tests need a CUDA card and skip without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_group_agg_kernels.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from flink_tpu_torch.core.records import RecordBatch, Schema
from flink_tpu_torch.runtime.harness import OneInputOperatorTestHarness
from flink_tpu_torch.sql.device_group_agg import DeviceGroupAggOperator
from flink_tpu_torch.sql.group_agg import SqlAggSpec

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("case", cs.GAGG_EDGE_CASES + cs.GAGG_STEP_CASES
                         + cs.GAGG_CARD_CASES)
def test_kernel_equals_plain(dev, case):
    seen = cs.check_gagg_edge(torch, dev, case)
    assert seen["groups"] > 0


def test_operator_on_card_equals_cpu(dev):
    schema = Schema([("k", np.int64), ("v", np.int64),
                     ("__rowkind__", np.int8)])
    aggs = [SqlAggSpec("sum", "v", "s"), SqlAggSpec("count", None, "c"),
            SqlAggSpec("avg", "v", "a"), SqlAggSpec("min", "v", "mn"),
            SqlAggSpec("max", "v", "mx")]
    rng = np.random.default_rng(3)
    outs = []
    for device in (dev, torch.device("cpu")):
        h = OneInputOperatorTestHarness(
            DeviceGroupAggOperator(["k"], aggs, capacity=64, device=device),
            schema)
        for b in range(6):
            n = 3000
            rows = {"k": rng.integers(0, 200, n) if b % 2 else
                    rng.integers(-5, 5, n),
                    "v": rng.integers(-100, 100, n),
                    "__rowkind__": np.where(rng.random(n) < 0.3, 1, 0)}
            h.process_batch(RecordBatch(schema, rows,
                                        np.full(n, b, np.int64)))
        rng = np.random.default_rng(3)
        outs.append([r for bt in h.output.batches for r in bt.iter_rows()])
    assert outs[0] == outs[1]
