"""The ingest step's kernels of csrc/hash_table.cu (the dirty form and the
spill form of ``ingest_step``) against ``ingest_step_plain`` on the card,
on the adversarial inputs of chip_smoke.py (``INGEST_EDGE_CASES``):

* every row one key; every key's home slot in one 64th of the table; one
  row; 255, 257, 1000 and 4097 rows (not a multiple of a block); every row
  late; a table with no free slot (the absent keys dropped, or staged in
  the spill form); cells past 2^31 (ring 129 x 2^24 uint8 planes); every
  fold kind and dtype, and a bool column;
* the spill split with no key group spilled, every group, a stage that
  overflows (and a batch that finds it full), 1, 100 and 4096 key groups,
  and a restored clock above the batch number.

Each run compares the table's key set, every plane key by key (the
kernel's CAS places keys unlike the plain version's scatter-min), the
late and dropped counters, each run's dirty blocks against the blocks of
its own folds, and in the spill form the staged keys, ring rows and
values position by position (both stage in batch order), the stage
count and the touch clock. Values are small integers or multiples of 1/8,
so every sum is exact in any order: tolerance exact.

The tests need a CUDA card and skip without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_ingest_kernels.py
"""

import importlib.util
import pathlib

import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.ops import hash_table as ht

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


@pytest.mark.parametrize("case", cs.INGEST_EDGE_CASES)
def test_kernel_equals_plain(dev, case):
    seen = cs.check_ingest_edge(torch, dev, case)
    for form in seen.values():
        assert form["rows"] > 0
    dirty = seen.get("dirty")
    spill = seen.get("spill")
    if case == "hot_key":
        assert dirty["keys"] == spill["keys"] == 1 and dirty["late"] > 0
    if case == "one_bucket":
        assert dirty["dropped"] == 0 and dirty["keys"] > 200
    if case == "all_late":
        assert dirty["late"] == dirty["rows"] and dirty["keys"] == 0
        assert spill["staged"] == 0 and spill["late"] == spill["rows"]
    if case == "full_table":
        assert dirty["dropped"] > 0
        assert spill["staged"] > 0 and spill["dropped"] == 0
    if case == "spill_none":
        assert spill["staged"] == 0
    if case == "spill_all":
        assert spill["keys"] == 0
        assert spill["staged"] == spill["rows"] - spill["late"]
    if case == "spill_overflow":
        assert spill["dropped"] > 0 and spill["staged"] > 700
    if case == "cells_past_2^31":
        # every row folds into ring row 128 of 129: cells past 2^31
        (c,) = cs.ingest_edge_configs(case)
        _keys, ts, _vals = c["batches"][0]
        panes = (ts - cs.EDGE_OFFSET) // cs.EDGE_PANE
        assert (panes % c["ring"] == c["ring"] - 1).all()
        assert (c["ring"] - 1) * c["cap"] >= 1 << 31 and dirty["keys"] > 0


def test_one_launch_per_call(dev):
    """Each form of the step counts one launch per call, and no probe."""
    for case, form in (("n_ragged", "dirty"), ("spill_overflow", "spill")):
        c = cs.ingest_edge_configs(case)[0]
        reset_launches()
        cs.run_ingest_edge(torch, dev, c, form, ht.ingest_step)
        torch.cuda.synchronize()
        assert KERNEL_LAUNCHES["ingest_step"] == len(c["batches"])
        assert KERNEL_LAUNCHES[f"ingest_step_{form}"] == len(c["batches"])
        assert KERNEL_LAUNCHES["hash_probe"] == 0
