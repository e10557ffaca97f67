"""The session kernels of csrc/session_window.cu against their plain
versions on the card, on the adversarial inputs of chip_smoke.py
(``EDGE_STEP_CASES``, ``EDGE_FIRE_CASES``):

* the step: a hot key whose run crosses the step's blocks; 1, 4, 16 and 64
  lanes with every lane of a key open, so segments are dropped; no
  aggregate, and 8 aggregate planes of every dtype; each on fresh tables
  (key by key) and on a table that already holds the batch's keys (slot
  for slot), with the fires after each batch;
* the fire: exactly capacity lanes due, capacity + 1, none, every lane,
  and entries that are not a multiple of the fire's tile (4096 lanes
  below 2^24 entries) or of the lanes a thread owns: every round's rows
  in lane-major order, every plane and the dirty bitmap exactly equal.

After every call the lanes that are not open hold the identities. The
tests need a CUDA card and skip without one; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_session_kernels.py
"""

import importlib.util
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.EDGE_STEP_CASES)
def test_step_kernel_equals_plain(dev, case):
    seen = cs.check_session_edge_steps(torch, dev, case)
    assert seen["fresh"] == seen["shared"]
    if case.startswith("lanes_"):
        assert seen["fresh"]["dropped"] > 0 and seen["fresh"]["late"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", cs.EDGE_FIRE_CASES)
def test_fire_kernel_equals_plain(dev, case):
    got = cs.check_session_edge_fire(torch, dev, case)
    if case == "ragged_tiles":
        assert got["entries"] % 4096 and got["rounds"] == 2
    if case == "ragged_threads":
        assert got["entries"] % 16
