"""Port parity: scatter folds (flink_tpu_torch/ops/segment_ops.py vs
flink_tpu/ops/segment_ops.py).

Duplicate indices and invalid rows (which fold the identity into slot 0)
over int32, int64 and float32 accumulators. Tolerance: exact; float
values are small integers, so every sum is exactly representable and the
summation order cannot matter."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.ops import segment_ops as ref  # noqa: E402
from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu_torch.ops import segment_ops as port  # noqa: E402

DTYPES = [(np.int32, torch.int32), (np.int64, torch.int64),
          (np.float32, torch.float32)]


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("np_dt,t_dt", DTYPES)
def test_scatter_fold_matches_reference(kind, np_dt, t_dt):
    ensure_x64()
    rng = np.random.default_rng(11)
    size, n = 64, 500
    idx = rng.integers(0, size, n).astype(np.int64)
    vals = rng.integers(-1000, 1000, n).astype(np_dt)
    valid = rng.random(n) < 0.7
    acc0 = np.asarray(ref.make_accumulator(kind, (size,), jnp.dtype(np_dt)))
    want = acc0
    got = port.make_accumulator(kind, (size,), t_dt, "cpu")
    np.testing.assert_array_equal(got.numpy(), acc0)
    for chunk in np.array_split(np.arange(n), 3):   # folds accumulate
        want = ref.scatter_fold(kind, jnp.asarray(want), jnp.asarray(
            idx[chunk]), jnp.asarray(vals[chunk]), jnp.asarray(valid[chunk]))
        out = port.scatter_fold(kind, got, torch.from_numpy(idx[chunk]),
                                torch.from_numpy(vals[chunk]),
                                torch.from_numpy(valid[chunk]))
        assert out is got   # in place
    assert got.dtype == t_dt
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
def test_pane_merge_matches_reference(kind):
    """The fire's pane-row merge (AGG_MERGES) over a [W, capacity] block."""
    rng = np.random.default_rng(5)
    block = rng.integers(-50, 50, (5, 32)).astype(np.int64)
    want = np.asarray(ref.AGG_MERGES[kind](jnp.asarray(block), axis=0))
    got = port.AGG_MERGES[kind](torch.from_numpy(block))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pow2_ceil():
    for n in (1, 2, 3, 4, 5, 1000, 1 << 20, (1 << 20) + 1):
        assert port.pow2_ceil(n) == ref.pow2_ceil(n)
