"""Port parity: radix-select histogram and masked top-k
(flink_tpu_torch/ops/radix_topk.py + topk.py vs flink_tpu/ops/pallas_topk.py
+ topk.py).

The histogram is held against numpy bincount and the reference's Pallas
kernel in interpret mode (as tests/test_pallas_topk.py runs it); exact.
Top-k is held against the reference ``masked_topk`` under the tie rule:
values and ok equal, indices strictly above the k-th value equal as sets,
indices at the k-th value a subset of that tie class. Float inputs are
multiples of 1/8, exactly representable."""

import zlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.ops.hash_table import ensure_x64  # noqa: E402
from flink_tpu.ops.pallas_topk import histogram256_pallas  # noqa: E402
from flink_tpu.ops.topk import masked_topk as ref_topk  # noqa: E402
from flink_tpu_torch.ops.radix_topk import histogram256  # noqa: E402
from flink_tpu_torch.ops.topk import masked_topk, masked_topk_sort  # noqa: E402


@pytest.mark.parametrize("valid_dtype", [torch.bool, torch.uint8])
def test_histogram_matches_numpy_and_pallas(valid_dtype):
    ensure_x64()
    rng = np.random.default_rng(3)
    u = rng.integers(-(1 << 31), 1 << 31, 5000).astype(np.int32)
    valid = rng.random(5000) < 0.7
    for shift in (0, 8, 16, 24):
        got = histogram256(torch.from_numpy(u),
                           torch.from_numpy(valid).to(valid_dtype), shift)
        ids = (u[valid].astype(np.uint32) >> shift) & 0xFF
        want = np.bincount(ids, minlength=256).astype(np.int32)
        pallas = np.asarray(histogram256_pallas(
            jnp.asarray(u), jnp.asarray(valid), shift, interpret=True))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), pallas)


def _values(kind, n, rng):
    if kind == "int32_8":
        return rng.integers(0, 1 << 8, n).astype(np.int32), 8
    if kind == "int32_16":
        return rng.integers(0, 1 << 16, n).astype(np.int32), 16
    if kind == "int32_31":
        return rng.integers(0, 40, n).astype(np.int32), 31
    if kind == "int64_32":
        return rng.integers(0, 1 << 32, n).astype(np.int64), 32
    if kind == "int64_48":
        return rng.integers(0, 1 << 40, n).astype(np.int64), 48
    if kind == "int64_neg":
        return rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64), 64
    if kind == "int64_ties":
        return rng.integers(-3, 3, n).astype(np.int64), 64
    if kind == "float32":
        return (rng.integers(-400, 400, n) / 8.0).astype(np.float32), 64
    if kind == "float64":
        return (rng.integers(-(1 << 40), 1 << 40, n) / 8.0), 64
    raise AssertionError(kind)


def _assert_tie_rule(vals, valid, ref_out, port_out):
    rv, ri, rok = (np.asarray(x) for x in ref_out)
    pv, pi, pok = (x.numpy() for x in port_out)
    np.testing.assert_array_equal(pok, rok)
    np.testing.assert_array_equal(pv[pok], rv[rok])
    if not pok.any():
        return
    assert (vals[pi[pok]] == pv[pok]).all() and valid[pi[pok]].all()
    kth = pv[pok][-1]
    assert set(pi[pok][pv[pok] > kth]) == set(ri[rok][rv[rok] > kth])
    tie_class = set(np.flatnonzero(valid & (vals == kth)))
    assert set(pi[pok][pv[pok] == kth]) <= tie_class
    assert len(set(pi[pok])) == int(pok.sum())


@pytest.mark.parametrize("kind", ["int32_8", "int32_16", "int32_31",
                                  "int64_32", "int64_48", "int64_neg",
                                  "int64_ties", "float32", "float64"])
@pytest.mark.parametrize("k,n,p_valid", [(10, 3000, 0.6), (100, 3000, 0.6),
                                         (50, 40, 0.5), (64, 30, 1.0)])
def test_masked_topk_matches_reference(kind, k, n, p_valid):
    """Covers value_bits 8/16/31/32/48/64, negative ints, float32/64, heavy
    ties, fewer valid rows than k (n=40) and k > n (n=30)."""
    ensure_x64()
    rng = np.random.default_rng(zlib.crc32(f"{kind}-{k}-{n}".encode()))
    vals, vb = _values(kind, n, rng)
    valid = rng.random(n) < p_valid
    ref_out = ref_topk(jnp.asarray(vals), jnp.asarray(valid), k,
                       value_bits=vb)
    port_out = masked_topk(torch.from_numpy(vals), torch.from_numpy(valid),
                           k, value_bits=vb)
    assert len(port_out[0]) == min(k, n)
    _assert_tie_rule(vals, valid, ref_out, port_out)
    # the sort-based reference agrees on values and ok
    sv, _si, sok = masked_topk_sort(torch.from_numpy(vals),
                                    torch.from_numpy(valid), k)
    np.testing.assert_array_equal(sok.numpy(), port_out[2].numpy())
    np.testing.assert_array_equal(sv.numpy()[sok.numpy()],
                                  port_out[0].numpy()[port_out[2].numpy()])


def test_unfilled_seats_hold_the_sentinel():
    vals = torch.tensor([5, 3, 9, 1], dtype=torch.int64)
    valid = torch.tensor([True, False, True, False])
    v, i, ok = masked_topk(vals, valid, 3, value_bits=8)
    assert ok.tolist() == [True, True, False]
    assert v.tolist()[:2] == [9, 5] and i.tolist()[:2] == [2, 0]
    assert int(v[2]) == torch.iinfo(torch.int64).min
