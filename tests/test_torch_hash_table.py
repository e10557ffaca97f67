"""Port parity: device hash table (flink_tpu_torch/ops/hash_table.py vs
flink_tpu/ops/hash_table.py).

Inputs are numpy arrays made from a seed and fed to both. Tolerance:
exact (integers). On the CPU the port runs its plain version, which is
the reference's algorithm, so slot layouts match too; the CUDA kernel's
layout differs and is held to the set semantics on the card
(tests/test_torch_kernels.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from flink_tpu.ops import hash_table as ref  # noqa: E402
from flink_tpu_torch.ops import hash_table as port  # noqa: E402

I64 = np.iinfo(np.int64)


def _keys(seed, n, distinct):
    rng = np.random.default_rng(seed)
    pool = rng.integers(I64.min, I64.max, distinct, dtype=np.int64)
    pool[:4] = [0, -1, I64.min, I64.max - 1]
    return pool[rng.integers(0, distinct, n)]


def test_hash_keys_bit_equal():
    ref.ensure_x64()
    keys = np.concatenate([
        _keys(0, 4000, 4000),
        np.array([0, 1, -1, I64.max, I64.min, 1 << 32, -(1 << 32),
                  (1 << 32) - 1], np.int64)])
    want = np.asarray(ref.hash_keys_device(jnp.asarray(keys))).astype(
        np.int64)
    got = port.hash_keys_device(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap,distinct", [(64, 30), (1024, 500)])
def test_lookup_or_insert_matches_reference(cap, distinct):
    """Duplicates and invalid rows: same ok mask, same key set, and (the
    plain version being the reference algorithm) the same slots."""
    ref.ensure_x64()
    keys = _keys(1, 3 * distinct, distinct)
    valid = np.random.default_rng(2).random(len(keys)) < 0.8
    rt, rs, rok = ref.lookup_or_insert(ref.make_table(cap),
                                       jnp.asarray(keys), jnp.asarray(valid))
    pt, ps, pok = port.lookup_or_insert(port.make_table(cap, "cpu"),
                                        torch.from_numpy(keys),
                                        torch.from_numpy(valid))
    rt, rs, rok = np.asarray(rt), np.asarray(rs), np.asarray(rok)
    pt, ps, pok = pt.numpy(), ps.numpy(), pok.numpy()
    np.testing.assert_array_equal(pok, rok)
    assert pok[valid].all() and not pok[~valid].any()
    assert (ps[~valid] == -1).all()
    assert (pt[ps[pok]] == keys[pok]).all()
    occupied = np.sort(pt[pt != port.EMPTY_KEY])
    np.testing.assert_array_equal(occupied, np.unique(keys[valid]))
    np.testing.assert_array_equal(pt, rt)
    np.testing.assert_array_equal(ps, rs)
    # lookup: every present key at its slot, absent keys -1
    probe = np.concatenate([keys, np.array([123456789, -987654321])])
    want = np.asarray(ref.lookup(jnp.asarray(rt), jnp.asarray(probe)))
    got = port.lookup(torch.from_numpy(pt), torch.from_numpy(probe)).numpy()
    np.testing.assert_array_equal(got, want)
    present = np.isin(probe, keys[valid])
    assert (got[~present] == -1).all() and (got[present] >= 0).all()


def test_sentinel_key_remapped_like_reference():
    ref.ensure_x64()
    keys = np.array([I64.max, I64.max - 1, 0, I64.max], np.int64)
    want = np.asarray(ref.sanitize_keys_device(jnp.asarray(keys)))
    got = port.sanitize_keys_device(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(got, want)
    table, slots, ok = port.lookup_or_insert(
        port.make_table(8, "cpu"), torch.from_numpy(got))
    assert ok.all() and (table != port.EMPTY_KEY).sum() == 2


def test_overflow_reports_not_ok_at_tiny_capacity():
    """More distinct keys than slots: the overflowing rows report ok False
    with slot -1, exactly where the reference does."""
    ref.ensure_x64()
    keys = np.arange(20, dtype=np.int64) * 7919
    _, rs, rok = ref.lookup_or_insert(ref.make_table(8), jnp.asarray(keys))
    table, ps, pok = port.lookup_or_insert(port.make_table(8, "cpu"),
                                           torch.from_numpy(keys))
    np.testing.assert_array_equal(pok.numpy(), np.asarray(rok))
    assert int(pok.sum()) == 8 and (table != port.EMPTY_KEY).all()
    assert (ps.numpy()[~pok.numpy()] == -1).all()


def test_wrapper_refuses_devices_without_a_kernel():
    """No quiet fallback: a tensor that is neither on the CPU nor on CUDA
    is refused, never routed to the plain version."""
    table = torch.full((8,), port.EMPTY_KEY, dtype=torch.int64,
                       device="meta")
    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        port.lookup_or_insert(table, keys)
