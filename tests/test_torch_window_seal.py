"""Port parity: the incremental fire engine's seal and rebuild
(flink_tpu_torch/ops/window_seal.py) against the reference's
``_seal_program`` and ``_rebuild_program``
(flink_tpu/runtime/operators/device_window.py), and the merge tree of
flink_tpu_torch/ops/segment_ops.py against flink_tpu/ops/segment_ops.py.

Inputs are made with numpy from a seed and handed to both. Values are
small integers in every dtype, so every sum is exact in any order and the
comparison is exact (``==``), floats included. The reference's window
accumulator takes the dtype its sum promotes to (int64 for an int32
count); the port keeps an int32 count window, whose values the count
plane's width promises to fit, so values are compared in the port's
dtype and the port's dtypes are checked on their own.

The ``cuda``-marked tests hold the kernels of csrc/window_seal.cu against
the plain versions on the card and skip without one. The reference is
imported by a fixture, so on a machine with PyTorch alone the parity tests
skip and the card tests run:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_window_seal.py
"""

import types
import zlib

import numpy as np
import pytest
import torch

from flink_tpu_torch import KERNEL_LAUNCHES, reset_launches
from flink_tpu_torch.ops import segment_ops as seg
from flink_tpu_torch.ops.window_seal import rebuild, rebuild_plain, seal, \
    seal_plain
from flink_tpu_torch.runtime.operators.device_window import _window_dtype

RING, CAP = 8, 64
L = 8
DTYPES = {"int32": (np.int32, torch.int32), "int64": (np.int64, torch.int64),
          "float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}
KIND_DTYPES = [("sum", d) for d in DTYPES] + [("count", "int32"),
                                             ("count", "int64")] + \
    [(k, d) for k in ("min", "max") for d in DTYPES]


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, with 64-bit types on."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from flink_tpu.ops import segment_ops
    from flink_tpu.ops.hash_table import ensure_x64
    from flink_tpu.runtime.operators import device_window

    ensure_x64()
    return types.SimpleNamespace(jnp=jnp, seg=segment_ops,
                                 dw=device_window)


def _rng(*parts) -> np.random.Generator:
    """A generator seeded from the test's parameters (str hashes change
    from process to process; crc32 does not)."""
    return np.random.default_rng(zlib.crc32(repr(parts).encode()))


def _pane(rng, kind, np_dt, ring=RING, cap=CAP):
    """A [ring, cap] pane plane: small integers, a few slots and one row
    at the aggregate's identity (an untouched slot, a retired row)."""
    lo = 0 if kind == "count" else -50
    pane = rng.integers(lo, 50, (ring, cap)).astype(np_dt)
    ident = seg.identity(kind, DTYPES[np.dtype(np_dt).name][1])
    pane[:, rng.random(cap) < 0.2] = ident
    pane[rng.integers(0, ring)] = ident
    return pane


def _state(kind, pane, rng):
    """The port's state for ``pane``: a window (the reference's running
    accumulator is the same values) or a merge tree over random leaves."""
    t_dt = _window_dtype(kind, torch.from_numpy(pane[:1]).dtype)
    if kind in seg.INVERTIBLE_KINDS:
        lo = 0 if kind == "count" else -200
        return torch.from_numpy(rng.integers(lo, 200, pane.shape[1])).to(
            t_dt)
    leaves = torch.from_numpy(pane[rng.integers(0, RING, L)])
    return seg.merge_tree_build(kind, leaves)


def _ref_arrays(jnp, kind, pane, state):
    """The reference's inputs; ``state`` copied (``jnp.asarray`` of a
    tensor's numpy view shares its memory on the CPU, and the plain
    version writes it in place while the reference's program may still
    run)."""
    inv = kind in seg.INVERTIBLE_KINDS
    return ({"p": jnp.asarray(pane)},
            {"p": jnp.array(state.numpy())} if inv else {},
            {} if inv else {"p": jnp.array(state.numpy())},
            ((kind, "p"),) if inv else (),
            () if inv else ((kind, "p"),))


def _assert_equal(ref, got: torch.Tensor):
    want = np.asarray(ref).astype(got.numpy().dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# seal: (W, p_end, min_seen): W 1 (tumbling: the new row retires at
# once), W 5 with the retiring pane valid and not, and leaves that wrap
SEAL_CASES = {"w1": (1, 11, 0), "w5": (5, 11, 0),
              "w5_sub_invalid": (5, 11, 8), "w5_wrap": (5, 17, 0)}


@pytest.mark.parametrize("case", sorted(SEAL_CASES))
def test_seal_plain_equals_reference(case, ref):
    """Every kind and dtype, one plane at a time."""
    for kind, dtype in KIND_DTYPES:
        _check_seal(ref, kind, dtype, case)


def _check_seal(ref, kind, dtype, case):
    W, p_end, min_seen = SEAL_CASES[case]
    rng = _rng(kind, dtype, case)
    pane = _pane(rng, kind, DTYPES[dtype][0])
    state = _state(kind, pane, rng)
    arrays, wins, trees, inv_sig, tree_sig = _ref_arrays(ref.jnp, kind,
                                                         pane, state)
    new_row, sub_row = (p_end - 1) % RING, (p_end - W) % RING
    sub_valid = p_end - W >= min_seen
    new_leaf, old_leaf = (p_end - 1) % L, (p_end - 1 - W) % L
    ref_view, ref_wins, ref_trees = ref.dw._seal_program(inv_sig, tree_sig)(
        arrays, wins, trees, np.int32(new_row), np.int32(sub_row),
        np.bool_(sub_valid), np.int32(new_leaf), np.int32(old_leaf))
    view = torch.empty(CAP, dtype=state.dtype)
    pane_t = torch.from_numpy(pane)
    reset_launches()
    seal([(kind, pane_t, state, view)], new_row, sub_row, sub_valid,
         new_leaf, old_leaf)
    assert sum(KERNEL_LAUNCHES.values()) == 0   # the CPU runs the plain one
    _assert_equal(ref_view["p"], view)
    _assert_equal((ref_wins if kind in seg.INVERTIBLE_KINDS
                   else ref_trees)["p"], state)
    assert view.dtype == state.dtype == _window_dtype(kind, pane_t.dtype)
    assert torch.equal(pane_t, torch.from_numpy(pane))   # panes untouched


# rebuild: (W, p_end, min_seen)
REBUILD_CASES = {"w1": (1, 11, 0), "w5": (5, 11, 0),
                 "w5_partial": (5, 11, 8), "w7_wrap": (7, 21, 0)}


@pytest.mark.parametrize("case", sorted(REBUILD_CASES))
def test_rebuild_plain_equals_reference(case, ref):
    """Every kind and dtype, one plane at a time."""
    for kind, dtype in KIND_DTYPES:
        _check_rebuild(ref, kind, dtype, case)


def _check_rebuild(ref, kind, dtype, case):
    W, p_end, min_seen = REBUILD_CASES[case]
    rng = _rng(kind, dtype, case, 1)
    pane = _pane(rng, kind, DTYPES[dtype][0])
    state = _state(kind, pane, rng)
    arrays, _w, _t, inv_sig, tree_sig = _ref_arrays(ref.jnp, kind, pane,
                                                    state)
    first = max(p_end - W, min_seen)
    panes = list(range(first, p_end))
    rows, leaves = [p % RING for p in panes], [p % L for p in panes]
    sub_row, sub_valid = (p_end - W) % RING, p_end - W >= min_seen
    pane_rows = np.zeros(RING, np.int32)
    rows_valid = np.zeros(RING, bool)
    pane_leaves = np.zeros(RING, np.int32)
    pane_rows[:len(rows)] = rows
    rows_valid[:len(rows)] = True
    pane_leaves[:len(rows)] = leaves
    jnp = ref.jnp
    ref_view, ref_wins, ref_trees = ref.dw._rebuild_program(
        inv_sig, tree_sig, L)(arrays, jnp.asarray(pane_rows),
                              jnp.asarray(rows_valid),
                              jnp.asarray(pane_leaves), np.int32(sub_row),
                              np.bool_(sub_valid))
    view = torch.empty(CAP, dtype=state.dtype)
    rebuild([(kind, torch.from_numpy(pane), state, view)], rows, leaves,
            sub_row, sub_valid)
    _assert_equal(ref_view["p"], view)
    _assert_equal((ref_wins if kind in seg.INVERTIBLE_KINDS
                   else ref_trees)["p"], state)


def test_seal_after_rebuild_follows_full_merge():
    """A rebuild, then seals fire after fire across a ring wrap, against
    the full merge of each window: every plane kind in one signature."""
    rng = np.random.default_rng(11)
    W, ring, cap = 5, 8, 40
    kinds = [("count", torch.int32), ("sum", torch.int32),
             ("sum", torch.float64), ("min", torch.int64),
             ("max", torch.float32)]
    # one pane's rows per pane number, written into its ring row when the
    # pane opens (after the row's previous pane retired)
    data = {p: [rng.integers(0, 30, cap) for _ in kinds]
            for p in range(30)}
    panes = [seg.make_accumulator(k, (ring, cap), dt, "cpu")
             for k, dt in kinds]
    states = [seg.make_accumulator(k, (cap,), _window_dtype(k, dt), "cpu")
              if k in seg.INVERTIBLE_KINDS else
              seg.make_accumulator(k, (2 * ring, cap), dt, "cpu")
              for k, dt in kinds]

    def planes():
        return [(k, pane, st, torch.empty(cap, dtype=st.dtype))
                for (k, _dt), pane, st in zip(kinds, panes, states)]

    for p in range(W):
        for j, pane in enumerate(panes):
            pane[p % ring] = torch.from_numpy(data[p][j])
    for p_end in range(W, 26):
        sig = planes()
        if p_end == W:
            rebuild(sig, [p % ring for p in range(0, p_end)],
                    [p % ring for p in range(0, p_end)], 0, True)
        else:
            seal(sig, (p_end - 1) % ring, (p_end - W) % ring, True,
                 (p_end - 1) % ring, (p_end - 1 - W) % ring)
        for (k, _dt), pane, (_k, _p, _s, view) in zip(kinds, panes, sig):
            rows = [p % ring for p in range(p_end - W, p_end)]
            want = seg.AGG_MERGES[k](pane[rows])
            assert torch.equal(view, want.to(view.dtype)), (k, p_end)
        # retire the window's first pane, open the next one
        for j, (k, dt) in enumerate(kinds):
            panes[j][(p_end - W) % ring] = seg.identity(k, dt)
            panes[j][p_end % ring] = torch.from_numpy(data[p_end][j])


@pytest.mark.parametrize("kind", ["min", "max", "sum"])
def test_merge_tree_equals_reference(kind, ref):
    for n_leaves in (1, 2, 8, 16):
        _check_merge_tree(ref, kind, n_leaves)


def _check_merge_tree(ref, kind, n_leaves):
    jnp, ref_seg = ref.jnp, ref.seg
    rng = np.random.default_rng(n_leaves)
    leaves = rng.integers(-100, 100, (n_leaves, 33)).astype(np.int64)
    tree = seg.merge_tree_build(kind, torch.from_numpy(leaves))
    want = ref_seg.merge_tree_build(kind, jnp.asarray(leaves))
    np.testing.assert_array_equal(tree.numpy(), np.asarray(want))
    assert torch.equal(seg.merge_tree_root(tree),
                       torch.from_numpy(np.array(
                           ref_seg.merge_tree_root(want))))
    for pos in rng.integers(0, n_leaves, 4):
        value = rng.integers(-100, 100, 33).astype(np.int64)
        got = seg.merge_tree_update(kind, tree, int(pos),
                                    torch.from_numpy(value))
        assert got is tree   # in place
        want = ref_seg.merge_tree_update(kind, want, jnp.int32(pos),
                                         jnp.asarray(value))
        np.testing.assert_array_equal(tree.numpy(), np.asarray(want))


def test_invertible_tables_match_reference(ref):
    jnp, ref_seg = ref.jnp, ref.seg
    assert seg.INVERTIBLE_KINDS == ref_seg.INVERTIBLE_KINDS
    a, b = torch.tensor([7, -3]), torch.tensor([2, 5])
    for kind in seg.INVERTIBLE_KINDS:
        np.testing.assert_array_equal(
            seg.AGG_INVERT[kind](a, b).numpy(),
            np.asarray(ref_seg.AGG_INVERT[kind](jnp.asarray(a.numpy()),
                                                jnp.asarray(b.numpy()))))


def test_signature_checks():
    pane = torch.zeros((8, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        seal([("max", pane, torch.zeros((12, 16), dtype=torch.int64),
               torch.empty(16, dtype=torch.int64))], 0, 1, True, 0, 1)
    with pytest.raises(ValueError, match="cannot accumulate"):
        seal([("sum", pane, torch.zeros(16, dtype=torch.int32),
               torch.empty(16, dtype=torch.int32))], 0, 1, True, 0, 1)
    with pytest.raises(ValueError, match="1 to 8 planes"):
        rebuild([], [], [], 0, False)


# -- the kernels, on the card ----------------------------------------------
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _card_planes(dev, kinds, ring, cap, seed):
    """(kernel planes, plain planes) with equal contents: every kind and
    dtype of ``kinds`` over one ring, trees of L = pow2_ceil(ring)."""
    rng = np.random.default_rng(seed)
    Lc = seg.pow2_ceil(ring)
    a, b = [], []
    for kind, dt in kinds:
        np_dt = DTYPES[str(dt).split(".")[1]][0]
        pane = torch.from_numpy(_pane(rng, kind, np_dt, ring, cap)).to(dev)
        wdt = _window_dtype(kind, dt)
        if kind in seg.INVERTIBLE_KINDS:
            st = torch.from_numpy(rng.integers(-9, 9, cap)).to(dev).to(wdt)
        else:
            st = seg.merge_tree_build(kind, pane[torch.from_numpy(
                rng.integers(0, ring, Lc)).to(dev)])
        a.append((kind, pane, st.clone(), torch.empty(cap, dtype=wdt,
                                                        device=dev)))
        b.append((kind, pane, st.clone(), torch.empty(cap, dtype=wdt,
                                                        device=dev)))
    return a, b


ALL_CARD = [(k, getattr(torch, d)) for k, d in KIND_DTYPES if k != "count"]
#: signature groups of the card tests: the two paths', and every kind and
#: dtype in two signatures of at most 8 planes
CARD_SIGS = {
    "paths": ([("count", torch.int32), ("sum", torch.int64)],
              [("count", torch.int64), ("max", torch.int64)]),
    "every_kind": (ALL_CARD[:8], ALL_CARD[8:] + [("count", torch.int32)]),
}


def _assert_planes_equal(got, want, what):
    torch.cuda.synchronize()
    for (k, _p, gs, gv), (_k2, _p2, ws, wv) in zip(got, want):
        assert torch.equal(gv, wv) and torch.equal(gs, ws), (k, what)


@pytest.mark.cuda
@pytest.mark.parametrize("group", sorted(CARD_SIGS))
def test_seal_kernel_equals_plain(dev, group):
    """W = 1 and 5, the retiring pane valid and not, capacities of one
    slot, a ragged grid and 2^16, leaves that wrap."""
    ring = 16
    Lc = seg.pow2_ceil(ring)
    for sig in CARD_SIGS[group]:
        for W, sub_valid in ((1, True), (5, True), (5, False)):
            for cap in (1, 1000, 1 << 16):
                got, want = _card_planes(dev, sig, ring, cap, cap + W)
                for p_end in (9, 23, 40):
                    args = ((p_end - 1) % ring, (p_end - W) % ring,
                            sub_valid, (p_end - 1) % Lc,
                            (p_end - 1 - W) % Lc)
                    reset_launches()
                    seal(got, *args)
                    assert KERNEL_LAUNCHES["window_seal"] == 1
                    seal_plain(want, *args)
                    _assert_planes_equal(got, want, (W, sub_valid, cap,
                                                     p_end))


@pytest.mark.cuda
@pytest.mark.parametrize("group", sorted(CARD_SIGS))
def test_rebuild_kernel_equals_plain(dev, group):
    """1, 5 and 20 live rows of a 46-row ring (64 leaves), the first
    pane of the window present or not; and 128 rows of bench.py's ring
    for a 128-pane window (2W + 6 = 262 rows, 512 leaves)."""
    cap, p_end = 5000, 300
    for sig in CARD_SIGS[group]:
        for ring, W, first_gap in ((46, 1, 0), (46, 5, 0), (46, 5, 3),
                                   (46, 20, 0), (262, 128, 0)):
            Lc = seg.pow2_ceil(ring)
            got, want = _card_planes(dev, sig, ring, cap, W + first_gap)
            panes = range(p_end - W + first_gap, p_end)
            args = ([p % ring for p in panes], [p % Lc for p in panes],
                    (p_end - W) % ring, first_gap == 0)
            reset_launches()
            rebuild(got, *args)
            assert KERNEL_LAUNCHES["window_rebuild"] == 1
            rebuild_plain(want, *args)
            _assert_planes_equal(got, want, (W, first_gap))

