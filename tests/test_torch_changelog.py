"""Port parity of the changelog state backend and its durable log
(``state/changelog.py``, ``state/dstl.py``,
``checkpoint/coordinator.py::savepoint_self_contained``) against the
reference, on the changelog half of tests/test_unaligned_changelog.py:

* snapshots of the change since the base, the log replayed on restore,
  the materialization interval, a restore filtered by key group;
* the fs driver: bytes in proportion to the change, batched segment
  uploads, truncation on subsumption only (failed checkpoints, savepoint
  pins, slow savepoints), relocatable handles, self-contained savepoints,
  the inline form of older snapshots, digests;
* ``changelog-dstl`` snapshots equal to the reference's field by field
  (handles resolved: a base's and a segment's names carry random ids),
  and restored across the packages both ways;
* ``state.backend: changelog`` through a job at parallelism 2.

Values are integers and lists of integers, seeded with numpy; every
comparison is exact.
"""

import os
import pickle
import shutil
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.checkpoint.coordinator as ref_coord  # noqa: E402
import flink_tpu.core.config as ref_config  # noqa: E402
import flink_tpu.core.functions as ref_fn  # noqa: E402
import flink_tpu.core.keygroups as ref_kg  # noqa: E402
import flink_tpu.core.records as ref_rec  # noqa: E402
import flink_tpu.state.changelog as ref_cl  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
import flink_tpu.state.dstl as ref_dstl  # noqa: E402
from flink_tpu.api.environment import \
    StreamExecutionEnvironment as RefEnv  # noqa: E402
import flink_tpu_torch.checkpoint.coordinator as port_coord  # noqa: E402
import flink_tpu_torch.core.config as port_config  # noqa: E402
import flink_tpu_torch.core.functions as port_fn  # noqa: E402
import flink_tpu_torch.core.keygroups as port_kg  # noqa: E402
import flink_tpu_torch.core.records as port_rec  # noqa: E402
import flink_tpu_torch.state.changelog as port_cl  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
import flink_tpu_torch.state.dstl as port_dstl  # noqa: E402
from flink_tpu_torch.api.environment import \
    StreamExecutionEnvironment as PortEnv  # noqa: E402

SIDES = {
    "ref": types.SimpleNamespace(
        cl=ref_cl, dstl=ref_dstl, desc=ref_desc, kg=ref_kg, coord=ref_coord,
        config=ref_config, fn=ref_fn, rec=ref_rec,
        env=lambda: RefEnv()),
    "port": types.SimpleNamespace(
        cl=port_cl, dstl=port_dstl, desc=port_desc, kg=port_kg,
        coord=port_coord, config=port_config, fn=port_fn, rec=port_rec,
        env=lambda: PortEnv(device="cpu")),
}
SEED = 31


def both(fn, *a, **kw):
    got = {name: fn(side, *a, **kw) for name, side in SIDES.items()}
    assert got["ref"] == got["port"], got
    return got["port"]


def backend(side, lo=0, hi=127, store_dir=None, **kw):
    b = side.cl.ChangelogKeyedStateBackend(side.kg.KeyGroupRange(lo, hi),
                                           128, **kw)
    if store_dir is not None:
        b._store = side.dstl.FsChangelogStorage(str(store_dir))
        b._writer.store = b._store
    return b


def put(b, key, value, desc):
    b.set_current_key(key)
    b.get_partitioned_state(desc).update(value)


def value(b, key, desc):
    b.set_current_key(key)
    return b.get_partitioned_state(desc).value()


def records(side, snap, root=None) -> list:
    out = []
    for h in snap["segments"]:
        for seq, (op, name, kg, payload, expiry) in \
                side.dstl.read_any_segment(h, root):
            if seq > snap["base_seq"]:
                out.append((seq, op, name, kg, pickle.loads(payload),
                            expiry))
    return sorted(out)


def resolved(side, snap, root=None) -> dict:
    """A ``changelog-dstl`` snapshot with its handles read: the base's
    content and the records past it, field by field."""
    base = (pickle.loads(side.dstl.read_any_base(snap["driver"],
                                                 snap["base"], root))
            if snap.get("base") is not None else None)
    return {"kind": snap["kind"], "driver": snap["driver"],
            "base_seq": snap["base_seq"], "mat_id": snap["mat_id"],
            "base": base, "records": records(side, snap, root),
            "segment_fields": sorted(
                sorted(k for k in h if k not in ("segment_id", "location",
                                                 "digest"))
                for h in snap["segments"])}


def seeded(n: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    return [(int(k), int(v)) for k, v in
            zip(rng.integers(0, 10_000, n), rng.integers(-500, 500, n))]


# -- the backend ------------------------------------------------------------

def test_snapshot_is_the_change_since_the_base():
    def run(side):
        b = backend(side, materialization_interval=10)
        desc = side.desc.ValueStateDescriptor("counter")
        for i in range(100):
            put(b, i, i * 2, desc)
        s1 = b.snapshot(1)
        put(b, 5, 999, desc)
        s2 = b.snapshot(2)
        assert s2["base"] == s1["base"]       # shared by handle
        return (s1["kind"], s1["segments"], resolved(side, s2))

    got = both(run)
    assert got[0] == "changelog-dstl" and got[1] == []
    assert [r[1:5] for r in got[2]["records"]] == [
        ("put", "counter", port_kg.assign_to_key_group(5, 128),
         (5, None, 999))]


def test_restore_replays_puts_and_removes():
    def run(side):
        b = backend(side, materialization_interval=10)
        desc = side.desc.ValueStateDescriptor("counter")
        lst = side.desc.ListStateDescriptor("seen")
        put(b, 1, 100, desc)
        b.snapshot(1)
        put(b, 1, 200, desc)
        put(b, 2, 50, desc)
        b.set_current_key(2)
        b.get_partitioned_state(desc).clear()
        b.set_current_key(3)
        for v in (4, 5, 6):
            b.get_partitioned_state(lst).add(v)
        snap = b.snapshot(2)
        b2 = backend(side)
        b2.restore([snap])
        got = (value(b2, 1, desc), value(b2, 2, desc))
        b2.set_current_key(3)
        return (len(records(side, snap)), *got,
                b2.get_partitioned_state(lst).get())

    assert both(run) == (6, 200, None, [4, 5, 6])


def test_materialization_interval():
    def run(side):
        b = backend(side, materialization_interval=2)
        desc = side.desc.ValueStateDescriptor("x")
        out = []
        for cid in (1, 2, 3):
            put(b, 1, cid, desc)
            s = b.snapshot(cid)
            out.append((s["mat_id"], len(s["segments"])))
        return out

    assert both(run) == [(1, 0), (1, 1), (2, 0)]


def test_restore_filters_key_groups_on_a_rescale():
    pairs = seeded(200)

    def run(side):
        b = backend(side, materialization_interval=100)
        desc = side.desc.ValueStateDescriptor("x")
        for k, v in pairs:
            put(b, k, v, desc)
        b.snapshot(1)
        for k, v in pairs:
            put(b, k, v + 1000, desc)
        snap = b.snapshot(2)
        lo, hi = backend(side, 0, 63), backend(side, 64, 127)
        lo.restore([snap])
        hi.restore([snap])
        return sorted(list(lo.entries("x")) + list(hi.entries("x")))

    got = both(run)
    assert got == sorted({((k, None), v + 1000) for k, v in
                          dict(pairs).items()})


def test_snapshots_equal_field_by_field():
    pairs = seeded(300, SEED + 1)

    def run(side):
        b = backend(side, materialization_interval=3, flush_bytes=512)
        desc = side.desc.ValueStateDescriptor("v")
        lst = side.desc.ListStateDescriptor("l")
        out = []
        for cid in range(1, 6):
            for k, v in pairs[(cid - 1) * 60:cid * 60]:
                put(b, k, v * cid, desc)
                b.set_current_key(k % 17)
                b.get_partitioned_state(lst).add(v)
            out.append(resolved(side, b.snapshot(cid)))
            b.notify_checkpoint_complete(cid)
        return out

    got = both(run)
    # the list state's base copies hold the values of their snapshot
    assert got[3]["base"]["states"]["l"]


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_snapshots_restore_across_the_packages(direction, tmp_path):
    pairs = seeded(120, SEED + 2)
    src, dst = (("ref", "port") if direction == "ref_to_port"
                else ("port", "ref"))
    a, b_ = SIDES[src], SIDES[dst]
    b = backend(a, store_dir=tmp_path, materialization_interval=5)
    desc = a.desc.ValueStateDescriptor("v")
    for k, v in pairs[:60]:
        put(b, k, v, desc)
    b.snapshot(1)
    for k, v in pairs[60:]:
        put(b, k, -v, desc)
    b.set_current_key(pairs[0][0])
    b.get_partitioned_state(desc).clear()
    snap = b.snapshot(2)
    c = backend(b_, store_dir=tmp_path)
    c.restore([pickle.loads(pickle.dumps(snap))])
    want = dict(pairs[:60])
    want.update({k: -v for k, v in pairs[60:]})
    want.pop(pairs[0][0])
    assert sorted((kn[0], v) for kn, v in c.entries("v")) == \
        sorted(want.items())


def test_changelog_backend_through_a_job():
    rows = [(i % 5, i) for i in range(50)]

    def run(side):
        class Count(side.fn.ProcessFunction):
            def open(self, ctx):
                self.state = ctx.get_state(
                    side.desc.ValueStateDescriptor("cnt", default=0))

            def process_element(self, value, ctx, out):
                c = self.state.value() + 1
                self.state.update(c)
                out.collect((value[0], c))

        env = side.env()
        env.set_parallelism(2)
        env.set_state_backend("changelog")
        sch = side.rec.Schema([("k", np.int64), ("v", np.int64)])
        ds = env.from_collection(rows, sch, timestamps=list(range(50)))
        out = ds.key_by("k").process(Count()).execute_and_collect("cl")
        finals: dict = {}
        for k, c in out:
            finals[int(k)] = max(finals.get(int(k), 0), int(c))
        return finals

    assert both(run) == {i: 10 for i in range(5)}


# -- the durable log ---------------------------------------------------------

def test_fs_bytes_follow_the_change_and_restore_from_handles(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        b = backend(side, store_dir=root, materialization_interval=10)
        desc = side.desc.ValueStateDescriptor("counter")
        for i in range(5000):
            put(b, i, i * 2, desc)
        s1 = b.snapshot(1)
        assert not os.path.isabs(s1["base"])
        base_size = os.path.getsize(os.path.join(root, s1["base"]))
        put(b, 7, 999, desc)
        s2 = b.snapshot(2)
        seg = sum(os.path.getsize(os.path.join(root, h["location"]))
                  for h in s2["segments"])
        b2 = backend(side, store_dir=root)
        b2.restore([s2])
        return (s2["base"] == s1["base"], seg < base_size / 50,
                value(b2, 7, desc), value(b2, 4999, desc))

    assert both(run) == (True, True, 999, 9998)


def test_batched_uploads_and_truncation_on_subsumption(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        b = backend(side, store_dir=root, materialization_interval=2,
                    flush_bytes=256)
        desc = side.desc.ValueStateDescriptor("x")
        b.snapshot(1)
        b.notify_checkpoint_complete(1)
        for i in range(100):
            put(b, i, i, desc)
        flushed = b._writer.segments_uploaded
        s2 = b.snapshot(2)
        uploads = b._writer.segments_uploaded
        b.notify_checkpoint_complete(2)
        s3 = b.snapshot(3)
        # 3 has not completed: generation 1 still serves s2
        b2 = backend(side, store_dir=root)
        b2.restore([s2])
        before = value(b2, 42, desc)
        b.notify_checkpoint_complete(3)
        files = os.listdir(root)
        return (flushed > 1, len(s2["segments"]) == uploads, s3["mat_id"],
                s3["segments"], before,
                [f for f in files if f.startswith("seg-")],
                len([f for f in files if f.startswith("base-")]))

    assert both(run) == (True, True, 2, [], 42, [], 1)


def test_failed_checkpoints_keep_the_last_completed_one(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        b = backend(side, store_dir=root, materialization_interval=1)
        desc = side.desc.ValueStateDescriptor("x")
        for i in range(50):
            put(b, i, i * 3, desc)
        s1 = b.snapshot(1)
        b.notify_checkpoint_complete(1)
        for cid in range(2, 10):
            put(b, cid, cid, desc)
            b.snapshot(cid)                    # never completes
        b2 = backend(side, store_dir=root)
        b2.restore([s1])
        return value(b2, 42, desc)

    assert both(run) == 126


def test_relocated_directory_restores(tmp_path):
    def run(side):
        tag = side.cl.__name__.split(".")[0]
        src, dst = tmp_path / tag / "a", tmp_path / tag / "b"
        b = backend(side, store_dir=src, materialization_interval=10,
                    flush_bytes=128)
        desc = side.desc.ValueStateDescriptor("x")
        b.snapshot(1)
        for i in range(30):
            put(b, i, i + 7, desc)
        s2 = b.snapshot(2)
        shutil.move(str(src), str(dst))
        b2 = backend(side, store_dir=dst)
        b2.restore([s2])
        return ([h["location"].startswith("/") for h in s2["segments"]],
                value(b2, 3, desc))

    got = both(run)
    assert not any(got[0]) and got[1] == 10


def test_savepoint_is_self_contained(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        store = root / "ckpt" / "changelog"
        b = backend(side, store_dir=store, materialization_interval=10)
        desc = side.desc.ValueStateDescriptor("x")
        for i in range(20):
            put(b, i, i * 5, desc)
        sp = b.snapshot(1)
        cfg = side.config.Configuration()
        cfg.set("execution.checkpointing.dir", str(root / "ckpt"))
        acks = {"t0": {"chain": {"op": {"keyed": {"backend": sp}}}}}
        inline = side.coord.savepoint_self_contained(acks, cfg)[
            "t0"]["chain"]["op"]["keyed"]["backend"]
        shutil.rmtree(store)
        b2 = backend(side)
        b2.restore([inline])
        return inline["kind"], len(inline["log"]), value(b2, 4, desc)

    assert both(run) == ("changelog", 0, 20)


def test_inline_snapshot_of_an_older_build_restores():
    def run(side):
        legacy = {"kind": "changelog", "mat_id": 1, "mat": None,
                  "log": [("put", "counter",
                           side.kg.assign_to_key_group(1, 128),
                           pickle.dumps((1, None, 42)), None),
                          ("put", "counter",
                           side.kg.assign_to_key_group(2, 128),
                           pickle.dumps((2, None, 7)), None),
                          ("rm", "counter",
                           side.kg.assign_to_key_group(2, 128),
                           pickle.dumps((2, None)), None)]}
        b = backend(side)
        b.restore([legacy])
        desc = side.desc.ValueStateDescriptor("counter")
        return value(b, 1, desc), value(b, 2, desc)

    assert both(run) == (42, None)


def test_savepoint_pins_neither_evict_nor_age_out(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        b = backend(side, store_dir=root, materialization_interval=1)
        desc = side.desc.ValueStateDescriptor("x")
        for i in range(30):
            put(b, i, i * 2, desc)
        s5 = b.snapshot(5)
        b.notify_checkpoint_complete(5)
        put(b, 99, 1, desc)
        b.snapshot(6)                          # a savepoint
        b.notify_checkpoint_complete(6, is_savepoint=True)
        b2 = backend(side, store_dir=root)
        b2.restore([s5])
        first = value(b2, 7, desc)
        sp = b.snapshot(7)                     # a slow savepoint
        for cid in range(8, 60):
            put(b, cid, cid, desc)
            b.snapshot(cid)
            b.notify_checkpoint_complete(cid)
        b3 = backend(side, store_dir=root)
        b3.restore([sp])
        b.notify_checkpoint_complete(7, is_savepoint=True)
        b.snapshot(200)
        b.notify_checkpoint_aborted(200)
        return first, value(b3, 7, desc), sorted(b._ckpt_gen)

    assert both(run) == (14, 14, [])


def test_a_corrupt_segment_fails_its_digest(tmp_path):
    def run(side):
        root = tmp_path / side.cl.__name__.split(".")[0]
        b = backend(side, store_dir=root, materialization_interval=10)
        desc = side.desc.ValueStateDescriptor("x")
        b.snapshot(1)
        for i in range(10):
            put(b, i, i, desc)
        s2 = b.snapshot(2)
        (h,) = s2["segments"]
        path = os.path.join(root, h["location"])
        data = bytearray(open(path, "rb").read())
        data[len(data) // 2] ^= 0x40
        open(path, "wb").write(bytes(data))
        with pytest.raises(Exception, match="checksum"):
            backend(side, store_dir=root).restore([s2])
        return h["digest"] != "", h["from_seq"], h["to_seq"]

    assert both(run) == (True, 1, 10)


def test_in_memory_driver_and_config_keys():
    def run(side):
        cfg = side.config.Configuration()
        cfg.set("state.backend.changelog.materialization-interval", 3)
        cfg.set("execution.checkpointing.num-retained", 2)
        b = side.cl.ChangelogKeyedStateBackend(
            side.kg.KeyGroupRange(0, 127), 128, config=cfg)
        desc = side.desc.ValueStateDescriptor("x")
        mats = []
        for cid in range(1, 8):
            put(b, cid, cid, desc)
            mats.append(b.snapshot(cid)["mat_id"])
            b.notify_checkpoint_complete(cid)
        return b._store.driver, b._mat_interval, b._retained, mats

    assert both(run) == ("mem", 3, 2, [1, 1, 1, 2, 2, 2, 3])
