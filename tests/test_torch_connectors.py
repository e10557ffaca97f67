"""Port parity: the file systems, plugins and connectors of
flink_tpu_torch (``core/fs.py``, ``core/plugins.py``,
``connectors/file.py``, ``log.py``, ``log_net.py``, ``socket.py``,
``utils/auth.py``) and their SQL wiring (``sql/ddl.py``,
``sql/table_env.py``) against flink_tpu's.

* The local and ``mem://`` file systems, a registered scheme, and plugins
  loaded as isolated modules (a plugin connector used from SQL).
* FileSink's in-progress -> pending -> committed protocol, stale-file
  cleanup and size rolls; FileSource's directories, globs and scheme
  globs; reader and writer snapshots restored across the packages both
  ways.
* The log: offsets a partition resumed, transactions idempotent after a
  restore; the network broker and the socket source on loopback.
* SQL filesystem, log, socket and print tables give the reference's rows.
* A tiny Q5 read from a columnar file through the port's runtime on the
  CPU equals the reference's rows under the ROADMAP tie rule, and the
  connectors phase of chip_smoke.py runs tiny in a subprocess where jax
  and flink_tpu cannot be imported.
* The kept difference: the reference's binary reader loses frames larger
  than its 1 MiB read and snapshots past the bytes it holds, so a restore
  taken mid-frame fails; the port reads every row and its ``pos`` is the
  first byte not yet decoded.

Every socket binds port 0 on loopback and every ``mem://`` path has a
prefix of its own, so the tests run side by side. Tolerance: exact.
"""

import importlib.util
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import uuid
from collections import defaultdict

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.connectors.file as ref_file  # noqa: E402
import flink_tpu.connectors.log as ref_log  # noqa: E402
import flink_tpu.connectors.socket as ref_socket  # noqa: E402
import flink_tpu.core.fs as ref_fs  # noqa: E402
import flink_tpu.core.records as ref_records  # noqa: E402
import flink_tpu.formats.columnar as ref_col  # noqa: E402
import flink_tpu.formats.core as ref_fmt  # noqa: E402
import flink_tpu.metrics.reporters as ref_reporters  # noqa: E402
import flink_tpu.sql as ref_sql  # noqa: E402
import flink_tpu.sql.ddl as ref_ddl  # noqa: E402
from flink_tpu.api import StreamExecutionEnvironment as RefEnv  # noqa: E402
from flink_tpu.core import WatermarkStrategy as RefWS  # noqa: E402
from flink_tpu.core.config import Configuration as RefConfiguration  # noqa: E402
from flink_tpu.core.plugins import PluginManager as RefPlugins  # noqa: E402
from flink_tpu.runtime.operators.device_window import \
    AggSpec as RefAggSpec  # noqa: E402
from flink_tpu.window import SlidingEventTimeWindows as RefSliding  # noqa: E402
import flink_tpu_torch.connectors.file as port_file  # noqa: E402
import flink_tpu_torch.connectors.log as port_log  # noqa: E402
import flink_tpu_torch.connectors.socket as port_socket  # noqa: E402
import flink_tpu_torch.core.fs as port_fs  # noqa: E402
import flink_tpu_torch.core.records as port_records  # noqa: E402
import flink_tpu_torch.formats.columnar as port_col  # noqa: E402
import flink_tpu_torch.formats.core as port_fmt  # noqa: E402
import flink_tpu_torch.metrics.reporters as port_reporters  # noqa: E402
import flink_tpu_torch.sql as port_sql  # noqa: E402
import flink_tpu_torch.sql.ddl as port_ddl  # noqa: E402
from flink_tpu_torch.api import StreamExecutionEnvironment  # noqa: E402
from flink_tpu_torch.connectors.log_net import LogBrokerServer, \
    RemoteLogBroker  # noqa: E402
from flink_tpu_torch.core import Configuration, WatermarkStrategy  # noqa: E402
from flink_tpu_torch.core.plugins import PluginManager  # noqa: E402
from flink_tpu_torch.runtime.operators import AggSpec  # noqa: E402
from flink_tpu_torch.window import SlidingEventTimeWindows  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
REF = {"file": ref_file, "log": ref_log, "socket": ref_socket,
       "fs": ref_fs, "records": ref_records, "col": ref_col,
       "fmt": ref_fmt, "sql": ref_sql, "ddl": ref_ddl,
       "reporters": ref_reporters, "config": RefConfiguration}
PORT = {"file": port_file, "log": port_log, "socket": port_socket,
        "fs": port_fs, "records": port_records, "col": port_col,
        "fmt": port_fmt, "sql": port_sql, "ddl": port_ddl,
        "reporters": port_reporters, "config": Configuration}
SIDES = (REF, PORT)
KV = [("k", np.int64), ("v", np.int64)]


def _tag() -> str:
    return uuid.uuid4().hex[:10]


def _env(side, **config):
    if side is REF:
        env = RefEnv()
        for k, v in config.items():
            env.config.set(k, v)
        return env
    return StreamExecutionEnvironment(Configuration(config), device="cpu")


def _kv(side, lo, hi):
    rec = side["records"]
    k = np.arange(lo, hi, dtype=np.int64)
    return rec.RecordBatch(rec.Schema(KV), {"k": k, "v": k * 7 - 3})


def _read_all(reader, limit=1 << 12) -> list:
    rows = []
    while (b := reader.read_batch(limit)) is not None:
        rows.extend(b.iter_rows())
    return rows


def _reader(side, path, fmt, **kw):
    src = side["file"].FileSource(path, fmt, **kw)
    return src.create_reader(src.create_splits(1)[0])


# -- file systems and plugins ------------------------------------------------

def test_local_and_mem_file_systems_and_a_registered_scheme(tmp_path):
    for side in SIDES:
        fs_mod = side["fs"]
        fs, p = fs_mod.get_file_system(str(tmp_path / "x"))
        assert fs.scheme == "file" and p.endswith("/x")
        root = f"t{_tag()}"
        fs, p = fs_mod.get_file_system(f"mem://{root}/key")
        assert fs.scheme == "mem" and p == f"{root}/key"
        with fs.open_write(f"{root}/one") as f:
            f.write(b"hello")
        with fs.open_write(f"{root}/one", append=True) as f:
            f.write(b" world")
        with fs.open_read(f"{root}/one") as f:
            assert f.read() == b"hello world"
        assert fs.exists(root) and fs.is_dir(root)
        assert fs.size(f"{root}/one") == 11
        fs.rename(f"{root}/one", f"{root}/sub/two")
        assert fs.listdir(root) == ["sub"]
        assert not fs.is_dir(f"{root}/sub/two")
        fs.remove(f"{root}/sub/two")
        with pytest.raises(FileNotFoundError):
            fs.open_read(f"{root}/sub/two")
        with pytest.raises(ValueError, match="quantumfs"):
            fs_mod.get_file_system("quantumfs://x")
        scheme = f"s{_tag()}"

        class Upper(fs_mod.MemoryFileSystem):
            pass

        fs_mod.register_filesystem(scheme, Upper)
        fs, p = fs_mod.get_file_system(f"{scheme}://a/b")
        assert isinstance(fs, Upper) and p == "a/b"


def test_plugin_manager_loads_isolated_plugins_and_sql_uses_them(tmp_path):
    """Two plugin directories: one plugin registers a scheme, a state
    backend, a SQL connector and a metric reporter; a broken one and one
    without a hook are recorded; two files of one name stay separate
    modules. The plugin connector serves a SQL table and the plugin
    reporter is built from ``metrics.reporters``, in both packages."""
    name, scheme = f"plug-{_tag()}", f"p{_tag()}"
    good = tmp_path / "a"
    good.mkdir()
    (good / "conn.py").write_text(f'''
import numpy as np
SEEN = []

def register(registry):
    def source(env, table):
        rows = [(i, i * i) for i in range(6)]
        return env.from_collection(rows, table.schema)

    class Sink:
        def invoke_batch(self, batch):
            SEEN.extend(batch.iter_rows())
            return True

    def sink(table):
        return Sink()

    class Fs:
        scheme = {scheme!r}

    class Reporter:
        def open(self, registry):
            self.registry = registry

        def close(self):
            pass

    registry.connector({name!r}, source=source, sink=sink)
    registry.metric_reporter({name!r}, Reporter)
    registry.filesystem({scheme!r}, Fs)
    registry.state_backend({name!r}, object)
    registry.sink_rows = SEEN
''')
    (good / "broken.py").write_text("raise RuntimeError('boom')\n")
    (good / "nohook.py").write_text("X = 1\n")
    (good / "_private.py").write_text("raise SystemExit\n")
    other = tmp_path / "b"
    other.mkdir()
    (other / "conn.py").write_text("def register(registry):\n"
                                   "    registry.loaded_twice = True\n")
    got = {}
    for side, manager in ((REF, RefPlugins), (PORT, PluginManager)):
        pm = manager([str(good), str(other), str(tmp_path / "none")])
        reg = pm.load_all()
        assert reg.loaded == ["conn", "conn"]
        assert sorted(os.path.basename(p) for p, _e in pm.errors) == \
            ["broken.py", "nohook.py"]
        assert name in reg.connectors
        assert side["fs"].get_file_system(f"{scheme}://x")[1] == "x"
        t_env = side["sql"].TableEnvironment(_env(side))
        t_env.execute_sql(f"CREATE TABLE p (k BIGINT, v BIGINT) WITH "
                          f"('connector' = '{name}')")
        t_env.execute_sql(f"CREATE TABLE q (k BIGINT, v BIGINT) WITH "
                          f"('connector' = '{name}')")
        rows = sorted(t_env.execute_sql("SELECT k, v FROM p WHERE k > 1")
                      .collect())
        n = t_env.execute_sql("INSERT INTO q SELECT k, v FROM p").collect()
        reporters = side["reporters"].reporters_from_config(
            side["config"]({"metrics.reporters": f"prometheus, {name}"}))
        got[id(side)] = (rows, n, sorted(reg.sink_rows),
                         name in reg.metric_reporters,
                         [type(r).__name__ for r in reporters])
    assert got[id(REF)] == got[id(PORT)]
    assert got[id(PORT)][0] == [(i, i * i) for i in range(2, 6)]
    assert got[id(PORT)][3:] == (True, ["PrometheusReporter", "Reporter"])


# -- the file connector ------------------------------------------------------

def _sink_dir(side, d, fmt_name="csv", rolling=64 << 20):
    rec = side["records"]
    schema = rec.Schema(KV)
    fmt = {"csv": side["fmt"].CsvFormat, "json": side["fmt"].JsonFormat,
           "columnar": side["col"].ColumnarFormat}[fmt_name](schema)
    return side["file"].FileSink(d, fmt, rolling_size=rolling), fmt


def _listing(d):
    return sorted(os.listdir(d))


def test_file_sink_two_phase_commit_and_stale_cleanup(tmp_path):
    """Nothing is visible before a checkpoint completes; a commit renames
    the checkpoint's parts; a failed attempt's in-progress file is
    removed at the next attempt's first write, after its restored
    pending parts committed. Same files, same bytes in both packages."""
    out = {}
    for side in SIDES:
        d = str(tmp_path / ("ref" if side is REF else "port"))
        sink, _fmt = _sink_dir(side, d)
        w = sink.create_writer(0)
        w.write_batch(_kv(side, 0, 5))
        assert _listing(d) == [".part-0-0.inprogress"]
        w.flush()
        w.prepare_commit(1)
        snap = w.snapshot()
        w.write_batch(_kv(side, 5, 8))           # after the barrier
        steps = [_listing(d)]
        w.commit(1)
        steps.append(_listing(d))
        # a crash: the writer is dropped; the restored one commits the
        # snapshot's pending parts again (a no-op now) and cleans the
        # dead attempt's file at its first write
        w2 = sink.create_writer(0)
        w2.restore(snap)
        steps.append(_listing(d))
        w2.write_batch(_kv(side, 8, 10))
        steps.append(_listing(d))
        w2.prepare_commit(2)
        w2.commit(2)
        w2.close()
        steps.append(_listing(d))
        files = {f: open(os.path.join(d, f)).read() for f in _listing(d)}
        out[id(side)] = (steps, files, snap)
    assert out[id(REF)][0] == out[id(PORT)][0]
    assert out[id(REF)][1] == out[id(PORT)][1]
    steps, files, snap = out[id(PORT)]
    assert steps[1] == [".part-0-1.inprogress", "part-0-0"]
    assert steps[3] == [".part-0-1.inprogress", "part-0-0"]
    assert steps[4] == ["part-0-0", "part-0-1"]
    assert files["part-0-1"] == "8,53\n9,60\n"
    # the writer's snapshot is the reference's schema; each restores in
    # the other package
    assert set(snap) == {"seq", "pending"}
    assert out[id(REF)][2] == {**snap, "pending": {
        1: [(p.replace("/port/", "/ref/"), q.replace("/port/", "/ref/"))
            for p, q in snap["pending"][1]]}}


def test_file_sink_snapshots_restore_across_the_packages(tmp_path):
    """A writer's pending parts, snapshotted in one package, commit when
    the other package's writer restores the snapshot."""
    for src, dst in ((REF, PORT), (PORT, REF)):
        d = str(tmp_path / f"x{_tag()}")
        sink, _fmt = _sink_dir(src, d, "json")
        w = sink.create_writer(0)
        w.write_batch(_kv(src, 0, 3))
        w.prepare_commit(7)
        snap = w.snapshot()
        assert _listing(d) == [".part-0-0.inprogress"]
        w2 = _sink_dir(dst, d, "json")[0].create_writer(0)
        w2.restore(snap)
        assert _listing(d) == ["part-0-0"]
        w2.write_batch(_kv(dst, 3, 4))
        w2.prepare_commit(8)
        w2.commit(8)
        assert _listing(d) == ["part-0-0", "part-0-1"]


def test_file_sink_size_roll_waits_for_the_next_checkpoint(tmp_path):
    for side in SIDES:
        d = str(tmp_path / ("ref" if side is REF else "port"))
        sink, _fmt = _sink_dir(side, d, rolling=16)
        w = sink.create_writer(0)
        w.write_batch(_kv(side, 0, 4))           # rolls by size
        w.write_batch(_kv(side, 4, 5))
        w.commit(1)                              # no prepare: nothing yet
        assert _listing(d) == [".part-0-0.inprogress",
                               ".part-0-1.inprogress"]
        w.prepare_commit(2)
        w.commit(2)
        assert _listing(d) == ["part-0-0", "part-0-1"]


def test_file_source_directories_globs_and_scheme_globs(tmp_path):
    """The same files in the same order from a directory (hidden and
    in-progress files left out), a glob, a scheme glob over mem:// and a
    single mem:// file; a missing path raises FileNotFoundError."""
    mem = f"mem://g{_tag()}"
    for name, body in (("a.csv", "1,2\n"), ("b.csv", "3,4\n5,6\n"),
                       ("c.txt", "7,8\n"), (".hidden", "9,9\n"),
                       ("x.inprogress", "9,9\n")):
        (tmp_path / name).write_text(body)
        fs, p = port_fs.get_file_system(f"{mem}/{name}")
        with fs.open_write(p) as f:
            f.write(body.encode())
        # the two packages' mem:// stores are separate
        rfs, rp = ref_fs.get_file_system(f"{mem}/{name}")
        with rfs.open_write(rp) as f:
            f.write(body.encode())
    paths = [str(tmp_path), str(tmp_path / "*.csv"), f"{mem}/*.csv",
             f"{mem}/b.csv", mem]
    for path in paths:
        got = []
        for side in SIDES:
            fmt = side["fmt"].CsvFormat(side["records"].Schema(KV))
            src = side["file"].FileSource(path, fmt)
            got.append(([os.path.basename(f) for f in src._files()],
                        _read_all(_reader(side, path, fmt))))
        assert got[0] == got[1], path
    assert got[0][1] == [(1, 2), (3, 4), (5, 6), (7, 8)]
    for side in SIDES:
        fmt = side["fmt"].CsvFormat(side["records"].Schema(KV))
        with pytest.raises(FileNotFoundError):
            side["file"].FileSource(str(tmp_path / "none*"),
                                    fmt).create_splits(1)


def _columnar_file(path, side, n_frames, rows, seed=0):
    """``n_frames`` frames of ``rows`` random int64 rows (so they hardly
    compress) in one columnar file; returns the frames' end offsets."""
    rng = np.random.default_rng(seed)
    rec = side["records"]
    fmt = side["col"].ColumnarFormat(rec.Schema(KV))
    ends, at = [], 0
    with open(path, "wb") as f:
        for i in range(n_frames):
            k = rng.integers(-(1 << 62), 1 << 62, rows)
            block = fmt.encode_block(rec.RecordBatch(
                rec.Schema(KV), {"k": k, "v": np.full(rows, i)}))
            f.write(block)
            at += len(block)
            ends.append(at)
    return ends


def test_file_readers_resume_across_the_packages(tmp_path):
    """A reader's {"file", "pos"} snapshot, taken in one package, resumes
    in the other: csv by line offset, columnar at a frame boundary."""
    d_text, d_bin = tmp_path / "t", tmp_path / "b"
    d_text.mkdir()
    d_bin.mkdir()
    (d_text / "a.csv").write_text("".join(f"{i},{i}\n" for i in range(7)))
    (d_text / "b.csv").write_text("".join(f"{i},{i}\n" for i in range(7, 9)))
    for i in range(2):
        _columnar_file(d_bin / f"p{i}", PORT, 3, 500, seed=i)
    cases = [(str(d_text), lambda s: s["fmt"].CsvFormat(
        s["records"].Schema(KV)), {"batch_lines": 3}),
        (str(d_bin), lambda s: s["col"].ColumnarFormat(
            s["records"].Schema(KV)), {})]
    for path, fmt_of, kw in cases:
        whole = _read_all(_reader(PORT, path, fmt_of(PORT), **kw))
        assert whole == _read_all(_reader(REF, path, fmt_of(REF), **kw))
        for src, dst in ((REF, PORT), (PORT, REF)):
            r = _reader(src, path, fmt_of(src), **kw)
            head = list(r.read_batch(1 << 12).iter_rows())
            snap = r.snapshot()
            assert set(snap) == {"file", "pos"} and snap["pos"] > 0
            r2 = _reader(dst, path, fmt_of(dst), **kw)
            r2.restore(snap)
            assert head + _read_all(r2) == whole


def test_kept_difference_large_frames_and_a_mid_frame_restore(tmp_path):
    """Frames larger than the reference's 1 MiB read: the reference reads
    no row of the file, the port all of them, a frame a batch. Frames of
    0.7 MiB: the reference's snapshot after its first read lies past the
    bytes it holds (``pos`` 1 MiB, inside the second frame) and a restore
    from it loses the rest (it fails, or reads the bytes there as a frame
    length past the end); the port's ``pos`` is the first frame's end,
    and a restore from it reads the rest exactly."""
    big = tmp_path / "big"
    big.mkdir()
    rows = 1 << 17
    ends = _columnar_file(big / "p0", PORT, 2, rows)
    assert ends[0] > 1 << 20
    fmt = {id(s): s["col"].ColumnarFormat(s["records"].Schema(KV))
           for s in SIDES}
    assert _read_all(_reader(REF, str(big), fmt[id(REF)])) == []
    r = _reader(PORT, str(big), fmt[id(PORT)])
    first = r.read_batch(1 << 20)
    assert first.n == rows and r.snapshot() == {"file": 0, "pos": ends[0]}
    assert first.n + sum(1 for _ in _read_all(r)) == 2 * rows
    mid = tmp_path / "mid"
    mid.mkdir()
    ends = _columnar_file(mid / "p0", PORT, 3, 90_000, seed=3)
    assert ends[0] < 1 << 20 < ends[1]
    whole = _read_all(_reader(PORT, str(mid), fmt[id(PORT)]))
    assert len(whole) == 3 * 90_000
    ref_r = _reader(REF, str(mid), fmt[id(REF)])
    assert ref_r.read_batch(1 << 20).n == 90_000
    assert ref_r.snapshot() == {"file": 0, "pos": 1 << 20}
    again = _reader(REF, str(mid), fmt[id(REF)])
    again.restore(ref_r.snapshot())
    try:
        rest = _read_all(again)
    except ValueError as e:      # the bytes at 1 MiB read as a frame head
        assert "bad group magic" in str(e)
    else:                        # or as a length past the file's end
        assert len(rest) < 2 * 90_000
    port_r = _reader(PORT, str(mid), fmt[id(PORT)])
    head = list(port_r.read_batch(1 << 20).iter_rows())
    assert port_r.snapshot() == {"file": 0, "pos": ends[0]}
    for side in SIDES:   # the corrected offset resumes in both packages
        r2 = _reader(side, str(mid), fmt[id(side)])
        r2.restore(port_r.snapshot())
        assert head + _read_all(r2) == whole
    # a truncated tail raises, naming the file and the offset
    with open(mid / "p0", "r+b") as f:
        f.truncate(ends[2] - 10)
    r3 = _reader(PORT, str(mid), fmt[id(PORT)])
    r3.restore({"file": 0, "pos": ends[1]})
    with pytest.raises(ValueError, match=f"p0: truncated frame at byte "
                                         f"{ends[1]}"):
        r3.read_batch(1 << 20)


def test_unframed_binary_reader_resumes_past_a_partial_message(tmp_path):
    """Protobuf messages (no frame prefix): the reader decodes the whole
    messages of a growing read and snapshots the first byte of the
    partial one it holds; a restore there reads every row once."""
    pytest.importorskip("google.protobuf")
    from flink_tpu_torch.formats.protobuf import ProtobufFormat

    rec = port_records
    fmt = ProtobufFormat(rec.Schema(KV))
    k = np.arange(300_000, dtype=np.int64)
    with open(tmp_path / "m.pb", "wb") as f:
        f.write(fmt.encode_block(rec.RecordBatch(rec.Schema(KV),
                                                 {"k": k, "v": k * 3})))
    r = _reader(PORT, str(tmp_path), fmt)
    head = list(r.read_batch(1 << 20).iter_rows())
    snap = r.snapshot()
    assert 0 < snap["pos"] < os.path.getsize(tmp_path / "m.pb")
    assert r._pending and len(head) < len(k)
    r2 = _reader(PORT, str(tmp_path), fmt)
    r2.restore(snap)
    rows = head + _read_all(r2)
    assert [a for a, _b in rows] == k.tolist()


# -- the log -----------------------------------------------------------------

def _topic(side, broker, n=40, parts=3):
    rec = side["records"]
    fmt = side["fmt"].JsonFormat(rec.Schema(KV))
    broker.create_topic("in", parts)
    for p in range(parts):
        b = _kv(side, p * 100, p * 100 + n)
        broker.append("in", p, fmt.encode_batch(b).splitlines())
    return fmt


def test_log_readers_resume_offsets_across_the_packages():
    whole = {}
    for side in SIDES:
        broker = side["log"].InMemoryLogBroker()
        fmt = _topic(side, broker)
        src = side["log"].LogSource(broker, "in", fmt, bounded=True)
        whole[id(side)] = sorted(_read_all(src.create_reader(
            src.create_splits(1)[0]), 7))
    assert whole[id(REF)] == whole[id(PORT)]
    for src_side, dst_side in ((REF, PORT), (PORT, REF)):
        broker = src_side["log"].InMemoryLogBroker()
        fmt = _topic(src_side, broker)
        src = src_side["log"].LogSource(broker, "in", fmt, bounded=True)
        r = src.create_reader(src.create_splits(1)[0])
        head = [row for _ in range(4) for row in r.read_batch(7).iter_rows()]
        snap = r.snapshot()
        assert snap == {0: 14, 1: 7, 2: 7}
        dst_broker = dst_side["log"].InMemoryLogBroker()
        dfmt = _topic(dst_side, dst_broker)
        dsrc = dst_side["log"].LogSource(dst_broker, "in", dfmt,
                                         bounded=True)
        r2 = dsrc.create_reader(dsrc.create_splits(1)[0])
        r2.restore(json.loads(json.dumps(snap)))    # keys as strings too
        assert sorted(head + _read_all(r2, 7)) == whole[id(REF)]


def test_log_sink_transactions_stay_idempotent_after_restore():
    """A staged checkpoint commits once: after a restore from its
    snapshot (in either package) the redelivered transaction is dropped,
    and a restore before its commit applies it."""
    for src, dst in ((REF, PORT), (PORT, REF), (PORT, PORT)):
        broker = dst["log"].InMemoryLogBroker(2)
        broker.create_topic("out", 2)
        rec = src["records"]
        fmt = src["fmt"].JsonFormat(rec.Schema(KV))
        w = src["log"].LogSink(broker, "out", fmt,
                               partition_by="k").create_writer(0)
        w.write_batch(_kv(src, 0, 6))
        w.prepare_commit(1)
        snap = w.snapshot()
        assert set(snap) == {"staged"}
        w.commit(1)
        committed = [broker.end_offset("out", p) for p in range(2)]
        assert sum(committed) == 6
        dfmt = dst["fmt"].JsonFormat(dst["records"].Schema(KV))
        w2 = dst["log"].LogSink(broker, "out", dfmt,
                                partition_by="k").create_writer(0)
        w2.restore(snap)
        w2.commit(1)
        assert [broker.end_offset("out", p) for p in range(2)] == committed
        fresh = dst["log"].InMemoryLogBroker(2)
        fresh.create_topic("out", 2)
        w3 = dst["log"].LogSink(fresh, "out", dfmt).create_writer(0)
        w3.restore(snap)
        assert [fresh.end_offset("out", p) for p in range(2)] == committed
        lines = [json.loads(x) for p in range(2)
                 for _o, x in broker.poll("out", p, 0, 100)]
        assert sorted((r["k"], r["v"]) for r in lines) == \
            [(k, 7 * k - 3) for k in range(6)]


def test_network_broker_on_loopback():
    """LogBrokerServer and RemoteLogBroker: the LogBroker calls, a
    transaction applied once, a server error shipped back, a refused
    method, a reconnect after the server severed the connection, and
    LogSource and LogSink through the client."""
    server = LogBrokerServer(port=0)
    client = RemoteLogBroker(server.address)
    try:
        client.create_topic("t", 2)
        assert client.partitions("t") == 2
        client.append("t", 0, ["a", "b"])
        client.append_txn("x1", "t", 1, ["c"])
        client.append_txn("x1", "t", 1, ["c"])
        assert client.end_offset("t", 1) == 1
        assert client.poll("t", 0, 1, 10) == [(1, "b")]
        with pytest.raises(RuntimeError, match="KeyError"):
            client.partitions("missing")
        with pytest.raises(RuntimeError, match="no broker method"):
            client._call("__init__")
        server.drop_connections()
        with pytest.raises((ConnectionError, OSError)):
            client.end_offset("t", 0)
        assert client.end_offset("t", 0) == 2      # reconnected
        fmt = port_fmt.JsonFormat(port_records.Schema(KV))
        client.create_topic("kv", 2)
        w = port_log.LogSink(client, "kv", fmt,
                             partition_by="k").create_writer(0)
        w.write_batch(_kv(PORT, 0, 20))
        w.prepare_commit(1)
        w.commit(1)
        src = port_log.LogSource(client, "kv", fmt, bounded=True)
        rows = _read_all(src.create_reader(src.create_splits(1)[0]), 5)
        assert sorted(rows) == [(k, 7 * k - 3) for k in range(20)]
    finally:
        client.close()
        server.close()
    with pytest.raises(RuntimeError, match="WITHOUT a cluster secret"):
        LogBrokerServer(host="0.0.0.0", port=0)


def _serve(payload: bytes):
    """A loopback server that writes ``payload`` to its first client and
    closes; returns (port, thread)."""
    srv = socket.create_server(("127.0.0.1", 0))

    def run():
        with srv:
            conn, _ = srv.accept()
            with conn:
                conn.sendall(payload)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return srv.getsockname()[1], t


def test_socket_source_on_loopback():
    """Lines split across reads, a burst beyond max_records carried over,
    a last line without a newline, the end at the peer's close; the idle
    split of a second subtask; a refused connection ends after its
    retries."""
    lines = [f"line {i} ünï" for i in range(3000)]
    payload = ("\n".join(lines)).encode()
    got = {}
    for side in SIDES:
        port, t = _serve(payload)
        src = side["socket"].SocketSource("127.0.0.1", port)
        splits = src.create_splits(2)
        r = src.create_reader(splits[0])
        rows, sizes = [], []
        while (b := r.read_batch(500)) is not None:
            rows.extend(b.iter_rows())
            sizes.append(b.n)
        r.close()
        t.join(10)
        idle = src.create_reader(splits[1]).read_batch(10)
        got[id(side)] = (rows, idle.n)
        assert max(sizes) == 500
    assert got[id(REF)] == got[id(PORT)] == (lines, 0)
    dead = socket.create_server(("127.0.0.1", 0))
    port = dead.getsockname()[1]
    dead.close()
    r = port_socket.SocketSource("127.0.0.1", port, max_retries=1,
                                 retry_delay=0.01).create_reader(
        port_socket.SocketSource("127.0.0.1", port).create_splits(1)[0])
    assert all(r.read_batch(10) is not None and i < 5 for i in range(2))
    assert r.read_batch(10) is None


# -- SQL ---------------------------------------------------------------------

def _both_sql(statements, tmp_path, **config):
    """Run the statements in a fresh TableEnvironment of each package
    ({dir} in a statement: a directory of its own a package); the
    collected rows of each statement, package by package."""
    out = []
    for side in SIDES:
        d = tmp_path / (("ref" if side is REF else "port") + _tag())
        d.mkdir()
        t_env = side["sql"].TableEnvironment(_env(side, **config))
        res = []
        for sql in statements:
            r = t_env.execute_sql(sql.format(dir=d))
            res.append(sorted(r.collect()) if r is not None else None)
        out.append((res, d))
    return out


@pytest.mark.parametrize("fmt", ["csv", "json", "columnar", "avro",
                                 "binary"])
def test_sql_filesystem_tables_match_the_reference(tmp_path, fmt):
    """INSERT INTO a filesystem table (local, then mem://) from a
    datagen table, then a GROUP BY and a filter over it: the reference's
    rows and the reference's files."""
    mem = f"mem://sql{_tag()}"
    stmts = [
        "CREATE TABLE gen (k BIGINT, v BIGINT, s STRING) WITH ('connector' "
        "= 'datagen', 'number-of-rows' = '300', 'fields.k.kind' = "
        "'random', 'fields.k.min' = '0', 'fields.k.max' = '9')",
        f"CREATE TABLE f (k BIGINT, v BIGINT, s STRING) WITH ('connector' "
        f"= 'filesystem', 'path' = '{{dir}}', 'format' = '{fmt}')",
        f"CREATE TABLE m (k BIGINT, v BIGINT) WITH ('connector' = "
        f"'filesystem', 'path' = '{mem}/{{dir}}', 'format' = '{fmt}')",
        "INSERT INTO f SELECT k, v, s FROM gen",
        "SELECT k, COUNT(*) c, SUM(v) t, MIN(v) mn, MAX(v) mx FROM f "
        "GROUP BY k",
        "INSERT INTO m SELECT k, v FROM f WHERE v % 3 = 0",
        "SELECT k, v FROM m WHERE k < 5",
    ]
    (ref, rd), (port, pd) = _both_sql(stmts, tmp_path)
    assert port == ref
    assert port[3] == [(300,)] and len(port[6]) > 10
    files = [{f: open(os.path.join(d, f), "rb").read()
              for f in _listing(d)} for d in (rd, pd)]
    assert files[0] == files[1] and list(files[1]) == ["part-0-0"]


def test_sql_insert_into_filesystem_commits_at_checkpoints(tmp_path):
    """Under periodic checkpoints an INSERT INTO a json table commits a
    part a checkpoint (each rolls the in-progress file) and the end
    commits the rest: every row once, no file in progress."""
    env = StreamExecutionEnvironment(Configuration({
        "execution.checkpointing.interval": 0.002,
        "pipeline.micro-batch-size": 64}), device="cpu")
    t_env = port_sql.TableEnvironment(env)
    t_env.execute_sql("CREATE TABLE gen (k BIGINT, v BIGINT) WITH "
                      "('connector' = 'datagen', 'number-of-rows' = "
                      "'20000', 'rows-per-second' = '100000')")
    t_env.execute_sql(f"CREATE TABLE out (k BIGINT, v BIGINT) WITH "
                      f"('connector' = 'filesystem', 'path' = "
                      f"'{tmp_path}', 'format' = 'json')")
    assert t_env.execute_sql("INSERT INTO out SELECT k, v FROM gen"
                             ).collect() == [(20000,)]
    parts = _listing(tmp_path)
    assert len(parts) > 1 and not any(p.startswith(".") for p in parts)
    rows = sorted(json.loads(line)["k"] for p in parts
                  for line in open(tmp_path / p).read().splitlines())
    assert rows == list(range(20000))


def test_sql_log_socket_and_print_tables_match_the_reference(tmp_path,
                                                             capsys):
    """A log table (a named in-process broker) written by INSERT INTO and
    read bounded, a socket table, a print table: the reference's rows
    and the reference's printed lines."""
    broker = f"b{_tag()}"
    log_stmts = [
        "CREATE TABLE gen (k BIGINT, v BIGINT) WITH ('connector' = "
        "'datagen', 'number-of-rows' = '200')",
        f"CREATE TABLE lg (k BIGINT, v BIGINT) WITH ('connector' = 'log', "
        f"'topic' = 't', 'broker' = '{broker}', 'format' = 'json', "
        "'bounded' = 'true')",
        "INSERT INTO lg SELECT k, v * 2 FROM gen WHERE k % 2 = 0",
        "SELECT k, v FROM lg WHERE k < 50",
        "CREATE TABLE pr (k BIGINT, v BIGINT) WITH ('connector' = 'print')",
        "INSERT INTO pr SELECT k, v FROM lg WHERE k < 8",
    ]
    (ref, _d1), (port, _d2) = _both_sql(log_stmts, tmp_path)
    assert port == ref
    assert port[3] == [(k, 2 * k) for k in range(0, 50, 2)]
    printed = capsys.readouterr().out.splitlines()
    assert printed == ["(0, 0)", "(2, 4)", "(4, 8)", "(6, 12)"] * 2
    for side in SIDES:
        t_env = side["sql"].TableEnvironment(_env(side))
        t_env.execute_sql("CREATE TABLE bl (k BIGINT) WITH ('connector' = "
                          "'log', 'topic' = 'x', 'format' = 'columnar')")
        with pytest.raises(side["sql"].SqlError, match="text lines"):
            t_env.execute_sql("SELECT k FROM bl")
    rows = {}
    for side in SIDES:
        port_no, t = _serve("".join(f"w{i % 7}\n" for i in range(500))
                            .encode())
        t_env = side["sql"].TableEnvironment(_env(side))
        t_env.execute_sql(f"CREATE TABLE s (line STRING) WITH ('connector'"
                          f" = 'socket', 'port' = '{port_no}')")
        rows[id(side)] = sorted(t_env.execute_sql(
            "SELECT line, COUNT(*) c FROM s GROUP BY line").collect_final())
        t.join(10)
    assert rows[id(REF)] == rows[id(PORT)]
    assert [c for _l, c in rows[id(PORT)]] == [72, 72, 72, 71, 71, 71, 71]


# -- Q5 from a columnar file -------------------------------------------------

N_EVENTS, N_KEYS, SPAN, BATCH = 20_000, 500, 20_000, 4096
MULT = 0x9E3779B97F4A7C15
Q5_FIELDS = [("auction", np.int64), ("price", np.int64), ("ts", np.int64)]


def _q5_file(path):
    """bench.py's Q5 events in columnar frames of BATCH rows."""
    idx = np.arange(N_EVENTS, dtype=np.int64)
    cols = {"auction": ((idx.astype(np.uint64) * np.uint64(MULT))
                        % np.uint64(N_KEYS)).astype(np.int64),
            "price": idx % 997 + 1, "ts": (idx * SPAN) // N_EVENTS}
    schema = port_records.Schema(Q5_FIELDS)
    fmt = port_col.ColumnarFormat(schema)
    with open(path, "wb") as f:
        for lo in range(0, N_EVENTS, BATCH):
            f.write(fmt.encode_block(port_records.RecordBatch(
                schema, {k: v[lo:lo + BATCH] for k, v in cols.items()})))


def _q5_rows(side, d, topk):
    if side is REF:
        env = RefEnv()
        env.set_state_backend("tpu")
        env.config.set("pipeline.micro-batch-size", BATCH)
        ws = RefWS.for_monotonous_timestamps().with_timestamp_column("ts")
        agg, sliding = RefAggSpec, RefSliding
    else:
        env = StreamExecutionEnvironment(
            Configuration({"pipeline.micro-batch-size": BATCH}),
            device="cpu")
        ws = WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        agg, sliding = AggSpec, SlidingEventTimeWindows
    src = side["file"].FileSource(d, side["col"].ColumnarFormat(
        side["records"].Schema(Q5_FIELDS)))
    return (env.from_source(src, ws, "Files")
            .key_by("auction")
            .window(sliding.of(5000, 1000))
            .device_aggregate([agg("count", out_name="bids", value_bits=31),
                               agg("sum", "price", out_name="revenue")],
                              capacity=1 << 10, ring_size=32,
                              emit_topk=topk, defer_overflow=True,
                              async_fire=True)
            .execute_and_collect())


def _by_window(rows):
    out = defaultdict(list)
    for auction, _start, end, bids, revenue in rows:
        out[end].append((auction, bids, revenue))
    return out


def test_tiny_q5_from_a_columnar_file_matches_the_reference(tmp_path):
    """The reference reads the file as one batch (its 1 MiB read), the
    port a frame a batch: full emission equal window for window, and the
    top 10 under the tie rule (equal values and keys above the k-th
    value; keys at it among the window's ties)."""
    _q5_file(tmp_path / "part-0-0")
    full = _by_window(_q5_rows(REF, str(tmp_path), None))
    assert len(full) > 10
    port_full = _by_window(_q5_rows(PORT, str(tmp_path), None))
    assert {e: sorted(r) for e, r in port_full.items()} == \
        {e: sorted(r) for e, r in full.items()}
    want = _by_window(_q5_rows(REF, str(tmp_path), 10))
    got = _by_window(_q5_rows(PORT, str(tmp_path), 10))
    assert sorted(got) == sorted(want) == sorted(full)
    for end, prows in got.items():
        rrows = want[end]
        assert [r[1] for r in prows] == [r[1] for r in rrows]
        kth = prows[-1][1]
        assert {r for r in prows if r[1] > kth} == \
            {r for r in rrows if r[1] > kth}
        exact = {a: (b, v) for a, b, v in full[end]}
        ties = {a for a, b, _v in full[end] if b == kth}
        assert all(exact[a] == (b, v) for a, b, v in prows)
        assert {r[0] for r in prows if r[1] == kth} <= ties


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util, json, time
import torch
from flink_tpu_torch.connectors import datagen, file, log


def paced(read):
    # a tiny batch takes microseconds: pace the readers, so each manual
    # checkpoint lands where the card's batches put it
    def read_batch(self, n):
        time.sleep(0.02)
        return read(self, n)
    return read_batch


for cls in (datagen._DataGenReader, file._FileReader, log._LogReader):
    cls.read_batch = paced(cls.read_batch)
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.fresh_memory = lambda torch: {{}}
torch.cuda.max_memory_allocated = lambda *a, **k: 0
cs.emit = lambda obj: None
sizes = {{"q5_files": {{"keys": 3000, "events": 1 << 15,
                        "capacity": 1 << 13, "batch": 1 << 11}},
         "sql_filesystem": {{"rows": 1 << 13, "auctions": 1 << 8,
                             "batch": 1 << 9, "ckpt_s": 0.002}},
         "log": {{"lines": 1 << 13, "net_lines": 1 << 11,
                  "auctions": 1 << 8, "batch": 1 << 7,
                  "capacity": 1 << 10}},
         "socket": {{"lines": 1 << 11, "words": 50}}}}
out = cs.connectors_phase(torch, torch.device("cpu"), sizes)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(json.dumps({{"windows": out["q5_files"]["read"]["windows_checked"],
                  "restore": out["q5_files"]["restore"]["windows_repeated"],
                  "groups": out["sql_filesystem"]["groups"],
                  "log": out["log"]["windows_checked"],
                  "socket": out["socket"]["rows"]}}))
"""


def test_connectors_phase_runs_tiny_without_jax():
    """chip_smoke.py's connectors phase at a tiny size on the CPU, in a
    subprocess where jax and flink_tpu cannot be imported: the Q5 file
    job (written, read, restored mid-file), SQL over the filesystem, the
    log (restored) and the socket, each against its oracle."""
    proc = subprocess.run([sys.executable, "-c",
                           _BLOCKED.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["windows"] > 5 and got["restore"] == 0
    assert got["groups"] == 256 and got["log"] > 5 and got["socket"] > 50
