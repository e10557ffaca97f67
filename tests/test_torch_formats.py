"""Port parity: the formats (``flink_tpu_torch/formats/``), the batch
codec and serializer registry (``core/serializers.py``) and the heap
backend's serializer records (``state/heap.py``) against flink_tpu's.

* Every format encodes one seeded batch to the same text or bytes in both
  packages, and each package decodes the other's output to an equal
  batch: csv (nulls, quotes, delimiters and newlines inside fields, a
  header skipped at each file's start by the file reader), json, the
  native binary frames, columnar (pruning, and a predicate's
  ``groups_skipped``), avro (a reader schema that adds and drops
  fields); parquet and protobuf where their package imports, and both
  raise an ``ImportError`` naming it where it does not.
* ``serialize_batch`` gives equal bytes in both packages.
* Serializer migrations chain and refuse as the reference's do.
* Heap snapshots of state under a registered serializer are equal in both
  packages and restore both ways.

Tolerance: exact (float columns round-trip bit for bit).
"""

import builtins
import sys
import uuid

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import flink_tpu.connectors.file as ref_file  # noqa: E402
import flink_tpu.core.records as ref_records  # noqa: E402
import flink_tpu.core.serializers as ref_ser  # noqa: E402
import flink_tpu.formats.avro as ref_avro  # noqa: E402
import flink_tpu.formats.columnar as ref_col  # noqa: E402
import flink_tpu.formats.core as ref_fmt  # noqa: E402
import flink_tpu.state.backend as ref_backend  # noqa: E402
import flink_tpu.state.descriptors as ref_desc  # noqa: E402
import flink_tpu.state.heap  # noqa: E402,F401 - registers hashmap
from flink_tpu.core.keygroups import KeyGroupRange as RefRange  # noqa: E402
import flink_tpu_torch.connectors.file as port_file  # noqa: E402
import flink_tpu_torch.core.records as port_records  # noqa: E402
import flink_tpu_torch.core.serializers as port_ser  # noqa: E402
import flink_tpu_torch.formats.avro as port_avro  # noqa: E402
import flink_tpu_torch.formats.columnar as port_col  # noqa: E402
import flink_tpu_torch.formats.core as port_fmt  # noqa: E402
import flink_tpu_torch.state.backend as port_backend  # noqa: E402
import flink_tpu_torch.state.descriptors as port_desc  # noqa: E402
from flink_tpu_torch.core.keygroups import KeyGroupRange  # noqa: E402

REF = {"records": ref_records, "fmt": ref_fmt, "col": ref_col,
       "avro": ref_avro, "ser": ref_ser, "file": ref_file,
       "backend": ref_backend, "desc": ref_desc, "range": RefRange}
PORT = {"records": port_records, "fmt": port_fmt, "col": port_col,
        "avro": port_avro, "ser": port_ser, "file": port_file,
        "backend": port_backend, "desc": port_desc, "range": KeyGroupRange}
SIDES = (REF, PORT)
FIELDS = [("k", np.int64), ("v", np.float64), ("i", np.int32),
          ("flag", np.bool_), ("s", object)]
#: strings a text format must escape: the delimiter, quotes, newlines,
#: backslashes, an empty string and a null
WORDS = ["plain", "a,b", 'say "hi"', "two\nlines", "back\\slash",
         "tab\there", "", None, "ünï", 'mixed, "all"\nof \\n them']
MAXP = 128


def _batch(side, n=257, seed=22, fields=FIELDS, nulls=True):
    rng = np.random.default_rng(seed)
    words = WORDS if nulls else [w for w in WORDS if w]
    cols = {"k": rng.integers(-(1 << 40), 1 << 40, n),
            "v": rng.normal(size=n) * 1e3,
            "i": rng.integers(-1000, 1000, n).astype(np.int32),
            "flag": rng.random(n) < 0.5,
            "s": np.array([words[j] for j in
                           rng.integers(0, len(words), n)], dtype=object)}
    rec = side["records"]
    schema = rec.Schema(fields)
    return rec.RecordBatch(schema, {f: cols[f] for f, _ in fields},
                           rng.integers(0, 10 ** 9, n))


def _same(a, b, ts=True):
    """Two batches (either package) hold the same rows: names, dtypes,
    values (None included) and, with ``ts``, timestamps."""
    assert a.schema.names == b.schema.names
    assert a.n == b.n
    for name in a.schema.names:
        x, y = a.columns[name], b.columns[name]
        assert x.dtype == y.dtype, name
        if x.dtype == object:
            assert x.tolist() == y.tolist(), name
        else:
            np.testing.assert_array_equal(x, y)
    if ts:
        np.testing.assert_array_equal(a.timestamps, b.timestamps)


def _text_formats(side, name):
    rec, fmt = side["records"], side["fmt"]
    schema = rec.Schema(FIELDS)
    return {"csv": fmt.CsvFormat(schema), "tsv": fmt.CsvFormat(schema, "\t"),
            "json": fmt.JsonFormat(schema)}[name]


@pytest.mark.parametrize("name", ["csv", "tsv", "json"])
def test_text_formats_equal_text_and_decode_each_other(name):
    """csv (and a tab-delimited csv) with nulls, quotes, delimiters and
    newlines inside fields; json lines."""
    texts = [_text_formats(s, name).encode_batch(_batch(s)) for s in SIDES]
    assert texts[0] == texts[1]
    if name != "json":
        assert "\\n" in texts[0] and '""' in texts[0]
    lines = texts[0].splitlines()
    assert len(lines) == 257
    ref_b, port_b = (_text_formats(s, name).decode_lines(lines)
                     for s in SIDES)
    _same(ref_b, port_b)
    assert port_b.columns["s"].tolist().count(None) > 0
    # the decoded strings are the written ones; csv reads an empty field
    # as a null
    want = _batch(PORT).columns["s"].tolist()
    if name != "json":
        want = [None if w == "" else w for w in want]
    assert port_b.columns["s"].tolist() == want


def test_csv_header_skipped_at_each_file_start(tmp_path):
    """The file reader drops a header line at the start of every file
    (and only there), in both packages, also for a file read in several
    batches."""
    for i, body in enumerate(["k,s\n1,a\n2,\n3,c\n", "k,s\n4,\"d,e\"\n"]):
        (tmp_path / f"p{i}.csv").write_text(body)
    rows = []
    for side in SIDES:
        rec, fmt = side["records"], side["fmt"]
        f = fmt.CsvFormat(rec.Schema([("k", np.int64), ("s", object)]),
                          skip_header=True)
        src = side["file"].FileSource(str(tmp_path), f, batch_lines=2)
        (split,) = src.create_splits(1)
        reader = src.create_reader(split)
        out = []
        while (b := reader.read_batch(1 << 10)) is not None:
            out.extend(b.iter_rows())
        rows.append(out)
    assert rows[0] == rows[1] == [(1, "a"), (2, None), (3, "c"),
                                  (4, "d,e")]


def _binary_formats(side, name, **kw):
    rec = side["records"]
    schema = rec.Schema(FIELDS)
    if name == "binary":
        return side["fmt"].BinaryFormat(schema)
    if name == "columnar":
        return side["col"].ColumnarFormat(schema, **kw)
    return side["avro"].AvroFormat(schema, **kw)


@pytest.mark.parametrize("name", ["binary", "columnar", "avro"])
def test_binary_formats_equal_bytes_and_decode_each_other(name):
    """Two frames in one block, then the block cut at every length: the
    same batches and the same remainder in both packages."""
    blocks = []
    for s in SIDES:
        f = _binary_formats(s, name)
        blocks.append(f.encode_block(_batch(s, seed=1))
                      + f.encode_block(_batch(s, n=31, seed=2)))
    assert blocks[0] == blocks[1]
    data = blocks[0]
    decoded = [_binary_formats(s, name).decode_block(data) for s in SIDES]
    (rb, rrest), (pb, prest) = decoded
    assert rrest == prest == b"" and len(rb) == len(pb) == 2
    for a, b in zip(rb, pb):
        # binary frames carry the timestamps; columnar and avro do not
        _same(a, b, ts=True)
    want = _batch(PORT, seed=1)
    if name != "binary":
        # columnar and avro write a null string as an empty one
        want.columns["s"] = np.array(["" if w is None else w
                                      for w in want.columns["s"]],
                                     dtype=object)
    _same(pb[0], want, ts=name == "binary")
    for cut in range(0, len(data), max(1, len(data) // 97)):
        got = [_binary_formats(s, name).decode_block(data[:cut])
               for s in SIDES]
        assert len(got[0][0]) == len(got[1][0])
        assert bytes(got[0][1]) == bytes(got[1][1])


def test_columnar_pruning_and_predicate_skip_count():
    """Pruned columns never inflate; groups whose stats miss the
    predicate are skipped on their header, counted alike."""
    blocks = []
    for s in SIDES:
        f = _binary_formats(s, "columnar")
        rec = s["records"]
        parts = []
        for g in range(6):
            b = _batch(s, n=64, seed=10 + g)
            cols = dict(b.columns)
            cols["k"] = np.arange(64, dtype=np.int64) + 1000 * g
            parts.append(f.encode_block(rec.RecordBatch(b.schema, cols)))
        blocks.append(b"".join(parts))
    assert blocks[0] == blocks[1]
    out = []
    for s in SIDES:
        f = _binary_formats(s, "columnar", columns=["k", "s"],
                            predicate={"k": (1050, 3010)})
        batches, rest = f.decode_block(blocks[0])
        out.append((batches, f.groups_read, f.groups_skipped))
        assert rest == b""
        assert [b.schema.names for b in batches] == [("k", "s")] * 3
    (rb, rr, rs), (pb, pr, ps) = out
    assert (rr, rs) == (pr, ps) == (3, 3)
    for a, b in zip(rb, pb):
        _same(a, b)


def test_avro_reader_schema_adds_and_drops_fields():
    """A writer without ``extra`` and with ``gone``: the reader drops
    ``gone`` and fills ``extra`` from its defaults (or zero)."""
    got = []
    for s in SIDES:
        rec = s["records"]
        writer = s["avro"].AvroFormat(rec.Schema(
            [("k", np.int64), ("gone", object), ("v", np.float64)]))
        b = rec.RecordBatch(writer.schema, {
            "k": np.array([-(1 << 62), -1, 0, 1, (1 << 62)], np.int64),
            "gone": np.array(list("abcde"), dtype=object),
            "v": np.array([0.5, -1.25, 3.0, 1e300, -0.0])})
        block = writer.encode_block(b)
        reader = s["avro"].AvroFormat(rec.Schema(
            [("k", np.int64), ("extra", np.int64), ("tag", object),
             ("v", np.float64)]), defaults={"tag": "none"})
        (out,), rest = reader.decode_block(block)
        assert rest == b""
        got.append((block, out))
    assert got[0][0] == got[1][0]
    _same(got[0][1], got[1][1])
    assert got[1][1].columns["extra"].tolist() == [0] * 5
    assert got[1][1].columns["tag"].tolist() == ["none"] * 5


def _file_roundtrip(side, fmt_of, tmp_path, tag):
    """A FileSink writes two batches through ``fmt_of(side)``, the
    FileSource reads them back: (the part's bytes, the batches read)."""
    d = str(tmp_path / f"{tag}-{'port' if side is PORT else 'ref'}")
    writer = side["file"].FileSink(d, fmt_of(side)).create_writer(0)
    for seed in (3, 4):
        writer.write_batch(_batch(side, seed=seed, nulls=False))
    writer.prepare_commit(1)
    writer.commit(1)
    writer.close()
    src = side["file"].FileSource(d, fmt_of(side))
    reader = src.create_reader(src.create_splits(1)[0])
    out = []
    while (b := reader.read_batch(1 << 12)) is not None:
        out.append(b)
    with open(f"{d}/part-0-0", "rb") as fh:
        return fh.read(), out


def test_parquet_where_pyarrow_imports(tmp_path):
    pytest.importorskip("pyarrow")
    from flink_tpu.formats.parquet import ParquetFormat as RefParquet
    from flink_tpu_torch.formats.parquet import ParquetFormat

    classes = {id(REF): RefParquet, id(PORT): ParquetFormat}

    def fmt(side):
        return classes[id(side)](side["records"].Schema(FIELDS))

    (rbytes, rb), (pbytes, pb) = (_file_roundtrip(s, fmt, tmp_path, "pq")
                                  for s in SIDES)
    assert rbytes == pbytes
    assert len(rb) == len(pb) == 2
    for a, b in zip(rb, pb):
        _same(a, b)
    _same(pb[0], _batch(PORT, seed=3, nulls=False))


def test_protobuf_where_it_imports(tmp_path):
    pytest.importorskip("google.protobuf")
    from flink_tpu.formats.protobuf import ProtobufFormat as RefPb
    from flink_tpu_torch.formats.protobuf import ProtobufFormat

    classes = {id(REF): RefPb, id(PORT): ProtobufFormat}

    def fmt(side):
        return classes[id(side)](side["records"].Schema(FIELDS))

    blocks = [fmt(s).encode_block(_batch(s, nulls=False)) for s in SIDES]
    assert blocks[0] == blocks[1]
    (rb,), rrest = fmt(REF).decode_block(blocks[0] + blocks[0][:3])
    (pb,), prest = fmt(PORT).decode_block(blocks[0] + blocks[0][:3])
    assert rrest == prest == blocks[0][:3]
    _same(rb, pb)
    _same(pb, _batch(PORT, nulls=False))
    (rfile, rbs), (pfile, pbs) = (_file_roundtrip(s, fmt, tmp_path, "pb")
                                  for s in SIDES)
    assert rfile == pfile
    for a, b in zip(rbs, pbs):
        _same(a, b)


def test_parquet_and_protobuf_name_the_missing_package(monkeypatch):
    """Without pyarrow or google.protobuf both packages raise an
    ImportError; the port's names the package."""
    real_import = builtins.__import__

    def blocked(name, *args, **kwargs):
        if name.split(".")[0] in ("pyarrow", "google"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *args, **kwargs)

    for mod in [m for m in sys.modules if m.split(".")[0] in
                ("pyarrow", "google")]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setattr(builtins, "__import__", blocked)
    from flink_tpu.formats.parquet import ParquetFormat as RefParquet
    from flink_tpu.formats.protobuf import ProtobufFormat as RefPb
    from flink_tpu_torch.formats.parquet import ParquetFormat
    from flink_tpu_torch.formats.protobuf import ProtobufFormat

    for side, parquet, pb in ((REF, RefParquet, RefPb),
                              (PORT, ParquetFormat, ProtobufFormat)):
        schema = side["records"].Schema(FIELDS)
        with pytest.raises(ImportError) as pq_err:
            parquet(schema).open_writer(None).write(_batch(side))
            parquet(schema).open_writer(None).close()
        with pytest.raises(ImportError) as pb_err:
            pb(schema)
        if side is PORT:
            assert "pyarrow" in str(pq_err.value)
            assert "google.protobuf" in str(pb_err.value)


def test_serialize_batch_equal_bytes_both_ways():
    for seed, n in ((5, 0), (6, 1), (7, 300)):
        ref_bytes, port_bytes = (s["ser"].serialize_batch(_batch(s, n=n,
                                                                 seed=seed))
                                 for s in SIDES)
        assert ref_bytes == port_bytes
        _same(ref_ser.deserialize_batch(port_bytes),
              port_ser.deserialize_batch(ref_bytes))
        _same(port_ser.deserialize_batch(port_bytes),
              _batch(PORT, n=n, seed=seed))
    with pytest.raises(ValueError, match="Bad batch magic"):
        port_ser.deserialize_batch(b"XXXX")


class _Point:
    """A serializer identity: only ``name`` and ``version`` are read."""

    def __init__(self, name, version):
        self.name, self.version = name, version


def _heap(side, sers, snapshots=None, name="pt", values=None):
    """A heap backend holding value state ``name`` under serializer
    ``sers`` (a (name, version) or None), filled with ``values`` or
    restored from ``snapshots``."""
    desc = side["desc"].ValueStateDescriptor(
        name, serializer=None if sers is None else _Point(*sers))
    b = side["backend"].create_backend("hashmap",
                                       side["range"](0, MAXP - 1), MAXP)
    if snapshots is not None:
        b.restore(snapshots)
    state = b.get_partitioned_state(desc)
    for key, v in (values or {}).items():
        b.set_current_key(key)
        state.update(v)
    return b, state


def _read(b, state, keys):
    out = {}
    for k in keys:
        b.set_current_key(k)
        out[k] = state.value()
    return out


def _register(name, version):
    for side in SIDES:
        ser = type("Ser", (side["ser"].PickleSerializer,),
                   {"name": name, "version": version})
        side["ser"].registry.register(ser())


def test_serializer_migrations_chain_and_refuse_alike():
    """A v1 snapshot restores under v3 through two registered migrations;
    a missing link, a newer snapshot and a replaced serializer refuse
    with the same message in both packages."""
    name, gapped = (f"pt-{uuid.uuid4().hex[:8]}" for _ in range(2))
    _register(name, 3)
    _register(gapped, 4)
    values = {k: k * 10 for k in range(40)}
    for side in SIDES:
        reg = side["ser"].registry
        for n in (name, gapped):
            reg.register_migration(n, 1, lambda v: v + 1)
            reg.register_migration(n, 2, lambda v: v * 2)
        assert reg.has_migration_path(name, 1, 3)
        assert not reg.has_migration_path(gapped, 1, 4)
        assert reg.migrate_value(name, 1, 3, 5) == 12
    reads, errors = [], []
    for side in SIDES:
        snaps = {sers: _heap(side, sers, values=values)[0].snapshot(1)
                 for sers in ((name, 1), (gapped, 1), (name, 5))}
        assert snaps[(name, 1)]["serializers"] == {"pt": [name, 1]}
        for other in SIDES:
            b, st = _heap(other, None, [snaps[(name, 1)]])
            reads.append(_read(b, st, values))
            msgs = []
            for snap in (snaps[(gapped, 1)], snaps[(name, 5)]):
                with pytest.raises(RuntimeError) as e:
                    _heap(other, None, [snap])
                msgs.append(str(e.value))
            # a backend whose descriptor names another serializer
            b, _st = _heap(other, (gapped, 4))
            with pytest.raises(RuntimeError) as e:
                b.restore([snaps[(name, 1)]])
            msgs.append(str(e.value))
            errors.append(msgs)
    assert all(r == {k: (v + 1) * 2 for k, v in values.items()}
               for r in reads)
    assert all(e == errors[0] for e in errors)
    assert "no migration chain v1->v4" in errors[0][0]
    assert "NEWER" in errors[0][1]
    assert "serializer replacement" in errors[0][2]


def test_heap_snapshots_with_a_registered_serializer_restore_both_ways():
    """A state under a registered serializer: equal snapshots, and each
    restores in the other package without its descriptor (the registry
    resolves the recorded name); an unregistered name refuses alike."""
    name = f"reg-{uuid.uuid4().hex[:8]}"
    _register(name, 2)
    values = {k: {"k": k, "tags": [k] * (k % 3)} for k in range(-20, 20)}
    snaps = [_heap(s, (name, 2), values=values)[0].snapshot(7)
             for s in SIDES]
    assert snaps[0] == snaps[1]
    assert snaps[0]["serializers"] == {"pt": [name, 2]}
    again = []
    for src, dst in ((REF, PORT), (PORT, REF)):
        snap = snaps[SIDES.index(src)]
        b = dst["backend"].create_backend("hashmap",
                                          dst["range"](0, MAXP - 1), MAXP)
        b.restore([snap])
        # a state restored without its descriptor snapshots under the
        # default serializer, in both packages
        again.append(b.snapshot(8))
        assert again[-1]["states"] == snap["states"]
        b2, st = _heap(dst, (name, 2), [snap])
        assert _read(b2, st, values) == values
        assert b2.snapshot(9) == snap
    assert again[0] == again[1]
    unknown = {**snaps[0], "serializers": {"pt": ["nowhere", 1]}}
    msgs = []
    for side in SIDES:
        b = side["backend"].create_backend("hashmap",
                                           side["range"](0, MAXP - 1), MAXP)
        with pytest.raises(RuntimeError) as e:
            b.restore([unknown])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "not registered" in msgs[0]
    # the default serializer's record is the reference's
    plain = [_heap(s, None, values={1: 2})[0].snapshot(1) for s in SIDES]
    assert plain[0] == plain[1]
    assert plain[0]["serializers"] == {"pt": ["pickle", 1]}
