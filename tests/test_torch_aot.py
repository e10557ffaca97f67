"""The verified build cache of the kernel libraries
(flink_tpu_torch/runtime/aot.py with ops/kernels.py): the reference's
tests/test_aot.py cases that need no HA, REST or command line, on the
port's artifacts.

There is no nvcc here: an injected stub compiler (a script that writes
bytes where nvcc would write the library) builds, and an injected loader
stands in for ``ctypes.CDLL``, recording the bytes it was handed. So
these tests show what reaches the loader (only bytes that verified), what
is built (``kernels.builds()``), stored, quarantined and missed; the real
nvcc build through the cache runs on the card (``cuda`` marker, and
``chip_smoke.py``'s ``aot_phase``).

* A cold run populates the cache; a warm run builds nothing.
* A flipped, truncated or garbage-header artifact is quarantined as
  ``.corrupt`` and its source alone is built again.
* A fingerprint skew (the header's, or the process's) is a miss, never an
  error, and quarantines nothing.
* ``aot.store`` trips persist nothing while the build proceeds; a store
  poison is caught at load; a transient ``aot.load`` trip is retried, a
  persistent one degrades to a build while the artifact survives.
* A warm-up stall leaves partial warmth.
* The fault grammar parses the three new sites as the reference's does;
  ``device.compile`` trips and stalls surface from the build.
* With ``aot.enabled`` off, library names and ``builds()`` are as before.
* ``aot.in-memory-max-programs`` caps the fused chain's graphs (LRU).

Tolerance: exact (counts, names, bytes).
"""

import os
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from flink_tpu_torch.core import Configuration
from flink_tpu_torch.metrics import DEVICE_STATS
from flink_tpu_torch.ops import kernels
from flink_tpu_torch.runtime import aot as port_aot
from flink_tpu_torch.runtime.aot import AOT, verify_aot_cache
from flink_tpu_torch.runtime.faults import FAULTS, FaultRule
from flink_tpu_torch.runtime.watchdog import WATCHDOG, StallError

STUB = textwrap.dedent("""\
    #!{python}
    import sys
    args = sys.argv[1:]
    if "--version" in args:
        print("Cuda compilation tools, release 12.4, V12.4.131")
        sys.exit(0)
    out, src = args[args.index("-o") + 1], args[-1]
    with open(out, "wb") as f:
        f.write(b"\\x7fELF stub library of " + src.encode() + b"\\n"
                + " ".join(args[:-3]).encode() * 8)
    print("ptxas info    : stub")
    """)


class FakeLib:
    """Stands in for a loaded library: records the bytes it was opened
    from; every C entry returns 0 (success)."""

    opened: list = []

    def __init__(self, path):
        with open(path, "rb") as f:
            FakeLib.opened.append(f.read())

    def __getattr__(self, name):
        def entry(*_args):
            return 0
        setattr(self, name, entry)
        return entry


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """Kernel builds through the stub compiler and the fake loader, with
    the process's library state fresh and the build dir under tmp_path."""
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "_dlopen", FakeLib)
    monkeypatch.setattr(kernels, "_LIBS", {})
    monkeypatch.setattr(kernels, "_READY", {})
    monkeypatch.setattr(kernels, "_BUILT", [0])
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    FakeLib.opened = []
    yield tmp_path
    AOT.reset()
    FAULTS.reset()
    WATCHDOG.reset()


@pytest.fixture(autouse=True)
def _reset_reference():
    yield
    try:
        from flink_tpu.runtime.aot import AOT as REF_AOT
        from flink_tpu.runtime.faults import FAULTS as REF_FAULTS
        from flink_tpu.runtime.watchdog import WATCHDOG as REF_WATCHDOG
        from flink_tpu.metrics.profiler import DEVICE_LEDGER as REF_LEDGER
    except ImportError:
        return
    REF_AOT.reset()
    REF_FAULTS.reset()
    REF_WATCHDOG.reset()
    REF_LEDGER.reset()


def _cfg(d, **extra) -> Configuration:
    return Configuration({"aot.enabled": True, "aot.dir": str(d), **extra})


def _fresh_process(cfg: Configuration) -> int:
    """A new process's library state, configured and warmed: returns the
    libraries the warm-up opened."""
    kernels._LIBS.clear()
    kernels._READY.clear()
    kernels._BUILT[0] = 0
    AOT.reset()
    AOT.configure(cfg)
    WATCHDOG.configure(cfg)
    return AOT.warmup()


def _artifacts(d) -> list:
    return sorted(n for n in os.listdir(d) if n.endswith(".aotx"))


def _artifact(d, stem: str) -> str:
    return os.path.join(str(d), next(n for n in _artifacts(d)
                                     if n.startswith(stem + "-")))


def _open_all() -> None:
    for stem in kernels.SOURCES:
        kernels.library(stem)


def test_cold_run_populates_the_cache_and_a_warm_run_builds_nothing(stub):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    assert AOT.warmup() == 0                    # cold: nothing to load
    stores0 = DEVICE_STATS.snapshot()["aot_stores_total"]
    assert kernels.build_all() > 0
    assert kernels.builds() == len(kernels.SOURCES)
    assert len(_artifacts(d)) == len(kernels.SOURCES)
    assert DEVICE_STATS.snapshot()["aot_stores_total"] == \
        stores0 + len(kernels.SOURCES)
    _open_all()
    built = sorted(FakeLib.opened)
    # a second build_all finds every artifact verified: builds nothing
    assert kernels.build_all() == 0.0
    assert kernels.builds() == len(kernels.SOURCES)
    FakeLib.opened = []
    assert _fresh_process(_cfg(d)) == len(kernels.SOURCES)
    _open_all()
    assert kernels.builds() == 0
    assert sorted(FakeLib.opened) == built      # the same verified bytes
    assert AOT.snapshot()["hits"] == len(kernels.SOURCES)
    # the private copies handed to the loader are gone
    assert not os.listdir(d / ".load")
    header = open(_artifact(d, "hist256"), "rb").read().split(b"\n")[0]
    for part in (b'"stem": "hist256"', b'"payload_digest"',
                 b'"nvcc_version": "Cuda compilation tools',
                 port_aot.AOT_FORMAT.encode()):
        assert part in header


@pytest.mark.parametrize("mutate", ["flip", "truncate", "garbage-header"])
def test_a_corrupt_artifact_is_quarantined_and_rebuilt(stub, mutate):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    kernels.build_all()
    path = _artifact(d, "hist256")
    raw = open(path, "rb").read()
    if mutate == "flip":
        bad = bytearray(raw)
        bad[-10] ^= 0xFF
    elif mutate == "truncate":
        bad = raw[: len(raw) // 2]
    else:
        bad = b"not json" + raw
    open(path, "wb").write(bytes(bad))
    verify0 = DEVICE_STATS.snapshot()["verify_failures_total"]
    assert _fresh_process(_cfg(d)) == len(kernels.SOURCES) - 1
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    assert any(e["kind"] == "aot-corrupt-artifact" for e in AOT.events)
    assert DEVICE_STATS.snapshot()["verify_failures_total"] == verify0 + 1
    assert kernels.builds() == 0
    FakeLib.opened = []
    kernels.library("hist256")                  # degrade: a live build
    assert kernels.builds() == 1
    assert FakeLib.opened[0].startswith(b"\x7fELF stub library of")
    assert FakeLib.opened[0].split(b"\n")[0].endswith(b"hist256.cu")
    # the rebuild stored a clean artifact beside the quarantined one
    statuses = sorted(st for n, st, _d in verify_aot_cache(str(d))
                      if n.startswith("hist256-"))
    assert statuses == ["OK", "QUARANTINED"]


def test_a_fingerprint_skew_is_a_miss_never_an_error(stub, monkeypatch):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    kernels.build_all()
    path = _artifact(d, "hist256")
    raw = open(path, "rb").read()
    nl = raw.index(b"\n")
    import json
    header = json.loads(raw[:nl])
    header["fingerprint"][-1] = "another toolkit"
    open(path, "wb").write(json.dumps(header, sort_keys=True).encode()
                           + raw[nl:])
    assert _fresh_process(_cfg(d)) == len(kernels.SOURCES) - 1
    assert any(e["kind"] == "aot-version-skew" for e in AOT.events)
    assert AOT.snapshot()["quarantined"] == 0
    kernels.library("hist256")
    assert kernels.builds() == 1
    assert not any(n.endswith(".corrupt") for n in os.listdir(d))
    # the rebuild rewrote the artifact with this process's fingerprint
    assert json.loads(open(path, "rb").read().split(b"\n")[0])[
        "fingerprint"] == AOT.fingerprint()
    # another card or toolkit names other artifacts: all misses, all built
    fp = AOT.fingerprint()
    monkeypatch.setattr(port_aot, "environment_fingerprint",
                        lambda: fp[:1] + ["sm_80"] + fp[2:])
    assert _fresh_process(_cfg(d)) == 0
    kernels.build_all()
    assert kernels.builds() == len(kernels.SOURCES)
    assert AOT.snapshot()["quarantined"] == 0


def test_a_store_trip_persists_nothing_and_the_build_proceeds(stub):
    d = stub / "cache"
    FAULTS.configure_spec("aot.store=always!persistent")
    AOT.configure(_cfg(d))
    kernels.library("hist256")
    assert kernels.builds() == 1 and len(FakeLib.opened) == 1
    assert _artifacts(d) == []
    assert any(e["kind"] == "aot-store-failed" for e in AOT.events)


def test_a_store_poison_is_caught_at_load(stub):
    d = stub / "cache"
    FAULTS.configure_spec("aot.store=once!poison")
    AOT.configure(_cfg(d))
    kernels.library("hist256")                  # stores a corrupt artifact
    FAULTS.reset()
    assert _fresh_process(_cfg(d)) == 0
    assert AOT.snapshot()["quarantined"] == 1
    kernels.library("hist256")
    assert kernels.builds() == 1


def test_load_trips_transient_retried_persistent_degrades(stub):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    kernels.build_all()
    FAULTS.configure_spec("aot.load=once@1")       # transient: retried
    assert _fresh_process(_cfg(d)) == len(kernels.SOURCES)
    assert kernels.builds() == 0
    FAULTS.configure_spec("aot.load=always!persistent")
    fallbacks0 = DEVICE_STATS.snapshot()["aot_fallbacks_total"]
    assert _fresh_process(_cfg(d)) == 0
    assert DEVICE_STATS.snapshot()["aot_fallbacks_total"] == \
        fallbacks0 + len(kernels.SOURCES)
    kernels.library("hist256")                  # degrade: a live build
    assert kernels.builds() == 1
    assert len(_artifacts(d)) == len(kernels.SOURCES)   # all survive
    assert not any(n.endswith(".corrupt") for n in os.listdir(d))
    # a load poison corrupts the bytes read: the digest check catches it
    FAULTS.configure_spec("aot.load=once@1!poison")
    _fresh_process(_cfg(d))
    assert AOT.snapshot()["quarantined"] == 1


def test_a_warmup_stall_leaves_partial_warmth(stub):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    kernels.build_all()
    FAULTS.configure_spec("aot.load=once@3!hang@800")
    loaded = _fresh_process(_cfg(d, **{"watchdog.aot-warmup-timeout": 0.2}))
    assert loaded == 2                          # the two before the hang
    assert AOT.warmed
    assert any(e["kind"] == "aot-warmup-stalled" for e in AOT.events)
    time.sleep(1.2)                             # the abandoned scan ends
    _open_all()                                 # the job never fails
    assert kernels.builds() == 0


def test_the_fault_grammar_parses_the_new_sites_as_the_reference(stub):
    pytest.importorskip("jax")
    from flink_tpu.runtime.faults import FaultRule as RefRule
    for entry in ("aot.load=once@2", "aot.store=always!poison",
                  "device.compile=every@3!persistent",
                  "device.compile=once!hang@50", "aot.load=p0.5"):
        a, b = FaultRule.parse(entry), RefRule.parse(entry)
        assert (a.site, a.mode, a.at, a.p, a.transient, a.poison,
                a.hang_ms) == (b.site, b.mode, b.at, b.p, b.transient,
                               b.poison, b.hang_ms)


def test_device_compile_faults_and_deadline_surface_from_the_build(stub):
    FAULTS.configure_spec("device.compile=once@1")     # transient: retried
    kernels.library("hist256")
    assert kernels.builds() == len(kernels.SOURCES)
    kernels._LIBS.clear()
    kernels._BUILT[0] = 0
    for p in (stub / "_build").iterdir():
        p.unlink()
    FAULTS.configure_spec("device.compile=always!persistent")
    with pytest.raises(RuntimeError, match="injected fault"):
        kernels.library("hist256")
    # a hang past the deadline stalls the visit, before nvcc starts; the
    # stall is retried once in place (watchdog.stall-retries), then raised
    FAULTS.configure_spec("device.compile=always!hang@5000")
    WATCHDOG.configure(Configuration(
        {"watchdog.device.compile-timeout": 0.3}))
    t0 = time.perf_counter()
    with pytest.raises(StallError):
        kernels.library("hist256")
    assert time.perf_counter() - t0 < 3.0
    assert kernels.builds() == 0


def test_cache_off_builds_and_names_libraries_as_before(stub):
    assert not AOT.enabled
    assert kernels.build_all() > 0
    assert kernels.builds() == len(kernels.SOURCES)
    names = sorted(p.name for p in (stub / "_build").glob("*.so"))
    assert names == sorted(kernels._lib_path(s).name
                           for s in kernels.SOURCES)
    for stem in kernels.SOURCES:
        assert kernels._lib_path(stem).name == \
            f"lib{stem}-{kernels._source_digest(stem)[:12]}.so"
        assert "ptxas info" in kernels.build_log(stem)
    assert kernels.build_all() == 0.0
    _open_all()
    assert kernels.builds() == len(kernels.SOURCES)
    assert not (stub / "cache").exists()


def test_the_in_memory_cap_evicts_the_fused_chains_graphs(stub):
    from flink_tpu_torch.runtime.compiled import FusedChain
    chain = FusedChain.__new__(FusedChain)
    from collections import OrderedDict
    chain._graphs = OrderedDict((n, ((n,), object())) for n in (1, 2, 3))
    AOT.configure(_cfg(stub / "cache",
                       **{"aot.in-memory-max-programs": 2}))
    ev0 = DEVICE_STATS.snapshot()["aot_in_memory_evictions_total"]
    chain._evict()
    assert list(chain._graphs) == [2, 3]
    assert DEVICE_STATS.snapshot()["aot_in_memory_evictions_total"] == \
        ev0 + 1
    AOT.configure(_cfg(stub / "cache"))
    chain._graphs[4] = ((4,), object())
    chain._evict()                               # 0: unbounded
    assert list(chain._graphs) == [2, 3, 4]
    assert kernels.builds() == 0


def test_verify_aot_cache_rows(stub):
    d = stub / "cache"
    AOT.configure(_cfg(d))
    kernels.build_all()
    path = _artifact(d, "group_agg")
    open(path, "ab").write(b"x")
    rows = {n.split("-")[0]: st for n, st, _d in verify_aot_cache(str(d))}
    assert rows["group_agg"] == "CORRUPT"
    assert sum(st == "OK" for st in rows.values()) == \
        len(kernels.SOURCES) - 1
    assert verify_aot_cache(str(stub / "nosuch"))[0][1] == "CORRUPT"


@pytest.mark.cuda
def test_a_real_nvcc_build_through_the_cache(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = textwrap.dedent(f"""\
        import sys, torch
        from flink_tpu_torch.core import Configuration
        from flink_tpu_torch.ops import kernels
        from flink_tpu_torch.ops.radix_topk import histogram256
        from flink_tpu_torch.runtime.aot import AOT
        AOT.configure(Configuration({{"aot.enabled": True,
                                     "aot.dir": {str(tmp_path)!r}}}))
        AOT.warmup()
        u = torch.arange(1 << 16, dtype=torch.int32, device="cuda")
        h = histogram256(u, torch.ones_like(u, dtype=torch.bool), 0)
        assert int(h.sum()) == 1 << 16
        print(kernels.builds())
        """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    builds = []
    for _ in range(2):
        out = subprocess.run([sys.executable, "-c", code], cwd=root,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        builds.append(int(out.stdout.split()[-1]))
    assert builds[0] >= 1 and builds[1] == 0
