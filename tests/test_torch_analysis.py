"""The port's lint (flink_tpu_torch/analysis/) against the reference's
(flink_tpu/analysis/).

* Tier A and the plan rules are clean on the port against its committed
  baseline, every baseline entry carries a reviewed reason, and no entry
  is stale.
* A seeded mini-package trips each ported rule, PyTorch's host waits and
  unseeded ``torch.rand`` included.
* On the mini-package's shared patterns (``.item()``, ``float(x_dev)``,
  ``np.asarray(x_dev)``) the host-sync rule gives the reference's
  findings, by rule and line, with both rules pointed at the same file.
* Every reference rule is registered in the port or listed as not
  applicable with its reason; the catalogue document lists both.
* The sync audit (Tier B's mapping) names a wait by its ``sync-ok`` line
  or its baseline entry and reports the rest.
* In a process where jax and flink_tpu cannot be imported, the port's
  ledger, build cache and lint import and run.

Tolerance: exact (findings by rule, file and line).
"""

import json
import pathlib
import subprocess
import sys
import textwrap
from types import SimpleNamespace

import pytest

from flink_tpu_torch.analysis import AnalysisContext, AnalysisSettings, \
    all_rules, diff_against_baseline, load_baseline, run_rules
from flink_tpu_torch.analysis import core as port_core
from flink_tpu_torch.analysis.program_rules import NOT_APPLICABLE
from flink_tpu_torch.analysis.sync_audit import audit_waits, named_waits
from flink_tpu_torch.graph import fusion

ROOT = pathlib.Path(__file__).resolve().parent.parent

HOT = '''\
import numpy as np
import torch


def step(x_dev, t, host):
    a = x_dev.item()
    b = float(x_dev)
    c = np.asarray(x_dev)
    d = t.tolist()
    e = t.numpy()
    f = t.cpu()
    g = t.cpu(non_blocking=True)
    h = t.to("cpu")
    i = int(torch.sum(t))
    torch.cuda.synchronize()
    j = t.nonzero()
    k = np.nonzero(host)
    # lint: sync-ok a deliberate read, once a job
    m = x_dev.item()
    return a, b, c, d, e, f, g, h, i, j, k, m
'''
#: (line, what) of every TPU101 finding HOT must give the port's rule
HOT_WANT = [(6, ".item()"), (7, "float()"), (8, "np.asarray"),
            (9, ".tolist()"), (10, ".numpy()"), (11, ".cpu()"),
            (13, ".to(cpu)"), (14, "int()"), (15, "torch.cuda.synchronize()"),
            (16, ".nonzero()")]
#: the lines of HOT the reference's rule also reads as host waits
SHARED = {6, 7, 8}

RUNTIME = '''\
import random
import threading

import numpy as np
import torch

_SHARED = {}
_CACHE = {}  # lint: guarded-by only the import thread writes it


def fill(k):
    _SHARED[k] = 1


def drop(k):
    _SHARED.pop(k, None)


def noise(gen):
    a = torch.rand(4)
    b = torch.randint(0, 9, (4,))
    c = torch.randperm(8, generator=gen)
    d = np.random.rand(3)
    e = random.random()
    f = random.Random()
    g = np.random.default_rng(7)
    return a, b, c, d, e, f, g


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self.n = 0

    def bump(self):
        with self._lock:
            self.n += 1

    def racy(self):
        self.n = 0
'''

OPS = '''\
import torch


def planes(n, dev):
    a = torch.zeros(n, dtype=torch.float64, device=dev)
    b = torch.empty(n, dtype=torch.float32, device=dev)
    c = b.to(torch.float64)
    # lint: f64-ok exact sums
    d = torch.ones(n, dtype=torch.double, device=dev)
    return a, b, c, d.double()
'''

CACHE = '''\
class Chain:
    def run(self, t, n):
        key = (t.data_ptr(), n, tuple(t.shape), t.sum().item())
        other_key = (t.data_ptr(), len(t))
        return key, other_key
'''

INVENTORY = '''\
from x import DEVICE_LEDGER, FAULTS, TRACER


def sites(dev):
    tok = DEVICE_LEDGER.begin("nosuch.site", dev)
    DEVICE_LEDGER.record("device_window.step", 1.0)
    FAULTS.fire("nosuch.fault")
    TRACER.span("scope", "name")
    cfg = {"profiler.enabld": True, "profiler.enabled": False}
    return tok, cfg
'''

DEPLOY = '''\
from x import FAULTS, WATCHDOG


def run_job(config):
    FAULTS.configure(config)
    _more(config)


def _more(config):
    WATCHDOG.configure(config)
'''


@pytest.fixture
def mini(tmp_path):
    """A seeded mini-package ``minipkg`` under tmp_path with its docs."""
    pkg = tmp_path / "minipkg"
    files = {"runtime/operators/hot.py": HOT, "runtime/noise.py": RUNTIME,
             "ops/planes.py": OPS, "runtime/compiled.py": CACHE,
             "metrics/sites.py": INVENTORY, "cluster/local.py": DEPLOY}
    for rel, src in files.items():
        p = pkg / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    (pkg / "__init__.py").write_text("")
    settings = AnalysisSettings(
        hot_path_modules=("runtime/operators/hot.py",),
        entry_points=(("cluster/local.py", "run_job"),),
        singletons=(("FAULTS", ("FAULTS",)), ("WATCHDOG", ("WATCHDOG",)),
                    ("DEVICE_LEDGER", ("DEVICE_LEDGER",))),
        program_caches=(("runtime/compiled.py", "Chain", "run"),),
        docs_dir="minipkg/docs")
    return AnalysisContext(tmp_path, "minipkg", settings)


def _by_rule(findings) -> dict:
    out: dict = {}
    for f in findings:
        out.setdefault(f.rule, []).append(f)
    return out


# -- the port is clean ----------------------------------------------------------
def test_tier_a_is_clean_on_the_port_against_its_reasoned_baseline(
        monkeypatch):
    # the plan rules read every certificate this process logged; pipelines
    # of other tests in the same worker must not enter the port's lint, so
    # with the log empty they certify the port's own pipelines
    monkeypatch.setattr(fusion, "CERTIFICATE_LOG", [])
    skipped = []
    findings = run_rules(AnalysisContext(), skipped=skipped)
    new, stale = diff_against_baseline(findings)
    assert new == [], [f"{f.rule} {f.location()} {f.symbol}" for f in new]
    assert stale == []
    assert skipped == []
    baseline = load_baseline()
    assert baseline
    for e in baseline:
        reason = e["reason"].strip()
        assert reason and not reason.startswith("TODO"), e
        assert set(e) == {"rule", "file", "symbol", "fingerprint", "reason"}
    assert json.loads((ROOT / "flink_tpu_torch/analysis/baseline.json")
                      .read_text())["version"] == 1


def test_the_singleton_wiring_covers_the_ledger_and_the_build_cache():
    ctx = AnalysisContext()
    names = {s for s, _acc in ctx.settings.singletons}
    assert names == {"FAULTS", "WATCHDOG", "TRACER", "FLIGHT_RECORDER",
                     "MESH_RUNTIME", "DEVICE_LEDGER", "AOT"}
    assert run_rules(ctx, ["TPU201"]) == []


# -- a seeded mini-package trips each rule ---------------------------------------
def test_the_host_sync_rule_flags_pytorch_waits(mini):
    got = [(f.line, f.message.split(" on a device")[0])
           for f in run_rules(mini, ["TPU101"])]
    assert got == HOT_WANT


def test_the_host_sync_rule_matches_the_reference_on_shared_patterns(mini):
    pytest.importorskip("jax")
    from flink_tpu.analysis.core import AnalysisContext as RefContext
    from flink_tpu.analysis.core import AnalysisSettings as RefSettings
    from flink_tpu.analysis.core import run_rules as ref_run
    ref_ctx = RefContext(mini.root, "minipkg", RefSettings(
        hot_path_modules=("runtime/operators/hot.py",)), extra_files=())
    ref = [(f.rule, f.file, f.line) for f in ref_run(ref_ctx, ["TPU101"])]
    port = [(f.rule, f.file, f.line) for f in run_rules(mini, ["TPU101"])
            if f.line in SHARED]
    assert ref == port and len(ref) == len(SHARED)


def test_the_determinism_and_lock_rules_trip(mini):
    by = _by_rule(run_rules(mini, ["TPU401", "TPU402", "TPU501", "TPU502"]))
    rng = sorted((f.line, f.symbol.split(":", 1)[1]) for f in by["TPU502"])
    assert rng == [(20, "torch.rand()  (no generator)"),
                   (21, "torch.randint()  (no generator)"),
                   (23, "np.random.rand"), (24, "random.random"),
                   (25, "random.Random()  (no seed)")]
    assert [(f.symbol, f.line) for f in by["TPU402"]] == [("_SHARED", 7)]
    assert [f.symbol for f in by["TPU401"]] == ["Counter.racy:n"]
    assert "TPU501" not in by


def test_the_program_rules_trip(mini):
    by = _by_rule(run_rules(mini, ["JX502", "JX504"]))
    assert [f.line for f in by["JX502"]] == [5, 7, 10]
    assert [(f.line, f.symbol.split(":")[0]) for f in by["JX504"]] == \
        [(3, "Chain.run"), (3, "Chain.run")]   # .sum() and .item()


def test_the_inventory_and_wiring_rules_trip(mini):
    by = _by_rule(run_rules(mini, ["TPU201", "TPU301", "TPU302", "TPU303",
                                   "TPU304", "TPU305"]))
    assert [f.symbol for f in by["TPU201"]] == ["run_job:DEVICE_LEDGER"]
    assert "code-not-inventoried:scope.name" in {f.symbol
                                                 for f in by["TPU301"]}
    assert "undeclared-site:nosuch.fault" in {f.symbol for f in by["TPU302"]}
    assert {f.symbol for f in by["TPU303"]} >= {"stale"}
    assert [f.symbol for f in by["TPU304"]] == ["key:profiler.enabld"]
    assert "code-not-inventoried:nosuch.site" in {f.symbol
                                                  for f in by["TPU305"]}


def test_the_plan_rules_read_certificates(mini, monkeypatch):
    findings = [SimpleNamespace(rule=r, file="<unknown>", line=0,
                                symbol=f"v:{r}", message=f"cut by {r}")
                for r in ("PLAN601", "PLAN602", "PLAN603", "PLAN604")]
    cert = SimpleNamespace(findings=lambda: findings)
    monkeypatch.setattr(fusion, "CERTIFICATE_LOG", [cert])
    by = _by_rule(run_rules(mini, ["PLAN601", "PLAN602", "PLAN603",
                                   "PLAN604"]))
    assert sorted(by) == ["PLAN601", "PLAN602", "PLAN603", "PLAN604"]
    # with no certificate logged, the port's own pipelines are certified
    monkeypatch.setattr(fusion, "CERTIFICATE_LOG", [])
    skipped = []
    assert run_rules(AnalysisContext(), ["PLAN601", "PLAN603"],
                     skipped=skipped) == []
    assert skipped == []


def test_a_todo_baseline_reason_trips_base601(tmp_path, monkeypatch):
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "TPU101", "file": "f.py", "symbol": "s", "fingerprint": "x",
         "reason": "TODO: justify this exception or fix it"}]}))
    monkeypatch.setattr(port_core, "baseline_path", lambda: path)
    assert [f.symbol for f in run_rules(AnalysisContext(), ["BASE601"])] \
        == ["x"]


# -- the catalogue -----------------------------------------------------------------
def test_every_reference_rule_is_ported_or_listed_with_its_reason():
    pytest.importorskip("jax")
    from flink_tpu.analysis.core import all_rules as ref_rules
    ported = set(all_rules())
    ref = set(ref_rules())
    assert ref <= ported | set(NOT_APPLICABLE)
    assert not ported & set(NOT_APPLICABLE)
    assert set(NOT_APPLICABLE) <= ref
    assert all(len(why) > 40 for why in NOT_APPLICABLE.values())
    doc = (ROOT / "flink_tpu_torch/docs/ANALYSIS.md").read_text()
    for rid in ported | set(NOT_APPLICABLE):
        assert f"| `{rid}` |" in doc, rid


# -- the sync audit's mapping --------------------------------------------------------
def test_the_sync_audit_names_waits_by_sync_ok_or_baseline():
    names = named_waits()
    window = "flink_tpu_torch/runtime/operators/device_window.py"
    src = (ROOT / window).read_text().splitlines()
    ok_line = next(i for i, ln in enumerate(src, 1)
                   if "lint: sync-ok the late counter at finish" in ln)
    base = next(e for e in load_baseline()
                if e["file"] == window and e["rule"] == "TPU101")
    base_line = next(i for i, ln in enumerate(src, 1)
                     if base["symbol"].split(":", 1)[1].split("(")[0] in ln)
    res = audit_waits([f"{window}:{ok_line + 1}", f"{window}:{base_line}",
                       f"{window}:1", "chip_smoke.py:10",
                       "__init__.py:12 torch._C.x()"])
    assert set(res["named"]) == {f"{window}:{ok_line + 1}",
                                 f"{window}:{base_line}"}
    assert res["named"][f"{window}:{base_line}"] == base["reason"]
    assert res["unnamed"] == [f"{window}:1"]
    assert res["outside"] == ["__init__.py:12 torch._C.x()",
                              "chip_smoke.py:10"]
    assert ok_line in names[window] and ok_line + 1 in names[window]


# -- without jax ------------------------------------------------------------------------
def test_the_ledger_cache_and_lint_run_without_jax(tmp_path):
    code = textwrap.dedent(f"""\
        import sys
        sys.modules["jax"] = None
        sys.modules["flink_tpu"] = None
        import torch
        from flink_tpu_torch.analysis import AnalysisContext, \\
            diff_against_baseline, run_rules
        from flink_tpu_torch.core import Configuration
        from flink_tpu_torch.metrics.profiler import DeviceLedger
        from flink_tpu_torch.ops import kernels
        from flink_tpu_torch.runtime.aot import AOT, verify_aot_cache
        led = DeviceLedger()
        led.configure(Configuration({{"profiler.enabled": True}}))
        tok = led.begin("ops.pallas_topk", torch.device("cpu"))
        led.end(tok, (8, 8), lambda n, s: (n, n * s))
        led.record("transfer.d2h", 0.0, nbytes=64)
        assert len(led.profile()["programs"]) == 2
        kernels._nvcc = lambda: {sys.executable!r}
        def compile_stub(todo, out_of):
            for s in todo:
                open(out_of(s), "wb").write(b"library " + s.encode())
            return 0.0
        kernels._compile = compile_stub
        AOT.configure(Configuration({{"aot.enabled": True,
                                     "aot.dir": {str(tmp_path)!r}}}))
        kernels.build_all()
        assert len(verify_aot_cache({str(tmp_path)!r})) == \\
            len(kernels.SOURCES)
        new, stale = diff_against_baseline(run_rules(AnalysisContext()))
        assert not new and not stale
        assert not any(m == "jax" or m.startswith(("jax.", "flink_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-1] == "ok"
