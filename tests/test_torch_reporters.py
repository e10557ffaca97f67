"""Port parity: metric reporters and the device and ledger gauges
(flink_tpu_torch/metrics/reporters.py, ``bind_device_metrics``,
``bind_ledger_metrics``) against flink_tpu/metrics.

* ``prometheus_text`` of registries filled alike in both packages is the
  same text: counters, gauges, meters, histograms (summary and ``le``
  buckets), the hardening cases (NaN, infinities, non-numeric and raising
  gauges, names to sanitize, label escaping) and the ledger's per-job
  rollups.
* ``PrometheusReporter`` serves that text over loopback (port 0) and 404s
  elsewhere; ``LoggingReporter`` writes the snapshot; a
  ``metrics.reporters`` list builds the same reporters, and an unknown
  name raises naming the known ones.
* ``bind_device_metrics`` registers the reference's gauge names, less the
  cluster's (``DEVICE_GAUGES_LEFT_OUT``); ``bind_ledger_metrics`` all of
  the reference's; the new configuration keys have the reference's
  defaults.
* A tiny Q5 through ``env.execute(..., metrics_registry=reg)`` with a
  reporter opened on ``reg`` (the reference's documented form): each
  ``flink_tpu_device_*`` series of the scrape equals its
  ``DEVICE_STATS`` counter, each ``flink_tpu_profiler_*`` the ledger's
  snapshot.

Tolerance: exact text. DEVICE_STATS, DEVICE_LEDGER, the tracer and the
flight recorder are process-global in both packages: the autouse fixture
resets them after every test. Servers bind port 0 of 127.0.0.1.
"""

import math
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from flink_tpu.core import config as ref_config  # noqa: E402
from flink_tpu.metrics import core as ref_core  # noqa: E402
from flink_tpu.metrics import device as ref_device  # noqa: E402
from flink_tpu.metrics import profiler as ref_profiler  # noqa: E402
from flink_tpu.metrics import reporters as ref_reporters  # noqa: E402
from flink_tpu.metrics import tracing as ref_tracing  # noqa: E402
from flink_tpu_torch.core import config as port_config  # noqa: E402
from flink_tpu_torch.metrics import core as port_core  # noqa: E402
from flink_tpu_torch.metrics import device as port_device  # noqa: E402
from flink_tpu_torch.metrics import profiler as port_profiler  # noqa: E402
from flink_tpu_torch.metrics import reporters as port_reporters  # noqa: E402
from flink_tpu_torch.metrics import tracing as port_tracing  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_checkpoint as q5  # noqa: E402

REF = {"config": ref_config, "core": ref_core, "device": ref_device,
       "profiler": ref_profiler, "reporters": ref_reporters,
       "tracing": ref_tracing}
PORT = {"config": port_config, "core": port_core, "device": port_device,
        "profiler": port_profiler, "reporters": port_reporters,
        "tracing": port_tracing}
SIDES = (REF, PORT)


def _reset(side, tmp_path=None):
    cfg = side["config"].Configuration()
    side["device"].DEVICE_STATS.reset()
    side["device"].set_compile_tracer(None)
    side["profiler"].DEVICE_LEDGER.reset()
    side["profiler"].DEVICE_LEDGER.configure(cfg)
    side["profiler"].clear_dispatch_context()
    side["tracing"].TRACER.reset()
    side["tracing"].TRACER.configure(cfg)
    side["tracing"].FLIGHT_RECORDER.dump_dir = \
        str(tmp_path) if tmp_path else None


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for side in SIDES:
        _reset(side, tmp_path)
    yield
    for side in SIDES:
        _reset(side)


def _parse(text: str) -> dict:
    """name (with labels) -> float of every sample line."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, _, val = ln.rpartition(" ")
            out[name] = float(val)
    return out


# -- prometheus_text, case for case -----------------------------------------
def _counters(side):
    reg = side["core"].MetricRegistry()
    g = reg.root().group("job").group("task")
    g.counter("numRecordsIn").inc(42)
    c = g.counter("numRecordsOut")
    c.inc(5)
    c.dec(2)
    reg.root().counter("top").inc()
    return reg


def _gauges(side):
    reg = side["core"].MetricRegistry()
    g = reg.root().group("job").group("0")
    g.gauge("lag", lambda: 7.5)
    g.gauge("int", lambda: 3)
    g.gauge("numpy", lambda: np.float32(0.25))
    g.gauge("bool", lambda: True)
    return reg


def _meters(side):
    reg = side["core"].MetricRegistry()
    m = reg.root().group("src").meter("events")
    m.mark(30)
    m.mark(30)
    return reg


def _histograms(side):
    reg = side["core"].MetricRegistry()
    h = reg.root().group("op").histogram("latency", window=8)
    for v in (0.5, 3.0, 3.0, 40.0, 700.0, 12000.0, 2.5, 99.0, 100.0):
        h.update(v)
    reg.root().group("empty").histogram("none")
    return reg


def _hardening(side):
    reg = side["core"].MetricRegistry()
    g = reg.root().group("h")
    g.gauge("bad_str", lambda: "not-a-number")
    g.gauge("none", lambda: None)
    g.gauge("nanval", lambda: float("nan"))
    g.gauge("infval", lambda: float("inf"))
    g.gauge("neginf", lambda: -math.inf)
    g.gauge("array", lambda: np.array([1, 2]))
    g.gauge("raises", lambda: 1 / 0)
    reg.root().group("job name-1").group('a"b\\c').counter("x.y").inc(2)
    return reg


def _ledger(side):
    prof = side["profiler"]
    cfg = side["config"].Configuration()
    cfg.set("profiler.enabled", True)
    prof.DEVICE_LEDGER.configure(cfg)
    for job, site, ms in (("q5", "device_window.step", 1.5),
                          ("q5", "device_window.step", 2.0),
                          ("q5", "device_window.fire", 4.25),
                          ('odd "job"\nname\\', "transfer.d2h", 0.5)):
        prof.DEVICE_LEDGER.record(site, ms, job=job, operator="op")
    reg = side["core"].MetricRegistry()
    reg.root().group("x").counter("c").inc()
    return reg


PROM_CASES = {"counters": _counters, "gauges": _gauges, "meters": _meters,
              "histograms": _histograms, "hardening": _hardening,
              "ledger": _ledger}


@pytest.mark.parametrize("case", sorted(PROM_CASES))
def test_prometheus_text_equals_reference(case):
    texts = [side["reporters"].prometheus_text(PROM_CASES[case](side))
             for side in SIDES]
    assert texts[1] == texts[0]
    _parse(texts[1])      # every sample value parses, NaN and Inf too
    if case == "hardening":
        assert "raises" not in texts[1]
        assert "flink_tpu_h_bad_str NaN" in texts[1]
    if case == "ledger":
        assert 'flink_tpu_profiler_job_device_ms{job="q5"}' in texts[1]


# -- the reporters ------------------------------------------------------------
def test_prometheus_reporter_serves_the_text_over_loopback():
    reg = port_core.MetricRegistry()
    reg.root().group("up").counter("c").inc(3)
    rep = port_reporters.PrometheusReporter(port=0)
    rep.open(reg)
    try:
        for path in ("/metrics", "/", "/metrics/"):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rep.port}{path}", timeout=5) as r:
                assert r.status == 200
                assert r.headers["Content-Type"].startswith("text/plain")
                body = r.read().decode()
            assert body == port_reporters.prometheus_text(reg)
            assert "flink_tpu_up_c 3" in body
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{rep.port}/other",
                                   timeout=5)
        assert err.value.code == 404
    finally:
        rep.close()
    rep.close()   # closing twice is harmless


def test_logging_reporter_writes_the_snapshot():
    got = {}
    for name, side in (("ref", REF), ("port", PORT)):
        reg = side["core"].MetricRegistry()
        reg.root().counter("x").inc(1)
        reg.root().group("g").gauge("v", lambda: 2.5)
        lines = []
        rep = side["reporters"].LoggingReporter(interval_s=0.01,
                                                sink=lines.append)
        rep.open(reg)
        deadline = time.time() + 5
        while len(lines) < 4 and time.time() < deadline:
            time.sleep(0.005)
        rep.close()
        got[name] = lines[:2]
    assert got["port"] == got["ref"] == ["g.v=2.5", "x=1"]


def test_reporters_from_config_as_reference():
    got = []
    for side in SIDES:
        cfg = side["config"].Configuration()
        names = []
        for raw in ("", "prometheus", " log , prometheus,,"):
            cfg.set(side["config"].MetricOptions.REPORTERS, raw)
            names.append([type(r).__name__ for r in
                          side["reporters"].reporters_from_config(cfg)])
        cfg.set(side["config"].MetricOptions.REPORTERS, "log,graphite")
        with pytest.raises(ValueError, match="known") as err:
            side["reporters"].reporters_from_config(cfg)
        got.append((names, str(err.value)))
    assert got[1] == got[0]
    # the port's logging reporter takes metrics.reporter.interval
    cfg = port_config.Configuration({"metrics.reporters": "log",
                                     "metrics.reporter.interval": "250 ms"})
    (rep,) = port_reporters.reporters_from_config(cfg)
    assert rep._interval == 0.25


def test_trace_and_reporter_keys_have_the_reference_defaults():
    ref_cfg, port_cfg = ref_config.Configuration(), \
        port_config.Configuration()
    for cls in ("TraceOptions", "MetricOptions"):
        for attr in ("ENABLED", "MAX_RETAINED", "FLIGHT_CAPACITY",
                     "FLIGHT_DIR", "FLIGHT_MIN_INTERVAL", "REPORTERS",
                     "INTERVAL"):
            ref_opt = getattr(getattr(ref_config, cls), attr, None)
            if ref_opt is None:
                continue
            port_key = getattr(getattr(port_config, cls), attr)
            assert port_key == ref_opt.key
            assert port_cfg.get(port_key) == ref_cfg.get(ref_opt)
    cfg = port_config.Configuration({"metrics.reporter.interval": "250 ms",
                                     "traces.enabled": "false"})
    assert cfg.get("metrics.reporter.interval") == 0.25
    assert cfg.get("traces.enabled") is False


# -- the gauges ---------------------------------------------------------------
def _scope_names(side, bind, scope):
    reg = side["core"].MetricRegistry()
    getattr(side[bind[0]], bind[1])(reg)
    return sorted(s[1] for s in reg.all_metrics() if s[0] == scope)


def test_device_and_ledger_gauge_names_as_reference():
    ref_dev = _scope_names(REF, ("device", "bind_device_metrics"), "device")
    port_dev = _scope_names(PORT, ("device", "bind_device_metrics"),
                            "device")
    left_out = set(port_device.DEVICE_GAUGES_LEFT_OUT)
    assert set(port_dev) == set(ref_dev) - left_out
    assert left_out <= set(ref_dev) and not left_out & set(port_dev)
    assert [n for n, _a in port_device.DEVICE_GAUGES] == \
        [n for n in _ref_order() if n not in left_out]
    assert _scope_names(PORT, ("profiler", "bind_ledger_metrics"),
                        "profiler") == \
        _scope_names(REF, ("profiler", "bind_ledger_metrics"), "profiler")


def _ref_order() -> list:
    reg = ref_core.MetricRegistry()
    ref_device.bind_device_metrics(reg)
    return [s[1] for s in reg.all_metrics() if s[0] == "device"]


def test_tiny_q5_scrape_equals_device_stats_and_ledger(tmp_path):
    """The reference's documented form: reporters from the job's
    configuration, opened on the registry the job is given."""
    settings = {"metrics.reporters": "prometheus", "profiler.enabled": True,
                "execution.checkpointing.interval": 0.05,
                "traces.flight-recorder.dir": str(tmp_path)}
    env = q5._port_q5(settings, [], rate=q5.RATE)
    reg = port_core.MetricRegistry()
    (rep,) = port_reporters.reporters_from_config(env.config)
    rep.open(reg)
    try:
        job = env.execute("q5-scraped", metrics_registry=reg)
        with urllib.request.urlopen(f"http://127.0.0.1:{rep.port}/metrics",
                                    timeout=10) as r:
            vals = _parse(r.read().decode())
    finally:
        rep.close()
    stats = port_device.DEVICE_STATS
    for name, attr in port_device.DEVICE_GAUGES:
        assert vals[f"flink_tpu_device_{name}"] == \
            pytest.approx(getattr(stats, attr), abs=0), name
    assert vals["flink_tpu_device_h2d_batches"] == 0   # device batches
    assert vals["flink_tpu_device_d2h_fires"] > 0
    snap = port_profiler.DEVICE_LEDGER.snapshot()
    for name, key in (("entries", "entries"),
                      ("device_ms_total", "device_ms_total"),
                      ("dispatches_total", "dispatches_total"),
                      ("recompiles_attributed_total",
                       "recompiles_attributed")):
        assert vals[f"flink_tpu_profiler_{name}"] == \
            pytest.approx(snap[key]), name
    assert vals["flink_tpu_profiler_enabled"] == 1
    assert vals['flink_tpu_profiler_job_dispatches{job="q5-scraped"}'] == \
        snap["jobs"]["q5-scraped"]["dispatches"] > 0
    busy = [v for k, v in vals.items() if k.endswith("busyTimeMsPerSecond")]
    assert len(busy) == len(job.tasks)
    assert vals["flink_tpu_device_spans_dropped_total"] == 0
