"""Port parity of the SQL gateway (``flink_tpu_torch/sql/gateway.py``,
``utils/httpd.py``): both gateways on loopback, port 0, the port's with
``device="cpu"``, driven by the same HTTP calls (the cases of
tests/test_sql_gateway.py and a MATCH_RECOGNIZE under a GROUP BY), give
equal status codes and equal response bodies, session ids aside. Also:
the gateway's sessions run on ``cuda`` unless asked, and chip_smoke.py's
whole ``patterns`` phase, tiny, in a subprocess that cannot import jax
or flink_tpu.
"""

import json
import os
import pathlib
import subprocess
import sys
import urllib.error
import urllib.request

import pytest
import torch

jax = pytest.importorskip("jax")

from flink_tpu.sql.gateway import SqlGateway as RefGateway  # noqa: E402
from flink_tpu_torch.sql.gateway import SqlGateway, _json_safe  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
TICKS = ("CREATE TABLE ticks (symbol BIGINT, price BIGINT, ts BIGINT, "
         "WATERMARK FOR ts AS ts - INTERVAL '0' SECOND) WITH ('connector' = "
         "'datagen', 'number-of-rows' = '3000', 'fields.symbol.kind' = "
         "'random', 'fields.symbol.max' = '15', 'fields.price.kind' = "
         "'random', 'fields.price.min' = '1', 'fields.price.max' = '1000')")
V_GROUP = ("SELECT symbol, COUNT(*) AS matches, MIN(bottom_price) AS low, "
           "MAX(end_price) AS high FROM (SELECT * FROM ticks MATCH_RECOGNIZE "
           "(PARTITION BY symbol ORDER BY ts MEASURES FIRST(A.price) AS "
           "start_price, LAST(B.price) AS bottom_price, C.price AS end_price "
           "ONE ROW PER MATCH AFTER MATCH SKIP PAST LAST ROW PATTERN (A B+ C) "
           "WITHIN INTERVAL '10' SECOND DEFINE B AS B.price < A.price, "
           "C AS C.price > LAST(B.price))) GROUP BY symbol")


@pytest.fixture()
def gateways():
    gws = {"ref": RefGateway(), "port": SqlGateway(device="cpu")}
    for g in gws.values():
        g.start()
    yield gws
    for g in gws.values():
        g.stop()


def _req(port: int, method: str, path: str, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _drive(gw, script) -> list:
    """Run ``script`` (method, path with ``{sid}``/``{sid2}``, body)
    against one gateway; the responses with session ids replaced, and
    rows sorted (a GROUP BY's final rows come in hash order)."""
    sids, out = {}, []
    for method, path, body in script:
        code, resp = _req(gw.port, method, path.format(**sids), body)
        if path == "/v1/sessions" and method == "POST":
            sids["sid" if "sid" not in sids else "sid2"] = resp["session_id"]
        resp = {k: ("<sid>" if k == "session_id" else v)
                for k, v in resp.items()}
        if "rows" in resp:
            resp["rows"] = sorted(resp["rows"])
        out.append((code, resp))
    return out


SCRIPTS = {
    "info": [("GET", "/v1/info", None), ("GET", "/v1/nothing", None)],
    "ddl_and_query": [
        ("POST", "/v1/sessions", None),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "CREATE TABLE g (k BIGINT, v BIGINT) WITH "
                       "('connector'='datagen', 'number-of-rows'='30', "
                       "'fields.k.max'='2')"}),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "SELECT k, COUNT(*) c FROM g GROUP BY k"}),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "SELECT k, v * 2 AS d FROM g WHERE v < 5"}),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "SHOW TABLES"})],
    "isolated": [
        ("POST", "/v1/sessions", None), ("POST", "/v1/sessions", None),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "CREATE TABLE only_a (x BIGINT) WITH "
                       "('connector'='datagen')"}),
        ("POST", "/v1/sessions/{sid2}/statements",
         {"statement": "SELECT * FROM only_a"})],
    "bad_statement": [
        ("POST", "/v1/sessions", None),
        ("POST", "/v1/sessions/{sid}/statements", {"statement": "SELEC nope"}),
        ("POST", "/v1/sessions/{sid}/statements",
         {"statement": "SHOW TABLES"})],
    "unknown_and_closed": [
        ("POST", "/v1/sessions/nope/statements",
         {"statement": "SHOW TABLES"}),
        ("POST", "/v1/sessions", None), ("GET", "/v1/sessions/{sid}", None),
        ("DELETE", "/v1/sessions/{sid}", None),
        ("GET", "/v1/sessions/{sid}", None)],
    "match_recognize_group_by": [
        ("POST", "/v1/sessions", None),
        ("POST", "/v1/sessions/{sid}/statements", {"statement": TICKS}),
        ("POST", "/v1/sessions/{sid}/statements", {"statement": V_GROUP})],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_gateways_give_equal_responses(gateways, name):
    got = {side: _drive(gw, SCRIPTS[name]) for side, gw in gateways.items()}
    assert got["ref"] == got["port"]
    if name == "match_recognize_group_by":
        code, resp = got["port"][-1]
        assert code == 200 and len(resp["rows"]) == 16
        assert all(isinstance(v, (int, float)) for r in resp["rows"]
                   for v in r)


def test_json_safe_renders_numpy_and_torch_values():
    import numpy as np

    vals = [np.int64(3), np.float32(1.5), np.bool_(True), torch.tensor(7),
            torch.tensor([2.5]), None, "s", 4, (1, 2)]
    assert [_json_safe(v) for v in vals] == [3, 1.5, True, 7, 2.5, None, "s",
                                             4, "(1, 2)"]


def test_sessions_run_on_cuda_unless_asked():
    if torch.cuda.is_available():
        assert SqlGateway().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SqlGateway()
    gw = SqlGateway(device="cpu")
    try:
        sid = gw.open_session()
        assert gw._sessions[sid].env.device.type == "cpu"
    finally:
        gw.stop()


_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["flink_tpu"] = None
sys.path.insert(0, {root!r})
import importlib.util, json
import torch
spec = importlib.util.spec_from_file_location("chip_smoke",
                                              {root!r} + "/chip_smoke.py")
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
cs.fresh_memory = lambda torch: {{}}
torch.cuda.max_memory_allocated = lambda *a, **k: 0
cs.emit = lambda obj: None
sizes = {{"mr": {{"ticks": 1 << 12, "symbols": 1 << 6, "batch": 1 << 9}},
         "cep": {{"bids": 1 << 12, "bidders": 1 << 6, "auctions": 1 << 7,
                  "span_ms": 30_000, "batch": 1 << 8, "capacity": 1 << 9,
                  "topk": 10, "paced_s": 2.0}},
         "broadcast": {{"bids": 1 << 12, "auctions": 1 << 6,
                        "span_ms": 20_000, "batch": 1 << 8,
                        "paced_s": 2.0}},
         "async": {{"bids": 1 << 12, "auctions": 1 << 9, "batch": 1 << 7,
                    "window_capacity": 1 << 11, "topk": 10,
                    "threads": 2, "lookup_s": 1e-3, "timeout_ms": 1000,
                    "wm_interval_s": 0.5}},
         "gateway": {{"ticks": 1 << 11, "symbols": 32, "bids": 1 << 12,
                      "auctions": 1 << 8, "batch": 1 << 9}}}}
out = cs.patterns_phase(torch, torch.device("cpu"), sizes)
assert "jax" not in sys.modules or sys.modules["jax"] is None
print(json.dumps({{"matches": out["mr"]["matches"],
                  "windows_b": out["cep"]["windows"],
                  "alerts": out["broadcast"]["alerts"],
                  "windows_d": out["async"]["windows"],
                  "in_flight": out["async"]["restore"][
                      "in_flight_at_checkpoint"],
                  "groups": out["gateway"]["groups"]}}))
"""


def test_patterns_phase_runs_tiny_without_jax():
    """chip_smoke.py's patterns phase, (a) to (e), tiny on the CPU in a
    subprocess where jax and flink_tpu cannot be imported, each part
    against its oracle. (d)'s lookups are slowed (2 threads, 1 ms) so a
    batch (about 64 ms) stays well inside the watermark interval and the
    job outlasts several: its checkpoint must land between two
    watermarks, with workers beside it."""
    proc = subprocess.run([sys.executable, "-c",
                           _BLOCKED.format(root=str(ROOT))],
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["matches"] > 50 and got["windows_b"] > 5
    assert got["alerts"] > 100 and got["windows_d"] > 5
    assert got["in_flight"] > 0
    assert got["groups"] == {"mr_group_by": 32, "q17": 256}
