"""The SQL gateway: REST sessions that run statements (port of
``flink_tpu/sql/gateway.py``).

Flink's SQL gateway (SqlGatewayRestEndpoint, SqlGatewayServiceImpl): a
session owns a ``TableEnvironment``, so its catalog lives across
statements, and clients drive it with JSON over HTTP:

    POST   /v1/sessions                       -> {"session_id"}
    POST   /v1/sessions/{id}/statements       {"statement": "..."}
                                              -> {"columns", "rows"}
    GET    /v1/sessions/{id}                  -> {"session_id"}
    DELETE /v1/sessions/{id}                  -> {"status": "closed"}
    GET    /v1/info                           -> the product and version

A statement runs to its end and returns its final table (the changelog
folded), one round trip. A failing statement returns 400 with the
message; the session survives. Rows are rendered to JSON scalars (numpy
and torch values alike), so the same statement gives the same body here
as in the reference.

``device``: where each session's environment runs, ``cuda`` unless the
caller passes ``"cpu"``.

The transport carries JSON only, never pickles; but every caller gets
unauthenticated SQL, and DDL can create filesystem tables (file reads and
writes as the server's user). Keep the loopback bind, or put
authentication in front.
"""

from __future__ import annotations

import http.server
import json
import threading
import uuid
from typing import Any

import numpy as np

from ..api.environment import StreamExecutionEnvironment
from ..core.config import StateOptions
from ..device import resolve_device
from ..utils.httpd import ThreadedHTTPServer
from . import rowkind as rk
from .table_env import TableEnvironment

__all__ = ["SqlGateway"]


def _json_safe(v: Any):
    if isinstance(v, np.generic):
        return _json_safe(v.item())
    if hasattr(v, "numel") and hasattr(v, "item") and v.numel() == 1:
        return _json_safe(v.item())        # a one-element torch tensor
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    return str(v)


class _Session:
    def __init__(self, device, state_backend: str = ""):
        self.env = StreamExecutionEnvironment(device=device)
        if state_backend:
            self.env.config.set(StateOptions.BACKEND, state_backend)
        self.t_env = TableEnvironment(self.env)
        self.lock = threading.Lock()   # one statement at a time a session


class SqlGateway:
    """The gateway server, embeddable; ``start`` serves it."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 state_backend: str = "", device=None):
        self._sessions: dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._backend = state_backend
        self.device = resolve_device(device)
        gateway = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length") or 0)
                return json.loads(self.rfile.read(n) or b"{}") if n else {}

            def _parts(self) -> list:
                return self.path.strip("/").split("/")

            def do_GET(self):
                parts = self._parts()
                if parts[:2] == ["v1", "info"]:
                    return self._send(200, {"productName": "flink-tpu",
                                            "version": "0.1"})
                if len(parts) == 3 and parts[:2] == ["v1", "sessions"]:
                    if parts[2] in gateway._sessions:
                        return self._send(200, {"session_id": parts[2]})
                    return self._send(404, {"error": "unknown session"})
                return self._send(404, {"error": "not found"})

            def do_POST(self):
                parts = self._parts()
                if parts == ["v1", "sessions"]:
                    return self._send(200, {"session_id":
                                            gateway.open_session()})
                if (len(parts) == 4 and parts[:2] == ["v1", "sessions"]
                        and parts[3] == "statements"):
                    stmt = self._body().get("statement", "")
                    try:
                        out = gateway.execute(parts[2], stmt)
                    except KeyError:
                        return self._send(404, {"error": "unknown session"})
                    except Exception as e:
                        return self._send(400, {"error": str(e)})
                    return self._send(200, out)
                return self._send(404, {"error": "not found"})

            def do_DELETE(self):
                parts = self._parts()
                if len(parts) == 3 and parts[:2] == ["v1", "sessions"]:
                    gateway.close_session(parts[2])
                    return self._send(200, {"status": "closed"})
                return self._send(404, {"error": "not found"})

        self._server = ThreadedHTTPServer(Handler, port=port, host=host,
                                          name="sql-gateway")
        self.port: int = self._server.port

    # -- the service -------------------------------------------------------
    def open_session(self) -> str:
        sid = uuid.uuid4().hex[:16]
        session = _Session(self.device, self._backend)
        with self._lock:
            self._sessions[sid] = session
        return sid

    def close_session(self, sid: str) -> None:
        with self._lock:
            self._sessions.pop(sid, None)

    def execute(self, sid: str, statement: str) -> dict:
        sess = self._sessions[sid]
        with sess.lock:
            res = sess.t_env.execute_sql(statement)
        names = [n for n in res.schema.names if n != rk.ROWKIND_COLUMN]
        rows = [[_json_safe(v) for v in r] for r in res.collect_final()]
        return {"columns": names, "rows": rows}

    def start(self) -> int:
        return self._server.start()

    def stop(self) -> None:
        self._server.stop()
        with self._lock:
            self._sessions.clear()
