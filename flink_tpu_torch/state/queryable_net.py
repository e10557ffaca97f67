"""Queryable state over TCP (port of ``flink_tpu/state/queryable_net.py``).

``KvStateServer`` puts a socket in front of a job's ``KvStateRegistry``;
``RemoteQueryableStateClient`` reads through it. Frames are
length-prefixed pickles, one request and one response each:

    ("get", queryable_name, key, namespace) -> ("ok", value or None)
                                             | ("err", message)
    ("names",)                              -> ("ok", [name, ...])

Every connection opens with the preamble of ``utils/auth.py``, checked
before the first unpickle; a non-loopback bind needs the cluster secret.
Reads are dirty, as in-process.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional

from .backend import VOID_NAMESPACE
from .queryable import KvStateRegistry, UnknownKvStateError

__all__ = ["KvStateServer", "RemoteQueryableStateClient"]

_MSG = struct.Struct("<I")


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_MSG.pack(len(payload)) + payload)


def _recv(sock: socket.socket) -> Optional[Any]:
    head = b""
    while len(head) < _MSG.size:
        chunk = sock.recv(_MSG.size - len(head))
        if not chunk:
            return None
        head += chunk
    (n,) = _MSG.unpack(head)
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return pickle.loads(body)


class KvStateServer:
    """Serves a job's KvStateRegistry over TCP (port 0: any free port;
    ``address`` says which)."""

    def __init__(self, registry: KvStateRegistry, port: int = 0,
                 host: str = "127.0.0.1", config=None):
        from ..utils import auth

        self.registry = registry
        self._secret = auth.resolve_secret(config)
        auth.check_bind(host, self._secret, "KvStateServer")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, name="kvstate-accept",
                         daemon=True).start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @classmethod
    def for_job(cls, job, port: int = 0) -> "KvStateServer":
        registry = getattr(job, "kv_registry", None)
        if registry is None:
            raise ValueError("job has no KvStateRegistry")
        return cls(registry, port=port)

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="kvstate-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        from ..utils import auth

        try:
            # auth preamble precedes the first pickle read
            if not auth.recv_hello(conn, self._secret):
                return
            while not self._stop.is_set():
                msg = _recv(conn)
                if msg is None:
                    return
                try:
                    _send(conn, ("ok", self._handle(msg)))
                except Exception as e:  # noqa: BLE001 - shipped to client
                    _send(conn, ("err", f"{type(e).__name__}: {e}"))
        except OSError:
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, msg: tuple) -> Any:
        kind = msg[0]
        if kind == "get":
            _, name, key, namespace = msg
            backend, state_name = self.registry.lookup_by_key(name, key)
            return backend.read_raw(state_name, key, namespace)
        if kind == "names":
            return self.registry.names()
        raise ValueError(f"unknown request {kind!r}")

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class RemoteQueryableStateClient:
    """``QueryableStateClient`` over a ``KvStateServer``."""

    def __init__(self, address: str, connect_timeout: float = 5.0,
                 config=None):
        from ..utils import auth

        self._address = address
        self._timeout = connect_timeout
        self._secret = auth.resolve_secret(config)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self._connect()

    def _connect(self) -> None:
        from ..utils import auth

        host, port = self._address.rsplit(":", 1)
        self._sock = socket.create_connection((host, int(port)),
                                              timeout=self._timeout)
        self._sock.settimeout(30.0)
        auth.send_hello(self._sock, self._secret)

    def _call(self, msg: tuple) -> Any:
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                _send(self._sock, msg)
                resp = _recv(self._sock)
            except (OSError, ConnectionError):
                self._teardown()
                raise
            if resp is None:
                self._teardown()
                raise ConnectionError("kvstate server closed the connection")
        status, payload = resp
        if status == "err":
            if "UnknownKvStateError" in payload:
                raise UnknownKvStateError(payload)
            raise RuntimeError(f"kvstate server error: {payload}")
        return payload

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def get_kv_state(self, queryable_name: str, key: Any,
                     namespace: Any = VOID_NAMESPACE,
                     default: Any = None) -> Any:
        try:
            value = self._call(("get", queryable_name, key, namespace))
        except UnknownKvStateError:
            if queryable_name in self.names():
                return default   # name exists; this key has no state yet
            raise
        return default if value is None else value

    def names(self) -> list[str]:
        return self._call(("names",))

    def close(self) -> None:
        self._teardown()
