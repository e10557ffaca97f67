"""The LogBroker contract over TCP (port of
``flink_tpu/connectors/log_net.py``).

``LogBrokerServer`` hosts topics (an ``InMemoryLogBroker`` behind it) and
``RemoteLogBroker`` is a client with the same ``LogBroker`` interface, so
``LogSource`` and ``LogSink`` work unchanged across processes. Each
message is a length-prefixed pickle; each client connection has a thread
of its own; the state lives in the broker under its lock. A connection
opens with the cluster secret's preamble (``utils/auth.py``).
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading
from typing import Any, Optional

from ..utils import auth
from .log import InMemoryLogBroker, LogBroker

__all__ = ["LogBrokerServer", "RemoteLogBroker"]

_MSG = struct.Struct("<I")


def _send(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_MSG.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv(sock: socket.socket) -> Optional[Any]:
    head = _recv_exact(sock, _MSG.size)
    if head is None:
        return None
    body = _recv_exact(sock, _MSG.unpack(head)[0])
    return None if body is None else pickle.loads(body)


class LogBrokerServer:
    """Serves a LogBroker over TCP; a request names a method of the
    LogBroker surface and nothing else."""

    _ALLOWED = {"partitions", "poll", "append", "append_txn", "end_offset",
                "create_topic"}

    def __init__(self, backing: Optional[LogBroker] = None, port: int = 0,
                 host: str = "127.0.0.1", config=None):
        self.broker = backing or InMemoryLogBroker()
        self._secret = auth.resolve_secret(config)
        auth.check_bind(host, self._secret, "LogBrokerServer")
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(64)
        self.host, self.port = self._srv.getsockname()
        self._stop = threading.Event()
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        threading.Thread(target=self._accept, name="log-broker-accept",
                         daemon=True).start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve, args=(conn,),
                             name="log-broker-conn", daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            # the preamble comes before the first unpickle: a caller
            # without the secret never reaches pickle.loads
            if not auth.recv_hello(conn, self._secret):
                return
            while not self._stop.is_set():
                msg = _recv(conn)
                if msg is None:
                    return
                method, args = msg
                try:
                    if method not in self._ALLOWED:
                        raise AttributeError(f"no broker method {method!r}")
                    result = getattr(self.broker, method)(*args)
                    _send(conn, ("ok", result))
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

    def drop_connections(self) -> None:
        """Sever every client connection, the listener staying up (a
        broker restart, which clients survive by reconnecting)."""
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        self.drop_connections()


class RemoteLogBroker(LogBroker):
    """TCP client of a LogBrokerServer. Calls take turns on one
    connection. The wire has no request ids, so after any failed send or
    receive the connection may hold a stale response: it is closed at
    once and the next call connects afresh."""

    def __init__(self, address: str, connect_timeout: float = 5.0,
                 config=None):
        self._address = address
        self._connect_timeout = connect_timeout
        self._secret = auth.resolve_secret(config)
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        with self._lock:
            self._connect()

    def _connect(self) -> None:
        host, port = self._address.rsplit(":", 1)
        self._sock = socket.create_connection(
            (host, int(port)), timeout=self._connect_timeout)
        self._sock.settimeout(30.0)
        auth.send_hello(self._sock, self._secret)

    def _call(self, method: str, *args):
        with self._lock:
            try:
                if self._sock is None:
                    self._connect()
                _send(self._sock, (method, args))
                resp = _recv(self._sock)
            except (OSError, ConnectionError):
                self._teardown()
                raise
            if resp is None:
                self._teardown()
                raise ConnectionError("log broker connection closed")
        status, payload = resp
        if status == "err":
            raise RuntimeError(f"broker error: {payload}")
        return payload

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def create_topic(self, topic: str,
                     num_partitions: Optional[int] = None) -> None:
        self._call("create_topic", topic, num_partitions)

    def partitions(self, topic: str) -> int:
        return self._call("partitions", topic)

    def poll(self, topic, partition, offset, max_records):
        return self._call("poll", topic, partition, offset, max_records)

    def append(self, topic, partition, payloads) -> None:
        self._call("append", topic, partition, payloads)

    def append_txn(self, txn_id, topic, partition, payloads) -> None:
        self._call("append_txn", txn_id, topic, partition, payloads)

    def end_offset(self, topic, partition) -> int:
        return self._call("end_offset", topic, partition)

    def close(self) -> None:
        with self._lock:
            self._teardown()
