"""A threaded HTTP server on a port of its own (port of
``flink_tpu/utils/httpd.py``): the scaffolding of the SQL gateway."""

from __future__ import annotations

import http.server
import socketserver
import threading
from typing import Type

__all__ = ["ThreadedHTTPServer"]


class ThreadedHTTPServer:
    """A threaded HTTP server, by default on loopback and a free port;
    ``start`` serves it on a daemon thread, ``stop`` shuts it down."""

    def __init__(self, handler: Type[http.server.BaseHTTPRequestHandler],
                 port: int = 0, host: str = "127.0.0.1",
                 name: str = "httpd"):
        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._httpd = _Server((host, port), handler)
        self.port: int = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name=name, daemon=True)

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        # shutdown() waits for serve_forever, so only a started one
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
