"""Cluster shared-secret authentication of the pickle-bearing endpoints
(trimmed port of ``flink_tpu/utils/auth.py``: what the network log broker
and the SQL layer's broker lookup use).

``connectors/log_net.py``'s server unpickles what a socket sends, which
runs code of the sender's choosing. So, as in the reference:

* the secret comes from ``security.cluster-secret``, else the
  ``FLINK_TPU_CLUSTER_SECRET`` environment variable;
* a bind to a non-loopback interface without a secret is refused (and
  warned about with one);
* each connection opens with a fixed preamble frame carrying the secret,
  checked in constant time before the first unpickle.

A loopback bind with no secret configured checks nothing: the boundary
defended is the network's.
"""

from __future__ import annotations

import hmac
import os
import socket
import struct
import warnings

__all__ = ["ENV_VAR", "resolve_secret", "is_loopback", "check_bind",
           "send_hello", "recv_hello"]

ENV_VAR = "FLINK_TPU_CLUSTER_SECRET"
_MAGIC = b"FTA1"
_HELLO = struct.Struct("<4sH")
_MAX_TOKEN = 1024


def resolve_secret(config=None) -> str:
    """The configuration's secret, else the environment's, else ''."""
    if config is not None:
        from ..core.config import SecurityOptions

        s = config.get(SecurityOptions.CLUSTER_SECRET)
        if s:
            return s
    return os.environ.get(ENV_VAR, "")


def is_loopback(host: str) -> bool:
    # "", "0.0.0.0" and "::" are every interface: the opposite of loopback
    return host in ("localhost", "127.0.0.1", "::1") or \
        host.startswith("127.")


def check_bind(host: str, secret: str, endpoint: str) -> None:
    """Refuse a non-loopback bind without a secret; warn with one."""
    if is_loopback(host):
        return
    if not secret:
        raise RuntimeError(
            f"{endpoint} deserializes pickle from the network and would "
            f"bind non-loopback host {host!r} WITHOUT a cluster secret. "
            f"Set {ENV_VAR} (or security.cluster-secret) on every process, "
            "or bind loopback. Refusing to start an unauthenticated pickle "
            "endpoint on a routable interface.")
    warnings.warn(
        f"{endpoint} binding non-loopback host {host!r}: connections are "
        "authenticated with the cluster secret, but pickle endpoints "
        "should additionally sit behind network-level access control",
        RuntimeWarning, stacklevel=3)


def send_hello(sock: socket.socket, secret: str) -> None:
    """The client's preamble, sent on every connection (an empty token
    without a secret, so the framing never changes)."""
    tok = secret.encode("utf-8")
    sock.sendall(_HELLO.pack(_MAGIC, len(tok)) + tok)


def recv_hello(sock: socket.socket, secret: str) -> bool:
    """The server's side: read the preamble and decide before any pickle
    frame is read. False: drop the connection."""
    buf = b""
    while len(buf) < _HELLO.size:
        chunk = sock.recv(_HELLO.size - len(buf))
        if not chunk:
            return False
        buf += chunk
    magic, n = _HELLO.unpack(buf)
    if magic != _MAGIC or n > _MAX_TOKEN:
        return False
    tok = b""
    while len(tok) < n:
        chunk = sock.recv(n - len(tok))
        if not chunk:
            return False
        tok += chunk
    if not secret:
        return True
    return hmac.compare_digest(tok, secret.encode("utf-8"))
