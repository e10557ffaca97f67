"""FileSystem abstraction: pluggable storage behind path schemes (port of
``flink_tpu/core/fs.py``).

One API over every storage the framework writes to, resolved per path
scheme, with new schemes arriving as plugins (``register_filesystem``,
``core/plugins.py``). Two file systems ship:

* ``file://`` and bare paths: local disk;
* ``mem://``: a process-global in-memory store (the object-store stand-in
  of tests; directories are implicit, as in an object store).

The operations are the ones the connectors perform: stream read and
write, atomic rename into place, list, delete, exists, size.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Callable

__all__ = ["FileSystem", "LocalFileSystem", "MemoryFileSystem",
           "get_file_system", "register_filesystem"]


class FileSystem:
    scheme = ""

    def open_read(self, path: str):
        raise NotImplementedError

    def open_write(self, path: str, append: bool = False):
        raise NotImplementedError

    def rename(self, src: str, dst: str) -> None:
        """Atomic move into place (``os.replace`` semantics)."""
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def listdir(self, path: str) -> list[str]:
        raise NotImplementedError

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def remove(self, path: str) -> None:
        raise NotImplementedError

    def is_dir(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError


class LocalFileSystem(FileSystem):
    scheme = "file"

    def open_read(self, path: str):
        return open(path, "rb")

    def open_write(self, path: str, append: bool = False):
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        return open(path, "ab" if append else "wb")

    def rename(self, src: str, dst: str) -> None:
        os.replace(src, dst)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list[str]:
        return sorted(os.listdir(path))

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove(self, path: str) -> None:
        os.remove(path)

    def is_dir(self, path: str) -> bool:
        return os.path.isdir(path)

    def size(self, path: str) -> int:
        return os.path.getsize(path)


class _MemWriteBuffer(io.BytesIO):
    """Publishes its bytes into the store on close (an object-store PUT)."""

    def __init__(self, path: str, existing: bytes = b""):
        super().__init__()
        self.write(existing)
        self._path = path

    def close(self):
        if not self.closed:
            with _MEM_LOCK:
                _MEM_FILES[self._path] = self.getvalue()
        super().close()


# process-global, under _MEM_LOCK: files outlive the FileSystem instances
# that wrote them
_MEM_FILES: dict[str, bytes] = {}
_MEM_LOCK = threading.Lock()


class MemoryFileSystem(FileSystem):
    scheme = "mem"

    def open_read(self, path: str):
        with _MEM_LOCK:
            if path not in _MEM_FILES:
                raise FileNotFoundError(path)
            return io.BytesIO(_MEM_FILES[path])

    def open_write(self, path: str, append: bool = False):
        with _MEM_LOCK:
            existing = _MEM_FILES.get(path, b"") if append else b""
        return _MemWriteBuffer(path, existing)

    def rename(self, src: str, dst: str) -> None:
        with _MEM_LOCK:
            if src not in _MEM_FILES:
                raise FileNotFoundError(src)
            _MEM_FILES[dst] = _MEM_FILES.pop(src)

    def exists(self, path: str) -> bool:
        prefix = path.rstrip("/") + "/"
        with _MEM_LOCK:
            return path in _MEM_FILES or any(k.startswith(prefix)
                                             for k in _MEM_FILES)

    def listdir(self, path: str) -> list[str]:
        prefix = path.rstrip("/") + "/"
        with _MEM_LOCK:
            names = {k[len(prefix):].split("/", 1)[0]
                     for k in _MEM_FILES if k.startswith(prefix)}
        return sorted(names)

    def makedirs(self, path: str) -> None:
        pass  # directories are implicit, as in an object store

    def remove(self, path: str) -> None:
        with _MEM_LOCK:
            if path not in _MEM_FILES:
                raise FileNotFoundError(path)
            del _MEM_FILES[path]

    def is_dir(self, path: str) -> bool:
        prefix = path.rstrip("/") + "/"
        with _MEM_LOCK:
            return any(k.startswith(prefix) for k in _MEM_FILES)

    def size(self, path: str) -> int:
        with _MEM_LOCK:
            if path not in _MEM_FILES:
                raise FileNotFoundError(path)
            return len(_MEM_FILES[path])


# scheme -> file system factory, under _REGISTRY_LOCK
_REGISTRY: dict[str, Callable[[], FileSystem]] = {
    "file": LocalFileSystem,
    "mem": MemoryFileSystem,
}
_REGISTRY_LOCK = threading.Lock()


def register_filesystem(scheme: str,
                        factory: Callable[[], FileSystem]) -> None:
    """The plugin seam: a new scheme registers a file system factory."""
    with _REGISTRY_LOCK:
        _REGISTRY[scheme] = factory


def get_file_system(path: str) -> tuple[FileSystem, str]:
    """Resolve ``scheme://rest`` to (file system, path without the scheme);
    a bare path is a local file."""
    if "://" in path:
        scheme, rest = path.split("://", 1)
        with _REGISTRY_LOCK:
            factory = _REGISTRY.get(scheme)
            known = sorted(_REGISTRY)
        if factory is None:
            raise ValueError(f"no filesystem registered for scheme "
                             f"{scheme!r} (known: {known})")
        return factory(), rest
    return LocalFileSystem(), path
