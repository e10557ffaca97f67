"""Plugin SPI: load extension modules from plugin directories (port of
``flink_tpu/core/plugins.py``).

Each ``*.py`` file of a plugin directory loads as a module of its own,
under a unique name (no collision in ``sys.modules`` between two
plugins, nothing leaking between them), and its hook populates a
registry of extension points:

    # plugins/my_fs.py
    def register(registry):
        registry.filesystem("s3", MyS3FileSystem)
        registry.state_backend("rocks2", MyBackend)
        registry.connector("my-source", source=my_source_factory)
        registry.metric_reporter("my-reporter", MyReporter)

The extension points are the framework's seams: path-scheme filesystems
(``core/fs.py``), state backends (``state/backend.py``), SQL connectors
(``sql/ddl.py``) and metric reporters, resolved by name from
``metrics.reporters`` (``metrics/reporters.py``).
"""

from __future__ import annotations

import importlib.util
import os
import uuid
from typing import Any, Callable

__all__ = ["PluginRegistry", "PluginManager"]

class PluginRegistry:
    """The extension points a plugin's ``register(registry)`` hook can
    populate."""

    def __init__(self):
        self.loaded: list[str] = []           # plugin names, in load order

    @property
    def connectors(self) -> dict:
        """A copy of the SQL layer's table of plugin connectors."""
        from ..sql.ddl import _PLUGIN_CONNECTORS
        return dict(_PLUGIN_CONNECTORS)

    @property
    def metric_reporters(self) -> dict:
        """A copy of the reporter factories by name."""
        from ..metrics.reporters import _REPORTER_FACTORIES
        return dict(_REPORTER_FACTORIES)

    def filesystem(self, scheme: str, factory: Callable) -> None:
        from .fs import register_filesystem
        register_filesystem(scheme, factory)

    def state_backend(self, name: str, cls: Any) -> None:
        from ..state.backend import register_backend
        register_backend(name, cls)

    def connector(self, name: str, source: Callable = None,
                  sink: Callable = None) -> None:
        """A SQL connector: ``source(env, catalog_table) -> DataStream``,
        ``sink(catalog_table) -> Sink | SinkFunction``. The DDL looks
        plugin connectors up after the built-in ones."""
        from ..sql.ddl import register_connector
        register_connector(name, source=source, sink=sink)

    def metric_reporter(self, name: str, factory: Callable) -> None:
        """A reporter ``metrics.reporters`` can name."""
        from ..metrics.reporters import register_reporter
        register_reporter(name, factory)


class PluginManager:
    """Loads every ``*.py`` of the given directories (names starting with
    ``_`` excepted) as a module of its own and calls its
    ``register(registry)`` hook; a plugin that fails is recorded in
    ``errors`` and the others load."""

    def __init__(self, plugin_dirs: list[str]):
        self.plugin_dirs = list(plugin_dirs)
        self.registry = PluginRegistry()
        self.errors: list[tuple[str, str]] = []   # (path, error)

    def load_all(self) -> PluginRegistry:
        for d in self.plugin_dirs:
            if not os.path.isdir(d):
                continue
            for name in sorted(os.listdir(d)):
                if name.endswith(".py") and not name.startswith("_"):
                    self._load_one(os.path.join(d, name))
        return self.registry

    def _load_one(self, path: str) -> None:
        mod_name = f"flink_tpu_torch_plugin_{uuid.uuid4().hex[:8]}"
        try:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            hook = getattr(module, "register", None)
            if hook is None:
                self.errors.append((path, "no register(registry) hook"))
                return
            hook(self.registry)
            self.registry.loaded.append(os.path.basename(path)[:-3])
        except Exception as e:  # noqa: BLE001 - a bad plugin must not kill
            self.errors.append((path, f"{type(e).__name__}: {e}"))
