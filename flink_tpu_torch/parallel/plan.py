"""The mesh's configuration: partition rules and the live-rescale policy
(port of ``flink_tpu/parallel/plan.py``).

``mesh.axis-rules`` names, for each leaf of the sharded window state, the
mesh axis it is split over; ``DECLARED_AXES`` lists the axes a rule may
name. The reference turns the rules into ``PartitionSpec`` pytrees that
drive ``shard_map`` and ``NamedSharding`` placement. The port has no
counterpart of ``PartitionSpec``, ``match_partition_rules`` or
``shard_map_compat``: each shard's state is a tensor of its own on its
shard's device (``sharded_window.ShardedWindowState``), a fixed layout that
is the reference's ``DEFAULT_AXIS_RULES``. So the parser and its errors are
the reference's, and ``MESH_RUNTIME.configure`` refuses any rules set in
the configuration rather than accept them and ignore them.

``MESH_RUNTIME`` is configured from the ``mesh.*`` keys by every deploy
path of the port (``cluster/local.py::deploy_local``), as ``FAULTS`` and
``WATCHDOG`` are; ``live_rescale`` and ``request_rescale`` read its policy.
"""

from __future__ import annotations

import re
import threading
from typing import NamedTuple

from .mesh import DATA_AXIS

__all__ = ["AxisRule", "DEFAULT_AXIS_RULES", "DECLARED_AXES",
           "parse_axis_rules", "MeshRuntime", "MESH_RUNTIME"]

#: every mesh axis a rule may name
DECLARED_AXES = (DATA_AXIS,)


class AxisRule(NamedTuple):
    """One ordered partition rule: leaf paths matching ``pattern`` (a full
    match against the "/"-joined path, e.g. ``accs/price``) are split over
    ``axes``; ``axes == ()`` replicates."""
    pattern: str
    axes: tuple


#: the window state's layout: every per-shard leaf over "data", the rest
#: replicated
DEFAULT_AXIS_RULES = (
    AxisRule(r"(table|dropped|keys|panes|valid)", (DATA_AXIS,)),
    AxisRule(r"(accs|cols|wins|trees|view)(/.*)?", (DATA_AXIS,)),
    AxisRule(r".*", ()),
)


def parse_axis_rules(text: str, axis_name: str = DATA_AXIS
                     ) -> tuple[AxisRule, ...]:
    """``mesh.axis-rules``: ``;``-separated ``regex=axis`` entries,
    ``regex=*`` (or ``replicated``) replicating; DEFAULT_AXIS_RULES when
    empty. A catch-all replicate rule is always appended."""
    text = (text or "").strip()
    if not text:
        return DEFAULT_AXIS_RULES
    rules = []
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(
                f"mesh.axis-rules entry {entry!r} is not 'regex=axis'")
        pattern, axis = (s.strip() for s in entry.rsplit("=", 1))
        re.compile(pattern)  # a bad regex fails at configure time
        if axis in ("*", "replicated", ""):
            rules.append(AxisRule(pattern, ()))
        else:
            if axis not in DECLARED_AXES:
                raise ValueError(
                    f"mesh.axis-rules names undeclared axis {axis!r}; "
                    f"declared: {DECLARED_AXES}")
            rules.append(AxisRule(pattern, (axis,)))
    rules.append(AxisRule(r".*", ()))
    return tuple(rules)


class MeshRuntime:
    """Process-global mesh configuration: the live-rescale policy, and a
    check of ``mesh.axis-rules``. ``configure`` is idempotent and cheap."""

    def __init__(self):
        self._lock = threading.Lock()
        self.rescale_enabled: bool = True
        self.rescale_timeout_ms: int = 30_000
        self.configured: bool = False

    def configure(self, config) -> None:
        text = config.get("mesh.axis-rules")
        parse_axis_rules(text)  # the reference's errors first
        if (text or "").strip():
            raise ValueError(
                f"mesh.axis-rules {text!r}: the port has no PartitionSpec "
                "counterpart; each shard's state is its own tensor, split "
                "over 'data' as DEFAULT_AXIS_RULES says, and no other layout "
                "is supported. Leave the key unset")
        with self._lock:
            self.rescale_enabled = bool(config.get("mesh.rescale.enabled"))
            self.rescale_timeout_ms = int(
                float(config.get("mesh.rescale.timeout")) * 1000)
            self.configured = True

    def reset(self) -> None:
        with self._lock:
            self.rescale_enabled = True
            self.rescale_timeout_ms = 30_000
            self.configured = False


MESH_RUNTIME = MeshRuntime()
