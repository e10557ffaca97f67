"""Tiered state residency: device-hot / host-warm paging of key groups
(port of ``flink_tpu/state/tiering/``).

Under an HBM budget the hot key groups stay on the device and the rest
page to the host-warm tier (``state/spill.py::HostTier``); residency is
decided by a decayed frequency and recency policy.

* :mod:`policy`: the deterministic 2Q heat policy (pure numpy, seeded
  tie-breaks, decay on the boundary cadence, never the wall clock).
* :mod:`residency`: the :class:`ResidencyManager` behind each budgeted
  backend's eviction and promotion decisions, and the process-global
  registry of residency tables.
* :mod:`prefetch`: the :class:`PrefetchPipeline` staging warm->hot
  promotions off the task's thread; promotions apply only at batch
  boundaries.
"""

from .policy import TieringPolicy
from .prefetch import PrefetchPipeline
from .residency import (
    RESIDENCY_REGISTRY, ResidencyManager, hit_ratio_series,
    register_residency, residency_table, unregister_residency,
)

__all__ = [
    "TieringPolicy", "PrefetchPipeline", "ResidencyManager",
    "RESIDENCY_REGISTRY", "register_residency", "unregister_residency",
    "residency_table", "hit_ratio_series",
]
