"""Device-path counters of the port (trimmed ``flink_tpu/metrics``)."""

from .device import DEVICE_STATS, DeviceStats  # noqa: F401
