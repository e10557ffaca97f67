from .device_backend import DeviceKeyedStateBackend  # noqa: F401
