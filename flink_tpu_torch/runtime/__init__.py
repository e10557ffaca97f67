from .harness import OneInputOperatorTestHarness  # noqa: F401
from .faults import FAULTS, DeviceGuard, DeviceSegmentError, \
    FaultInjector, InjectedFault, fire_with_retries  # noqa: F401
from .watchdog import WATCHDOG, StallError, TaskStallDetector, \
    Watchdog, stall_bounded  # noqa: F401
