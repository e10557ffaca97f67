from .assigners import (  # noqa: F401
    EventTimeSessionWindows, SlidingEventTimeWindows, TimeWindow,
    TumblingEventTimeWindows, WindowAssigner,
)
