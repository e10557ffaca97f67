from .assigners import (  # noqa: F401
    SlidingEventTimeWindows, TumblingEventTimeWindows, WindowAssigner,
)
