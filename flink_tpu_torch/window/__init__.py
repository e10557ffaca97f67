from .assigners import (  # noqa: F401
    CumulateWindows, EventTimeSessionWindows, GlobalWindow, GlobalWindows,
    ProcessingTimeSessionWindows, SlidingEventTimeWindows,
    SlidingProcessingTimeWindows, TimeWindow, TumblingEventTimeWindows,
    TumblingProcessingTimeWindows, WindowAssigner,
)
from .triggers import (  # noqa: F401
    ContinuousEventTimeTrigger, CountEvictor, CountTrigger,
    EventTimeTrigger, Evictor, NeverTrigger, ProcessingTimeTrigger,
    PurgingTrigger, TimeEvictor, Trigger, TriggerContext, TriggerResult,
)
