from .base import (  # noqa: F401
    CollectingOutput, OneInputOperator, OperatorContext, Output,
    TwoInputOperator,
)
from .device_session import DeviceSessionWindowOperator  # noqa: F401
from .device_window import AggSpec, DeviceWindowAggOperator  # noqa: F401
from .mesh_window import MeshWindowAggOperator  # noqa: F401
from .sink import CollectSink, SinkOperator  # noqa: F401
from .simple import BatchFnOperator, FilterOperator, FlatMapOperator, \
    KeyedProcessOperator, MapOperator  # noqa: F401
from .window import LATE_DATA_TAG, WindowOperator  # noqa: F401
