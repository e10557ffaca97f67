from .datastream import DataStream, KeyedStream, WindowedStream  # noqa: F401
from .environment import StreamExecutionEnvironment  # noqa: F401
