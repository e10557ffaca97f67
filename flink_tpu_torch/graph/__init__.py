"""Graph compilation: transformations -> StreamGraph -> JobGraph, and the
fusion certifier."""

from .stream_graph import (  # noqa: F401
    JobEdge, JobGraph, JobVertex, StreamGraph, build_job_graph,
    build_stream_graph,
)
