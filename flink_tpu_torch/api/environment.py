"""StreamExecutionEnvironment: the port's entry point (the Q5 subset of
``flink_tpu/api/environment.py``).

The environment owns the job's device: ``cuda`` unless the caller passes
``device="cpu"``, and it raises without CUDA otherwise. ``execute`` runs
every pipeline that ends in a sink on the local runner.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..connectors.datagen import CollectionSource, DataGenSource
from ..core.config import Configuration
from ..core.records import Schema
from ..core.watermarks import WatermarkStrategy
from ..device import resolve_device
from ..runtime.local import JobResult, run_pipeline
from .datastream import DataStream

__all__ = ["StreamExecutionEnvironment"]


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.config = config or Configuration()
        self.device = resolve_device(device)
        self._pipelines: list[DataStream] = []
        self.last_job: Optional[JobResult] = None

    def set_state_backend(self, name: str) -> "StreamExecutionEnvironment":
        """The port has one keyed-state backend, the device backend, under
        the reference's name ``tpu``."""
        if name not in ("tpu", "device"):
            raise ValueError(f"unknown state backend {name!r}; the port "
                             "runs the device backend ('tpu')")
        return self

    def datagen(self, gen_fn: Callable[[Any], dict], schema: Schema,
                count: Optional[int] = None,
                timestamp_column: Optional[str] = None,
                watermark_strategy: Optional[WatermarkStrategy] = None,
                name: str = "DataGen", device: bool = False) -> DataStream:
        """``device=True``: ``gen_fn`` gets an int64 torch tensor of global
        indices on the job's device and returns torch columns there; the
        batches never touch the host. Otherwise it gets and returns
        numpy."""
        src = DataGenSource(gen_fn, schema, count, timestamp_column,
                            device=device)
        return DataStream(self, src,
                          watermark_strategy or WatermarkStrategy.no_watermarks())

    def from_collection(self, elements: Sequence[Any],
                        schema: Optional[Schema] = None,
                        timestamps: Optional[Sequence[int]] = None,
                        watermark_strategy: Optional[WatermarkStrategy] = None
                        ) -> DataStream:
        ws = watermark_strategy
        if ws is None:
            ws = (WatermarkStrategy.for_monotonous_timestamps()
                  if timestamps is not None
                  else WatermarkStrategy.no_watermarks())
        return DataStream(self, CollectionSource(elements, schema, timestamps),
                          ws)

    def execute(self, job_name: str = "flink-tpu-torch-job") -> JobResult:
        """Run every pipeline that ends in a sink, one after another;
        returns the last one's result (also kept as ``last_job``)."""
        if not self._pipelines:
            raise RuntimeError("No sinks defined; nothing to execute")
        pipelines, self._pipelines = self._pipelines, []
        for p in pipelines:
            self.last_job = run_pipeline(
                job_name, p.source, p.watermark_strategy,
                [f() for f in p.factories], self.config, self.device)
        return self.last_job
