"""StreamExecutionEnvironment: the port's entry point (trimmed port of
``flink_tpu/api/environment.py``).

The environment records a Transformation DAG; ``execute`` compiles it
(StreamGraph -> JobGraph with chaining, and the fusion certificate under
``pipeline.fusion.enabled``) and runs it on the local cluster
(``cluster/local.py``): tasks on threads, joined by channels, with
periodic watermarks and, when enabled, aligned checkpoints.

The environment owns the job's device: ``cuda`` unless the caller passes
``device="cpu"``, and it raises without CUDA otherwise.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

from ..checkpoint.coordinator import build_restore_map
from ..checkpoint.storage import CompletedCheckpoint, load_checkpoint
from ..cluster.local import LocalJob, deploy_local, run_job
from ..connectors.datagen import CollectionSource, DataGenSource
from ..core.config import Configuration
from ..core.records import Schema
from ..core.watermarks import WatermarkStrategy
from ..device import resolve_device
from ..graph.stream_graph import JobGraph, build_job_graph, build_stream_graph
from ..graph.transformations import SourceTransformation, Transformation
from .datastream import DataStream

__all__ = ["StreamExecutionEnvironment"]


class StreamExecutionEnvironment:
    def __init__(self, config: Optional[Configuration] = None, device=None):
        self.config = config or Configuration()
        self.device = resolve_device(device)
        self._transformations: list[Transformation] = []
        self._sinks: list[Transformation] = []
        self._restore: Optional[CompletedCheckpoint] = None
        self.last_job: Optional[LocalJob] = None
        self.last_supervisor = None

    # -- config sugar ------------------------------------------------------
    @property
    def parallelism(self) -> int:
        return self.config.get("pipeline.parallelism")

    def set_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.config.set("pipeline.parallelism", p)
        return self

    @property
    def max_parallelism(self) -> int:
        return self.config.get("pipeline.max-parallelism")

    def set_max_parallelism(self, p: int) -> "StreamExecutionEnvironment":
        self.config.set("pipeline.max-parallelism", p)
        return self

    def enable_checkpointing(self, interval_seconds: float,
                             mode: str = "exactly-once"
                             ) -> "StreamExecutionEnvironment":
        self.config.set("execution.checkpointing.interval", interval_seconds)
        self.config.set("execution.checkpointing.mode", mode)
        return self

    def disable_operator_chaining(self) -> "StreamExecutionEnvironment":
        self.config.set("pipeline.operator-chaining", False)
        return self

    @property
    def state_backend(self) -> str:
        """The configured keyed-state backend (``state.backend.type``)."""
        return self.config.get("state.backend.type")

    def set_state_backend(self, name: str) -> "StreamExecutionEnvironment":
        """``tpu`` (the default): the device backend, whose row plane holds
        value state and whose operators run on the card; ``hashmap``: the
        heap backend, which holds every state kind on the host (the host
        window operator keeps its windows there under either)."""
        self.config.set("state.backend.type", name)
        return self

    def restore_from_checkpoint(self, checkpoint
                                ) -> "StreamExecutionEnvironment":
        """The next execute()/execute_async() starts from ``checkpoint``: a
        ``CompletedCheckpoint``, or the directory an ``FsCheckpointStorage``
        wrote it to. Operators map by their vertex's stable uid, so the
        pipeline may be a fresh build of the same program."""
        if isinstance(checkpoint, str):
            checkpoint = load_checkpoint(checkpoint)
        self._restore = checkpoint
        return self

    # -- sources -----------------------------------------------------------
    def from_source(self, source, watermark_strategy=None,
                    name: str = "Source",
                    parallelism: Optional[int] = None) -> DataStream:
        t = SourceTransformation(
            name=name, source=source,
            watermark_strategy=(watermark_strategy
                                or WatermarkStrategy.no_watermarks()),
            parallelism=parallelism, schema=source.schema)
        self._transformations.append(t)
        return DataStream(self, t)

    def datagen(self, gen_fn: Callable[[Any], dict], schema: Schema,
                count: Optional[int] = None,
                rate_per_sec: Optional[float] = None,
                timestamp_column: Optional[str] = None,
                watermark_strategy: Optional[WatermarkStrategy] = None,
                name: str = "DataGen", parallelism: Optional[int] = None,
                device: bool = False) -> DataStream:
        """``device=True``: ``gen_fn`` gets an int64 torch tensor of global
        indices on the job's device and returns torch columns there; the
        batches never touch the host. Otherwise it gets and returns
        numpy."""
        src = DataGenSource(gen_fn, schema, count, rate_per_sec,
                            timestamp_column, device=device)
        return self.from_source(src, watermark_strategy, name, parallelism)

    def from_collection(self, elements: Sequence[Any],
                        schema: Optional[Schema] = None,
                        timestamps: Optional[Sequence[int]] = None,
                        watermark_strategy: Optional[WatermarkStrategy] = None,
                        name: str = "Collection") -> DataStream:
        ws = watermark_strategy
        if ws is None and timestamps is not None:
            ws = WatermarkStrategy.for_monotonous_timestamps()
        return self.from_source(CollectionSource(elements, schema, timestamps),
                                ws, name, parallelism=1)

    # -- compile & run -----------------------------------------------------
    def get_job_graph(self, name: str = "job") -> JobGraph:
        if not self._sinks:
            raise RuntimeError("No sinks defined; nothing to execute")
        # the ledger attributes the job's device time to this name
        self.config.set("pipeline.name", name)
        sg = build_stream_graph(self._sinks, self.config)
        jg = build_job_graph(sg, self.config, name)
        if self.config.get("pipeline.fusion.enabled"):
            from ..graph.fusion import certify
            jg.certificate = certify(sg, jg, self.config)
        return jg

    def _take_restore_map(self, jg: JobGraph) -> Optional[dict]:
        cp, self._restore = self._restore, None
        return build_restore_map(cp, jg) if cp is not None else None

    def execute(self, job_name: str = "flink-tpu-torch-job",
                timeout: Optional[float] = None,
                recover: bool = False, metrics_registry=None) -> LocalJob:
        """Compile and run to the end of input; returns the finished job
        (also kept as ``last_job``). ``recover``: run under a
        ``JobSupervisor`` (kept as ``last_supervisor``), which restarts a
        failed job from its latest verified checkpoint, or only the failed
        pipelined regions, as ``restart-strategy.*`` allows.
        ``metrics_registry`` (``metrics/core.py``): each task's metrics
        and each operator's latency histogram register there."""
        jg = self.get_job_graph(job_name)
        if recover:
            from ..cluster.scheduler import JobSupervisor
            cp, self._restore = self._restore, None
            self.last_supervisor = JobSupervisor(jg, self.config,
                                                 self.device)
            self.last_job = self.last_supervisor.run(timeout,
                                                     initial_restore=cp)
        else:
            self.last_job = run_job(
                jg, self.config, self.device, timeout=timeout,
                restored_state=self._take_restore_map(jg),
                metrics_registry=metrics_registry)
        self._transformations, self._sinks = [], []
        return self.last_job

    def execute_async(self, job_name: str = "flink-tpu-torch-job",
                      metrics_registry=None) -> LocalJob:
        """Compile, deploy and start; returns the running job (``wait``,
        ``cancel``, and ``coordinator`` when checkpointing is on)."""
        jg = self.get_job_graph(job_name)
        job = deploy_local(jg, self.config, self.device,
                           restored_state=self._take_restore_map(jg),
                           metrics_registry=metrics_registry)
        job.start()
        self.last_job = job
        self._transformations, self._sinks = [], []
        return job
