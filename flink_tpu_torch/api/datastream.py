"""DataStream API of the port (trimmed port of
``flink_tpu/api/datastream.py``): a lazy Transformation DAG of sources,
keyed exchanges, device window aggregates (one device, or a mesh of
shards: ``mesh_aggregate``, and the builtin ``sum``/``count``/``min``/
``max`` under ``state.backend.tpu.mesh-devices``), custom one-input
operators, two connected streams into one two-input operator (``connect``
then ``transform``), and sinks, compiled and run by
``StreamExecutionEnvironment.execute``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.records import RecordBatch
from ..graph.transformations import OneInputTransformation, \
    PartitionTransformation, SinkTransformation, Transformation, \
    TwoInputTransformation
from ..runtime.operators.device_session import DeviceSessionWindowOperator
from ..runtime.operators.device_window import AggSpec, \
    DeviceWindowAggOperator
from ..runtime.operators.mesh_window import MeshWindowAggOperator
from ..runtime.operators.sink import CollectSink, SinkOperator
from ..runtime.writer import GlobalPartitioner, KeyGroupPartitioner, \
    RebalancePartitioner
from ..window.assigners import EventTimeSessionWindows, WindowAssigner

__all__ = ["DataStream", "KeyedStream", "WindowedStream", "ConnectedStreams",
           "make_key_extractor"]


def make_key_extractor(key):
    """RecordBatch -> per-row keys. ``key`` is a column name; a callable
    marked ``vectorized = True``, which takes the batch and returns the
    key array (the exchange then hashes exactly that array); or a
    callable of one row (a tuple), whose results form an object array."""
    if isinstance(key, str):
        def extract(batch: RecordBatch) -> np.ndarray:
            return batch.column(key)
        extract.column = key
        return extract
    if not callable(key):
        raise ValueError(f"key_by takes a column name or a callable, "
                         f"not {key!r}")
    if getattr(key, "vectorized", False):
        return key

    def extract_rows(batch: RecordBatch) -> np.ndarray:
        out = np.empty(batch.n, dtype=object)
        out[:] = [key(r) for r in batch.iter_rows()]
        return out
    return extract_rows


class DataStream:
    def __init__(self, env, transformation: Transformation):
        self.env = env
        self.transformation = transformation
        #: the output schema of a stream the SQL planner built
        self._sql_schema = None

    def _one_input(self, name: str, factory, parallelism=None,
                   key_extractor=None, traceable=False) -> "DataStream":
        t = OneInputTransformation(
            name=name, operator_factory=factory, parallelism=parallelism,
            inputs=[self.transformation], key_extractor=key_extractor,
            traceable=traceable)
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def transform(self, name: str, operator_factory,
                  parallelism: Optional[int] = None,
                  traceable: bool = False) -> "DataStream":
        """Attach a custom one-input operator; ``traceable`` declares it
        device-safe (a pure columnwise step the fusion certifier may fuse
        through)."""
        return self._one_input(name, operator_factory, parallelism,
                               traceable=traceable)

    def key_by(self, key) -> "KeyedStream":
        """A hash exchange by key group; ``key`` as ``make_key_extractor``
        takes it. The device window operators need a column name."""
        extractor = make_key_extractor(key)
        maxp = self.env.max_parallelism
        t = PartitionTransformation(
            name="keyed-exchange",
            partitioner_factory=lambda: KeyGroupPartitioner(extractor, maxp),
            partitioner_name="hash", inputs=[self.transformation])
        self.env._transformations.append(t)
        return KeyedStream(self.env, t, extractor, key)

    def _repartition(self, name: str, factory) -> "DataStream":
        t = PartitionTransformation(
            name=name, partitioner_factory=factory, partitioner_name=name,
            inputs=[self.transformation])
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def connect(self, other: "DataStream") -> "ConnectedStreams":
        """This stream and ``other`` into one two-input operator
        (``ConnectedStreams.transform``); each input keeps its own
        exchange (``key_by`` both for a keyed join). Broadcast state is not
        ported: only a DataStream connects."""
        if not isinstance(other, DataStream):
            raise NotImplementedError(
                f"connect takes a DataStream, not {type(other).__name__}; "
                "broadcast state is not ported")
        return ConnectedStreams(self.env, self, other)

    def rebalance(self) -> "DataStream":
        return self._repartition("rebalance", RebalancePartitioner)

    def global_(self) -> "DataStream":
        """Every record to subtask 0 of the next operator."""
        return self._repartition("global", GlobalPartitioner)

    def add_sink(self, sink, name: str = "Sink",
                 parallelism: Optional[int] = None) -> "DataStream":
        """``sink``: a callable taking a batch, or an object with
        ``invoke_batch(batch)``."""
        t = SinkTransformation(name=name,
                               operator_factory=lambda: SinkOperator(sink,
                                                                     name),
                               parallelism=parallelism,
                               inputs=[self.transformation])
        self.env._transformations.append(t)
        self.env._sinks.append(t)
        return self

    def execute_and_collect(self, job_name: str = "collect") -> list:
        sink = CollectSink()
        self.add_sink(sink, "Collect")
        self.env.execute(job_name)
        return sink.rows

    def set_parallelism(self, parallelism: int) -> "DataStream":
        self.transformation.parallelism = parallelism
        return self

    def uid(self, uid: str) -> "DataStream":
        self.transformation.uid = uid
        return self

    def name(self, name: str) -> "DataStream":
        self.transformation.name = name
        return self

    def disable_chaining(self) -> "DataStream":
        self.transformation.chaining_allowed = False
        return self


class KeyedStream(DataStream):
    def __init__(self, env, transformation: Transformation, key_extractor,
                 key_spec):
        super().__init__(env, transformation)
        self.key_extractor = key_extractor
        self.key_spec = key_spec

    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)


class ConnectedStreams:
    """Two streams into one two-input operator: batches of the first
    reach ``process_batch1``, of the second ``process_batch2``."""

    def __init__(self, env, first: DataStream, second: DataStream):
        self.env = env
        self.first = first
        self.second = second

    def transform(self, name: str, operator_factory,
                  parallelism: Optional[int] = None) -> DataStream:
        """``operator_factory() -> TwoInputOperator`` (a fresh instance a
        subtask)."""
        t = TwoInputTransformation(
            name=name, operator_factory=operator_factory,
            parallelism=parallelism,
            inputs=[self.first.transformation, self.second.transformation])
        self.env._transformations.append(t)
        return DataStream(self.env, t)


class WindowedStream:
    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner):
        self.keyed = keyed
        self.assigner = assigner

    def device_aggregate(self, aggs, capacity: int = 1 << 16,
                         ring_size: int = 64,
                         emit_window_bounds: bool = True,
                         emit_topk: Optional[int] = None,
                         defer_overflow: bool = False,
                         async_fire: bool = False,
                         hbm_budget_slots: int = 0,
                         spill_staging_slots: int = 1 << 16,
                         name: str = "DeviceWindowAgg") -> DataStream:
        """Device window aggregation: rows (key, [window_start,
        window_end], *aggregates); ``emit_topk=k`` emits the top k keys by
        the first aggregate per window (the Q5 hot-items fire).
        ``hbm_budget_slots`` caps the device state and pages cold key
        groups to host RAM; ``spill_staging_slots`` is the rows the
        deferred step can stage for the host between two watermarks.

        Session windows (``EventTimeSessionWindows``) take the device
        session operator, with max(4, min(ring_size, 16)) lanes per key;
        it takes none of top k, deferred overflow, async fires or a
        budget."""
        assigner, key_col = self.assigner, self.keyed.key_spec
        if not isinstance(key_col, str):
            raise ValueError("device aggregation needs a column key")
        device = self.keyed.env.device
        if type(assigner) is EventTimeSessionWindows:
            if emit_topk is not None:
                raise ValueError(
                    "emit_topk is not supported for session windows")
            if defer_overflow or async_fire or hbm_budget_slots:
                raise ValueError(
                    "defer_overflow/async_fire/hbm_budget_slots are not "
                    "supported by the session operator yet; drop them")
            gap, lanes = assigner.gap, max(4, min(ring_size, 16))

            def session_factory():
                return DeviceSessionWindowOperator(
                    gap, key_col, aggs, capacity=capacity, lanes=lanes,
                    emit_window_bounds=emit_window_bounds, device=device,
                    name=name)

            return self.keyed._one_input(
                name, session_factory, key_extractor=self.keyed.key_extractor)

        def factory():
            return DeviceWindowAggOperator(
                assigner, key_col, aggs, capacity=capacity,
                ring_size=ring_size, emit_window_bounds=emit_window_bounds,
                emit_topk=emit_topk, defer_overflow=defer_overflow,
                async_fire=async_fire, hbm_budget_slots=hbm_budget_slots,
                spill_staging_slots=spill_staging_slots, device=device,
                name=name)

        return self.keyed._one_input(name, factory,
                                     key_extractor=self.keyed.key_extractor)

    # -- builtin aggregates -------------------------------------------------
    def sum(self, field: str, name: str = "WindowSum") -> DataStream:
        return self._builtin_agg("sum", field, name)

    def min(self, field: str, name: str = "WindowMin") -> DataStream:
        return self._builtin_agg("min", field, name)

    def max(self, field: str, name: str = "WindowMax") -> DataStream:
        return self._builtin_agg("max", field, name)

    def count(self, name: str = "WindowCount") -> DataStream:
        return self._builtin_agg("count", None, name)

    def _builtin_agg(self, kind: str, field, name: str) -> DataStream:
        """The reference's planner rule (``_try_device_agg``): with the
        ``tpu`` backend, a column key and a pane-decomposable assigner the
        aggregate runs on the device operator, or as one vertex over a mesh
        of ``state.backend.tpu.mesh-devices`` shards when that is 2 or
        more; rows (key, result). The host WindowOperator the reference
        falls back to is not ported."""
        cfg = self.keyed.env.config
        key_col = self.keyed.key_spec
        if (cfg.get("state.backend.type") != "tpu"
                or not isinstance(key_col, str)
                or not isinstance(field, (str, type(None)))
                or self.assigner.pane_size is None):
            raise NotImplementedError(
                "this window aggregate needs the host WindowOperator, which "
                "is not ported yet (ROADMAP Queue 1, item 10); use the tpu "
                "backend, a column key and a tumbling or sliding window")
        assigner = self.assigner
        device = self.keyed.env.device
        capacity = cfg.get("state.backend.tpu.slots-per-key-group") \
            or (1 << 16)
        mesh_devices = cfg.get("state.backend.tpu.mesh-devices")

        def spec():
            return AggSpec(kind, field, out_name="result")

        if mesh_devices and mesh_devices >= 2:
            def mesh_factory():
                return MeshWindowAggOperator(
                    assigner, key_col, [spec()], n_devices=mesh_devices,
                    capacity=capacity, emit_window_bounds=False,
                    device=device, name=name)

            # the mesh is the parallelism: one vertex owns every shard
            return self.keyed._one_input(
                name, mesh_factory, parallelism=1,
                key_extractor=self.keyed.key_extractor)

        def factory():
            return DeviceWindowAggOperator(
                assigner, key_col, [spec()], capacity=capacity,
                emit_window_bounds=False, device=device, name=name)

        return self.keyed._one_input(name, factory,
                                     key_extractor=self.keyed.key_extractor)

    def mesh_aggregate(self, aggs, n_devices: Optional[int] = None,
                       capacity: int = 1 << 16, ring_size: int = 64,
                       device_batch: int = 1 << 12,
                       emit_window_bounds: bool = True,
                       emit_topk: Optional[int] = None,
                       async_fire: bool = False,
                       parallelism: int = 1, devices=None,
                       name: str = "MeshWindowAgg") -> DataStream:
        """Window aggregation as one vertex over a mesh of ``n_devices``
        shards (``runtime/operators/mesh_window.py``): the keyBy is the
        exchange on the device and the state is split by key-group range
        across the shards. ``parallelism=1``: one subtask whose
        parallelism is the mesh; ``parallelism=H``: H subtasks each owning
        a key-group range that its mesh re-splits (host batches only: a
        device batch is not split by key group between subtasks).
        ``emit_topk``/``async_fire`` as in ``device_aggregate``, the top k
        ranked across every shard. ``devices``: the shards' devices
        (default: every shard on the environment's device)."""
        if not isinstance(self.keyed.key_spec, str):
            raise ValueError("mesh aggregation needs a column key")
        if emit_topk is not None and parallelism > 1:
            raise ValueError(
                "emit_topk with parallelism > 1 would rank each subtask's "
                "key range separately, not globally; run the mesh top-k "
                "at parallelism=1 or add a downstream global TopN")
        if self.assigner.pane_size is None:
            raise ValueError(
                "mesh aggregation needs a pane-decomposable assigner "
                "(tumbling, or sliding with size % slide == 0)")
        assigner, key_col = self.assigner, self.keyed.key_spec
        device = self.keyed.env.device

        def factory():
            return MeshWindowAggOperator(
                assigner, key_col, aggs, n_devices=n_devices,
                capacity=capacity, ring_size=ring_size,
                device_batch=device_batch,
                emit_window_bounds=emit_window_bounds, emit_topk=emit_topk,
                async_fire=async_fire, device=device, devices=devices,
                name=name)

        return self.keyed._one_input(name, factory, parallelism=parallelism,
                                     key_extractor=self.keyed.key_extractor)
