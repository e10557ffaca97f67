"""DataStream API of the port (port of ``flink_tpu/api/datastream.py``):
a lazy Transformation DAG compiled and run by
``StreamExecutionEnvironment.execute``.

* Stateless steps: ``map``, ``flat_map``, ``filter`` (a function's
  vectorized path runs torch ops on a device batch where it lies),
  ``process``, custom one-input operators (``transform``).
* Exchanges: ``key_by``, ``rebalance``, ``rescale``, ``broadcast``,
  ``shuffle``, ``global_``, ``forward``, ``partition_custom``; ``union``;
  tagged side outputs (``get_side_output``).
* Keyed: ``process`` with keyed state and timers, the rolling ``reduce``
  and ``sum``/``min``/``max``, ``window``, ``count_window``.
* Windows: the device window aggregates (one device, or a mesh of
  shards: ``mesh_aggregate``), and the host WindowOperator with
  ``trigger``, ``evictor``, ``allowed_lateness``,
  ``side_output_late_data``, ``reduce``, ``aggregate`` and ``apply``.
  The builtin ``sum``/``count``/``min``/``max`` take the device operator
  where the reference's planner rule does, else the host operator.
* Two connected streams into one two-input operator (``connect`` then
  ``transform``), and sinks.
* The broadcast state pattern: ``keyed.connect(rules.broadcast(desc))
  .process(KeyedBroadcastProcessFunction)``; asynchronous lookups
  (``async_io``).
* Iterations: ``iterate(max_wait_s)`` opens a loop; the body built on
  the returned ``IterativeStream`` routes batches back into its head with
  ``close_with(stream)``. The head ends once its input ended and the loop
  stayed quiet for ``max_wait_s``; a job with an iteration takes no
  checkpoint.
"""

from __future__ import annotations

import operator as _op
from typing import Any, Callable, Optional, Union

import numpy as np

from ..core.functions import AggregateFunction, ProcessFunction, \
    SinkFunction, as_filter, as_flat_map, as_map, as_reduce, \
    copy_per_subtask
from ..core.records import RecordBatch, Schema
from ..graph.transformations import FeedbackTransformation, \
    OneInputTransformation, PartitionTransformation, \
    SideOutputTransformation, SinkTransformation, Transformation, \
    TwoInputTransformation, UnionTransformation
from ..runtime.operators.async_io import AsyncWaitOperator
from ..runtime.operators.co_broadcast import CoBroadcastWithKeyedOperator
from ..runtime.operators.device_session import DeviceSessionWindowOperator
from ..runtime.operators.device_window import AggSpec, \
    DeviceWindowAggOperator
from ..runtime.operators.mesh_window import MeshWindowAggOperator
from ..runtime.operators.simple import FilterOperator, FlatMapOperator, \
    KeyedProcessOperator, MapOperator
from ..runtime.operators.sink import CollectSink, FunctionSinkOperator, \
    SinkOperator
from ..runtime.operators.window import WindowOperator
from ..runtime.writer import BroadcastPartitioner, CustomPartitioner, \
    ForwardPartitioner, GlobalPartitioner, KeyGroupPartitioner, \
    RebalancePartitioner, RescalePartitioner, ShufflePartitioner
from ..state.descriptors import ReducingStateDescriptor
from ..window.assigners import CumulateWindows, EventTimeSessionWindows, \
    GlobalWindows, WindowAssigner, reject_variable_pane_assigner
from ..window.triggers import CountTrigger, Evictor, PurgingTrigger, \
    Trigger

__all__ = ["DataStream", "KeyedStream", "WindowedStream", "ConnectedStreams",
           "BroadcastStream", "BroadcastConnectedStream", "IterativeStream",
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

    # -- stateless steps -----------------------------------------------------
    def map(self, fn, name: str = "Map", out_schema: Optional[Schema] = None,
            parallelism: Optional[int] = None) -> "DataStream":
        """A transform a row (or a batch, through ``map_batch``). A tuple
        of the input's arity keeps the input's column names; a map that
        reorders or replaces fields names them with ``out_schema``."""
        mf = as_map(fn)
        return self._one_input(
            name, lambda: MapOperator(mf, out_schema, name), parallelism)

    def flat_map(self, fn, name: str = "FlatMap",
                 out_schema: Optional[Schema] = None,
                 parallelism: Optional[int] = None) -> "DataStream":
        ff = as_flat_map(fn)
        return self._one_input(
            name, lambda: FlatMapOperator(ff, out_schema, name), parallelism)

    def filter(self, fn, name: str = "Filter",
               parallelism: Optional[int] = None) -> "DataStream":
        pf = as_filter(fn)
        return self._one_input(name, lambda: FilterOperator(pf, name),
                               parallelism)

    def process(self, fn: ProcessFunction, name: str = "Process",
                parallelism: Optional[int] = None) -> "DataStream":
        """A process function over the whole stream: one pseudo-key, so
        its state and timers are the subtask's."""
        device = self.env.device

        def extract(batch: RecordBatch) -> np.ndarray:
            return np.zeros(batch.n, dtype=np.int64)

        return self._one_input(
            name, lambda: KeyedProcessOperator(fn, extract, name=name,
                                               device=device), parallelism)

    def async_io(self, fn, capacity: int = 100,
                 timeout_ms: Optional[int] = None, mode: str = "ordered",
                 retry=None, on_timeout: str = "fail",
                 out_schema: Optional[Schema] = None,
                 parallelism: Optional[int] = None,
                 name: str = "AsyncIO") -> "DataStream":
        """Asynchronous lookups (Flink's AsyncDataStream.orderedWait and
        unorderedWait): ``fn`` is an ``AsyncFunction``
        (``runtime/operators/async_io.py``). Each subtask gets its own
        copy, so a function makes its pools and clients in ``open()``."""
        return self._one_input(
            name, lambda: AsyncWaitOperator(
                copy_per_subtask(fn), capacity=capacity,
                timeout_ms=timeout_ms, mode=mode, retry=retry,
                on_timeout=on_timeout, out_schema=out_schema, name=name),
            parallelism=parallelism)

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
        exchange (``key_by`` both for a keyed join). A broadcast stream
        connects to a keyed stream only."""
        if isinstance(other, BroadcastStream):
            raise NotImplementedError(
                "broadcast state requires a KEYED stream: use "
                "ds.key_by(...).connect(rules.broadcast(desc)) with a "
                "KeyedBroadcastProcessFunction (the non-keyed "
                "BroadcastProcessFunction is not implemented, and dropping "
                "the descriptors would run the job with no broadcast "
                "state)")
        if not isinstance(other, DataStream):
            raise NotImplementedError(
                f"connect takes a DataStream, not {type(other).__name__}")
        return ConnectedStreams(self.env, self, other)

    def rebalance(self) -> "DataStream":
        return self._repartition("rebalance", RebalancePartitioner)

    def rescale(self) -> "DataStream":
        return self._repartition("rescale", RescalePartitioner)

    def broadcast(self, *descriptors):
        """Every record to every subtask of the next operator. With map
        state descriptors, a ``BroadcastStream`` for the broadcast state
        pattern: ``keyed.connect(rules.broadcast(desc)).process(fn)``."""
        replicated = self._repartition("broadcast", BroadcastPartitioner)
        if descriptors:
            return BroadcastStream(self.env, replicated.transformation,
                                   descriptors)
        return replicated

    def shuffle(self) -> "DataStream":
        return self._repartition("shuffle", ShufflePartitioner)

    def global_(self) -> "DataStream":
        """Every record to subtask 0 of the next operator."""
        return self._repartition("global", GlobalPartitioner)

    def forward(self) -> "DataStream":
        return self._repartition("forward", ForwardPartitioner)

    def partition_custom(self, fn: Callable[[Any, int], int],
                         key) -> "DataStream":
        """``fn(key, num_channels) -> channel`` a record."""
        extractor = make_key_extractor(key)
        return self._repartition(
            "custom", lambda: CustomPartitioner(fn, extractor))

    def union(self, *others: "DataStream") -> "DataStream":
        t = UnionTransformation(
            name="union",
            inputs=[self.transformation] + [o.transformation for o in others])
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def iterate(self, max_wait_s: float = 2.0) -> "IterativeStream":
        """Open a feedback loop: build its body on the returned stream,
        then ``close_with(feedback_stream)`` routes that stream's batches
        back into the head. The head ends once this stream ended and the
        loop stayed quiet for ``max_wait_s``, which must exceed the body's
        longest time for a batch: rows still inside the body then are
        lost, as in the reference. Iterations take no checkpoint (the
        deploy refuses one with periodic checkpoints)."""
        t = FeedbackTransformation(name="iteration",
                                   inputs=[self.transformation],
                                   max_wait_s=max_wait_s)
        self.env._transformations.append(t)
        return IterativeStream(self.env, t)

    def get_side_output(self, tag: str) -> "DataStream":
        """The batches this stream's operator emits under ``tag``."""
        t = SideOutputTransformation(name=f"side-{tag}", tag=tag,
                                     inputs=[self.transformation])
        self.env._transformations.append(t)
        return DataStream(self.env, t)

    def window_all(self, assigner: WindowAssigner) -> "WindowedStream":
        """Windows over the whole stream: one pseudo-key, parallelism 1."""
        keyed = self.global_().key_by(lambda _row: 0)
        return WindowedStream(keyed, assigner, all_windows=True)

    def add_sink(self, sink, name: str = "Sink",
                 parallelism: Optional[int] = None) -> "DataStream":
        """``sink``: a ``SinkFunction``, a ``connectors.core.Sink``, a
        callable taking a batch, or an object with
        ``invoke_batch(batch)``."""
        if isinstance(sink, SinkFunction):
            def factory():
                return FunctionSinkOperator(sink, name)
        else:
            def factory():
                return SinkOperator(sink, name)
        t = SinkTransformation(name=name, operator_factory=factory,
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


class IterativeStream(DataStream):
    """The head of a feedback loop; ``close_with`` adds the back edge."""

    def close_with(self, feedback: DataStream) -> DataStream:
        """Route ``feedback``'s batches back into the loop's head; returns
        ``feedback``, so the loop's exit can go on from it."""
        self.transformation.feedback_inputs.append(feedback.transformation)
        return feedback


class BroadcastStream:
    """A broadcast stream bound to the map state descriptors of the
    broadcast state it feeds."""

    def __init__(self, env, transformation: Transformation, descriptors):
        self.env = env
        self.transformation = transformation
        self.descriptors = list(descriptors)


class BroadcastConnectedStream:
    """A keyed stream and a broadcast stream awaiting a
    ``KeyedBroadcastProcessFunction``."""

    def __init__(self, env, keyed: "KeyedStream",
                 broadcast: BroadcastStream):
        self.env = env
        self.keyed = keyed
        self.broadcast = broadcast

    def process(self, fn, name: str = "CoBroadcastWithKeyed",
                out_schema: Optional[Schema] = None,
                parallelism: Optional[int] = None) -> DataStream:
        """The keyed side's state is the configured backend's, on the
        environment's device."""
        ke, device = self.keyed.key_extractor, self.env.device
        descs = tuple(self.broadcast.descriptors)
        t = TwoInputTransformation(
            name=name,
            operator_factory=lambda: CoBroadcastWithKeyedOperator(
                fn, ke, descs, out_schema=out_schema, name=name,
                device=device),
            parallelism=parallelism,
            inputs=[self.keyed.transformation,
                    self.broadcast.transformation],
            key_extractor1=ke)
        self.env._transformations.append(t)
        return DataStream(self.env, t)


class KeyedStream(DataStream):
    def __init__(self, env, transformation: Transformation, key_extractor,
                 key_spec):
        super().__init__(env, transformation)
        self.key_extractor = key_extractor
        self.key_spec = key_spec

    def connect(self, other):
        """A broadcast stream gives a ``BroadcastConnectedStream``, any
        other stream ``ConnectedStreams``."""
        if isinstance(other, BroadcastStream):
            return BroadcastConnectedStream(self.env, self, other)
        return super().connect(other)

    def process(self, fn: ProcessFunction, name: str = "KeyedProcess",
                parallelism: Optional[int] = None) -> DataStream:
        """A process function a record, with keyed state on the configured
        backend (``tpu``: the device row plane, ValueState only;
        ``hashmap``: every kind) and event- and processing-time timers."""
        ke, device = self.key_extractor, self.env.device
        return self._one_input(
            name, lambda: KeyedProcessOperator(fn, ke, name=name,
                                               device=device),
            parallelism, key_extractor=ke)

    # -- rolling (non-windowed) aggregation -------------------------------
    def reduce(self, fn, name: str = "KeyedReduce") -> DataStream:
        """The running reduce of each key, one row a record (a reducing
        state: the ``hashmap`` backend holds it)."""
        rf = as_reduce(fn)

        class _RollingReduce(ProcessFunction):
            def open(self, ctx):
                self._desc = ReducingStateDescriptor("rolling-reduce", rf)
                self._ctx = ctx

            def process_element(self, value, ctx, out):
                state = self._ctx.get_state(self._desc)
                state.add(value)
                out.collect(state.get(), ctx.timestamp)

        return self.process(_RollingReduce(), name)

    def sum(self, field: int, name: str = "KeyedSum") -> DataStream:
        return self._rolling_builtin("sum", field, name)

    def min(self, field: int, name: str = "KeyedMin") -> DataStream:
        return self._rolling_builtin("min", field, name)

    def max(self, field: int, name: str = "KeyedMax") -> DataStream:
        return self._rolling_builtin("max", field, name)

    def _rolling_builtin(self, kind: str, field, name: str) -> DataStream:
        if isinstance(field, str):
            raise NotImplementedError(
                "string fields on rolling agg need tuple index; use window "
                "aggregation or pass an int index")
        pick = _op.itemgetter(field)

        def combine(a, b):
            va, vb = pick(a), pick(b)
            v = va + vb if kind == "sum" else (
                min(va, vb) if kind == "min" else max(va, vb))
            # the latest record's other fields, the aggregated field set
            if isinstance(b, tuple):
                out = list(b)
                out[field] = v
                return tuple(out)
            return v

        return self.reduce(combine, name)

    # -- windows -----------------------------------------------------------
    def window(self, assigner: WindowAssigner) -> "WindowedStream":
        return WindowedStream(self, assigner)

    def count_window(self, size: int) -> "WindowedStream":
        """Windows of ``size`` records a key, purged at each fire."""
        return WindowedStream(self, GlobalWindows.create(),
                              trigger=PurgingTrigger.of(CountTrigger.of(size)))


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
    """A keyed stream with an assigner, and the trigger, evictor and
    lateness of the host operator; it ends in a device aggregate or in
    ``reduce``/``aggregate``/``apply`` on the host."""

    def __init__(self, keyed: KeyedStream, assigner: WindowAssigner,
                 trigger: Optional[Trigger] = None,
                 evictor: Optional[Evictor] = None,
                 all_windows: bool = False):
        self.keyed = keyed
        self.assigner = assigner
        self._trigger = trigger
        self._evictor = evictor
        self._lateness = 0
        self._late_tag: Optional[str] = None
        self._all = all_windows

    def trigger(self, trigger: Trigger) -> "WindowedStream":
        self._trigger = trigger
        return self

    def evictor(self, evictor: Evictor) -> "WindowedStream":
        self._evictor = evictor
        return self

    def allowed_lateness(self, ms: int) -> "WindowedStream":
        self._lateness = int(ms)
        return self

    def side_output_late_data(self, tag: str = "late-data"
                              ) -> "WindowedStream":
        """Late records go to the operator's ``late-data`` side output."""
        self._late_tag = tag
        return self

    def _parallelism(self) -> Optional[int]:
        return 1 if self._all else None

    def _build(self, name, aggregate=None, reduce=None, window_fn=None,
               out_schema=None) -> DataStream:
        """The host WindowOperator."""
        assigner, trigger, evictor = self.assigner, self._trigger, \
            self._evictor
        lateness, late = self._lateness, self._late_tag
        ke = self.keyed.key_extractor

        def factory():
            return WindowOperator(
                assigner, ke, aggregate=aggregate, reduce=reduce,
                window_fn=window_fn, trigger=trigger, evictor=evictor,
                allowed_lateness=lateness, emit_late_data=late is not None,
                out_schema=out_schema, name=name)

        return self.keyed._one_input(name, factory,
                                     parallelism=self._parallelism(),
                                     key_extractor=ke)

    def reduce(self, fn, name: str = "WindowReduce",
               window_fn=None) -> DataStream:
        return self._build(name, reduce=as_reduce(fn), window_fn=window_fn)

    def aggregate(self, fn: AggregateFunction, name: str = "WindowAggregate",
                  window_fn=None) -> DataStream:
        return self._build(name, aggregate=fn, window_fn=window_fn)

    def apply(self, window_fn, name: str = "WindowApply") -> DataStream:
        """``window_fn(key, window, elements: list)`` -> rows."""
        return self._build(name, window_fn=window_fn)

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
        par = self._parallelism()
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
                name, session_factory, parallelism=par,
                key_extractor=self.keyed.key_extractor)

        reject_variable_pane_assigner(assigner, "device")

        def factory():
            return DeviceWindowAggOperator(
                assigner, key_col, aggs, capacity=capacity,
                ring_size=ring_size, emit_window_bounds=emit_window_bounds,
                emit_topk=emit_topk, defer_overflow=defer_overflow,
                async_fire=async_fire, hbm_budget_slots=hbm_budget_slots,
                spill_staging_slots=spill_staging_slots, device=device,
                name=name)

        return self.keyed._one_input(name, factory, parallelism=par,
                                     key_extractor=self.keyed.key_extractor)

    # -- builtin aggregates -------------------------------------------------
    def sum(self, field: Union[str, int],
            name: str = "WindowSum") -> DataStream:
        return self._builtin_agg("sum", field, name)

    def min(self, field: Union[str, int],
            name: str = "WindowMin") -> DataStream:
        return self._builtin_agg("min", field, name)

    def max(self, field: Union[str, int],
            name: str = "WindowMax") -> DataStream:
        return self._builtin_agg("max", field, name)

    def count(self, name: str = "WindowCount") -> DataStream:
        return self._builtin_agg("count", None, name)

    def _builtin_agg(self, kind: str, field, name: str) -> DataStream:
        """The device window operator where the reference's planner rule
        (``_try_device_agg``) takes it, else the host WindowOperator over
        a field-wise aggregate; rows (key, result) either way."""
        device = self._try_device_agg(kind, field, name)
        if device is not None:
            return device
        return self._build(name, aggregate=_BuiltinAggregate(kind, field))

    def _try_device_agg(self, kind: str, field, name: str
                        ) -> Optional[DataStream]:
        """With the ``tpu`` backend, a column key, a pane-decomposable
        assigner that is not CUMULATE, and no custom trigger, evictor or
        lateness, the aggregate runs on the device operator, or as one
        vertex over a mesh of ``state.backend.tpu.mesh-devices`` shards
        when that is 2 or more. None otherwise."""
        cfg = self.keyed.env.config
        if (cfg.get("state.backend.type") != "tpu"
                or not isinstance(self.keyed.key_spec, str)
                or not isinstance(field, (str, type(None)))
                or self.assigner.pane_size is None
                or isinstance(self.assigner, CumulateWindows)
                or self._trigger is not None or self._evictor is not None
                or self._lateness != 0 or self._late_tag is not None):
            return None
        assigner, key_col = self.assigner, self.keyed.key_spec
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
                                     parallelism=self._parallelism(),
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
        reject_variable_pane_assigner(self.assigner, "mesh")
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


class _BuiltinAggregate(AggregateFunction):
    """A field-wise builtin aggregate on the host WindowOperator.
    ``bind_schema`` resolves a string field to the tuple index of the
    batch's schema (the operator calls it a batch); ``builtin_kind`` and
    ``builtin_field`` let the operator's grouped path fold a column with
    numpy instead of calling ``add`` a row."""

    def __init__(self, kind: str, field):
        self.builtin_kind = kind
        self.builtin_field = field
        self._pick = (_op.itemgetter(field) if isinstance(field, int)
                      else None)

    def bind_schema(self, schema) -> None:
        if isinstance(self.builtin_field, str):
            self._pick = (
                (lambda v: v) if len(schema) == 1
                else _op.itemgetter(schema.index_of(self.builtin_field)))

    def create_accumulator(self):
        return None

    def _combine(self, a, b):
        if self.builtin_kind in ("sum", "count"):
            return a + b
        return min(a, b) if self.builtin_kind == "min" else max(a, b)

    def add(self, value, acc):
        v = 1 if self.builtin_field is None else self._pick(value)
        return v if acc is None else self._combine(acc, v)

    def merge(self, a, b):
        if a is None:
            return b
        if b is None:
            return a
        return self._combine(a, b)

    def get_result(self, acc):
        return acc
