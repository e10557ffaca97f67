"""Job configuration: the string keys the port reads.

A trimmed stand-in for ``flink_tpu/core/config.py``'s typed options. Keys
and defaults match the reference's, so one dict of settings drives both.
Durations are seconds (a number, or a string such as ``"5 ms"``).
"""

from __future__ import annotations

import re
from typing import Any, Optional

__all__ = ["Configuration", "DEFAULTS", "SqlOptions", "StateOptions",
           "MeshOptions", "ProfilerOptions", "AotOptions", "SecurityOptions",
           "WatchdogOptions", "MetricOptions", "TraceOptions", "all_options",
           "generate_config_docs"]

#: key -> default (reference: PipelineOptions / CheckpointingOptions /
#: TaskOptions / WindowOptions)
DEFAULTS: dict[str, Any] = {
    # the job's name; the device-time ledger attributes samples to it
    "pipeline.name": "flink-tpu-job",
    "pipeline.parallelism": 1,
    "pipeline.max-parallelism": 128,
    "pipeline.micro-batch-size": 4096,
    # fuse compatible adjacent operators into one task
    "pipeline.operator-chaining": True,
    # periodic watermark emission of a source task (seconds of wall time;
    # 0 emits after every batch)
    "pipeline.auto-watermark-interval": 0.2,
    # size each source batch to a latency target (the reference's
    # BufferDebloater analog: size = throughput x target, EMA-smoothed),
    # between the min and max clamps
    "pipeline.adaptive-batch-size": False,
    "pipeline.adaptive-batch-size.target-latency": 0.1,
    "pipeline.adaptive-batch-size.min": 64,
    "pipeline.adaptive-batch-size.max": 1 << 20,
    # certify chains (graph/fusion.py) and lower a certified source ->
    # window prefix to one dispatch per micro-batch; also lets a hash edge
    # chain at parallelism 1 into a device window aggregate
    "pipeline.fusion.enabled": False,
    # seconds between checkpoints; 0 disables periodic checkpoints
    "execution.checkpointing.interval": 0.0,
    # exactly-once (aligned barriers) or at-least-once
    "execution.checkpointing.mode": "exactly-once",
    "execution.checkpointing.timeout": 600.0,
    # checkpoint directory; in-memory storage when unset
    "execution.checkpointing.dir": None,
    # completed checkpoints kept before subsumption (savepoints apart)
    "execution.checkpointing.num-retained": 1,
    # unaligned barriers: the first barrier at a gate fires at once, and
    # the batches still queued ahead of the other channels' barriers go
    # into the checkpoint as in-flight data
    "execution.checkpointing.unaligned": False,
    # an aligned checkpoint whose alignment stalls longer than this turns
    # unaligned (seconds; 0: never)
    "execution.checkpointing.aligned-checkpoint-timeout": 0.0,
    # seconds between latency markers a source injects; each operator
    # records source-to-here ms into its "latency" histogram (0: off)
    "metrics.latency.interval": 0.0,
    # metric reporters (reference MetricOptions): comma-separated names
    # ("log", "prometheus", or a plugin's) that reporters_from_config
    # builds, and the logging reporter's period
    "metrics.reporters": "",
    "metrics.reporter.interval": 10.0,
    # causal tracing and the flight recorder (reference TraceOptions): the
    # master switch, the spans the in-memory ring keeps, the recorder's
    # ring, its dump directory (empty: <tmpdir>/flink_tpu_flight) and the
    # least seconds between two dumps of one reason
    "traces.enabled": True,
    "traces.max-retained": 4096,
    "traces.flight-recorder.capacity": 512,
    "traces.flight-recorder.dir": "",
    "traces.flight-recorder.min-interval": 1.0,
    "task.max-inflight": 2,
    # coalesce consecutive same-schema micro-batches host-side up to this
    # many records, then run one ingest step (0/1: off)
    "task.coalesce.target-records": 0,
    # age deadline of a non-empty coalescing buffer, checked when the next
    # batch arrives (0: none)
    "task.coalesce.timeout-ms": 0,
    # incremental fires: a running window accumulator per invertible
    # aggregate and a merge tree per min/max, sealed once per pane
    "window.fire.incremental": False,
    # the keyed-state backend: "tpu" is the device backend (its row plane
    # holds value state; the device operators and the interval join's
    # device lists run on the card), "hashmap" the heap backend, which
    # holds every state kind on the host (host window operators, process
    # functions, host joins and GROUP BY)
    "state.backend.type": "tpu",
    # the changelog backend: checkpoints between two materializations of
    # its base (the log holds the changes in between)
    "state.backend.changelog.materialization-interval": 10,
    # most device hash-table slots of keyed state; state beyond them pages
    # to the host spill tier at key-group granularity (0: unlimited)
    "state.backend.tpu.hbm-budget-slots": 0,
    # the same budget in bytes ("512mb" style sizes), converted to slots
    # from the operator's per-slot footprint; the slots key wins when both
    # are set (0: unlimited)
    "state.backend.tpu.hbm-budget-bytes": 0,
    # pre-sized device slots of a builtin window aggregate (0: 2^16, grown
    # by rehash)
    "state.backend.tpu.slots-per-key-group": 0,
    # builtin window aggregates run as one vertex over a mesh of this many
    # shards (the keyBy exchange on the device); 0 and 1: one device
    "state.backend.tpu.mesh-devices": 0,
    # the mesh (parallel/plan.py): partition rules of the sharded state as
    # ';'-separated 'regex=axis' entries ('regex=*' replicates; empty: the
    # window state's rules), whether a live worker-set change may
    # re-shard the state at an aligned barrier, and its deadline
    "mesh.axis-rules": "",
    "mesh.rescale.enabled": True,
    "mesh.rescale.timeout": 30.0,
    # tiered residency under a budget (state/tiering/): batch boundaries
    # between heat decay steps, the factor each step applies, the seed of
    # the policy's tie-break permutation, staging promotions on a thread
    # of their own (false: inline at the boundary, deterministic), the
    # share of capacity promotions may fill, and the least decayed heat of
    # a warm key group worth promoting
    "state.tiering.decay-interval": 8,
    "state.tiering.decay-factor": 0.5,
    "state.tiering.seed": 24243,
    "state.tiering.async-prefetch": True,
    "state.tiering.promote-headroom": 0.5,
    "state.tiering.promote-min-heat": 2.0,
    # split a plain GROUP BY into a local combine before the keyed
    # exchange and a global merge after it (the host route; the device
    # fold pre-aggregates a whole batch and skips the split)
    "sql.optimizer.agg-phase-strategy.two-phase": True,
    # fault injection (reference FaultOptions): the master switch, the seed
    # of probabilistic rules, the rules '<site>=<mode>[!flag...]' (modes
    # once@N, every@N, p<float>, always, off; flags !persistent, !poison,
    # !hang@MS; runtime/faults.py), screening of float aggregate columns
    # for NaN/Inf, and the device guard's retries, backoff and degrade
    # ladder
    "faults.enabled": False,
    "faults.seed": 0,
    "faults.spec": "",
    "faults.validate-batches": False,
    "device.failover.max-retries": 3,
    "device.failover.retry-backoff": 0.005,
    "device.failover.retry-backoff-max": 0.25,
    "device.failover.degradation": True,
    # the stall watchdog (reference WatchdogOptions): per-site deadlines of
    # supervised calls (0: unbounded, a direct call), in-place retries of a
    # hang before its region starts, and task-progress supervision
    "watchdog.enabled": True,
    "watchdog.device.compile-timeout": 600.0,
    "watchdog.device.execute-timeout": 300.0,
    "watchdog.transfer-timeout": 120.0,
    "watchdog.checkpoint-timeout": 300.0,
    "watchdog.tier-timeout": 120.0,
    "watchdog.aot-warmup-timeout": 120.0,
    "watchdog.stall-retries": 1,
    "task.stall-timeout": 120.0,
    "task.backpressure.stall-timeout": 300.0,
    # restart strategies of the job supervisor (reference RuntimeOptions):
    # none | fixed-delay | exponential-delay | failure-rate
    "restart-strategy.type": "exponential-delay",
    "restart-strategy.fixed-delay.attempts": 3,
    "restart-strategy.fixed-delay.delay": 0.1,
    "restart-strategy.failure-rate.max-failures-per-interval": 3,
    "restart-strategy.failure-rate.failure-rate-interval": 60.0,
    "restart-strategy.failure-rate.delay": 0.1,
    "restart-strategy.exponential-delay.initial-backoff": 0.05,
    "restart-strategy.exponential-delay.max-backoff": 10.0,
    # the device-time ledger (metrics/profiler.py, reference
    # ProfilerOptions): the master switch, the duration reservoir of an
    # entry, the recompile records kept, the EWMA factor, the sample ring
    # and the assumed rates of the cost model (estimated ms = max(flops /
    # gflops, bytes / gbps)); assumed, not measured
    "profiler.enabled": False,
    "profiler.reservoir": 256,
    "profiler.recompile-history": 64,
    "profiler.ewma-alpha": 0.2,
    "profiler.trace-samples": 2048,
    "profiler.cost-model.gflops": 50.0,
    "profiler.cost-model.gbps": 10.0,
    # the verified build cache of the kernel libraries (runtime/aot.py,
    # reference AotOptions): the master switch, its directory (empty: off)
    # and the cap of each in-memory program cache (0: unbounded)
    "aot.enabled": False,
    "aot.dir": "",
    "aot.in-memory-max-programs": 0,
    # the shared secret the network log broker's processes present before
    # any pickle crosses a socket (empty: loopback binds only; the
    # FLINK_TPU_CLUSTER_SECRET environment variable is the fallback)
    "security.cluster-secret": "",
}


class SqlOptions:
    """The SQL planner's keys (reference ``core/config.py::SqlOptions``)."""

    TWO_PHASE_AGG = "sql.optimizer.agg-phase-strategy.two-phase"


class StateOptions:
    """Keyed-state keys the mesh route reads (reference
    ``core/config.py::StateOptions``)."""

    BACKEND = "state.backend.type"
    TPU_CAPACITY = "state.backend.tpu.slots-per-key-group"
    MESH_DEVICES = "state.backend.tpu.mesh-devices"


class MeshOptions:
    """The mesh's keys (reference ``core/config.py::MeshOptions``, same
    defaults)."""

    AXIS_RULES = "mesh.axis-rules"
    RESCALE_ENABLED = "mesh.rescale.enabled"
    RESCALE_TIMEOUT = "mesh.rescale.timeout"


class ProfilerOptions:
    """The device-time ledger's keys (reference
    ``core/config.py::ProfilerOptions``, same defaults)."""

    ENABLED = "profiler.enabled"
    RESERVOIR = "profiler.reservoir"
    RECOMPILE_HISTORY = "profiler.recompile-history"
    EWMA_ALPHA = "profiler.ewma-alpha"
    TRACE_SAMPLES = "profiler.trace-samples"
    COST_GFLOPS = "profiler.cost-model.gflops"
    COST_GBPS = "profiler.cost-model.gbps"


class AotOptions:
    """The build cache's keys (reference ``core/config.py::AotOptions``)."""

    ENABLED = "aot.enabled"
    DIR = "aot.dir"
    IN_MEMORY_MAX_PROGRAMS = "aot.in-memory-max-programs"


class SecurityOptions:
    """The cluster's trust boundary (reference
    ``core/config.py::SecurityOptions``)."""

    CLUSTER_SECRET = "security.cluster-secret"


class WatchdogOptions:
    """The deadlines of the kernel build and of the cache's warm-up
    (reference ``core/config.py::WatchdogOptions``)."""

    COMPILE_TIMEOUT = "watchdog.device.compile-timeout"
    AOT_WARMUP_TIMEOUT = "watchdog.aot-warmup-timeout"


class MetricOptions:
    """The reporters' keys (reference ``core/config.py::MetricOptions``)."""

    REPORTERS = "metrics.reporters"
    INTERVAL = "metrics.reporter.interval"
    LATENCY_INTERVAL = "metrics.latency.interval"


class TraceOptions:
    """Causal tracing and the flight recorder (reference
    ``core/config.py::TraceOptions``, same defaults)."""

    ENABLED = "traces.enabled"
    MAX_RETAINED = "traces.max-retained"
    FLIGHT_CAPACITY = "traces.flight-recorder.capacity"
    FLIGHT_DIR = "traces.flight-recorder.dir"
    FLIGHT_MIN_INTERVAL = "traces.flight-recorder.min-interval"


#: value type of each key whose default does not name it
_TYPES: dict[str, type] = {"execution.checkpointing.dir": str}
_DURATIONS = {"pipeline.auto-watermark-interval",
              "pipeline.adaptive-batch-size.target-latency",
              "execution.checkpointing.aligned-checkpoint-timeout",
              "metrics.latency.interval",
              "metrics.reporter.interval",
              "traces.flight-recorder.min-interval",
              "watchdog.device.compile-timeout",
              "watchdog.aot-warmup-timeout",
              "execution.checkpointing.interval",
              "execution.checkpointing.timeout",
              "device.failover.retry-backoff",
              "device.failover.retry-backoff-max",
              "watchdog.device.execute-timeout", "watchdog.transfer-timeout",
              "watchdog.checkpoint-timeout", "watchdog.tier-timeout",
              "task.stall-timeout", "task.backpressure.stall-timeout",
              "restart-strategy.fixed-delay.delay",
              "restart-strategy.failure-rate.failure-rate-interval",
              "restart-strategy.failure-rate.delay",
              "restart-strategy.exponential-delay.initial-backoff",
              "restart-strategy.exponential-delay.max-backoff",
              "mesh.rescale.timeout"}
_MEMORY = {"state.backend.tpu.hbm-budget-bytes"}
_DURATION_RE = re.compile(r"^\s*([0-9.]+)\s*(ms|s|min)?\s*$")
_UNITS = {"ms": 1e-3, "s": 1.0, "min": 60.0}
_MEMORY_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*(b|kb|k|mb|m|gb|g|tb|t)?\s*$",
                        re.IGNORECASE)
_MEMORY_UNITS = {"b": 1, "k": 1 << 10, "kb": 1 << 10, "m": 1 << 20,
                 "mb": 1 << 20, "g": 1 << 30, "gb": 1 << 30, "t": 1 << 40,
                 "tb": 1 << 40}


def _duration(value: Any) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    m = _DURATION_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse duration {value!r}")
    return float(m.group(1)) * _UNITS[m.group(2) or "s"]


def _memory(value: Any) -> int:
    """Bytes: an int, or a size such as "512mb", "1.5 g" or "1024"."""
    if isinstance(value, int):
        return value
    m = _MEMORY_RE.match(str(value))
    if not m:
        raise ValueError(f"cannot parse memory size {value!r}")
    return int(float(m.group(1)) * _MEMORY_UNITS[(m.group(2) or "b").lower()])


class Configuration:
    def __init__(self, values: Optional[dict] = None):
        self._values: dict[str, Any] = {}
        for k, v in (values or {}).items():
            self.set(k, v)

    def set(self, key: str, value: Any) -> "Configuration":
        if key not in DEFAULTS:
            raise KeyError(f"unknown option {key!r}; the port reads "
                           f"{sorted(DEFAULTS)}")
        kind = _TYPES.get(key, type(DEFAULTS[key]))
        if value is None:
            if DEFAULTS[key] is not None:
                raise ValueError(f"{key} takes a value")
        elif key in _DURATIONS:
            value = _duration(value)
        elif key in _MEMORY:
            value = _memory(value)
        elif kind is bool and isinstance(value, str):
            if value.strip().lower() not in ("true", "false"):
                raise ValueError(f"{key} takes true or false, not {value!r}")
            value = value.strip().lower() == "true"
        else:
            value = kind(value)
        self._values[key] = value
        return self

    def get(self, key: str) -> Any:
        return self._values.get(key, DEFAULTS[key])


def all_options() -> list[str]:
    """Every key the port reads, sorted."""
    return sorted(DEFAULTS)


def generate_config_docs() -> str:
    """The option table of ``flink_tpu_torch/docs/CONFIG.md``: one row a
    key with its default, generated so the committed page cannot drift
    from ``DEFAULTS`` (the lint's TPU303 compares them)."""
    lines = ["# Configuration of the port", "",
             "Generated from `flink_tpu_torch/core/config.py::DEFAULTS` by "
             "`generate_config_docs()`; do not edit by hand.", "",
             "| Key | Default |", "| --- | --- |"]
    for key in all_options():
        lines.append(f"| `{key}` | `{DEFAULTS[key]!r}` |")
    return "\n".join(lines) + "\n"
