"""Tier-P (plan) rules of the port: graph-level fusion findings from the
fusion certifier, plus the baseline-hygiene rule (port of
``flink_tpu/analysis/plan_rules.py``).

The certifier (``graph/fusion.py``) does the analysis when a job graph is
compiled; these rules surface its rejected-boundary findings so a
pipeline that SHOULD fuse, but is cut by a host-effectful op, a
serializer boundary, a shuffle or a timer escape, fails the lint against
the committed baseline like any other regression.

Certificates come from ``fusion.CERTIFICATE_LOG`` (every ``certify()``
call of the process; tests seed it directly). When the log is empty the
rules certify the port's own pipelines (``port_pipelines``: Q5 through
the device window with fusion on, and a session window), never the
reference's ``examples/``.
"""

from __future__ import annotations

from typing import List

from .core import AnalysisContext, Finding, load_baseline, rule, skip_rule

__all__ = ["plan_rule_ids", "port_pipelines"]

_PLAN_RULES = ("PLAN601", "PLAN602", "PLAN603", "PLAN604")


def plan_rule_ids() -> tuple:
    return _PLAN_RULES


def _certificates(ctx: AnalysisContext) -> list:
    cached = getattr(ctx, "_plan_certificates", None)
    if cached is not None:
        return cached
    try:
        from ..graph.fusion import CERTIFICATE_LOG
    except Exception as e:  # pragma: no cover - broken runtime import
        skip_rule(f"fusion certifier unavailable: {e!r}")
    certs = list(CERTIFICATE_LOG)
    if not certs:
        try:
            certs = port_pipelines()
        except Exception as e:
            skip_rule(f"could not certify the port's pipelines: {e!r}")
    if not certs:
        skip_rule("no fusion certificates captured")
    ctx._plan_certificates = certs
    return certs


def port_pipelines() -> list:
    """Certificates of the port's own pipelines, built on the CPU and
    never run: Q5 (device datagen, keyBy, sliding window, device
    aggregate, sink) with fusion on, and an event-time session window."""
    import numpy as np

    from ..api import StreamExecutionEnvironment
    from ..core import Configuration, Schema, WatermarkStrategy
    from ..graph.fusion import certify
    from ..graph.stream_graph import build_job_graph, build_stream_graph
    from ..runtime.operators import AggSpec
    from ..window import EventTimeSessionWindows, SlidingEventTimeWindows

    schema = Schema([("auction", np.int64), ("price", np.int64),
                     ("ts", np.int64)])

    def gen(idx):
        return {"auction": idx % 97, "price": idx % 13, "ts": idx}

    certs = []
    for name, window in (
            ("q5", SlidingEventTimeWindows.of(5000, 1000)),
            ("sessions", EventTimeSessionWindows.with_gap(1000))):
        env = StreamExecutionEnvironment(
            Configuration({"pipeline.fusion.enabled": True}), device="cpu")
        ws = WatermarkStrategy.for_monotonous_timestamps() \
            .with_timestamp_column("ts")
        (env.datagen(gen, schema, count=1 << 12, timestamp_column="ts",
                     watermark_strategy=ws, device=True)
         .key_by("auction").window(window)
         .device_aggregate([AggSpec("count", out_name="bids"),
                            AggSpec("sum", "price", out_name="revenue")],
                           capacity=1 << 10, ring_size=8)
         .add_sink(lambda b: None, "Sink"))
        sg = build_stream_graph(env._sinks, env.config)
        certs.append(certify(sg, build_job_graph(sg, env.config, name),
                             env.config))
    return certs


def _plan_findings(ctx: AnalysisContext, rule_id: str,
                   hint: str) -> List[Finding]:
    out: List[Finding] = []
    seen = set()
    for cert in _certificates(ctx):
        for f in cert.findings():
            if f.rule != rule_id:
                continue
            key = (f.file, f.line, f.symbol, f.message)
            if key in seen:
                continue
            seen.add(key)
            if f.file != "<unknown>" and f.line and \
                    (ctx.root / f.file).is_file() and \
                    ctx.suppression(f.file, f.line, rule_id.lower()):
                continue
            out.append(Finding(rule=rule_id, file=f.file, line=f.line,
                               symbol=f.symbol, message=f.message,
                               hint=hint))
    return out


@rule("PLAN601", "host-effectful op cuts a fusable chain", "P",
      "An opaque/host-effectful operator interrupts a run of "
      "device-fusable operators: every record pays a device round-trip "
      "plus a dispatch at the boundary.")
def plan601_host_effectful(ctx: AnalysisContext) -> List[Finding]:
    return _plan_findings(
        ctx, "PLAN601",
        "make the op a device operator of the port or move it past the "
        "flush point")


@rule("PLAN602", "serializer/schema boundary cuts a fusable chain", "P",
      "A row-loop operator decodes host rows in the middle of a "
      "device-fusable run — a serialize/deserialize boundary that "
      "forces device->host materialization per batch.")
def plan602_serializer(ctx: AnalysisContext) -> List[Finding]:
    return _plan_findings(
        ctx, "PLAN602",
        "implement map_batch/filter_batch so the op stays columnar, or "
        "hoist the row logic behind the keyed flush point")


@rule("PLAN603", "shuffle where fusion was possible", "P",
      "A non-forward (or feedback) exchange separates two fusable "
      "operators at equal parallelism: the shuffle costs a dispatch + "
      "partition round-trip a forward edge would not.")
def plan603_shuffle(ctx: AnalysisContext) -> List[Finding]:
    return _plan_findings(
        ctx, "PLAN603",
        "drop the rebalance/rescale between pure operators (forward "
        "edges chain) or move the keyed exchange to the stateful op")


@rule("PLAN604", "timer/side-output escape cuts a fusable chain", "P",
      "A timer-driven operator or a side-output tag escapes the "
      "candidate fused region: records/timers leave mid-dispatch, so "
      "the chain cannot lower to one program across it.")
def plan604_escape(ctx: AnalysisContext) -> List[Finding]:
    return _plan_findings(
        ctx, "PLAN604",
        "timers and side outputs are legal only at chain flush points; "
        "split the chain there or fold the logic into the window step")


@rule("BASE601", "baseline entry still carries the TODO reason", "A",
      "Every committed baseline entry must carry a reviewed reason; "
      "'TODO: justify this exception or fix it' is the placeholder "
      "save_baseline stamps when no reason was given.")
def base601_todo_reason(ctx: AnalysisContext) -> List[Finding]:
    out: List[Finding] = []
    for e in load_baseline():
        reason = (e.get("reason") or "").strip()
        if not reason or reason.startswith("TODO"):
            out.append(Finding(
                rule="BASE601",
                file="flink_tpu_torch/analysis/baseline.json", line=0,
                symbol=e.get("fingerprint", "?"),
                message=(f"baseline entry {e.get('rule')} @ "
                         f"{e.get('file')}:{e.get('symbol')} has no "
                         f"reviewed reason (got {reason!r})"),
                hint="replace the reason with why this exception is "
                     "sound (save_baseline(..., default_reason=...)) or "
                     "fix the finding"))
    return out
