"""Fusion certifier: which operator chains may run as ONE dispatch per
micro-batch, and why the others may not (trimmed port of
``flink_tpu/graph/fusion.py``).

``certify`` walks every chained JobVertex, classifies each operator, and
emits a :class:`FusionCertificate` naming the maximal fusable runs. A
boundary that rejects fusion (a host-effectful operator cutting a run, a
non-forward edge between fusable operators) is a PLAN6xx finding,
anchored at the rejecting operator's class. Sinks, keyed exchanges into
keyed state and device window aggregates are legal flush points.

The runtime reads the certificate: a certified run that starts at the
device source heading a vertex of parallelism 1 and ends at the device
window aggregate is that vertex's ``lowered_prefix``, which the deployer
(``cluster/local.py``) arms as one dispatch per micro-batch
(``runtime/compiled.py``). The verdicts and rule names are the
reference's; the capture harness and CLI are not ported. Every
certificate also goes into ``CERTIFICATE_LOG`` (bounded), which the
lint's PLAN6xx rules read (``analysis/plan_rules.py``).
"""

from __future__ import annotations

import inspect
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

__all__ = ["VERDICTS", "PlanFinding", "FusedOp", "ChainReport",
           "FusionCertificate", "certify", "CERTIFICATE_LOG"]

VERDICTS = ("CERTIFIED", "PARTIAL", "REJECTED")

# A run starts at a device source and extends through pure operators; a
# device window aggregate certifies as its keyed tail. Flush categories
# end a run legally.
_FUSABLE = ("source-device", "pure")
_FLUSH = ("sink", "keyed-device", "keyed-host", "window-device",
          "source-host", "two-input")
_CUTTER_RULE = {"host-effectful": "PLAN601", "serializer": "PLAN602",
                "timer": "PLAN604", "unknown": "PLAN601"}


@dataclass(frozen=True)
class PlanFinding:
    """One rejected fusion boundary, anchored to the operator class."""
    rule: str
    message: str
    file: str       # repo-relative posix path of the rejecting op class
    line: int
    symbol: str     # "<vertex uid>:<node name>"


@dataclass
class FusedOp:
    node_id: int
    name: str
    category: str
    detail: str
    file: str
    line: int


@dataclass
class ChainReport:
    vertex_id: str
    uid: str
    name: str
    parallelism: int
    ops: list[FusedOp] = field(default_factory=list)
    verdict: str = "REJECTED"
    # maximal legal fusable sub-chains, as lists of stream-node ids
    certified: list[list[int]] = field(default_factory=list)
    # the prefix the runtime lowers to one dispatch (source -> device
    # window, parallelism 1, fusion enabled)
    lowered_prefix: list[int] = field(default_factory=list)
    findings: list[PlanFinding] = field(default_factory=list)


@dataclass
class FusionCertificate:
    job_name: str
    fusion_enabled: bool
    chains: list[ChainReport] = field(default_factory=list)

    def findings(self) -> list[PlanFinding]:
        return [f for c in self.chains for f in c.findings]

    def chain_for_vertex(self, vertex_id: str) -> Optional[ChainReport]:
        for c in self.chains:
            if c.vertex_id == vertex_id:
                return c
        return None


#: the most recent certificates of this process, newest last (the lint's
#: plan rules read them; tests seed it directly)
CERTIFICATE_LOG: deque = deque(maxlen=64)


# ---------------------------------------------------------------------------
# Classification


def _repo_rel(path: Optional[str]) -> str:
    if not path:
        return "<unknown>"
    p = Path(path)
    for parent in p.parents:
        if parent.name == "flink_tpu_torch":
            return p.relative_to(parent.parent).as_posix()
    return p.name


def _class_location(cls: type) -> tuple[str, int]:
    try:
        return (_repo_rel(inspect.getsourcefile(cls)),
                inspect.getsourcelines(cls)[1])
    except (OSError, TypeError):
        return "<unknown>", 0


def _classify_operator(op: Any) -> tuple[str, str]:
    """Category of an instantiated operator of the port, as the
    reference classifies its counterpart: a vectorized batch method is
    the device-safe surface; a row loop decodes host rows (a serializer
    boundary); timers and side collectors escape the dispatch."""
    from ..core.functions import FilterFunction, MapFunction
    from ..runtime.operators.device_window import DeviceWindowAggOperator
    from ..runtime.operators.simple import BatchFnOperator, \
        FilterOperator, FlatMapOperator, KeyedProcessOperator, MapOperator

    if isinstance(op, DeviceWindowAggOperator):
        return "window-device", "keyed partial-agg tail (one-dispatch step)"
    name = type(op).__name__
    if name in ("DeviceSessionWindowOperator", "MeshWindowAggOperator",
                "DeviceGroupAggOperator"):
        return "keyed-device", "keyed device aggregate (own fused step)"
    if isinstance(op, KeyedProcessOperator) or name in (
            "CepOperator", "AsyncWaitOperator", "WindowOperator"):
        return "timer", "timer/side-output surface escapes the dispatch"
    if isinstance(op, BatchFnOperator):
        return "host-effectful", "opaque batch fn (not declared traceable)"
    fn = getattr(op, "_fn", None)
    if isinstance(op, MapOperator):
        if fn is not None and \
                type(fn).map_batch is not MapFunction.map_batch:
            return "pure", "vectorized map_batch"
        return "serializer", "row-loop map decodes host rows"
    if isinstance(op, FilterOperator):
        if fn is not None and \
                type(fn).filter_batch is not FilterFunction.filter_batch:
            return "pure", "vectorized filter_batch"
        return "serializer", "row-loop filter decodes host rows"
    if isinstance(op, FlatMapOperator):
        return "serializer", "row-loop flat_map decodes host rows"
    if type(op).__module__.startswith("flink_tpu_torch.sql"):
        return "keyed-host", "host keyed SQL operator (legal flush point)"
    return "host-effectful", f"unclassified operator {name}"


def _classify_node(node: Any) -> FusedOp:
    """StreamNode -> FusedOp. Instantiating a factory is cheap: the heavy
    set-up of the port's operators lives in setup()/open()."""
    if node.kind == "source":
        src = node.source
        file, line = _class_location(type(src))
        if getattr(src, "_device", False):
            return FusedOp(node.id, node.name, "source-device",
                           "device-resident generator batches", file, line)
        return FusedOp(node.id, node.name, "source-host",
                       "host-resident source batches", file, line)
    if node.kind == "two_input":
        return FusedOp(node.id, node.name, "two-input",
                       "two-input operator (two gates; a flush point)",
                       "<unknown>", 0)
    if node.kind == "sink":
        cat, detail = "sink", "chain flush point"
    elif node.traceable:
        cat, detail = "pure", "declared device-safe"
    else:
        cat, detail = "unknown", "operator factory failed to classify"
    if node.kind == "one_input" and node.operator_factory is not None:
        try:
            op = node.operator_factory()
            c, d = _classify_operator(op)
            file, line = _class_location(type(op))
            if node.traceable and c in ("host-effectful", "unknown"):
                c, d = "pure", "declared device-safe"
            return FusedOp(node.id, node.name, c, d, file, line)
        except Exception as e:  # classification must never kill compile
            return FusedOp(node.id, node.name, "unknown",
                           f"factory raised during classification: {e!r}",
                           "<unknown>", 0)
    if node.kind == "sink" and node.operator_factory is not None:
        try:
            file, line = _class_location(type(node.operator_factory()))
        except Exception:
            file, line = "<unknown>", 0
        return FusedOp(node.id, node.name, cat, detail, file, line)
    return FusedOp(node.id, node.name, cat, detail, "<unknown>", 0)


# ---------------------------------------------------------------------------
# Certification


def _walk_chain(report: ChainReport, side_tagged: set[int]) -> None:
    """Split a chained vertex into maximal fusable runs; a run cut by a
    non-flush category is a rejected boundary -> PLAN finding."""
    run: list[FusedOp] = []

    def close(cutter: Optional[FusedOp], rule: Optional[str]) -> None:
        nonlocal run
        if len(run) >= 2:
            report.certified.append([o.node_id for o in run])
            if cutter is not None and rule is not None:
                report.findings.append(PlanFinding(
                    rule=rule,
                    message=(f"fusable run [{', '.join(o.name for o in run)}]"
                             f" is cut by {cutter.name!r}: {cutter.detail}"),
                    file=cutter.file, line=cutter.line,
                    symbol=f"{report.uid}:{cutter.name}"))
        run = []

    for op in report.ops:
        if op.node_id in side_tagged and run:
            report.findings.append(PlanFinding(
                rule="PLAN604",
                message=(f"side output escapes the fusable run at "
                         f"{op.name!r}; fusion stops at the tag"),
                file=op.file, line=op.line,
                symbol=f"{report.uid}:{op.name}:side"))
            close(None, None)
        if op.category in _FUSABLE:
            if op.category == "source-device" and run:
                close(None, None)  # sources only head a chain
            run.append(op)
            continue
        if op.category == "window-device":
            # the certified keyed tail: its own one-dispatch step even when
            # nothing fusable precedes it
            run.append(op)
            report.certified.append([o.node_id for o in run])
            run = []
            continue
        if op.category in _FLUSH:
            close(None, None)    # legal flush point, no finding
            continue
        close(op, _CUTTER_RULE.get(op.category, "PLAN601"))
    close(None, None)
    # CERTIFIED: every boundary is a legal flush point; PARTIAL: rejected
    # boundaries but some run certified; REJECTED: nothing certified
    if report.findings:
        report.verdict = "PARTIAL" if report.certified else "REJECTED"
    else:
        report.verdict = "CERTIFIED"


def certify(stream_graph: Any, job_graph: Any,
            config: Any = None) -> FusionCertificate:
    """The fusion certificate of a compiled job; never mutates either
    graph."""
    enabled = (bool(config.get("pipeline.fusion.enabled"))
               if config is not None else False)
    cert = FusionCertificate(job_name=getattr(job_graph, "name", "job"),
                             fusion_enabled=enabled)
    side_tagged = {e.source_id for e in stream_graph.edges
                   if e.side_tag is not None}
    for vid, vertex in job_graph.vertices.items():
        report = ChainReport(vertex_id=vid, uid=vertex.uid, name=vertex.name,
                             parallelism=vertex.parallelism)
        report.ops = [_classify_node(node) for node in vertex.chained_nodes]
        _walk_chain(report, side_tagged)
        # a certified run from the device source heading this vertex to a
        # device window aggregate lowers to one dispatch (parallelism 1:
        # the keyed exchange it absorbs is forward-equivalent there)
        if enabled and vertex.parallelism == 1 and report.certified:
            head_run = report.certified[0]
            ops_by_id = {o.node_id: o for o in report.ops}
            first, last = ops_by_id[head_run[0]], ops_by_id[head_run[-1]]
            if (first.node_id == vertex.chained_nodes[0].id
                    and first.category == "source-device"
                    and last.category == "window-device"):
                report.lowered_prefix = list(head_run)
        cert.chains.append(report)

    # PLAN603: a non-forward edge between two operators that would
    # otherwise fuse
    for e in job_graph.edges:
        if e.side_tag is not None:
            continue
        src = cert.chain_for_vertex(e.source_vertex)
        dst = cert.chain_for_vertex(e.target_vertex)
        if src is None or dst is None or not src.ops or not dst.ops:
            continue
        tail, head = src.ops[-1], dst.ops[0]
        if e.partitioner_name == "hash" and head.category in (
                "window-device", "keyed-device", "keyed-host", "timer"):
            continue  # the keyed exchange IS the legal flush point
        if ((e.partitioner_name != "forward" or e.feedback)
                and tail.category in _FUSABLE
                and head.category == "pure"
                and src.parallelism == dst.parallelism):
            dst.findings.append(PlanFinding(
                rule="PLAN603",
                message=(f"non-forward edge ({e.partitioner_name}"
                         f"{', feedback' if e.feedback else ''}) between "
                         f"fusable operators {tail.name!r} -> {head.name!r} "
                         "at equal parallelism: a forward edge would fuse"),
                file=head.file, line=head.line,
                symbol=f"{dst.uid}:{head.name}:edge"))
            dst.verdict = "PARTIAL" if dst.certified else "REJECTED"
    CERTIFICATE_LOG.append(cert)
    return cert
