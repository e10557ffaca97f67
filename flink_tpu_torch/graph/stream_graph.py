"""StreamGraph and JobGraph: graph compilation with operator chaining
(trimmed port of ``flink_tpu/graph/stream_graph.py``).

The Transformation DAG flattens into a StreamGraph (nodes + partitioned
edges; unions dissolve into plain edges), then chainable runs fuse into
JobVertices, each run by one task. Chaining rule: forward edge + equal
parallelism + single in-edge + chaining enabled on both nodes + same
slot-sharing group. Under ``pipeline.fusion.enabled`` a hash edge at
parallelism 1 into a device window aggregate chains too: every record
lands on subtask 0, so the keyed exchange is forward-equivalent.

The port builds sources, one-input and two-input operators, sinks and
iterations. A two-input node's in-edges carry ``target_input`` (0 or 1),
and it heads its chain: nothing chains into it, and forward edges after
it chain as usual. An iteration head (``FeedbackTransformation``) is a
pass-through node that chains with nothing upstream; the loop body's
tail reaches it over a ``feedback`` edge, which never chains.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

from ..core.config import Configuration
from .transformations import (
    FeedbackTransformation, OneInputTransformation, PartitionTransformation,
    SideOutputTransformation, SinkTransformation, SourceTransformation,
    Transformation, TwoInputTransformation, UnionTransformation,
)

__all__ = ["StreamNode", "StreamEdge", "StreamGraph", "JobVertex", "JobEdge",
           "JobGraph", "build_stream_graph", "build_job_graph"]


@dataclass
class StreamNode:
    id: int
    name: str
    kind: str  # source | one_input | two_input | sink
    parallelism: int
    max_parallelism: int
    uid: str = ""
    uid_explicit: bool = False  # user-set via .uid(), vs generated
    chaining_allowed: bool = True
    slot_sharing_group: str = "default"
    operator_factory: Optional[Callable] = None
    key_extractor: Optional[Callable] = None
    source: Any = None
    watermark_strategy: Any = None
    traceable: bool = False
    # an iteration head's gate ends once its regular inputs ended and the
    # feedback loop stayed quiet this long
    iteration_head: bool = False
    iteration_wait_s: float = 0.0


@dataclass
class StreamEdge:
    source_id: int
    target_id: int
    partitioner_factory: Callable[[], Any]
    partitioner_name: str = "forward"
    side_tag: Optional[str] = None
    target_input: int = 0
    feedback: bool = False  # an iteration's back edge (body tail -> head)


@dataclass
class StreamGraph:
    nodes: dict[int, StreamNode] = field(default_factory=dict)
    edges: list[StreamEdge] = field(default_factory=list)

    def in_edges(self, node_id: int) -> list[StreamEdge]:
        return [e for e in self.edges if e.target_id == node_id]

    def out_edges(self, node_id: int) -> list[StreamEdge]:
        return [e for e in self.edges if e.source_id == node_id]


def build_stream_graph(sinks: list[Transformation],
                       config: Configuration) -> StreamGraph:
    """Flatten the transformation DAG; virtual nodes (partition/union/side
    output) dissolve into edge attributes."""
    g = StreamGraph()
    default_par = config.get("pipeline.parallelism")
    default_maxp = config.get("pipeline.max-parallelism")
    visited: dict[int, int] = {}  # transformation id -> stream node id

    def resolve_input(t: Transformation) -> list[tuple[int, dict]]:
        if isinstance(t, PartitionTransformation):
            out = []
            for up in t.inputs:
                for nid, attrs in resolve_input(up):
                    a = dict(attrs)
                    a["partitioner_factory"] = t.partitioner_factory
                    a["partitioner_name"] = t.partitioner_name
                    out.append((nid, a))
            return out
        if isinstance(t, UnionTransformation):
            out = []
            for up in t.inputs:
                out.extend(resolve_input(up))
            return out
        if isinstance(t, SideOutputTransformation):
            out = []
            for up in t.inputs:
                for nid, attrs in resolve_input(up):
                    a = dict(attrs)
                    a["side_tag"] = t.tag
                    out.append((nid, a))
            return out
        return [(visit(t), {})]

    def visit(t: Transformation) -> int:
        if t.id in visited:
            return visited[t.id]
        par = t.parallelism or default_par
        maxp = t.max_parallelism or default_maxp
        common = dict(uid=t.effective_uid, uid_explicit=t.uid is not None,
                      chaining_allowed=t.chaining_allowed,
                      slot_sharing_group=t.slot_sharing_group)
        if isinstance(t, SourceTransformation):
            node = StreamNode(t.id, t.name, "source", par, maxp,
                              source=t.source,
                              watermark_strategy=t.watermark_strategy,
                              **common)
        elif isinstance(t, SinkTransformation):
            node = StreamNode(t.id, t.name, "sink", par, maxp,
                              operator_factory=t.operator_factory, **common)
        elif isinstance(t, OneInputTransformation):
            node = StreamNode(t.id, t.name, "one_input", par, maxp,
                              operator_factory=t.operator_factory,
                              key_extractor=t.key_extractor,
                              traceable=t.traceable, **common)
        elif isinstance(t, TwoInputTransformation):
            node = StreamNode(t.id, t.name, "two_input", par, maxp,
                              operator_factory=t.operator_factory, **common)
        elif isinstance(t, FeedbackTransformation):
            from ..runtime.operators.simple import BatchFnOperator
            # the head owns the special gate: it never chains into an
            # upstream task (a source task has no gate for the feedback)
            common["chaining_allowed"] = False
            node = StreamNode(t.id, t.name, "one_input", par, maxp,
                              operator_factory=lambda: BatchFnOperator(
                                  lambda b: b, "IterationHead"),
                              iteration_head=True,
                              iteration_wait_s=t.max_wait_s, **common)
        else:
            raise TypeError(f"the port builds no {type(t).__name__}")
        g.nodes[node.id] = node
        # registered before its inputs resolve: a feedback edge cycles
        # back here, and this entry ends the recursion
        visited[t.id] = node.id
        two = isinstance(t, TwoInputTransformation)
        for input_idx, up in enumerate(t.inputs):
            for nid, attrs in resolve_input(up):
                g.edges.append(_make_edge(nid, node.id, attrs,
                                          input_idx if two else 0))
        if isinstance(t, FeedbackTransformation):
            if not t.feedback_inputs:
                raise ValueError(
                    f"iteration {t.name!r} was never closed: call "
                    "close_with(feedback_stream) on the IterativeStream")
            for up in t.feedback_inputs:
                for nid, attrs in resolve_input(up):
                    g.edges.append(_make_edge(nid, node.id,
                                              {**attrs, "feedback": True}))
        return node.id

    for s in sinks:
        visit(s)
    return g


def _make_edge(source_id: int, target_id: int, attrs: dict,
               target_input: int = 0) -> StreamEdge:
    from ..runtime.writer import ForwardPartitioner
    return StreamEdge(
        source_id, target_id,
        partitioner_factory=attrs.get("partitioner_factory",
                                      ForwardPartitioner),
        partitioner_name=attrs.get("partitioner_name", "forward"),
        side_tag=attrs.get("side_tag"), target_input=target_input,
        feedback=attrs.get("feedback", False))


# ---------------------------------------------------------------------------
# JobGraph: chained vertices
# ---------------------------------------------------------------------------

@dataclass
class JobEdge:
    source_vertex: str
    target_vertex: str
    partitioner_factory: Callable[[], Any]
    partitioner_name: str = "forward"
    side_tag: Optional[str] = None
    target_input: int = 0
    feedback: bool = False


@dataclass
class JobVertex:
    id: str
    name: str
    parallelism: int
    max_parallelism: int
    chained_nodes: list[StreamNode] = field(default_factory=list)
    slot_sharing_group: str = "default"
    # stable across job submissions: user-set uid, or an auto uid from the
    # chain's names and occurrence; the key checkpoint restore maps by
    uid: str = ""

    @property
    def kind(self) -> str:
        return self.chained_nodes[0].kind


@dataclass
class JobGraph:
    name: str
    vertices: dict[str, JobVertex] = field(default_factory=dict)
    edges: list[JobEdge] = field(default_factory=list)
    config: Configuration = field(default_factory=Configuration)
    # FusionCertificate attached by the environment under
    # pipeline.fusion.enabled; the deployer reads lowered_prefix per vertex
    certificate: Any = None

    def in_edges(self, vid: str) -> list[JobEdge]:
        return [e for e in self.edges if e.target_vertex == vid]

    def out_edges(self, vid: str) -> list[JobEdge]:
        return [e for e in self.edges if e.source_vertex == vid]

    def topological_order(self) -> list[JobVertex]:
        order, seen = [], set()

        def dfs(vid: str):
            if vid in seen:
                return
            seen.add(vid)
            for e in self.in_edges(vid):
                dfs(e.source_vertex)
            order.append(self.vertices[vid])

        for vid in self.vertices:
            dfs(vid)
        return order


def build_job_graph(g: StreamGraph, config: Configuration,
                    name: str = "job") -> JobGraph:
    chaining = config.get("pipeline.operator-chaining")
    fusion = config.get("pipeline.fusion.enabled")
    _window_head: dict[int, bool] = {}

    def device_window_head(node: StreamNode) -> bool:
        """Does this node's factory build a device window aggregate?
        (Instantiation is cheap: the backend is made in setup().)"""
        if node.id not in _window_head:
            ok = False
            if node.kind == "one_input" and node.operator_factory is not None:
                try:
                    from ..runtime.operators.device_window import (
                        DeviceWindowAggOperator,
                    )
                    ok = isinstance(node.operator_factory(),
                                    DeviceWindowAggOperator)
                except Exception:
                    ok = False
            _window_head[node.id] = ok
        return _window_head[node.id]

    def chainable(e: StreamEdge) -> bool:
        if not chaining or e.side_tag is not None or e.feedback:
            return False
        up, down = g.nodes[e.source_id], g.nodes[e.target_id]
        forward_ok = e.partitioner_name == "forward"
        if not forward_ok and fusion:
            # a hash exchange at parallelism 1 is forward-equivalent, so
            # the keyed edge into a device window aggregate may chain: that
            # is what lets a certified source -> window prefix lower to one
            # dispatch (graph/fusion.py)
            forward_ok = (e.partitioner_name == "hash"
                          and up.parallelism == 1
                          and down.parallelism == 1
                          and device_window_head(down))
        return (forward_ok
                and up.parallelism == down.parallelism
                and up.slot_sharing_group == down.slot_sharing_group
                and down.kind in ("one_input", "sink")
                and down.chaining_allowed and up.chaining_allowed
                and len(g.in_edges(down.id)) == 1
                and len(g.out_edges(up.id)) == 1)

    # map each stream node to the head of its chain
    head_of: dict[int, int] = {}
    for nid in g.nodes:
        head = nid
        while True:
            ins = g.in_edges(head)
            if len(ins) == 1 and chainable(ins[0]):
                head = ins[0].source_id
            else:
                break
        head_of[nid] = head

    jg = JobGraph(name=name, config=config)
    auto_uid_counts: dict[str, int] = {}
    for nid, node in g.nodes.items():
        if head_of[nid] != nid:
            continue
        chain = [node]
        cur = nid
        while True:
            outs = g.out_edges(cur)
            if len(outs) == 1 and chainable(outs[0]):
                cur = outs[0].target_id
                chain.append(g.nodes[cur])
            else:
                break
        head = chain[0]
        vid = f"v{head.id}"
        chain_name = " -> ".join(n.name for n in chain)
        if head.uid_explicit:
            uid = head.uid
        else:
            # stable across submissions of the same program: chain shape +
            # occurrence index (transformation ids are a process-global
            # counter and do not survive resubmission)
            idx = auto_uid_counts.get(chain_name, 0)
            auto_uid_counts[chain_name] = idx + 1
            uid = f"auto::{chain_name}::{idx}"
        jg.vertices[vid] = JobVertex(
            id=vid, name=chain_name, parallelism=head.parallelism,
            max_parallelism=head.max_parallelism, chained_nodes=chain,
            slot_sharing_group=head.slot_sharing_group, uid=uid)

    # edges between chains
    for e in g.edges:
        src_head, dst_head = head_of[e.source_id], head_of[e.target_id]
        if src_head == dst_head:
            continue  # intra-chain edge, consumed by chaining
        jg.edges.append(JobEdge(
            source_vertex=f"v{src_head}", target_vertex=f"v{dst_head}",
            partitioner_factory=e.partitioner_factory,
            partitioner_name=e.partitioner_name,
            side_tag=e.side_tag, target_input=e.target_input,
            feedback=e.feedback))
    return jg
