"""Pipelined-region failover calculation (port of
``flink_tpu/cluster/regions.py``, whole).

Flink's RestartPipelinedRegionFailoverStrategy and the region build of
LogicalPipelinedRegionComputeUtil: a failover REGION is a maximal set of
vertices connected by pipelined edges; a task failure restarts exactly
the regions reachable from it. Every streaming edge here is pipelined
(there is no blocking/batch exchange), so regions are the connected
components of the job graph — one region for a typical connected job,
several for jobs with disconnected pipelines (independent source->sink
chains submitted as one job), which then fail over independently.
"""

from __future__ import annotations

from ..graph.stream_graph import JobGraph

__all__ = ["compute_regions", "affected_vertices", "region_task_ids"]


def compute_regions(job_graph: JobGraph) -> list[set[str]]:
    """Connected components over (pipelined) edges, as vertex-id sets."""
    parent: dict[str, str] = {v: v for v in job_graph.vertices}

    def find(x: str) -> str:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for e in job_graph.edges:
        a, b = find(e.source_vertex), find(e.target_vertex)
        if a != b:
            parent[a] = b
    groups: dict[str, set[str]] = {}
    for v in job_graph.vertices:
        groups.setdefault(find(v), set()).add(v)
    return list(groups.values())


def affected_vertices(regions: list[set[str]],
                      failed_task_ids: list[str]) -> set[str]:
    """Union of the regions containing the failed tasks."""
    failed_vids = {t.rsplit("#", 1)[0] for t in failed_task_ids}
    out: set[str] = set()
    for region in regions:
        if region & failed_vids:
            out |= region
    return out


def region_task_ids(job_graph: JobGraph, vids: set[str]) -> list[str]:
    return [f"{vid}#{s}"
            for vid in vids
            for s in range(job_graph.vertices[vid].parallelism)]
