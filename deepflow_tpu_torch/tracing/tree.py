"""Trace-tree assembly — spans of one trace_id → a service call tree.
Port copy of deepflow_tpu/tracing/tree.py.


The reference defines the trace-tree *data model* (TraceTree/TreeNode
with per-node RED aggregates, parent links, pseudo-links for broken
chains — server/libs/tracetree/tracetree.go:38-90) and the storage
tables, but the open-source tree builder is an enterprise stub
(querier/app/distributed_tracing/service/tracemap/tracemap_generator.go:32
`Start() {}`), so the assembly below is designed fresh:

  * one node per *service* seen in the trace (app_service name, falling
    back to the enriched auto_service id) — spans of the same service
    collapse into the node's RED aggregates, mirroring the reference's
    node-level ResponseDurationSum/ResponseTotal/ServerErrorCount;
  * parent link = service of the span referenced by parent_span_id;
    spans whose parent span is absent from the trace attach to the
    root with `pseudo_link=1` (tracetree.go:80 PseudoLink);
  * levels are depths after link resolution; cycles (malformed data)
    are cut at the back-edge and marked pseudo.

Wire form: a compact self-describing JSON (the reference uses a custom
zigzag codec because ClickHouse stores it as an opaque string; our
columnar store holds it in a string column where JSON is the idiomatic
opaque encoding).
"""

from __future__ import annotations

import dataclasses
import json


def search_index(trace_id: str) -> int:
    """64-bit FNV-1a of the trace id — the fixed-width key the trace_tree
    table is ordered by (the reference orders by a string hash too,
    tracetree.go:33)."""
    h = 0xCBF29CE484222325
    for b in trace_id.encode():
        h = ((h ^ b) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


@dataclasses.dataclass
class SpanRow:
    """The slice of one l7_flow_log row the assembler needs."""

    trace_id: str
    span_id: str
    parent_span_id: str
    app_service: str
    auto_service_id: int = 0
    tap_side: int = 0
    endpoint: str = ""
    start_us: int = 0
    end_us: int = 0
    response_duration_us: int = 0
    server_error: bool = False


@dataclasses.dataclass
class TreeNode:
    app_service: str
    auto_service_id: int = 0
    parent_node_index: int = -1
    pseudo_link: int = 0
    level: int = 0
    topic: str = ""
    response_duration_sum: int = 0  # µs
    response_total: int = 0
    response_status_server_error_count: int = 0


@dataclasses.dataclass
class TraceTree:
    time: int  # earliest span second
    trace_id: str
    nodes: list[TreeNode]

    @property
    def search_index(self) -> int:
        return search_index(self.trace_id)

    def encode(self) -> str:
        return json.dumps(
            {
                "v": 1,
                "nodes": [
                    [
                        n.app_service,
                        n.auto_service_id,
                        n.parent_node_index,
                        n.pseudo_link,
                        n.level,
                        n.topic,
                        n.response_duration_sum,
                        n.response_total,
                        n.response_status_server_error_count,
                    ]
                    for n in self.nodes
                ],
            },
            separators=(",", ":"),
        )

    @staticmethod
    def decode(time: int, trace_id: str, text: str) -> "TraceTree":
        obj = json.loads(text)
        nodes = [
            TreeNode(
                app_service=r[0],
                auto_service_id=r[1],
                parent_node_index=r[2],
                pseudo_link=r[3],
                level=r[4],
                topic=r[5],
                response_duration_sum=r[6],
                response_total=r[7],
                response_status_server_error_count=r[8],
            )
            for r in obj["nodes"]
        ]
        return TraceTree(time=time, trace_id=trace_id, nodes=nodes)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "time": self.time,
            "search_index": self.search_index,
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
        }


def _service_key(s: SpanRow) -> tuple:
    return (s.app_service or f"auto:{s.auto_service_id}", s.auto_service_id)


def assemble_trace(spans: list[SpanRow]) -> TraceTree | None:
    """Collapse one trace's spans into a service tree.

    Returns None for an empty span list. Deterministic: node order is
    (level, first-seen order), so equal inputs encode identically.
    """
    if not spans:
        return None
    trace_id = spans[0].trace_id

    by_span_id = {s.span_id: s for s in spans if s.span_id}

    # service nodes in first-seen order
    key_to_idx: dict[tuple, int] = {}
    nodes: list[TreeNode] = []
    for s in spans:
        k = _service_key(s)
        if k not in key_to_idx:
            key_to_idx[k] = len(nodes)
            nodes.append(TreeNode(app_service=k[0], auto_service_id=k[1]))
        n = nodes[key_to_idx[k]]
        n.response_total += 1
        n.response_duration_sum += max(0, s.response_duration_us)
        if s.server_error:
            n.response_status_server_error_count += 1

    # parent resolution per node: the first span of the node whose parent
    # resolves inside the trace wins; otherwise the node is a root or a
    # pseudo-linked orphan.
    has_parent = [False] * len(nodes)
    is_orphan_with_parent_ref = [False] * len(nodes)
    for s in spans:
        idx = key_to_idx[_service_key(s)]
        if has_parent[idx]:
            continue
        if s.parent_span_id and s.parent_span_id in by_span_id:
            pidx = key_to_idx[_service_key(by_span_id[s.parent_span_id])]
            if pidx != idx:  # intra-service parent stays merged
                nodes[idx].parent_node_index = pidx
                has_parent[idx] = True
        elif s.parent_span_id:
            is_orphan_with_parent_ref[idx] = True

    # root: first node with no parent; orphans attach there pseudo-linked
    root_idx = next(
        (i for i, n in enumerate(nodes) if n.parent_node_index < 0), 0
    )
    for i, n in enumerate(nodes):
        if i != root_idx and n.parent_node_index < 0:
            n.parent_node_index = root_idx
            if is_orphan_with_parent_ref[i]:
                n.pseudo_link = 1

    # levels, with cycle cut (defensive against malformed span data):
    # a walk that hasn't reached a root within |nodes| hops is cyclic —
    # re-attach the start node to the root as a pseudo link.
    for i, n in enumerate(nodes):
        level, j = 0, i
        while nodes[j].parent_node_index >= 0:
            j = nodes[j].parent_node_index
            level += 1
            if level > len(nodes):
                # root_idx itself can sit inside the cycle: it becomes
                # the true root, everything else re-attaches beneath it.
                n.parent_node_index = root_idx if i != root_idx else -1
                n.pseudo_link = 0 if i == root_idx else 1
                level = 0 if i == root_idx else 1
                break
        n.level = level

    t0 = min((s.start_us for s in spans if s.start_us), default=0) // 1_000_000
    return TraceTree(time=int(t0), trace_id=trace_id, nodes=nodes)
