"""Trace query surface — trace-by-id and the cross-trace trace map.
Port copy of deepflow_tpu/tracing/query.py.


The reference serves these from the querier's distributed_tracing app
(querier/app/distributed_tracing/router/tracemap.go; trace_tree /
span_with_trace_id tables, engine/clickhouse/common/const.go:32-33).
Here both run directly over the columnar store:

  * query_trace: prefer the assembled `trace_tree` row (closed traces);
    fall back to on-the-fly assembly over `l7_flow_log` spans so a trace
    can be queried before its quiet period expires.
  * trace_map: aggregate service→service call edges over every tree in
    a time range — edge call counts, duration sums, error counts — the
    "aggregate from trace_tree" model (model/raw_trace_map.go:24-26).
"""

from __future__ import annotations

import numpy as np

from ..storage.store import ColumnarStore, org_db
from .builder import FLOW_LOG_DB, TRACE_TREE_SCHEMA
from .tree import SpanRow, TraceTree, assemble_trace


def _spans_from_l7(store: ColumnarStore, db: str, trace_id: str,
                   time_range=None) -> list[SpanRow]:
    try:
        cols = store.scan(
            db,
            "l7_flow_log",
            time_range=time_range,
            columns=[
                "time", "trace_id", "span_id", "parent_span_id",
                "app_service", "tap_side", "endpoint", "start_time",
                "end_time", "response_duration", "status",
            ],
        )
    except KeyError:
        return []
    sel = cols["trace_id"] == trace_id
    if not sel.any():
        return []
    spans = []
    for i in np.nonzero(sel)[0]:
        spans.append(
            SpanRow(
                trace_id=trace_id,
                span_id=str(cols["span_id"][i]),
                parent_span_id=str(cols["parent_span_id"][i]),
                app_service=str(cols["app_service"][i]),
                tap_side=int(cols["tap_side"][i]),
                endpoint=str(cols["endpoint"][i]),
                start_us=int(cols["start_time"][i]) * 1_000_000,
                end_us=int(cols["end_time"][i]) * 1_000_000,
                response_duration_us=int(cols["response_duration"][i]),
                server_error=int(cols["status"][i]) == 4,
            )
        )
    return spans


def query_trace(
    store: ColumnarStore,
    trace_id: str,
    org: int = 1,
    time_range: tuple[int, int] | None = None,
) -> dict | None:
    """Full tree for one trace id, or None if unknown."""
    db = org_db(FLOW_LOG_DB, org)
    try:
        cols = store.scan(
            db, TRACE_TREE_SCHEMA.name, time_range=time_range
        )
        sel = cols["trace_id"] == trace_id
        if sel.any():
            i = int(np.nonzero(sel)[0][-1])  # latest assembly wins
            try:
                tree = TraceTree.decode(
                    int(cols["time"][i]), trace_id, str(cols["encoded_span_list"][i])
                )
                return tree.to_dict()
            except (ValueError, KeyError, IndexError):
                pass  # corrupt row: fall through to on-the-fly assembly
    except KeyError:
        pass  # no trace_tree table yet
    tree = assemble_trace(_spans_from_l7(store, db, trace_id, time_range))
    return tree.to_dict() if tree is not None else None


def tempo_trace(
    store: ColumnarStore,
    trace_id: str,
    org: int = 1,
    time_range: tuple[int, int] | None = None,
) -> dict | None:
    """Tempo/OTLP-shaped trace response — the querier's Tempo adapter
    seat (the reference serves Grafana's Tempo datasource from its span
    store). Raw spans come from l7_flow_log; shape follows the OTLP JSON
    trace schema Grafana consumes: batches → scopeSpans → spans."""
    db = org_db(FLOW_LOG_DB, org)
    spans = _spans_from_l7(store, db, trace_id, time_range)
    if not spans:
        return None
    by_service: dict[str, list] = {}
    for s in spans:
        by_service.setdefault(s.app_service, []).append(s)
    batches = []
    for service, group in by_service.items():
        batches.append(
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name", "value": {"stringValue": service}}
                    ]
                },
                "scopeSpans": [
                    {
                        "scope": {"name": "deepflow_tpu"},
                        "spans": [
                            {
                                "traceId": trace_id,
                                "spanId": s.span_id,
                                "parentSpanId": s.parent_span_id,
                                "name": s.endpoint or service,
                                # OTLP: 2=SERVER, 3=CLIENT — derived
                                # from which side of the call the tap
                                # observed (TapSide.CLIENT bit)
                                "kind": 3 if (s.tap_side & 1) else 2,
                                "startTimeUnixNano": str(s.start_us * 1000),
                                "endTimeUnixNano": str(
                                    (s.start_us + s.response_duration_us) * 1000
                                ),
                                "status": {"code": 2 if s.server_error else 0},
                            }
                            for s in group
                        ],
                    }
                ],
            }
        )
    return {"batches": batches}


def trace_map(
    store: ColumnarStore,
    time_range: tuple[int, int] | None = None,
    org: int = 1,
) -> list[dict]:
    """Service-edge aggregation across all trees in the range.

    Returns one row per (client_service, server_service) edge:
    {client, server, call_count, duration_sum_us, error_count,
     trace_count, pseudo_link_count}, sorted by call_count desc.
    """
    db = org_db(FLOW_LOG_DB, org)
    try:
        cols = store.scan(db, TRACE_TREE_SCHEMA.name, time_range=time_range)
    except KeyError:
        return []
    edges: dict[tuple[str, str], dict] = {}
    for i in range(len(cols["time"])):
        try:
            tree = TraceTree.decode(
                int(cols["time"][i]),
                str(cols["trace_id"][i]),
                str(cols["encoded_span_list"][i]),
            )
        except (ValueError, KeyError, IndexError):
            continue  # one corrupt row must not break the whole map
        for n in tree.nodes:
            client = (
                tree.nodes[n.parent_node_index].app_service
                if n.parent_node_index >= 0
                else ""
            )
            key = (client, n.app_service)
            e = edges.get(key)
            if e is None:
                e = edges[key] = {
                    "client": client,
                    "server": n.app_service,
                    "call_count": 0,
                    "duration_sum_us": 0,
                    "error_count": 0,
                    "trace_count": 0,
                    "pseudo_link_count": 0,
                }
            e["call_count"] += n.response_total
            e["duration_sum_us"] += n.response_duration_sum
            e["error_count"] += n.response_status_server_error_count
            e["trace_count"] += 1
            e["pseudo_link_count"] += n.pseudo_link
    return sorted(edges.values(), key=lambda e: -e["call_count"])
