"""TraceTreeBuilder — buffers l7 spans per trace, closes quiet traces,
Port copy of deepflow_tpu/tracing/builder.py.

writes `flow_log.trace_tree` rows.

The reference streams spans into `span_with_trace_id` and feeds trees
through a shared OverwriteQueue into TraceTreeWriter
(flow_log/dbwriter/tracetree_writer.go, common/module_shared.go:38); the
component that fills that queue is enterprise-only. Here the builder is
the whole loop: `observe()` from any l7 write path that carries a
trace_id, `tick()` (driven by the server's housekeeping tick) closes
traces that have been quiet for `close_after_s`, assembles them
(tree.assemble_trace) and hands rows to a TableWriter per org database.

Spans are NOT duplicated into a span_with_trace_id table — l7_flow_log
already stores every span with its trace_id, and the querier can filter
it directly; one copy is the columnar-store-native design.

Backpressure: at most `max_traces` open traces and `max_spans_per_trace`
spans each; beyond that, oldest traces close early / extra spans drop
and are counted — the OverwriteQueue shed-oldest stance
(libs/queue/queue.go:139).
"""

from __future__ import annotations

import threading
import time as _time

from ..storage.store import ColumnSpec, TableSchema, org_db
from ..storage.writer import TableWriter
from .tree import SpanRow, TraceTree, assemble_trace

import numpy as np

FLOW_LOG_DB = "flow_log"

TRACE_TREE_SCHEMA = TableSchema(
    "trace_tree",
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("search_index", "u8"),
        ColumnSpec("trace_id", "U64"),
        ColumnSpec("encoded_span_list", "U4096"),
    ),
    partition_s=3600,
)


class TraceTreeBuilder:
    def __init__(
        self,
        store,
        *,
        close_after_s: float = 3.0,
        max_traces: int = 4096,
        max_spans_per_trace: int = 512,
        writer_args: dict | None = None,
    ):
        self.store = store
        self.close_after_s = close_after_s
        self.max_traces = max_traces
        self.max_spans_per_trace = max_spans_per_trace
        self.writer_args = writer_args or {"flush_interval_s": 0.5}
        self._writers: dict[str, TableWriter] = {}
        # (org, trace_id) -> (spans, last_seen_monotonic)
        self._open: dict[tuple[int, str], tuple[list[SpanRow], float]] = {}
        self._lock = threading.Lock()
        self.counters = {
            "spans_in": 0,
            "spans_dropped": 0,
            "traces_closed": 0,
            "traces_evicted": 0,
        }

    def get_counters(self):
        with self._lock:
            return dict(self.counters)

    # -- ingest side ----------------------------------------------------
    def observe(self, spans: list[SpanRow], org: int = 1) -> None:
        """Buffer spans (called from the OTel/l7 write paths)."""
        now = _time.monotonic()
        to_close: list[tuple[int, str, list[SpanRow]]] = []
        with self._lock:
            for s in spans:
                if not s.trace_id:
                    continue
                self.counters["spans_in"] += 1
                key = (org, s.trace_id)
                entry = self._open.get(key)
                if entry is None:
                    if len(self._open) >= self.max_traces:
                        # shed the stalest open trace (close it early)
                        old_key = min(self._open, key=lambda k: self._open[k][1])
                        old_spans, _t = self._open.pop(old_key)
                        self.counters["traces_evicted"] += 1
                        to_close.append((old_key[0], old_key[1], old_spans))
                    entry = ([], now)
                    self._open[key] = entry
                if len(entry[0]) >= self.max_spans_per_trace:
                    self.counters["spans_dropped"] += 1
                    continue
                entry[0].append(s)
                self._open[key] = (entry[0], now)
        for org_id, _tid, spans_ in to_close:
            self._write_tree(org_id, spans_)

    # -- close side -----------------------------------------------------
    def tick(self, now: float | None = None) -> int:
        """Close traces quiet for close_after_s; returns trees written."""
        now = _time.monotonic() if now is None else now
        closed = []
        with self._lock:
            for key in list(self._open):
                spans, last = self._open[key]
                if now - last >= self.close_after_s:
                    del self._open[key]
                    closed.append((key[0], spans))
        for org_id, spans in closed:
            self._write_tree(org_id, spans)
        return len(closed)

    def drain(self) -> int:
        """Close everything (shutdown)."""
        with self._lock:
            items = [(k[0], s) for k, (s, _t) in self._open.items()]
            self._open.clear()
        for org_id, spans in items:
            self._write_tree(org_id, spans)
        return len(items)

    def flush(self) -> None:
        with self._lock:
            writers = list(self._writers.values())
        for w in writers:
            w.flush()

    def stop(self) -> None:
        self.drain()
        with self._lock:
            writers = list(self._writers.values())
            self._writers.clear()
        for w in writers:
            w.stop()

    # -- internals ------------------------------------------------------
    def _writer(self, org: int) -> TableWriter:
        db = org_db(FLOW_LOG_DB, org)
        with self._lock:
            w = self._writers.get(db)
            if w is None:
                w = TableWriter(self.store, db, TRACE_TREE_SCHEMA, **self.writer_args)
                self._writers[db] = w
            return w

    # storage column width for encoded_span_list (TRACE_TREE_SCHEMA U4096);
    # numpy would truncate longer strings SILENTLY, leaving undecodable
    # JSON — so oversized trees shed their deepest nodes until they fit.
    MAX_ENCODED = 4096

    def _shrink_encode(self, tree) -> str:
        """Encode within MAX_ENCODED, shedding deepest-level nodes first.

        Keeping a prefix of the (level, index)-sorted node order always
        keeps every kept node's parent (a parent's level is strictly
        smaller), so reindexed trees stay well-formed."""
        import dataclasses as _dc

        encoded = tree.encode()
        order = sorted(range(len(tree.nodes)), key=lambda i: (tree.nodes[i].level, i))
        k = len(order)
        while len(encoded) > self.MAX_ENCODED and k > 1:
            k = max(1, (k * 4) // 5)
            keep = order[:k]
            remap = {old: new for new, old in enumerate(keep)}
            nodes = [
                _dc.replace(
                    tree.nodes[old],
                    parent_node_index=remap.get(tree.nodes[old].parent_node_index, -1),
                )
                for old in keep
            ]
            encoded = TraceTree(tree.time, tree.trace_id, nodes).encode()
        if k < len(order):
            with self._lock:
                self.counters["nodes_shed_oversize"] = (
                    self.counters.get("nodes_shed_oversize", 0)
                    + (len(order) - k)
                )
        return encoded

    def _write_tree(self, org: int, spans: list[SpanRow]) -> None:
        tree = assemble_trace(spans)
        if tree is None:
            return
        encoded = self._shrink_encode(tree)
        self._writer(org).put(
            {
                "time": np.array([tree.time], np.uint32),
                "search_index": np.array([tree.search_index], np.uint64),
                "trace_id": np.array([tree.trace_id]),
                "encoded_span_list": np.array([encoded]),
            }
        )
        with self._lock:
            self.counters["traces_closed"] += 1
