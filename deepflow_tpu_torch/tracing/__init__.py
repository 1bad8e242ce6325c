from .tree import SpanRow, TraceTree, TreeNode, assemble_trace, search_index
from .builder import TraceTreeBuilder, TRACE_TREE_SCHEMA
from .query import query_trace, trace_map
from .lineage import (
    FreshnessTracker,
    LineageTracker,
    hop_span_id,
    query_window_trace,
    window_trace_id,
)

__all__ = [
    "SpanRow",
    "TraceTree",
    "TreeNode",
    "assemble_trace",
    "search_index",
    "TraceTreeBuilder",
    "TRACE_TREE_SCHEMA",
    "query_trace",
    "trace_map",
    "FreshnessTracker",
    "LineageTracker",
    "hop_span_id",
    "query_window_trace",
    "window_trace_id",
]
