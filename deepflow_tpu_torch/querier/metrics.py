"""Logical metric registry — the querier's metric expansion layer.
Port copy of deepflow_tpu/querier/metrics.py.

The reference maps user-facing metric names onto storage-column
expressions per table family (querier/engine/clickhouse/metrics/: e.g.
`rtt` expands to Sum(rtt_sum)/Sum(rtt_count), `packet` to
Sum(packet_tx)+Sum(packet_rx)); the engine substitutes these before
building SQL. Same idea here: derived metrics are SQL snippets parsed
with our own parser and substituted into the query AST.

`db_descriptions`-style catalogs: `list_metrics(table)` enumerates both
raw meter columns and derived names so the CLI can surface them.
"""

from __future__ import annotations

from ..datamodel.schema import APP_METER, FLOW_METER, USAGE_METER, MeterSchema
from .sqlparse import _Parser

# family → derived metric name → expression snippet over storage columns
_FLOW_DERIVED = {
    "packet": "Sum(packet_tx) + Sum(packet_rx)",
    "byte": "Sum(byte_tx) + Sum(byte_rx)",
    "l3_byte": "Sum(l3_byte_tx) + Sum(l3_byte_rx)",
    "l4_byte": "Sum(l4_byte_tx) + Sum(l4_byte_rx)",
    "rtt_avg": "Sum(rtt_sum) / Sum(rtt_count)",
    "rtt_client_avg": "Sum(rtt_client_sum) / Sum(rtt_client_count)",
    "rtt_server_avg": "Sum(rtt_server_sum) / Sum(rtt_server_count)",
    "srt_avg": "Sum(srt_sum) / Sum(srt_count)",
    "art_avg": "Sum(art_sum) / Sum(art_count)",
    "rrt_avg": "Sum(rrt_sum) / Sum(rrt_count)",
    "cit_avg": "Sum(cit_sum) / Sum(cit_count)",
    "retrans": "Sum(retrans_tx) + Sum(retrans_rx)",
    "retrans_ratio": "(Sum(retrans_tx) + Sum(retrans_rx)) / (Sum(packet_tx) + Sum(packet_rx))",
    "error": "Sum(client_rst_flow) + Sum(server_rst_flow)",
    "l7_error": "Sum(l7_client_error) + Sum(l7_server_error)",
}

# NOTE: derived names must not shadow raw storage columns — expansion is
# by name, and `SELECT request` must mean the raw column, not Sum(request).
_APP_DERIVED = {
    "rrt_avg": "Sum(rrt_sum) / Sum(rrt_count)",
    "error": "Sum(client_error) + Sum(server_error)",
    "error_ratio": "(Sum(client_error) + Sum(server_error)) / Sum(response)",
    "client_error_ratio": "Sum(client_error) / Sum(response)",
    "server_error_ratio": "Sum(server_error) / Sum(response)",
}

_USAGE_DERIVED = {
    "packet": "Sum(packet_tx) + Sum(packet_rx)",
    "byte": "Sum(byte_tx) + Sum(byte_rx)",
}

_FAMILY_METER: dict[str, tuple[MeterSchema, dict[str, str]]] = {
    "network": (FLOW_METER, _FLOW_DERIVED),
    "network_map": (FLOW_METER, _FLOW_DERIVED),
    "application": (APP_METER, _APP_DERIVED),
    "application_map": (APP_METER, _APP_DERIVED),
    "traffic_policy": (USAGE_METER, _USAGE_DERIVED),
}


# shadowing guard: a derived name that matched a raw column would make
# `SELECT <col>` silently aggregate
for _meter, _derived in _FAMILY_METER.values():
    _clash = set(_derived) & set(_meter.field_names())
    assert not _clash, f"derived metrics shadow raw columns: {_clash}"


def _family(table: str) -> str | None:
    base = table.replace(".", "_")
    for fam in sorted(_FAMILY_METER, key=len, reverse=True):
        if base == fam or base.startswith(fam + "_"):
            return fam
    return None


def derived_metrics(table: str) -> dict[str, str]:
    fam = _family(table)
    return _FAMILY_METER[fam][1] if fam else {}


def list_metrics(table: str) -> dict[str, str]:
    """name → kind ("counter"/"gauge"/"derived") for the catalogs."""
    fam = _family(table)
    out: dict[str, str] = {}
    if fam:
        meter, derived = _FAMILY_METER[fam]
        for f in meter.fields:
            out[f.name] = "counter" if f.op.value == "sum" else "gauge"
        for name in derived:
            out[name] = "derived"
    return out


def expand(table: str, name: str):
    """Derived metric name → parsed expression AST, or None."""
    snippet = derived_metrics(table).get(name)
    if snippet is None:
        return None
    return _Parser(snippet).parse_expr()


# ---------------------------------------------------------------------------
# Metric types + counter-aware operator sets (metrics/const.go
# METRICS_TYPE_* and METRICS_TYPE_UNLAY_FUNCTIONS). The type drives
# Avg's expansion (Counter_Avg / Delay_Avg / plain AVG) and the
# ignore-zero treatment of delay metrics (view/function.go *If(x>0)).

import re as _re

COUNTER = "counter"
GAUGE = "gauge"
BOUNDED_GAUGE = "bounded_gauge"
DELAY = "delay"
PERCENTAGE = "percentage"
QUOTIENT = "quotient"

# delay family: rtt/srt/art/rrt/cit/tls_rtt with side/stat suffixes —
# everything except the _count lanes (those are counters)
_DELAY_RE = _re.compile(
    r"^(tls_)?(rtt|srt|art|rrt|cit)(_client|_server)?(_max|_sum|_avg)?$"
)

TYPE_OPERATORS = {
    COUNTER: ("Sum", "Avg", "AAvg", "Max", "Min", "PerSecond", "Percentile", "Stddev"),
    GAUGE: ("Avg", "AAvg", "Max", "Min", "Percentile", "Stddev"),
    BOUNDED_GAUGE: ("Avg", "AAvg", "Max", "Min", "Last", "Percentile", "PercentileExact"),
    DELAY: ("Avg", "AAvg", "Max", "Min", "Last", "Spread", "Rspread",
            "Percentile", "PercentileExact", "Apdex"),
    PERCENTAGE: ("Avg",),
    QUOTIENT: ("Avg",),
}


def metric_type(table: str, name: str) -> str | None:
    """Semantic type of a raw or derived metric column, or None for an
    unknown/tag column."""
    if name.endswith("_ratio"):
        return PERCENTAGE
    if _DELAY_RE.match(name) or name in ("response_duration",):
        return DELAY
    if name == "direction_score":
        return BOUNDED_GAUGE
    if name in ("flow_load",):
        return GAUGE
    fam = _family(table)
    if fam:
        meter, derived = _FAMILY_METER[fam]
        if name in derived:
            return QUOTIENT
        if name in meter.field_names():
            f = next(f for f in meter.fields if f.name == name)
            return COUNTER if f.op.value == "sum" else GAUGE
        return None
    # log tables: numeric counters vs delays handled by the regex above
    if name in _LOG_ROW_DERIVED or name.endswith(("_tx", "_rx", "_count")) or name in (
        "syn_count", "synack_count"
    ):
        return COUNTER
    return None


def is_delay(table: str, name: str) -> bool:
    return metric_type(table, name) == DELAY


# row-level derived metrics — substituted INSIDE aggregate arguments
# (clickhouse_test.go: `Sum(byte)` → SUM(byte_tx+byte_rx), `byte` on a
# log table → byte_tx+byte_rx, `Sum(log_count)` → SUM(1))
_TRAFFIC_ROW = {
    "byte": "byte_tx + byte_rx",
    "packet": "packet_tx + packet_rx",
    "l3_byte": "l3_byte_tx + l3_byte_rx",
    "l4_byte": "l4_byte_tx + l4_byte_rx",
    "retrans": "retrans_tx + retrans_rx",
    "zero_win": "zero_win_tx + zero_win_rx",
}
_LOG_ROW_DERIVED = {**_TRAFFIC_ROW, "total_byte": "total_byte_tx + total_byte_rx",
                    "total_packet": "total_packet_tx + total_packet_rx",
                    "log_count": "1"}
_APP_ROW = {"error": "client_error + server_error", "log_count": "1"}


def row_derived(table: str) -> dict[str, str]:
    base = table.replace(".", "_")
    if base.startswith("l4_flow_log") or base.startswith("l7_flow_log"):
        return _LOG_ROW_DERIVED if base.startswith("l4") else _APP_ROW
    fam = _family(table)
    if fam in ("network", "network_map", "traffic_policy"):
        return _TRAFFIC_ROW
    if fam in ("application", "application_map"):
        return _APP_ROW
    return {}


def expand_row(table: str, name: str):
    """Row-level derived name → AST (usable inside aggregates)."""
    snippet = row_derived(table).get(name)
    if snippet is None:
        return None
    return _Parser(snippet).parse_expr()


def datasource_interval(table: str) -> int:
    """Storage granularity from the table name (network_1m → 60s) —
    Counter_Avg's divisor (view/function.go GetInterval)."""
    base = table.replace(".", "_")
    for suffix, ival in (("_1d", 86400), ("_1h", 3600), ("_1m", 60), ("_1s", 1)):
        if base.endswith(suffix):
            return ival
    return 1


# ---------------------------------------------------------------------------
# db_descriptions-style catalogs (querier/db_descriptions/) — generated
# from the schemas instead of shipped as flat files.


def metric_catalog(table: str, store_schema=None) -> list[dict]:
    """One row per queryable metric: name, type, unit, operators."""
    out = []
    seen = set()

    def add(name, mtype, category):
        if name in seen or mtype is None:
            return
        seen.add(name)
        unit = ""
        if _DELAY_RE.match(name) or name.endswith("_avg") or name == "response_duration":
            unit = "us"
        elif "byte" in name:
            unit = "byte"
        out.append({
            "name": name,
            "type": mtype,
            "unit": unit,
            "category": category,
            "operators": list(TYPE_OPERATORS.get(mtype, ("Sum",))),
        })

    fam = _family(table)
    if fam:
        meter, derived = _FAMILY_METER[fam]
        for f in meter.fields:
            add(f.name, metric_type(table, f.name), "meter")
        for name in derived:
            add(name, metric_type(table, name) or QUOTIENT, "derived")
    for name in row_derived(table):
        add(name, COUNTER, "derived")
    if store_schema is not None:
        # raw numeric columns of the concrete table (log tables have no
        # meter schema; their f4 lanes are metrics)
        for c in store_schema.columns:
            t = metric_type(table, c.name)
            if c.dtype.startswith("f") or t is not None:
                add(c.name, t or GAUGE, "meter")
    return out


def tag_catalog(table: str, store_schema=None) -> list[dict]:
    """One row per queryable tag: name, data type, enumerability —
    from the storage schema when given, else the static tag schema."""
    from ..datamodel.schema import TAG_SCHEMA

    metric_names = {m["name"] for m in metric_catalog(table, store_schema)}
    out = []
    if store_schema is not None:
        for c in store_schema.columns:
            if c.name in metric_names or c.name == "time":
                continue
            kind = "string" if c.dtype.startswith("U") else "int"
            out.append({"name": c.name, "type": kind,
                        "client_server": c.name.endswith(("_0", "_1"))})
    else:
        for f in TAG_SCHEMA.fields:
            out.append({"name": f.name, "type": "int", "client_server": False})
    return out
