"""PromQL subset over the prometheus.samples table — the app/prometheus
Port copy of deepflow_tpu/querier/promql.py.

seat (the reference compiles PromQL onto its CK engine; we evaluate
directly).

Supported:  [agg by (l1, l2)] (metric{label="v", label!="v"})
            and rate(metric{...}[Ns])  inside the aggregation,
            topk(k, metric{...}) / bottomk(k, metric{...}) — the
            heavy-hitter surface the sketch tier feeds (
            topk(5, deepflow_sketch_top_bytes) ranks the invertible
            sketch's recovered flows without any exact-row scan)
Instant queries: evaluate at time `t` with a lookback window (last
sample per series wins, Prometheus staleness semantics simplified).
Range queries: query_range evaluates the instant expression at each
step over [start, end] and returns per-series value arrays — the
/api/v1/query_range shape.

Live read plane: when a LiveRegistry (querier/live.py)
carries a provider for (db, table), both entry points merge the
provider's open-window partial rows with the flushed scan — a range
query ending "now" returns rows from the currently OPEN window. Any
result row whose value used a live sample carries `"partial": True`
(Prometheus result-marker style; absent otherwise), and because
flushed rows supersede a window's partials, the same query returns
identical values unmarked once the window closes (bit-exact by
construction). Results are cached through
live.QueryResultCache keyed on (query, db, table, time args) and
validated against (store write epoch, live snapshot generation) — the
repeated-dashboard path costs a dict lookup until a window closes or a
new snapshot lands.
"""

from __future__ import annotations

import re

import numpy as np

from ..storage.store import ColumnarStore
from .live import (
    LiveRegistry,
    QueryResultCache,
    cache_token,
    default_live_registry,
    default_query_cache,
)

_QUERY_RE = re.compile(
    r"^\s*(?:(?P<agg>sum|avg|max|min|count)\s*(?:by\s*\((?P<by>[^)]*)\)\s*)?\(\s*)?"
    r"(?:(?P<topk>topk|bottomk)\s*\(\s*(?P<k>\d+)\s*,\s*)?"
    r"(?:(?P<rate>rate)\s*\(\s*)?"
    r"(?P<metric>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<matchers>[^}]*)\})?"
    r"(?:\[(?P<range>\d+)(?P<range_unit>[smh])\])?"
    r"(?:\s*\))?(?:\s*\))?(?:\s*\))?\s*$"
)

_UNIT_S = {"s": 1, "m": 60, "h": 3600}


class PromQLError(ValueError):
    pass


def _parse_matchers(text: str | None) -> list[tuple[str, str, str]]:
    out = []
    if not text:
        return out
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r'^([a-zA-Z_][a-zA-Z0-9_]*)\s*(=~|!=|=)\s*"([^"]*)"$', part)
        if not m:
            raise PromQLError(f"bad matcher {part!r}")
        out.append((m.group(1), m.group(2), m.group(3)))
    return out


from ..integration.formats import unpack_tags as _label_dict


def _row(labels: dict, value: float, partial: bool) -> dict:
    """One result row; `partial` is present ONLY when True (the live
    marker must not change the shape of flushed-only results)."""
    out = {"labels": labels, "value": value}
    if partial:
        out["partial"] = True
    return out


def query_instant(
    store: ColumnarStore,
    query: str,
    t: int,
    *,
    lookback_s: int = 300,
    db: str = "prometheus",
    table: str = "samples",
    live: "LiveRegistry | None" = None,
) -> list[dict]:
    """→ [{"labels": {...}, "value": float}] — instant vector at time t.

    `db`/`table` default to the remote-write store; pass
    db="deepflow_system", table="deepflow_system" to evaluate over the
    framework's own dogfooded telemetry (integration/dfstats) — the
    table shares the samples row shape by construction. `live` (default:
    the process-wide registry) supplies open-window partial rows; rows
    whose value used one carry `"partial": True`."""
    m = _QUERY_RE.match(query)
    if not m:
        raise PromQLError(f"unsupported query {query!r}")
    if query.count("(") != query.count(")"):
        # the regex's optional close-paren groups would otherwise let a
        # typo ("topk(5, m" / "sum(m))") parse and silently answer
        raise PromQLError(f"unbalanced parentheses in {query!r}")
    agg = m.group("agg")
    by = [s.strip() for s in (m.group("by") or "").split(",") if s.strip()]
    is_rate = bool(m.group("rate"))
    window = (
        int(m.group("range")) * _UNIT_S[m.group("range_unit")]
        if m.group("range")
        else lookback_s
    )
    matchers = _parse_matchers(m.group("matchers"))
    if is_rate and not m.group("range"):
        raise PromQLError("rate() needs a [range]")

    cols = store.scan(db, table, time_range=(t - window, t + 1))
    n_store = len(cols["time"]) if cols else 0
    is_live = np.zeros(n_store, bool)
    reg = default_live_registry if live is None else live
    if reg.has(db, table):
        # open-window overlay: live partial rows join the flushed scan.
        # Flushed rows for the same (series, time) supersede at the
        # last-sample-wins stage below (live rows sort FIRST on time
        # ties via the is_live sort key), so a window that closed
        # between snapshot and query never double-reports.
        lv = reg.columns(db, table, t - window, t + 1)
        if lv is not None and all(
            k in lv for k in ("time", "metric", "labels", "value")
        ):
            lt = np.asarray(lv["time"], np.int64)
            sel_t = (lt >= t - window) & (lt < t + 1)
            if sel_t.any():
                cols = {
                    k: np.concatenate(
                        [np.asarray(cols[k]), np.asarray(lv[k])[sel_t]]
                    )
                    for k in ("time", "metric", "labels", "value")
                }
                is_live = np.r_[is_live, np.ones(int(sel_t.sum()), bool)]

    sel = cols["metric"] == m.group("metric")
    labels_packed = cols["labels"]
    rows = np.nonzero(sel)[0]
    series: dict[str, list[tuple[int, int, float]]] = {}
    for i in rows:
        packed = str(labels_packed[i])
        lab = _label_dict(packed)
        keep = True
        for name, op, val in matchers:
            have = lab.get(name, "")
            if op == "=" and have != val:
                keep = False
            elif op == "!=" and have == val:
                keep = False
            elif op == "=~" and not re.fullmatch(val, have):
                keep = False
        if keep:
            series.setdefault(packed, []).append(
                # sort key (time, rank) with rank 0 = live, 1 = flushed:
                # on a time tie the FLUSHED sample sorts last and wins
                # the instant value (flushed supersedes partials)
                (int(cols["time"][i]), 0 if is_live[i] else 1,
                 float(cols["value"][i]))
            )

    # per-series instant value (+ whether a live sample produced it)
    per_series: dict[str, float] = {}
    partials: dict[str, bool] = {}
    for packed, samples in series.items():
        samples.sort()
        if is_rate:
            if len(samples) < 2:
                continue
            dt = samples[-1][0] - samples[0][0]
            # counter-reset correction (Prometheus extrapolatedRate): a
            # decrease means the counter restarted from ~0, so the true
            # increase across the reset is the new value itself
            dv = 0.0
            for (_, _, prev), (_, _, cur) in zip(samples, samples[1:]):
                dv += cur - prev if cur >= prev else cur
            per_series[packed] = dv / dt if dt > 0 else 0.0
            partials[packed] = any(rank == 0 for _, rank, _ in samples)
        else:
            per_series[packed] = samples[-1][2]
            partials[packed] = samples[-1][1] == 0

    if m.group("topk"):
        # topk/bottomk(k, inner): keep the k extreme series, then fall
        # through to an (optional) outer aggregation over the survivors
        k = int(m.group("k"))
        sign = -1.0 if m.group("topk") == "topk" else 1.0
        keep = sorted(per_series.items(), key=lambda kv: (sign * kv[1], kv[0]))[:k]
        per_series = dict(keep)
        if agg is None:
            # rank order, not label order — the whole point of topk
            return [
                _row(_label_dict(p), v, partials.get(p, False)) for p, v in keep
            ]

    if agg is None:
        return [
            _row(_label_dict(p), v, partials.get(p, False))
            for p, v in sorted(per_series.items())
        ]
    groups: dict[tuple, list[float]] = {}
    group_partial: dict[tuple, bool] = {}
    for packed, v in per_series.items():
        lab = _label_dict(packed)
        key = tuple((b, lab.get(b, "")) for b in by)
        groups.setdefault(key, []).append(v)
        group_partial[key] = group_partial.get(key, False) or partials.get(
            packed, False
        )
    out = []
    for key, vals in sorted(groups.items()):
        if agg == "sum":
            v = sum(vals)
        elif agg == "avg":
            v = sum(vals) / len(vals)
        elif agg == "max":
            v = max(vals)
        elif agg == "min":
            v = min(vals)
        else:
            v = float(len(vals))
        out.append(_row(dict(key), v, group_partial[key]))
    return out


def query_range(
    store: ColumnarStore,
    query: str,
    start: int,
    end: int,
    step: int,
    *,
    lookback_s: int = 300,
    db: str = "prometheus",
    table: str = "samples",
    live: "LiveRegistry | None" = None,
    cache: "QueryResultCache | None | bool" = None,
) -> list[dict]:
    """Matrix result: [{"labels": {...}, "values": [[t, v], ...]}] — the
    /api/v1/query_range evaluation (each step is an instant evaluation,
    which is exactly Prometheus's range-query semantics).

    A range ending "now" includes the currently open window's partial
    rows via the live overlay; any series that used one carries
    `"partial": True`. Results cache through `cache` (default: the
    process-wide live.default_query_cache; False disables) keyed on
    (query, db, table, start, end, step) and validated against the
    (store write epoch, live snapshot generation) token — the repeated
    dashboard is a dict lookup until a window closes or a new snapshot
    lands, at which point the stale entry is dropped (counted) and
    recomputed."""
    if step <= 0:
        raise PromQLError("step must be positive")
    if end < start:
        raise PromQLError("end < start")
    reg = default_live_registry if live is None else live
    if cache is None or cache is True:
        c = default_query_cache
    elif cache is False:
        c = None
    else:
        c = cache
    key = token = None
    if c is not None:
        key = ("promql_range", query, db, table, start, end, step,
               lookback_s, getattr(store, "uid", id(store)))
        # token BEFORE evaluation: a pipeline provider's epoch() may
        # take the rate-limited snapshot, so the generation the token
        # names is the one the evaluation below reads
        token = cache_token(store, db, table, reg)
        hit = c.lookup(key, token)
        if hit is not None:
            return hit
    series: dict[tuple, dict] = {}
    for t in range(start, end + 1, step):
        for row in query_instant(
            store, query, t, lookback_s=lookback_s, db=db, table=table,
            live=reg,
        ):
            skey = tuple(sorted(row["labels"].items()))
            s = series.get(skey)
            if s is None:
                s = series[skey] = {"labels": row["labels"], "values": []}
            s["values"].append([t, row["value"]])
            if row.get("partial"):
                s["partial"] = True
    out = [series[k] for k in sorted(series)]
    if c is not None:
        c.store(key, token, out)
    return out
