"""Self-telemetry loop closure: StatsCollector → dfstats wire frames →
`deepflow_system` tables (port of deepflow_tpu/integration/dfstats.py).

  * `stats_sink(sender)` — the wire loop: snapshots as InfluxDB line
    protocol over a UniformSender (the reference's DFSTATS frames into
    deepflow_stats).
  * `system_sink(store)` — the dogfood loop: snapshots land directly in
    the store's `deepflow_system.deepflow_system` table in the
    prometheus-samples shape (time, metric, labels, value), so the
    framework's own SQL engine answers questions about the framework
    (`SELECT value FROM deepflow_system.deepflow_system WHERE metric =
    'tpu_pipeline_doc_in'`).
  * the sketch tier (`sketch_block_rows`, `sketch_system_sink`): closed
    windows' distinct counts, rtt quantiles (t-digest through the
    port's `ops/tdigest.tdigest_quantile` on the block's CPU tensors) and top-K
    heavy flows in the same row shape;
  * the live read plane's overlay providers (`PipelineLiveSource`,
    `SystemLiveSource`) for `querier/live.LiveRegistry`, and the
    closed-window sinks that share their row builders.

Influx line serialization follows the line-protocol typing rules:
integer fields keep their `{v}i` suffix, tag values escape
backslash/comma/equals/space, and non-finite floats are skipped.

The sinks' `bus=` (push-event batches) and `lineage=` (window lineage
hops) arguments need the push plane and the lineage tracker, which the
port does not have yet: passing either raises NotImplementedError.
"""

from __future__ import annotations

import math
import numbers
import re

import numpy as np

from ..ingest.sender import UniformSender
from ..storage.store import ColumnSpec, TableSchema
from ..utils.stats import StatsPoint


def _escape_tag(v: str) -> str:
    """Influx line-protocol tag-value escaping: backslash first, then
    the three structural characters (`,` `=` space)."""
    return (
        v.replace("\\", "\\\\")
        .replace(",", "\\,")
        .replace("=", "\\=")
        .replace(" ", "\\ ")
    )


def points_to_influx(points: list[StatsPoint]) -> str:
    lines = []
    for p in points:
        tags = "".join(f",{k}={_escape_tag(str(v))}" for k, v in p.tags)
        parts = []
        for k, v in p.fields.items():
            if isinstance(v, bool):
                v = int(v)
            if isinstance(v, numbers.Integral):
                parts.append(f"{k}={int(v)}i")  # keep influx int typing
            elif isinstance(v, numbers.Real):
                f = float(v)
                if math.isfinite(f):  # NaN/inf poison the line — skip
                    parts.append(f"{k}={f}")
        if not parts:
            continue
        lines.append(f"{p.module}{tags} {','.join(parts)} {int(p.timestamp * 1e9)}")
    return "\n".join(lines)


def stats_sink(sender: UniformSender):
    """→ a sink callable for StatsCollector.add_sink."""

    def sink(points: list[StatsPoint]) -> None:
        if not points:
            return
        text = points_to_influx(points)
        if text:
            sender.send([text.encode()])

    return sink


# ---------------------------------------------------------------------------
# deepflow_system: the dogfooded self-telemetry table. Same row shape as
# prometheus.samples, so the SQL engine resolves
# `deepflow_system.deepflow_system` directly (and the reference's PromQL
# evaluator reads the same rows through its db/table overrides).

DEEPFLOW_SYSTEM_DB = "deepflow_system"
DEEPFLOW_SYSTEM_TABLE = "deepflow_system"
# metric/labels are variable-width ("O", the ClickHouse-String analogue
# the store serializes per-part) — a fixed U<n> would silently clip a
# long packed label string, possibly mid-escape, and a label selector
# would then match nothing with no error
DEEPFLOW_SYSTEM_SCHEMA = TableSchema(
    DEEPFLOW_SYSTEM_TABLE,
    (
        ColumnSpec("time", "u4"),
        ColumnSpec("metric", "O"),
        ColumnSpec("labels", "O"),
        ColumnSpec("value", "f8"),
    ),
)

_METRIC_SAN_RE = re.compile(r"[^a-zA-Z0-9_:]")


def system_metric_name(module: str, field: str) -> str:
    """`<module>_<field>` sanitized to the PromQL metric charset
    ([a-zA-Z_:][a-zA-Z0-9_:]*) — span fields like `stats.fetch.count`
    become `stats_fetch_count`."""
    return _METRIC_SAN_RE.sub("_", f"{module}_{field}")


def points_to_system_columns(
    points: list[StatsPoint], *, extra_tags: dict | None = None
) -> dict[str, np.ndarray]:
    """StatsPoints → deepflow_system columns, one row per (point, field).

    Values store as f8 — integer counters up to 2^53 round-trip
    bit-exactly (the acceptance test pins this). Non-finite and
    non-numeric fields are skipped, same stance as points_to_influx.

    `extra_tags` merge into every row's packed labels (winning on
    collision) — the fleet aggregator stamps `host`/`group` here so
    per-host attribution is a plain PromQL label selector."""
    from .formats import pack_tags

    extra = {k: str(v) for k, v in (extra_tags or {}).items()}
    time_col: list[int] = []
    metric: list[str] = []
    labels: list[str] = []
    value: list[float] = []
    for p in points:
        packed = pack_tags({**{k: str(v) for k, v in p.tags}, **extra})
        for fname, v in p.fields.items():
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, numbers.Real):
                continue
            f = float(v)
            if not math.isfinite(f):
                continue
            time_col.append(int(p.timestamp))
            metric.append(system_metric_name(p.module, fname))
            labels.append(packed)
            value.append(f)
    return {
        "time": np.asarray(time_col, np.uint32),
        "metric": np.asarray(metric, dtype=object),
        "labels": np.asarray(labels, dtype=object),
        "value": np.asarray(value, np.float64),
    }


def ensure_system_table(store) -> None:
    store.create_table(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_SCHEMA)


def system_sink(store):
    """→ a StatsCollector sink writing snapshots straight into the
    store's deepflow_system table (no wire hop — this is the in-process
    dogfood path the bench/test stacks use; production stacks keep the
    DFSTATS wire loop as well)."""
    ensure_system_table(store)

    def sink(points: list[StatsPoint]) -> None:
        if not points:
            return
        cols = points_to_system_columns(points)
        if len(cols["time"]):
            store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, cols)

    return sink


# ---------------------------------------------------------------------------
# Sketch tier → deepflow_system. Closed-window sketch blocks
# (aggregator/sketchplane.WindowSketchBlock) land in the SAME
# prometheus-samples row shape, so distinct-count / quantile /
# heavy-hitter answers for a closed window are queryable without
# flushing exact rows:
#   SQL:    SELECT value FROM deepflow_system.deepflow_system
#           WHERE metric = 'deepflow_sketch_distinct' AND time = <w>

SKETCH_METRIC_DISTINCT = "deepflow_sketch_distinct"
SKETCH_METRIC_QUANTILE = "deepflow_sketch_rtt_quantile"
SKETCH_METRIC_TOPK = "deepflow_sketch_top_bytes"


def _not_ported(what: str, value) -> None:
    """Refuse a `bus=` / `lineage=` argument until its plane is ported."""
    if value is not None:
        raise NotImplementedError(
            f"{what}= needs "
            + ("the push-event plane (querier/events.py)" if what == "bus"
               else "the window lineage tracker (tracing/lineage.py)")
            + ", which is not ported yet"
        )


def sketch_block_rows(
    block, interval: int, *, quantiles=(0.5, 0.95, 0.99), topk: int = 16
) -> list[tuple[int, str, dict, float]]:
    """One closed-window block → (time, metric, labels, value) rows.

    Per-service distinct counts (services whose HLL row saw data) and
    rtt quantiles, the window-level distinct count, and the inverted
    top-K heavy flows (one series per recovered key: the `key` label is
    the flow fingerprint, `ip`/`svc` carry the id-preview words)."""
    import torch

    from ..ops.tdigest import tdigest_quantile

    t = block.window * interval
    rows: list[tuple[int, str, dict, float]] = []
    rows.append((t, SKETCH_METRIC_DISTINCT, {"service": "all"}, block.distinct()))
    per_group = block.distinct_per_group()
    active = np.nonzero(block.hll.max(axis=1) > 0)[0]
    for g in active:
        g = int(g)
        rows.append(
            (t, SKETCH_METRIC_DISTINCT, {"service": str(g)}, float(per_group[g]))
        )
        # quantile rows only for services with actual latency samples —
        # an all-zero histogram (e.g. UDP-only traffic, rtt_count=0)
        # must produce NO series, not a fake 0 ms series. One t-digest
        # compression serves every requested quantile.
        if block.hist[g].sum() > 0:
            m, w = block.tdigest(g)
            qv = tdigest_quantile(torch.from_numpy(m), torch.from_numpy(w),
                                  torch.tensor(list(quantiles), dtype=torch.float32))
            for q, v in zip(quantiles, qv):
                rows.append(
                    (t, SKETCH_METRIC_QUANTILE,
                     {"service": str(g), "q": str(q)}, float(v))
                )
    for rank, hh in enumerate(block.topk(topk)):
        rows.append(
            (
                t, SKETCH_METRIC_TOPK,
                {
                    "key": f"{hh['key_hi']:08x}{hh['key_lo']:08x}",
                    "rank": str(rank),
                    "ip": str(hh["id_a"]),
                    "svc": str(hh["id_b"]),
                },
                float(hh["estimate"]),
            )
        )
    return rows


def sketch_rows_to_columns(rows) -> dict[str, np.ndarray]:
    from .formats import pack_tags

    return {
        "time": np.asarray([r[0] for r in rows], np.uint32),
        "metric": np.asarray([r[1] for r in rows], dtype=object),
        "labels": np.asarray([pack_tags(r[2]) for r in rows], dtype=object),
        "value": np.asarray([r[3] for r in rows], np.float64),
    }


def sketch_system_sink(store, interval: int = 1, *, bus=None, **row_kw):
    """→ a callable(blocks) writing closed-window sketch answers into
    deepflow_system — wire a pipeline's `pop_closed_sketches()` (or a
    ShardedWindowManager's) into it after every ingest/drain. `bus`
    (publishing the close events) is not ported: non-None raises."""
    _not_ported("bus", bus)
    ensure_system_table(store)

    def sink(blocks) -> None:
        rows = []
        for b in blocks:
            rows.extend(sketch_block_rows(b, interval, **row_kw))
        if rows:
            store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE,
                         sketch_rows_to_columns(rows))

    return sink


# ---------------------------------------------------------------------------
# Live read plane: the open-window overlay's dogfood adapters. Two kinds of live source plug into querier/live.LiveRegistry:
#
#   * `live_flow_source(pipeline_or_manager)` — per-flow rows of the
#     OPEN windows from `snapshot_open()`, in the prometheus-samples
#     shape (one `deepflow_flow_bytes{key=…}` series per stash row).
#     The SAME `flow_window_rows` builder serves a closed window's
#     flushed rows (`flow_window_sink`), so the live partial and the
#     post-flush value are bit-exact by construction once the window's
#     traffic stops.
#   * `live_system_source(collector)` — the CURRENT counter values of
#     every registered Countable (StatsCollector.sample — no sink, no
#     store write), stamped at the query's upper time edge: feeder
#     health and device counter lanes answer at sub-`delay` latency
#     instead of waiting for the next collector tick. deepflow_tpu
#     observing itself in real time.

LIVE_METRIC_FLOW_BYTES = "deepflow_flow_bytes"


def flow_window_rows(
    f, *, metric: str = LIVE_METRIC_FLOW_BYTES, meter_col: int | None = None,
    meter_schema=None,
) -> list[tuple[int, str, dict, float]]:
    """One (open-partial OR flushed) window's rows → samples rows: a
    series per flow key (labels: the 64-bit fingerprint + window id),
    value = the chosen meter column (default byte_tx). Shared by the
    live source and the closed-window sink so the two emit identical
    values for identical window content."""
    if meter_col is None:
        from ..datamodel.schema import FLOW_METER

        meter_col = (meter_schema or FLOW_METER).index("byte_tx")
    rows = []
    for i in range(f.count):
        rows.append(
            (
                f.start_time, metric,
                {"key": f"{int(f.key_hi[i]):08x}{int(f.key_lo[i]):08x}",
                 "window": str(f.window_idx)},
                float(f.meters[i, meter_col]),
            )
        )
    return rows


class PipelineLiveSource:
    """LiveRegistry provider over an object exposing `snapshot_open()`
    (RollupPipeline, WindowManager, ShardedWindowManager): open-window
    partial rows in the samples shape. `epoch()` returns the snapshot
    seq — and may TAKE the (rate-limited) snapshot, so the result
    cache's live token names exactly the generation a subsequent
    evaluation reads.

    Two correctness/efficiency guards on top of the raw snapshot:

      * windows the manager has CLOSED since the (rate-limited)
        snapshot was cached are dropped at pull time, using the
        manager's host-side `start_window` (a plain int — no device
        read). A closed window's flushed rows are in (or en route to)
        the store; serving its stale partial alongside them would
        double-count in SQL aggregates, which have no per-series
        last-sample-wins dedup the way PromQL does.
      * rows are BUILT once per snapshot generation and cached; a
        range query's per-step pulls slice the prebuilt columns with a
        numpy time mask instead of rebuilding per-row label dicts
        O(steps × rows) times."""

    def __init__(self, owner, row_builder=flow_window_rows):
        self.owner = owner
        self.row_builder = row_builder
        self._built: tuple | None = None  # (seq, columns dict | None)

    def _open_lo(self):
        """The manager's CURRENT open-span start in seconds (host int;
        None = nothing ingested) — fresher than the cached snapshot."""
        wm = getattr(self.owner, "wm", self.owner)
        sw = getattr(wm, "start_window", None)
        if sw is None:
            return None
        interval = getattr(wm, "interval", None)
        if interval is None:
            interval = wm.config.interval
        return sw * interval

    def _columns(self):
        snap = self.owner.snapshot_open()
        if self._built is not None and self._built[0] == snap.seq:
            return self._built[1]
        rows = []
        for w in snap.windows:
            rows.extend(self.row_builder(w))
        cols = sketch_rows_to_columns(rows) if rows else None
        self._built = (snap.seq, cols)
        return cols

    def __call__(self, lo: int, hi: int):
        cols = self._columns()
        if cols is None:
            return None
        t = np.asarray(cols["time"], np.int64)
        open_lo = self._open_lo()
        # flushed supersedes: a window below the CURRENT open span has
        # closed since the snapshot — its flushed rows own the answer
        floor = lo if open_lo is None else max(lo, open_lo)
        sel = (t >= floor) & (t < hi)
        if not sel.any():
            return None
        if sel.all():
            return cols
        return {k: np.asarray(v)[sel] for k, v in cols.items()}

    def epoch(self) -> int:
        return self.owner.snapshot_open().seq

    def open_from(self):
        of = self.owner.snapshot_open().open_from
        open_lo = self._open_lo()
        if of is None or open_lo is None:
            return of
        return max(of, open_lo)


def live_flow_source(
    owner, *, db: str = DEEPFLOW_SYSTEM_DB, table: str = DEEPFLOW_SYSTEM_TABLE,
    registry=None, row_builder=flow_window_rows,
):
    """Register an open-window flow source for (db, table); returns
    (provider, handle) — pass the handle to registry.unregister at
    teardown."""
    from ..querier.live import default_live_registry

    reg = default_live_registry if registry is None else registry
    provider = PipelineLiveSource(owner, row_builder)
    return provider, reg.register(db, table, provider)


def flow_window_sink(store, *, bus=None, lineage=None, **row_kw):
    """→ callable(windows) writing CLOSED windows' rows through the
    same `flow_window_rows` builder the live source uses — window
    close = insert = store epoch bump = result-cache invalidation.
    `bus` and `lineage` are not ported: non-None raises."""
    _not_ported("bus", bus)
    _not_ported("lineage", lineage)
    ensure_system_table(store)

    def sink(windows) -> None:
        rows = []
        for f in windows:
            rows.extend(flow_window_rows(f, **row_kw))
        if rows:
            store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE,
                         sketch_rows_to_columns(rows))

    return sink


LIVE_METRIC_WINDOW_ROWS = "deepflow_window_rows"


def docbatch_window_sink(store, *, interval: int = 1,
                         metric: str = LIVE_METRIC_WINDOW_ROWS,
                         bus=None, lineage=None):
    """→ callable(outputs) for CLOSED windows that arrive as writer
    DocBatches (RollupPipeline.ingest / ShardedWindowManager.ingest /
    pop_tier_docbatches): one summary row per window lands in
    deepflow_system (time = window start, labels {window, tier}, value
    = row count) — the minimal "this window is queryable" insert.
    Outputs may be DocBatches or (tier_interval_s, DocBatch) pairs (the
    cascade shape). `bus` and `lineage` are not ported: non-None
    raises."""
    _not_ported("bus", bus)
    _not_ported("lineage", lineage)
    ensure_system_table(store)

    def sink(outputs) -> None:
        rows = []
        for o in outputs:
            iv, db = o if isinstance(o, tuple) else (interval, o)
            if db.timestamp.shape[0] == 0:
                continue
            w = int(db.timestamp[0]) // iv
            rows.append((w * iv, metric, {"window": str(w), "tier": f"{iv}s"},
                         float(db.timestamp.shape[0])))
        if rows:
            store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE,
                         sketch_rows_to_columns(rows))

    return sink


class SystemLiveSource:
    """LiveRegistry provider pulling the CURRENT Countable counters
    (collector.sample — no sinks, no store writes) stamped at the
    query's upper time edge."""

    def __init__(self, collector=None):
        from ..utils.stats import default_collector

        self.collector = default_collector if collector is None else collector
        self._pulls = 0

    def __call__(self, lo: int, hi: int):
        # stamp at the query's upper edge, clamped into the u32 time
        # column's range — an unbounded SQL range passes hi = 2^62 and
        # an unclamped stamp would overflow the dtype (and silently
        # drop the whole overlay via the registry's containment)
        t = int(max(min(lo, 0xFFFFFFFF), min(hi - 1, 0xFFFFFFFF)))
        points = self.collector.sample(now=float(t))
        self._pulls += 1
        cols = points_to_system_columns(points)
        return cols if len(cols["time"]) else None

    def epoch(self) -> int:
        # counters move continuously — every pull is a new generation,
        # so cached entries over live counters never serve stale values
        return self._pulls


def live_system_source(collector=None, *, registry=None):
    """Register the self-telemetry live source on
    deepflow_system.deepflow_system; returns (provider, handle)."""
    from ..querier.live import default_live_registry

    reg = default_live_registry if registry is None else registry
    provider = SystemLiveSource(collector)
    return provider, reg.register(
        DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, provider
    )
