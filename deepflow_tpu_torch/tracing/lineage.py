"""Window lineage tracing + data-freshness plane.
Port copy of deepflow_tpu/tracing/lineage.py.


The repo already re-implements the reference's signature feature —
zero-instrumentation distributed tracing — for *ingested* telemetry
(TraceTreeBuilder over l7_flow_log). This module turns that engine on
the pipeline itself: every window's journey from receiver frame
admission to the row becoming queryable is recorded as a set of HOPS,
each hop exported as a span row on the same OTLP `l7_flow_log` lane,
so `tracing.tree.assemble_trace` / `TraceTreeBuilder` assemble a
per-window trace tree that answers "where did window W spend its
2.3 s?" with the repo's own trace machinery.

Design constraints, in order:

  * **zero new device fetches** — every hop is a HOST wall stamp taken
    at a seam the host already owns (frame admission, pump, journal
    append, staged upload, dispatch call, counter-block replay, flush
    drain, store insert, store scan). Device-side hops are *derived,
    not fetched*: the counter blocks / K-ring stats / flush watermarks
    that already ride the existing ≤3-fetch drain tell WHICH dispatch
    closed a window; a small FIFO of dispatch wall stamps (pushed per
    dispatch, popped per replayed block) tells WHEN it was dispatched.
    The port's tests (`tests/test_torch_lineage.py`) and the card's
    smoke run pin ingest-attributable fetch parity with the plane
    attached: a lineage seam never reads a tensor.
  * **no context on the wire** — the propagated trace context IS the
    window id: `window_trace_id(service, window, interval)` is a pure
    function, so the receiver, feeder, manager, store sink and querier
    all join the same trace without a header field. Hops that happen
    before windows are known (admission, pump, journal, upload) park in
    a per-pump *pending context* and bind to the batch's window span
    the moment the host computes it (numpy min/max over timestamps it
    already holds — pre-upload, never a transfer).
  * **bounded** — at most `max_windows` live lineage records
    (oldest-evicted-counted), a bounded admission-stamp ring, a bounded
    dispatch-stamp FIFO.

On top of the trees, `FreshnessTracker` computes per-tier
event-time-to-queryable lag lanes — the SLO a live query plane is
actually judged on:

  * `ingest`     — last fused dispatch covering the window vs the
                   window's event-time end
  * `flush`      — flush-drain completion vs event-time end
  * `cascade`    — tier close vs the TIER window's event-time end
  * `visibility` — store insert (row queryable via SQL/PromQL) vs
                   event-time end
  * `partial`    — a live-snapshot read serving the still-OPEN window,
                   anchored on the window START (age of the open
                   window when the live read served it) and kept as a
                   DISTINCT lane so dashboards can tell a partial
                   answer from post-flush visibility

Each tier registers its own Countable (`tpu_freshness`, tier label),
so the lanes dogfood into `deepflow_system` and answer via SQL AND
PromQL; one rule over `tpu_freshness_visibility_lag_ms` gets a
per-series for-ladder per tier through the alert engine (querier/alerts.py). Every
lag sample carries an EXEMPLAR: the trace id of the window that
produced it, linking the metric that fired a page to the trace tree
that explains it.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict, deque

import numpy as np

from ..utils.spans import SpanHistSpec, loghist_quantiles_np
from ..utils.stats import register_countable
from .tree import SpanRow, assemble_trace, search_index

#: the hop vocabulary — one trace-tree node per hop (app_service =
#: hop name; TraceTreeBuilder collapses per service)
HOP_RECEIVER_ADMIT = "receiver.admit"
HOP_FEEDER_PUMP = "feeder.pump"
HOP_JOURNAL_APPEND = "journal.append"
HOP_UPLOAD_STAGE = "upload.stage"
HOP_INGEST_DISPATCH = "ingest.dispatch"
HOP_WINDOW_ADVANCE = "window.advance"
HOP_FLUSH_DRAIN = "flush.drain"
HOP_CASCADE_CLOSE = "cascade.close"
HOP_STORE_INSERT = "store.insert"
HOP_QUERY_SNAPSHOT = "query.snapshot"  # partial (live) read — distinct
HOP_QUERY_FIRST = "query.first"

#: static parent topology. At export time a hop's parent is the NEAREST
#: ancestor along this chain that exists in the same window's record, so
#: a feederless pipeline (no pump/journal hops) still assembles with no
#: orphans — children just re-root on what actually ran.
HOP_PARENT = {
    HOP_RECEIVER_ADMIT: None,
    HOP_FEEDER_PUMP: HOP_RECEIVER_ADMIT,
    HOP_JOURNAL_APPEND: HOP_FEEDER_PUMP,
    HOP_UPLOAD_STAGE: HOP_FEEDER_PUMP,
    HOP_INGEST_DISPATCH: HOP_UPLOAD_STAGE,
    HOP_WINDOW_ADVANCE: HOP_INGEST_DISPATCH,
    HOP_FLUSH_DRAIN: HOP_WINDOW_ADVANCE,
    HOP_CASCADE_CLOSE: HOP_FLUSH_DRAIN,
    HOP_STORE_INSERT: HOP_FLUSH_DRAIN,
    HOP_QUERY_SNAPSHOT: HOP_INGEST_DISPATCH,
    HOP_QUERY_FIRST: HOP_STORE_INSERT,
}

#: freshness lag kinds (FreshnessTracker lanes)
LAG_INGEST = "ingest"
LAG_FLUSH = "flush"
LAG_CASCADE = "cascade"
LAG_VISIBILITY = "visibility"
LAG_PARTIAL = "partial"

DEFAULT_SERVICE = "tpu.pipeline"

#: a window's spans EXPORT only once one of these hops exists — the
#: window left the device (or became externally visible), so the
#: pre-close hops have stopped merging and each span id is emitted
#: exactly once (the store lane is append-only; a re-emitted id would
#: double-count in assembled trees)
TERMINAL_HOPS = (HOP_FLUSH_DRAIN, HOP_CASCADE_CLOSE, HOP_STORE_INSERT,
                 HOP_QUERY_FIRST)

_U64 = 0xFFFFFFFFFFFFFFFF


def window_trace_id(service: str, window_idx: int, interval: int = 1) -> str:
    """The deterministic 128-bit trace id of one (service, tier,
    window): high 64 bits fingerprint the (service, interval) pair, low
    64 bits are the window index. Pure function — ANY component that
    knows the window id can join (or query) the trace without a
    propagated header, and `dfctl trace window <id>` needs no lookup."""
    hi = search_index(f"{service}/{int(interval)}s")
    return f"{hi:016x}{int(window_idx) & _U64:016x}"


def hop_span_id(trace_id: str, hop: str) -> str:
    """Deterministic span id of one hop inside one window's trace —
    parents can be referenced before (or without) seeing them emitted."""
    return f"{search_index(f'{trace_id}/{hop}'):016x}"


class _HopAgg:
    """One hop's aggregate inside one window's lineage: multiple events
    (e.g. every batch that fed the window dispatches once) collapse into
    first-start / last-end / count — one span per (window, hop)."""

    __slots__ = ("start_s", "end_s", "count", "rows", "exported")

    def __init__(self, start_s: float, end_s: float, rows: int = 0):
        self.start_s = start_s
        self.end_s = end_s
        self.count = 1
        self.rows = rows
        self.exported = False

    def merge(self, start_s: float, end_s: float, rows: int = 0) -> None:
        self.start_s = min(self.start_s, start_s)
        self.end_s = max(self.end_s, end_s)
        self.count += 1
        self.rows += rows
        # `exported` is STICKY: the store lane is append-only and the
        # tree assemblers have no span-id dedup, so re-emitting the
        # same span id would double-count the hop in RED aggregates.
        # drain_spans defers a window's export until it has a terminal
        # hop, so pre-close merges are folded in before the one export.


class WindowLineage:
    """Every recorded hop of one (tier interval, window)."""

    __slots__ = ("window_idx", "interval", "hops", "lags")

    def __init__(self, window_idx: int, interval: int):
        self.window_idx = int(window_idx)
        self.interval = int(interval)
        self.hops: dict[str, _HopAgg] = {}
        self.lags: dict[str, float] = {}  # kind → lag seconds (latest)

    @property
    def event_end_s(self) -> int:
        """Event-time end of the window — the freshness anchor."""
        return (self.window_idx + 1) * self.interval

    def note(self, hop: str, start_s: float, end_s: float, rows: int = 0):
        agg = self.hops.get(hop)
        if agg is None:
            self.hops[hop] = _HopAgg(start_s, end_s, rows)
        else:
            agg.merge(start_s, end_s, rows)

    def parent_hop(self, hop: str) -> str | None:
        """Nearest ancestor hop PRESENT in this record (fallback chain)."""
        p = HOP_PARENT.get(hop)
        while p is not None and p not in self.hops:
            p = HOP_PARENT.get(p)
        return p

    def span_rows(self, trace_id: str, *, only_unexported: bool = False,
                  mark: bool = False) -> list[SpanRow]:
        rows = []
        name = f"w{self.window_idx}@{self.interval}s"
        for hop, agg in self.hops.items():
            if only_unexported and agg.exported:
                continue
            parent = self.parent_hop(hop)
            rows.append(
                SpanRow(
                    trace_id=trace_id,
                    span_id=hop_span_id(trace_id, hop),
                    parent_span_id=(
                        hop_span_id(trace_id, parent) if parent else ""
                    ),
                    app_service=hop,
                    endpoint=name,
                    start_us=int(agg.start_s * 1e6),
                    end_us=int(agg.end_s * 1e6),
                    response_duration_us=max(
                        0, int((agg.end_s - agg.start_s) * 1e6)
                    ),
                )
            )
            if mark:
                agg.exported = True
        return rows


# ---------------------------------------------------------------------------
# freshness lanes


class _FreshLane:
    __slots__ = ("last_ms", "max_ms", "samples", "hist",
                 "last_window", "last_trace")

    def __init__(self, bins: int):
        self.last_ms = 0.0
        self.max_ms = 0.0
        self.samples = 0
        self.hist = np.zeros(bins, np.int64)
        self.last_window = -1
        self.last_trace = ""


class _TierFreshView:
    """The per-tier Countable face: one of these registers per tier
    label (`tpu_freshness{tier="60s"}`), so ONE PromQL rule over
    `tpu_freshness_visibility_lag_ms` fans into per-series alert
    ladders — one per tier — through the per-series alert engine."""

    def __init__(self, owner: "FreshnessTracker", interval: int):
        self.owner = owner
        self.interval = interval

    def get_counters(self) -> dict[str, float | int]:
        return self.owner._tier_counters(self.interval)


#: lag histograms: 512 log bins over 1 µs .. ~3.4e8 ms at ≤3.5% error
_FRESH_HIST = SpanHistSpec(bins=512, vmin=0.001, gamma=1.07)
_FRESH_QS = (0.5, 0.95)


class FreshnessTracker:
    """Per-tier event-time-to-queryable lag lanes + exemplars.

    Pure host arithmetic: `observe()` is a dict update + one histogram
    increment. Lag = hop wall stamp − window event-time end (window
    START for the `partial` lane — the window is still open), in
    SECONDS in, milliseconds out on the Countable face."""

    def __init__(self, *, name: str = "freshness", collector=None,
                 autoregister: bool = True, group: str | None = None):
        self.name = name
        # per-shard-group freshness lanes: a multi-host
        # deployment runs one tracker per shard group, labelled
        # tpu_freshness{tier=..., group=...} — cross-host skew between
        # groups is a dashboard diff of the same lane across labels
        self.group = group
        self._lock = threading.Lock()
        # (interval, kind) → _FreshLane
        self._lanes: dict[tuple[int, str], _FreshLane] = {}
        self._views: dict[int, _TierFreshView] = {}  # strong refs (weak reg)
        self._srcs: list = []
        self._collector = collector
        self._autoregister = autoregister

    def _get_collector(self):
        if self._collector is not None:
            return self._collector
        from ..utils.stats import default_collector

        return default_collector

    def observe(self, kind: str, interval: int, lag_s: float,
                window_idx: int, trace_id: str) -> None:
        interval = int(interval)
        lag_ms = float(lag_s) * 1e3
        with self._lock:
            lane = self._lanes.get((interval, kind))
            if lane is None:
                lane = self._lanes[(interval, kind)] = _FreshLane(
                    _FRESH_HIST.bins
                )
                if interval not in self._views:
                    view = self._views[interval] = _TierFreshView(
                        self, interval
                    )
                    if self._autoregister:
                        tags = {"tier": f"{interval}s", "name": self.name}
                        if self.group is not None:
                            tags["group"] = self.group
                        self._srcs.append(
                            self._get_collector().register(
                                "tpu_freshness", view, **tags
                            )
                        )
            lane.last_ms = lag_ms
            lane.max_ms = max(lane.max_ms, lag_ms)
            lane.samples += 1
            lane.hist[_FRESH_HIST.bin(max(lag_ms, 0.0))] += 1
            lane.last_window = int(window_idx)
            lane.last_trace = trace_id

    def _tier_counters(self, interval: int) -> dict[str, float | int]:
        out: dict[str, float | int] = {}
        with self._lock:
            items = [
                (kind, lane) for (iv, kind), lane in self._lanes.items()
                if iv == interval
            ]
            for kind, lane in items:
                out[f"{kind}_lag_ms"] = round(lane.last_ms, 3)
                out[f"{kind}_lag_max_ms"] = round(lane.max_ms, 3)
                out[f"{kind}_samples"] = lane.samples
                qv = loghist_quantiles_np(lane.hist, _FRESH_HIST, _FRESH_QS)
                for q, v in zip(_FRESH_QS, qv):
                    out[f"{kind}_lag_p{int(q * 100)}_ms"] = round(float(v), 3)
        return out

    def get_counters(self) -> dict[str, float | int]:
        """Flat all-tier face (lane names prefixed `<interval>s.`) —
        the bench-snapshot/debug shape; the per-tier views above are
        the dogfood registration."""
        out: dict[str, float | int] = {}
        with self._lock:
            tiers = sorted({iv for iv, _ in self._lanes})
        for iv in tiers:
            for k, v in self._tier_counters(iv).items():
                out[f"{iv}s.{k}"] = v
        return out

    def hist_dump(self) -> dict[str, list[int]]:
        """lane → raw log-histogram bin counts (nonzero (bin, count)
        pairs, compact). The elastic-topology proof pins
        that a rebalanced group's lag distribution across BOTH owners
        sums bin-for-bin to the uninterrupted oracle's — histograms
        add; quantile summaries don't."""
        with self._lock:
            return {
                f"{iv}s.{kind}": [
                    [int(b), int(lane.hist[b])]
                    for b in np.nonzero(lane.hist)[0]
                ]
                for (iv, kind), lane in self._lanes.items()
            }

    def exemplars(self) -> dict[str, dict]:
        """lane → {trace_id, window, lag_ms}: the metric→trace links a
        dashboard renders next to each lag series (the exemplar
        contract)."""
        with self._lock:
            return {
                f"{iv}s.{kind}": {
                    "trace_id": lane.last_trace,
                    "window": lane.last_window,
                    "lag_ms": round(lane.last_ms, 3),
                }
                for (iv, kind), lane in self._lanes.items()
                if lane.samples
            }

    def close(self) -> None:
        col = self._get_collector()
        for src in self._srcs:
            try:
                col.deregister(src)
            except Exception:
                pass
        self._srcs.clear()


def merge_hist_dumps(*dumps: dict) -> dict[str, list[list[int]]]:
    """Sum `hist_dump()` outputs bin-for-bin across trackers/hosts —
    the summary-domain merge algebra (histograms add; quantile
    summaries don't). Output is the same sparse sorted shape
    `hist_dump()` emits, so the merge composes: the fleet pane pins
    merge(host dumps) bit-exact against the aggregator's view."""
    acc: dict[str, dict[int, int]] = {}
    for dump in dumps:
        for lane, pairs in dump.items():
            tgt = acc.setdefault(lane, {})
            for b, c in pairs:
                tgt[int(b)] = tgt.get(int(b), 0) + int(c)
    return {
        lane: [[b, tgt[b]] for b in sorted(tgt)]
        for lane, tgt in sorted(acc.items())
    }


# ---------------------------------------------------------------------------
# the tracker

#: process-wide registry of live trackers — the REST/dfctl live
#: fallback assembles a not-yet-exported window trace from here
_REGISTRY: "weakref.WeakSet[LineageTracker]" = weakref.WeakSet()


def all_trackers() -> list["LineageTracker"]:
    return list(_REGISTRY)


class LineageTracker:
    """Per-window hop recorder for one pipeline (one service name, one
    base tier interval; cascade tiers share the tracker with their own
    interval key). Attach with `RollupPipeline.attach_lineage` /
    `ShardedWindowManager.attach_lineage` (receiver/feeder take it as
    `lineage=`); everything else is plumbing-free — the window id is
    the context."""

    MAX_ADMIT_STAMPS = 4096
    MAX_DISPATCH_STAMPS = 256
    #: a batch whose (t_min, t_max) spans more than this many windows
    #: binds only the newest MAX_BIND_SPAN (counted) — a corrupt
    #: timestamp must not turn one bind into a million dict inserts
    MAX_BIND_SPAN = 64

    def __init__(self, service: str = DEFAULT_SERVICE, interval: int = 1,
                 *, clock=time.time, freshness: FreshnessTracker | None = None,
                 max_windows: int = 4096, name: str = "lineage",
                 group: str | None = None):
        self.service = service
        self.interval = int(interval)
        self.clock = clock
        self.freshness = freshness
        self.name = name
        # multi-host mesh: shard-group label for the
        # Countable rows. Trace ids stay PURE functions of (service,
        # window, interval) — deliberately NOT of the group — so every
        # host's hops for one window join ONE trace with no wire
        # context; the group label only distinguishes tracker rows
        self.group = group
        self.max_windows = int(max_windows)
        self._lock = threading.RLock()
        # (interval, window_idx) → WindowLineage, eviction order
        self._windows: "OrderedDict[tuple[int, int], WindowLineage]" = (
            OrderedDict()
        )
        self._admit_ring: deque[float] = deque(maxlen=self.MAX_ADMIT_STAMPS)
        self._dispatch_ring: deque[tuple[float, float]] = deque(
            maxlen=self.MAX_DISPATCH_STAMPS
        )
        # per-pump pending context: hop → (start_s, end_s) — bound to
        # windows at the next dispatch with a known span. Scope: a
        # feeder pump resets it via begin_pump(); FEEDERLESS pipelines
        # (attach_lineage + direct ingest, no pump loop) reset it after
        # every dispatch bind instead — without that, note_stage's
        # min-merge would pin upload.stage's start at the first-ever
        # stage call and every window's span would grow to process
        # uptime.
        self._ctx: dict[str, tuple[float, float]] = {}
        self._in_pump = False
        # incremental-export + query bookkeeping: keys touched since
        # the last drain_spans, and keys inserted-but-not-yet-queried —
        # the hot faces stay O(changed), not O(max_windows)
        self._dirty: set[tuple[int, int]] = set()
        self._awaiting_query: set[tuple[int, int]] = set()
        self.counters = {
            "hops_recorded": 0,
            "windows_tracked": 0,
            "windows_evicted": 0,
            "spans_exported": 0,
            "bind_span_clamped": 0,
        }
        tags = {"name": name}
        if group is not None:
            tags["group"] = group
        self._stats_src = register_countable("tpu_lineage", self, **tags)
        _REGISTRY.add(self)

    # -- countable face ---------------------------------------------------
    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["windows_live"] = len(self._windows)
            out["admit_stamps_pending"] = len(self._admit_ring)
        return out

    def close(self) -> None:
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)
        if self.freshness is not None:
            self.freshness.close()
        _REGISTRY.discard(self)

    # -- record plumbing --------------------------------------------------
    def _record(self, interval: int, window_idx: int) -> WindowLineage:
        key = (int(interval), int(window_idx))
        rec = self._windows.get(key)
        if rec is None:
            rec = self._windows[key] = WindowLineage(window_idx, interval)
            self.counters["windows_tracked"] += 1
            while len(self._windows) > self.max_windows:
                old_key, _old = self._windows.popitem(last=False)
                self._dirty.discard(old_key)
                self._awaiting_query.discard(old_key)
                self.counters["windows_evicted"] += 1
        else:
            self._windows.move_to_end(key)
        return rec

    def _note(self, rec: WindowLineage, hop: str, start_s, end_s, rows=0):
        rec.note(hop, float(start_s), float(end_s), int(rows))
        self._dirty.add((rec.interval, rec.window_idx))
        self.counters["hops_recorded"] += 1

    def _fresh(self, kind: str, rec: WindowLineage, stamp_s: float,
               *, anchor_start: bool = False) -> None:
        if self.freshness is None:
            return
        anchor = (
            rec.window_idx * rec.interval if anchor_start else rec.event_end_s
        )
        lag = float(stamp_s) - anchor
        rec.lags[kind] = lag
        self.freshness.observe(
            kind, rec.interval, lag, rec.window_idx,
            window_trace_id(self.service, rec.window_idx, rec.interval),
        )

    # -- ownership handover ------------------------------------
    def export_open(self, lo_window: int) -> dict:
        """Serialize the hop records of every still-open window (≥
        `lo_window` on the base tier) for a shard-group handover: the
        moving group's state checkpoint carries its windows' partial
        aggregates, and THIS carries their partial lineage — so the
        new owner's flush still observes the ingest lag a window
        accrued on the old owner, and its trace joins the hops from
        both hosts (ids are derived, so no id mapping is needed)."""
        with self._lock:
            wins = []
            for (iv, w), rec in self._windows.items():
                if iv != self.interval or w < int(lo_window):
                    continue
                wins.append({
                    "window": w,
                    "hops": {
                        h: [a.start_s, a.end_s, a.count, a.rows]
                        for h, a in rec.hops.items()
                    },
                })
            return {"interval": self.interval, "windows": wins}

    def import_open(self, data: dict) -> None:
        """Adopt exported open-window lineage (the export_open twin on
        the new owner). Hop aggregates merge, so importing into a
        tracker that already saw post-flip traffic for a window is
        safe — first-start/last-end semantics hold across hosts."""
        with self._lock:
            for win in data.get("windows", ()):
                rec = self._record(
                    int(data.get("interval", self.interval)),
                    int(win["window"]),
                )
                for hop, vals in win["hops"].items():
                    start_s, end_s, count, rows = (
                        float(vals[0]), float(vals[1]),
                        int(vals[2]), int(vals[3]),
                    )
                    rec.note(hop, start_s, end_s, rows)
                    agg = rec.hops[hop]
                    # note() counted one event; fold the remaining
                    # event count in so RED rates stay truthful
                    agg.count += count - 1
                self._dirty.add((rec.interval, rec.window_idx))

    # -- pre-window context (receiver / feeder / journal / upload) --------
    def note_admit(self, t: float | None = None) -> None:
        """Receiver frame admission stamp (called from receiver dispatch
        threads — just an append under the lock)."""
        with self._lock:
            self._admit_ring.append(self.clock() if t is None else t)

    def begin_pump(self) -> None:
        """Feeder pump start: reset the pending context (and flip the
        context scope to pump-lifetime — see _ctx)."""
        with self._lock:
            now = self.clock()
            self._in_pump = True
            self._ctx = {HOP_FEEDER_PUMP: (now, now)}

    def note_frames(self, n: int) -> None:
        """Pair n admitted frames with their receiver admission stamps
        (FIFO): the earliest stamp opens the receiver.admit hop, the
        pump time closes it."""
        with self._lock:
            now = self.clock()
            t0 = None
            for _ in range(min(n, len(self._admit_ring))):
                s = self._admit_ring.popleft()
                t0 = s if t0 is None else min(t0, s)
            if t0 is not None:
                have = self._ctx.get(HOP_RECEIVER_ADMIT)
                self._ctx[HOP_RECEIVER_ADMIT] = (
                    (min(have[0], t0), now) if have else (t0, now)
                )
            # the pump hop's end tracks the latest activity
            p = self._ctx.get(HOP_FEEDER_PUMP)
            if p is not None:
                self._ctx[HOP_FEEDER_PUMP] = (p[0], now)

    def drop_stamps(self, n: int) -> None:
        """Discard n admission stamps WITHOUT folding them into the
        context — for frames the feeder admitted but that contribute
        no rows (quarantined/bad, counted-shed, empty). Every admitted
        frame must consume exactly one stamp or the FIFO pairing
        drifts: a 1% bad-frame rate would otherwise make every later
        window's receiver.admit start monotonically staler."""
        with self._lock:
            for _ in range(min(n, len(self._admit_ring))):
                self._admit_ring.popleft()

    def note_journal(self, start_s: float) -> None:
        with self._lock:
            now = self.clock()
            have = self._ctx.get(HOP_JOURNAL_APPEND)
            self._ctx[HOP_JOURNAL_APPEND] = (
                (min(have[0], start_s), now) if have else (start_s, now)
            )

    def note_stage(self, start_s: float) -> None:
        """Staged device upload (RollupPipeline.stage)."""
        with self._lock:
            now = self.clock()
            have = self._ctx.get(HOP_UPLOAD_STAGE)
            self._ctx[HOP_UPLOAD_STAGE] = (
                (min(have[0], start_s), now) if have else (start_s, now)
            )

    # -- dispatch / advance / flush (the manager seams) -------------------
    def note_dispatch(self, window_span: tuple[int, int] | None,
                      start_s: float) -> None:
        """One fused-step dispatch: bind the pending context + the
        ingest.dispatch hop to every window in `window_span` (inclusive
        lo..hi, from the batch's own host-side timestamps) and push a
        wall stamp onto the FIFO the counter-block replay pops — the
        derived-not-fetched device time base for advances discovered at
        a K-ring drain."""
        with self._lock:
            end_s = self.clock()
            self._dispatch_ring.append((start_s, end_s))
            if window_span is None:
                return
            lo, hi = int(window_span[0]), int(window_span[1])
            if hi - lo + 1 > self.MAX_BIND_SPAN:
                self.counters["bind_span_clamped"] += 1
                lo = hi - self.MAX_BIND_SPAN + 1
            ctx = dict(self._ctx)
            for w in range(lo, hi + 1):
                rec = self._record(self.interval, w)
                for hop, (a, b) in ctx.items():
                    self._note(rec, hop, a, b)
                self._note(rec, HOP_INGEST_DISPATCH, start_s, end_s)
            if not self._in_pump:
                # feederless scope: this dispatch consumed its context
                # (a pump-scoped context is reset by begin_pump instead)
                self._ctx = {}

    def pop_dispatch_stamp(self) -> tuple[float, float] | None:
        """FIFO pairing: one counter block replayed = one dispatch."""
        with self._lock:
            return self._dispatch_ring.popleft() if self._dispatch_ring else None

    def note_advance(self, lo: int, hi: int,
                     stamp: tuple[float, float] | None) -> None:
        """Windows [lo, hi) closed: the advance hop, timed from the
        dispatch stamp of the batch whose counter block triggered it
        (start) to now (the host discovered/flushed it)."""
        with self._lock:
            now = self.clock()
            start = stamp[0] if stamp else now
            for (iv, w), rec in list(self._windows.items()):
                if iv == self.interval and lo <= w < hi:
                    self._note(rec, HOP_WINDOW_ADVANCE, start, now)

    def note_flush_windows(self, items: list[tuple[int, int]],
                           start_s: float | None = None) -> None:
        """Flush-drain completion for tier-0 windows: items are
        (window_idx, rows). Freshness: ingest lag (from the recorded
        dispatch hop) + flush lag anchor here — the window is closed."""
        with self._lock:
            now = self.clock()
            for w, rows in items:
                rec = self._record(self.interval, w)
                self._note(rec, HOP_FLUSH_DRAIN,
                           now if start_s is None else start_s, now, rows)
                disp = rec.hops.get(HOP_INGEST_DISPATCH)
                if disp is not None:
                    self._fresh(LAG_INGEST, rec, disp.end_s)
                self._fresh(LAG_FLUSH, rec, now)

    def note_tier_windows(self, items: list[tuple[int, int, int]],
                          start_s: float | None = None) -> None:
        """Cascade tier closes: items are (tier_interval_s, window_idx,
        rows). Tier windows get their own trace (same service, tier
        interval in the id) rooted at cascade.close."""
        with self._lock:
            now = self.clock()
            for interval, w, rows in items:
                rec = self._record(interval, w)
                self._note(rec, HOP_CASCADE_CLOSE,
                           now if start_s is None else start_s, now, rows)
                self._fresh(LAG_CASCADE, rec, now)

    # -- downstream (store / query) ---------------------------------------
    def note_store_insert(self, items: list[tuple[int, int]]) -> None:
        """Rows of closed windows landed in the store — the moment the
        window becomes queryable (visibility lag). Items are
        (tier_interval_s, window_idx); tier 0 callers pass the base
        interval."""
        with self._lock:
            now = self.clock()
            for interval, w in items:
                rec = self._record(interval or self.interval, w)
                self._note(rec, HOP_STORE_INSERT, now, now)
                self._awaiting_query.add((rec.interval, rec.window_idx))
                self._fresh(LAG_VISIBILITY, rec, now)

    def note_snapshot(self, items: list[tuple[int, int]]) -> None:
        """A live snapshot served these still-OPEN windows: the
        query.snapshot hop + the DISTINCT `partial` freshness lane
        (anchored on window start — the window has no end yet)."""
        with self._lock:
            now = self.clock()
            for w, rows in items:
                rec = self._record(self.interval, w)
                self._note(rec, HOP_QUERY_SNAPSHOT, now, now, rows)
                self._fresh(LAG_PARTIAL, rec, now, anchor_start=True)

    def note_query(self, lo: int | None = None, hi: int | None = None) -> None:
        """A store scan touched [lo, hi): the first query over a
        flushed window closes its lineage with query.first. Only
        windows that already have store.insert and no query.first yet
        are candidates (the `_awaiting_query` set, so a dashboard-rate
        scan hook costs O(still-unqueried), not O(max_windows)) —
        repeated dashboards don't widen the span."""
        with self._lock:
            now = self.clock()
            for key in list(self._awaiting_query):
                rec = self._windows.get(key)
                if rec is None:
                    self._awaiting_query.discard(key)
                    continue
                iv, w = key
                w_lo, w_hi = w * iv, (w + 1) * iv
                if lo is not None and w_hi <= lo:
                    continue
                if hi is not None and w_lo >= hi:
                    continue
                self._note(rec, HOP_QUERY_FIRST, now, now)
                self._awaiting_query.discard(key)

    # -- export faces ------------------------------------------------------
    def trace_id_of(self, window_idx: int, interval: int | None = None) -> str:
        return window_trace_id(
            self.service, window_idx,
            self.interval if interval is None else interval,
        )

    def record_of(self, window_idx: int,
                  interval: int | None = None) -> WindowLineage | None:
        with self._lock:
            return self._windows.get(
                (self.interval if interval is None else int(interval),
                 int(window_idx))
            )

    def drain_spans(self) -> list[SpanRow]:
        """Every unexported hop of every CLOSED window touched since
        the last drain, as l7-shaped SpanRows. Export is deferred until
        a window has a TERMINAL_HOPS entry and each span id is emitted
        exactly ONCE (sticky per-hop exported flag): the l7 lane is
        append-only and the tree assemblers have no span-id dedup, so
        re-emitting a merged hop would double-count it in the tree's
        RED aggregates. Open windows stay in the dirty set and export
        at close. Walks only touched windows — an every-batch consumer
        stays O(changed), never O(max_windows)."""
        out: list[SpanRow] = []
        with self._lock:
            dirty, self._dirty = self._dirty, set()
            still_open: set[tuple[int, int]] = set()
            for key in sorted(dirty):
                rec = self._windows.get(key)
                if rec is None:
                    continue  # evicted since it was touched
                if not any(h in rec.hops for h in TERMINAL_HOPS):
                    still_open.add(key)  # export at close
                    continue
                iv, w = key
                tid = window_trace_id(self.service, w, iv)
                out.extend(
                    rec.span_rows(tid, only_unexported=True, mark=True)
                )
            self._dirty |= still_open
            self.counters["spans_exported"] += len(out)
        return out

    def export_otlp(self, exporter, *, table: str = "l7_flow_log") -> int:
        """Drain through an exporter's traces lane — the same
        `exporter.export(table, cols)` path the span tracer and every
        l7 row takes (OtlpExporter → OTel spans; pointing it at our own
        collector closes the dogfood loop, pinned by the round-trip
        test)."""
        rows = self.drain_spans()
        if not rows:
            return 0
        exporter.export(table, spanrows_to_l7_cols(rows))
        return len(rows)

    def export_store(self, store, *, org: int = 1, builder=None) -> int:
        """Drain straight into the store's `l7_flow_log` table (the
        in-process dogfood lane — no wire hop) and, optionally, into a
        TraceTreeBuilder so quiet traces assemble into trace_tree rows."""
        rows = self.drain_spans()
        if not rows:
            return 0
        write_l7_span_rows(store, rows, org=org)
        if builder is not None:
            builder.observe(rows, org=org)
        return len(rows)

    def assemble(self, window_idx: int, interval: int | None = None):
        """Live (pre-export) tree of one window — the REST fallback."""
        iv = self.interval if interval is None else int(interval)
        with self._lock:
            rec = self._windows.get((iv, int(window_idx)))
            if rec is None:
                return None
            rows = rec.span_rows(
                window_trace_id(self.service, window_idx, iv)
            )
            lags = dict(rec.lags)
        tree = assemble_trace(rows)
        if tree is None:
            return None
        out = tree.to_dict()
        out["freshness"] = {k: round(v * 1e3, 3) for k, v in lags.items()}
        return out


# ---------------------------------------------------------------------------
# l7 lane helpers


def spanrows_to_l7_cols(rows: list[SpanRow]) -> dict[str, np.ndarray]:
    """SpanRows → the minimal l7_flow_log-shaped column dict the
    exporter traces lane consumes (utils/spans.export_otlp's shape,
    with REAL trace/parent ids)."""
    n = len(rows)
    return {
        "time": np.asarray([r.start_us // 1_000_000 for r in rows], np.uint32),
        "start_time": np.asarray(
            [r.start_us // 1_000_000 for r in rows], np.uint32
        ),
        "response_duration": np.asarray(
            [min(r.response_duration_us, 0xFFFFFFFF) for r in rows], np.uint32
        ),
        "app_service": np.asarray([r.app_service for r in rows]),
        "endpoint": np.asarray([r.endpoint for r in rows]),
        "trace_id": np.asarray([r.trace_id for r in rows]),
        "span_id": np.asarray([r.span_id for r in rows]),
        "parent_span_id": np.asarray([r.parent_span_id for r in rows]),
    }


def write_l7_span_rows(store, rows: list[SpanRow], *, org: int = 1) -> None:
    """Write lineage spans as real `flow_log.l7_flow_log` rows (the
    columnar-store-native lane `tracing.query.query_trace` reads), via
    the same LogSchema the OTel import path uses."""
    from ..datamodel.code import SignalSource
    from ..flowlog.aggr import FlowLogBatch
    from ..flowlog.schema import L7_FLOW_LOG
    from ..flowlog.server import log_batch_to_columns, log_table_schema
    from ..storage.store import org_db

    s = L7_FLOW_LOG
    n = len(rows)
    ints = np.zeros((n, len(s.ints)), np.uint32)
    nums = np.zeros((n, len(s.nums)), np.float32)
    strs = {f.name: [""] * n for f in s.strs}
    ii = s.int_index
    for r, sp in enumerate(rows):
        ints[r, ii("signal_source")] = int(SignalSource.OTEL)
        ints[r, ii("type")] = 2
        ints[r, ii("tap_side")] = 50  # s-app: our own process observed
        ints[r, ii("start_time")] = sp.start_us // 1_000_000
        ints[r, ii("end_time")] = sp.end_us // 1_000_000
        ints[r, ii("response_duration")] = min(
            sp.response_duration_us, 0xFFFFFFFF
        )
        ints[r, ii("status")] = 1
        strs["app_service"][r] = sp.app_service
        strs["endpoint"][r] = sp.endpoint
        strs["trace_id"][r] = sp.trace_id
        strs["span_id"][r] = sp.span_id
        strs["parent_span_id"][r] = sp.parent_span_id
    batch = FlowLogBatch(s, ints, nums, np.ones(n, bool), strs)
    db = org_db("flow_log", org)
    schema = log_table_schema(s)
    store.create_table(db, schema)
    store.insert(db, schema.name, log_batch_to_columns(batch))


def connect_store_reads(store, tracker: LineageTracker, db: str, table: str):
    """Register a scan hook: the first SQL/PromQL read touching a
    flushed window's (db, table) closes the lineage with query.first.
    Returns the hook (pass to `store.remove_scan_hook` to detach)."""

    def hook(sdb: str, stable: str, time_range):
        if sdb != db or stable != table:
            return
        lo, hi = (None, None) if time_range is None else time_range
        tracker.note_query(lo, hi)

    store.add_scan_hook(hook)
    return hook


def query_window_trace(
    store, window_idx: int, *, interval: int = 1,
    service: str = DEFAULT_SERVICE, org: int = 1,
) -> dict | None:
    """`GET /v1/trace/window/<id>` / `dfctl trace window <id>`: the
    assembled lineage tree of one window — from the store (exported
    spans / trace_tree rows) when present, else live from a registered
    tracker. The trace id is derived, never looked up."""
    from .query import query_trace

    tid = window_trace_id(service, window_idx, interval)
    out = None
    if store is not None:
        out = query_trace(store, tid, org=org)
    tracker = next(
        (
            t for t in all_trackers()
            if t.service == service
            and t.record_of(window_idx, interval) is not None
        ),
        None,
    )
    if out is None and tracker is not None:
        out = tracker.assemble(window_idx, interval)
    if out is not None:
        out.setdefault("trace_id", tid)
        out["window"] = int(window_idx)
        out["interval"] = int(interval)
        if "freshness" not in out and tracker is not None:
            rec = tracker.record_of(window_idx, interval)
            if rec is not None:
                out["freshness"] = {
                    k: round(v * 1e3, 3) for k, v in rec.lags.items()
                }
    return out
