"""Host stage-span tracer for the pipeline's self-telemetry plane (port
of deepflow_tpu/utils/spans.py).

A monotonic-clock span recorder with a fixed vocabulary of stage names
(staging a batch, dispatching the append step and its sub-layers, the
counter-block fetch, the window advance and its fold, the flush drain
and its wait / copy / split, checkpoint saves, the live read), cheap
enough to stay always-on: two perf_counter calls per span and no device
synchronisation, so a span of an asynchronous CUDA step measures its
host cost, as the reference's does for a jit dispatch. Three additions
over the reference's tracer:

  * profiler ranges — while a torch.profiler session is active each
    span also opens a `record_function` range of its name, so the spans
    sit on the profiler's timeline beside the kernels they launch; with
    no profiler only the enabled flag is read;
  * a work count — `with tracer.span(name) as sp: ...; sp.bytes = n`
    adds `n` to the span's `bytes` total, and `sp.pinned = k` adds `k`
    to its `pinned` count (transfers that landed in page-locked host
    memory: the drain's row fetch on a CUDA device);
  * device time — `span(name, device=d)` with a CUDA device records a
    timing-event pair on the current stream around the span's launches
    (events from a small reused pool). `resolve_device()` reads the
    pairs with `Event.query()` and is called only where the program has
    already waited for the card (WindowManager: just after its
    `stats.fetch` and `flush.drain` spans close); it never synchronises
    and never fetches. A pair measures the stream's elapsed time from
    the layer's first launch to its last kernel's end, launch gaps
    included; a profiler trace gives the kernels alone.

Faces:

  * `summary()` — per-stage count/total/max/last aggregates with the
    log-histogram p50/p95/p99, plus `bytes` (spans that carried a work
    count) and `device_us` / `device_count` (resolved pairs only;
    absent on a CPU device) and `pinned` (spans that carried one), for
    bench JSON and `telemetry()`;
  * `get_counters()` — a flat Countable field map, so the tracer
    registers on `utils/stats.StatsCollector` like any component and
    its aggregates dogfood into the `deepflow_system` table;
  * `quantiles()` and `hist_dump()` — per-stage latency distributions;
  * `recent()` / `drain()` and `export_otlp(exporter)` — the ring of
    recent SpanRecords, drained through any exporter with an
    `export(table, cols)` method (the reference's OtlpExporter shape).

The reference's `JitCacheMonitor` (compile/retrace counters read from a
jitted function's cache) has no counterpart in eager PyTorch and is not
ported: the port reports no `jit_retraces` lane.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch
from torch.profiler import record_function

# The pipeline stage vocabulary (explicit names). Everything the window
# managers emit uses these; ad-hoc names are allowed but the docs/tests
# pin this set.
SPAN_INGEST_DISPATCH = "ingest.dispatch"  # append step dispatch (async — host-side cost)
SPAN_STATS_FETCH = "stats.fetch"  # the ONE per-batch device→host stats sync
SPAN_WINDOW_ADVANCE = "window.advance"  # fold + flush_range dispatch on window close
# fold dispatch alone (capacity-triggered AND the advance's span fold) —
# nested inside window.advance when the advance fires it, so the
# fold-dominated share of drain_ms is attributable on its own (this is
# the lane the merge fold exists to shrink)
SPAN_WINDOW_FOLD = "window.fold"
SPAN_FLUSH_DRAIN = "flush.drain"  # packed flush fetch + per-window split
SPAN_CHECKPOINT_SAVE = "checkpoint.save"  # window-state snapshot to .npz
# live read plane: pull-only open-window snapshot reads and
# result-cache lookups — separate names so a live dashboard's read
# latency is attributable on its own instead of hiding in flush.drain
SPAN_QUERY_SNAPSHOT = "query.snapshot"  # snapshot_open: fold + 2-fetch read
SPAN_QUERY_CACHE = "query.cache"  # result-cache lookup (hit or miss)

# Feeder-runtime stages — emitted by feeder/runtime.py on its
# own tracer; NOT in PIPELINE_SPAN_NAMES (a pipeline can run feederless,
# and the pinned vocabulary must stay satisfiable by a bare pipeline).
SPAN_FEEDER_DRAIN = "feeder.drain"  # queue gets + frame decode
SPAN_FEEDER_COALESCE = "feeder.coalesce"  # bucket assembly + pad
SPAN_FEEDER_DISPATCH = "feeder.dispatch"  # staged batch → sink ingest

# Push query plane — emitted by querier/subscribe.py and
# querier/alerts.py on their own tracers; also not pipeline vocabulary
# (a pipeline can run with no standing queries). One span per
# subscription/rule evaluation, so fan-out latency (flush → watcher
# delivery) is attributable separately from the pull path's
# query.snapshot/query.cache lanes.
SPAN_SUBSCRIPTION_EVAL = "subscribe.eval"  # one shared eval serving N watchers
SPAN_ALERT_EVAL = "alert.eval"  # rule query + state-machine step

PIPELINE_SPAN_NAMES = (
    SPAN_INGEST_DISPATCH,
    SPAN_STATS_FETCH,
    SPAN_WINDOW_ADVANCE,
    SPAN_WINDOW_FOLD,
    SPAN_FLUSH_DRAIN,
    SPAN_CHECKPOINT_SAVE,
    SPAN_QUERY_SNAPSHOT,
    SPAN_QUERY_CACHE,
)

# The rollup's layers inside those stages. `RollupPipeline.stage()` is
# stage.pack then stage.upload; RollupPipeline._step runs step.prereduce
# (with batch_unique_cap), step.sketch (with the sketch plane) and
# step.fanout inside ingest.dispatch; WindowManager._drain_flush runs
# flush.wait, flush.copy (when rows ride) and flush.split inside
# flush.drain. Not in PIPELINE_SPAN_NAMES: a bare WindowManager.ingest
# emits no stage.* and no step.*.
SPAN_STAGE_PACK = "stage.pack"  # pad, valid check, stack of the tag lanes (host)
SPAN_STAGE_UPLOAD = "stage.upload"  # the host→device copies; bytes = bytes uploaded
SPAN_STEP_PREREDUCE = "step.prereduce"  # batch_prereduce (device time)
SPAN_STEP_SKETCH = "step.sketch"  # sketch_flow_rows (device time)
# fanout → doc fingerprint → counter block → ring append (device time)
SPAN_STEP_FANOUT = "step.fanout"
SPAN_FLUSH_WAIT = "flush.wait"  # the scalar fetch: waits for the queued fold + flush
SPAN_FLUSH_COPY = "flush.copy"  # the packed row fetch; bytes = bytes fetched
SPAN_FLUSH_SPLIT = "flush.split"  # host split into windows, blocks, tier hand-off

ROLLUP_SPAN_NAMES = (
    SPAN_STAGE_PACK,
    SPAN_STAGE_UPLOAD,
    SPAN_STEP_PREREDUCE,
    SPAN_STEP_SKETCH,
    SPAN_STEP_FANOUT,
    SPAN_FLUSH_WAIT,
    SPAN_FLUSH_COPY,
    SPAN_FLUSH_SPLIT,
)

# The sharded rollup's layers (parallel/sharded.py ShardedL4Pipeline and
# the ShardedWindowManager under it). `stage()` is stage.pack, then one
# shard.upload a card (bytes = that card's upload); inside
# ingest.dispatch one shard.step a card, with that card's device time;
# shard.merge is the cross-card sketch merge (window_close, card 0's
# device time, and the host merge of the cards' closed blocks);
# shard.gather the copy of the other cards' flush rows onto the first
# card before the drain's row fetch (bytes = bytes copied, card 0's
# device time: the peer copies do not hold the host).
SPAN_SHARD_UPLOAD = "shard.upload"
SPAN_SHARD_STEP = "shard.step"
SPAN_SHARD_MERGE = "shard.merge"
SPAN_SHARD_GATHER = "shard.gather"

SHARD_SPAN_NAMES = (
    SPAN_SHARD_UPLOAD,
    SPAN_SHARD_STEP,
    SPAN_SHARD_MERGE,
    SPAN_SHARD_GATHER,
)

#: at most this many event pairs wait for resolve_device(); older ones
#: are dropped unread (a tracer nobody resolves stays bounded)
MAX_PENDING_PAIRS = 256


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    start_s: float  # wall-clock epoch seconds (for export timestamps)
    duration_us: int  # monotonic-clock measured
    # window-lineage context: when a stage span belongs to a window's
    # lineage trace, these carry the DERIVED ids
    # (tracing/lineage.window_trace_id — the window id IS the context)
    # and export_otlp emits them instead of synthesizing singleton ids;
    # `window` is the per-window correlation key ("<idx>@<interval>s").
    trace_id: str = ""
    span_id: str = ""
    parent_span_id: str = ""
    window: str = ""


@dataclasses.dataclass(frozen=True)
class SpanHistSpec:
    """Log-binned per-stage latency histogram geometry — the numpy twin
    of ops/histogram.LogHistSpec (same bin(v) = floor(log_gamma(v /
    vmin)) algebra, same (gamma-1)/(gamma+1) relative-error bound), kept
    tensor-free so the tracer stays cheap for host-only components
    (agent, querier threads). The default
    covers 1 µs .. ~640 s at ≤1% relative error in 1024 i64 bins
    (8 KB per stage)."""

    bins: int = 1024
    vmin: float = 1.0  # µs; durations at/below land in bin 0
    gamma: float = 1.02

    def bin(self, duration_us: float) -> int:
        import math

        v = max(float(duration_us), self.vmin)
        b = int(math.floor(math.log(v / self.vmin) / math.log(self.gamma)))
        return min(max(b, 0), self.bins - 1)

    def centers(self) -> np.ndarray:
        return self.vmin * np.power(
            float(self.gamma), np.arange(self.bins, dtype=np.float64) + 0.5
        )


def loghist_quantiles_np(
    hist: np.ndarray, spec: SpanHistSpec, qs: tuple[float, ...]
) -> np.ndarray:
    """Pure-numpy quantiles over one [bins] log-histogram — the same
    cumsum + rank-threshold walk as ops/histogram.loghist_quantiles,
    evaluated host-side so the Countable face never dispatches to a
    device. Returns zeros for an empty histogram (no fake series)."""
    cum = np.cumsum(hist.astype(np.float64))
    total = cum[-1]
    if total <= 0:
        return np.zeros(len(qs))
    centers = spec.centers()
    out = np.empty(len(qs))
    for i, q in enumerate(qs):
        idx = int(np.searchsorted(cum, q * total, side="left"))
        out[i] = centers[min(idx, spec.bins - 1)]
    return out


#: the quantiles the Countable face exports per stage (deepflow_system
#: metric names: <module>_<stage>_p50_us / _p95_us / _p99_us — the lanes
#: span-latency alert rules key on)
SPAN_QUANTILES = (0.5, 0.95, 0.99)


class _Agg:
    __slots__ = ("count", "total_us", "max_us", "last_us", "hist", "bytes", "pinned",
                 "device_us", "device_count")

    def __init__(self, bins: int):
        self.count = 0
        self.total_us = 0
        self.max_us = 0
        self.last_us = 0
        # per-stage log-histogram: updated together with the
        # scalar aggregates — callers hold the tracer lock, so the
        # read-modify-write on the bin counter cannot lose updates under
        # concurrent feeder-pump + query threads
        self.hist = np.zeros(bins, np.int64)
        self.bytes: int | None = None  # None until a span carries a work count
        self.pinned: int | None = None  # None until a span reports a page-locked landing
        self.device_us = 0.0  # over resolved event pairs only
        self.device_count = 0

    def add(self, dur_us: int, bin_idx: int, nbytes: int | None = None,
            pinned: int | None = None) -> None:
        self.count += 1
        self.total_us += dur_us
        self.last_us = dur_us
        if dur_us > self.max_us:
            self.max_us = dur_us
        self.hist[bin_idx] += 1
        if nbytes is not None:
            self.bytes = (self.bytes or 0) + int(nbytes)
        if pinned is not None:
            self.pinned = (self.pinned or 0) + int(pinned)

    def extra(self) -> dict:
        """The work count and the device time, each only where measured
        (a CPU span has no device time: no zero stands in for it)."""
        out = {}
        if self.bytes is not None:
            out["bytes"] = self.bytes
        if self.pinned is not None:
            out["pinned"] = self.pinned
        if self.device_count:
            out["device_us"] = round(self.device_us, 1)
            out["device_count"] = self.device_count
        return out


class SpanWork:
    """What a span's body reports: `bytes` moved and `pinned` transfers
    landed in page-locked memory (None: not reported)."""

    __slots__ = ("bytes", "pinned")

    def __init__(self):
        self.bytes: int | None = None
        self.pinned: int | None = None


class SpanTracer:
    """Monotonic-clock stage spans: aggregates + per-stage log-histograms
    always, ring for export; profiler ranges while a profiler runs and
    device-time event pairs for spans given a CUDA device."""

    def __init__(self, service: str = "deepflow_tpu.pipeline", ring_size: int = 2048,
                 hist_spec: SpanHistSpec = SpanHistSpec()):
        self.service = service
        self.hist_spec = hist_spec
        self._ring: deque[SpanRecord] = deque(maxlen=ring_size)
        self._agg: dict[str, _Agg] = {}
        self._lock = threading.Lock()
        self._seq = 0
        # (name, device, start event, end event) awaiting resolve_device(),
        # in record order; finished events return to a per-device pool
        self._pending: deque = deque(maxlen=MAX_PENDING_PAIRS)
        self._free_events: dict[torch.device, list] = {}

    @contextmanager
    def span(self, name: str, device: torch.device | None = None):
        """Time the body on the host clock; yields a SpanWork whose
        `bytes` the body may set. With a CUDA `device`, an event pair on
        its current stream brackets the body's launches."""
        rng = None
        if torch.autograd._profiler_enabled():
            rng = record_function(name)
            rng.__enter__()
        start = self._event(device) if device is not None and device.type == "cuda" else None
        work = SpanWork()
        wall = time.time()
        t0 = time.perf_counter()
        try:
            yield work
        finally:
            dur_us = int((time.perf_counter() - t0) * 1e6)
            end = self._event(device) if start is not None else None
            self.record(name, dur_us, start_s=wall, nbytes=work.bytes, pinned=work.pinned)
            if end is not None:
                with self._lock:
                    self._pending.append((name, device, start, end))
            if rng is not None:
                rng.__exit__(None, None, None)

    def _event(self, device: torch.device):
        """A timing event from the pool, recorded on `device`'s current
        stream (no synchronisation)."""
        with self._lock:
            free = self._free_events.get(device)
            ev = free.pop() if free else None
        if ev is None:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def resolve_device(self) -> int:
        """Add every finished event pair to its span's device time, in
        record order, stopping at the first pair the stream has not
        reached (`Event.query()`: never a synchronise). Call it where the
        program has already waited for the card. Returns the pairs read."""
        n = 0
        with self._lock:
            while self._pending:
                name, device, start, end = self._pending[0]
                if not (end.query() and start.query()):
                    break
                self._pending.popleft()
                agg = self._agg[name]
                agg.device_us += 1e3 * start.elapsed_time(end)
                agg.device_count += 1
                self._free_events.setdefault(device, []).extend((start, end))
                n += 1
        return n

    def record(self, name: str, duration_us: int, start_s: float | None = None,
               *, trace_id: str = "", span_id: str = "",
               parent_span_id: str = "", window: str = "", nbytes: int | None = None,
               pinned: int | None = None):
        """Record a pre-measured span — for stages whose work is split
        across non-contiguous host sections (e.g. the sharded advance:
        sketch close before the append, fold after) that must count as
        ONE logical span so cross-path stage attribution compares.
        Optional trace/parent ids + the per-window correlation key ride
        into the export ring (lineage-context stage spans); `nbytes`
        adds to the span's work count, `pinned` to its page-locked
        landings."""
        rec = SpanRecord(name, time.time() if start_s is None else start_s,
                         int(duration_us), trace_id=trace_id, span_id=span_id,
                         parent_span_id=parent_span_id, window=window)
        # the bin is computed outside the lock (pure math), but EVERY
        # aggregate mutation — scalar lanes and the histogram counter —
        # happens under the tracer lock: record() runs concurrently from
        # feeder-pump and query threads, and an unlocked += on the
        # histogram would silently lose samples (
        # pinned by the threaded tracer stress test).
        bin_idx = self.hist_spec.bin(rec.duration_us)
        with self._lock:
            self._ring.append(rec)
            agg = self._agg.get(name)
            if agg is None:
                agg = self._agg[name] = _Agg(self.hist_spec.bins)
            agg.add(rec.duration_us, bin_idx, nbytes, pinned)

    # -- read faces -----------------------------------------------------
    def summary(self) -> dict[str, dict]:
        """Per-stage aggregates, JSON-able (the bench snapshot shape) —
        now with the log-histogram quantiles, so BENCH files
        carry p50/p95/p99 stage attribution next to count/avg/max, and
        `bytes` / `pinned` / `device_us` / `device_count` where measured."""
        with self._lock:
            out = {}
            for name, a in sorted(self._agg.items()):
                qv = loghist_quantiles_np(a.hist, self.hist_spec, SPAN_QUANTILES)
                out[name] = {
                    "count": a.count,
                    "total_us": a.total_us,
                    "avg_us": round(a.total_us / a.count, 1) if a.count else 0.0,
                    "max_us": a.max_us,
                    "last_us": a.last_us,
                    **{
                        f"p{int(q * 100)}_us": round(float(v), 1)
                        for q, v in zip(SPAN_QUANTILES, qv)
                    },
                    **a.extra(),
                }
            return out

    def hist_dump(self) -> dict[str, list[list[int]]]:
        """stage → nonzero (bin, count) pairs — the same compact shape
        `FreshnessTracker.hist_dump` emits, so span latency histograms
        ride the fleet frame and merge bin-for-bin across hosts
        (histograms add; quantile summaries don't)."""
        with self._lock:
            return {
                name: [
                    [int(b), int(a.hist[b])]
                    for b in np.nonzero(a.hist)[0]
                ]
                for name, a in sorted(self._agg.items())
            }

    def quantiles(
        self, name: str, qs: tuple[float, ...] = SPAN_QUANTILES
    ) -> np.ndarray | None:
        """Per-stage latency quantiles (µs) from the log-histogram —
        pure numpy, no device access. None when the stage never ran."""
        with self._lock:
            a = self._agg.get(name)
            hist = None if a is None else a.hist.copy()
        if hist is None:
            return None
        return loghist_quantiles_np(hist, self.hist_spec, qs)

    def get_counters(self) -> dict[str, int | float]:
        """Countable face: flat `<stage>.count/.total_us/.max_us` fields
        plus the log-histogram p50/p95/p99 lanes, and
        `<stage>.bytes/.pinned/.device_us/.device_count` where measured —
        dogfooded via integration/dfstats into deepflow_system, where
        `ingest.dispatch.p99_us` becomes the
        `tpu_pipeline_spans_ingest_dispatch_p99_us` metric a span-latency
        alert rule keys on. Pure numpy, fetch-free, safe from a ticking
        collector thread."""
        with self._lock:
            aggs = [(name, a.count, a.total_us, a.max_us, a.hist.copy(), a.extra())
                    for name, a in sorted(self._agg.items())]
        out: dict[str, int | float] = {}
        for name, count, total_us, max_us, hist, extra in aggs:
            out[f"{name}.count"] = count
            out[f"{name}.total_us"] = total_us
            out[f"{name}.max_us"] = max_us
            qv = loghist_quantiles_np(hist, self.hist_spec, SPAN_QUANTILES)
            for q, v in zip(SPAN_QUANTILES, qv):
                out[f"{name}.p{int(q * 100)}_us"] = round(float(v), 1)
            for k, v in extra.items():
                out[f"{name}.{k}"] = v
        return out

    def recent(self, name: str | None = None) -> list[SpanRecord]:
        with self._lock:
            recs = list(self._ring)
        if name is not None:
            recs = [r for r in recs if r.name == name]
        return recs

    def drain(self) -> list[SpanRecord]:
        """Pop and return the ring (export-once semantics)."""
        with self._lock:
            recs = list(self._ring)
            self._ring.clear()
        return recs

    # -- OTLP export ------------------------------------------------------
    def export_otlp(self, exporter, *, table: str = "l7_flow_log") -> int:
        """Drain the span ring through an exporter's traces lane.

        Builds l7_flow_log-shaped columns (app_service/endpoint/
        start_time/response_duration + trace ids) and hands them to
        `exporter.export(table, cols)` — the same path every other
        trace row takes (an OTLP exporter turns each row into an OTel
        span). Returns the span count exported."""
        recs = self.drain()
        if not recs:
            return 0
        with self._lock:
            seq0 = self._seq
            self._seq += len(recs)
        n = len(recs)
        cols = {
            "time": np.asarray([int(r.start_s) for r in recs], np.uint32),
            "start_time": np.asarray([int(r.start_s) for r in recs], np.uint32),
            "response_duration": np.asarray(
                [r.duration_us for r in recs], np.uint32
            ),
            "app_service": np.asarray([self.service] * n),
            # the window correlation key (when set) suffixes the
            # endpoint so per-window stage spans stay distinguishable
            # in the trace backend
            "endpoint": np.asarray(
                [f"{r.name}:{r.window}" if r.window else r.name for r in recs]
            ),
            # records carrying lineage context keep their DERIVED ids;
            # plain stage spans synthesize singleton ids
            "trace_id": np.asarray(
                [r.trace_id or f"{seq0 + i + 1:032x}" for i, r in enumerate(recs)]
            ),
            "span_id": np.asarray(
                [r.span_id or f"{seq0 + i + 1:016x}" for i, r in enumerate(recs)]
            ),
            "parent_span_id": np.asarray([r.parent_span_id for r in recs]),
        }
        exporter.export(table, cols)
        return n
