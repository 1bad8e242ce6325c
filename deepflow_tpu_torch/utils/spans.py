"""Host stage-span tracer for the pipeline's self-telemetry plane (port
of deepflow_tpu/utils/spans.py).

A monotonic-clock span recorder with a fixed vocabulary of stage names
(dispatching the append step, the counter-block fetch, the window
advance and its fold, the flush drain, checkpoint saves, the live read),
cheap enough to stay always-on: two perf_counter calls per span and no
device synchronisation, so a span of an asynchronous CUDA step measures
its host cost, as the reference's does for a jit dispatch. Faces:

  * `summary()` — per-stage count/total/max/last aggregates with the
    log-histogram p50/p95/p99, for bench JSON and `telemetry()`;
  * `get_counters()` — a flat Countable field map, so the tracer
    registers on `utils/stats.StatsCollector` like any component and
    its aggregates dogfood into the `deepflow_system` table;
  * `quantiles()`, `hist_dump()` and `tdigest()` — per-stage latency
    distributions (the t-digest through ops/tdigest.tdigest_from_loghist
    on a small host tensor);
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


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    start_s: float  # wall-clock epoch seconds (for export timestamps)
    duration_us: int  # monotonic-clock measured


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
    __slots__ = ("count", "total_us", "max_us", "last_us", "hist")

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

    def add(self, dur_us: int, bin_idx: int) -> None:
        self.count += 1
        self.total_us += dur_us
        self.last_us = dur_us
        if dur_us > self.max_us:
            self.max_us = dur_us
        self.hist[bin_idx] += 1


class SpanTracer:
    """Monotonic-clock stage spans: aggregates + per-stage log-histograms
    always, ring for export."""

    def __init__(self, service: str = "deepflow_tpu.pipeline", ring_size: int = 2048,
                 hist_spec: SpanHistSpec = SpanHistSpec()):
        self.service = service
        self.hist_spec = hist_spec
        self._ring: deque[SpanRecord] = deque(maxlen=ring_size)
        self._agg: dict[str, _Agg] = {}
        self._lock = threading.Lock()
        self._seq = 0

    @contextmanager
    def span(self, name: str):
        wall = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, int((time.perf_counter() - t0) * 1e6), start_s=wall)

    def record(self, name: str, duration_us: int, start_s: float | None = None):
        """Record a pre-measured span — for stages whose work is split
        across non-contiguous host sections (e.g. the sharded advance:
        sketch close before the append, fold after) that must count as
        ONE logical span so cross-path stage attribution compares."""
        rec = SpanRecord(name, time.time() if start_s is None else start_s,
                         int(duration_us))
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
            agg.add(rec.duration_us, bin_idx)

    # -- read faces -----------------------------------------------------
    def summary(self) -> dict[str, dict]:
        """Per-stage aggregates, JSON-able (the bench snapshot shape) —
        now with the log-histogram quantiles, so BENCH files
        carry p50/p95/p99 stage attribution next to count/avg/max."""
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

    def tdigest(self, name: str, compression: int = 64):
        """(means, weights) float32 numpy centroids of one stage's latency
        histogram — the loghist → t-digest compression the sketch blocks
        use (ops/tdigest.tdigest_from_loghist), on a small host tensor.
        None when the stage never ran."""
        with self._lock:
            a = self._agg.get(name)
            hist = None if a is None else a.hist.copy()
        if hist is None:
            return None
        import torch

        from ..ops.histogram import LogHistSpec
        from ..ops.tdigest import tdigest_from_loghist

        spec = LogHistSpec(bins=self.hist_spec.bins, vmin=self.hist_spec.vmin,
                           gamma=self.hist_spec.gamma)
        m, w = tdigest_from_loghist(torch.from_numpy(hist[None, :].astype(np.int32)), spec,
                                    compression=compression)
        return m[0].numpy(), w[0].numpy()

    def get_counters(self) -> dict[str, int | float]:
        """Countable face: flat `<stage>.count/.total_us/.max_us` fields
        plus the log-histogram p50/p95/p99 lanes — dogfooded
        via integration/dfstats into deepflow_system, where
        `ingest.dispatch.p99_us` becomes the
        `tpu_pipeline_spans_ingest_dispatch_p99_us` metric a span-latency
        alert rule keys on. Pure numpy, fetch-free, safe from a ticking
        collector thread."""
        with self._lock:
            aggs = [(name, a.count, a.total_us, a.max_us, a.hist.copy())
                    for name, a in sorted(self._agg.items())]
        out: dict[str, int | float] = {}
        for name, count, total_us, max_us, hist in aggs:
            out[f"{name}.count"] = count
            out[f"{name}.total_us"] = total_us
            out[f"{name}.max_us"] = max_us
            qv = loghist_quantiles_np(hist, self.hist_spec, SPAN_QUANTILES)
            for q, v in zip(SPAN_QUANTILES, qv):
                out[f"{name}.p{int(q * 100)}_us"] = round(float(v), 1)
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
            "endpoint": np.asarray([r.name for r in recs]),
            # every stage span is its own singleton trace
            "trace_id": np.asarray([f"{seq0 + i + 1:032x}" for i in range(n)]),
            "span_id": np.asarray([f"{seq0 + i + 1:016x}" for i in range(n)]),
            "parent_span_id": np.full(n, ""),
        }
        exporter.export(table, cols)
        return n
