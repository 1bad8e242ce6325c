"""Host stage-span tracer (port copy of deepflow_tpu/utils/spans.py, the
parts the feeder runtime uses).

A monotonic-clock span recorder, cheap enough to stay always-on (two
perf_counter calls per span), with per-stage count/total/max/last
aggregates and a log-binned latency histogram per stage: `summary()`
gives them as JSON-able dicts (with p50/p95/p99), `get_counters()` as a
flat Countable field map.

Not copied: `SpanTracer.tdigest()` (it runs the jitted
`tdigest_from_loghist`, which the port does not have), the ring of
recent span records with its OTLP export and fleet histogram dump (their
exporters are not ported), `JitCacheMonitor` (it reads the jit cache of
a JAX function) and the pipeline stage vocabulary, which stays with the
reference until the port's window managers emit spans.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from contextlib import contextmanager

import numpy as np

# Feeder-runtime stages, emitted by feeder/runtime.py on its own tracer.
SPAN_FEEDER_DRAIN = "feeder.drain"  # queue gets + frame decode
SPAN_FEEDER_COALESCE = "feeder.coalesce"  # bucket assembly + pad
SPAN_FEEDER_DISPATCH = "feeder.dispatch"  # staged batch → sink ingest

# Query-plane stage, emitted by querier/live.py's result cache.
SPAN_QUERY_CACHE = "query.cache"  # result-cache lookup (hit or miss)

# the quantiles each stage reports (<stage>.p50_us / .p95_us / .p99_us)
SPAN_QUANTILES = (0.5, 0.95, 0.99)


@dataclasses.dataclass(frozen=True)
class SpanHistSpec:
    """Log-binned per-stage latency histogram geometry: bin(v) =
    floor(log_gamma(v / vmin)), relative error ≤ (gamma-1)/(gamma+1).
    The default covers 1 µs .. ~640 s at ≤ 1% in 1024 i64 bins."""

    bins: int = 1024
    vmin: float = 1.0  # µs; durations at/below land in bin 0
    gamma: float = 1.02

    def bin(self, duration_us: float) -> int:
        v = max(float(duration_us), self.vmin)
        b = int(math.floor(math.log(v / self.vmin) / math.log(self.gamma)))
        return min(max(b, 0), self.bins - 1)

    def centers(self) -> np.ndarray:
        return self.vmin * np.power(float(self.gamma),
                                    np.arange(self.bins, dtype=np.float64) + 0.5)


def loghist_quantiles_np(hist: np.ndarray, spec: SpanHistSpec,
                         qs: tuple[float, ...]) -> np.ndarray:
    """Quantiles over one [bins] log-histogram (cumsum + rank threshold,
    bin centres); zeros for an empty histogram."""
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


class _Agg:
    __slots__ = ("count", "total_us", "max_us", "last_us", "hist")

    def __init__(self, bins: int):
        self.count = 0
        self.total_us = 0
        self.max_us = 0
        self.last_us = 0
        self.hist = np.zeros(bins, np.int64)

    def add(self, dur_us: int, bin_idx: int) -> None:
        self.count += 1
        self.total_us += dur_us
        self.last_us = dur_us
        if dur_us > self.max_us:
            self.max_us = dur_us
        self.hist[bin_idx] += 1


class SpanTracer:
    """Monotonic-clock stage spans: aggregates + per-stage log-histograms."""

    def __init__(self, service: str = "deepflow_tpu.pipeline",
                 hist_spec: SpanHistSpec = SpanHistSpec()):
        self.service = service
        self.hist_spec = hist_spec
        self._agg: dict[str, _Agg] = {}
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, int((time.perf_counter() - t0) * 1e6))

    def record(self, name: str, duration_us: int) -> None:
        """Record a pre-measured span."""
        duration_us = int(duration_us)
        bin_idx = self.hist_spec.bin(duration_us)
        # every aggregate mutation happens under the lock: record() runs
        # from the pump thread and readers concurrently, and an unlocked
        # += on the histogram would lose samples
        with self._lock:
            agg = self._agg.get(name)
            if agg is None:
                agg = self._agg[name] = _Agg(self.hist_spec.bins)
            agg.add(duration_us, bin_idx)

    def summary(self) -> dict[str, dict]:
        """Per-stage aggregates with the histogram quantiles, JSON-able."""
        with self._lock:
            out = {}
            for name, a in sorted(self._agg.items()):
                qv = loghist_quantiles_np(a.hist, self.hist_spec, SPAN_QUANTILES)
                out[name] = {
                    "count": a.count, "total_us": a.total_us,
                    "avg_us": round(a.total_us / a.count, 1) if a.count else 0.0,
                    "max_us": a.max_us, "last_us": a.last_us,
                    **{f"p{int(q * 100)}_us": round(float(v), 1)
                       for q, v in zip(SPAN_QUANTILES, qv)},
                }
            return out

    def get_counters(self) -> dict[str, int | float]:
        """Countable face: flat `<stage>.count/.total_us/.max_us` fields
        plus the p50/p95/p99 lanes. Host-only, fetch-free."""
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
