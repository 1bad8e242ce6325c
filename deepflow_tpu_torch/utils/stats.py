"""Self-telemetry counter registry — the universal Countable pattern.
Port copy of deepflow_tpu/utils/stats.py.

Every component in the reference registers a `RefCountable`/`Countable`
with a stats collector that periodically snapshots counters and ships them
as `deepflow_stats` points into its own ext_metrics pipeline
(server/libs/stats/stats.go:89-202; agent/src/utils/stats.rs). This module
is the framework-wide twin: components expose `get_counters()` dicts; the
collector holds *weak* references (a dropped component unregisters itself,
the RefCountable semantics), ticks on an interval, and hands batched
`StatsPoint`s to pluggable sinks — in-memory ring for the debug tap, and
the ext_metrics ingester once it exists.

Counter naming follows the reference convention: a point per (module,
tags) with an integer/float field map.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from collections import deque
from typing import Callable, Mapping, Protocol, runtime_checkable

_log = logging.getLogger(__name__)


@runtime_checkable
class Countable(Protocol):
    def get_counters(self) -> Mapping[str, int | float]: ...


@dataclasses.dataclass(frozen=True)
class StatsPoint:
    timestamp: float
    module: str
    tags: tuple[tuple[str, str], ...]
    fields: dict[str, int | float]


class CounterSource:
    """One registered countable: weakly held, tagged."""

    __slots__ = ("module", "tags", "_ref", "_fn", "failures", "cooldown",
                 "suppressed", "lock")

    def __init__(self, module: str, tags: dict[str, str], countable):
        self.module = module
        self.tags = tuple(sorted(tags.items()))
        self.failures = 0  # consecutive get_counters() exceptions
        self.cooldown = 0  # ticks to skip before the next re-probe
        self.suppressed = False  # entered backoff (warning already logged)
        # guards the failure/cooldown/suppressed bookkeeping: the tick
        # thread and pull-path sample() callers (live queries, the fleet
        # exporter) race on the same source, and unlocked check-then-act
        # would lose failure counts or double-count recoveries
        self.lock = threading.Lock()
        if callable(countable) and not isinstance(countable, Countable):
            # plain closures can't be weakly bound to a component lifetime;
            # hold them strongly (caller owns deregistration)
            self._ref = None
            self._fn = countable
        else:
            self._ref = weakref.ref(countable)
            self._fn = None

    def dead(self) -> bool:
        """Weakly-bound component already collected (callable sources
        are owner-deregistered, never dead)."""
        return self._ref is not None and self._ref() is None

    def sample(self) -> Mapping[str, int | float] | None:
        if self._fn is not None:
            return self._fn()
        obj = self._ref()
        if obj is None:
            return None
        return obj.get_counters()


class StatsCollector:
    """Periodic counter snapshotter with pluggable sinks.

    `register(module, countable, **tags)` — countable is either an object
    with `get_counters()` (weakly referenced; auto-deregistered when the
    component is garbage collected) or a zero-arg callable returning the
    counter map (strongly held; `deregister` to remove).
    """

    # consecutive sample failures before a source enters backoff
    # (warning logged once on entry)
    MAX_SOURCE_FAILURES = 3
    # re-probe backoff cap, in ticks: a broken source is probed at
    # 1, 2, 4, … up to this many ticks apart — never dropped for good
    # (a component that recovers, e.g. after a device comes
    # back, must resume reporting without a process restart)
    MAX_BACKOFF_TICKS = 64

    def __init__(self, interval_s: float = 10.0, ring_size: int = 4096):
        self.interval_s = interval_s
        self.n_source_errors = 0  # total get_counters() exceptions seen
        self.n_source_recoveries = 0  # sources that came back from backoff
        self.n_sink_errors = 0  # sink callback exceptions (contained)
        self._sources: list[CounterSource] = []
        self._sinks: list[Callable[[list[StatsPoint]], None]] = []
        self._ring: deque[StatsPoint] = deque(maxlen=ring_size)
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()

    # -- registry -------------------------------------------------------
    def register(self, module: str, countable, **tags: str) -> CounterSource:
        src = CounterSource(module, tags, countable)
        with self._lock:
            # prune dead weakrefs here too: components auto-register at
            # construction (pipelines, exporters), so a process that
            # never ticks must not grow the source list unboundedly
            self._sources = [s for s in self._sources if not s.dead()]
            self._sources.append(src)
        return src

    def deregister(self, src: CounterSource) -> None:
        with self._lock:
            if src in self._sources:
                self._sources.remove(src)

    def add_sink(self, sink: Callable[[list[StatsPoint]], None]) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[list[StatsPoint]], None]) -> None:
        """Detach a sink (a stopped server's ProfileSnapshot publisher
        must not keep firing events on a bus nobody drains)."""
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    # -- ticking --------------------------------------------------------
    def sample(
        self, now: float | None = None, *, _advance_backoff: bool = False
    ) -> list[StatsPoint]:
        """Snapshot every live source once WITHOUT sinking or ringing —
        the pull-time read the live query plane uses (
        integration/dfstats.live_system_source answers a query at
        sub-tick latency from the CURRENT counters; writing those rows
        through the sinks would turn every query into a store insert).
        Shares tick()'s failure accounting, but only tick() ADVANCES
        the backoff clock (`_advance_backoff`): a broken source's
        capped-exponential re-probe spacing is measured in collector
        ticks, and dashboard-rate pulls must neither drain it in
        seconds nor hammer the broken source on the query path — while
        backing off, pulls skip it without touching the cooldown."""
        now = time.time() if now is None else now
        points: list[StatsPoint] = []
        with self._lock:
            sources = list(self._sources)
        dead: list[CounterSource] = []
        for src in sources:
            if src.dead():
                dead.append(src)
                continue
            with src.lock:
                if src.cooldown > 0:  # backing off — skip this round
                    if _advance_backoff:
                        src.cooldown -= 1
                    continue
            try:
                fields = src.sample()
            except Exception:
                with self._lock:
                    self.n_source_errors += 1
                with src.lock:
                    src.failures += 1
                    failures = src.failures
                    entered_backoff = False
                    if failures >= self.MAX_SOURCE_FAILURES:
                        src.cooldown = min(
                            1 << (failures - self.MAX_SOURCE_FAILURES),
                            self.MAX_BACKOFF_TICKS,
                        )
                        if not src.suppressed:
                            src.suppressed = True
                            entered_backoff = True
                if entered_backoff:
                    _log.warning(
                        "stats source %s%s backing off after %d "
                        "consecutive sample errors (re-probed with "
                        "capped exponential spacing)",
                        src.module, dict(src.tags) or "", failures,
                        exc_info=True,
                    )
                continue
            with src.lock:
                recovered = src.suppressed
                failures = src.failures
                src.suppressed = False
                src.failures = 0
                src.cooldown = 0
            if recovered:  # came back from backoff
                with self._lock:
                    self.n_source_recoveries += 1
                _log.warning(
                    "stats source %s%s recovered after %d consecutive "
                    "sample errors", src.module, dict(src.tags) or "",
                    failures,
                )
            if fields is None:  # component died → auto-deregister
                dead.append(src)
                continue
            if fields:
                points.append(StatsPoint(now, src.module, src.tags, dict(fields)))
        with self._lock:
            if dead:
                self._sources = [s for s in self._sources if s not in dead]
        return points

    def tick(self, now: float | None = None) -> list[StatsPoint]:
        """`sample()` + sinks + ring (also called by the thread).

        Samples run outside the lock (a callback may register/deregister)
        and are exception-guarded — one broken component must not kill
        self-telemetry for the rest. Failures are COUNTED
        (`n_source_errors`); a source that fails MAX_SOURCE_FAILURES
        times in a row enters capped-exponential BACKOFF (one warning
        log) and keeps being re-probed at 1, 2, 4, …, MAX_BACKOFF_TICKS
        tick spacing instead of being dropped — a component whose
        dependency comes back (a reconnected store, a recovered device)
        resumes reporting, with the recovery counted and logged once
        (`n_source_recoveries`). Sink callbacks are guarded the same
        way (`n_sink_errors`): a broken export loop must not kill the
        collector thread.
        """
        points = self.sample(now, _advance_backoff=True)
        with self._lock:
            sinks = list(self._sinks)
            self._ring.extend(points)
        for sink in sinks:
            try:
                sink(points)
            except Exception:
                with self._lock:
                    self.n_sink_errors += 1
                _log.warning("stats sink %r failed; points dropped for "
                             "this tick", sink, exc_info=True)
        return points

    def recent(self, module: str | None = None) -> list[StatsPoint]:
        with self._lock:
            pts = list(self._ring)
        if module is not None:
            pts = [p for p in pts if p.module == module]
        return pts

    # -- thread ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=self.interval_s + 1)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()


# Default process-wide collector, mirroring the reference's package-level
# RegisterCountable entry points (stats.go:89).
default_collector = StatsCollector()


def register_countable(module: str, countable, **tags: str) -> CounterSource:
    return default_collector.register(module, countable, **tags)
