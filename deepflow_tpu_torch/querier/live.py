"""Live query plane — open-window overlay + result cache.
Port copy of deepflow_tpu/querier/live.py.

The querier (SQL + PromQL) historically read only FLUSHED stores: every
open window was invisible until it closed, so the freshest `delay`
seconds of telemetry — exactly what a live dashboard wants — were a
blind spot. This module closes it with two host-side pieces:

  * **LiveRegistry** — (db, table) → live-row providers. A provider is
    a callable `(lo, hi) → columns dict | None` returning table-shaped
    rows for the open span (typically backed by
    `RollupPipeline.snapshot_open()` / `ShardedWindowManager
    .snapshot_open()` through the adapters in integration/dfstats.py,
    or by a pull of StatsCollector counters). Both query engines
    consult the registry when a query's time range touches the open
    span and merge the partial rows in, marked `partial=True` in
    results — flushed rows always SUPERSEDE a window's partials, so
    once a window closes the same query returns the identical values
    unmarked (the consistency pin in tests/test_live_read.py).
    Optional provider faces: `.epoch()` — a monotonically increasing
    int identifying the snapshot generation backing the rows (the
    result cache's live token; pipeline adapters return the
    OpenSnapshot seq, so the cache stays hot between rate-limited
    snapshots) — and `.open_from()` — the first open second (None =
    nothing open), used by datasource tier selection to keep
    live-covered tiers preferred for range queries ending "now".

  * **QueryResultCache** — the repeated-dashboard path: an LRU map
    keyed on (engine, query, db, table, time args), validated per
    lookup against a token of (store write epoch, live epoch). A
    window close inserts flushed rows → the store epoch moves → the
    stale entry is dropped (counted as an invalidation) and recomputed;
    between mutations and snapshots, the same dashboard query is a
    dict lookup. Bounded (LRU, configurable entries) so a dashboard
    storm of distinct queries cannot grow host memory without bound;
    hit/miss/invalidation/eviction counters expose as a Countable —
    queryable through the same SQL/PromQL engines it accelerates.

Both pieces are PULL-only and entirely off the ingest path: nothing
here runs unless a query does, and the device reads behind the
providers are rate-limited at the snapshot layer
(`WindowConfig.min_snapshot_interval`).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np

from ..utils.spans import SPAN_QUERY_CACHE, SpanTracer
from ..utils.stats import register_countable


class LiveRegistry:
    """(db, table) → live-row providers for the open-window overlay."""

    def __init__(self):
        self._providers: dict[tuple[str, str], list] = {}
        self._lock = threading.Lock()
        self._reg_seq = 0  # registration churn feeds the epoch too

    def register(self, db: str, table: str, provider) -> tuple:
        """Add a provider; returns a handle for `unregister`."""
        key = (db, table)
        with self._lock:
            self._providers.setdefault(key, []).append(provider)
            self._reg_seq += 1
        return (key, provider)

    def unregister(self, handle: tuple) -> None:
        key, provider = handle
        with self._lock:
            lst = self._providers.get(key, [])
            if provider in lst:
                lst.remove(provider)
                self._reg_seq += 1
            if not lst:
                self._providers.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._providers.clear()
            self._reg_seq += 1

    def has(self, db: str, table: str) -> bool:
        with self._lock:
            return bool(self._providers.get((db, table)))

    def live_tables(self, db: str) -> set[str]:
        with self._lock:
            return {t for (d, t), ps in self._providers.items() if d == db and ps}

    def epoch(self, db: str, table: str) -> int:
        """Live-data generation token for (db, table): changes whenever
        a provider's snapshot generation moves or the provider set
        does. NOTE: a pipeline-backed provider's epoch() may take the
        (rate-limited) snapshot itself, so the token identifies the
        exact generation the subsequent evaluation will read."""
        with self._lock:
            providers = list(self._providers.get((db, table), ()))
            seq = self._reg_seq
        tok = seq
        for p in providers:
            ep = getattr(p, "epoch", None)
            if ep is not None:
                tok = tok * 1_000_003 + int(ep())
        return tok

    def open_from(self, db: str, table: str) -> int | None:
        """Earliest open second any provider serves (None = nothing
        open / no provider exposes it)."""
        with self._lock:
            providers = list(self._providers.get((db, table), ()))
        vals = []
        for p in providers:
            of = getattr(p, "open_from", None)
            if of is not None:
                v = of()
                if v is not None:
                    vals.append(int(v))
        return min(vals) if vals else None

    def columns(self, db: str, table: str, lo: int, hi: int):
        """Merged live rows for [lo, hi): one columns dict (or None).
        Provider failures are contained — a broken live source must
        degrade the query to flushed-only, never break it."""
        with self._lock:
            providers = list(self._providers.get((db, table), ()))
        parts = []
        for p in providers:
            try:
                cols = p(lo, hi)
            except Exception:
                continue
            if cols is not None and len(next(iter(cols.values()), ())):
                parts.append(cols)
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        # only columns EVERY provider serves concatenate — a provider
        # missing one must degrade that column's overlay, not raise
        keys = set(parts[0])
        for p in parts[1:]:
            keys &= set(p)
        return {k: np.concatenate([p[k] for p in parts]) for k in sorted(keys)}


#: process-wide default, mirroring utils.stats.default_collector — the
#: engines fall back to it when no registry is passed explicitly, so an
#: empty registry keeps today's flushed-only behavior bit-for-bit.
default_live_registry = LiveRegistry()


class QueryResultCache:
    """LRU result cache keyed on (query, db, table, window args).

    `lookup(key, token)` → cached value or None; `store(key, token,
    value)` inserts. A token mismatch on lookup drops the stale entry
    (counted: `invalidations` — the window-close path) and reports a
    miss; insertion beyond `max_entries` evicts the least recently
    used (counted: `evictions`). Thread-safe; the cached value is
    returned by reference — treat results as immutable.

    Push mode: `attach_bus(bus)` subscribes the cache to a
    `events.QueryEventBus` — any WindowClosed / TierClosed /
    SnapshotAdvanced / StoreMutation event drops the named (db, table)'s
    entries EAGERLY at event time instead of waiting for the next
    lookup's token compare. The two paths count into separate lanes —
    `push_invalidations` (event-driven) vs `stale_invalidations` (the
    lazy per-lookup backstop) — with `invalidations` kept as their sum,
    so the push plane's coverage is observable: in a fully event-wired
    process the stale lane sits at ~0 and every non-zero tick of it
    names a mutation path that bypassed the bus. The token compare
    itself is never retired — it is the correctness backstop that keeps
    stale-row-never-served pinned bit-exact whether or not events flow."""

    def __init__(self, max_entries: int = 256, *, tracer: SpanTracer | None = None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self.tracer = tracer if tracer is not None else SpanTracer(
            service="deepflow_tpu.querier"
        )
        self._map: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self._buses: list = []  # attached event buses (handles kept alive)
        self._rewarm = None
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.push_invalidations = 0
        self.stale_invalidations = 0
        self.rewarmed = 0
        self.evictions = 0

    def lookup(self, key, token):
        with self.tracer.span(SPAN_QUERY_CACHE):
            with self._lock:
                entry = self._map.get(key)
                if entry is not None:
                    e_token, value = entry
                    if e_token == token:
                        self._map.move_to_end(key)
                        self.hits += 1
                        return value
                    # stale — a window closed (store epoch moved) or a
                    # newer snapshot landed (live epoch moved) and no
                    # push event beat this lookup to the entry: the
                    # lazy-epoch backstop lane
                    del self._map[key]
                    self.invalidations += 1
                    self.stale_invalidations += 1
                self.misses += 1
                return None

    def store(self, key, token, value) -> None:
        with self._lock:
            self._map[key] = (token, value)
            self._map.move_to_end(key)
            while len(self._map) > self.max_entries:
                self._map.popitem(last=False)
                self.evictions += 1

    def invalidate(
        self, db: str | None = None, table: str | None = None,
        *, push: bool = False,
    ) -> int:
        """Drop entries whose key names (db, table) — every key the
        engines build carries them at fixed positions 2/3; None drops
        everything. Returns the number invalidated. `push=True` counts
        into the event-driven lane (attach_bus uses it); the default
        counts the manual/lazy lane."""
        with self._lock:
            if db is None and table is None:
                drop = list(self._map)
                self._map.clear()
            else:
                drop = [
                    k for k in self._map
                    if (db is None or (len(k) > 2 and k[2] == db))
                    and (table is None or (len(k) > 3 and k[3] == table))
                ]
                for k in drop:
                    del self._map[k]
            n = len(drop)
            self.invalidations += n
            if push:
                self.push_invalidations += n
            else:
                self.stale_invalidations += n
            rewarm = self._rewarm
        if push and rewarm is not None and drop:
            # optional re-warm: hand the dropped keys to the hook (a
            # SubscriptionManager re-evaluating its standing queries is
            # the usual warmer); contained — a broken warmer must not
            # break the event path
            try:
                self.rewarmed += rewarm(drop)
            except Exception:
                pass
        return n

    def attach_bus(self, bus, *, rewarm=None):
        """Subscribe to an `events.QueryEventBus`: every event naming a
        (db, table) push-invalidates its entries. Idempotent per bus.
        `rewarm(keys) -> int` optionally re-computes hot entries right
        after a push drop (returns how many it warmed)."""
        if rewarm is not None:
            self._rewarm = rewarm
        with self._lock:
            if any(b is bus for b, _ in self._buses):
                return None

        def on_events(events) -> None:
            seen = set()
            for e in events:
                db = getattr(e, "db", None)
                table = getattr(e, "table", None)
                if db is None or table is None or (db, table) in seen:
                    continue
                seen.add((db, table))
                self.invalidate(db, table, push=True)

        handle = bus.subscribe(on_events, name="query_cache")
        with self._lock:
            self._buses.append((bus, handle))
        return handle

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def get_counters(self) -> dict:
        """Countable face — dogfoods into deepflow_system like every
        other component, so cache health is queryable via SQL and
        PromQL (tpu_query_cache_hits{...}); the push vs stale lanes
        (tpu_query_cache_push_invalidations / ..._stale_invalidations)
        make the event plane's invalidation coverage observable."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
                "push_invalidations": self.push_invalidations,
                "stale_invalidations": self.stale_invalidations,
                "rewarmed": self.rewarmed,
                "evictions": self.evictions,
                "entries": len(self._map),
                "max_entries": self.max_entries,
            }


#: process-wide default result cache (the engines use it unless told
#: otherwise), registered as a Countable at import — the reference's
#: RegisterCountable-at-construction stance.
default_query_cache = QueryResultCache(max_entries=256)
register_countable("tpu_query_cache", default_query_cache)


def cache_token(store, db: str, table: str, live: LiveRegistry | None) -> tuple:
    """The validation token both engines stamp on cached entries:
    (store write epoch, live generation). Any flushed insert — a
    window close — or a new live snapshot changes it."""
    mut = store.mutation_count(db, table) if hasattr(store, "mutation_count") else -1
    lep = live.epoch(db, table) if live is not None else 0
    return (mut, lep)
