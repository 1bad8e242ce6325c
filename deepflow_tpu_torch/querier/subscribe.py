"""Push-mode query plane, layer 2: query subscriptions.
Port copy of deepflow_tpu/querier/subscribe.py.


A dashboard storm is thousands of clients asking the SAME question at
the same cadence. The live plane's result cache collapses the
*recompute* cost of a repeated read, but every client still polls;
this module inverts the flow: a PromQL/SQL query registers ONCE, the
`events.QueryEventBus` tells the manager when its (db, table) moved,
the manager re-evaluates against the live overlay ONE time and fans
the result out to N watchers. N dashboards cost one evaluation per
data change, not one evaluation per client per poll tick.

Shape:

  * `SubscriptionManager.subscribe_promql(query, span_s=, step=)` — a
    range query pinned to "now": each evaluation runs `query_range`
    over `[now - span_s, now]` where `now` is the event batch's data
    time (`events.event_time` max; wall clock only when no event
    carries one), so results are deterministic under replay.
    `subscribe_sql(sql)` — the SQL is evaluated as written; its
    (db, table) is resolved once at subscribe time for event routing.
  * **Dedup**: identical query specs share ONE Subscription — a second
    `subscribe_*` call with the same spec just adds a watcher.
  * **Watchers**: `sub.watch(callback)` or `sub.watch()` (queue mode:
    a bounded deque the client drains; overflow drops the OLDEST
    result, counted — a slow websocket must not hold results for the
    fast ones). A callback that raises is counted and DETACHED after
    `MAX_WATCHER_FAILURES` consecutive failures — it never stalls the
    drain that published the event.
  * **Coalescing**: handlers receive the whole publish batch, so K
    window closes in one drain mark the subscription dirty K times but
    evaluate ONCE (`coalesced_events` counts the K−1 savings).

Every evaluation runs under `SPAN_SUBSCRIPTION_EVAL` on the manager's
tracer; the manager registers as a Countable (`tpu_query_subscriptions`)
so fan-out amplification (deliveries/evals) is queryable via SQL and
PromQL like every other lane. Evaluations go through the shared result
cache, so a subscription doubles as the cache re-warmer: the entry a
push event just dropped is recomputed by the one subscription eval and
every plain pull after it hits.
"""

from __future__ import annotations

import threading
import time
from collections import deque

from ..utils.spans import SPAN_SUBSCRIPTION_EVAL, SpanTracer
from ..utils.stats import register_countable
from .events import QueryEventBus, event_time

DEFAULT_WATCHER_QUEUE = 64


class Watcher:
    """One consumer of a subscription's evaluations: callback mode
    (`callback(result, subscription)`) or queue mode (bounded deque,
    client drains with `poll()`).

    Lease: with `lease_s` set the watcher must
    renew within that many seconds — `poll()` renews implicitly (an
    actively-draining queue dashboard never expires), a SUCCESSFUL
    callback delivery renews too (callback mode has no poll; accepting
    the delivery is its heartbeat), and `renew()` renews explicitly
    (the wire layer calls it per client heartbeat). A watcher that
    misses its lease is REAPED by the manager (counted,
    `watchers_reaped`): an abandoned dashboard client stops holding a
    bounded queue — and its share of fan-out work — forever. lease_s
    None (default) never expires, today's behavior."""

    MAX_WATCHER_FAILURES = 4

    __slots__ = ("callback", "queue", "delivered", "dropped", "errors",
                 "_failstreak", "detached", "lease_s", "last_renew")

    def __init__(self, callback=None, *, maxlen: int = DEFAULT_WATCHER_QUEUE,
                 lease_s: float | None = None):
        self.callback = callback
        self.queue: deque | None = None if callback is not None else deque(
            maxlen=max(1, maxlen)
        )
        self.delivered = 0
        self.dropped = 0
        self.errors = 0
        self._failstreak = 0
        self.detached = False
        self.lease_s = lease_s
        self.last_renew = time.monotonic()

    def renew(self) -> None:
        """Refresh the lease (client liveness heartbeat)."""
        self.last_renew = time.monotonic()

    def expired(self, now_monotonic: float | None = None) -> bool:
        if self.lease_s is None:
            return False
        now = time.monotonic() if now_monotonic is None else now_monotonic
        return now - self.last_renew > self.lease_s

    def deliver(self, result, sub) -> bool:
        if self.callback is not None:
            try:
                self.callback(result, sub)
            except Exception:
                self.errors += 1
                self._failstreak += 1
                if self._failstreak >= self.MAX_WATCHER_FAILURES:
                    self.detached = True
                return False
            self._failstreak = 0
            self.delivered += 1
            # a callback that keeps ACCEPTING deliveries is alive — it
            # has no poll() to renew through, so successful delivery IS
            # its heartbeat (queue mode must NOT renew here: the queue
            # fills whether or not anyone drains it — only poll() proves
            # a queue client exists)
            self.renew()
            return True
        if len(self.queue) == self.queue.maxlen:
            self.dropped += 1  # deque drops the OLDEST on append
        self.queue.append(result)
        self.delivered += 1
        return True

    def poll(self, *, renew: bool = True):
        """Queue mode: pop the oldest pending result (None = empty).
        Polling renews the lease by default — an actively-draining
        client is by definition alive. The WIRE plane passes
        `renew=False`: there the server-side delivery loop polls on the
        client's behalf, so the pop itself proves nothing about the
        client — only a successful socket write does, and the wire lane
        calls `renew()` explicitly after one (a disconnected client's
        lease must lapse even while the server keeps polling)."""
        if renew:
            self.renew()
        if self.queue is None or not self.queue:
            return None
        return self.queue.popleft()


class Subscription:
    """One registered query + its watcher set; evaluation is owned by
    the manager (one eval per event batch, shared by every watcher)."""

    def __init__(self, key: tuple, kind: str, query: str, db: str, table: str,
                 evaluate):
        self.key = key
        self.kind = kind  # "promql" | "sql"
        self.query = query
        self.db = db
        self.table = table
        self._evaluate = evaluate  # (now:int) -> result
        self.watchers: list[Watcher] = []
        self.evals = 0
        self.eval_errors = 0
        self.deliveries = 0
        self.coalesced_events = 0
        self.last_eval_us = 0
        self.last_now = 0
        self.last_result = None

    def watch(self, callback=None, *, maxlen: int = DEFAULT_WATCHER_QUEUE,
              lease_s: float | None = None) -> Watcher:
        w = Watcher(callback, maxlen=maxlen, lease_s=lease_s)
        self.watchers.append(w)
        return w

    def unwatch(self, watcher: Watcher) -> None:
        if watcher in self.watchers:
            self.watchers.remove(watcher)


class SubscriptionManager:
    """Standing queries over one store, evaluated on push events. SQL
    subscriptions reduce on `device` (default CUDA; raises without it)
    through the SQL engine, on the device's default stream — the one
    the ingest thread writes on — and every result comes back to the
    host before it is delivered."""

    def __init__(self, store, *, live=None, cache=None, bus: QueryEventBus | None = None,
                 tracer: SpanTracer | None = None, name: str = "subs", device=None):
        from ..device import resolve_device
        from .live import default_live_registry, default_query_cache

        self.store = store
        self.device = resolve_device(device)
        self.live = default_live_registry if live is None else live
        self.cache = default_query_cache if cache is None else (
            None if cache is False else cache
        )
        self.tracer = tracer if tracer is not None else SpanTracer(
            service="deepflow_tpu.subscribe"
        )
        self.name = name
        self._subs: dict[tuple, Subscription] = {}
        self._lock = threading.Lock()
        self.counters = {
            "event_batches": 0,
            "evals": 0,
            "eval_errors": 0,
            "deliveries": 0,
            "coalesced_events": 0,
            "watcher_drops": 0,
            "watcher_errors": 0,
            "watchers_detached": 0,
            "watchers_reaped": 0,
        }
        # serializes evaluation + fan-out: bus dispatch is single-
        # threaded by the bus itself, but the public evaluate() may be
        # called from any thread concurrently with it
        self._eval_lock = threading.RLock()
        self._bus = bus
        self._bus_handle = None
        if bus is not None:
            self._bus_handle = bus.subscribe(self.on_events, name=f"subs:{name}")
        self._stats_src = register_countable(
            "tpu_query_subscriptions", self, name=name
        )

    def close(self) -> None:
        """Detach from the bus AND the stats collector — a stopped
        manager on a shared bus must not keep evaluating against its
        (possibly stopped) store, nor keep dogfooding frozen counters
        next to a successor with the same name tag."""
        if self._bus is not None and self._bus_handle is not None:
            self._bus.unsubscribe(self._bus_handle)
            self._bus_handle = None
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    # -- registration ----------------------------------------------------
    def subscribe_promql(
        self, query: str, *, span_s: int, step: int, db: str, table: str,
        lookback_s: int = 300, callback=None, queue: bool = False,
        maxlen: int = DEFAULT_WATCHER_QUEUE, lease_s: float | None = None,
    ) -> tuple[Subscription, Watcher]:
        """Register (or join — dedup) a now-anchored PromQL range query;
        returns (subscription, watcher). Pass `callback` for push
        delivery or `queue=True` for a pollable bounded queue; neither
        registers a bare subscription (evaluations still run and park
        in `last_result` — the cache-warming mode). `lease_s` gives the
        watcher a renewal lease (poll()/renew()); miss it and `reap()`
        removes the watcher, counted."""
        from .promql import query_range

        key = ("promql", query, db, table, int(span_s), int(step), int(lookback_s))

        def evaluate(now: int):
            return query_range(
                self.store, query, int(now) - int(span_s), int(now), int(step),
                lookback_s=lookback_s, db=db, table=table, live=self.live,
                cache=self.cache if self.cache is not None else False,
            )

        return self._register(key, "promql", query, db, table, evaluate,
                              callback, queue, maxlen, lease_s)

    def subscribe_sql(
        self, sql: str, *, callback=None, queue: bool = False,
        maxlen: int = DEFAULT_WATCHER_QUEUE, lease_s: float | None = None,
    ) -> tuple[Subscription, Watcher]:
        """Register (or join) a SQL query, evaluated as written. Its
        (db, table) resolves once here — event routing filters on it."""
        from .engine import QueryEngine

        engine = QueryEngine(self.store, live=self.live,
                             cache=self.cache if self.cache is not None else False,
                             device=self.device)
        db, table = engine.resolve_query_table(sql)
        key = ("sql", sql, db, table)

        def evaluate(now: int):
            return engine.execute(sql)

        return self._register(key, "sql", sql, db, table, evaluate,
                              callback, queue, maxlen, lease_s)

    def _register(self, key, kind, query, db, table, evaluate,
                  callback, queue, maxlen, lease_s=None):
        with self._lock:
            sub = self._subs.get(key)
            if sub is None:
                sub = Subscription(key, kind, query, db, table, evaluate)
                self._subs[key] = sub
        watcher = None
        if callback is not None or queue:
            watcher = sub.watch(callback, maxlen=maxlen, lease_s=lease_s)
        return sub, watcher

    def reap(self, now_monotonic: float | None = None) -> int:
        """Remove watchers whose lease expired:
        an abandoned dashboard client — websocket gone, tab closed —
        stops holding its bounded queue and its share of the fan-out.
        Counted (`watchers_reaped`, queryable like every lane); runs
        before every event-batch evaluation and from Server.tick."""
        now = time.monotonic() if now_monotonic is None else now_monotonic
        reaped = 0
        with self._lock:
            subs = list(self._subs.values())
        # watcher-list mutation is serialized on the eval lock like
        # every other path that touches it (_evaluate_locked's detach
        # loop) — reap() runs concurrently from the Server.tick thread
        # and the bus thread, and an unguarded check-then-remove pair
        # would double-remove the same expired watcher (ValueError out
        # of whichever thread loses the race, double-counted reaps)
        with self._eval_lock:
            for sub in subs:
                for w in [w for w in sub.watchers if w.expired(now)]:
                    sub.unwatch(w)
                    reaped += 1
        if reaped:
            with self._lock:
                self.counters["watchers_reaped"] += reaped
        return reaped

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            self._subs.pop(sub.key, None)

    # -- evaluation ------------------------------------------------------
    def on_events(self, events) -> None:
        """Bus handler: ONE evaluation per dirty subscription per batch
        regardless of how many events touched it (the coalescing pin).
        Expired leases reap first — a dead client must not receive (or
        drop) this batch's delivery."""
        self.reap()
        with self._lock:
            subs = list(self._subs.values())
            self.counters["event_batches"] += 1
        if not subs:
            return
        now = max((t for t in (event_time(e) for e in events) if t is not None),
                  default=None)
        touched: dict[tuple, int] = {}
        for e in events:
            db = getattr(e, "db", None)
            table = getattr(e, "table", None)
            if db is None:
                continue
            touched[(db, table)] = touched.get((db, table), 0) + 1
        for sub in subs:
            n = touched.get((sub.db, sub.table), 0)
            if n == 0:
                continue
            sub.coalesced_events += n - 1
            with self._lock:
                self.counters["coalesced_events"] += n - 1
            self.evaluate(sub, now=now)

    def evaluate(self, sub: Subscription, *, now: int | None = None):
        """Evaluate one subscription once and fan the result out to its
        watchers; returns the result (None on eval failure — counted,
        contained). `now=None` — an event batch with no data-timed
        event (e.g. pure SnapshotAdvanced) — re-evaluates at the LAST
        data time the subscription saw, not the wall clock: under
        replay the wall is far from the data and an eval there would
        silently answer over an empty range (falls back to the wall
        only when no data time was ever seen)."""
        with self._eval_lock:
            return self._evaluate_locked(sub, now)

    def _evaluate_locked(self, sub: Subscription, now: int | None):
        if now is None:
            now = sub.last_now or int(time.time())
        now = int(now)
        t0 = time.perf_counter()
        try:
            with self.tracer.span(SPAN_SUBSCRIPTION_EVAL):
                result = sub._evaluate(now)
        except Exception:
            sub.eval_errors += 1
            with self._lock:
                self.counters["eval_errors"] += 1
            return None
        sub.last_eval_us = int((time.perf_counter() - t0) * 1e6)
        sub.last_now = now
        sub.last_result = result
        sub.evals += 1
        with self._lock:
            self.counters["evals"] += 1
        detached = []
        for w in list(sub.watchers):
            drops0, errs0 = w.dropped, w.errors
            ok = w.deliver(result, sub)
            with self._lock:
                self.counters["watcher_drops"] += w.dropped - drops0
                self.counters["watcher_errors"] += w.errors - errs0
                if ok:
                    self.counters["deliveries"] += 1
            sub.deliveries += int(ok)
            if w.detached:
                detached.append(w)
        for w in detached:
            sub.unwatch(w)
            with self._lock:
                self.counters["watchers_detached"] += 1
        return result

    # -- read faces ------------------------------------------------------
    def list_subscriptions(self) -> list[dict]:
        """The dfctl listing: one row per active subscription."""
        with self._lock:
            subs = list(self._subs.values())
        return [
            {
                "kind": s.kind,
                "query": s.query,
                "db": s.db,
                "table": s.table,
                "watchers": len(s.watchers),
                "evals": s.evals,
                "eval_errors": s.eval_errors,
                "deliveries": s.deliveries,
                "coalesced_events": s.coalesced_events,
                "last_eval_us": s.last_eval_us,
                "last_now": s.last_now,
            }
            for s in subs
        ]

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["subscriptions"] = len(self._subs)
            out["watchers"] = sum(len(s.watchers) for s in self._subs.values())
        # the amplification lane the bench/gate pin: deliveries per eval
        out["amplification_x100"] = int(
            out["deliveries"] * 100 / max(1, out["evals"])
        )
        return out
