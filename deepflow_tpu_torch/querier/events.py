"""Push-mode query plane, layer 1: the QueryEventBus.
Port copy of deepflow_tpu/querier/events.py.


The live read plane (querier/live.py) is pull-only: the result cache discovers staleness
lazily, one token compare per lookup, and every dashboard client
re-evaluates its own query. The reference server's querier exists to
feed Grafana panels and alert rules — *continuous* consumers — so the
interesting moment is not "a query arrived" but "the data a standing
query watches just changed". This module gives that moment a type:

  * **Typed events** — `WindowClosed` (a 1s window's flushed rows left
    the device), `TierClosed` (a cascade 1m/1h window closed),
    `SnapshotAdvanced` (a new open-window snapshot generation landed),
    `StoreMutation` (a flushed insert/drop bumped a table's write
    epoch). Every event names its (db, table), so consumers filter
    with one tuple compare.
  * **QueryEventBus** — a bounded in-process pub/sub fan-out. Handlers
    receive the WHOLE publish batch in one call (`handler(events)`), so
    a drain that closes K windows produces ONE delivery — the
    coalescing surface subscriptions and alert rules build on (K
    closes → one evaluation). Publishing from inside a handler is
    legal: re-entrant events append to a bounded pending queue (drops
    counted) and drain in the same outer dispatch, never recursing.

Failure stance (the drain must never stall): a handler that raises is
counted (`handler_errors`); after `MAX_HANDLER_FAILURES` consecutive
failures it is DETACHED (counted, logged once) rather than retried
forever. Publish itself never raises. Counters register as a Countable
(`tpu_query_events`), so bus health dogfoods into `deepflow_system`
like every other component.

Layer-1 consumers wired here:

  * `connect_store_events(store, bus)` — the ColumnarStore's mutation
    hook → `StoreMutation` events: a window close (flushed insert)
    becomes a push the instant it lands, instead of a lazy token
    mismatch at the next lookup.
  * `live.QueryResultCache.attach_bus(bus)` — push invalidation: the
    cache drops a mutated (db, table)'s entries EAGERLY at event time
    (`push_invalidations` lane). The per-lookup token compare stays as
    the correctness backstop (`stale_invalidations` lane) — stale-row-
    never-served remains pinned bit-exact whether or not events flow.

The process-wide `default_event_bus` mirrors `default_live_registry` /
`default_query_cache` and arrives pre-attached to the default cache: a
process that never publishes keeps today's pull-only behavior bit-for-
bit; the first connected store makes invalidation push-mode with no
further wiring.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
from collections import deque

from ..utils.stats import register_countable

_log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# the event vocabulary


@dataclasses.dataclass(frozen=True)
class WindowClosed:
    """A 1s window closed: its flushed rows left (or are leaving) the
    device — any standing query over (db, table) is stale."""

    db: str
    table: str
    time: int  # window start, seconds
    interval: int = 1


@dataclasses.dataclass(frozen=True)
class TierClosed:
    """A cascade tier window (1m/1h/…) closed."""

    db: str
    table: str
    time: int
    interval: int


@dataclasses.dataclass(frozen=True)
class SnapshotAdvanced:
    """A new open-window snapshot generation is readable — live
    partials moved even though nothing flushed."""

    db: str
    table: str
    seq: int


@dataclasses.dataclass(frozen=True)
class StoreMutation:
    """A table's write epoch moved (insert or partition drop)."""

    db: str
    table: str
    epoch: int


@dataclasses.dataclass(frozen=True)
class ProfileSnapshot:
    """A profiling sample tick landed: the device memory
    ledger / span-quantile rows for (db, table) moved — span-latency
    alert rules and standing profile dashboards re-evaluate. `time` is
    the tick's sample timestamp (the rows' own time column), so
    evaluations run at DATA time like every other event; None falls
    back to the consumer's last data time, like SnapshotAdvanced."""

    db: str
    table: str
    seq: int
    time: int | None = None


@dataclasses.dataclass(frozen=True)
class AlertFired:
    """An alert rule transitioned: published by the wire
    hub's alert sink so in-process consumers can ride the same moment
    remote dashboards see. Deliberately carries NO `db` attribute —
    subscription/alert routing keys on (db, table), and an alert
    transition must not re-trigger query evaluation (that way lies a
    feedback loop: eval → alert → event → eval)."""

    rule: str
    state: str
    value: float
    labels: tuple = ()
    time: int | None = None


QUERY_EVENT_TYPES = (
    WindowClosed, TierClosed, SnapshotAdvanced, StoreMutation,
    ProfileSnapshot, AlertFired,
)


def event_time(ev) -> int | None:
    """Best event-plane clock for an event (None when it carries no
    time) — subscription/alert evaluation uses the batch max as `now`
    so `for`-durations advance on DATA time, deterministically."""
    t = getattr(ev, "time", None)
    if t is None:
        return None
    return int(t) + int(getattr(ev, "interval", 1) or 1)


# ---------------------------------------------------------------------------
# the bus


class _Handler:
    __slots__ = ("fn", "name", "failures", "detached")

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name
        self.failures = 0  # consecutive
        self.detached = False


class QueryEventBus:
    """Bounded in-process event fan-out; batch-preserving delivery."""

    # consecutive handler failures before detachment — a broken
    # subscriber must not tax every future drain with a raise+catch
    MAX_HANDLER_FAILURES = 8

    def __init__(self, *, max_pending: int = 4096, name: str = "default"):
        self.name = name
        self.max_pending = max_pending
        self._handlers: list[_Handler] = []
        self._pending: deque = deque()
        self._lock = threading.RLock()
        self._dispatching = False
        self.counters = {
            "events_published": 0,
            "events_dropped": 0,
            "batches": 0,
            "handler_errors": 0,
            "handlers_detached": 0,
        }
        register_countable("tpu_query_events", self, name=name)

    # -- registry --------------------------------------------------------
    def subscribe(self, handler, *, name: str = "?") -> _Handler:
        """`handler(events: list)` gets every publish batch in one
        call; returns a handle for `unsubscribe`."""
        h = _Handler(handler, name)
        with self._lock:
            self._handlers.append(h)
        return h

    def unsubscribe(self, handle: _Handler) -> None:
        with self._lock:
            if handle in self._handlers:
                self._handlers.remove(handle)

    # -- publish ---------------------------------------------------------
    def publish(self, events) -> int:
        """Deliver a batch (or one event) to every handler; returns the
        number of events accepted. Never raises; re-entrant publishes
        queue into the bounded pending deque and drain in the OUTER
        dispatch — one logical batch per drain, no recursion."""
        if dataclasses.is_dataclass(events):
            events = [events]
        events = [e for e in events if e is not None]
        if not events:
            return 0
        with self._lock:
            accepted = 0
            for e in events:
                if len(self._pending) >= self.max_pending:
                    self.counters["events_dropped"] += 1
                    continue
                self._pending.append(e)
                accepted += 1
            self.counters["events_published"] += accepted
            if self._dispatching:
                # a publish from inside a handler (or from another
                # thread mid-drain): the draining caller owns delivery
                return accepted
            self._dispatching = True
        self._drain()
        return accepted

    @contextlib.contextmanager
    def batch(self):
        """Coalesce every publish inside the context into ONE dispatch
        at exit. The close-and-insert shape needs this: a sink's
        `store.insert` fires the mutation hook's StoreMutation and the
        sink then publishes its data-timed WindowClosed — without the
        context that is two dispatches per close (two evaluations, a
        drop-rewarm-drop cache bounce, and the first eval has no data
        time); inside it, both land in one batch, evaluated once at
        the data time. Re-entrant: inside an active dispatch (or a
        nested batch) it is a no-op — the outer drain owns delivery."""
        with self._lock:
            nested = self._dispatching
            self._dispatching = True
        try:
            yield self
        finally:
            if not nested:
                self._drain()

    def _drain(self) -> None:
        """Deliver pending batches until empty. The emptiness check and
        the `_dispatching` clear happen under ONE lock acquisition: a
        concurrent publisher either appends while the flag is up (this
        loop sees it) or after the clear (it drains itself) — an event
        can never strand between a finishing drainer and a publisher
        that deferred to it."""
        while True:
            with self._lock:
                if not self._pending:
                    self._dispatching = False
                    return
                batch = list(self._pending)
                self._pending.clear()
                self.counters["batches"] += 1
                handlers = [h for h in self._handlers if not h.detached]
            try:
                self._dispatch(batch, handlers)
            except BaseException:
                with self._lock:  # never leave the bus wedged
                    self._dispatching = False
                raise

    def _dispatch(self, batch: list, handlers: list) -> None:
        for h in handlers:
            try:
                h.fn(batch)
            except Exception:
                with self._lock:
                    self.counters["handler_errors"] += 1
                h.failures += 1
                if h.failures >= self.MAX_HANDLER_FAILURES:
                    h.detached = True
                    with self._lock:
                        self.counters["handlers_detached"] += 1
                        if h in self._handlers:
                            self._handlers.remove(h)
                    _log.exception(
                        "event bus %s: handler %s detached after %d "
                        "consecutive failures",
                        self.name, h.name, h.failures,
                    )
                else:
                    _log.debug(
                        "event bus %s: handler %s raised (contained)",
                        self.name, h.name, exc_info=True,
                    )
            else:
                h.failures = 0

    # -- countable face --------------------------------------------------
    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["handlers"] = len(self._handlers)
            out["pending"] = len(self._pending)
        return out


# ---------------------------------------------------------------------------
# store → bus wiring


def connect_store_events(store, bus: QueryEventBus):
    """Point a ColumnarStore's mutation hook at the bus: every insert /
    partition drop publishes a `StoreMutation` for its (db, table).
    Returns the hook so callers can detach (`store.set_mutation_hook
    (None)`)."""

    def hook(db: str, table: str, epoch: int) -> None:
        bus.publish(StoreMutation(db, table, int(epoch)))

    store.set_mutation_hook(hook)
    return hook


def docbatch_events(outputs, *, db: str, table: str) -> list:
    """Flushed pipeline outputs → WindowClosed/TierClosed events, one
    per distinct (window start, interval). Accepts the two flushed
    shapes the window controllers emit — DocBatch (timestamp array,
    optional tier `interval_s`) and FlushedWindow (start_time) — and
    skips anything it cannot read; the event hook must never be the
    thing that breaks a drain."""
    seen: dict[tuple[int, int], None] = {}
    for o in outputs:
        try:
            interval = int(
                getattr(o, "interval_s", None) or getattr(o, "interval", 1) or 1
            )
            st = getattr(o, "start_time", None)
            if st is None:
                ts = getattr(o, "timestamp", None)
                if ts is None or not len(ts):
                    continue
                st = int(ts[0]) // interval * interval
            seen.setdefault((int(st), interval), None)
        except Exception:
            continue
    return [
        WindowClosed(db, table, t, i) if i <= 1 else TierClosed(db, table, t, i)
        for (t, i) in seen
    ]


#: process-wide default bus, mirroring live.default_live_registry /
#: live.default_query_cache — and pre-attached to the default cache, so
#: the first `connect_store_events` makes invalidation push-mode with
#: no further wiring (nothing changes until something publishes).
default_event_bus = QueryEventBus()

from .live import default_query_cache  # noqa: E402  (import-cycle-free: live imports nothing from here)

default_query_cache.attach_bus(default_event_bus)
