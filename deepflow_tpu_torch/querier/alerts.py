"""Push-mode query plane, layer 3: the alerting rule engine.
Port copy of deepflow_tpu/querier/alerts.py.


The reference server's querier serves exactly two consumers — Grafana
dashboards and alert rules. Subscriptions (subscribe.py) are the
dashboard half; an alert rule is the same machinery with a comparator
and a threshold bolted on: a standing query re-evaluated on push
events, whose RESULT feeds a small per-rule state machine instead of a
websocket.

Rule = query (PromQL instant — including `topk()` / distinct /
quantile queries the sketch plane answers — or SQL) + comparator +
threshold + `for`-duration. State is kept PER SERIES (label set) —
Prometheus semantics: one service's latency series can fire
while its siblings stay inactive; the rule-level faces report the
worst series. States:

    inactive ──breach──▶ pending ──held for ≥ for_s──▶ firing
       ▲                    │                            │
       └────no breach───────┘                       no breach
                                                         ▼
    resolved ◀───────────────────────────────────────────┘
       └──breach──▶ pending  (flap suppression: a re-fire after a
                              resolve walks the FULL pending ladder
                              again — a flapping series cannot ring
                              the pager at event rate)

Time is the event plane's DATA time (`events.event_time` batch max),
so `for`-durations advance deterministically under replay and tests;
`tick(now)` drives the same evaluation from a wall clock for processes
whose tables go quiet (a pending rule must still mature to firing when
traffic stops precisely because it stopped).

Transitions notify pluggable sinks: `log_notification_sink` (always
available), arbitrary callbacks, and `otlp_notification_sink(exporter)`
— alert events ride the same exporter traces lane the span tracer uses,
so a firing rule shows up in the trace backend next to the pipeline
stages that produced it. A raising sink is counted and DETACHED after
`MAX_SINK_FAILURES` consecutive failures; it never stalls the drain.

Dogfood: the engine registers as a Countable (`tpu_alert_rules`), with
per-rule state codes and transition counts as flat lanes — rule states
are queryable via SQL and PromQL
(`tpu_alert_rules_rule_<name>_state_code`) like every other component.
"""

from __future__ import annotations

import dataclasses
import logging
import re
import threading
import time

from ..utils.spans import SPAN_ALERT_EVAL, SpanTracer
from ..utils.stats import register_countable
from .events import QueryEventBus, event_time

_log = logging.getLogger(__name__)

STATE_INACTIVE = "inactive"
STATE_PENDING = "pending"
STATE_FIRING = "firing"
STATE_RESOLVED = "resolved"

#: stable numeric codes for the dogfood lanes (SQL/PromQL-queryable)
STATE_CODES = {
    STATE_INACTIVE: 0,
    STATE_PENDING: 1,
    STATE_FIRING: 2,
    STATE_RESOLVED: 3,
}

_COMPARATORS = {
    ">": lambda v, t: v > t,
    ">=": lambda v, t: v >= t,
    "<": lambda v, t: v < t,
    "<=": lambda v, t: v <= t,
    "==": lambda v, t: v == t,
    "!=": lambda v, t: v != t,
}

_NAME_SAN_RE = re.compile(r"[^a-zA-Z0-9_]")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One rule spec. `engine` picks evaluation: "promql" runs
    `query_instant` at the event time over (db, table) and compares
    EVERY returned series against the threshold — state is kept PER
    LABEL SET (Prometheus semantics: one series of
    a rule can fire while its siblings stay inactive); "sql" executes
    the statement and compares the first numeric cell of the first row
    (one anonymous series). A series with no data this evaluation is no
    breach (a silent series resolves rather than pages), and an
    inactive series that stops reporting leaves the state map — label
    churn cannot grow it unboundedly (plus a hard cap, counted)."""

    name: str
    query: str
    comparator: str  # one of > >= < <= == !=
    threshold: float
    for_s: int = 0
    engine: str = "promql"  # "promql" | "sql"
    db: str = "deepflow_system"
    table: str = "deepflow_system"
    lookback_s: int = 300
    labels: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.comparator not in _COMPARATORS:
            raise ValueError(f"unknown comparator {self.comparator!r}")
        if self.engine not in ("promql", "sql"):
            raise ValueError(f"unknown engine {self.engine!r}")
        if self.for_s < 0:
            raise ValueError("for_s must be >= 0")


#: worst-state ordering for the rule-level rollup faces (state(),
#: list_rules, the dogfood state-code lane)
_SEVERITY = {STATE_INACTIVE: 0, STATE_RESOLVED: 1, STATE_PENDING: 2,
             STATE_FIRING: 3}


def worst_state(states) -> str:
    """Worst alert state in `states` under the severity ordering —
    the fleet aggregator's per-rule cross-host rollup (one firing host
    makes the fleet rule firing). Unknown states rank below inactive
    rather than raising: a newer host must not crash an older pane."""
    worst = STATE_INACTIVE
    rank = -1
    for s in states:
        r = _SEVERITY.get(s, -1)
        if r > rank:
            rank, worst = r, s
    return worst


# -- rule persistence ----------------------------------------------------
#
# Rules serialize to/from plain mappings so a YAML or JSON config file
# round-trips an engine's rule set across restarts. Parsing is LOUD:
# a malformed rule raises ValueError naming the entry and the field —
# a typo'd comparator must fail the boot, not silently drop the page.

_RULE_REQUIRED = ("name", "query", "comparator", "threshold")
_RULE_OPTIONAL = {
    "for_s": int, "engine": str, "db": str, "table": str,
    "lookback_s": int, "labels": None,
}


def rule_to_dict(rule: AlertRule) -> dict:
    d = dataclasses.asdict(rule)
    d["labels"] = dict(rule.labels)
    return d


def rule_from_dict(d, *, where: str = "rule") -> AlertRule:
    if not isinstance(d, dict):
        raise ValueError(f"{where}: expected a mapping, got {type(d).__name__}")
    unknown = set(d) - set(_RULE_REQUIRED) - set(_RULE_OPTIONAL)
    if unknown:
        raise ValueError(f"{where}: unknown keys {sorted(unknown)}")
    for k in _RULE_REQUIRED:
        if k not in d:
            raise ValueError(f"{where}: missing required key {k!r}")
    kw = dict(d)
    try:
        kw["threshold"] = float(kw["threshold"])
        for k in ("for_s", "lookback_s"):
            if k in kw:
                kw[k] = int(kw[k])
        labels = kw.pop("labels", None)
        if labels is not None:
            if not isinstance(labels, dict):
                raise ValueError("labels must be a mapping")
            kw["labels"] = tuple(sorted(
                (str(k), str(v)) for k, v in labels.items()
            ))
        rule = AlertRule(**kw)
    except (TypeError, ValueError) as exc:
        raise ValueError(f"{where}: {exc}") from exc
    return rule


def load_rules_file(path) -> list[AlertRule]:
    """Parse a YAML/JSON rules file → validated AlertRules. The file is
    either a list of rule mappings or {"rules": [...]}; EVERY rule is
    validated before any is returned (atomic — a malformed entry fails
    the whole load loudly)."""
    import json
    from pathlib import Path

    import yaml

    p = Path(path)
    text = p.read_text()
    try:
        data = (json.loads(text) if p.suffix == ".json"
                else yaml.safe_load(text))
    except Exception as exc:
        raise ValueError(f"alert rules file {p}: unparseable: {exc}") from exc
    if isinstance(data, dict):
        data = data.get("rules", None)
    if not isinstance(data, list):
        raise ValueError(
            f"alert rules file {p}: expected a list of rules (or a "
            "mapping with a 'rules' list)"
        )
    rules = [
        rule_from_dict(d, where=f"{p.name} rule #{i}")
        for i, d in enumerate(data)
    ]
    names = [r.name for r in rules]
    dupes = {n for n in names if names.count(n) > 1}
    if dupes:
        raise ValueError(f"alert rules file {p}: duplicate names {sorted(dupes)}")
    return rules


def save_rules_file(path, rules: list[AlertRule]) -> None:
    """Write rules as YAML (or JSON for a .json path) — the exact shape
    `load_rules_file` reads back."""
    import json
    from pathlib import Path

    import yaml

    p = Path(path)
    doc = {"rules": [rule_to_dict(r) for r in rules]}
    if p.suffix == ".json":
        p.write_text(json.dumps(doc, indent=2))
    else:
        p.write_text(yaml.safe_dump(doc, sort_keys=False))


class _SeriesState:
    """One label set's state machine (Prometheus keys alert state by
    series, not by rule)."""

    __slots__ = ("labels", "state", "pending_since", "fired_before",
                 "last_value", "last_transition", "transitions",
                 "last_partial", "last_seen")

    def __init__(self, labels: dict | None = None):
        self.labels = dict(labels or {})
        self.state = STATE_INACTIVE
        self.pending_since: int | None = None
        self.fired_before = False
        self.last_value: float | None = None
        self.last_transition = 0
        self.transitions = 0
        self.last_partial = False
        self.last_seen = 0  # event time of the last eval WITH data


class _RuleState:
    """Per-rule bookkeeping: the series map + rule-level eval counters.
    Bounded: beyond MAX_SERIES new label sets are counted-dropped (the
    held-buffer stance everywhere else in the tree); inactive series
    that stop reporting are garbage-collected each evaluation."""

    MAX_SERIES = 512

    __slots__ = ("series", "last_eval", "evals", "eval_errors",
                 "last_partial", "series_dropped", "_transitions_base",
                 "_last_transition_base")

    def __init__(self):
        self.series: dict[tuple, _SeriesState] = {}
        self.last_eval = 0
        self.evals = 0
        self.eval_errors = 0
        self.last_partial = False
        self.series_dropped = 0
        self._transitions_base = 0  # transitions of GC'd series
        self._last_transition_base = 0  # newest transition of GC'd series

    def worst(self) -> _SeriesState | None:
        """The most severe series (ties: larger value) — the rule-level
        rollup the single-state faces report."""
        best = None
        for ss in self.series.values():
            if best is None:
                best = ss
                continue
            key = (_SEVERITY[ss.state], ss.last_value or 0.0)
            bkey = (_SEVERITY[best.state], best.last_value or 0.0)
            if key > bkey:
                best = ss
        return best

    @property
    def state(self) -> str:
        w = self.worst()
        return STATE_INACTIVE if w is None else w.state

    @property
    def transitions(self) -> int:
        return self._transitions_base + sum(
            ss.transitions for ss in self.series.values()
        )


def log_notification_sink(event: dict) -> None:
    """The always-on default notification lane."""
    _log.warning(
        "ALERT %s: rule %r value=%s threshold %s %s (t=%s)",
        event["state"], event["rule"], event["value"], event["comparator"],
        event["threshold"], event["time"],
    )


def otlp_notification_sink(exporter, *, table: str = "l7_flow_log"):
    """→ a sink shipping alert transitions through an exporter's traces
    lane (the same path utils/spans.export_otlp uses), one span per
    transition: app_service = deepflow_tpu.alerts, endpoint = rule
    name, response_duration = the for-duration the rule held."""
    import numpy as np

    seq = {"n": 0}

    def sink(event: dict) -> None:
        seq["n"] += 1
        i = seq["n"]
        cols = {
            "time": np.asarray([int(event["time"])], np.uint32),
            "start_time": np.asarray([int(event["time"])], np.uint32),
            "response_duration": np.asarray(
                [int(event.get("held_s", 0)) * 1_000_000], np.uint32
            ),
            "app_service": np.asarray(["deepflow_tpu.alerts"]),
            "endpoint": np.asarray([f"{event['rule']}:{event['state']}"]),
            "trace_id": np.asarray([f"{i:032x}"]),
            "span_id": np.asarray([f"{i:016x}"]),
            "parent_span_id": np.asarray([""]),
        }
        exporter.export(table, cols)

    return sink


def wire_notification_sink(hub):
    """→ a sink fanning alert transitions to the wire hub's `alerts=1`
    watchers — the wire twin of otlp_notification_sink: a
    firing rule reaches every connected `/v1/watch?alerts=1` stream
    (and, through the hub's bus hook, any in-process AlertFired
    consumer) without polling."""

    def sink(event: dict) -> None:
        hub.deliver_alert(dict(event))

    return sink


class _Sink:
    __slots__ = ("fn", "name", "failures", "detached")

    def __init__(self, fn, name):
        self.fn = fn
        self.name = name
        self.failures = 0
        self.detached = False


class AlertEngine:
    """Rules over one store, evaluated on push events (and `tick`). SQL
    rules reduce on `device` (default CUDA; raises without it) through
    the SQL engine, on the device's default stream, and compare the
    host copy of the result."""

    MAX_SINK_FAILURES = 4
    # a RESOLVED series that stops reporting is kept this many seconds
    # (event time) for flap-memory/visibility, then GC'd like an
    # inactive one — without this, churned series that once fired
    # (per-pod incident labels) occupy MAX_SERIES slots forever and
    # eventually block NEW series from ever alerting
    RESOLVED_RETENTION_S = 900

    def __init__(self, store, *, live=None, cache=None,
                 bus: QueryEventBus | None = None,
                 tracer: SpanTracer | None = None, name: str = "alerts",
                 log_sink: bool = True, device=None):
        from ..device import resolve_device
        from .live import default_live_registry

        self.store = store
        self.device = resolve_device(device)
        self.live = default_live_registry if live is None else live
        self.cache = cache
        self.tracer = tracer if tracer is not None else SpanTracer(
            service="deepflow_tpu.alerts"
        )
        self.name = name
        self._rules: dict[str, tuple[AlertRule, _RuleState]] = {}
        self._sinks: list[_Sink] = []
        self._lock = threading.Lock()
        # serializes rule evaluation + state transitions: bus dispatch
        # (a writer-flusher or feeder thread) and Server.tick run
        # concurrently, and an unguarded pending_since read racing a
        # transition's None-out would crash (int - None) or double-fire.
        # RLock, separate from _lock: _notify takes _lock inside.
        self._eval_lock = threading.RLock()
        self.counters = {
            "evals": 0,
            "eval_errors": 0,
            "notifications": 0,
            "sink_errors": 0,
            "sinks_detached": 0,
            "transitions": 0,
        }
        if log_sink:
            self.add_sink(log_notification_sink, name="log")
        self._bus = bus
        self._bus_handle = None
        if bus is not None:
            self._bus_handle = bus.subscribe(self.on_events, name=f"alerts:{name}")
        self._stats_src = register_countable("tpu_alert_rules", self, name=name)

    def close(self) -> None:
        """Detach from the bus AND the stats collector — a stopped
        engine on a shared bus must not keep firing rules against its
        (possibly stopped) store, nor keep dogfooding frozen counters
        next to a successor with the same name tag."""
        if self._bus is not None and self._bus_handle is not None:
            self._bus.unsubscribe(self._bus_handle)
            self._bus_handle = None
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    # -- registry --------------------------------------------------------
    def add_rule(self, rule: AlertRule) -> None:
        with self._lock:
            if rule.name in self._rules:
                raise ValueError(f"duplicate rule {rule.name!r}")
            self._rules[rule.name] = (rule, _RuleState())

    def remove_rule(self, name: str) -> None:
        with self._lock:
            self._rules.pop(name, None)

    # -- persistence (rules survive a restart) -----------------------------
    def save_rules(self, path) -> int:
        """Serialize every registered rule to a YAML/JSON file (shape:
        {"rules": [...]}). Returns the rule count. Per-series STATES are
        deliberately not persisted: they rebuild from evaluations after
        a restart (the for-ladder restarts from the next breach — a
        restart must not resurrect a stale pager state)."""
        with self._lock:
            rules = [r for r, _ in self._rules.values()]
        save_rules_file(path, rules)
        return len(rules)

    def load_rules(self, path, *, replace: bool = False) -> int:
        """Load + register rules from a YAML/JSON file. The WHOLE file
        validates before any rule registers (atomic); malformed entries
        raise ValueError naming the entry and field. With
        `replace=False` (default) a name collision with a live rule is
        an error — silently shadowing an active pager rule is worse
        than failing the load. Each loaded rule starts with FRESH
        per-series states; the next evaluations rebuild them."""
        rules = load_rules_file(path)
        with self._lock:
            if not replace:
                clash = [r.name for r in rules if r.name in self._rules]
                if clash:
                    raise ValueError(
                        f"alert rules file {path}: rules already "
                        f"registered: {clash} (load_rules(replace=True) "
                        "to replace them)"
                    )
            for r in rules:
                self._rules[r.name] = (r, _RuleState())
        return len(rules)

    def add_sink(self, fn, *, name: str = "?") -> _Sink:
        s = _Sink(fn, name)
        with self._lock:
            self._sinks.append(s)
        return s

    # -- evaluation ------------------------------------------------------
    def on_events(self, events) -> None:
        """Bus handler: ONE evaluation per matching rule per batch —
        K window closes in one drain cost one rule evaluation."""
        with self._lock:
            rules = list(self._rules.values())
        if not rules:
            return
        now = max((t for t in (event_time(e) for e in events) if t is not None),
                  default=None)
        touched = {
            (getattr(e, "db", None), getattr(e, "table", None)) for e in events
        }
        for rule, st in rules:
            if (rule.db, rule.table) in touched:
                self._evaluate(rule, st, now)

    def tick(self, now: int | None = None, *, all_rules: bool = False) -> None:
        """Wall-clock evaluation — the quiet-table path: a pending rule
        matures to firing (and a firing one resolves) even when no
        event arrives because traffic stopped. Only PENDING and FIRING
        rules evaluate by default: an inactive/resolved rule can only
        change on a breach, which requires new data, which publishes an
        event — re-running every rule's query per tick would be the
        per-poll cost the push plane exists to retire (`all_rules=True`
        restores the sweep for event-less deployments). Unlike the
        event path, `now=None` here resolves to the WALL clock — the
        whole point of the tick is that real time kept moving."""
        now = int(time.time()) if now is None else int(now)
        with self._lock:
            rules = list(self._rules.values())
        for rule, st in rules:
            # st.state iterates the series map — _eval_lock, like every
            # other series read (the bus thread mutates it mid-eval)
            with self._eval_lock:
                wanted = all_rules or st.state in (STATE_PENDING, STATE_FIRING)
            if wanted:
                self._evaluate(rule, st, now)

    def evaluate_rule(self, name: str, *, now: int | None = None):
        with self._lock:
            rule, st = self._rules[name]
        return self._evaluate(rule, st, now)

    def _query_series(
        self, rule: AlertRule, now: int
    ) -> list[tuple[tuple, dict, float, bool]]:
        """→ [(series_key, labels, value, partial)] — one entry per
        returned series (Prometheus alert semantics: every label set
        gets its own state machine). SQL rules produce one anonymous
        series from the first numeric cell; no rows → empty list (no
        data → no breach for every known series)."""
        if rule.engine == "promql":
            from .promql import query_instant

            rows = query_instant(
                self.store, rule.query, int(now), lookback_s=rule.lookback_s,
                db=rule.db, table=rule.table, live=self.live,
            )
            return [
                (tuple(sorted(r["labels"].items())), r["labels"],
                 float(r["value"]), bool(r.get("partial")))
                for r in rows
            ]
        from .engine import QueryEngine

        engine = QueryEngine(self.store, live=self.live, cache=False, device=self.device)
        res = engine.execute(rule.query)
        if not res.rows:
            return []
        for c in res.columns:
            try:
                return [((), {}, float(res.values[c][0]), bool(res.partial))]
            except (TypeError, ValueError):
                continue
        return []

    def _evaluate(self, rule: AlertRule, st: _RuleState, now: int | None):
        # now=None (an event batch with no data-timed event, e.g. pure
        # SnapshotAdvanced/ProfileSnapshot): re-evaluate at the rule's
        # LAST data time — under replay the wall clock is far from the
        # data and would silently resolve a firing rule over an empty
        # range
        with self._eval_lock:
            if now is None:
                now = st.last_eval or int(time.time())
            now = int(now)
            try:
                with self.tracer.span(SPAN_ALERT_EVAL):
                    series = self._query_series(rule, now)
            except Exception:
                st.eval_errors += 1
                with self._lock:
                    self.counters["eval_errors"] += 1
                return st.state
            st.evals += 1
            st.last_eval = now
            st.last_partial = any(p for *_, p in series)
            with self._lock:
                self.counters["evals"] += 1
            seen: set[tuple] = set()
            for key, labels, value, partial in series:
                ss = st.series.get(key)
                if ss is None:
                    if len(st.series) >= st.MAX_SERIES:
                        st.series_dropped += 1
                        continue
                    ss = st.series[key] = _SeriesState(labels)
                seen.add(key)
                ss.last_value = value
                ss.last_partial = partial
                ss.last_seen = now
                breach = _COMPARATORS[rule.comparator](value, rule.threshold)
                self._transition(rule, ss, breach, now)
            # series with no data this evaluation: no breach (a silent
            # series resolves rather than pages) — then GC so label
            # churn cannot poison the bounded map: inactive ones leave
            # immediately, RESOLVED ones after RESOLVED_RETENTION_S of
            # silence (they hold only flap memory by then — left
            # forever, 512 churned once-fired series would permanently
            # block every NEW label set from alerting)
            for key, ss in list(st.series.items()):
                if key in seen:
                    continue
                ss.last_value = None
                self._transition(rule, ss, False, now)
                if ss.state == STATE_INACTIVE or (
                    ss.state == STATE_RESOLVED
                    and now - max(ss.last_seen, ss.last_transition)
                    >= self.RESOLVED_RETENTION_S
                ):
                    st._transitions_base += ss.transitions
                    st._last_transition_base = max(
                        st._last_transition_base, ss.last_transition
                    )
                    del st.series[key]
            return st.state

    def _transition(self, rule: AlertRule, ss: _SeriesState, breach: bool,
                    now: int) -> str:
        old = ss.state
        if breach:
            if ss.state in (STATE_INACTIVE, STATE_RESOLVED):
                ss.state = STATE_PENDING
                ss.pending_since = now
            if ss.state == STATE_PENDING and now - ss.pending_since >= rule.for_s:
                ss.state = STATE_FIRING
        else:
            if ss.state == STATE_PENDING:
                # never matured: fall back quietly, no notification
                ss.state = STATE_RESOLVED if ss.fired_before else STATE_INACTIVE
                ss.pending_since = None
            elif ss.state == STATE_FIRING:
                ss.state = STATE_RESOLVED
                ss.pending_since = None
        if ss.state != old:
            ss.transitions += 1
            ss.last_transition = now
            with self._lock:
                self.counters["transitions"] += 1
            if ss.state == STATE_FIRING:
                ss.fired_before = True
                self._notify(rule, ss, STATE_FIRING, now)
            elif ss.state == STATE_RESOLVED and old == STATE_FIRING:
                self._notify(rule, ss, STATE_RESOLVED, now)
        return ss.state

    def _notify(self, rule: AlertRule, ss: _SeriesState, state: str, now: int):
        event = {
            "rule": rule.name,
            "state": state,
            "value": ss.last_value,
            "comparator": rule.comparator,
            "threshold": rule.threshold,
            "time": now,
            "held_s": (now - ss.pending_since) if ss.pending_since else 0,
            "partial": ss.last_partial,
            # rule labels + the firing series' own label set — a pager
            # line names WHICH series fired, not just which rule
            "labels": {**dict(rule.labels), **ss.labels},
        }
        with self._lock:
            sinks = [s for s in self._sinks if not s.detached]
            self.counters["notifications"] += 1
        for s in sinks:
            try:
                s.fn(event)
            except Exception:
                s.failures += 1
                with self._lock:
                    self.counters["sink_errors"] += 1
                if s.failures >= self.MAX_SINK_FAILURES:
                    s.detached = True
                    with self._lock:
                        self.counters["sinks_detached"] += 1
                        if s in self._sinks:
                            self._sinks.remove(s)
                    _log.exception(
                        "alert engine %s: notification sink %s detached "
                        "after %d consecutive failures",
                        self.name, s.name, s.failures,
                    )
            else:
                s.failures = 0

    # -- read faces ------------------------------------------------------
    # Series maps are mutated by _evaluate under _eval_lock (inserts on
    # new label sets, deletes on GC); every reader that ITERATES one —
    # state()'s worst() rollup, list_rules, series_states, the
    # Countable face a ticking collector thread samples — must hold
    # _eval_lock too, or a concurrent evaluation turns the read into
    # "dictionary changed size during iteration". Lock order: _lock is
    # only ever taken INSIDE _eval_lock (never the reverse), so the
    # readers take _lock first standalone, release it, then _eval_lock.

    def state(self, name: str) -> str:
        with self._lock:
            st = self._rules[name][1]
        with self._eval_lock:
            return st.state

    def series_states(self, name: str) -> list[dict]:
        """Per-series detail for one rule (the Prometheus /api/v1/rules
        alerts shape): one row per tracked label set."""
        with self._lock:
            _, st = self._rules[name]
        with self._eval_lock:
            series = list(st.series.values())
        return [
            {
                "labels": dict(ss.labels),
                "state": ss.state,
                "value": ss.last_value,
                "partial": ss.last_partial,
                "transitions": ss.transitions,
                "last_transition": ss.last_transition,
            }
            for ss in series
        ]

    def list_rules(self) -> list[dict]:
        """The dfctl listing: one row per rule — the worst series'
        state/value as the rule-level rollup, per-series detail in
        `series`."""
        with self._lock:
            rules = list(self._rules.values())
        out = []
        for r, st in rules:
            with self._eval_lock:
                out.append(self._rule_row(r, st))
        return out

    def _rule_row(self, r: AlertRule, st: _RuleState) -> dict:
        worst = st.worst()
        return {
                "name": r.name,
                "query": r.query,
                "condition": f"{r.comparator} {r.threshold}",
                "for_s": r.for_s,
                "state": st.state,
                "value": None if worst is None else worst.last_value,
                "partial": st.last_partial,
                "evals": st.evals,
                "transitions": st.transitions,
                # GC'd series fold their newest transition into the
                # base so the rule-level stamp never regresses to 0
                # while transitions stays > 0
                "last_transition": max(
                    max((ss.last_transition for ss in st.series.values()),
                        default=0),
                    st._last_transition_base,
                ),
                "series": [
                    {
                        "labels": dict(ss.labels),
                        "state": ss.state,
                        "value": ss.last_value,
                        "transitions": ss.transitions,
                    }
                    for ss in st.series.values()
                ],
            }

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            rules = list(self._rules.values())
        out["rules"] = len(rules)
        with self._eval_lock:
            # rule-level rollups (a rule counts as firing when ANY of
            # its series fires) + the total tracked-series accounting —
            # all series-map iteration, hence under the eval lock (the
            # collector tick thread samples this mid-evaluation)
            out["firing"] = sum(st.state == STATE_FIRING for _, st in rules)
            out["pending"] = sum(st.state == STATE_PENDING for _, st in rules)
            out["series"] = sum(len(st.series) for _, st in rules)
            out["series_dropped"] = sum(st.series_dropped for _, st in rules)
            for r, st in rules:
                slug = _NAME_SAN_RE.sub("_", r.name)
                out[f"rule_{slug}_state_code"] = STATE_CODES[st.state]
                out[f"rule_{slug}_transitions"] = st.transitions
                out[f"rule_{slug}_firing_series"] = sum(
                    ss.state == STATE_FIRING for ss in st.series.values()
                )
        return out
