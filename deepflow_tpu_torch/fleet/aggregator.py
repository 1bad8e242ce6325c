"""FleetAggregator — cross-host telemetry fan-in with one queryable pane.

A TCP listener (same reassembly stance as `HandoffReceiver`) receives
one `FleetFrame` per host per tick and merges IN THE SUMMARY DOMAIN:

  * counters — latest cumulative sample per host, summed across live
    hosts at read time, keyed by (module, tags-minus-host, field); the
    per-host rows additionally land in a fleet-level `deepflow_system`
    store with `host`/`group` labels, so the EXISTING SQL + PromQL
    queriers, subscriptions and alert engine serve fleet-wide queries
    unchanged,
  * log-hists — sparse `(bin, count)` dumps summed bin-for-bin across
    hosts (histograms add; quantile summaries don't — the
    sketch-plane algebra), pinned BIT-EXACT against the per-host-dump oracle by the
    mesh proof,
  * alert states — worst-rolled-up per rule across hosts
    (`querier.alerts.worst_state` severity ordering).

Staleness is explicit, never silent: each host carries a last-seen
stamp; a host quiet past `expiry_s` EXPIRES — excluded from every
merged view with the exclusion COUNTED (`stale_drops`, one per read
that skipped it; `hosts_expired` on the transition) and its last-seen
stamp still served on the `hosts()` pane. A frame from an expired
host recovers it (counted).

Built-in skew surfaces ride the Countable face (`tpu_fleet`) and the
`health()` / `hosts()` / `skew()` panes:
  * freshness-lag skew — max−min of per-host current lag,
  * HBM imbalance — max−min (and max/mean) of per-host ledger bytes,
  * rate divergence — max−min of per-group ingest rate, measured from
    consecutive frames' cumulative counters.

Aggregator work per tick is O(hosts × lanes), independent of how many
raw samples each host ingested.
"""

from __future__ import annotations

import socket
import threading
import time

from ..ingest.framing import FrameReassembler
from ..utils.stats import StatsPoint, register_countable
from .frame import decode_fleet_frame

#: counter field used for the per-group rate-divergence surface
DEFAULT_RATE_FIELD = "flow_in"


class _HostState:
    __slots__ = (
        "host", "groups", "epoch", "seq", "last_seen", "frame_ts",
        "frames", "points", "hists", "alerts", "hbm", "census",
        "expired", "rate_prev", "rates",
    )

    def __init__(self, host: str):
        self.host = host
        self.groups: set[str] = set()
        self.epoch = 0
        self.seq = -1
        self.last_seen = 0.0
        self.frame_ts = 0.0
        self.frames = 0
        self.points: tuple = ()
        self.hists: dict = {}
        self.alerts: tuple = ()
        self.hbm: tuple = ()
        self.census: dict = {}
        self.expired = False
        # per-group (t, cumulative value) for the rate surface
        self.rate_prev: dict[str, tuple[float, float]] = {}
        self.rates: dict[str, float] = {}


def _counter_key(module: str, tags: dict, field: str) -> str:
    """Canonical merged-counter key: host label stripped (that is the
    merge axis), remaining tags packed in sorted order."""
    from ..integration.formats import pack_tags

    rest = {k: str(v) for k, v in tags.items() if k != "host"}
    return f"{module}{{{pack_tags(rest)}}}.{field}"


class FleetAggregator:
    """Receive, merge, store and expose fleet telemetry."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 store=None, bus=None, expiry_s: float = 60.0,
                 clock=time.time, rate_field: str = DEFAULT_RATE_FIELD,
                 autoregister: bool = True):
        self.host = host
        self.port = port
        self.store = store
        self.bus = bus
        self.expiry_s = float(expiry_s)
        self.clock = clock
        self.rate_field = rate_field
        self._hosts: dict[str, _HostState] = {}
        self._lock = threading.Lock()
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._running = False
        self.counters = {
            "frames_rx": 0, "bytes_rx": 0, "bad_frames": 0,
            "decode_errors": 0, "conns": 0, "store_rows": 0,
            "store_errors": 0, "hosts_expired": 0, "hosts_recovered": 0,
            "stale_drops": 0,
        }
        if store is not None:
            from ..integration.dfstats import ensure_system_table

            ensure_system_table(store)
        self._stats_src = (
            register_countable("tpu_fleet", self) if autoregister else None
        )

    # -- wire ------------------------------------------------------------
    def endpoint(self) -> tuple[str, int]:
        """The (host, port) every host's FleetSink dials."""
        return (self.host, self.port)

    def start(self) -> "FleetAggregator":
        self._running = True
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        self.port = s.getsockname()[1]
        s.listen(64)
        s.settimeout(0.5)  # close() does not wake accept() on Linux
        self._sock = s
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def stop(self) -> None:
        self._running = False
        if self._stats_src is not None:
            from ..utils.stats import default_collector

            default_collector.deregister(self._stats_src)
            self._stats_src = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in list(self._threads):
            t.join(timeout=2)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.5)
            self._count("conns")
            with self._lock:
                self._conns.add(conn)
                self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(
                target=self._conn_loop, args=(conn,), daemon=True
            )
            t.start()
            with self._lock:
                self._threads.append(t)

    def _conn_loop(self, conn: socket.socket) -> None:
        asm = FrameReassembler()
        seen_bad = 0
        try:
            while self._running:
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                if not chunk:
                    return
                for header, body in asm.feed(chunk):
                    nbytes = header.frame_size
                    try:
                        frame = decode_fleet_frame(header, body)
                    except Exception:
                        # counted, never fatal to the conn: one corrupt
                        # frame must not take down the fleet pane
                        self._count("decode_errors")
                        continue
                    self.ingest(frame, nbytes=nbytes)
                if asm.bad_frames != seen_bad:
                    self._count("bad_frames", asm.bad_frames - seen_bad)
                    seen_bad = asm.bad_frames
        except OSError:
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- merge -----------------------------------------------------------
    def ingest(self, frame, *, nbytes: int = 0) -> None:
        """Merge one decoded frame (also the in-process test seam).
        Frames carry CUMULATIVE faces, so per-host state is
        last-frame-wins; cross-host summation happens at read time."""
        now = self.clock()
        with self._lock:
            st = self._hosts.get(frame.host)
            if st is None:
                st = self._hosts[frame.host] = _HostState(frame.host)
            if st.expired:
                st.expired = False
                self.counters["hosts_recovered"] += 1
            st.last_seen = now
            st.frame_ts = frame.timestamp
            st.epoch = frame.epoch
            st.seq = frame.seq
            st.frames += 1
            if frame.group:
                st.groups.add(frame.group)
            st.points = frame.points
            # hist faces are cumulative too: replace per face, keep
            # faces a sparser later frame did not mention (a quiet lane
            # still counts in the merge)
            for face, lanes in frame.hists.items():
                st.hists[face] = lanes
            if frame.alerts:
                st.alerts = frame.alerts
            st.hbm = frame.hbm
            if frame.census:
                st.census = frame.census
            self.counters["frames_rx"] += 1
            self.counters["bytes_rx"] += nbytes
            self._update_rates(st, frame)
        if self.store is not None:
            self._store_frame(frame)

    def _update_rates(self, st: _HostState, frame) -> None:
        """Per-group ingest rate from consecutive cumulative counters
        (under self._lock)."""
        for ts, _module, tags, fields in frame.points:
            if self.rate_field not in fields:
                continue
            group = str(tags.get("group", frame.group or ""))
            val = float(fields[self.rate_field])
            prev = st.rate_prev.get(group)
            if prev is not None and ts > prev[0]:
                st.rates[group] = (val - prev[1]) / (ts - prev[0])
            st.rate_prev[group] = (float(ts), val)

    def _store_frame(self, frame) -> None:
        """Per-host counter rows → the fleet deepflow_system table, with
        host/group labels packed into the standard labels column — the
        existing SQL/PromQL/alert planes read them with zero changes."""
        from ..integration.dfstats import (
            DEEPFLOW_SYSTEM_DB,
            DEEPFLOW_SYSTEM_TABLE,
            points_to_system_columns,
        )

        extra = {"host": frame.host}
        if frame.group:
            extra["group"] = frame.group
        points = [
            StatsPoint(ts, module, tuple(sorted(
                (str(k), str(v)) for k, v in tags.items()
            )), dict(fields))
            for ts, module, tags, fields in frame.points
        ]
        if not points:
            return
        try:
            cols = points_to_system_columns(points, extra_tags=extra)
            n = len(cols["time"])
            if n:
                self.store.insert(
                    DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, cols
                )
                self._count("store_rows", n)
        except Exception:
            self._count("store_errors")

    # -- staleness -------------------------------------------------------
    def _live(self, now: float) -> list[_HostState]:
        """Live hosts, with expiry transitions + stale skips COUNTED
        (call under self._lock)."""
        live = []
        for st in self._hosts.values():
            if now - st.last_seen > self.expiry_s:
                if not st.expired:
                    st.expired = True
                    self.counters["hosts_expired"] += 1
                # a read is happening and this host's data is being
                # withheld — that is the "no silent stale reads" lane
                self.counters["stale_drops"] += 1
                continue
            live.append(st)
        return live

    # -- merged read faces ----------------------------------------------
    def merged_counters(self, now: float | None = None) -> dict:
        """Cross-host counter sums keyed `module{tags}.field` (host
        label stripped — it is the merge axis). Bit-exact: int sums
        stay ints."""
        now = self.clock() if now is None else now
        with self._lock:
            live = self._live(now)
            rows = [(st.points,) for st in live]
        out: dict[str, int | float] = {}
        for (points,) in rows:
            for _ts, module, tags, fields in points:
                for field, v in fields.items():
                    if not isinstance(v, (int, float)) or isinstance(v, bool):
                        continue
                    key = _counter_key(module, tags, field)
                    out[key] = out.get(key, 0) + v
        return out

    def merged_hists(self, now: float | None = None) -> dict:
        """Cross-host log-hist sums, `face.lane` → sorted nonzero
        [[bin, count], ...] — the same shape `hist_dump()` emits, so a
        fleet-level quantile read uses the identical algebra."""
        now = self.clock() if now is None else now
        with self._lock:
            live = self._live(now)
            dumps = [dict(st.hists) for st in live]
        acc: dict[str, dict[int, int]] = {}
        for hists in dumps:
            for face, lanes in hists.items():
                for lane, pairs in lanes.items():
                    tgt = acc.setdefault(f"{face}.{lane}", {})
                    for b, c in pairs:
                        tgt[int(b)] = tgt.get(int(b), 0) + int(c)
        return {
            key: [[b, tgt[b]] for b in sorted(tgt)]
            for key, tgt in sorted(acc.items())
        }

    def merged_alerts(self, now: float | None = None) -> list[dict]:
        """Per-rule worst state across live hosts (the fleet rollup)."""
        from ..querier.alerts import worst_state

        now = self.clock() if now is None else now
        with self._lock:
            live = self._live(now)
            rows = [(st.host, st.alerts) for st in live]
        rules: dict[str, dict] = {}
        for host, alerts in rows:
            for a in alerts:
                r = rules.setdefault(
                    a["name"], {"name": a["name"], "hosts": {}}
                )
                r["hosts"][host] = {
                    "state": a["state"], "value": a.get("value"),
                    "transitions": a.get("transitions", 0),
                }
        out = []
        for name in sorted(rules):
            r = rules[name]
            r["state"] = worst_state(
                h["state"] for h in r["hosts"].values()
            )
            out.append(r)
        return out

    # -- panes -----------------------------------------------------------
    def hosts(self, now: float | None = None) -> list[dict]:
        """Per-host roster: last-seen stamp always served, stale flagged
        loudly instead of dropped."""
        now = self.clock() if now is None else now
        with self._lock:
            self._live(now)  # refresh expiry transitions (counted)
            states = list(self._hosts.values())
            rows = [
                {
                    "host": st.host,
                    "groups": sorted(st.groups),
                    "epoch": st.epoch,
                    "frames": st.frames,
                    "last_seen": st.last_seen,
                    "age_s": round(max(now - st.last_seen, 0.0), 3),
                    "stale": st.expired,
                    "hbm_bytes": sum(
                        int(r.get("bytes", 0)) for r in st.hbm
                    ),
                    "census": dict(st.census),
                }
                for st in sorted(states, key=lambda s: s.host)
            ]
        return rows

    def skew(self, now: float | None = None) -> dict:
        """The built-in cross-host imbalance surfaces."""
        now = self.clock() if now is None else now
        with self._lock:
            live = self._live(now)
            lag = {}
            hbm = {}
            rates: dict[str, float] = {}
            wire_drops: dict[str, int] = {}
            wire_deliveries: dict[str, int] = {}
            for st in live:
                worst = 0.0
                wd = wdel = 0
                for _ts, module, _tags, fields in st.points:
                    if module.startswith("tpu_wire"):
                        # slow-consumer imbalance:
                        # every wire face — hub, router, publisher —
                        # reports drop/delivery lanes; summing them per
                        # host makes a host whose clients shed visible
                        # fleet-wide next to the lag/HBM skew lanes
                        for field, v in fields.items():
                            if not isinstance(v, (int, float)):
                                continue
                            if field in ("drops", "open_dropped",
                                         "shed_frames", "alerts_dropped"):
                                wd += int(v)
                            elif field in ("deliveries", "open_delivered"):
                                wdel += int(v)
                    if "freshness" not in module:
                        continue
                    for field, v in fields.items():
                        if field.endswith("_lag_ms") and isinstance(
                            v, (int, float)
                        ):
                            worst = max(worst, float(v))
                lag[st.host] = worst
                wire_drops[st.host] = wd
                wire_deliveries[st.host] = wdel
                hbm[st.host] = sum(int(r.get("bytes", 0)) for r in st.hbm)
                for g, r in st.rates.items():
                    rates[g] = rates.get(g, 0.0) + r
        def spread(d):
            return (max(d.values()) - min(d.values())) if d else 0.0
        hbm_mean = (sum(hbm.values()) / len(hbm)) if hbm else 0.0
        return {
            "hosts": len(lag),
            "freshness_lag_skew_ms": round(spread(lag), 3),
            "per_host_lag_ms": {h: round(v, 3) for h, v in lag.items()},
            "hbm_imbalance_bytes": int(spread(hbm)),
            "hbm_imbalance_ratio": round(
                (max(hbm.values()) / hbm_mean) if hbm_mean else 0.0, 4
            ),
            "per_host_hbm_bytes": hbm,
            "rate_divergence": round(spread(rates), 3),
            "per_group_rate": {g: round(r, 3) for g, r in rates.items()},
            "wire_drop_skew": int(spread(wire_drops)),
            "per_host_wire_drops": wire_drops,
            "per_host_wire_deliveries": wire_deliveries,
        }

    def health(self, now: float | None = None) -> dict:
        now = self.clock() if now is None else now
        with self._lock:
            live = self._live(now)
            n_hosts = len(self._hosts)
            n_live = len(live)
            last_rx = max(
                (st.last_seen for st in self._hosts.values()), default=0.0
            )
            c = dict(self.counters)
        alerts = self.merged_alerts(now)
        firing = sum(a["state"] == "firing" for a in alerts)
        return {
            "status": "ok" if n_live else "empty",
            "hosts": n_hosts,
            "live": n_live,
            "stale": n_hosts - n_live,
            "frames_rx": c["frames_rx"],
            "bytes_rx": c["bytes_rx"],
            "decode_errors": c["decode_errors"],
            "store_rows": c["store_rows"],
            "last_rx_age_s": round(max(now - last_rx, 0.0), 3)
            if last_rx else None,
            "rules": len(alerts),
            "rules_firing": firing,
        }

    # -- Countable --------------------------------------------------------
    def get_counters(self) -> dict[str, int | float]:
        """The `tpu_fleet` dogfood face: rx/merge accounting plus the
        skew gauges — pure summary math, fetch-free."""
        now = self.clock()
        sk = self.skew(now)
        with self._lock:
            out = dict(self.counters)
            n_hosts = len(self._hosts)
            n_stale = sum(st.expired for st in self._hosts.values())
        out["hosts"] = n_hosts
        out["hosts_stale"] = n_stale
        out["freshness_lag_skew_ms"] = sk["freshness_lag_skew_ms"]
        out["hbm_imbalance_bytes"] = sk["hbm_imbalance_bytes"]
        out["rate_divergence"] = sk["rate_divergence"]
        out["wire_drop_skew"] = sk["wire_drop_skew"]
        return out
