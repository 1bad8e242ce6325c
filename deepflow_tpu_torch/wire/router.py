"""FleetSubscriptionRouter — ONE upstream eval per query, N wire clients.

The aggregator-side half of the cross-host push fan-out (port copy of
deepflow_tpu/wire/router.py).
Pipeline hosts dial in (`publisher.WirePublisher`), say `hello`, and
the router subscribes each of them to every distinct query any wire
client is watching — exactly ONE `sub` per normalized query per host,
no matter how many clients watch it. Hosts push `result` frames (one
per local subscription eval, i.e. one per event batch) and the router
merges the per-host rows and fans the merged envelope out to N bounded
watcher queues. Fan-out cost is O(evals), never O(watchers × hosts).

Semantics:

  * **Dedup by normalized query** — `frame.normalize_query_spec`;
    the first watcher creates the entry (and the upstream subs), the
    last watcher's departure tears both down (`unsub` broadcast, no
    orphaned upstream evals).
  * **At-least-once upstream** — the publisher retains the in-flight
    frame across reconnects (HandoffSender stance), so the router
    dedups redelivery on `(host, query_id, seq)` (counted
    `dup_results`).
  * **Flushed supersedes partial** — a host's PARTIAL result for data
    time `now` never replaces a flushed result it already delivered
    for the same `now` (counted `partial_superseded`, no fan-out: the
    merged view did not move).
  * **Counted staleness** — a host connection dropping marks that
    host's rows stale in every entry and delivers a staleness notice
    to every watcher (counted, never silent); `hello` from the same
    host recovers it and re-sends the active subscription set, so
    reconnect resumes with no host-side bookkeeping.

Watchers are the EXISTING `querier.subscribe.Watcher` bounded queues —
same drop/lease/reap machinery as the local push plane; `reap()` here
covers router watchers the way `SubscriptionManager.reap()` covers
local ones. Countable face: `tpu_wire_router`.
"""

from __future__ import annotations

import socket
import threading
import time

from ..ingest.framing import FrameReassembler
from ..querier.subscribe import DEFAULT_WATCHER_QUEUE, Watcher
from ..utils.stats import register_countable
from .frame import (
    PushFrame,
    decode_push_frame,
    encode_push_frame,
    normalize_query_spec,
    query_id_for,
    spec_from_key,
)


class _RouterEntry:
    """One distinct query fleet-wide: its wire watchers + per-host
    latest-result state. `hosts[h]` = {"seq", "now", "partial",
    "series", "stale"}."""

    __slots__ = ("key", "query_id", "spec", "watchers", "hosts",
                 "merged_seq", "upstream_results", "deliveries", "drops",
                 "dup_results", "partial_superseded")

    def __init__(self, key: tuple):
        self.key = key
        self.query_id = query_id_for(key)
        self.spec = spec_from_key(key)
        self.watchers: list[Watcher] = []
        self.hosts: dict[str, dict] = {}
        self.merged_seq = 0
        self.upstream_results = 0
        self.deliveries = 0
        self.drops = 0
        self.dup_results = 0
        self.partial_superseded = 0


class _HostConn:
    __slots__ = ("host", "sock", "wlock", "connected", "last_seen",
                 "results", "hellos")

    def __init__(self, host: str, sock):
        self.host = host
        self.sock = sock
        self.wlock = threading.Lock()
        self.connected = True
        self.last_seen = 0.0
        self.results = 0
        self.hellos = 0


class FleetSubscriptionRouter:
    """TCP listener for WirePublisher uplinks + the fleet-wide
    subscription table. Start with `.start()`; wire clients attach via
    `watch(spec)` (usually through `hub.WireHub`)."""

    def __init__(self, *, host: str = "127.0.0.1", port: int = 0,
                 clock=time.time, name: str = "router"):
        self.host = host
        self.port = port
        self.name = name
        self._clock = clock
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._running = False
        self._lock = threading.Lock()  # entries/hosts maps + counters
        # serializes fan-out and watcher-list mutation (the
        # SubscriptionManager._eval_lock stance: an unguarded
        # check-then-remove pair double-reaps under concurrency)
        self._fan_lock = threading.RLock()
        self._entries: dict[tuple, _RouterEntry] = {}
        self._by_qid: dict[str, _RouterEntry] = {}
        self._hosts: dict[str, _HostConn] = {}
        self._alert_cbs: list = []
        self.counters = {
            "connections": 0,
            "hellos": 0,
            "frames_rx": 0,
            "decode_errors": 0,
            "results_rx": 0,
            "dup_results": 0,
            "unknown_results": 0,
            "partial_superseded": 0,
            "merged_evals": 0,
            "deliveries": 0,
            "drops": 0,
            "alerts_rx": 0,
            "alert_cb_errors": 0,
            "upstream_subs": 0,
            "upstream_unsubs": 0,
            "control_tx": 0,
            "control_errors": 0,
            "hosts_lost": 0,
            "hosts_recovered": 0,
            "staleness_notices": 0,
            "watchers_reaped": 0,
        }
        self._stats_src = register_countable("tpu_wire_router", self, name=name)

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetSubscriptionRouter":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(32)
        s.settimeout(0.5)
        self._sock = s
        self.port = s.getsockname()[1]
        self._running = True
        t = threading.Thread(target=self._accept_loop,
                             name=f"wire-router-{self.name}", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.host, self.port)

    def stop(self) -> None:
        self._running = False
        with self._lock:
            conns = list(self._hosts.values())
        for hc in conns:
            try:
                hc.sock.close()
            except OSError:
                pass
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- wire client face (the hub calls these) --------------------------
    def watch(self, spec: dict, *, maxlen: int = DEFAULT_WATCHER_QUEUE,
              lease_s: float | None = None) -> tuple[_RouterEntry, Watcher]:
        """Attach one wire watcher to the (deduped) entry for `spec`;
        the FIRST watcher for a distinct query broadcasts the upstream
        `sub` — later ones just join the fan-out."""
        key = normalize_query_spec(spec)
        broadcast = None
        with self._fan_lock:
            with self._lock:
                entry = self._entries.get(key)
                if entry is None:
                    entry = _RouterEntry(key)
                    self._entries[key] = entry
                    self._by_qid[entry.query_id] = entry
                    self.counters["upstream_subs"] += 1
                    broadcast = entry
            w = Watcher(None, maxlen=maxlen, lease_s=lease_s)
            entry.watchers.append(w)
        if broadcast is not None:
            self._broadcast_sub(broadcast)
        return entry, w

    def unwatch(self, entry: _RouterEntry, watcher: Watcher) -> None:
        """Detach one watcher; the LAST one tears the entry down and
        unsubscribes the fleet (no orphaned upstream evals)."""
        teardown = False
        with self._fan_lock:
            if watcher in entry.watchers:
                entry.watchers.remove(watcher)
            if not entry.watchers:
                with self._lock:
                    if self._entries.get(entry.key) is entry:
                        del self._entries[entry.key]
                        self._by_qid.pop(entry.query_id, None)
                        self.counters["upstream_unsubs"] += 1
                        teardown = True
        if teardown:
            frame = PushFrame(kind="unsub", query_id=entry.query_id)
            for hc in self._live_conns():
                self._send_control(hc, frame)

    def reap(self, now_monotonic: float | None = None) -> int:
        """Remove router watchers whose lease lapsed (same stance as
        SubscriptionManager.reap); empty entries unsubscribe upstream."""
        now = time.monotonic() if now_monotonic is None else now_monotonic
        reaped = 0
        with self._fan_lock:
            entries = list(self._entries.values())
            expired = [
                (e, w) for e in entries for w in list(e.watchers)
                if w.expired(now)
            ]
            for e, w in expired:
                self.unwatch(e, w)
                reaped += 1
        if reaped:
            self._count("watchers_reaped", reaped)
        return reaped

    def on_alert(self, cb) -> None:
        """Register a callback for remote `alert` frames (the hub fans
        them to its `alerts=1` wire watchers)."""
        with self._lock:
            self._alert_cbs.append(cb)

    # -- read faces ------------------------------------------------------
    def hosts(self) -> list[dict]:
        with self._lock:
            return [
                {
                    "host": hc.host,
                    "connected": hc.connected,
                    "last_seen": hc.last_seen,
                    "results": hc.results,
                    "hellos": hc.hellos,
                }
                for hc in self._hosts.values()
            ]

    def entries(self) -> list[dict]:
        with self._fan_lock:
            return [
                {
                    "query_id": e.query_id,
                    "kind": e.spec["kind"],
                    "query": e.spec["query"],
                    "watchers": len(e.watchers),
                    "hosts": len(e.hosts),
                    "upstream_results": e.upstream_results,
                    "merged_seq": e.merged_seq,
                    "deliveries": e.deliveries,
                    "drops": e.drops,
                    "dup_results": e.dup_results,
                    "partial_superseded": e.partial_superseded,
                }
                for e in self._entries.values()
            ]

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["queries"] = len(self._entries)
            out["hosts"] = len(self._hosts)
            out["hosts_connected"] = sum(
                1 for hc in self._hosts.values() if hc.connected
            )
        with self._fan_lock:
            out["watchers"] = sum(
                len(e.watchers) for e in self._by_qid.values()
            )
        return out

    # -- control plane (router → host) -----------------------------------
    def _live_conns(self) -> list[_HostConn]:
        with self._lock:
            return [hc for hc in self._hosts.values() if hc.connected]

    def _broadcast_sub(self, entry: _RouterEntry) -> None:
        frame = PushFrame(kind="sub", query_id=entry.query_id,
                          body=dict(entry.spec))
        for hc in self._live_conns():
            self._send_control(hc, frame)

    def _send_control(self, hc: _HostConn, frame: PushFrame) -> None:
        buf = encode_push_frame(frame)
        try:
            with hc.wlock:
                hc.sock.sendall(buf)
            self._count("control_tx")
        except OSError:
            # the conn loop owns disconnect bookkeeping; reconnect
            # re-sends the whole active set on hello anyway
            self._count("control_errors")

    # -- uplink (host → router) ------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(0.5)
            self._count("connections")
            t = threading.Thread(
                target=self._conn_loop, args=(conn, addr),
                name=f"wire-router-conn-{addr[1]}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket, addr) -> None:
        reasm = FrameReassembler()
        hc: _HostConn | None = None
        try:
            while self._running:
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                for header, body in reasm.feed(chunk):
                    self._count("frames_rx")
                    try:
                        frame = decode_push_frame(header, body)
                    except (ValueError, KeyError, TypeError):
                        self._count("decode_errors")
                        continue
                    hc = self._dispatch(frame, conn, hc)
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if hc is not None:
                self._host_lost(hc, conn)

    def _dispatch(self, frame: PushFrame, conn, hc: _HostConn | None):
        if frame.kind == "hello":
            return self._on_hello(frame, conn)
        if hc is None:
            # results before hello: identity unknown — count, drop
            self._count("decode_errors")
            return None
        hc.last_seen = self._clock()
        if frame.kind == "result":
            hc.results += 1
            self._on_result(hc.host, frame)
        elif frame.kind == "alert":
            self._on_alert_frame(hc.host, frame)
        else:
            self._count("decode_errors")
        return hc

    def _on_hello(self, frame: PushFrame, conn) -> _HostConn:
        host = frame.host or "?"
        with self._lock:
            prev = self._hosts.get(host)
            hc = _HostConn(host, conn)
            hc.hellos = (prev.hellos if prev else 0) + 1
            hc.results = prev.results if prev else 0
            hc.last_seen = self._clock()
            self._hosts[host] = hc
            recovered = prev is not None
            self.counters["hellos"] += 1
            if recovered:
                self.counters["hosts_recovered"] += 1
        if prev is not None and prev.sock is not conn:
            try:
                prev.sock.close()
            except OSError:
                pass
        # (re)send the active subscription set: reconnect resumes with
        # zero host-side state
        with self._lock:
            entries = list(self._entries.values())
        for entry in entries:
            self._send_control(hc, PushFrame(
                kind="sub", query_id=entry.query_id, body=dict(entry.spec)
            ))
        return hc

    def _host_lost(self, hc: _HostConn, conn) -> None:
        """Connection gone: mark stale + notify watchers (counted)."""
        with self._lock:
            cur = self._hosts.get(hc.host)
            if cur is not hc:
                return  # a newer hello superseded this conn already
            hc.connected = False
            self.counters["hosts_lost"] += 1
        notice_base = {"type": "staleness", "host": hc.host}
        with self._fan_lock:
            entries = [
                e for e in self._entries.values() if hc.host in e.hosts
            ]
            for e in entries:
                e.hosts[hc.host]["stale"] = True
                notice = dict(notice_base)
                notice["query_id"] = e.query_id
                n = drops = 0
                for w in list(e.watchers):
                    d0 = w.dropped
                    w.deliver(notice, None)
                    drops += w.dropped - d0
                    n += 1
                if n:
                    self._count("staleness_notices", n)
                e.drops += drops
                if drops:
                    self._count("drops", drops)

    def _on_result(self, host: str, frame: PushFrame) -> None:
        with self._lock:
            entry = self._by_qid.get(frame.query_id)
        if entry is None:
            self._count("unknown_results")
            return
        body = frame.body
        now = int(body.get("now", 0))
        partial = bool(body.get("partial", False))
        with self._fan_lock:
            hs = entry.hosts.get(host)
            if hs is not None and frame.seq <= hs["seq"]:
                # at-least-once redelivery across a reconnect
                entry.dup_results += 1
                self._count("dup_results")
                return
            if (hs is not None and partial and not hs["partial"]
                    and now <= hs["now"]):
                # flushed supersedes partial: the merged view did not
                # move — record the seq (it IS consumed) and skip
                hs["seq"] = frame.seq
                entry.partial_superseded += 1
                self._count("partial_superseded")
                return
            entry.hosts[host] = {
                "seq": frame.seq,
                "now": now,
                "partial": partial,
                "series": body.get("series"),
                "stale": False,
            }
            entry.upstream_results += 1
            self._count("results_rx")
            self._fan_out(entry)

    def _fan_out(self, entry: _RouterEntry) -> None:
        """Build ONE merged envelope from the entry's per-host state and
        deliver it to every watcher (called under _fan_lock)."""
        entry.merged_seq += 1
        hosts = {
            h: {
                "seq": hs["seq"],
                "now": hs["now"],
                "partial": hs["partial"],
                "stale": hs["stale"],
                "series": hs["series"],
            }
            for h, hs in entry.hosts.items()
        }
        merged = []
        for h in sorted(hosts):
            series = hosts[h]["series"]
            if isinstance(series, list):
                for s in series:
                    if isinstance(s, dict):
                        s = dict(s)
                        metric = dict(s.get("metric") or {})
                        metric["host"] = h
                        s["metric"] = metric
                    merged.append(s)
        envelope = {
            "type": "result",
            "query_id": entry.query_id,
            "kind": entry.spec["kind"],
            "query": entry.spec["query"],
            "seq": entry.merged_seq,
            "now": max((hs["now"] for hs in hosts.values()), default=0),
            "hosts": hosts,
            "merged": merged,
        }
        self._count("merged_evals")
        delivered = drops = 0
        for w in list(entry.watchers):
            d0 = w.dropped
            w.deliver(envelope, None)
            drops += w.dropped - d0
            delivered += 1
        entry.deliveries += delivered
        entry.drops += drops
        self._count("deliveries", delivered)
        if drops:
            self._count("drops", drops)

    def _on_alert_frame(self, host: str, frame: PushFrame) -> None:
        self._count("alerts_rx")
        event = dict(frame.body)
        event.setdefault("host", host)
        with self._lock:
            cbs = list(self._alert_cbs)
        for cb in cbs:
            try:
                cb(event)
            except Exception:
                self._count("alert_cb_errors")


__all__ = ["FleetSubscriptionRouter"]
