"""WireHub — the wire delivery plane's serving half (port copy of
deepflow_tpu/wire/hub.py).

Maps each wire client — an SSE stream off the RestServer
(`GET /v1/watch?...`), a framed-TCP connection (`WireListener`), or an
in-process stream (`open_stream`) — onto ONE bounded `Watcher` queue
from the EXISTING push plane. Nothing new is invented for flow
control, drops, or liveness:

  connection → queue → lease state machine

  * OPEN     — `open_stream` attaches a queue-mode `Watcher` to the
    query's (deduped) subscription: local `SubscriptionManager` for
    `scope=local`, `FleetSubscriptionRouter` entry for fleet queries,
    the hub's alert topic for `alerts=1`. Queue bounds ARE the
    per-client flow control: a slow client drops ITS OWN oldest
    results (counted on its watcher), never a sibling's.
  * DELIVER  — the serve loop polls with `renew=False` (the pop proves
    nothing about the client) and renews the lease only after a
    successful socket write — delivery IS the heartbeat; idle streams
    renew on successful `: hb` keepalive writes instead.
  * LAPSE    — a client that vanished mid-silence stops renewing; the
    manager/router/hub `reap()` removes the watcher after `lease_s`
    (counted) and the serve loop notices and ends. A client that
    vanished mid-WRITE is caught immediately (BrokenPipe/
    ConnectionReset contained + counted, never kills the handler
    thread) and unwatched on the spot — lease lapse is the backstop
    for silently-wedged transports, not the common path.
  * CLOSE    — `close_conn` detaches the watcher from whatever it was
    attached to; no orphaned queues (the queue dies with the watcher,
    and a fleet entry whose last watcher left unsubscribes upstream).

Countable face: `tpu_wire` — aggregate counters plus per-connection
rows via `connections()` (surfaced on `GET /v1/wire` and, as skew
lanes, in `GET /v1/fleet/skew`).
"""

from __future__ import annotations

import itertools
import json
import select
import socket
import threading
import time

from ..querier.subscribe import DEFAULT_WATCHER_QUEUE, Watcher
from ..utils.stats import register_countable
from .frame import PushFrame, decode_push_frame, encode_push_frame
from .publisher import result_to_jsonable

DEFAULT_LEASE_S = 30.0

_conn_ids = itertools.count(1)


class WireConnection:
    """One wire client: a Watcher plus the detach recipe for whatever
    plane it is attached to."""

    __slots__ = ("id", "transport", "topic", "query", "query_id",
                 "watcher", "opened", "closed", "_detach")

    def __init__(self, *, transport: str, topic: str, query: str,
                 query_id: str, watcher: Watcher, detach):
        self.id = next(_conn_ids)
        self.transport = transport  # "sse" | "tcp" | "local"
        self.topic = topic  # "promql" | "sql" | "alerts"
        self.query = query
        self.query_id = query_id
        self.watcher = watcher
        self.opened = time.monotonic()
        self.closed = False
        self._detach = detach

    def poll(self):
        """Pop WITHOUT renewing — only a successful write renews."""
        return self.watcher.poll(renew=False)

    def renew(self) -> None:
        self.watcher.renew()


class WireHub:
    def __init__(self, subscriptions, *, alerts=None, router=None,
                 bus=None, lease_s: float | None = DEFAULT_LEASE_S,
                 maxlen: int = DEFAULT_WATCHER_QUEUE, name: str = "wire"):
        self._subs = subscriptions
        self._alerts = alerts
        self.router = router
        self._bus = bus
        self.lease_s = lease_s
        self.maxlen = maxlen
        self.name = name
        self._lock = threading.Lock()
        self._conns: dict[int, WireConnection] = {}
        self._alert_watchers: list[Watcher] = []
        self._closing = False
        self.counters = {
            "connections_total": 0,
            "sse_connections": 0,
            "tcp_connections": 0,
            "deliveries": 0,
            "drops": 0,
            "heartbeats": 0,
            "disconnects": 0,
            "mid_write_disconnects": 0,
            "reaps": 0,
            "alerts_delivered": 0,
            "alerts_dropped": 0,
            "open_errors": 0,
        }
        self._alert_sink = None
        if alerts is not None:
            from ..querier.alerts import wire_notification_sink

            self._alert_sink = alerts.add_sink(
                wire_notification_sink(self), name=f"wire:{name}"
            )
        if router is not None:
            router.on_alert(self.deliver_alert)
        self._stats_src = register_countable("tpu_wire", self, name=name)

    # -- stream lifecycle ------------------------------------------------
    def open_stream(self, *, promql: str | None = None,
                    sql: str | None = None, alerts: bool = False,
                    scope: str = "auto", span_s: int = 60, step: int = 1,
                    db: str = "deepflow_system", table: str = "deepflow_system",
                    lookback_s: int = 300, maxlen: int | None = None,
                    lease_s: float | None = None,
                    transport: str = "local") -> WireConnection:
        """Attach one wire client; returns the connection. Exactly one
        of promql/sql/alerts selects the topic. `scope="fleet"` (or
        "auto" with a router attached) rides the FleetSubscriptionRouter
        — ONE upstream subscription per distinct query fleet-wide;
        `scope="local"` evaluates on this process's store."""
        maxlen = self.maxlen if maxlen is None else int(maxlen)
        lease = self.lease_s if lease_s is None else lease_s
        if sum(x is not None and x != "" for x in (promql, sql)) + bool(alerts) != 1:
            raise ValueError(
                "exactly one of promql=, sql=, alerts=1 selects the topic"
            )
        if alerts:
            w = Watcher(None, maxlen=maxlen, lease_s=lease)
            with self._lock:
                self._alert_watchers.append(w)

            def detach():
                with self._lock:
                    if w in self._alert_watchers:
                        self._alert_watchers.remove(w)

            conn = WireConnection(
                transport=transport, topic="alerts", query="alerts",
                query_id="", watcher=w, detach=detach,
            )
        else:
            kind = "promql" if promql is not None else "sql"
            query = promql if promql is not None else sql
            fleet = self.router is not None and scope != "local"
            if scope == "fleet" and self.router is None:
                raise ValueError("no fleet router on this server")
            if fleet and kind == "sql":
                if scope == "fleet":
                    raise ValueError(
                        "sql subscriptions are local-only; fleet scope "
                        "takes promql"
                    )
                fleet = False  # auto: sql falls back to the local store
            if fleet:
                spec = {"kind": kind, "query": query, "db": db,
                        "table": table, "span_s": span_s, "step": step,
                        "lookback_s": lookback_s}
                entry, w = self.router.watch(
                    spec, maxlen=maxlen, lease_s=lease
                )
                detach = lambda: self.router.unwatch(entry, w)  # noqa: E731
                qid = entry.query_id
            else:
                if kind == "sql":
                    sub, w = self._subs.subscribe_sql(
                        query, queue=True, maxlen=maxlen, lease_s=lease
                    )
                else:
                    sub, w = self._subs.subscribe_promql(
                        query, span_s=int(span_s), step=int(step), db=db,
                        table=table, lookback_s=int(lookback_s),
                        queue=True, maxlen=maxlen, lease_s=lease,
                    )
                qid = ""

                def detach(sub=sub, w=w):
                    sub.unwatch(w)
                    if not sub.watchers:
                        # a transient dashboard client must not leave a
                        # standing eval behind (cache-warming subs are
                        # registered deliberately, not by disconnect)
                        self._subs.unsubscribe(sub)

            conn = WireConnection(
                transport=transport, topic=kind, query=query,
                query_id=qid, watcher=w, detach=detach,
            )
        with self._lock:
            self._conns[conn.id] = conn
            self.counters["connections_total"] += 1
            if transport == "sse":
                self.counters["sse_connections"] += 1
            elif transport == "tcp":
                self.counters["tcp_connections"] += 1
        return conn

    def close_conn(self, conn: WireConnection, *, reason: str = "close") -> None:
        with self._lock:
            if conn.closed:
                return
            conn.closed = True
            self._conns.pop(conn.id, None)
            # fold the departing connection's drops into the lifetime
            # total (open connections report theirs via open_dropped)
            self.counters["drops"] += conn.watcher.dropped
            if reason == "disconnect":
                self.counters["disconnects"] += 1
            elif reason == "lease":
                self.counters["reaps"] += 1
        try:
            conn._detach()
        except Exception:
            pass

    def reap(self, now_monotonic: float | None = None) -> int:
        """Lease sweep for everything the hub owns: alert-topic
        watchers, fleet router watchers (via router.reap), and stream
        records whose watcher lapsed. Local-subscription watchers are
        ALSO reaped by SubscriptionManager.reap — this pass closes the
        hub's connection record for them."""
        now = time.monotonic() if now_monotonic is None else now_monotonic
        reaped = 0
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            if conn.watcher.expired(now):
                self.close_conn(conn, reason="lease")
                reaped += 1
        with self._lock:
            expired = [w for w in self._alert_watchers if w.expired(now)]
            for w in expired:
                self._alert_watchers.remove(w)
                # not conn-tracked (open_stream alert watchers are); a
                # bare expired alert watcher still counts as a reap
                self.counters["reaps"] += 1
                reaped += 1
        if self.router is not None:
            self.router.reap(now)
        return reaped

    def close(self) -> None:
        self._closing = True
        if self._alert_sink is not None:
            self._alert_sink.detached = True
            self._alert_sink = None
        with self._lock:
            conns = list(self._conns.values())
        for conn in conns:
            self.close_conn(conn)
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    # -- alert topic -----------------------------------------------------
    def deliver_alert(self, event: dict) -> None:
        """Fan one alert notification to every alerts-topic watcher
        (local engine sink AND remote `alert` frames land here)."""
        with self._lock:
            watchers = list(self._alert_watchers)
        delivered = dropped = 0
        for w in watchers:
            d0 = w.dropped
            w.deliver(dict(event), None)
            dropped += w.dropped - d0
            delivered += 1
        with self._lock:
            self.counters["alerts_delivered"] += delivered
            self.counters["alerts_dropped"] += dropped
        if self._bus is not None:
            from ..querier.events import AlertFired

            labels = event.get("labels") or {}
            self._bus.publish(AlertFired(
                rule=str(event.get("rule", "?")),
                state=str(event.get("state", "?")),
                value=float(event.get("value") or 0.0),
                labels=tuple(sorted(labels.items())),
                time=event.get("time"),
            ))

    # -- read faces ------------------------------------------------------
    def connections(self) -> list[dict]:
        now = time.monotonic()
        with self._lock:
            conns = list(self._conns.values())
        return [
            {
                "id": c.id,
                "transport": c.transport,
                "topic": c.topic,
                "query": c.query,
                "query_id": c.query_id,
                "delivered": c.watcher.delivered,
                "dropped": c.watcher.dropped,
                "queue_depth": len(c.watcher.queue or ()),
                "lease_s": c.watcher.lease_s,
                "age_s": round(now - c.opened, 3),
                "expired": c.watcher.expired(now),
            }
            for c in conns
        ]

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            conns = list(self._conns.values())
            out["alert_watchers"] = len(self._alert_watchers)
        out["connections_open"] = len(conns)
        # the skew lanes fleet/skew scans for (per-host wire imbalance):
        # live per-connection sums ride the same names as the totals
        out["open_delivered"] = sum(c.watcher.delivered for c in conns)
        out["open_dropped"] = sum(c.watcher.dropped for c in conns)
        return out

    # -- SSE serving -----------------------------------------------------
    def serve_sse(self, h, q: dict) -> None:
        """Serve `GET /v1/watch` on a RestServer handler `h` with query
        params `q`. Chunked-style SSE: `data: <json>\\n\\n` per result,
        `: hb\\n\\n` keepalives, until the client disconnects, the
        lease lapses, `max_events` is reached, or the hub closes."""
        try:
            conn = self.open_stream(
                promql=q.get("promql"),
                sql=q.get("sql"),
                alerts=(q.get("alerts") or "0") not in ("0", "", "false"),
                scope=q.get("scope", "auto"),
                span_s=int(q.get("span_s") or 60),
                step=int(q.get("step") or 1),
                db=q.get("db") or "deepflow_system",
                table=q.get("table") or "deepflow_system",
                lookback_s=int(q.get("lookback_s") or 300),
                maxlen=int(q["maxlen"]) if q.get("maxlen") else None,
                lease_s=float(q["lease_s"]) if q.get("lease_s") else None,
                transport="sse",
            )
        except ValueError as e:
            with self._lock:
                self.counters["open_errors"] += 1
            h._json({"error": str(e)}, 400)
            return
        max_events = int(q.get("max_events") or 0)
        heartbeat_s = float(q.get("heartbeat_s") or 5.0)
        poll_s = 0.02
        h.send_response(200)
        h.send_header("Content-Type", "text/event-stream")
        h.send_header("Cache-Control", "no-cache")
        h.send_header("X-Accel-Buffering", "no")
        h.end_headers()
        sent = 0
        last_write = time.monotonic()
        reason = "disconnect"
        try:
            while True:
                if self._closing or conn.closed:
                    reason = "close" if not conn.closed else "lease"
                    break
                item = conn.poll()
                if item is None:
                    now = time.monotonic()
                    if now - last_write >= heartbeat_s:
                        h.wfile.write(b": hb\n\n")
                        h.wfile.flush()
                        conn.renew()
                        last_write = now
                        with self._lock:
                            self.counters["heartbeats"] += 1
                    time.sleep(poll_s)
                    continue
                payload = json.dumps(
                    result_to_jsonable(item), default=str
                ).encode()
                h.wfile.write(b"data: " + payload + b"\n\n")
                h.wfile.flush()
                # a successful write IS the client's heartbeat
                conn.renew()
                last_write = time.monotonic()
                sent += 1
                with self._lock:
                    self.counters["deliveries"] += 1
                if max_events and sent >= max_events:
                    reason = "close"
                    break
        except (BrokenPipeError, ConnectionResetError, OSError):
            # client vanished mid-write: contained and counted — the
            # handler thread survives; the watcher detaches on the spot
            # (lease lapse is only the backstop for wedged transports)
            with self._lock:
                self.counters["mid_write_disconnects"] += 1
            reason = "disconnect"
        finally:
            self.close_conn(conn, reason=reason)


class WireListener:
    """The framed-TCP variant of the SSE lane (the UniformSender/
    handoff stance): a client connects, sends ONE `sub` PushFrame whose
    body is an open_stream spec, and receives `result` frames (body =
    {"payload": ...}) with `hello` keepalives — same watcher queue,
    lease, drop, and containment semantics as SSE."""

    def __init__(self, hub: WireHub, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.hub = hub
        self.host = host
        self.port = port
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._running = False

    def start(self) -> "WireListener":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(32)
        s.settimeout(0.5)
        self._sock = s
        self.port = s.getsockname()[1]
        self._running = True
        t = threading.Thread(target=self._accept_loop,
                             name="wire-listener", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    @property
    def endpoint(self) -> tuple[str, int]:
        return (self.host, self.port)

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5.0)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve_conn, args=(conn,),
                name=f"wire-tcp-{addr[1]}", daemon=True,
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, sock: socket.socket) -> None:
        from ..ingest.framing import FrameReassembler

        hub = self.hub
        reasm = FrameReassembler()
        stream = None
        try:
            sock.settimeout(5.0)
            sub = None
            while sub is None:
                chunk = sock.recv(1 << 16)
                if not chunk:
                    return
                for header, body in reasm.feed(chunk):
                    frame = decode_push_frame(header, body)
                    if frame.kind == "sub":
                        sub = frame
                        break
            spec = sub.body
            stream = hub.open_stream(
                promql=spec.get("promql"),
                sql=spec.get("sql"),
                alerts=bool(spec.get("alerts")),
                scope=spec.get("scope", "auto"),
                span_s=int(spec.get("span_s") or 60),
                step=int(spec.get("step") or 1),
                db=spec.get("db") or "deepflow_system",
                table=spec.get("table") or "deepflow_system",
                lookback_s=int(spec.get("lookback_s") or 300),
                maxlen=spec.get("maxlen"),
                lease_s=spec.get("lease_s"),
                transport="tcp",
            )
            sock.setblocking(True)
            seq = 0
            last_write = time.monotonic()
            heartbeat_s = float(spec.get("heartbeat_s") or 5.0)
            reason = "disconnect"
            while self._running:
                if hub._closing or stream.closed:
                    reason = "close" if not stream.closed else "lease"
                    break
                r, _, _ = select.select([sock], [], [], 0)
                if r:
                    chunk = sock.recv(1 << 16)
                    if not chunk:
                        break  # client closed cleanly
                    for header, body in reasm.feed(chunk):
                        frame = decode_push_frame(header, body)
                        if frame.kind == "unsub":
                            reason = "close"
                            raise StopIteration
                item = stream.poll()
                if item is None:
                    now = time.monotonic()
                    if now - last_write >= heartbeat_s:
                        sock.sendall(encode_push_frame(
                            PushFrame(kind="hello")
                        ))
                        stream.renew()
                        last_write = now
                        with hub._lock:
                            hub.counters["heartbeats"] += 1
                    time.sleep(0.02)
                    continue
                seq += 1
                sock.sendall(encode_push_frame(PushFrame(
                    kind="result", query_id=stream.query_id, seq=seq,
                    body={"payload": result_to_jsonable(item)},
                )))
                stream.renew()
                last_write = time.monotonic()
                with hub._lock:
                    hub.counters["deliveries"] += 1
            hub.close_conn(stream, reason=reason)
            stream = None
        except StopIteration:
            hub.close_conn(stream, reason="close")
            stream = None
        except (BrokenPipeError, ConnectionResetError, OSError, ValueError):
            with hub._lock:
                hub.counters["mid_write_disconnects"] += 1
        finally:
            if stream is not None:
                hub.close_conn(stream, reason="disconnect")
            try:
                sock.close()
            except OSError:
                pass


__all__ = ["WireHub", "WireConnection", "WireListener", "DEFAULT_LEASE_S"]
