"""WirePublisher — the pipeline host's DFPUSH uplink (port copy of
deepflow_tpu/wire/publisher.py).

One duplex framed-TCP connection host → `FleetSubscriptionRouter`:
control frames (`sub`/`unsub`) flow DOWN it, results and alert
notifications flow UP it. The send side is the HandoffSender stance
verbatim — bounded PyOverwriteQueue (overflow = counted shed, the only
loss point), the in-flight frame retained across reconnects
(at-least-once; the router dedups on seq), capped decorrelated-jitter
backoff, and the `chaos.SITE_WIRE_SEND` seam so tests script transport
loss deterministically.

A `sub` frame creates ONE local subscription on the host's EXISTING
`SubscriptionManager` with a callback watcher that encodes each
evaluation as a `result` frame — so the host evaluates once per event
batch (the push plane's coalescing) no matter how many wire clients watch
the query on the aggregator, and the local drop/lease machinery is
reused unchanged. `unsub` tears the local subscription down (unless
other local watchers still hold it). Countable face:
`tpu_wire_publisher`.
"""

from __future__ import annotations

import select
import socket
import threading
import time

from .. import chaos
from ..ingest.framing import FrameReassembler
from ..ingest.queues import PyOverwriteQueue
from ..utils.retry import RetryPolicy, decorrelated_rng
from ..utils.stats import register_countable
from .frame import PushFrame, decode_push_frame, encode_push_frame

_RECONNECT = RetryPolicy(base_delay_s=0.05, max_delay_s=2.0, jitter=0.5)
_BACKOFF_CAP_ATTEMPT = 16


def result_to_jsonable(result):
    """One subscription eval result → the JSON shape shipped in a
    `result` frame body. PromQL range results are already list[dict];
    SQL `QueryResult`s become {"columns", "rows"}. The ORACLE in the
    2-process pin records the same shape, so bit-exact comparison is a
    plain == on parsed JSON.

    The SQL engine's `Result.rows` is the row COUNT; its rows come from
    `to_dicts()` as Python scalars, in column order. (The JAX package's
    copy iterates the count and raises TypeError on every SQL result.)"""
    if result is None:
        return None
    if isinstance(result, (list, tuple)):
        return [dict(s) if isinstance(s, dict) else s for s in result]
    cols = getattr(result, "columns", None)
    rows = getattr(result, "rows", None)
    if cols is not None and rows is not None:
        if isinstance(rows, int):
            rows = [[d[c] for c in cols] for d in result.to_dicts()]
        return {
            "columns": list(cols),
            "rows": [list(r) for r in rows],
        }
    return result


def _has_partial(payload) -> bool:
    if isinstance(payload, list):
        return any(
            isinstance(s, dict) and s.get("partial") for s in payload
        )
    return False


class WirePublisher:
    """Dial a router, answer its subscription control plane, push every
    local eval upstream. `seq_base` exists for process generations: a
    respawned host must start ABOVE its predecessor's sequence space or
    the router's at-least-once dedup would eat its first results."""

    def __init__(self, endpoint: tuple[str, int], *, host: str,
                 subscriptions, alerts=None, capacity: int = 1024,
                 seq_base: int = 0, connect_timeout_s: float = 5.0,
                 name: str | None = None):
        self.endpoint = (endpoint[0], int(endpoint[1]))
        self.host = host
        self._subs = subscriptions
        self._alerts = alerts
        self._alert_sink = None
        self._queue = PyOverwriteQueue(capacity)
        self._seq = seq_base
        self._seq_lock = threading.Lock()
        self.connect_timeout_s = connect_timeout_s
        self._lock = threading.Lock()
        #: query_id -> (sub, watcher) — the local half of each router sub
        self._active: dict[str, tuple] = {}
        self._inflight = 0
        self._sock: socket.socket | None = None
        self._running = True
        self._rng = decorrelated_rng(hash(host) & 0x7FFFFFFF)
        self.counters = {
            "hellos": 0,
            "tx_frames": 0,
            "tx_bytes": 0,
            "shed_frames": 0,
            "send_errors": 0,
            "reconnects": 0,
            "control_rx": 0,
            "control_errors": 0,
            "dup_subs": 0,
            "results_built": 0,
            "alerts_tx": 0,
        }
        if alerts is not None:
            self._alert_sink = alerts.add_sink(
                self._on_alert, name=f"wire:{host}"
            )
        self._stats_src = register_countable(
            "tpu_wire_publisher", self, host=host, name=name or host
        )
        self._thread = threading.Thread(
            target=self._run, name=f"wire-pub-{host}", daemon=True
        )
        self._thread.start()

    # -- public faces ----------------------------------------------------
    def active_queries(self) -> list[tuple]:
        """[(query_id, Subscription)] — the test oracle attaches here."""
        with self._lock:
            return [(qid, sw[0]) for qid, sw in self._active.items()]

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["subs_active"] = len(self._active)
        out["queue_depth"] = len(self._queue)
        out["queue_shed"] = self._queue.overwritten
        return out

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Block until the outbound queue is drained ONTO the wire (the
        HandoffSender fence): queue empty AND no frame in flight."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if not len(self._queue) and not self._inflight:
                return True
            time.sleep(0.002)
        return False

    def close(self, drain_timeout_s: float = 5.0) -> None:
        self.flush(drain_timeout_s)
        self._running = False
        self._thread.join(timeout=10.0)
        shed = len(self._queue) + self._inflight
        if shed:
            self._count("shed_frames", shed)
        self._queue.close()
        if self._alert_sink is not None:
            # the engine prunes detached sinks; flagging it is the
            # supported detach path (no remove_sink face)
            self._alert_sink.detached = True
            self._alert_sink = None
        with self._lock:
            active = list(self._active.values())
            self._active.clear()
        for sub, w in active:
            sub.unwatch(w)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    # -- counters --------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def _enqueue(self, buf: bytes) -> None:
        before = self._queue.overwritten
        self._queue.put(buf)
        shed = self._queue.overwritten - before
        if shed:
            self._count("shed_frames", shed)

    # -- alert lane ------------------------------------------------------
    def _on_alert(self, event: dict) -> None:
        self._enqueue(encode_push_frame(PushFrame(
            kind="alert", host=self.host, body=dict(event)
        )))
        self._count("alerts_tx")

    # -- control plane ---------------------------------------------------
    def _on_control(self, frame: PushFrame) -> None:
        self._count("control_rx")
        if frame.kind == "sub":
            self._on_sub(frame)
        elif frame.kind == "unsub":
            self._on_unsub(frame)
        else:
            self._count("control_errors")

    def _on_sub(self, frame: PushFrame) -> None:
        qid = frame.query_id
        with self._lock:
            if qid in self._active:
                self.counters["dup_subs"] += 1
                return
        spec = frame.body

        def cb(result, sub):
            with self._seq_lock:
                self._seq += 1
                seq = self._seq
            payload = result_to_jsonable(result)
            body = {
                "now": int(getattr(sub, "last_now", 0) or 0),
                "partial": _has_partial(payload),
                "series": payload,
            }
            self._enqueue(encode_push_frame(PushFrame(
                kind="result", host=self.host, query_id=qid,
                seq=seq, body=body,
            )))
            self._count("results_built")

        try:
            if spec.get("kind") == "sql":
                sub, w = self._subs.subscribe_sql(
                    spec["query"], callback=cb
                )
            else:
                sub, w = self._subs.subscribe_promql(
                    spec["query"],
                    span_s=int(spec.get("span_s", 60)),
                    step=int(spec.get("step", 1)),
                    db=spec.get("db", "deepflow_system"),
                    table=spec.get("table", "deepflow_system"),
                    lookback_s=int(spec.get("lookback_s", 300)),
                    callback=cb,
                )
        except Exception:
            self._count("control_errors")
            return
        with self._lock:
            self._active[qid] = (sub, w)

    def _on_unsub(self, frame: PushFrame) -> None:
        with self._lock:
            pair = self._active.pop(frame.query_id, None)
        if pair is None:
            return
        sub, w = pair
        sub.unwatch(w)
        if not sub.watchers:
            # no other local consumer holds this query — drop it so it
            # stops evaluating (cache-warming mode is opt-in, not a leak)
            self._subs.unsubscribe(sub)

    # -- uplink thread ---------------------------------------------------
    def _connect(self) -> bool:
        try:
            s = socket.create_connection(
                self.endpoint, timeout=self.connect_timeout_s
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(encode_push_frame(PushFrame(
                kind="hello", host=self.host
            )))
        except OSError:
            return False
        self._sock = s
        self._count("hellos")
        return True

    def _disconnect(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _run(self) -> None:
        attempt = 1
        pending: bytes | None = None
        reasm = FrameReassembler()
        while self._running or pending is not None or len(self._queue):
            if self._sock is None:
                if not self._connect():
                    self._count("send_errors")
                    if not self._running:
                        self._count("shed_frames", 1 if pending else 0)
                        self._inflight = 0
                        return
                    time.sleep(_RECONNECT.delay(attempt, self._rng))
                    attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)
                    continue
                reasm = FrameReassembler()  # new stream, new framing
                attempt = 1
            # control plane: drain whatever the router pushed down
            try:
                r, _, _ = select.select([self._sock], [], [], 0)
                if r:
                    chunk = self._sock.recv(1 << 16)
                    if not chunk:
                        raise ConnectionResetError("router closed uplink")
                    for header, body in reasm.feed(chunk):
                        try:
                            self._on_control(decode_push_frame(header, body))
                        except (ValueError, KeyError, TypeError):
                            self._count("control_errors")
            except OSError:
                self._count("reconnects")
                self._disconnect()
                continue
            if pending is None:
                got = self._queue.gets(1, timeout_ms=5)
                if not got:
                    if not self._running:
                        return
                    continue
                pending = got[0]
                self._inflight = 1
            try:
                # the scripted-loss seam: an injected fault here behaves
                # exactly like a broken pipe (reconnect + resend)
                chaos.maybe_fail(chaos.SITE_WIRE_SEND)
                self._sock.sendall(pending)
                self._count("tx_frames")
                self._count("tx_bytes", len(pending))
                pending = None
                self._inflight = 0
            except Exception:
                # at-least-once: the in-flight frame stays pending
                # across the reconnect
                self._count("send_errors")
                self._count("reconnects")
                self._disconnect()
                time.sleep(_RECONNECT.delay(attempt, self._rng))
                attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)


__all__ = ["WirePublisher", "result_to_jsonable"]
