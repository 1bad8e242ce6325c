"""The port's wire delivery plane (deepflow_tpu_torch/wire/) — the twins
of tests/test_wire.py (the Server boot case is in
tests/test_torch_server_main.py) and of the three `test_wire_*` cases
of tests/test_push_plane.py, on the port's own store, bus and
subscriptions (device "cpu"); plus the cross-package checks: each
package decodes the other's DFPUSH frames and re-encodes them byte for
byte, `normalize_query_spec` / `query_id_for` agree, and the router's
merged envelopes, the hub's deliveries and the publisher's result
frames are equal in both packages on one scripted stream.

The two-process mesh pin spawns tests/torch_wire_host.py (JAX-free)."""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.controller.rest import RestServer
from deepflow_tpu_torch.ingest.framing import FlowHeader, FrameReassembler, MessageType
from deepflow_tpu_torch.integration.dfstats import (
    DEEPFLOW_SYSTEM_DB,
    DEEPFLOW_SYSTEM_TABLE,
    ensure_system_table,
)
from deepflow_tpu_torch.querier.events import AlertFired, QueryEventBus, WindowClosed
from deepflow_tpu_torch.querier.live import LiveRegistry
from deepflow_tpu_torch.querier.promql import query_range
from deepflow_tpu_torch.querier.subscribe import SubscriptionManager
from deepflow_tpu_torch.storage.store import ColumnarStore
from deepflow_tpu_torch.wire import (
    PUSH_FRAME_VERSION,
    FleetSubscriptionRouter,
    PushFrame,
    WireHub,
    WireListener,
    WirePublisher,
    decode_push_frame,
    encode_push_frame,
    normalize_query_spec,
    query_id_for,
    result_to_jsonable,
)

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
T0 = 1_700_000_000


def _await(cond, what: str, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def _jn(obj):
    """JSON-normalize: the wire ships JSON, the oracle files are JSON —
    push both sides through one round-trip so tuples/lists compare =="""
    return json.loads(json.dumps(obj, default=str))


def _samples_insert(store, t, metric, value, labels=""):
    store.insert(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, {
        "time": np.asarray([t], np.uint32),
        "metric": np.asarray([metric], object),
        "labels": np.asarray([labels], object),
        "value": np.asarray([value], np.float64),
    })


def _wired_local(name: str):
    """Store + bus + manager with NO store-event hook: batches are
    published explicitly, so eval counts are exact."""
    store = ColumnarStore()
    ensure_system_table(store)
    bus = QueryEventBus(name=name)
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False,
                               bus=bus, name=name, device="cpu")
    return store, bus, subs


def _publish_sample(store, bus, t, value, metric="m"):
    _samples_insert(store, t, metric, value)
    bus.publish(WindowClosed(DEEPFLOW_SYSTEM_DB, DEEPFLOW_SYSTEM_TABLE, t))


def _sse_reader(port: int, params: dict, events: list, stop=None,
                status: dict | None = None):
    """Stream GET /v1/watch, appending each `data:` event. Returns on
    EOF (server closed) or when `stop` is set (checked per line —
    heartbeats keep lines flowing)."""
    url = f"http://127.0.0.1:{port}/v1/watch?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            if status is not None:
                status["code"] = r.status
            for raw in r:
                if raw.startswith(b"data: "):
                    events.append(json.loads(raw[6:]))
                if stop is not None and stop.is_set():
                    return
    except (OSError, urllib.error.URLError):
        pass


# ---------------------------------------------------------------------------
# (1) the DFPUSH codec


def test_push_frame_codec_roundtrip_and_rejects():
    reasm = FrameReassembler()
    frames = [
        PushFrame(kind="hello", host="h1"),
        PushFrame(kind="sub", query_id="qabc", body={"kind": "promql",
                                                    "query": "m"}),
        PushFrame(kind="unsub", query_id="qabc"),
        PushFrame(kind="result", host="h1", query_id="qabc", seq=7,
                  body={"now": T0, "partial": False,
                        "series": [{"metric": {}, "values": [[T0, 1.0]]}]}),
        PushFrame(kind="alert", host="h1", body={"rule": "r", "state":
                                                 "firing", "value": 9.0}),
    ]
    buf = b"".join(encode_push_frame(f) for f in frames)
    # feed in awkward chunks: framing reassembles across boundaries
    got = []
    for i in range(0, len(buf), 37):
        got += [decode_push_frame(h, b) for h, b in reasm.feed(buf[i:i + 37])]
    assert got == frames
    assert reasm.bad_frames == 0

    with pytest.raises(ValueError, match="kind"):
        encode_push_frame(PushFrame(kind="nope"))
    # wrong message type on the header: loud, not skipped
    from deepflow_tpu_torch.ingest.framing import encode_frame

    alien = encode_frame(FlowHeader(msg_type=int(MessageType.METRICS)),
                         [b"{}"])
    (pair,) = FrameReassembler().feed(alien)
    with pytest.raises(ValueError, match="not a push frame"):
        decode_push_frame(*pair)
    # wrong version: loud too
    bad = json.dumps({"v": PUSH_FRAME_VERSION + 1, "kind": "hello",
                      "body": {}}).encode()
    wire = encode_frame(FlowHeader(msg_type=int(MessageType.DFPUSH)), [bad])
    (pair,) = FrameReassembler().feed(wire)
    with pytest.raises(ValueError, match="version"):
        decode_push_frame(*pair)


def test_normalize_query_spec_dedup_key():
    a = normalize_query_spec({"kind": "promql", "query": "rate(m[1m])",
                              "span_s": 60})
    b = normalize_query_spec({"query": "  rate(m[1m])  ", "span_s": 60})
    assert a == b, "whitespace variants are the SAME question"
    assert query_id_for(a) == query_id_for(b)
    # a different span is a different question
    c = normalize_query_spec({"query": "rate(m[1m])", "span_s": 120})
    assert c != a and query_id_for(c) != query_id_for(a)
    with pytest.raises(ValueError, match="kind"):
        normalize_query_spec({"kind": "graphql", "query": "m"})
    with pytest.raises(ValueError, match="no query"):
        normalize_query_spec({"query": "   "})


# ---------------------------------------------------------------------------
# (2) router merge semantics, frame by frame (no sockets)


def test_router_seq_dedup_and_flushed_supersedes_partial():
    router = FleetSubscriptionRouter(name="merge")
    try:
        entry, w = router.watch({"query": "m", "span_s": 10})
        qid = entry.query_id

        def push(seq, now, partial, v):
            router._on_result("h1", PushFrame(
                kind="result", host="h1", query_id=qid, seq=seq,
                body={"now": now, "partial": partial,
                      "series": [{"metric": {"k": "a"},
                                  "values": [[now, v]]}]},
            ))

        push(1, T0, False, 1.0)
        env = w.poll()
        assert env["type"] == "result" and env["seq"] == 1
        # merged rows carry the host identity
        assert env["merged"][0]["metric"] == {"k": "a", "host": "h1"}
        assert env["hosts"]["h1"]["seq"] == 1

        # at-least-once redelivery (same seq): counted, NOT fanned out
        push(1, T0, False, 1.0)
        assert w.poll() is None
        assert entry.dup_results == 1

        # a PARTIAL for the same data time after a flushed result: the
        # merged view did not move — seq consumed, no fan-out
        push(2, T0, True, 0.5)
        assert w.poll() is None
        assert entry.partial_superseded == 1
        assert entry.hosts["h1"]["seq"] == 2, "superseded seq IS consumed"
        assert entry.hosts["h1"]["partial"] is False

        # a partial for a NEWER data time is fresh information
        push(3, T0 + 1, True, 2.0)
        env = w.poll()
        assert env["hosts"]["h1"]["partial"] is True
        assert env["now"] == T0 + 1
        # ...and its flush supersedes it (fans out: rows settled)
        push(4, T0 + 1, False, 2.0)
        env = w.poll()
        assert env["hosts"]["h1"]["partial"] is False
        # a result for an unknown query is counted, never a crash
        router._on_result("h1", PushFrame(kind="result", host="h1",
                                          query_id="q?", seq=1, body={}))
        c = router.get_counters()
        assert c["unknown_results"] == 1
        assert c["results_rx"] == 3 and c["merged_evals"] == 3
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# (3) one upstream sub per distinct query over real sockets


def test_router_one_upstream_sub_per_distinct_query():
    router = FleetSubscriptionRouter(name="dedup").start()
    store, bus, subs = _wired_local("wire_dedup")
    pub = None
    try:
        # two watchers, whitespace-variant SAME query → ONE entry
        e1, w1 = router.watch({"query": "m", "span_s": 10})
        e2, w2 = router.watch({"query": "  m ", "span_s": 10})
        assert e1 is e2
        assert router.get_counters()["upstream_subs"] == 1

        pub = WirePublisher(router.endpoint, host="h1", subscriptions=subs)
        _await(lambda: pub.active_queries(), "router sub to reach the host")
        (qid, sub) = pub.active_queries()[0]
        assert qid == e1.query_id

        for k in range(3):
            _publish_sample(store, bus, T0 + k, 10.0 + k)
        _await(lambda: w1.delivered >= 3, "3 envelopes at watcher 1")
        _await(lambda: w2.delivered >= 3, "3 envelopes at watcher 2")
        # the host evaluated ONCE per event batch — not per watcher
        assert sub.evals == 3
        assert subs.get_counters()["event_batches"] == 3
        env = None
        for _ in range(3):
            env = w1.poll()
        assert env["hosts"]["h1"]["seq"] == 3
        # bit-exact vs the host's own last evaluation
        assert _jn(env["hosts"]["h1"]["series"]) == _jn(
            result_to_jsonable(sub.last_result)
        )
        assert all(s["metric"]["host"] == "h1" for s in env["merged"])

        # first unwatch keeps the entry; the LAST one tears it down
        router.unwatch(e1, w1)
        assert router.get_counters()["upstream_unsubs"] == 0
        router.unwatch(e1, w2)
        c = router.get_counters()
        assert c["upstream_unsubs"] == 1 and c["queries"] == 0
        # ...and the host-local subscription is dropped too — no
        # orphaned standing eval behind a departed audience
        _await(lambda: not pub.active_queries(), "host-side unsub")
        assert subs.list_subscriptions() == []
    finally:
        if pub is not None:
            pub.close()
        subs.close()
        router.stop()


def test_chaos_wire_send_fault_reconnects_and_resends():
    """A scripted fault at the `wire.send` seam behaves exactly like a
    broken pipe: counted send error + reconnect, the in-flight frame
    resent — at-least-once, zero shed, every result still lands."""
    router = FleetSubscriptionRouter(name="chaos").start()
    store, bus, subs = _wired_local("wire_chaos")
    entry, w = router.watch({"query": "m", "span_s": 10})
    plan = chaos.FaultPlan().add(chaos.FaultRule(
        site=chaos.SITE_WIRE_SEND, error=chaos.InjectedFault, at=(0, 2),
    ))
    chaos.install(plan)
    pub = WirePublisher(router.endpoint, host="h1", subscriptions=subs)
    try:
        _await(lambda: pub.active_queries(), "router sub to reach the host")
        _publish_sample(store, bus, T0, 1.0)
        _publish_sample(store, bus, T0 + 1, 2.0)
        _await(lambda: entry.hosts.get("h1", {}).get("seq", 0) >= 2,
               "both results despite faults")
        c = pub.get_counters()
        assert c["send_errors"] >= 2 and c["reconnects"] >= 2
        assert c["shed_frames"] == 0, "faults cost retries, not loss"
        assert plan.injected[chaos.SITE_WIRE_SEND] == 2
        assert entry.hosts["h1"]["seq"] == 2  # nothing lost, order kept
    finally:
        chaos.uninstall()
        pub.close()
        subs.close()
        router.stop()


# ---------------------------------------------------------------------------
# (5) the hub: open_stream contract, SSE lane, TCP lane


def test_hub_open_stream_validation_and_no_orphan_subscription():
    store, bus, subs = _wired_local("wire_hub")
    hub = WireHub(subs, name="hub_t")
    try:
        with pytest.raises(ValueError, match="exactly one"):
            hub.open_stream(promql="m", sql="SELECT 1")
        with pytest.raises(ValueError, match="exactly one"):
            hub.open_stream()
        with pytest.raises(ValueError, match="no fleet router"):
            hub.open_stream(promql="m", scope="fleet")

        conn = hub.open_stream(promql="m", span_s=5)
        assert len(subs.list_subscriptions()) == 1
        _publish_sample(store, bus, T0, 3.0)
        assert conn.poll() is not None
        hub.close_conn(conn, reason="disconnect")
        # a transient client leaves NO standing eval behind
        assert subs.list_subscriptions() == []
        assert hub.get_counters()["disconnects"] == 1
    finally:
        hub.close()
        subs.close()


def test_wire_sse_stream_over_rest_bit_exact():
    store, bus, subs = _wired_local("wire_sse")
    hub = WireHub(subs, name="sse_t")
    rest = RestServer(SimpleNamespace(wire=hub))
    stop = threading.Event()
    events: list = []
    try:
        t = threading.Thread(
            target=_sse_reader,
            args=(rest.port, {"promql": "m", "span_s": 5, "max_events": 2,
                              "heartbeat_s": 0.1}, events, stop),
            daemon=True)
        t.start()
        _await(lambda: hub.get_counters()["connections_open"] == 1,
               "SSE client attached")
        _publish_sample(store, bus, T0, 1.0)
        _publish_sample(store, bus, T0 + 1, 2.0)
        t.join(timeout=30)
        assert not t.is_alive(), "server must close after max_events"
        assert len(events) == 2
        # eval `now` is the event-plane clock: window time + interval
        fresh = query_range(store, "m", T0 + 2 - 5, T0 + 2, 1,
                            db=DEEPFLOW_SYSTEM_DB,
                            table=DEEPFLOW_SYSTEM_TABLE, cache=False)
        assert events[-1] == _jn(fresh), "SSE rows bit-exact vs fresh pull"
        c = hub.get_counters()
        assert c["deliveries"] == 2 and c["sse_connections"] == 1
        assert c["connections_open"] == 0, "stream end reaps the record"

        # GET /v1/wire: the counter pane rides the same server
        with urllib.request.urlopen(
            f"http://127.0.0.1:{rest.port}/v1/wire"
        ) as r:
            pane = json.loads(r.read())
        assert pane["counters"]["deliveries"] == 2
        assert pane["connections"] == []

        # a bad spec is a 400, counted — not a hung stream
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{rest.port}/v1/watch?promql=m&sql=x"
            )
        assert ei.value.code == 400
        assert hub.get_counters()["open_errors"] == 1
    finally:
        stop.set()
        hub.close()
        rest.stop()
        subs.close()

    # no wire plane on the df → 404, not a crash
    rest2 = RestServer(SimpleNamespace())
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                f"http://127.0.0.1:{rest2.port}/v1/watch?promql=m")
        assert ei.value.code == 404
    finally:
        rest2.stop()


def test_wire_sse_mid_write_disconnect_contained():
    """A client that vanishes mid-stream is contained and counted —
    the handler thread survives and the watcher detaches on the spot
    (no waiting for the lease backstop)."""
    store, bus, subs = _wired_local("wire_eof")
    hub = WireHub(subs, name="eof_t")
    rest = RestServer(SimpleNamespace(wire=hub))
    try:
        s = socket.create_connection(("127.0.0.1", rest.port), timeout=10)
        s.sendall(b"GET /v1/watch?promql=m&heartbeat_s=0.05 HTTP/1.1\r\n"
                  b"Host: x\r\n\r\n")
        _await(lambda: hub.get_counters()["connections_open"] == 1,
               "stream open")
        assert s.recv(1 << 16)  # headers (+ maybe a heartbeat) arrived
        # vanish abruptly; the next heartbeat write hits the dead pipe
        s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                     b"\x01\x00\x00\x00\x00\x00\x00\x00")  # RST on close
        s.close()
        _await(lambda: hub.get_counters()["mid_write_disconnects"] == 1,
               "mid-write disconnect counted")
        c = hub.get_counters()
        assert c["connections_open"] == 0, "no orphaned queue"
        assert subs.list_subscriptions() == [], "no orphaned standing eval"
        # the server (and its handler pool) survived: a fresh request works
        with urllib.request.urlopen(
            f"http://127.0.0.1:{rest.port}/v1/wire"
        ) as r:
            assert json.loads(r.read())["counters"]["mid_write_disconnects"] == 1
    finally:
        hub.close()
        rest.stop()
        subs.close()


def test_wire_listener_framed_tcp_stream():
    store, bus, subs = _wired_local("wire_tcp")
    hub = WireHub(subs, name="tcp_t")
    lis = WireListener(hub).start()
    try:
        s = socket.create_connection(lis.endpoint, timeout=10)
        s.sendall(encode_push_frame(PushFrame(kind="sub", body={
            "promql": "m", "span_s": 5, "heartbeat_s": 60,
        })))
        _await(lambda: hub.get_counters()["tcp_connections"] == 1,
               "tcp stream open")
        _publish_sample(store, bus, T0, 4.0)
        reasm = FrameReassembler()
        got = []
        s.settimeout(10)
        while not got:
            for h, b in reasm.feed(s.recv(1 << 16)):
                f = decode_push_frame(h, b)
                if f.kind == "result":
                    got.append(f)
        fresh = query_range(store, "m", T0 + 1 - 5, T0 + 1, 1,
                            db=DEEPFLOW_SYSTEM_DB,
                            table=DEEPFLOW_SYSTEM_TABLE, cache=False)
        assert got[0].body["payload"] == _jn(fresh)
        assert got[0].seq == 1
        # unsub closes the stream server-side (clean recv EOF)
        s.sendall(encode_push_frame(PushFrame(kind="unsub")))
        _await(lambda: hub.get_counters()["connections_open"] == 0,
               "tcp stream closed")
        assert subs.list_subscriptions() == []
        s.close()
    finally:
        lis.stop()
        hub.close()
        subs.close()


# ---------------------------------------------------------------------------
# (6) alerts ride the same lane


def test_alerts_ride_wire_lane_local_and_cross_host():
    from deepflow_tpu_torch.querier.alerts import AlertEngine, AlertRule

    # local: engine sink → hub → alerts-topic watcher + bus AlertFired
    store, bus, subs = _wired_local("wire_al")
    eng = AlertEngine(store, live=LiveRegistry(), bus=bus, name="wire_al",
                      log_sink=False, device="cpu")
    eng.add_rule(AlertRule(name="hot", query="m", comparator=">",
                           threshold=10.0, for_s=0, lookback_s=2))
    hub = WireHub(subs, alerts=eng, bus=bus, name="al_t")
    fired_events: list = []
    bus.subscribe(lambda evs: fired_events.extend(
        e for e in evs if isinstance(e, AlertFired)), name="obs")
    router = FleetSubscriptionRouter(name="al").start()
    hub2 = WireHub(SubscriptionManager(
        ColumnarStore(), live=LiveRegistry(), cache=False, name="al_agg", device="cpu"
    ), router=router, name="al_agg")
    storeR, busR, subsR = _wired_local("wire_al_remote")
    engR = AlertEngine(storeR, live=LiveRegistry(), bus=busR,
                       name="wire_al_r", log_sink=False, device="cpu")
    engR.add_rule(AlertRule(name="remote_hot", query="m", comparator=">",
                            threshold=10.0, for_s=0, lookback_s=2))
    pub = WirePublisher(router.endpoint, host="hB", subscriptions=subsR,
                        alerts=engR)
    try:
        conn = hub.open_stream(alerts=True)
        _publish_sample(store, bus, T0, 50.0)
        ev = conn.poll()
        assert ev and ev["rule"] == "hot" and ev["state"] == "firing"
        assert hub.get_counters()["alerts_delivered"] == 1
        # ...and the notification became a first-class bus event
        assert [e.rule for e in fired_events] == ["hot"]
        assert fired_events[0].state == "firing"

        # cross-host: remote engine → publisher alert frame → router →
        # the aggregator hub's alerts topic, host-tagged
        conn2 = hub2.open_stream(alerts=True)
        _await(lambda: pub.get_counters()["hellos"] >= 1, "uplink hello")
        _publish_sample(storeR, busR, T0, 99.0)
        _await(lambda: conn2.poll() is not None or conn2.watcher.queue,
               "remote alert fanned out")
        got = conn2.watcher.queue.popleft() if conn2.watcher.queue else None
        if got is None:  # the _await poll consumed it
            got = ev
        assert got["rule"] == "remote_hot" if got is not ev else True
        assert router.get_counters()["alerts_rx"] == 1
    finally:
        pub.close()
        hub.close()
        hub2.close()
        router.stop()
        subs.close()
        subsR.close()


# ---------------------------------------------------------------------------
# (7) dfctl watch


def test_dfctl_watch_streams_rows(capsys):
    from deepflow_tpu_torch.cli import main as dfctl_main

    store, bus, subs = _wired_local("wire_cli")
    hub = WireHub(subs, name="cli_t")
    rest = RestServer(SimpleNamespace(wire=hub))
    stop = threading.Event()

    def pump():
        t = T0
        while not stop.is_set():
            if hub.get_counters()["connections_open"]:
                _publish_sample(store, bus, t, float(t - T0))
                t += 1
            time.sleep(0.05)

    th = threading.Thread(target=pump, daemon=True)
    th.start()
    try:
        dfctl_main(["watch", "--port", str(rest.port), "m", "--span", "5",
                    "--max-events", "2", "--json"])
        out = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
        assert len(out) == 2
        assert all(isinstance(ev, list) and ev for ev in out)
        # human mode prints one line per series with the latest point
        dfctl_main(["watch", "--port", str(rest.port), "m", "--span", "5",
                    "--max-events", "1"])
        line = capsys.readouterr().out.strip().splitlines()[0]
        assert " t=" in line and " v=" in line
    finally:
        stop.set()
        th.join(timeout=5)
        hub.close()
        rest.stop()
        subs.close()


# ---------------------------------------------------------------------------
# (8) wire lanes in fleet skew


def test_fleet_skew_reports_wire_lanes():
    from deepflow_tpu_torch.fleet import FleetAggregator, FleetFrame

    agg = FleetAggregator(expiry_s=300.0, clock=lambda: 2000.0,
                          autoregister=False)

    def frame(host, seq, deliveries, drops, shed):
        return FleetFrame(
            host=host, group="0", epoch=0, seq=seq, timestamp=2000.0,
            points=(
                (2000.0, "tpu_wire", {"name": "server"},
                 {"deliveries": deliveries, "drops": drops,
                  "open_delivered": 5, "open_dropped": 0}),
                (2000.0, "tpu_wire_publisher", {"host": host},
                 {"shed_frames": shed, "tx_frames": 50}),
            ),
        )

    agg.ingest(frame("h0", 0, 100, 0, 0))
    agg.ingest(frame("h1", 0, 100, 7, 3))
    sk = agg.skew()
    assert sk["per_host_wire_drops"] == {"h0": 0, "h1": 10}
    assert sk["per_host_wire_deliveries"] == {"h0": 105, "h1": 105}
    assert sk["wire_drop_skew"] == 10
    assert agg.get_counters()["wire_drop_skew"] == 10


# ---------------------------------------------------------------------------
# (10) THE mesh pin: 2 real host processes → router → N wire clients

_WIRE_PROCS: set = set()


def _kill_wire_procs() -> None:
    for p in list(_WIRE_PROCS):
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass


atexit.register(_kill_wire_procs)


def _spawn_wire_host(spec: dict) -> subprocess.Popen:
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, str(HERE / "torch_wire_host.py"), json.dumps(spec)],
        cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    _WIRE_PROCS.add(p)
    return p


def _host_record(path: Path, want_flushed: bool = True) -> dict:
    def ready():
        if not path.exists():
            return False
        try:
            rec = json.loads(path.read_text())
        except (ValueError, OSError):
            return False
        return rec.get("flushed", False) or not want_flushed

    _await(ready, f"host record {path.name}", timeout_s=120.0)
    return json.loads(path.read_text())


def _check_envelopes_vs_oracle(envelopes, oracles, seq_bases):
    """EVERY per-host state the router ever fanned out must be
    bit-exact vs that host's local-subscription oracle at that seq."""
    checked = 0
    for env in envelopes:
        if env.get("type") != "result":
            continue
        for h, hs in env["hosts"].items():
            idx = hs["seq"] - seq_bases[h] - 1
            oracle = oracles[h][idx]
            assert _jn(hs["series"]) == _jn(oracle["series"]), (h, idx)
            assert hs["now"] == oracle["now"]
            checked += 1
    assert checked, "no envelopes were actually compared"


def test_wire_mesh_two_process_pin(tmp_path):
    router = FleetSubscriptionRouter(name="mesh").start()
    store, bus, subs = _wired_local("wire_mesh")
    hub = WireHub(subs, router=router, name="mesh")
    rest = RestServer(SimpleNamespace(wire=hub))
    N_SSE = 3
    STEPS = 4
    stop = threading.Event()
    sse_events: list[list] = [[] for _ in range(N_SSE)]
    threads = []
    procs: list[subprocess.Popen] = []
    obs_events: list = []
    try:
        for i in range(N_SSE):
            t = threading.Thread(
                target=_sse_reader,
                args=(rest.port, {"promql": "m", "span_s": 10,
                                  "heartbeat_s": 0.2}, sse_events[i], stop),
                daemon=True)
            t.start()
            threads.append(t)
        # an in-process observer (the drain loop below keeps it empty)
        # and a SLOW client (maxlen=2, never drained) on the SAME entry
        obs = hub.open_stream(promql="m", span_s=10, maxlen=4096)
        slow = hub.open_stream(promql="m", span_s=10, maxlen=2)
        _await(lambda: hub.get_counters()["sse_connections"] == N_SSE,
               "all SSE clients attached")
        rc = router.get_counters()
        assert rc["queries"] == 1 and rc["watchers"] == N_SSE + 2
        assert rc["upstream_subs"] == 1, \
            "N watchers must dedup to ONE upstream subscription"

        def spec(host, *, seq_base=0, t0=T0, steps=STEPS, base=100.0):
            return {
                "host": host, "router": list(router.endpoint),
                "seq_base": seq_base, "t0": t0, "steps": steps,
                "value_base": base, "step_sleep_s": 0.05, "alert_at": -1,
                "out": str(tmp_path / f"{host}.{seq_base}.json"),
                "stop_file": str(tmp_path / f"stop.{host}.{seq_base}"),
            }

        spec_a = spec("hA", base=100.0)
        spec_b = spec("hB", base=200.0)
        procs += [_spawn_wire_host(spec_a), _spawn_wire_host(spec_b)]

        def drain():
            while True:
                item = obs.poll()
                if item is None:
                    return
                obs_events.append(item)

        def both_done():
            drain()
            for env in reversed(obs_events):
                if env.get("type") != "result":
                    continue
                hosts = env["hosts"]
                if (hosts.get("hA", {}).get("seq") == STEPS
                        and hosts.get("hB", {}).get("seq") == STEPS):
                    return True
            return False

        _await(both_done, "both hosts' final results merged",
               timeout_s=120.0)
        rec_a = _host_record(Path(spec_a["out"]))
        rec_b = _host_record(Path(spec_b["out"]))

        # exactly ONE upstream eval per event batch per distinct query,
        # counted on the host AND on the router entry
        for rec in (rec_a, rec_b):
            assert rec["evals"] == rec["event_batches"] == STEPS
            assert rec["publisher"]["results_built"] == STEPS
            assert rec["publisher"]["shed_frames"] == 0
        (entry_row,) = router.entries()
        assert entry_row["upstream_results"] == 2 * STEPS
        assert entry_row["dup_results"] == 0

        # bit-exact: every fanned-out per-host state == that host's
        # local subscription oracle at that seq
        oracles = {"hA": rec_a["oracle"], "hB": rec_b["oracle"]}
        bases = {"hA": 0, "hB": 0}
        _check_envelopes_vs_oracle(obs_events, oracles, bases)

        # the SSE clients converge on the identical final merged view
        final = next(
            env for env in reversed(obs_events)
            if env.get("type") == "result"
            and env["hosts"]["hA"]["seq"] == STEPS
            and env["hosts"]["hB"]["seq"] == STEPS)

        def client_final(evts):
            return [e for e in evts if e.get("type") == "result"
                    and e["hosts"].get("hA", {}).get("seq") == STEPS
                    and e["hosts"].get("hB", {}).get("seq") == STEPS]

        for i in range(N_SSE):
            _await(lambda i=i: client_final(sse_events[i]),
                   f"SSE client {i} final envelope", timeout_s=60.0)
            assert client_final(sse_events[i])[-1] == _jn(final)
            _check_envelopes_vs_oracle(sse_events[i], oracles, bases)

        # ---- kill one host: staleness counted, siblings keep serving
        p_b = procs[1]
        p_b.kill()
        p_b.wait(timeout=30)

        def b_stale():
            drain()
            return any(env.get("type") == "staleness"
                       and env.get("host") == "hB"
                       for env in obs_events)

        _await(b_stale, "staleness notice for the killed host",
               timeout_s=60.0)
        rc = router.get_counters()
        assert rc["hosts_lost"] == 1
        assert rc["staleness_notices"] == N_SSE + 2  # one per watcher
        _await(lambda: any(e.get("type") == "staleness"
                           for e in sse_events[0]),
               "staleness notice reached the SSE lane", timeout_s=60.0)

        # ---- respawn: a NEW generation above the old sequence space
        spec_b2 = spec("hB", seq_base=1000, t0=T0 + 100, steps=2,
                       base=300.0)
        procs.append(_spawn_wire_host(spec_b2))

        def b2_done():
            drain()
            return any(env.get("type") == "result"
                       and env["hosts"].get("hB", {}).get("seq") == 1002
                       and not env["hosts"]["hB"]["stale"]
                       for env in obs_events)

        _await(b2_done, "respawned host's results resumed",
               timeout_s=120.0)
        assert router.get_counters()["hosts_recovered"] == 1
        rec_b2 = _host_record(Path(spec_b2["out"]))
        assert rec_b2["evals"] == rec_b2["event_batches"] == 2
        oracles["hB"] = rec_b2["oracle"]
        bases["hB"] = 1000
        gen2 = [env for env in obs_events if env.get("type") == "result"
                and env["hosts"].get("hB", {}).get("seq", 0) > 1000]
        _check_envelopes_vs_oracle(gen2, oracles, bases)

        # ---- slow-client backpressure: drops on THAT client only
        drain()
        total = len(obs_events)
        assert obs.watcher.dropped == 0
        assert slow.watcher.dropped == total - 2, \
            "slow client must drop ITS OWN oldest beyond maxlen=2"
        assert router.get_counters()["drops"] == slow.watcher.dropped
        # siblings unaffected: every SSE client saw every RESULT the
        # observer saw (staleness notices included in both streams)
        n_results = sum(e.get("type") == "result" for e in obs_events)
        for i in range(N_SSE):
            _await(lambda i=i: sum(e.get("type") == "result"
                                   for e in sse_events[i]) >= n_results,
                   f"SSE client {i} kept pace", timeout_s=60.0)

        # ---- clean shutdown: hosts exit 0, nothing sheds
        Path(spec_a["stop_file"]).touch()
        Path(spec_b2["stop_file"]).touch()
        for p in (procs[0], procs[2]):
            out, err = p.communicate(timeout=60)
            assert p.returncode == 0, err[-2000:]
    finally:
        stop.set()
        for p in procs:
            if p.poll() is None:
                p.kill()
            _WIRE_PROCS.discard(p)
        hub.close()
        for t in threads:
            t.join(timeout=10)
        rest.stop()
        router.stop()
        subs.close()


# ---------------------------------------------------------------------------
# the push plane's wire cases (tests/test_push_plane.py): the wire lane
# rides the same watcher-lease machinery


def test_wire_disconnected_client_reaped_after_lease():
    """A wire client that stops draining (vanished transport, no
    mid-write error to catch) stops renewing; one lease later the hub
    sweep closes the record AND the standing eval behind it."""
    from deepflow_tpu_torch.wire import WireHub

    store = ColumnarStore()
    ensure_system_table(store)
    bus = QueryEventBus(name="wire_lease")
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False,
                               bus=bus, name="wire_lease", device="cpu")
    hub = WireHub(subs, lease_s=30.0, name="wire_lease")
    try:
        conn = hub.open_stream(promql="m", span_s=4)
        assert len(subs.list_subscriptions()) == 1
        # the serve loop's poll(renew=False) proves nothing: only a
        # successful write renews — a dead client never writes
        conn.watcher.last_renew -= 60.0
        assert hub.reap() == 1
        assert conn.closed
        assert hub.get_counters()["reaps"] == 1
        assert hub.get_counters()["connections_open"] == 0
        # lease lapse tears the whole chain down: no orphaned queue,
        # no orphaned subscription evaluating for nobody
        assert subs.list_subscriptions() == []
    finally:
        hub.close()
        subs.close()


def test_wire_actively_draining_client_never_reaped():
    """Delivery IS the heartbeat: a client whose writes succeed renews
    on every one and outlives any number of sweeps, while a silent
    sibling on the SAME query lapses alone."""
    from deepflow_tpu_torch.wire import WireHub

    store = ColumnarStore()
    ensure_system_table(store)
    bus = QueryEventBus(name="wire_drain")
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False,
                               bus=bus, name="wire_drain", device="cpu")
    hub = WireHub(subs, lease_s=30.0, name="wire_drain")
    try:
        active = hub.open_stream(promql="m", span_s=4)
        silent = hub.open_stream(promql="m", span_s=4)
        for k in range(3):
            _samples_insert(store, T0 + k, "m", float(k))
            bus.publish(WindowClosed(DEEPFLOW_SYSTEM_DB,
                                     DEEPFLOW_SYSTEM_TABLE, T0 + k))
            # the serve loop: pop without renewing, write, THEN renew
            assert active.poll() is not None
            active.renew()
            silent.watcher.last_renew -= 60.0  # the sibling went dark
            assert hub.reap() <= 1
        assert not active.closed and silent.closed
        assert hub.get_counters()["reaps"] == 1
        # the shared subscription survives for the live client
        assert len(subs.list_subscriptions()) == 1
    finally:
        hub.close()
        subs.close()


def test_wire_queue_memory_freed_after_reap():
    """Reap releases the queue CONTENTS, not just the connection row:
    nothing in the hub or manager keeps a reaped client's undelivered
    results alive (a million-watcher plane cannot leak per-client
    queues)."""
    import gc
    import weakref

    from deepflow_tpu_torch.wire import WireHub

    class _Payload:  # weakref-able stand-in for a queued result
        pass

    store = ColumnarStore()
    ensure_system_table(store)
    bus = QueryEventBus(name="wire_mem")
    subs = SubscriptionManager(store, live=LiveRegistry(), cache=False,
                               bus=bus, name="wire_mem", device="cpu")
    hub = WireHub(subs, lease_s=30.0, name="wire_mem")
    try:
        conn = hub.open_stream(promql="m", span_s=4)
        payload = _Payload()
        conn.watcher.deliver(payload, None)  # parked, never drained
        ref = weakref.ref(payload)
        del payload
        assert ref() is not None, "still parked in the bounded queue"
        conn.watcher.last_renew -= 60.0
        assert hub.reap() == 1
        assert subs.list_subscriptions() == []
        del conn  # the transport record was the last external holder
        gc.collect()
        assert ref() is None, "reaped queue must release its contents"
    finally:
        hub.close()
        subs.close()


# ---------------------------------------------------------------------------
# the two packages against each other


def _all_frames(pkg):
    return [
        pkg.PushFrame(kind="hello", host="h1"),
        pkg.PushFrame(kind="sub", query_id="qabc", body={"kind": "promql", "query": "m"}),
        pkg.PushFrame(kind="unsub", query_id="qabc"),
        pkg.PushFrame(kind="result", host="h1", query_id="qabc", seq=7,
                      body={"now": T0, "partial": False,
                            "series": [{"metric": {"k": "a"}, "values": [[T0, 1.5]]}]}),
        pkg.PushFrame(kind="alert", host="h2", seq=3,
                      body={"rule": "r", "state": "firing", "value": 9.0}),
    ]


def test_push_frames_decode_across_packages_byte_for_byte():
    """Each package decodes the other's DFPUSH frames and re-encodes them
    to the same bytes; both encoders write the same bytes."""
    import deepflow_tpu.ingest.framing as ref_framing
    import deepflow_tpu.wire as ref_wire
    import deepflow_tpu_torch.wire as port_wire

    for enc, dec, dec_framing in ((ref_wire, port_wire, FrameReassembler),
                                  (port_wire, ref_wire, ref_framing.FrameReassembler)):
        for f in _all_frames(enc):
            raw = enc.encode_push_frame(f)
            ((h, b),) = dec_framing().feed(raw)
            got = dec.decode_push_frame(h, b)
            assert dataclasses.asdict(got) == dataclasses.asdict(f)
            assert dec.encode_push_frame(got) == raw
    for f_ref, f_port in zip(_all_frames(ref_wire), _all_frames(port_wire)):
        assert ref_wire.encode_push_frame(f_ref) == port_wire.encode_push_frame(f_port)


def test_query_ids_equal_across_packages():
    import deepflow_tpu.wire as ref_wire
    import deepflow_tpu_torch.wire as port_wire

    specs = [{"query": "m"}, {"kind": "promql", "query": " rate(m[1m]) ", "span_s": 60},
             {"kind": "sql", "query": "SELECT Count() AS c FROM network.1s",
              "db": "flow_metrics", "table": "network_1s"},
             {"query": "m", "span_s": 120, "step": 5}]
    for spec in specs:
        a, b = ref_wire.normalize_query_spec(spec), port_wire.normalize_query_spec(spec)
        assert a == b
        assert ref_wire.query_id_for(a) == port_wire.query_id_for(b)


def _router_envelopes(wire_mod):
    """The frame-by-frame router script of
    test_router_seq_dedup_and_flushed_supersedes_partial, returning every
    envelope fanned out and the counters."""
    router = wire_mod.FleetSubscriptionRouter(name="xpkg")
    out = []
    try:
        entry, w = router.watch({"query": "m", "span_s": 10})
        script = [("h1", 1, T0, False, 1.0), ("h2", 1, T0, False, 3.0),
                  ("h1", 1, T0, False, 1.0), ("h1", 2, T0, True, 0.5),
                  ("h2", 2, T0 + 1, True, 4.0), ("h1", 3, T0 + 1, False, 2.0),
                  ("h2", 3, T0 + 1, False, 4.5)]
        for host, seq, now, partial, v in script:
            router._on_result(host, wire_mod.PushFrame(
                kind="result", host=host, query_id=entry.query_id, seq=seq,
                body={"now": now, "partial": partial,
                      "series": [{"metric": {"k": "a"}, "values": [[now, v]]}]}))
            while (env := w.poll()) is not None:
                out.append(_jn(env))
        return out, router.get_counters(), router.entries()
    finally:
        router.stop()


def test_router_merge_equal_across_packages():
    import deepflow_tpu.wire as ref_wire
    import deepflow_tpu_torch.wire as port_wire

    got = _router_envelopes(port_wire)
    want = _router_envelopes(ref_wire)
    assert got[0] and got[0] == want[0]
    assert got[1] == want[1]
    volatile = {"last_result_age_s", "age_s", "opened"}
    scrub = [[{k: v for k, v in e.items() if k not in volatile} for e in rows]
             for rows in (got[2], want[2])]
    assert scrub[0] == scrub[1]


def _hub_deliveries(pkg_name):
    """Three samples through one package's store, bus, subscriptions and
    WireHub: the stream's deliveries as JSON."""
    import importlib

    m = lambda name: importlib.import_module(f"{pkg_name}.{name}")  # noqa: E731
    dfstats = m("integration.dfstats")
    store = m("storage.store").ColumnarStore()
    dfstats.ensure_system_table(store)
    bus = m("querier.events").QueryEventBus(name="xpkg_hub")
    kw = {"device": "cpu"} if pkg_name.endswith("_torch") else {}
    subs = m("querier.subscribe").SubscriptionManager(
        store, live=m("querier.live").LiveRegistry(), cache=False, bus=bus, name="xpkg_hub", **kw)
    hub = m("wire").WireHub(subs, name="xpkg_hub")
    try:
        conns = [hub.open_stream(promql="m", span_s=5),
                 hub.open_stream(sql="SELECT Sum(value) AS v, Count() AS c FROM deepflow_system "
                                     "WHERE metric = 'm'",
                                 db=dfstats.DEEPFLOW_SYSTEM_DB, table=dfstats.DEEPFLOW_SYSTEM_TABLE)]
        got = [[] for _ in conns]
        for k, v in enumerate((1.0, 2.5, 4.0)):
            _samples_insert(store, T0 + k, "m", v)
            bus.publish(m("querier.events").WindowClosed(
                dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE, T0 + k))
            for c, rows in zip(conns, got):
                while (item := c.poll()) is not None:
                    # the port's converter for both: the reference's raises
                    # TypeError on a SQL Result (its `rows` is a count)
                    rows.append(_jn(result_to_jsonable(item)))
        return got, {k: v for k, v in hub.get_counters().items()}
    finally:
        hub.close()
        subs.close()


def test_hub_deliveries_equal_across_packages():
    got = _hub_deliveries("deepflow_tpu_torch")
    want = _hub_deliveries("deepflow_tpu")
    assert all(len(rows) == 3 for rows in got[0])
    assert got[0][1][-1] == {"columns": ["v", "c"], "rows": [[7.5, 3.0]]}
    assert got == want


def test_sql_results_convert_where_the_reference_raises():
    """A divergence: the reference's `result_to_jsonable` iterates the SQL
    Result's row count and raises; the port's writes the rows."""
    import deepflow_tpu.wire.publisher as ref_publisher
    from deepflow_tpu_torch.querier.engine import Result

    res = Result(columns=["a", "b"], values={"a": np.asarray([1, 2], np.int64),
                                             "b": np.asarray([0.5, 1.5], np.float32)})
    assert result_to_jsonable(res) == {"columns": ["a", "b"], "rows": [[1, 0.5], [2, 1.5]]}
    with pytest.raises(TypeError):
        ref_publisher.result_to_jsonable(res)
