"""The server's host planes in the port against the reference's, on the
same inputs: the event ingester, the integration ingester with the
collector, the wire formats and the SkyWalking / Datadog imports, the
exporters (the Kafka RecordBatch bytes equal), ISSU, the store monitor
and the flame-graph querier. Each scenario runs once per package; their
store rows, answers and bytes must be equal (the cases of
tests/test_events_ingest.py, test_integration.py, test_otlp_exporter.py,
test_trace_imports.py, test_kafka_exporter.py and
test_rest_monitor_issu.py)."""

from __future__ import annotations

import gzip
import importlib
import json
import socket
import struct
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

REF, PORT = "deepflow_tpu", "deepflow_tpu_torch"
T0 = 1_700_000_000


def m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario, *args):
    """Run a scenario on each package; returns (port, reference)."""
    return scenario(PORT, *args), scenario(REF, *args)


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _rows(store, db, table, drop=()):
    """A table's rows as sorted tuples of strings (order-free compare)."""
    cols = store.scan(db, table)
    names = sorted(k for k in cols if k not in drop)
    n = len(cols[names[0]]) if names else 0
    return names, sorted(tuple(str(np.asarray(cols[k])[i]) for k in names) for i in range(n))


def _sender(pkg, port, mt, **kw):
    if pkg == REF:
        kw["prefer_native_queue"] = False
    return m(pkg, "ingest.sender").UniformSender([("127.0.0.1", port)], mt, **kw)


def _ld(field, payload):
    from deepflow_tpu_torch.ingest.codec import _put_varint

    b = bytearray()
    _put_varint(b, field << 3 | 2)
    _put_varint(b, len(payload))
    b += payload
    return bytes(b)


def _vi(field, v):
    from deepflow_tpu_torch.ingest.codec import _put_varint

    b = bytearray()
    _put_varint(b, field << 3 | 0)
    _put_varint(b, v & 0xFFFFFFFFFFFFFFFF)
    return bytes(b)


def _otlp_body():
    sname = _ld(1, b"service.name") + _ld(2, _ld(1, b"checkout"))
    resource = _ld(1, _ld(1, sname))
    span = (_ld(1, bytes(16)) + _ld(2, bytes.fromhex("00000000000000aa"))
            + _ld(5, b"GET /cart") + _vi(6, 2) + _vi(7, T0 * 10**9)
            + _vi(8, T0 * 10**9 + 5_000_000)
            + _ld(9, _ld(1, b"http.method") + _ld(2, _ld(1, b"GET")))
            + _ld(9, _ld(1, b"http.status_code") + _ld(2, _ld(1, b"200")))
            + _ld(15, _ld(2, b"deadline exceeded") + _vi(3, 2)))
    return _ld(1, resource + _ld(2, _ld(2, span)))


def _sw_segment():
    ref = _vi(1, 0) + _ld(2, b"trace-abc") + _ld(3, b"seg-upstream") + _vi(4, 4)
    span0 = (_vi(1, 0) + _vi(2, -1) + _vi(3, T0 * 1000) + _vi(4, T0 * 1000 + 25)
             + _ld(5, ref) + _ld(6, b"GET:/cart") + _vi(8, 0)
             + _ld(12, _ld(1, b"http.method") + _ld(2, b"GET")))
    span1 = (_vi(1, 1) + _vi(2, 0) + _vi(3, T0 * 1000 + 5) + _vi(4, T0 * 1000 + 20)
             + _ld(6, b"SELECT db") + _ld(7, b"db:5432") + _vi(8, 1) + _vi(11, 1))
    return (_ld(1, b"trace-abc") + _ld(2, b"seg-1") + _ld(3, span0) + _ld(3, span1)
            + _ld(4, b"cart") + _ld(5, b"cart-pod-1"))


DD_TRACES = [[
    {"trace_id": 42, "span_id": 7, "parent_id": 0, "service": "web", "name": "web.request",
     "resource": "GET /", "start": T0 * 10**9, "duration": 30_000_000, "error": 0,
     "meta": {"span.kind": "server"}},
    {"trace_id": 42, "span_id": 8, "parent_id": 7, "service": "db", "name": "pg.query",
     "resource": "SELECT", "start": T0 * 10**9, "duration": 5_000_000, "error": 1,
     "meta": {"span.kind": "client"}},
    {"trace_id": "not-an-int", "span_id": 2, "service": "bad", "meta": "oops"},
]]


def _fields(obj):
    import dataclasses

    return dataclasses.asdict(obj) if dataclasses.is_dataclass(obj) else obj


# -- wire formats and trace imports ---------------------------------------------

def _formats(pkg):
    fm = m(pkg, "integration.formats")
    ti = m(pkg, "integration.trace_imports")
    influx = ('cpu,host=web-1,az=a usage=0.5,count=3i 1700000000000000000\n'
              'mem,host=web-1 used=12.5\nbad line without fields\nesc\\,aped,t=v\\ x f=1i')
    pts, errors = fm.parse_influx_lines(influx)
    series = [fm.PromSeries({"__name__": "http_requests_total", "job": "api", "code": "200"},
                            [(T0 * 1000, 10.0), ((T0 + 30) * 1000, 25.0)]),
              fm.PromSeries({"__name__": "up", "job": "api"}, [(T0 * 1000, 1.0)])]
    rw = fm.encode_remote_write(series)
    spans = [fm.OtelSpan(service="checkout", name=f"GET /cart/{i}", trace_id=f"{i + 1:032x}",
                         span_id=f"{i + 0xAB:016x}", parent_span_id="" if i == 0 else
                         f"{0xAB:016x}", kind=2, start_us=T0 * 10**6 + i,
                         end_us=T0 * 10**6 + 5000 + i, status_code=2 if i % 2 else 1,
                         attributes={"http.method": "GET", "df.endpoint": f"/cart/{i}"})
             for i in range(2)]
    traces = fm.encode_otlp_traces(spans)
    metrics = fm.encode_otlp_metrics([
        fm.OtlpMetric("deepflow", "deepflow_network_byte_tx", "By", True,
                      [fm.OtlpMetricPoint({"pod": "p1"}, T0 * 10**9, 123.5),
                       fm.OtlpMetricPoint({"pod": "p2"}, T0 * 10**9, 7.0)]),
        fm.OtlpMetric("deepflow", "deepflow_network_rtt", "us", False,
                      [fm.OtlpMetricPoint({}, T0 * 10**9, 250.0)])])
    folded, ferr = fm.parse_folded("a;b;c 10\na;b 5\na;b;d 1\nbad\n")
    tags = {"url": "/search?a=1,b=2", "k=y": "v\\x", "plain": "ok"}
    return {
        "influx": ([_fields(p) for p in pts], errors),
        "rw": rw, "rw_back": [_fields(s) for s in fm.parse_remote_write(rw)],
        "traces": traces, "traces_back": [_fields(s) for s in fm.parse_otlp_traces(traces)],
        "otlp": [_fields(s) for s in fm.parse_otlp_traces(_otlp_body())],
        "metrics": metrics,
        "metrics_back": [_fields(x) for x in fm.parse_otlp_metrics(metrics)],
        "folded": ([_fields(s) for s in folded], ferr),
        "tags": (fm.pack_tags(tags), fm.unpack_tags(fm.pack_tags(tags))),
        "sw": [_fields(s) for s in ti.parse_skywalking_segment(_sw_segment())],
        "dd": [_fields(s) for s in ti.parse_datadog_traces(json.dumps(DD_TRACES).encode())],
        "bad": (ti.parse_skywalking_segment(b"\xff\xff\xff"),
                ti.parse_datadog_traces(b"not json"), ti.parse_datadog_traces(b'{"a": 1}')),
    }


def test_formats_and_trace_imports_equal():
    got, want = both(_formats)
    for k in want:
        assert got[k] == want[k], k
    assert got["influx"][1] == 1 and got["influx"][0][2]["measurement"] == "esc,aped"
    assert got["otlp"][0]["service"] == "checkout" and got["otlp"][0]["status_code"] == 2
    assert [s["trace_id"] for s in got["traces_back"]] == [f"{1:032x}", f"{2:032x}"]
    assert len(got["dd"]) == 2 and got["dd"][1]["parent_span_id"] == format(7, "016x")
    assert {s["service"] for s in got["sw"]} == {"cart"} and got["bad"] == ([], [], [])
    assert got["tags"][1] == {"url": "/search?a=1,b=2", "k=y": "v\\x", "plain": "ok"}


def _flame(pkg):
    prof = m(pkg, "querier.profile")
    fm = m(pkg, "integration.formats")
    samples, _ = fm.parse_folded("a;b;c 10\na;b 5\na;b;d 1\n")
    return prof.flame_tree([s.stack for s in samples], [s.value for s in samples])


def test_flame_tree_equal():
    got, want = both(_flame)
    assert got == want and got["total_value"] == 16
    assert got["children"][0]["children"][0]["self_value"] == 5


# -- the event ingester -------------------------------------------------------

def _events(pkg):
    recv = m(pkg, "ingest.receiver").Receiver()
    recv.start()
    store = m(pkg, "storage.store").ColumnarStore()
    ing = m(pkg, "server.events").EventIngester(recv, store,
                                                writer_args={"flush_interval_s": 0.05})
    MT = m(pkg, "ingest.framing").MessageType
    pkt = bytes(range(64))
    sends = [
        (MT.PROC_EVENT, [json.dumps({"time": T0, "start_time_us": T0 * 10**6,
                                     "end_time_us": T0 * 10**6 + 500, "event_type": "io_write",
                                     "process_kname": "nginx", "gprocess_id": 42,
                                     "description": "slow write"}).encode(), b"not json"]),
        (MT.K8S_EVENT, [json.dumps({"time": T0 + 1, "event_type": "create",
                                    "resource_type": "pod", "resource_id": 9,
                                    "resource_name": "web-0"}).encode()]),
        (MT.ALERT_EVENT, [json.dumps({"time": T0, "policy_id": 3, "policy_name": "high-rtt",
                                      "level": 3, "target_tags": {"pod": "web-0"},
                                      "metric_value": 812.5,
                                      "description": "rtt over threshold"}).encode()]),
        (MT.APPLICATION_LOG, [json.dumps(x).encode() for x in (
            {"timestamp_us": T0 * 10**6, "app_service": "checkout", "severity_text": "ERROR",
             "body": "payment failed", "trace_id": "t1", "span_id": "s1",
             "attributes": {"k": "v"}},
            {"timestamp_us": T0 * 10**6 + 1, "app_service": "checkout",
             "severity_number": 9, "body": "ok"})]),
        (MT.RAW_PCAP, [struct.pack(">QQI", 0xAABBCCDD00112233, T0 * 10**6 + 7, len(pkt)) + pkt]),
        (MT.SYSLOG, [b"<11>1 2026-07-30T06:12:33.5Z host app: disk read failure"]),
        (MT.AGENT_LOG, [b"dispatcher: rx ring resized"]),
    ]
    try:
        for mt, msgs in sends:
            snd = _sender(pkg, recv.tcp_port, mt, agent_id=5, organization_id=1,
                          flush_interval=0.05)
            snd.send(msgs)
            snd.close()
        assert _wait(lambda: ing.get_counters()["rows_written"] >= 8), ing.get_counters()
        ing.flush()
        out = {t: _rows(store, db, t) for db, t in (("event", "event"),
                                                     ("event", "alert_event"),
                                                     ("pcap", "pcap"))}
        # the agent log carries no time of its own: it is stamped at ingest
        out["log"] = _rows(store, "application_log", "log", drop=("time", "timestamp_us"))
        cols = store.scan("application_log", "log")
        stamped = cols["app_service"] != "deepflow-agent"
        out["log_times"] = sorted(zip(np.asarray(cols["time"])[stamped].tolist(),
                                      np.asarray(cols["timestamp_us"])[stamped].tolist()))
        out["counters"] = ing.get_counters()
        return out
    finally:
        ing.stop()
        recv.stop()


def test_event_ingester_rows_equal():
    got, want = both(_events)
    assert got == want
    names, rows = got["event"]
    assert len(rows) == 2 and got["counters"]["decode_errors"] >= 1
    assert len(got["log"][1]) == 4 and len(got["pcap"][1]) == 1


@pytest.mark.parametrize("line", [
    "1 2026-07-30T06:12:33.5Z host app: boom", "Jul 30 06:12:33 host app: boom",
    "no timestamp here", "1 2026-07-30T06:12:33.123456789+02:00 h a: x"])
def test_syslog_timestamp_equal(line):
    got = m(PORT, "server.events").EventIngester._syslog_timestamp(line)
    assert got == m(REF, "server.events").EventIngester._syslog_timestamp(line)


# -- the integration ingester, fed by the collector ---------------------------------

def _post(port, path, body, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def _integration(pkg):
    recv = m(pkg, "ingest.receiver").Receiver()
    recv.start()
    store = m(pkg, "storage.store").ColumnarStore()
    tracing = m(pkg, "tracing")
    builder = tracing.TraceTreeBuilder(store, close_after_s=0.0,
                                       writer_args={"flush_interval_s": 0.01})
    reg = m(pkg, "controller.prom_labels").PrometheusLabelRegistry()
    ing = m(pkg, "server.integration").IntegrationIngester(
        recv, store, writer_args={"flush_interval_s": 0.05}, trace_builder=builder,
        prom_labels=reg)
    col = m(pkg, "integration.collector").IntegrationCollector([("127.0.0.1", recv.tcp_port)])
    fm = m(pkg, "integration.formats")
    dfstats = m(pkg, "integration.dfstats")
    try:
        influx = f"cpu,host=h1 usage=0.7 {T0}000000000\ncpu,host=h2 usage=0.2 {T0}000000000"
        rw = fm.encode_remote_write([fm.PromSeries({"__name__": "up", "job": "api"},
                                                   [(T0 * 1000, 1.0)])])
        statuses = [
            _post(col.port, "/influxdb/api/v2/write", gzip.compress(influx.encode()),
                  {"Content-Encoding": "gzip"}),
            _post(col.port, "/api/v1/prom/write", rw),
            _post(col.port, "/api/v1/prom/write", b"x", {"Content-Encoding": "snappy"}),
            _post(col.port, "/api/v1/profile",
                  f"svc-a\x00cpu\x00{T0}\nmain;work;hot 90\nmain;idle 10".encode()),
            _post(col.port, "/v1/traces", _otlp_body()),
            _post(col.port, "/v3/segment", _sw_segment()),
            _post(col.port, "/v0.4/traces", json.dumps(DD_TRACES).encode()),
            _post(col.port, "/nope", b""),
        ]
        sc = m(pkg, "utils.stats").StatsCollector(interval_s=999)
        sc.register("flow_map", lambda: {"packets_in": 42})
        snd = _sender(pkg, recv.tcp_port, m(pkg, "ingest.framing").MessageType.DFSTATS,
                      agent_id=1)
        sc.add_sink(dfstats.stats_sink(snd))
        sc.tick(now=float(T0))
        assert _wait(lambda: ing.get_counters()["rows_written"] >= 11), ing.get_counters()
        assert _wait(lambda: builder.get_counters()["spans_in"] >= 5)
        builder.tick()
        builder.flush()
        ing.flush()
        snd.close()
        out = {"statuses": statuses, "counters": ing.get_counters(),
               "collector": dict(col.counters),
               "flame": m(pkg, "querier.profile").query_flame(store, app_service="svc-a"),
               "trace": tracing.query_trace(store, "trace-abc"),
               "dd": tracing.query_trace(store, format(42, "032x"))}
        for db in store.databases():
            for t in store.tables(db):
                out[(db, t)] = _rows(store, db, t)
        return out
    finally:
        col.stop()
        ing.stop()
        builder.stop()
        recv.stop()


def test_integration_ingester_rows_equal():
    got, want = both(_integration)
    assert sorted(got, key=str) == sorted(want, key=str)
    for k in want:
        assert got[k] == want[k], k
    assert got["statuses"] == [200, 204, 415, 200, 200, 200, 200, 404]
    assert got["flame"]["total_value"] == 100
    assert {n["app_service"] for n in got["trace"]["nodes"]} == {"cart"}
    names, rows = got[("ext_metrics", "metrics")]
    assert len(rows) == 2
    assert len(got[("deepflow_stats", "stats")][1]) == 1


# -- exporters ---------------------------------------------------------------

def _l7_cols():
    n = 3
    return {
        "time": np.full(n, T0, np.uint32), "start_time": np.full(n, T0, np.uint32),
        "response_duration": np.array([5000, 800, 12000], np.uint32),
        "status": np.array([1, 1, 4], np.uint32),
        "status_code": np.array([200, 200, 500], np.uint32),
        "tap_side": np.array([1, 2, 2], np.uint32), "l7_protocol": np.full(n, 20, np.uint32),
        "server_port": np.full(n, 8080, np.uint32),
        "app_service": np.array(["checkout", "checkout", "cart"]),
        "endpoint": np.array(["/pay", "/pay", "/add"]),
        "request_type": np.array(["POST", "POST", "GET"]),
        "request_resource": np.array(["/pay", "/pay", "/add"]),
        "trace_id": np.array([f"{7:032x}", f"{8:032x}", f"{9:032x}"]),
        "span_id": np.array([f"{1:016x}", f"{2:016x}", f"{3:016x}"]),
        "parent_span_id": np.array(["", "", f"{1:016x}"]),
        "x_request_id": np.array(["", "", ""]),
        "request_domain": np.array(["shop.local", "shop.local", ""]),
        "response_exception": np.array(["", "", "boom"]),
    }


NET_COLS = {"time": np.array([T0, T0 + 1], np.uint32),
            "byte_tx": np.array([4096.0, 7.5], np.float32),
            "rtt": np.array([150.0, 20.0], np.float32), "pod": np.array(["p1", "p2"])}


class _Capture(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self.server.captured.append((self.path, self.headers.get("Content-Type"), body))
        self.send_response(200)
        self.end_headers()


def _exporters(pkg, tmp_path):
    ex = m(pkg, "server.exporters")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _Capture)
    srv.captured = []
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        spans = [ex.OtlpExporter._row_to_span(r)
                 for r in ex.OtlpExporter(traces_url="http://unused")._to_rows(
                     "l7_flow_log", _l7_cols())]
        otlp = ex.OtlpExporter(traces_url=url + "/v1/traces", metrics_url=url + "/v1/metrics",
                               metrics=("byte_tx", "rtt"))
        otlp.export("network", NET_COLS)
        otlp.export("l7_flow_log", _l7_cols())
        skip = ex.OtlpExporter(metrics_url=url + "/v1/metrics", metrics=("response_duration",))
        skip.export("l7_flow_log", _l7_cols())
        rw = ex.RemoteWriteExporter(url + "/api/v1/write", metrics=("byte_tx",),
                                    data_sources=("network",))
        rw.export("network", NET_COLS)
        rw.export("application", NET_COLS)
        fdir = tmp_path / f"{pkg}_jsonl"
        fx = ex.FileExporter(fdir, data_sources=("network",))
        fx.export("network", NET_COLS)
        seen = []
        hub = ex.ExporterHub([ex.CallbackExporter(lambda t, rows: seen.append((t, rows)))])
        hub.export("network", NET_COLS)
        hub.flush()
        hub.stop()
        files = {p.name: p.read_text() for p in sorted(fdir.iterdir())}
        return {"spans": [_fields(s) for s in spans], "posts": list(srv.captured),
                "counters": [otlp.get_counters(), skip.get_counters(), rw.get_counters(),
                             fx.get_counters()],
                "files": files, "hub": seen}
    finally:
        srv.shutdown()


def test_exporters_equal(tmp_path):
    got, want = both(_exporters, tmp_path)
    for k in want:
        assert got[k] == want[k], k
    assert got["spans"][0]["kind"] == 3 and got["spans"][2]["service"] == "cart"
    paths = [p for p, _, _ in got["posts"]]
    assert paths.count("/v1/metrics") == 1 and paths.count("/v1/traces") == 1
    assert paths.count("/api/v1/write") == 1
    assert got["counters"][1]["trace_rows_skipped"] == 3


def _reingest(pkg):
    recv = m(pkg, "ingest.receiver").Receiver()
    recv.start()
    store = m(pkg, "storage.store").ColumnarStore()
    ing = m(pkg, "server.integration").IntegrationIngester(
        recv, store, writer_args={"flush_interval_s": 0.05})
    col = m(pkg, "integration.collector").IntegrationCollector([("127.0.0.1", recv.tcp_port)])
    try:
        exp = m(pkg, "server.exporters").OtlpExporter(
            traces_url=f"http://127.0.0.1:{col.port}/v1/traces")
        exp.export("l7_flow_log", _l7_cols())
        assert _wait(lambda: ing.get_counters()["rows_written"] >= 3)
        ing.flush()
        return [exp.get_counters(), _rows(store, "flow_log", "l7_flow_log")]
    finally:
        col.stop()
        ing.stop()
        recv.stop()


def test_export_reingest_loop_equal():
    got, want = both(_reingest)
    assert got == want
    assert got[0]["rows"] == 3 and len(got[1][1]) == 3


class _Broker:
    """A fake Kafka broker: records every Produce frame, answers acks=1."""

    def __init__(self, acks, error_code=0):
        self.acks, self.error_code, self.frames = acks, error_code, []
        self.srv = socket.create_server(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._run, daemon=True).start()

    @staticmethod
    def _read(conn, n):
        out = b""
        while len(out) < n:
            c = conn.recv(n - len(out))
            if not c:
                return None
            out += c
        return out

    def _run(self):
        conn, _ = self.srv.accept()
        try:
            while True:
                hdr = self._read(conn, 4)
                if hdr is None:
                    return
                body = self._read(conn, struct.unpack(">i", hdr)[0])
                if body is None:
                    return
                self.frames.append(hdr + body)
                if self.acks:
                    corr = struct.unpack(">i", body[4:8])[0]
                    if self.error_code:
                        topic = b"deepflow.network"
                        resp = struct.pack(">ii", corr, 1) + struct.pack(">h", len(topic))
                        resp += topic + struct.pack(">i", 1)
                        resp += struct.pack(">ih", 0, self.error_code)
                        resp += struct.pack(">qq", -1, -1) + struct.pack(">i", 0)
                    else:
                        resp = struct.pack(">ii", corr, 0) + struct.pack(">i", 0)
                    conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            pass


def _kafka(pkg):
    kx = m(pkg, "server.kafka_exporter")
    out = {"crc": [kx.crc32c(b) for b in (b"", b"123456789", b"\x00" * 32, b"\xff" * 32,
                                          bytes(range(32)))],
           "batch": kx.encode_record_batch([(b"k", b"v1"), (None, b"v2" * 90)], 123),
           "produce": kx.encode_produce_request("deepflow.network", [(b"network", b"{}")],
                                                correlation_id=7, acks=1, timestamp_ms=123)}
    for acks, err in ((0, 0), (1, 0), (1, 3)):
        broker = _Broker(acks, err)
        exp = kx.KafkaExporter("127.0.0.1", broker.port, acks=acks, data_sources=("network",))
        exp.export("network", NET_COLS)
        exp.export("application", NET_COLS)
        assert _wait(lambda: broker.frames, timeout=5)
        out[(acks, err)] = [exp.get_counters(), list(broker.frames)]
        exp.close()
        broker.srv.close()
    return out


def test_kafka_exporter_bytes_equal():
    got, want = both(_kafka)
    for k in want:
        assert got[k] == want[k], k
    assert got["crc"] == [0, 0xE3069283, 0x8A9136AA, 0x62A8AB43, 0x46DD794E]
    assert got[(1, 0)][0]["batches"] == 1 and got[(1, 0)][0]["filtered"] == 1
    assert got[(1, 3)][0]["errors"] == 1 and got[(1, 3)][0]["batches"] == 0


def test_build_exporters_equal(tmp_path):
    specs = [{"kind": "kafka", "host": "127.0.0.1", "port": 19092, "acks": 0,
              "data_sources": ["network"]},
             {"kind": "otlp", "traces_url": "http://127.0.0.1:1/v1/traces"},
             {"kind": "prom_rw", "url": "http://127.0.0.1:1/w", "metrics": ["byte_tx"]},
             {"kind": "jsonl", "directory": str(tmp_path / "sink")}]
    got = m(PORT, "server.main").build_exporters(specs)
    want = m(REF, "server.main").build_exporters(specs)
    assert [type(e).__name__ for e in got] == [type(e).__name__ for e in want] == [
        "KafkaExporter", "OtlpExporter", "RemoteWriteExporter", "FileExporter"]
    assert got[0].addr == want[0].addr == ("127.0.0.1", 19092)
    assert got[0].data_sources == want[0].data_sources == ("network",)
    for mod in (PORT, REF):
        with pytest.raises(ValueError, match="nonsense"):
            m(mod, "server.main").build_exporters([{"kind": "nonsense"}])


# -- ISSU and the store monitor ------------------------------------------------

def _issu(pkg, tmp_path):
    st = m(pkg, "storage.store")
    issu = m(pkg, "storage.issu")
    root = tmp_path / f"{pkg}_store"
    store = st.ColumnarStore(root)
    old = st.TableSchema("l7_flow_log", (st.ColumnSpec("time", "u4"),
                                         st.ColumnSpec("trace_id", "U64")), partition_s=3600)
    store.create_table("flow_log", old)
    store.insert("flow_log", "l7_flow_log", {"time": np.array([T0], np.uint32),
                                             "trace_id": np.array(["t1"])})
    (root / "schema_version").write_text("1")
    store2 = st.ColumnarStore(root)
    report = issu.upgrade(store2)
    fresh = st.ColumnarStore(tmp_path / f"{pkg}_fresh")
    return [report, issu.read_version(root), _rows(store2, "flow_log", "l7_flow_log"),
            store2.schema("flow_log", "l7_flow_log").to_json(), issu.upgrade(store2),
            issu.upgrade(fresh), issu.read_version(tmp_path / f"{pkg}_fresh")]


def test_issu_upgrade_equal(tmp_path):
    got, want = both(_issu, tmp_path)
    assert got == want
    assert got[0]["applied"] == [2] and got[1] == 2
    assert got[4]["applied"] == [] and got[5] == {"applied": [], "tables_changed": 0}


def _monitor(pkg, tmp_path):
    st = m(pkg, "storage.store")
    mon_mod = m(pkg, "storage.monitor")

    def mk(store, db, table, pids):
        store.create_table(db, st.TableSchema(
            table, (st.ColumnSpec("time", "u4"), st.ColumnSpec("v", "f4")), partition_s=3600))
        for pid in pids:
            store.insert(db, table, {"time": np.full(1000, pid * 3600 + 1, np.uint32),
                                     "v": np.ones(1000, np.float32)})

    store = st.ColumnarStore(tmp_path / f"{pkg}_a")
    mk(store, "flow_log", "l4_flow_log", [0, 1, 2, 3])
    mk(store, "flow_metrics", "network_1s", [0, 1, 2, 3])
    mon = mon_mod.StoreMonitor(store, max_bytes=1,
                               ttl_hours={("flow_log", "l4_flow_log"): 2})
    out = [mon.check(4 * 3600), store.partitions("flow_log", "l4_flow_log"),
           store.partitions("flow_metrics", "network_1s"), mon.get_counters()]
    store2 = st.ColumnarStore(tmp_path / f"{pkg}_b")
    mk(store2, "pcap", "pcap", [0, 1, 2])
    mk(store2, "flow_metrics", "network_1s", [0, 1, 2])
    mon2 = mon_mod.StoreMonitor(store2, max_bytes=store2.disk_bytes() - 1)
    out += [mon2.check(0), store2.partitions("pcap", "pcap"),
            store2.partitions("flow_metrics", "network_1s")]
    return out


def test_store_monitor_equal(tmp_path):
    got, want = both(_monitor, tmp_path)
    assert got == want
    assert got[0]["ttl_dropped"] == 2 and got[2] == [3]
    assert len(got[5]) == 2 and len(got[6]) == 3
