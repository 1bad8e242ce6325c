"""The composed server in the port (`server.main.Server`, `dfctl`)
against the reference's. One reference Server and one port Server
(`device="cpu"`) boot from one dict config with the resource plane, the
fleet plane, leader election, an exporter and an alert-rules file; they
receive the same frames over TCP, take the same resources through their
own resource planes, change one resource mid-stream and roll 1 s up to
1 h on a leader tick. Their stores, tag dictionaries, 1 h rows, REST,
debug and MCP answers must be equal (apart from ports and wall times);
integer meters bit-exact, float32 sums within rtol 1e-5. Each package's
`dfctl query` reads the other's store.

Also the port counterparts of tests/test_server_cli.py, the server cases
of tests/test_lineage.py (the OTLP dogfood loop, the window-trace REST
route, the alert-rules knob), tests/test_fleet.py's REST / dfctl / boot
cases, tests/test_tracing.py::test_otlp_to_trace_tree_e2e and
tests/test_push_plane.py::test_debug_plane_and_dfctl_listing; and the
port's own rules: the device defaults to CUDA (raises here) and a device
error in the tick ends `dfctl server` with a non-zero exit.

The pair boots with the reference's defaults for the ingester and the
wire plane: native decode and queue (each package its own library) and
the wire plane on; `test_rest_answers_equal` also reads both servers
with the plane detached, and `test_server_boots_wire_plane` is the twin
of tests/test_wire.py's case."""

from __future__ import annotations

import importlib
import json
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from deepflow_tpu.server.main import Server as RefServer
from deepflow_tpu_torch.server.main import Server

REF, PORT = "deepflow_tpu", "deepflow_tpu_torch"
T0 = 1_700_000_000
REGION = 1
SVC_GROUP = 400
# wall-clock and address fields a server stamps itself
VOLATILE = {"first_seen", "last_seen", "addr", "server_time_us", "last_eval_us",
            "eval_us_p50", "eval_us_max", "last_eval_ms", "age_s", "last_seen_s",
            "frame_ts", "uptime_s", "wall_ms", "eval_ms", "last_rx_age_s",
            # how store events batch up depends on the writer threads' timing
            "event_batches", "evals"}
TAG_DICTS = ("pod_map", "pod_service_map", "pod_group_map", "region_map", "pod_ns_map",
             "host_map", "pod_node_map", "pod_cluster_map")


def m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _wait(cond, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _scrub(obj, floats=False):
    """Drop the volatile fields; with `floats`, hold each float to the
    float rule (see `_f32`), for the side that is the reference."""
    if isinstance(obj, dict):
        return {k: _scrub(v, floats) for k, v in obj.items() if k not in VOLATILE}
    if isinstance(obj, (list, tuple)):
        return [_scrub(v, floats) for v in obj]
    return _f32(obj) if floats else obj


def _f32(v):
    """The float rule: integer-valued below 2^24 exact, else rtol 1e-5."""
    if isinstance(v, float) and not (abs(v) < 2 ** 24 and v == round(v)):
        return pytest.approx(v, rel=1e-5)
    return v


def _same(got, want):
    assert _scrub(got) == _scrub(want, floats=True)


def _k8s_objects(pods=2):
    return {
        "nodes": [{"metadata": {"name": "node-1"},
                   "status": {"addresses": [{"type": "InternalIP", "address": "10.1.0.1"}]}}],
        "namespaces": [{"metadata": {"name": "prod"}}],
        "pods": [
            {"metadata": {"name": f"web-{i}", "namespace": "prod",
                          "ownerReferences": [{"kind": "ReplicaSet", "name": "web-5d9f7d6c4d"}]},
             "spec": {"nodeName": "node-1"}, "status": {"podIP": f"10.2.0.{i + 1}"}}
            for i in range(pods)
        ],
        "services": [{"metadata": {"name": "web-svc", "namespace": "prod"},
                      "spec": {"clusterIP": "10.3.0.1"}}],
    }


def _platform_doc(gen, svc0: str) -> dict:
    """The stream's endpoints as a file-reader cloud source: a pod
    interface per tuple on side 0 (one in 9 in another region), node
    interfaces on side 1, a pod service per pod group (group SVC_GROUP's
    service is `svc0`), names for the tag dictionaries."""
    p = gen.pop
    vifs, pods = [], []
    for i in range(len(p["ip0"])):
        vifs.append(dict(epc_id=int(p["epc0"][i]), ips=[int(p["ip0"][i])], pod_id=1 + i,
                         region_id=REGION + 1 if i % 9 == 0 else REGION, subnet_id=100 + i,
                         az_id=7, pod_node_id=300 + i % 5, pod_group_id=SVC_GROUP + i % 7,
                         pod_cluster_id=9, l3_device_id=1000 + i, l3_device_type=1))
        vifs.append(dict(epc_id=int(p["epc1"][i]), ips=[int(p["ip1"][i])], region_id=REGION,
                         subnet_id=200 + i, pod_node_id=300 + i % 5,
                         pod_group_id=SVC_GROUP + i % 7))
        pods.append({"uid": f"pod-{i}", "name": f"pod-{i}", "pod_group_id": SVC_GROUP + i % 7})
    services = [{"uid": svc0 if g == 0 else f"svc-{g}", "name": f"svc-{g}",
                 "pod_group_id": SVC_GROUP + g} for g in range(7)]
    return {"resources": {"pod": pods, "pod_service": services,
                          "region": [{"uid": "ra", "name": "region-a"},
                                     {"uid": "rb", "name": "region-b"}]},
            "vinterfaces": vifs}


def _stream():
    """Two halves of METRICS frames from the port's L4Pipeline (CPU): the
    second half's docs are all later than the first's."""
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.datamodel.code import DocumentFlag
    from deepflow_tpu_torch.ingest.codec import encode_docbatch
    from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=40, seed=3)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=512),
                      device="cpu")
    docs = []
    for t in range(T0, T0 + 6):
        docs += pipe.ingest(gen.flow_batch(200, t))
    docs += pipe.drain()
    split = int(docs[len(docs) // 2].timestamp[0])
    halves: list[list] = [[], []]
    for db in docs:
        halves[int(db.timestamp[0]) >= split] += encode_docbatch(
            db, flags=int(DocumentFlag.PER_SECOND_METRICS))
    frames = tuple(
        [encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1 + k % 3,
                                 organization_id=1), msgs[i:i + 64])
         for k, i in enumerate(range(0, len(msgs), 64))]
        for msgs in halves)
    return gen, frames, [len(h) for h in halves], split


def _rules_file(path):
    from deepflow_tpu_torch.querier.alerts import AlertRule, save_rules_file

    save_rules_file(path, [
        AlertRule(name="lag", query="lag_ms", comparator=">", threshold=10.0, for_s=0),
        AlertRule(name="shed", query="SELECT Sum(byte_tx) AS b FROM network.1s",
                  comparator=">", threshold=1e12, engine="sql",
                  db="flow_metrics", table="network_1s"),
    ])
    return path


def _config(pkg, tmp, rules):
    return m(pkg, "utils.config").load_config({
        "receiver": {"tcp_port": 0, "udp_port": 0},
        "ingester": {"n_decoders": 2},
        "storage": {"writer_flush_s": 0.05, "root": str(tmp / f"{pkg}_store")},
        "fleet": {"enabled": True, "listen_port": 0, "expiry_s": 120.0},
        "alert_rules": str(rules),
        "region_id": REGION,
    })


def _send(srv, frames, total):
    with socket.create_connection(("127.0.0.1", srv.receiver.tcp_port)) as s:
        s.sendall(b"".join(frames))

        def settled():
            c = srv.flow_metrics.get_counters()
            return (c["docs_in"] == total and c["docs_written"] + c["drop_other_region"] == total
                    and srv.doc_writer.counters["rows"] == c["docs_written"])

        assert _wait(settled), srv.flow_metrics.get_counters()
    srv.doc_writer.flush()


def _drive(pkg, tmp, stream, rules):
    """Boot one package's server and run the whole scenario on it."""
    gen, frames, sizes, _split = stream
    cfg, unknown = _config(pkg, tmp, rules)
    assert unknown == []
    exported = []
    ex = m(pkg, "server.exporters")
    kw = {"device": "cpu"} if pkg == PORT else {}
    srv = (Server if pkg == PORT else RefServer)(
        cfg, lease_path=tmp / f"{pkg}.lease",
        exporters=[ex.CallbackExporter(lambda t, rows: exported.append((t, len(rows))),
                                       data_sources=("network",))], **kw).start()
    out = {"exported": exported}
    assert _wait(lambda: srv.election.is_leader(), timeout=10)
    cloud = m(pkg, "controller.cloud")
    src = cloud.FileReaderPlatform(_platform_doc(gen, "svc-0"), domain="file")
    srv.add_cloud_source(src)
    # discovery: a K8s source and an agent's genesis report reconcile on the tick
    srv.add_cloud_source(cloud.KubernetesGather(_k8s_objects(2), epc_id=7))
    sync = srv.trisolaris.handle_sync({
        "agent_id": 9, "config_rev": 0, "platform_version": 0,
        "genesis": {"hostname": "bare-1", "interfaces": [{"mac": 5, "ips": ["172.16.0.4"]}]}})
    out["sync_analyzer"] = sync["analyzer_ip"]
    # the leader's tick reconciles the sources; the next one compiles the
    # platform (every node refreshes first thing in its tick)
    out["tick0"] = [srv.tick(now=T0), srv.tick(now=T0)]
    # the dictionaries as the tick's sync wrote them (the next tick's
    # store monitor drops their time-0 partitions, in both packages)
    out["dicts"] = {t: _canonical(srv.store.scan("flow_tag", t)) for t in TAG_DICTS}
    _send(srv, frames[0], sizes[0])
    # one resource changes mid-stream: the group's pod service is replaced
    old_id = srv.recorder.id_of("file", "pod_service", "svc-0")
    src.update(_platform_doc(gen, "svc-0-new"))
    out["tick1"] = [srv.tick(now=T0 + 1), srv.tick(now=T0 + 1)]
    out["svc"] = (old_id, srv.recorder.id_of("file", "pod_service", "svc-0"),
                  srv.recorder.id_of("file", "pod_service", "svc-0-new"))
    _send(srv, frames[1], sizes[0] + sizes[1])
    srv.add_datasource(base_table="network_1s", interval="1h")
    out["tick2"] = srv.tick(now=T0 + 3 * 3600)
    srv.events.flush()
    srv.doc_writer.flush()
    out["counters"] = srv.flow_metrics.get_counters()
    return srv, out


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("servers")
    stream = _stream()
    rules = _rules_file(tmp / "rules.yaml")
    servers = {}
    try:
        for pkg in (PORT, REF):
            servers[pkg] = _drive(pkg, tmp, stream, rules)
        yield {"port": servers[PORT][0], "ref": servers[REF][0],
               "port_out": servers[PORT][1], "ref_out": servers[REF][1],
               "stream": stream, "tmp": tmp}
    finally:
        for srv, _ in servers.values():
            srv.stop()


# -- stores -------------------------------------------------------------------

def _canonical(cols: dict, drop=()) -> dict:
    names = sorted(k for k in cols if k not in drop)
    n = len(cols[names[0]]) if names else 0
    keys = [np.unique(np.asarray(cols[k]), return_inverse=True)[1] for k in names]
    order = np.lexsort(keys[::-1]) if n else np.arange(0)
    return {k: np.asarray(cols[k])[order] for k in names}


def _assert_cols_equal(got: dict, want: dict, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        if w.dtype.kind == "f":
            exact = np.all(np.abs(w) < 2 ** 24) and np.all(w == np.round(w))
            if exact:
                assert np.array_equal(g, w), (what, k)
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=str((what, k)))
        else:
            assert np.array_equal(g, w), (what, k)


# columns a server stamps with its wall clock
WALL = {("event", "event"): ("time", "start_time", "end_time")}


def test_servers_store_the_same_tables(pair):
    a, b = pair["port"].store, pair["ref"].store
    assert a.databases() == b.databases()
    n = 0
    for db in b.databases():
        assert a.tables(db) == b.tables(db), db
        for t in b.tables(db):
            assert a.schema(db, t).to_json() == b.schema(db, t).to_json(), (db, t)
            drop = WALL.get((db, t), ())
            _assert_cols_equal(_canonical(a.scan(db, t), drop), _canonical(b.scan(db, t), drop),
                               (db, t))
            n += 1
    assert n > 20
    assert a.row_count("flow_metrics", "network_1s") > 0
    assert a.row_count("flow_metrics", "network_1h") > 0


def test_counters_ticks_and_exports_equal(pair):
    po, ro = pair["port_out"], pair["ref_out"]
    for k in ("tick0", "tick1", "tick2", "sync_analyzer", "svc"):
        assert po[k] == ro[k], k
    # the port's ingester adds its enrichment lanes to the reference's
    assert {k: po["counters"][k] for k in ro["counters"]} == ro["counters"]
    assert po["counters"]["enrich_fetches"] == po["counters"]["enrich_chunks"] > 0
    assert po["tick0"][0]["leader"] and po["tick0"][0]["tagrecorder"]
    assert po["tick0"][0]["resource_changes"] > 0 and po["tick0"][1]["platform"]
    assert po["tick1"][0]["resource_changes"] == 2 and po["tick1"][1]["platform"]
    assert po["tick2"]["downsampled"] > 0
    assert po["svc"][0] > 0 and po["svc"][1] is None and po["svc"][2] > po["svc"][0]
    c = po["counters"]
    assert c["decode_errors"] == 0 and c["drop_other_region"] > 0
    assert c["docs_in"] == sum(pair["stream"][2])
    assert _wait(lambda: sum(n for _, n in po["exported"]) == c["docs_written"])
    assert _wait(lambda: sum(n for _, n in ro["exported"]) == c["docs_written"])
    # rows per table; how the writer's flushes cut them into calls depends
    # on how fast the decoder threads ran
    assert _per_table(po["exported"]) == _per_table(ro["exported"])
    assert all(t.startswith("network") for t, _ in po["exported"])


def _per_table(exported):
    out: dict = {}
    for t, n in exported:
        out[t] = out.get(t, 0) + n
    return out


def test_platform_refresh_carries_the_changed_resource(pair):
    """The docs after the mid-stream change carry the new pod service."""
    split = pair["stream"][3]
    old_id, _, new_id = pair["port_out"]["svc"]
    for srv in (pair["port"], pair["ref"]):
        cols = srv.store.scan("flow_metrics", "network_1s",
                              columns=["time", "pod_group_id_0", "service_id_0"])
        grp = cols["pod_group_id_0"] == SVC_GROUP
        svc, t = cols["service_id_0"][grp], cols["time"][grp]
        assert (svc[t < split] == old_id).any() and not (svc[t < split] == new_id).any()
        assert (svc[t >= split] == new_id).any() and not (svc[t >= split] == old_id).any()
    assert pair["port"].flow_metrics.platform_state.device == torch.device("cpu")
    assert pair["port"].flow_log.platform_state is pair["port"].flow_metrics.platform_state


def test_tag_dictionaries_and_resources_equal(pair):
    a, b = pair["port"], pair["ref"]
    got, want = pair["port_out"]["dicts"], pair["ref_out"]["dicts"]
    for t in TAG_DICTS:
        _assert_cols_equal(got[t], want[t], t)
        assert len(next(iter(got[t].values()))) > 0, t
    assert "pod-3" in set(got["pod_map"]["name"].tolist())
    for kind in ("pod_ns", "host", "pod", "pod_service", "pod_group"):
        got = sorted((r.id, r.name) for r in a.resources.list(kind))
        assert got == sorted((r.id, r.name) for r in b.resources.list(kind)), kind
    assert [r.name for r in a.resources.list("pod_ns")] == ["prod"]
    assert [r.name for r in a.resources.list("host")] == ["bare-1"]
    cols = a.store.scan("event", "event", columns=["resource_type"])
    assert "pod" in set(str(s) for s in cols["resource_type"])


SQL = (
    "SELECT Count() AS c, Sum(byte_tx) AS b, Max(rtt_max) AS m FROM network.1s",
    "SELECT pod_group_id_0 AS g, service_id_0 AS s, Count() AS c, Sum(packet_tx) AS p "
    "FROM network.1s GROUP BY pod_group_id_0, service_id_0 ORDER BY g, s",
    "SELECT region_id_0 AS r, Count() AS c FROM network_map.1s GROUP BY region_id_0 ORDER BY r",
    "SELECT Count() AS c, Sum(byte_tx) AS b, Avg(rtt_sum) AS a FROM network_1h",
    "SELECT interval(time, 3600) AS t, Sum(packet_tx) AS p FROM network "
    "GROUP BY interval(time, 3600) ORDER BY t",
)


def _http(port, path, body=None, method=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k] == _f32(w[k]), k


@pytest.mark.parametrize("wire", ["on", "off"])
def test_rest_answers_equal(pair, wire):
    """Both servers answer alike with the wire plane on (their default)
    and with it detached, as a server without the plane answers."""
    servers = (pair["port"], pair["ref"])
    hubs = [srv.wire for srv in servers]
    assert all(h is not None for h in hubs)
    if wire == "off":
        for srv in servers:
            srv.wire = None
    try:
        _rest_answers_equal(pair, wire == "on")
    finally:
        for srv, hub in zip(servers, hubs):
            srv.wire = hub


def _rest_answers_equal(pair, wire_on: bool):
    a, b = pair["port"].rest.port, pair["ref"].rest.port
    for path in ("/v1/health", "/v1/datasources", "/v1/resources", "/v1/resources/pod_ns",
                 "/v1/resources/pod_service", "/v1/query/tables", "/v1/agents",
                 "/v1/query/catalog?table=network", "/v1/fleet/nope", "/v1/watch",
                 "/v1/watch?promql=m&sql=x", "/v1/wire", "/v1/traces/none",
                 "/v1/trace/window/12345", "/v1/prom?query=up&time=1700000000", "/v1/nope"):
        got, want = _http(a, path), _http(b, path)
        assert got[0] == want[0], path
        _same(got[1], want[1])
    assert _http(a, "/v1/health")[1] == {"status": "ok", "leader": True}
    if wire_on:
        assert _http(a, "/v1/watch")[0] == 400 and _http(a, "/v1/wire")[0] == 200
        assert {"counters", "connections"} <= set(_http(a, "/v1/wire")[1])
    else:
        assert _http(a, "/v1/watch")[0] == 404 and _http(a, "/v1/wire")[0] == 404
    names = [d["name"] for d in _http(a, "/v1/datasources")[1]]
    assert "network_1h" in names
    for sql in SQL:
        got = _http(a, "/v1/query", {"sql": sql})
        want = _http(b, "/v1/query", {"sql": sql})
        assert got[0] == want[0] == 200, (sql, got)
        assert got[1]["columns"] == want[1]["columns"]
        _same_rows(got[1]["rows"], want[1]["rows"])
        assert got[1]["rows"], sql
    code, prof = _http(a, "/v1/profile/device?analyze=0")
    assert code == 200 and {"hbm", "hbm_totals", "census"} <= set(prof)


def test_rest_datasource_and_resource_writes(pair):
    """The leader's POST/DELETE routes, on both servers alike."""
    out = []
    for srv in (pair["port"], pair["ref"]):
        p = srv.rest.port
        out.append([
            _http(p, "/v1/resources/az", {"id": 77, "name": "az-77", "region_id": REGION},
                  method="POST"),
            _http(p, "/v1/resources/az"),
            _http(p, "/v1/resources/az/77", method="DELETE"),
            _http(p, "/v1/resources/az/77", method="DELETE"),
            _http(p, "/v1/datasources", {"base_table": "network_map_1s", "interval": "1h"},
                  method="POST"),
            _http(p, "/v1/datasources/network_map_1h", method="DELETE"),
            _http(p, "/v1/nope", {}, method="POST"),
        ])
    assert out[0] == out[1]
    assert out[0][0][0] == 201 and out[0][2] == (200, {"deleted": True})
    assert out[0][3][0] == 404 and out[0][4] == (201, {"name": "network_map_1h"})


def test_debug_answers_equal(pair):
    dbg = m(PORT, "server.debug")
    a, b = pair["port"].debug.port, pair["ref"].debug.port
    for cmd in ("ping", "tables", "datasources", "subscriptions", "alerts", "agents", "nope"):
        got = dbg.debug_request("127.0.0.1", a, {"cmd": cmd})
        want = dbg.debug_request("127.0.0.1", b, {"cmd": cmd})
        _same(got, want)
    assert dbg.debug_request("127.0.0.1", a, {"cmd": "ping"})["pong"]
    tabs = dbg.debug_request("127.0.0.1", a, {"cmd": "tables"})["tables"]
    assert tabs["flow_metrics"]["network_1s"] > 0
    alerts = dbg.debug_request("127.0.0.1", a, {"cmd": "alerts"})["alerts"]
    assert {r["name"] for r in alerts} == {"lag", "shed"}
    counters = dbg.debug_request("127.0.0.1", a, {"cmd": "counters",
                                                  "module": "table_writer"})["counters"]
    assert counters and all(c["module"] == "table_writer" for c in counters)


def _rpc(port, method, params=None, rid=1):
    body = json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": params or {}}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/mcp", data=body)
    with urllib.request.urlopen(req) as resp:
        return json.loads(resp.read())


def test_mcp_answers_equal(pair):
    a, b = pair["port"].mcp.port, pair["ref"].mcp.port
    calls = [("initialize", None), ("tools/list", None),
             ("tools/call", {"name": "list_catalog", "arguments": {"table": "application"}}),
             ("tools/call", {"name": "query_sql", "arguments": {"sql": SQL[1]}}),
             ("tools/call", {"name": "query_promql", "arguments": {"promql": "up",
                                                                  "time": T0}}),
             ("tools/call", {"name": "trace_map", "arguments": {}}),
             ("tools/call", {"name": "analyze_profile", "arguments": {"app_service": "x"}}),
             ("tools/call", {"name": "nope", "arguments": {}}), ("nope", None)]
    for method, params in calls:
        got, want = _rpc(a, method, params), _rpc(b, method, params)
        assert got == want, (method, params)
    init = _rpc(a, "initialize")
    assert init["result"]["serverInfo"]["name"].startswith("deepflow")
    names = {t["name"] for t in _rpc(a, "tools/list")["result"]["tools"]}
    assert {"query_sql", "query_promql", "query_trace", "trace_map", "analyze_profile",
            "list_catalog"} <= names
    rows = json.loads(_rpc(a, "tools/call", {"name": "query_sql", "arguments": {
        "sql": SQL[0]}})["result"]["content"][0]["text"])
    assert rows[0]["c"] > 0


def test_each_dfctl_query_reads_the_others_store(pair, capsys):
    port_cli, ref_cli = m(PORT, "cli"), m(REF, "cli")
    roots = {pkg: str(pair["tmp"] / f"{pkg}_store") for pkg in (PORT, REF)}
    for sql in SQL:
        outs = []
        for cli, root, extra in ((port_cli, roots[REF], ["--device", "cpu"]),
                                 (ref_cli, roots[PORT], []),
                                 (port_cli, roots[PORT], ["--device", "cpu"]),
                                 (ref_cli, roots[REF], [])):
            cli.main(["query", "--store", root, *extra, sql])
            outs.append(json.loads(capsys.readouterr().out))
        for o in outs[1:]:
            _same_rows(o, outs[0])
        assert outs[0], sql
    port_cli.main(["tables", "--store", roots[REF]])
    got = json.loads(capsys.readouterr().out)
    ref_cli.main(["tables", "--store", roots[REF]])
    assert got == json.loads(capsys.readouterr().out)


# -- tests/test_server_cli.py::test_cli_reads_store ------------------------

def _cli_store(pkg, root, capsys):
    st = m(pkg, "storage.store")
    store = st.ColumnarStore(root)
    store.create_table("flow_metrics", st.TableSchema("application_1s", (
        st.ColumnSpec("time", "u4"), st.ColumnSpec("request", "f4"),
        st.ColumnSpec("rrt_sum", "f4"), st.ColumnSpec("rrt_count", "f4"))))
    store.insert("flow_metrics", "application_1s", {
        "time": np.full(10, T0, np.uint32), "request": np.ones(10, np.float32),
        "rrt_sum": np.full(10, 5.0, np.float32), "rrt_count": np.ones(10, np.float32)})
    cli = m(pkg, "cli")
    out = []
    dev = ["--device", "cpu"] if pkg == PORT else []
    for argv in (["query", "--store", str(root), *dev,
                  "SELECT Sum(request) AS req FROM application.1s"],
                 ["tables", "--store", str(root)],
                 ["metrics", "--store", str(root), "application_1s"],
                 ["promql", "--store", str(root), "up", "-t", str(T0)]):
        try:
            cli.main(argv)
            out.append(json.loads(capsys.readouterr().out))
        except Exception as exc:  # both packages must fail alike
            capsys.readouterr()
            out.append(type(exc).__name__)
    return out


def test_cli_reads_store(tmp_path, capsys):
    got = _cli_store(PORT, tmp_path / "p", capsys)
    assert got == _cli_store(REF, tmp_path / "r", capsys)
    assert got[0] == [{"req": 10.0}]
    assert got[1]["flow_metrics"]["application_1s"] == 10
    assert got[2]["rrt_avg"] == "derived"


# -- the OTLP trace lanes through the servers' own planes -----------------------

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
    _put_varint(b, v)
    return bytes(b)


def _otlp_trace_fixture():
    """Three services, one trace: frontend -> cart -> db."""
    tid = bytes.fromhex("0102030405060708090a0b0c0d0e0f10")

    def mkspan(sid, psid, name, kind, dur_ms, status=0):
        body = (_ld(1, tid) + _ld(2, sid) + (_ld(4, psid) if psid else b"")
                + _ld(5, name.encode()) + _vi(6, kind) + _vi(7, T0 * 10**9)
                + _vi(8, T0 * 10**9 + dur_ms * 10**6))
        if status:
            body += _ld(15, _vi(3, status))
        return body

    def resource_spans(svc, spans):
        sname = _ld(1, b"service.name") + _ld(2, _ld(1, svc.encode()))
        return _ld(1, _ld(1, _ld(1, sname)) + _ld(2, b"".join(_ld(2, sp) for sp in spans)))

    a, b, c = b"\x01" * 8, b"\x02" * 8, b"\x03" * 8
    return (resource_spans("frontend", [mkspan(a, b"", "GET /", 2, 30)])
            + resource_spans("cart", [mkspan(b, a, "GET /cart", 2, 20)])
            + resource_spans("db", [mkspan(c, b, "SELECT", 2, 5, status=2)]))


TRACE_ID = "0102030405060708090a0b0c0d0e0f10"


def _otlp_through(pkg, srv):
    col = m(pkg, "integration.collector").IntegrationCollector(
        [("127.0.0.1", srv.receiver.tcp_port)])
    try:
        srv.trace_builder.close_after_s = 0.0
        before = srv.trace_builder.get_counters()["spans_in"]
        req = urllib.request.Request(f"http://127.0.0.1:{col.port}/v1/traces",
                                     data=_otlp_trace_fixture())
        with urllib.request.urlopen(req) as resp:
            assert resp.status == 200
        assert _wait(lambda: srv.trace_builder.get_counters()["spans_in"] >= before + 3)
        srv.trace_builder.tick()
        srv.trace_builder.flush()
        srv.integration.flush()
    finally:
        col.stop()
    p = srv.rest.port
    return {"trace": _http(p, f"/v1/traces/{TRACE_ID}"),
            "map": _http(p, "/v1/tracemap"),
            "tempo": _http(p, f"/api/traces/{TRACE_ID}"),
            "mcp": _rpc(srv.mcp.port, "tools/call",
                        {"name": "query_trace", "arguments": {"trace_id": TRACE_ID}}),
            "direct": m(pkg, "tracing.query").query_trace(srv.store, TRACE_ID)}


def test_otlp_to_trace_tree_e2e(pair):
    got, want = _otlp_through(PORT, pair["port"]), _otlp_through(REF, pair["ref"])
    assert got == want
    tree = got["direct"]
    by_svc = {n["app_service"]: n for n in tree["nodes"]}
    assert set(by_svc) == {"frontend", "cart", "db"}
    assert by_svc["cart"]["parent_node_index"] == tree["nodes"].index(by_svc["frontend"])
    assert by_svc["db"]["parent_node_index"] == tree["nodes"].index(by_svc["cart"])
    assert by_svc["db"]["response_status_server_error_count"] == 1
    assert by_svc["frontend"]["level"] == 0 and by_svc["db"]["level"] == 2
    pairs = {(e["client"], e["server"]) for e in got["map"][1]}
    assert ("frontend", "cart") in pairs and ("cart", "db") in pairs
    assert got["trace"][0] == 200 and got["tempo"][0] == 200


# -- window lineage through the port server (tests/test_lineage.py) ------------

class _FakeClock:
    def __init__(self, t: float):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


def _lineage_pipe():
    from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
    from deepflow_tpu_torch.aggregator.window import WindowConfig
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    from deepflow_tpu_torch.tracing.lineage import FreshnessTracker, LineageTracker

    fr = FreshnessTracker(autoregister=False)
    lin = LineageTracker("tpu.pipeline", 1, freshness=fr, clock=_FakeClock(2_000_000_000.0))
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=256),
                      device="cpu")
    pipe.attach_lineage(lin)
    gen = SyntheticFlowGen(num_tuples=30, seed=2)
    for i in range(6):
        pipe.ingest(gen.flow_batch(96, T0 + i))
    pipe.drain()
    return lin


def test_rest_window_trace_and_otlp_dogfood(pair):
    """`GET /v1/trace/window/<id>` serves the live lineage tree; the same
    spans exported through the OtlpExporter into the server's own
    collector lane come back as a stored tree with the same hops."""
    from deepflow_tpu_torch.server.exporters import OtlpExporter
    from deepflow_tpu_torch.tracing.lineage import (
        HOP_FLUSH_DRAIN, HOP_INGEST_DISPATCH, HOP_WINDOW_ADVANCE, window_trace_id)

    srv = pair["port"]
    lin = _lineage_pipe()
    try:
        live = lin.assemble(T0)
        code, got = _http(srv.rest.port, f"/v1/trace/window/{T0}?interval=1&service=tpu.pipeline")
        assert code == 200 and got["window"] == T0
        assert got["trace_id"] == window_trace_id("tpu.pipeline", T0, 1)
        hops = {n["app_service"] for n in got["nodes"]}
        assert {HOP_INGEST_DISPATCH, HOP_WINDOW_ADVANCE, HOP_FLUSH_DRAIN} <= hops
        assert hops == {n["app_service"] for n in live["nodes"]} and "freshness" in got
        assert _http(srv.rest.port, "/v1/trace/window/12345")[0] == 404

        col = m(PORT, "integration.collector").IntegrationCollector(
            [("127.0.0.1", srv.receiver.tcp_port)])
        try:
            srv.trace_builder.close_after_s = 0.0
            before = srv.trace_builder.get_counters()["spans_in"]
            exp = OtlpExporter(traces_url=f"http://127.0.0.1:{col.port}/v1/traces")
            n = lin.export_otlp(exp)
            assert n >= len(hops) and exp.get_counters()["errors"] == 0
            assert _wait(lambda: srv.trace_builder.get_counters()["spans_in"] >= before + n)
            srv.trace_builder.tick()
            srv.trace_builder.flush()
        finally:
            col.stop()
        stored = m(PORT, "tracing.lineage").query_window_trace(srv.store, T0)
        assert {x["app_service"] for x in stored["nodes"]} == hops
        assert sum(1 for x in stored["nodes"] if x["parent_node_index"] < 0) == 1
    finally:
        lin.close()


def test_server_config_alert_rules_knob(pair, tmp_path):
    """Rules load at boot; a malformed rules file fails the boot."""
    for srv in (pair["port"], pair["ref"]):
        assert {r["name"] for r in srv.alerts.list_rules()} == {"lag", "shed"}
    _same(pair["port"].alerts.list_rules(), pair["ref"].alerts.list_rules())
    (tmp_path / "bad.yaml").write_text("rules:\n  - name: x\n")
    cfg, _ = m(PORT, "utils.config").load_config({
        "receiver": {"tcp_port": 0, "udp_port": 0}, "wire": {"enabled": False},
        "alert_rules": str(tmp_path / "bad.yaml")})
    srv = Server(cfg, exporters=[], device="cpu")
    try:
        with pytest.raises(ValueError, match="missing required key"):
            srv.start()
    finally:
        srv.receiver.stop()


# -- the fleet plane (tests/test_fleet.py) ----------------------------------------

def _fleet_frame(pkg, srv):
    fleet = m(pkg, "fleet")
    col = m(pkg, "utils.stats").StatsCollector()

    class C:
        def get_counters(self):
            return {"flow_in": 9}

    c = C()
    col.register("tpu_mesh_swm", c, group="0")
    exp = fleet.FleetExporter("hX", group="0", collector=col, clock=lambda: 1000.0)
    sink = fleet.FleetSink(srv.fleet.endpoint(), exp)
    try:
        col.add_sink(sink)
        col.tick(1000.0)
        assert sink.flush(10)
        assert _wait(lambda: srv.fleet.counters["frames_rx"] >= 1, timeout=5)
    finally:
        sink.close()
    prom = m(pkg, "querier.promql").query_instant(
        srv.store, 'tpu_mesh_swm_flow_in{host="hX"}', 1000,
        db="deepflow_system", table="deepflow_system")
    p = srv.rest.port
    return {"prom": prom, "health": _http(p, "/v1/fleet/health"),
            "hosts": _http(p, "/v1/fleet/hosts"), "skew": _http(p, "/v1/fleet/skew"),
            "nope": _http(p, "/v1/fleet/nope")}


def test_server_fleet_plane_and_dfctl(pair, capsys):
    got, want = _fleet_frame(PORT, pair["port"]), _fleet_frame(REF, pair["ref"])
    _same(got, want)
    assert [s["value"] for s in got["prom"]] == [9.0]
    assert got["health"][1]["hosts"] == 1 and got["nope"][0] == 404
    assert got["hosts"][1][0]["host"] == "hX" and got["hosts"][1][0]["stale"] is False
    cli = m(PORT, "cli")
    port = str(pair["port"].rest.port)
    cli.main(["fleet", "--port", port, "health", "--json"])
    assert json.loads(capsys.readouterr().out)["hosts"] == 1
    cli.main(["fleet", "--port", port, "hosts"])
    human = capsys.readouterr().out
    assert "hX" in human and "{" not in human.split("\n")[0]
    cli.main(["profile", "--port", port, "device", "--no-analyze", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert "hbm" in out and "census" in out
    cli.main(["profile", "--port", port, "device", "--no-analyze"])
    assert "# hbm ledger" in capsys.readouterr().out


def test_rest_fleet_404_when_disabled():
    class _Stub:
        fleet = None
        election = None

    rest = m(PORT, "controller.rest").RestServer(_Stub())
    try:
        assert _http(rest.port, "/v1/fleet/health")[0] == 404
        assert _http(rest.port, "/v1/watch")[0] == 404
    finally:
        rest.stop()


# -- the push plane's debug listing (tests/test_push_plane.py) ---------------------

def _debug_listing(pkg, capsys):
    ev = m(pkg, "querier.events")
    live = m(pkg, "querier.live")
    dfstats = m(pkg, "integration.dfstats")
    alerts = m(pkg, "querier.alerts")
    store = m(pkg, "storage.store").ColumnarStore()
    dfstats.ensure_system_table(store)
    bus = ev.QueryEventBus(name="w")
    cache = live.QueryResultCache(max_entries=64)
    cache.attach_bus(bus)
    ev.connect_store_events(store, bus)
    reg = live.LiveRegistry()
    dev = {"device": "cpu"} if pkg == PORT else {}
    subs = m(pkg, "querier.subscribe").SubscriptionManager(store, live=reg, cache=cache,
                                                           bus=bus, name="w", **dev)
    eng = alerts.AlertEngine(store, live=reg, bus=bus, name="dbg", log_sink=False, **dev)
    eng.add_rule(alerts.AlertRule(name="r1", query="m", comparator=">", threshold=10.0,
                                  for_s=0))
    db, table = dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE
    subs.subscribe_promql("m", span_s=5, step=1, db=db, table=table, queue=True)
    store.insert(db, table, {"time": np.asarray([T0], np.uint32),
                             "metric": np.asarray(["m"], object),
                             "labels": np.asarray([""], object),
                             "value": np.asarray([50.0], np.float64)})
    bus.publish(ev.WindowClosed(db, table, T0))
    debug = m(pkg, "server.debug")
    dbg = debug.DebugServer(context={"subscriptions": subs, "alerts": eng})
    out = []
    try:
        for cmd in ("subscriptions", "alerts"):
            out.append(debug.debug_request("127.0.0.1", dbg.port, {"cmd": cmd}))
            m(pkg, "cli").main([cmd, "--port", str(dbg.port)])
            out.append(json.loads(capsys.readouterr().out))
    finally:
        dbg.stop()
        subs.close()
        eng.close()
    dbg2 = debug.DebugServer(context={})
    try:
        out.append(sorted(debug.debug_request("127.0.0.1", dbg2.port, {"cmd": "alerts"})))
    finally:
        dbg2.stop()
    return out


def test_debug_plane_and_dfctl_listing(capsys):
    got = _debug_listing(PORT, capsys)
    _same(got, _debug_listing(REF, capsys))
    subs, subs_cli, alerts, alerts_cli, missing = got
    assert subs["subscriptions"][0]["watchers"] == 1 and subs["subscriptions"][0]["evals"] >= 1
    assert "last_eval_us" in subs["subscriptions"][0]
    assert alerts["alerts"][0]["name"] == "r1" and alerts["alerts"][0]["state"] == "firing"
    assert alerts["counters"]["firing"] == 1
    assert subs_cli["subscriptions"][0]["watchers"] == 1
    assert alerts_cli["alerts"][0]["state"] == "firing" and missing == ["error"]


# -- the port's own rules ---------------------------------------------------------

def _cfg(**extra):
    doc = {"receiver": {"tcp_port": 0, "udp_port": 0}, "wire": {"enabled": False}}
    doc.update(extra)
    return m(PORT, "utils.config").load_config(doc)[0]


def test_server_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(_cfg(), device="cuda")
    assert Server(_cfg(), device="cpu").device == torch.device("cpu")


def _sse_events(port: int, params: dict, events: list, stop):
    """Stream GET /v1/watch, appending each `data:` event until EOF or
    `stop` (checked per line; heartbeats keep lines flowing)."""
    url = f"http://127.0.0.1:{port}/v1/watch?" + urllib.parse.urlencode(params)
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            for raw in r:
                if raw.startswith(b"data: "):
                    events.append(json.loads(raw[6:]))
                if stop.is_set():
                    return
    except (OSError, urllib.error.URLError):
        pass


def _insert_sample(pkg, store, t, value):
    dfstats = m(pkg, "integration.dfstats")
    dfstats.ensure_system_table(store)
    store.insert(dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE, {
        "time": np.asarray([t], np.uint32), "metric": np.asarray(["m"], object),
        "labels": np.asarray([""], object), "value": np.asarray([value], np.float64)})


def _watch_once(pkg, srv, t, value):
    """One SSE stream (promql `m`, local) on a live server: a sample goes
    in (its store event evaluates at wall time, before the stream opens),
    then its WindowClosed; the stream's one event comes out."""
    events: list = []
    stop = threading.Event()
    _insert_sample(pkg, srv.store, t, value)
    th = threading.Thread(target=_sse_events, daemon=True, args=(
        srv.rest.port, {"promql": "m", "scope": "local", "span_s": 5, "max_events": 1,
                        "heartbeat_s": 0.2}, events, stop))
    th.start()
    try:
        assert _wait(lambda: srv.wire.get_counters()["connections_open"] == 1)
        dfstats = m(pkg, "integration.dfstats")
        srv.event_bus.publish(m(pkg, "querier.events").WindowClosed(
            dfstats.DEEPFLOW_SYSTEM_DB, dfstats.DEEPFLOW_SYSTEM_TABLE, t))
        assert _wait(lambda: events)
        th.join(timeout=30)
        assert not th.is_alive()
    finally:
        stop.set()
    return events


def test_watch_streams_equal(pair):
    """The same sample on both live servers: the SSE streams deliver the
    same event."""
    got = _watch_once(PORT, pair["port"], T0 + 7200, 8.0)
    want = _watch_once(REF, pair["ref"], T0 + 7200, 8.0)
    assert got == want and got[0]


def test_server_boots_wire_plane(tmp_path):
    """The reference's default config (wire plane on, native decode), with
    the TCP listener and the router on too, boots; a row reaches an SSE
    client through the live server; the router pane rides /v1/wire."""
    cfg, _ = m(PORT, "utils.config").load_config({
        "receiver": {"tcp_port": 0, "udp_port": 0},
        "storage": {"root": str(tmp_path / "store")},
        "wire": {"tcp_enabled": True, "router_enabled": True, "lease_s": 45.0},
    })
    assert cfg.wire.enabled and cfg.ingester.prefer_native  # the reference's defaults
    srv = Server(cfg, exporters=[], device="cpu").start()
    try:
        assert srv.flow_metrics._use_native, m(PORT, "native").build_error()
        assert srv.wire is not None and srv.wire.lease_s == 45.0
        assert srv.wire_tcp is not None and srv.wire_tcp.port > 0
        assert srv.wire_router is not None and srv.wire_router.port > 0
        events = _watch_once(PORT, srv, T0, 8.0)
        assert events and events[0][0]["values"]
        code, pane = _http(srv.rest.port, "/v1/wire")
        assert code == 200 and pane["counters"]["deliveries"] >= 1
        assert "router" in pane, "router pane rides /v1/wire when enabled"
        srv.tick()  # the reap lane runs on the server clock
    finally:
        srv.stop()
    assert not srv.started


def test_dfctl_server_ends_on_a_device_error(tmp_path, monkeypatch, capsys):
    """A host fault in the tick is printed and the server keeps serving; a
    device fault stops the server and exits non-zero."""
    cli = m(PORT, "cli")
    main_mod = m(PORT, "server.main")
    path = tmp_path / "server.json"
    path.write_text(json.dumps({"receiver": {"tcp_port": 0, "udp_port": 0},
                                "wire": {"enabled": False}}))
    faults = [ValueError("a host fault"),
              RuntimeError("CUDA error: an illegal memory access was encountered")]
    started = []
    orig_start = main_mod.Server.start

    def start(self):
        started.append(self)
        return orig_start(self)

    def tick(self, now=None):
        raise faults.pop(0)

    monkeypatch.setattr(main_mod.Server, "start", start)
    monkeypatch.setattr(main_mod.Server, "tick", tick)
    monkeypatch.setattr(cli.time, "sleep", lambda s: None)
    with pytest.raises(SystemExit) as ei:
        cli.main(["server", "--device", "cpu", "-f", str(path)])
    assert ei.value.code == 1 and faults == []
    out = capsys.readouterr()
    assert "tick error: ValueError('a host fault')" in out.out
    assert "tick error on the device" in out.err
    assert started and not started[0].started  # stopped on the way out
    dev = m(PORT, "device")
    assert dev.is_device_error(RuntimeError("CUDA error: misaligned address"))
    assert not dev.is_device_error(ValueError("CUDA in a message of another type"))
    wrapped = RuntimeError("worker died")
    wrapped.__cause__ = RuntimeError("CUDA launch failed (700): illegal address")
    assert dev.is_device_error(wrapped)


def test_second_start_in_one_process(tmp_path):
    """stop() detaches the process-wide planes, so a second server boots
    and serves in the same process; the reference's planes stay apart."""
    from deepflow_tpu.querier.events import default_event_bus as ref_bus
    from deepflow_tpu_torch.querier.events import default_event_bus as port_bus

    assert ref_bus is not port_bus
    for _ in range(2):
        srv = Server(_cfg(storage={"root": str(tmp_path / "s")}), exporters=[],
                     device="cpu").start()
        try:
            assert srv.event_bus is port_bus
            assert _http(srv.rest.port, "/v1/health")[0] == 200
        finally:
            srv.stop()
