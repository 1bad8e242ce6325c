"""The port's controller plane against the reference's: each scenario of
tests/test_controller.py, tests/test_controller_plane.py and
tests/test_prom_labels.py runs through both packages on the same inputs,
and the ids, tables, sync payloads and tag dictionaries must be equal.
The resource plane's platform table, compiled on the CPU, enriches a
seeded doc batch equal to the reference's compiled table."""

from __future__ import annotations

import importlib
import json
import logging
import time

import numpy as np
import pytest

REF, PORT = "deepflow_tpu", "deepflow_tpu_torch"
T0 = 1_700_000_000


def m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def both(scenario, *args):
    """Run a scenario on each package; returns (port, reference)."""
    return scenario(PORT, *args), scenario(REF, *args)


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


def _db_dump(db) -> dict:
    return {kind: sorted((r.id, r.name, json.dumps(r.attrs, sort_keys=True, default=str))
                         for r in rows)
            for kind, rows in ((k, db.list(k)) for k, _ in db.iter_kinds())}


def _store_dump(store) -> dict:
    out = {}
    for db in store.databases():
        for t in store.tables(db):
            cols = store.scan(db, t)
            out[(db, t)] = {k: [str(x) for x in np.asarray(v).tolist()] for k, v in cols.items()}
    return out


# -- tests/test_controller.py -------------------------------------------------

def _resource_versioning(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    v0 = db.version
    db.put("pod", 101, "web-0", pod_node_id=3)
    db.put("region", 1, "us-west")
    out = [db.version - v0, db.get("pod", 101).name, [r.name for r in db.list("region")]]
    db.delete("pod", 101)
    v1 = db.version
    db.delete("pod", 999)
    out += [db.get("pod", 101), db.version == v1, _db_dump(db)]
    return out


def test_resource_versioning_and_reads():
    got, want = both(_resource_versioning)
    assert got == want
    assert got[:3] == [2, "web-0", ["us-west"]] and got[3] is None and got[4]


def _tagrecorder(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    store = m(pkg, "storage.store").ColumnarStore()
    tr = m(pkg, "querier.translation").Translator(store)
    rec = m(pkg, "controller.tagrecorder").TagRecorder(db, store, translator=tr)
    db.put("pod", 7, "checkout-7f9c")
    db.put("auto_service", 33, "payments")
    db.put("pod", 9, "labelled", labels={"app": "web", "tier": "fe"})
    out = [rec.sync(), rec.sync(),
           list(tr.translate("application_1s", "pod_id_0", np.array([7, 8]))),
           list(tr.translate("application_1s", "auto_service_id_0", np.array([33])))]
    db.put("pod", 7, "checkout-new")
    out += [rec.sync(), list(tr.translate("t", "pod_id_0", np.array([7]))),
            _store_dump(store), rec.get_counters()]
    return out


def test_tagrecorder_feeds_querier_translation():
    got, want = both(_tagrecorder)
    assert got == want
    assert got[:6] == [True, False, ["checkout-7f9c", "8"], ["payments"], True,
                       ["checkout-new"]]


def _trisolaris_sync(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    db.add_vinterface(epc_id=5, ips=["10.0.0.9"], pod_id=42)
    tri = m(pkg, "controller.trisolaris")
    svc = tri.TrisolarisService(db)
    out = []
    try:
        cli = tri.AgentSyncClient([("127.0.0.1", svc.port)], agent_id=3,
                                  max_escape_s=100.0, defaults={"sampling": 1})
        out += [cli.sync_once(now=1000.0), cli.platform, dict(cli.config)]
        svc.set_group_config("default", {"sampling": 16})
        out += [cli.sync_once(now=1001.0), dict(cli.config)]
        rev = cli.config_rev
        out += [cli.sync_once(now=1002.0), cli.config_rev == rev, svc.agents[3]["group"]]
        svc.stop()
        out += [cli.sync_once(now=1050.0), dict(cli.config), cli.escaped]
        out += [cli.sync_once(now=1200.0), cli.escaped, dict(cli.config)]
    finally:
        svc.stop()
    return out


def test_trisolaris_sync_and_escape():
    got, want = both(_trisolaris_sync)
    assert got == want
    assert got[0] and got[1]["interfaces"][0]["pod_id"] == 42
    assert got[4] == {"sampling": 16} and got[6] and got[7] == "default"
    assert not got[8] and got[9] == {"sampling": 16} and not got[10]
    assert not got[11] and got[12] and got[13] == {"sampling": 1}


def _election(pkg, tmp_path):
    LeaderElection = m(pkg, "controller.election").LeaderElection
    lease = tmp_path / f"{pkg}.lease"
    a = LeaderElection(lease, "ctrl-a", lease_s=2.0)
    b = LeaderElection(lease, "ctrl-b", lease_s=2.0)
    out = [a.try_acquire(now=100.0), b.try_acquire(now=100.5), a.try_acquire(now=101.0),
           a.counters["renewals"], b.try_acquire(now=103.5), b.is_leader(),
           a.try_acquire(now=103.6), a.counters["losses"]]
    b._leader = True
    b.stop()
    out += [a.try_acquire(now=103.7), dict(a.counters), dict(b.counters)]
    return out


def test_leader_election(tmp_path):
    got, want = both(_election, tmp_path)
    assert got == want
    assert got[:9] == [True, False, True, 1, True, True, False, 1, True]


def _ntp_upgrade(pkg):
    tri = m(pkg, "controller.trisolaris")
    svc = tri.TrisolarisService(m(pkg, "controller.resources").ResourceDB())
    out = []
    try:
        cli = tri.AgentSyncClient([("127.0.0.1", svc.port)], agent_id=9)
        out += [cli.sync_once(), abs(cli.ntp_offset_us) < 2_000_000,
                abs(cli.corrected_time_us() - int(time.time() * 1e6)) < 5_000_000,
                cli.pending_upgrade]
        pkg_bytes = b"agent-binary-bytes" * 100
        svc.set_upgrade("default", "v7.0.1", pkg_bytes)
        out += [cli.sync_once(), dict(cli.pending_upgrade)]
        version, data = cli.pull_upgrade()
        out += [data == pkg_bytes, version, cli.pending_upgrade is not None]
        cli.confirm_upgrade(version)
        out += [cli.agent_version, cli.sync_once(), cli.pending_upgrade,
                svc.counters["upgrade_pulls"]]
    finally:
        svc.stop()
    return out


def test_trisolaris_ntp_and_upgrade():
    got, want = both(_ntp_upgrade)
    assert got == want
    assert got[:4] == [True, True, True, None] and got[5]["version"] == "v7.0.1"
    assert got[6:] == [True, "v7.0.1", True, "v7.0.1", True, None, 1]


def _plural_json(pkg, tmp_path, caplog):
    db = m(pkg, "controller.resources").ResourceDB()
    store = m(pkg, "storage.store").ColumnarStore(tmp_path / pkg)
    trmod = m(pkg, "controller.tagrecorder")
    rec = trmod.TagRecorder(db, store)
    big = {f"label-key-{i}": "v" * 40 for i in range(40)}
    db.put("pod", 1, "huge-labels", labels=big)
    db.put("pod", 2, "ok-labels", labels={"app": "web"})
    caplog.clear()
    with caplog.at_level(logging.WARNING, f"{pkg}.controller.tagrecorder"):
        synced = rec.sync()
    warned = any("pod_k8s_labels_map" in r.message for r in caplog.records)
    cols = store.scan(trmod.FLOW_TAG_DB, "pod_k8s_labels_map", columns=["id", "value"])
    by_id = {int(i): json.loads(str(v)) for i, v in zip(cols["id"], cols["value"])}
    return [synced, warned, rec.get_counters()["plural_json_truncated"], by_id,
            rec.sync(), rec.get_counters()["plural_json_truncated"]]


def test_tagrecorder_counts_plural_json_truncation(tmp_path, caplog):
    got = _plural_json(PORT, tmp_path, caplog)
    want = _plural_json(REF, tmp_path, caplog)
    assert got == want
    assert got[:3] == [True, True, 1] and got[3][2] == {"app": "web"}
    assert len(got[3][1]) == 40 and got[4:] == [False, 1]


# -- the platform table the resource plane compiles ---------------------------

def _resource_platform(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    db.add_vinterface(epc_id=9, ips=["10.1.1.1"], pod_id=55, region_id=2, az_id=4,
                      subnet_id=6, pod_cluster_id=1)
    db.add_vinterface(epc_id=9, ips=["10.1.1.2", "fd00::7"], pod_id=56, region_id=3,
                      az_id=5, subnet_id=7, pod_node_id=11)
    db.add_vinterface(epc_id=12, ips=["10.9.0.1"], pod_id=57, region_id=2, az_id=4)
    db.put("pod", 55, "web-0", pod_node_id=11, pod_group_id=21, pod_ns_id=31,
           pod_cluster_id=1)
    db.put("pod", 56, "web-1", pod_node_id=11, pod_group_id=21, pod_ns_id=31)
    db.put("pod_service", 41, "web-svc", pod_group_id=21)
    return db


def _seeded_tags(n: int, seed: int):
    from deepflow_tpu_torch.datamodel.code import CodeId
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA

    rng = np.random.default_rng(seed)
    tags = np.zeros((n, TAG_SCHEMA.num_fields), np.uint32)

    def put(name, vals):
        tags[:, TAG_SCHEMA.index(name)] = np.asarray(vals, np.uint64).astype(np.uint32)

    put("code_id", rng.choice([int(CodeId.SINGLE_IP_PORT), int(CodeId.EDGE_IP_PORT)], n))
    put("l3_epc_id", rng.choice([9, 12, 0], n))
    put("l3_epc_id1", rng.choice([9, 12], n))
    ips = np.array([0x0A010101, 0x0A010102, 0x0A090001, 0x08080808], np.uint32)
    put("ip0_w3", rng.choice(ips, n))
    put("ip1_w3", rng.choice(ips, n))
    put("pod_id", rng.choice([0, 55, 56, 99], n))
    put("server_port", rng.choice([0, 80], n))
    put("protocol", rng.choice([6, 17], n))
    put("tap_side", rng.choice([0, 1, 2], n))
    return tags


@pytest.mark.parametrize("region", [0, 2])
def test_resource_platform_table_enriches_equal(region):
    import torch

    from deepflow_tpu.enrich import platform as ref_platform
    from deepflow_tpu_torch.enrich import platform
    from deepflow_tpu_torch.ops.u32 import to_numpy_u32

    tags = _seeded_tags(512, seed=region + 3)
    valid = np.random.default_rng(5).random(512) < 0.9
    port_state = _resource_platform(PORT).build_platform_table(region).build(device="cpu")
    ref_state = _resource_platform(REF).build_platform_table(region).build()
    assert port_state.device == torch.device("cpu")
    s0, s1, keep, drops = platform.enrich_docs(port_state, tags, valid)
    r0, r1, rkeep, rdrops = ref_platform.enrich_docs(ref_state, tags, valid)
    for got, want in ((s0, r0), (s1, r1)):
        assert sorted(got) == sorted(want)
        for f in want:
            assert np.array_equal(to_numpy_u32(got[f]), np.asarray(want[f])), f
    assert np.array_equal(keep.numpy(), np.asarray(rkeep)) and int(drops) == int(rdrops)
    assert (to_numpy_u32(s0["pod_id"]) == 55).any()
    if region == 2:
        assert int(drops) > 0


# -- tests/test_controller_plane.py ----------------------------------------

def _recorder_cycle(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    events = []
    rec = m(pkg, "controller.recorder").Recorder(db, event_sink=events.append)
    snap = {"resources": {"pod": [{"uid": "p/a", "name": "a"}, {"uid": "p/b", "name": "b"}]}}
    cs1 = rec.reconcile("dom", snap)
    ida = rec.id_of("dom", "pod", "p/a")
    v = db.version
    cs2 = rec.reconcile("dom", snap)
    unchanged = db.version == v
    cs3 = rec.reconcile("dom", {"resources": {"pod": [{"uid": "p/a", "name": "a2"}]}})
    return [(cs1.created, cs1.updated, cs1.deleted), cs2.total, unchanged,
            (cs3.created, cs3.updated, cs3.deleted), ida, rec.id_of("dom", "pod", "p/a"),
            db.get("pod", ida).name, [e["type"] for e in events], _db_dump(db)]


def test_recorder_create_update_delete_cycle():
    got, want = both(_recorder_cycle)
    assert got[:8] == want[:8] and got[8] == want[8]
    assert len(got[0][0]) == 2 and got[1] == 0 and got[2]
    assert got[3][1] == [("pod", "p/a")] and got[3][2] == [("pod", "p/b")]
    assert got[4] == got[5] and got[6] == "a2"
    assert got[7].count("create-pod") == 2 and got[7].count("delete-pod") == 1


def _recorder_domains(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    rec = m(pkg, "controller.recorder").Recorder(db)
    rec.reconcile("a", {"resources": {"host": [{"uid": "h1", "name": "h1"}]}})
    rec.reconcile("b", {"resources": {"host": [{"uid": "h1", "name": "h1b"}]}})
    n = len(db.list("host"))
    rec.reconcile("a", {"resources": {}})
    return [n, [r.name for r in db.list("host")], _db_dump(db)]


def test_recorder_domains_are_isolated():
    got, want = both(_recorder_domains)
    assert got == want and got[:2] == [2, ["h1b"]]


def _k8s_gather(pkg):
    cloud = m(pkg, "controller.cloud")
    db = m(pkg, "controller.resources").ResourceDB()
    rec = m(pkg, "controller.recorder").Recorder(db)
    gather = cloud.KubernetesGather(_k8s_objects(pods=2), cluster_name="c1", epc_id=7)
    task = cloud.CloudTask(gather, rec)
    task.poll()
    first = _db_dump(db)
    task.poll()
    pod_ids = sorted(rec.id_of("k8s", "pod", f"k8s/c1/pod/prod/web-{i}") for i in range(2))
    vif_pods = sorted(v["pod_id"] for v in db._vifs)
    vifs = json.dumps(db._vifs, sort_keys=True, default=str)
    gather.update(_k8s_objects(pods=1))
    cs = task.poll()
    return [first, pod_ids, vif_pods, vifs, cs.deleted, len(db.list("pod")), _db_dump(db)]


def test_k8s_gather_to_db_e2e():
    got, want = both(_k8s_gather)
    assert got == want
    names = {k: [r[1] for r in v] for k, v in got[0].items()}
    assert names["pod_cluster"] == ["c1"] and names["pod_group"] == ["web"]
    assert sorted(names["pod"]) == ["web-0", "web-1"] and names["pod_service"] == ["web-svc"]
    assert got[1] == got[2]
    assert ("pod", "k8s/c1/pod/prod/web-1") in got[4] and got[5] == 1


def _file_reader(pkg, tmp_path):
    cloud = m(pkg, "controller.cloud")
    doc = {"resources": {"region": [{"uid": "r1", "name": "east"}],
                         "host": [{"uid": "h1", "name": "h1", "region": "r1"}]},
           "vinterfaces": [{"ips": ["10.5.0.1"], "epc_id": 3}]}
    path = tmp_path / f"{pkg}.json"
    path.write_text(json.dumps(doc))
    db = m(pkg, "controller.resources").ResourceDB()
    task = cloud.CloudTask(cloud.FileReaderPlatform(doc, domain="file"),
                           m(pkg, "controller.recorder").Recorder(db))
    cs = task.poll()
    return [cs.total, _db_dump(db), json.dumps(db._vifs, sort_keys=True, default=str)]


def test_file_reader_platform_equal(tmp_path):
    got, want = both(_file_reader, tmp_path)
    assert got == want and got[0] >= 2


def _genesis(pkg):
    g = m(pkg, "controller.genesis").GenesisStore(lease_s=100.0, epc_id=3)
    t0 = 1000.0
    g.report(1, {"hostname": "hostA", "interfaces": [
        {"mac": 0xAA, "ips": ["192.168.0.5"], "name": "eth0"}]}, now=t0)
    g.report(2, {"hostname": "hostB", "interfaces": [
        {"mac": 0xBB, "ips": ["192.168.0.6"], "name": "eth0"}]}, now=t0)
    snap1 = g.snapshot(now=t0 + 10)
    g.report(1, {"hostname": "hostA", "interfaces": []}, now=t0 + 90)
    snap2 = g.snapshot(now=t0 + 150)
    db = m(pkg, "controller.resources").ResourceDB()
    m(pkg, "controller.recorder").Recorder(db).reconcile(g.domain, snap2)
    return [snap1, snap2, dict(g.counters), _db_dump(db)]


def test_genesis_lease_and_snapshot():
    got, want = both(_genesis)
    assert got == want
    assert [h["name"] for h in got[0]["resources"]["host"]] == ["hostA", "hostB"]
    assert got[0]["vinterfaces"][0]["epc_id"] == 3
    assert [h["name"] for h in got[1]["resources"]["host"]] == ["hostA"]
    assert got[2]["expired"] == 1


def _trisolaris_genesis(pkg):
    db = m(pkg, "controller.resources").ResourceDB()
    g = m(pkg, "controller.genesis").GenesisStore()
    b = m(pkg, "controller.rebalance").AnalyzerBalancer()
    b.register("10.9.9.9")
    svc = m(pkg, "controller.trisolaris").TrisolarisService(db, genesis=g, balancer=b)
    try:
        resp = svc.handle_sync({"agent_id": 5, "config_rev": 0, "platform_version": 0,
                                "genesis": {"hostname": "n1", "interfaces": [
                                    {"mac": 1, "ips": ["172.16.0.9"]}]}})
        resp.pop("server_time_us")
        snap = g.snapshot()
        for h in snap["resources"]["host"]:
            h.pop("last_seen", None)
        return [resp, snap]
    finally:
        svc.stop()


def test_trisolaris_carries_genesis_and_analyzer():
    got, want = both(_trisolaris_genesis)
    assert got == want
    assert got[0]["analyzer_ip"] == "10.9.9.9"
    assert got[1]["resources"]["host"][0]["name"] == "n1"
    assert got[1]["vinterfaces"][0]["ips"] == ["172.16.0.9"]


def _recorder_restart(pkg, tmp_path):
    path = tmp_path / f"{pkg}_ids.json"
    Rec = m(pkg, "controller.recorder").Recorder
    DB = m(pkg, "controller.resources").ResourceDB
    rec = Rec(DB())
    rec.reconcile("k8s", {"resources": {"pod": [{"uid": "p/a", "name": "a"},
                                                {"uid": "p/b", "name": "b"}]}})
    rec.save(path)
    saved = json.loads(path.read_text())
    events = []
    rec2 = Rec(DB(), event_sink=events.append)
    loaded = rec2.load(path)
    cs = rec2.reconcile("k8s", {"resources": {"pod": [{"uid": "p/a", "name": "a"},
                                                      {"uid": "p/c", "name": "c"}]}})
    return [saved, loaded, rec2.id_of("k8s", "pod", "p/a"), rec2.id_of("k8s", "pod", "p/c"),
            cs.deleted, [e["type"] for e in events], rec2.dirty]


def test_recorder_ids_stable_across_restart(tmp_path):
    got, want = both(_recorder_restart, tmp_path)
    assert got == want
    assert got[1] and ("pod", "p/b") in got[4]
    # each package reads the other's id file
    for a, b in ((PORT, REF), (REF, PORT)):
        m(a, "controller.recorder").Recorder(m(a, "controller.resources").ResourceDB()).save(
            tmp_path / "x.json")
        assert m(b, "controller.recorder").Recorder(
            m(b, "controller.resources").ResourceDB()).load(tmp_path / f"{REF}_ids.json")


# -- tests/test_prom_labels.py --------------------------------------------

def _prom_labels(pkg):
    pl = m(pkg, "controller.prom_labels")
    reg = pl.PrometheusLabelRegistry()
    m1, m2 = reg.metric_id("http_requests_total"), reg.metric_id("up")
    v0 = reg.version
    reg.metric_id("up")
    unchanged = reg.version == v0
    labels = {"__name__": "up", "job": "api", "instance": "n1:9100"}
    mid, packed = reg.encode(labels)
    _, p2 = reg.encode({"__name__": "up", "zone": "api"})
    store = m(pkg, "storage.store").ColumnarStore()
    n = reg.flush_dicts(store, now=T0)
    return [m1, m2, unchanged, mid, packed, p2, reg.decode(mid, packed),
            reg.encode(dict(labels)), n, reg.flush_dicts(store, now=T0), _store_dump(store)]


def test_prom_label_ids_encoding_and_dicts():
    got, want = both(_prom_labels)
    assert got == want
    assert got[0] != got[1] and got[2]
    assert got[6] == {"__name__": "up", "job": "api", "instance": "n1:9100"}
    assert got[7] == (got[3], got[4]) and got[9] == 0


def _prom_ingest(pkg):
    recv = m(pkg, "ingest.receiver").Receiver()
    recv.start()
    store = m(pkg, "storage.store").ColumnarStore()
    pl = m(pkg, "controller.prom_labels")
    reg = pl.PrometheusLabelRegistry()
    ing = m(pkg, "server.integration").IntegrationIngester(
        recv, store, writer_args={"flush_interval_s": 0.05}, prom_labels=reg)
    kw = {"prefer_native_queue": False} if pkg == REF else {}
    snd = m(pkg, "ingest.sender").UniformSender(
        [("127.0.0.1", recv.tcp_port)], m(pkg, "ingest.framing").MessageType.PROMETHEUS,
        organization_id=1, flush_interval=0.05, **kw)
    fm = m(pkg, "integration.formats")
    try:
        snd.send([fm.encode_remote_write([
            fm.PromSeries({"__name__": "up", "job": "api"}, [(T0 * 1000, 1.0)]),
            fm.PromSeries({"__name__": "rq", "job": "api", "code": "200"},
                          [(T0 * 1000, 3.0), (T0 * 1000 + 1000, 4.5)])])])
        deadline = time.time() + 15
        while time.time() < deadline and ing.get_counters()["rows_written"] < 3:
            time.sleep(0.05)
        ing.flush()
        enc = store.scan("prometheus", pl.SAMPLES_ENC.name)
        decoded = [reg.decode(int(a), str(b)) for a, b in zip(enc["metric_id"], enc["label_ids"])]
        return [_store_dump(store), decoded, ing.get_counters()]
    finally:
        snd.close()
        ing.stop()
        recv.stop()


def test_ingester_writes_encoded_samples():
    got, want = both(_prom_ingest)
    assert got[0] == want[0] and got[1] == want[1]
    for k, v in want[2].items():
        assert got[2][k] == v, k
    assert {"__name__": "up", "job": "api"} in got[1] and got[2]["rows_written"] == 3
