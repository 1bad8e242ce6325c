"""The port's small controller and utility modules: the cases of
tests/test_cloud_adapters.py (`controller/cloud_adapters.py` into the
port's recorder and tag recorder), tests/test_trident_grpc.py (the gRPC
facade; skipped where `grpc` is missing, as the reference's are), the
geo and segment-tree cases of tests/test_geo_plugins.py,
tests/test_trace_imports.py and tests/test_checkpoint_misc.py, and the
trident parser cases of tests/test_fuzz_decoders.py with fewer draws; and
the two packages against each other: equal cloud snapshots, sync
messages byte for byte, geo lookups and interval queries."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

from deepflow_tpu_torch.controller.cloud import CloudTask, KubernetesGather
from deepflow_tpu_torch.controller.cloud_adapters import AliyunPlatform, AwsPlatform
from deepflow_tpu_torch.controller.recorder import Recorder
from deepflow_tpu_torch.controller.resources import ResourceDB
from deepflow_tpu_torch.controller.tagrecorder import TagRecorder
from deepflow_tpu_torch.controller.trident_grpc import (
    TridentGrpcFacade,
    build_sync_response,
    parse_sync_request,
    parse_sync_response,
)
from deepflow_tpu_torch.controller.trisolaris import TrisolarisService
from deepflow_tpu_torch.ingest.codec import _put_varint
from deepflow_tpu_torch.querier.translation import Translator
from deepflow_tpu_torch.storage.store import ColumnarStore
from deepflow_tpu_torch.utils.geo import GeoTable
from deepflow_tpu_torch.utils.segmenttree import IntervalIndex


ALIYUN_FIXTURE = {
    "DescribeRegions": {"Regions": {"Region": [
        {"RegionId": "cn-hangzhou", "LocalName": "华东1"},
    ]}},
    "DescribeZones": {"Zones": {"Zone": [
        {"ZoneId": "cn-hangzhou-h", "RegionId": "cn-hangzhou"},
        {"ZoneId": "cn-hangzhou-i", "RegionId": "cn-hangzhou"},
    ]}},
    "DescribeVpcs": {"Vpcs": {"Vpc": [
        {"VpcId": "vpc-abc", "VpcName": "prod", "CidrBlock": "10.0.0.0/8",
         "RegionId": "cn-hangzhou"},
    ]}},
    "DescribeVSwitches": {"VSwitches": {"VSwitch": [
        {"VSwitchId": "vsw-1", "VpcId": "vpc-abc", "CidrBlock": "10.1.0.0/16",
         "ZoneId": "cn-hangzhou-h", "VSwitchName": "web-tier"},
    ]}},
    "DescribeInstances": {"Instances": {"Instance": [
        {"InstanceId": "i-web1", "InstanceName": "web-1", "Status": "Running",
         "ZoneId": "cn-hangzhou-h",
         "VpcAttributes": {"VpcId": "vpc-abc"}},
    ]}},
    "DescribeNetworkInterfaces": {"NetworkInterfaceSets": {"NetworkInterfaceSet": [
        {"NetworkInterfaceId": "eni-1", "MacAddress": "00:16:3e:aa:bb:cc",
         "VSwitchId": "vsw-1", "VpcId": "vpc-abc", "InstanceId": "i-web1",
         "PrivateIpSets": {"PrivateIpSet": [
             {"PrivateIpAddress": "10.1.2.3", "Primary": True},
         ]}},
    ]}},
}

AWS_FIXTURE = {
    "DescribeRegions": {"Regions": [{"RegionName": "us-east-1"}]},
    "DescribeAvailabilityZones": {"AvailabilityZones": [
        {"ZoneName": "us-east-1a", "RegionName": "us-east-1"},
    ]},
    "DescribeVpcs": {"Vpcs": [
        {"VpcId": "vpc-123", "CidrBlock": "172.31.0.0/16",
         "Tags": [{"Key": "Name", "Value": "main"}]},
    ]},
    "DescribeSubnets": {"Subnets": [
        {"SubnetId": "subnet-9", "VpcId": "vpc-123",
         "CidrBlock": "172.31.1.0/24", "AvailabilityZone": "us-east-1a"},
    ]},
    "DescribeInstances": {"Reservations": [{"Instances": [
        {"InstanceId": "i-0abc", "VpcId": "vpc-123", "SubnetId": "subnet-9",
         "State": {"Name": "running"},
         "Placement": {"AvailabilityZone": "us-east-1a"},
         "Tags": [{"Key": "Name", "Value": "api-server"}],
         "NetworkInterfaces": [
             {"NetworkInterfaceId": "eni-7", "MacAddress": "0a:1b:2c:3d:4e:5f",
              "VpcId": "vpc-123", "SubnetId": "subnet-9",
              "PrivateIpAddresses": [{"PrivateIpAddress": "172.31.1.50"}]},
         ]},
    ]}]},
}


def _settle(task):
    task.poll()  # allocate ids
    return task.poll()  # resolve _refs against them


def test_aliyun_fixture_reconciles():
    rec = Recorder(ResourceDB())
    task = CloudTask(AliyunPlatform(ALIYUN_FIXTURE), rec)
    _settle(task)
    db = rec.db
    assert [r.name for r in db.list("region")] == ["华东1"]
    assert len(db.list("az")) == 2
    assert db.list("l3_epc")[0].name == "prod"
    assert db.list("subnet")[0].attrs["cidr"] == "10.1.0.0/16"
    vm = db.list("device")[0]
    assert vm.name == "web-1" and vm.attrs["type"] == "vm"

    vifs = db.vinterfaces()
    assert len(vifs) == 1
    v = vifs[0]
    assert v["ips"] == ["10.1.2.3"]
    assert v["mac"] == 0x00163EAABBCC
    assert v["epc_id"] == rec.id_of("aliyun", "l3_epc", "vpc-abc")
    assert v["subnet_id"] == rec.id_of("aliyun", "subnet", "vsw-1")
    assert v["l3_device_id"] == rec.id_of("aliyun", "device", "i-web1")


def test_aws_fixture_reconciles():
    rec = Recorder(ResourceDB())
    task = CloudTask(AwsPlatform(AWS_FIXTURE), rec)
    _settle(task)
    db = rec.db
    assert db.list("l3_epc")[0].name == "main"  # Name tag wins
    assert db.list("device")[0].name == "api-server"
    v = db.vinterfaces()[0]
    assert v["ips"] == ["172.31.1.50"]
    assert v["epc_id"] == rec.id_of("aws", "l3_epc", "vpc-123")
    assert v["l3_device_id"] == rec.id_of("aws", "device", "i-0abc")


def test_aliyun_instance_deletion_propagates():
    rec = Recorder(ResourceDB())
    plat = AliyunPlatform(ALIYUN_FIXTURE)
    task = CloudTask(plat, rec)
    _settle(task)
    pruned = json.loads(json.dumps(ALIYUN_FIXTURE))
    pruned["DescribeInstances"]["Instances"]["Instance"] = []
    pruned["DescribeNetworkInterfaces"]["NetworkInterfaceSets"]["NetworkInterfaceSet"] = []
    plat.update(pruned)
    cs = task.poll()
    assert ("device", "i-web1") in cs.deleted
    assert rec.db.list("device") == [] and rec.db.vinterfaces() == []


def _k8s_pod_objects():
    return {
        "nodes": [], "namespaces": [{"metadata": {"name": "default"}}],
        "services": [],
        "pods": [
            {
                "metadata": {
                    "name": "web-0", "namespace": "default",
                    "labels": {"app": "web", "tier": "frontend"},
                    "annotations": {"owner": "team-a"},
                },
                "spec": {
                    "nodeName": "n1",
                    "containers": [
                        {"env": [{"name": "MODE", "value": "prod"},
                                 {"name": "SECRETLESS", "value": "1"}]},
                    ],
                },
                "status": {"podIP": "10.9.0.5"},
            },
            {
                "metadata": {"name": "db-0", "namespace": "default",
                             "labels": {"app": "db"}},
                "spec": {"containers": []},
                "status": {"podIP": "10.9.0.6"},
            },
        ],
    }


def test_tagrecorder_k8s_label_dictionaries():
    rec = Recorder(ResourceDB())
    task = CloudTask(KubernetesGather(_k8s_pod_objects(), epc_id=3), rec)
    _settle(task)
    store = ColumnarStore()
    tr = Translator(store)
    tagrec = TagRecorder(rec.db, store, tr)
    assert tagrec.sync()

    web_id = rec.id_of("k8s", "pod", "k8s/cluster/pod/default/web-0")
    db_id = rec.id_of("k8s", "pod", "k8s/cluster/pod/default/db-0")

    # singular form: one row per (pod, key)
    rows = store.scan("flow_tag", "pod_k8s_label_map")
    by_pod = {}
    for i, k, v in zip(rows["id"], rows["key"], rows["value"]):
        by_pod.setdefault(int(i), {})[str(k)] = str(v)
    assert by_pod[web_id] == {"app": "web", "tier": "frontend"}
    assert by_pod[db_id] == {"app": "db"}

    # plural form: whole dict JSON per pod
    rows = store.scan("flow_tag", "pod_k8s_labels_map")
    plural = {int(i): json.loads(str(v)) for i, v in zip(rows["id"], rows["value"])}
    assert plural[web_id]["tier"] == "frontend"

    # annotations + envs materialize too
    rows = store.scan("flow_tag", "pod_k8s_annotation_map")
    assert {(int(i), str(k), str(v)) for i, k, v in
            zip(rows["id"], rows["key"], rows["value"])} == {(web_id, "owner", "team-a")}
    rows = store.scan("flow_tag", "pod_k8s_env_map")
    envs = {str(k): str(v) for _, k, v in
            zip(rows["id"], rows["key"], rows["value"])}
    assert envs == {"MODE": "prod", "SECRETLESS": "1"}

    # query-time custom-tag lookup (the `k8s.label.<key>` seat)
    out = tr.k8s_meta("label", "app", np.array([web_id, db_id, 999]))
    assert list(out) == ["web", "db", ""]


def test_engine_k8s_label_function():
    from deepflow_tpu_torch.querier import QueryEngine
    from deepflow_tpu_torch.storage.store import ColumnSpec, TableSchema

    rec = Recorder(ResourceDB())
    task = CloudTask(KubernetesGather(_k8s_pod_objects(), epc_id=3), rec)
    _settle(task)
    store = ColumnarStore()
    tr = Translator(store)
    TagRecorder(rec.db, store, tr).sync()
    web_id = rec.id_of("k8s", "pod", "k8s/cluster/pod/default/web-0")
    db_id = rec.id_of("k8s", "pod", "k8s/cluster/pod/default/db-0")

    store.create_table("flow_metrics", TableSchema(
        "application_1s",
        (ColumnSpec("time", "u4"), ColumnSpec("pod_id_0", "u4"),
         ColumnSpec("request", "f4")),
    ))
    store.insert("flow_metrics", "application_1s", {
        "time": np.array([1000, 1000, 1000], np.uint32),
        "pod_id_0": np.array([web_id, db_id, web_id], np.uint32),
        "request": np.array([1, 1, 1], np.float32),
    })
    eng = QueryEngine(store, tr, device="cpu")
    r = eng.execute(
        "select k8s_label(pod_id_0, 'app') as app, Sum(request) as req "
        "from application.1s group by k8s_label(pod_id_0, 'app') order by app"
    )
    assert r.to_dicts() == [{"app": "db", "req": 1.0}, {"app": "web", "req": 2.0}]


# -- the trident gRPC facade ---------------------------------------------------

def _sync_request(ctrl_ip="10.0.0.9", ctrl_mac="aa:bb:cc:dd:ee:01",
                  group="", platform_version=0) -> bytes:
    out = bytearray()
    _put_varint(out, 1 << 3 | 0); _put_varint(out, 1_700_000_000)  # boot_time
    for field, s in ((5, "v6.4"), (7, "deepflow-agent"), (21, ctrl_ip),
                     (22, "host-1"), (25, ctrl_mac), (26, group)):
        b = s.encode()
        _put_varint(out, field << 3 | 2); _put_varint(out, len(b)); out += b
    _put_varint(out, 9 << 3 | 0); _put_varint(out, platform_version)
    _put_varint(out, 32 << 3 | 0); _put_varint(out, 4)  # cpu_num
    return bytes(out)


def test_wire_subset_roundtrip():
    req = parse_sync_request(_sync_request())
    assert req["ctrl_ip"] == "10.0.0.9" and req["ctrl_mac"] == "aa:bb:cc:dd:ee:01"
    assert req["process_name"] == "deepflow-agent" and req["cpu_num"] == 4
    resp = parse_sync_response(build_sync_response(
        vtap_id=7, sync_interval=30, platform_version=5, revision="v7"))
    assert resp["status"] == 0
    assert resp["config"] == {"enabled": True, "sync_interval": 30, "vtap_id": 7}
    assert resp["revision"] == "v7" and resp["version_platform_data"] == 5


@pytest.fixture()
def stack():
    grpc = pytest.importorskip("grpc")
    db = ResourceDB()
    tri = TrisolarisService(db)
    facade = TridentGrpcFacade(tri, sync_interval=30, push_poll_s=0.05, push_heartbeat_s=0.3)
    chan = grpc.insecure_channel(f"127.0.0.1:{facade.port}")
    yield db, tri, facade, chan
    chan.close()
    facade.stop()
    tri.stop()


def _stub(chan, method):
    return chan.unary_unary(
        f"/trident.Synchronizer/{method}",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )


def test_stock_agent_registers_and_keeps_vtap_id(stack):
    db, tri, facade, chan = stack
    sync = _stub(chan, "Sync")
    r1 = parse_sync_response(sync(_sync_request()))
    assert r1["status"] == 0
    vid = r1["config"]["vtap_id"]
    assert vid >= 1 and r1["config"]["enabled"]

    # same identity → same id; new MAC → new id (IP_AND_MAC identity)
    r2 = parse_sync_response(sync(_sync_request()))
    assert r2["config"]["vtap_id"] == vid
    r3 = parse_sync_response(sync(_sync_request(ctrl_mac="aa:bb:cc:dd:ee:02")))
    assert r3["config"]["vtap_id"] != vid
    assert facade.counters["registers"] == 2

    # the agent shows up in trisolaris' agent table under its vtap_id
    assert vid in tri.agents

    # AnalyzerSync rides the same handler
    r4 = parse_sync_response(_stub(chan, "AnalyzerSync")(_sync_request()))
    assert r4["config"]["vtap_id"] == vid


def test_group_request_routes_group_config(stack):
    db, tri, facade, chan = stack
    tri.set_group_config("edge", {"l4_log_collect_nps_threshold": 777})
    sync = _stub(chan, "Sync")
    r = parse_sync_response(sync(_sync_request(group="edge")))
    vid = r["config"]["vtap_id"]
    assert tri.agents[vid]["group"] == "edge"


def test_push_streams_on_platform_change(stack):
    db, tri, facade, chan = stack
    push = chan.unary_stream(
        "/trident.Synchronizer/Push",
        request_serializer=lambda b: b,
        response_deserializer=lambda b: b,
    )
    stream = push(_sync_request())
    first = parse_sync_response(next(stream))
    assert first["status"] == 0
    v0 = first["version_platform_data"]
    # a platform change (new resource) reaches the agent through the
    # stream — possibly on a heartbeat frame that raced the change
    # detector, so scan a few frames rather than pinning which one
    db.put("pod", 9001, "web-9001")
    nxt = first
    for _ in range(10):
        nxt = parse_sync_response(next(stream))
        if nxt["version_platform_data"] > v0:
            break
    assert nxt["version_platform_data"] > v0
    stream.cancel()


# -- geo and the interval index -------------------------------------------------

def test_geo_builtin_ranges():
    g = GeoTable.builtin()
    ips = np.array(
        [0x0A000001, 0xAC100101, 0xC0A80001, 0x7F000001, 0x08080808, 0xE0000001],
        np.uint32,
    )
    got = [g.label(i) for i in g.lookup(ips)]
    assert got == ["private-10", "private-172", "private-192", "loopback",
                   "public", "multicast"]


def test_geo_custom_table():
    g = GeoTable.from_cidrs([("203.0.113.0/24", 42)], {42: "ap-southeast"})
    ids = g.lookup(np.array([0xCB007101, 0xCB007201], np.uint32))
    assert g.label(ids[0]) == "ap-southeast"
    assert ids[1] == 0  # outside the /24


def test_geo_nested_and_empty_tables():
    g = GeoTable.from_cidrs([("10.0.0.0/8", 1), ("10.1.0.0/16", 2)],
                            {1: "isp", 2: "province"})
    ids = g.lookup(np.array([0x0A010001, 0x0A020001, 0x0B000001], np.uint32))
    assert [g.label(i) for i in ids] == ["province", "isp", "public"]
    # empty table: all-unknown, no crash
    empty = GeoTable.from_cidrs([])
    assert list(empty.lookup(np.array([1], np.uint32))) == [0]


def test_interval_index_queries():
    idx = IntervalIndex([0, 5, 10, 5], [4, 9, 20, 30])
    assert list(idx.query(6, 7)) == [1, 3]
    assert list(idx.query(0, 100)) == [0, 1, 2, 3]
    assert list(idx.query(25, 40)) == [3]
    assert list(idx.query(50, 60)) == []
    assert [list(s) for s in idx.stab([4, 12])] == [[0], [2, 3]]
    np.testing.assert_array_equal(idx.coverage([4, 6, 12, 99]), [1, 2, 2, 0])


def test_interval_index_matches_bruteforce():
    rng = np.random.default_rng(0)
    starts = rng.integers(0, 1000, 200)
    ends = starts + rng.integers(0, 100, 200)
    idx = IntervalIndex(starts, ends)
    for lo, hi in [(0, 10), (500, 510), (999, 1200), (50, 50)]:
        brute = np.sort(np.nonzero((starts <= hi) & (ends >= lo))[0])
        np.testing.assert_array_equal(idx.query(lo, hi), brute)
    pts = rng.integers(0, 1100, 50)
    brute_cov = np.array([((starts <= p) & (ends >= p)).sum() for p in pts])
    np.testing.assert_array_equal(idx.coverage(pts), brute_cov)


# -- trident parsers under hostile bytes ----------------------------------------

def test_wire_parsers_never_raise_on_random_bytes():
    """The OTLP metrics and trident sync codecs share the
    untrusted-input stance: garbage in, empty/partial out, no raise."""
    import numpy as np

    from deepflow_tpu_torch.controller.trident_grpc import (
        parse_sync_request,
        parse_sync_response,
    )
    from deepflow_tpu_torch.integration.formats import (
        parse_otlp_metrics,
        parse_otlp_traces,
    )

    rng = np.random.default_rng(11)
    for n in (0, 1, 7, 64, 513):
        for _ in range(10):
            blob = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            parse_otlp_metrics(blob)
            parse_otlp_traces(blob)
            parse_sync_request(blob)
            parse_sync_response(blob)


def test_encoders_roundtrip_under_mutation():
    """Flip bytes in valid OTLP/trident messages: parsers must never
    raise (truncated varints surface as ValueError from _iter_fields
    for trident, which handle_sync callers catch at the RPC edge)."""
    import numpy as np

    from deepflow_tpu_torch.controller.trident_grpc import (
        build_sync_response,
        parse_sync_response,
    )
    from deepflow_tpu_torch.integration.formats import (
        OtelSpan,
        encode_otlp_traces,
        parse_otlp_traces,
    )

    rng = np.random.default_rng(12)
    span = OtelSpan("svc", "op", "ab" * 16, "cd" * 8, "", 2,
                    1_700_000_000_000_000, 1_700_000_001_000_000, 1,
                    {"k": "v"})
    base_t = bytearray(encode_otlp_traces([span]))
    base_s = bytearray(build_sync_response(
        vtap_id=9, sync_interval=60, platform_version=3))
    for _ in range(20):
        for base, parse in ((base_t, parse_otlp_traces),
                            (base_s, parse_sync_response)):
            b = bytearray(base)
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(0, len(b))] = rng.integers(0, 256)
            try:
                parse(bytes(b))
            except ValueError:
                pass


# -- the two packages against each other ----------------------------------------

def _snapshot(mod_pkg, fixture, platform):
    import importlib

    m = lambda name: importlib.import_module(f"{mod_pkg}.{name}")  # noqa: E731
    rec = m("controller.recorder").Recorder(m("controller.resources").ResourceDB())
    task = m("controller.cloud").CloudTask(
        getattr(m("controller.cloud_adapters"), platform)(fixture), rec)
    _settle(task)
    db = rec.db
    kinds = ("region", "az", "l3_epc", "subnet", "device")
    return ({k: sorted((r.id, r.name, json.dumps(r.attrs, sort_keys=True, default=str))
                       for r in db.list(k)) for k in kinds},
            sorted(json.dumps(v, sort_keys=True, default=str) for v in db.vinterfaces()))


@pytest.mark.parametrize("platform", ["AliyunPlatform", "AwsPlatform"])
def test_cloud_snapshots_equal_across_packages(platform):
    fixture = ALIYUN_FIXTURE if platform == "AliyunPlatform" else AWS_FIXTURE
    got = _snapshot("deepflow_tpu_torch", fixture, platform)
    want = _snapshot("deepflow_tpu", fixture, platform)
    assert got == want and got[1]


def test_sync_messages_equal_across_packages():
    import deepflow_tpu.controller.trident_grpc as ref_tri

    req = _sync_request(group="edge", platform_version=3)
    assert parse_sync_request(req) == ref_tri.parse_sync_request(req)
    for kw in ({"vtap_id": 7, "sync_interval": 30, "platform_version": 5, "revision": "v7"},
               {"vtap_id": 1, "sync_interval": 60, "platform_version": 0}):
        raw = build_sync_response(**kw)
        assert raw == ref_tri.build_sync_response(**kw)
        assert parse_sync_response(raw) == ref_tri.parse_sync_response(raw)


def test_geo_and_intervals_equal_across_packages():
    from deepflow_tpu.utils.geo import GeoTable as RefGeoTable
    from deepflow_tpu.utils.segmenttree import IntervalIndex as RefIntervalIndex

    rng = np.random.default_rng(5)
    ips = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for got, want in ((GeoTable.builtin(), RefGeoTable.builtin()),
                      (GeoTable.from_cidrs([("10.0.0.0/8", 1), ("10.1.0.0/16", 2)], {1: "a"}),
                       RefGeoTable.from_cidrs([("10.0.0.0/8", 1), ("10.1.0.0/16", 2)], {1: "a"}))):
        g, w = got.lookup(ips), want.lookup(ips)
        assert np.array_equal(g, w)
        assert [got.label(i) for i in g[:64]] == [want.label(i) for i in w[:64]]
    starts = rng.integers(0, 1000, 300)
    ends = starts + rng.integers(0, 100, 300)
    a, b = IntervalIndex(starts, ends), RefIntervalIndex(starts, ends)
    pts = rng.integers(0, 1100, 100)
    assert np.array_equal(a.coverage(pts), b.coverage(pts))
    assert [list(s) for s in a.stab(pts)] == [list(s) for s in b.stab(pts)]
    for lo, hi in [(0, 10), (500, 700), (1000, 1200)]:
        assert np.array_equal(a.query(lo, hi), b.query(lo, hi))
