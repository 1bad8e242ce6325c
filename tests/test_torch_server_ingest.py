"""The server's ingest path on the port — Receiver → FlowMetricsIngester
(decode → device enrichment) → DocStoreWriter → ColumnarStore — against
the reference's, on the CPU.

Both stacks take the same METRICS frames over localhost TCP, plus one
UDP datagram: docs of the port's L4Pipeline over a SyntheticFlowGen
stream, a few docs carrying app_service strings, enriched against the
same platform registry (region filter on). Then:

  * every store table the two writers produced is equal column for
    column (rows in a canonical order: worker threads interleave), the
    flow_tag app_service sidecar too;
  * the ingesters' and receivers' counters are equal; the port fetches
    once per enrichment chunk;
  * a store directory the port wrote is read by the reference's
    QueryEngine, and the reference's by the port's, with equal results;
  * the codec copies encode and decode the same bytes and batches;
  * a worker exception surfaces from get_counters() and stop().

Both stacks run their Python decoder and queue (prefer_native=False):
which frames share a decode batch depends on the decoders' speed, and
the app_service sidecar's time is its batch's first doc's.
tests/test_torch_native.py holds the port's native decoder against them.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch

from deepflow_tpu.enrich import platform as ref_platform
from deepflow_tpu.ingest import codec as ref_codec
from deepflow_tpu.ingest.receiver import Receiver as RefReceiver
from deepflow_tpu.querier import QueryEngine as RefQueryEngine
from deepflow_tpu.server.flow_metrics import FlowMetricsIngester as RefIngester
from deepflow_tpu.server.metrics_tables import DocStoreWriter as RefDocStoreWriter
from deepflow_tpu.storage.store import ColumnarStore as RefStore
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel.code import DocumentFlag
from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA
from deepflow_tpu_torch.enrich import platform
from deepflow_tpu_torch.ingest import codec
from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame
from deepflow_tpu_torch.ingest.receiver import Receiver
from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
from deepflow_tpu_torch.querier import QueryEngine
from deepflow_tpu_torch.server.flow_metrics import FlowMetricsIngester, ListWriter, WorkerError
from deepflow_tpu_torch.server.metrics_tables import DocStoreWriter
from deepflow_tpu_torch.storage.store import ColumnarStore

CPU = torch.device("cpu")
T0 = 1_700_000_000
MY_REGION = 3
FRAME_DOCS = 64
SQL = (
    "SELECT Count() AS c, Sum(byte_tx) AS b, Max(rtt_max) AS m FROM network.1s",
    "SELECT auto_service_id_0 AS s, Sum(packet_tx) AS p, Count() AS c FROM network_map.1s "
    "GROUP BY auto_service_id_0 ORDER BY s",
    "SELECT region_id_0 AS r, tag_source_0 AS ts, Count() AS c FROM network.1s "
    "GROUP BY region_id_0, tag_source_0 ORDER BY r, ts",
    "SELECT interval(time, 60) AS t, Avg(rtt_sum) AS a FROM network_map.1s "
    "GROUP BY interval(time, 60) ORDER BY t",
)


def _platform_table(mod, gen: SyntheticFlowGen):
    """A registry keyed on the stream's own pods, gprocesses and
    (epc, ip) pairs: most lookups hit, some info rows sit in another
    region (dropped), services resolve for a share of the pods."""
    pt = mod.PlatformInfoTable(my_region_id=MY_REGION)
    p = gen.pop
    for i in range(len(p["ip0"])):
        region = MY_REGION + 1 if i % 9 == 0 else MY_REGION
        pt.add_info(epc_id=int(p["epc0"][i]), ips=[int(p["ip0"][i])], region_id=region,
                    subnet_id=100 + i, az_id=7, l3_device_id=1000 + i, l3_device_type=1)
        pt.add_info(epc_id=int(p["epc1"][i]), ips=[int(p["ip1"][i])], region_id=MY_REGION,
                    subnet_id=200 + i, pod_node_id=300 + i % 5, pod_group_id=400 + i % 7,
                    pod_group_type=101)
    for pod in range(1, 500, 2):
        pt.add_info(pod_id=pod, region_id=MY_REGION, pod_node_id=300 + pod % 5,
                    pod_group_id=400 + pod % 7, pod_group_type=101, pod_cluster_id=9)
    for gpid in range(1, 1000, 3):
        pt.add_gprocess(gpid=gpid, agent_id=gpid % 4, pod_id=2 * (gpid % 200) + 1)
    for g in range(7):
        pt.add_pod_service(800 + g, pod_group_id=400 + g)
    pt.add_pod_service(900, pod_node_id=301, protocol=6, server_port=80)
    return pt


@pytest.fixture(scope="module")
def stream():
    gen = SyntheticFlowGen(num_tuples=40, seed=9)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 12), batch_size=512),
                      device=CPU)
    docs = []
    for t in range(T0, T0 + 3):
        docs += pipe.ingest(gen.flow_batch(300, t))
    docs += pipe.drain()
    msgs = []
    for db in docs:
        msgs += codec.encode_docbatch(db, flags=int(DocumentFlag.PER_SECOND_METRICS))
    # a few docs with app_service / app_instance strings for the sidecar
    db = docs[0]
    for i in range(6):
        msgs.append(codec.encode_document(
            db.timestamp[i], db.tags[i], db.meters[i], int(DocumentFlag.PER_SECOND_METRICS),
            strings={"app_service": f"svc-{i % 3}", "app_instance": f"inst-{i % 2}",
                     "endpoint": "/api"}))
    frames = []
    for k, i in enumerate(range(0, len(msgs), FRAME_DOCS)):
        h = FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1 + k % 4,
                       organization_id=1)
        frames.append(encode_frame(h, msgs[i:i + FRAME_DOCS]))
    udp_msgs = codec.encode_docbatch(docs[-1])[:10]
    udp = encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=9,
                                  organization_id=1), udp_msgs)
    return {"gen": gen, "docs": docs, "msgs": msgs, "frames": frames, "udp": udp,
            "total": len(msgs) + len(udp_msgs)}


def _wait(cond, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _run_stack(ref: bool, stream, root):
    """One stack over `root`: returns (ingester counters, receiver
    counters, the store root)."""
    if ref:
        state = _platform_table(ref_platform, stream["gen"]).build()
        recv = RefReceiver()
        store = RefStore(root)
        writer = RefDocStoreWriter(store, writer_args={"flush_interval_s": 0.05})
        extra = {"prefer_native": False}
        ing_cls = RefIngester
    else:
        state = _platform_table(platform, stream["gen"]).build(device=CPU)
        recv = Receiver()
        store = ColumnarStore(root)
        writer = DocStoreWriter(store, writer_args={"flush_interval_s": 0.05})
        extra = {"prefer_native": False}
        ing_cls = FlowMetricsIngester
    recv.start()
    ing = ing_cls(recv, writer, platform_state=state, n_workers=2, enrich_chunk=256, **extra)
    try:
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(b"".join(stream["frames"]))
            u = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            u.sendto(stream["udp"], ("127.0.0.1", recv.udp_port))
            u.close()
            def settled():
                c = ing.get_counters()
                return (c["docs_written"] + c["drop_other_region"] == stream["total"]
                        and writer.counters["rows"] == c["docs_written"])

            assert _wait(settled)
        writer.flush()
        writer._app_tags.flush()
        counters = ing.get_counters()
        rx = recv.get_counters()
    finally:
        ing.stop()
        writer.stop()
        recv.stop()
    return counters, rx


def _canonical(cols: dict) -> dict:
    names = sorted(cols)
    n = len(cols[names[0]]) if names else 0
    keys = [np.unique(cols[k], return_inverse=True)[1] for k in names]
    order = np.lexsort(keys[::-1]) if n else np.arange(0)
    return {k: np.asarray(cols[k])[order] for k in names}


def _assert_stores_equal(a, b):
    assert a.databases() == b.databases()
    n_tables = 0
    for db in a.databases():
        assert a.tables(db) == b.tables(db), db
        for t in a.tables(db):
            if t == "datasource_watermark":
                continue
            assert a.schema(db, t).to_json() == b.schema(db, t).to_json()
            ca, cb = _canonical(a.scan(db, t)), _canonical(b.scan(db, t))
            for k in ca:
                assert ca[k].dtype == cb[k].dtype, (db, t, k)
                assert np.array_equal(ca[k], cb[k]), (db, t, k)
            n_tables += 1
    return n_tables


def _assert_results_equal(got, want):
    assert got.columns == want.columns
    for c in want.columns:
        g, w = np.asarray(got.values[c]), np.asarray(want.values[c])
        assert g.shape == w.shape, c
        if w.dtype.kind == "f":
            exact = np.all(np.abs(w) < 2 ** 24) and np.all(w == np.round(w))
            if exact:
                assert np.array_equal(g, w), c
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=c)
        else:
            assert np.array_equal(g, w), c


@pytest.fixture(scope="module")
def stacks(stream, tmp_path_factory):
    ref_root = tmp_path_factory.mktemp("ref_store")
    port_root = tmp_path_factory.mktemp("port_store")
    ref = _run_stack(True, stream, ref_root)
    port = _run_stack(False, stream, port_root)
    return {"ref": ref, "port": port, "ref_root": ref_root, "port_root": port_root}


def test_codec_copies_agree(stream):
    db = stream["docs"][0]
    assert codec.encode_docbatch(db) == ref_codec.encode_docbatch(db)
    got = codec.DocumentDecoder().decode(stream["msgs"])
    want = ref_codec.DocumentDecoder().decode(stream["msgs"])
    assert sorted(got) == sorted(want)
    for mid in want:
        g, w = got[mid], want[mid]
        for k in ("tags", "meters", "timestamp", "flags", "service_ids"):
            assert getattr(g, k).dtype == getattr(w, k).dtype
            assert np.array_equal(getattr(g, k), getattr(w, k)), k
        assert g.strings.values == w.strings.values


def test_stores_equal_column_for_column(stacks):
    ref_store, port_store = RefStore(stacks["ref_root"]), ColumnarStore(stacks["port_root"])
    n = _assert_stores_equal(port_store, ref_store)
    assert n >= 3  # network_1s, network_map_1s and the app_service sidecar
    assert "app_service" in port_store.tables("flow_tag")
    assert port_store.row_count("flow_tag", "app_service") > 0
    enriched = port_store.scan("flow_metrics", "network_1s",
                               columns=["auto_instance_type_0", "tag_source_0"])
    assert (enriched["tag_source_0"] & platform.TS_POD_ID).any()
    assert (enriched["tag_source_0"] & platform.TS_EPC_IP).any()


def test_counters_equal(stacks):
    (ref_c, ref_rx), (port_c, port_rx) = stacks["ref"], stacks["port"]
    for k, v in ref_c.items():
        assert port_c[k] == v, k
    assert port_c["drop_other_region"] > 0
    assert port_c["enrich_fetches"] == port_c["enrich_chunks"] > 0
    for k in ("rx_frames", "rx_bytes", "bad_frames", "udp_frames", "tcp_conns",
              "no_handler", "queue_closed", "agents_seen"):
        assert port_rx[k] == ref_rx[k], k
    assert port_rx["udp_frames"] == 1


def test_each_package_reads_the_others_store(stacks):
    for root in (stacks["ref_root"], stacks["port_root"]):
        ref_eng = RefQueryEngine(RefStore(root), cache=False)
        port_eng = QueryEngine(ColumnarStore(root), cache=False, device=CPU)
        for sql in SQL:
            _assert_results_equal(port_eng.execute(sql), ref_eng.execute(sql))
    r = QueryEngine(ColumnarStore(stacks["ref_root"]), cache=False, device=CPU).execute(SQL[0])
    assert r.values["c"][0] > 0


def test_worker_exception_surfaces():
    class Boom:
        def put(self, batch):
            raise RuntimeError("writer failed")

    recv = Receiver()
    recv.start()
    ing = FlowMetricsIngester(recv, Boom(), n_workers=1)
    try:
        msgs = codec.encode_docbatch(_one_docbatch())
        frame = encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1), msgs)
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(frame)

            def raised():
                try:
                    ing.get_counters()
                except WorkerError:
                    return True
                return False

            assert _wait(raised, timeout=30)
        with pytest.raises(WorkerError, match="writer failed") as info:
            ing.get_counters()
        assert isinstance(info.value.__cause__, RuntimeError)
    finally:
        with pytest.raises(WorkerError):
            ing.stop()
        recv.stop()


def test_list_writer_collects_enriched_batches(stream):
    recv = Receiver()
    recv.start()
    writer = ListWriter()
    state = _platform_table(platform, stream["gen"]).build(device=CPU)
    ing = FlowMetricsIngester(recv, writer, platform_state=state, enrich_chunk=128,
                              disable_second_write=True)
    try:
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(stream["frames"][0])
            assert _wait(lambda: ing.get_counters()["docs_in"] == FRAME_DOCS)
        assert _wait(lambda: len(writer.batches) >= 1)
        c = ing.get_counters()
        # every doc is a 1 s doc, so disable_second_write drops them all
        assert c["drop_second_write"] == FRAME_DOCS and writer.doc_count() == 0
        b = writer.batches[0]
        assert sorted(b.side0) == sorted(platform.ENRICH_FIELDS)
        assert b.side0["region_id"].dtype == np.uint32 and not b.keep.any()
    finally:
        ing.stop()
        recv.stop()


def _one_docbatch():
    gen = SyntheticFlowGen(num_tuples=4, seed=1)
    pipe = L4Pipeline(PipelineConfig(window=WindowConfig(capacity=1 << 10), batch_size=64),
                      device=CPU)
    docs = pipe.ingest(gen.flow_batch(32, T0)) + pipe.drain()
    return docs[0]


def test_tags_schema_width_unchanged():
    assert TAG_SCHEMA.num_fields == len(ref_codec._T.fields)


def test_worker_counters_hold_under_thread_stress(stream):
    """More workers than cores, a short switch interval: every doc is
    counted once in and once out (a lost counter update would break it)."""
    import os
    import sys

    workers = 2 * (os.cpu_count() or 4)
    frames = [encode_frame(FlowHeader(msg_type=int(MessageType.METRICS), agent_id=1 + i,
                                      organization_id=1), stream["msgs"][i * 8:(i + 1) * 8])
              for i in range(40)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    recv = Receiver()
    recv.start()
    writer = ListWriter()
    ing = FlowMetricsIngester(recv, writer, n_workers=workers)
    try:
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(b"".join(frames))
            assert _wait(lambda: ing.get_counters()["docs_written"] == 320, timeout=60)
        c = ing.get_counters()
        assert c["docs_in"] == 320 and c["frames_in"] == 40
        assert _wait(lambda: writer.doc_count() == 320, timeout=10)
    finally:
        sys.setswitchinterval(interval)
        ing.stop()
        recv.stop()
    assert not any(t.is_alive() for t in ing._threads)
