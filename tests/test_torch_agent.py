"""The agent on the port — `Agent.run_pcap` (parse → FlowMap → L7 engine
→ metric pipelines and minute flow-log aggregation → senders) and the
server's `FlowLogIngester` — against the reference's, on the CPU.

One crafted capture goes through both packages' Agents through the
`senders=` recording seam: HTTP/1.1 keep-alive sessions (2xx and 5xx),
gRPC unary calls (HTTP/2 HEADERS + DATA in literal HPACK), DNS over
UDP, a bulk TCP transfer with a resend, SSH packets a capture filter
excludes, a DROP ACL and a PCAP ACL, behind a mirror dispatcher. Every
message of every type must be equal byte for byte, and so must the
agents' counters. Then each package's FlowLogIngester takes the same
TAGGEDFLOW / PROTOCOLLOG frames over localhost TCP and enriches them
against one platform registry: the stored rows are equal, and each
package's QueryEngine reads the other's flow_log store.

The reference's runs are cached per module. Every second of the
capture ends 3–4 request logs and 4 minute logs, so both ingesters
enrich batches of one padded size (the reference compiles one shape).
"""

from __future__ import annotations

import socket
import time

import numpy as np
import pytest
import torch

from deepflow_tpu.agent import dispatcher as ref_dispatcher
from deepflow_tpu.agent import main as ref_main
from deepflow_tpu.agent import packet as ref_packet
from deepflow_tpu.agent import policy as ref_policy
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.enrich import platform as ref_platform
from deepflow_tpu.flowlog.server import FlowLogIngester as RefFlowLogIngester
from deepflow_tpu.ingest.receiver import Receiver as RefReceiver
from deepflow_tpu.querier import QueryEngine as RefQueryEngine
from deepflow_tpu.storage.store import ColumnarStore as RefStore
from deepflow_tpu_torch.agent import dispatcher, main, packet, policy
from deepflow_tpu_torch.agent.packet import TCP_ACK, TCP_FIN, TCP_PSH, TCP_SYN, craft_tcp, craft_udp
from deepflow_tpu_torch.agent.pcap import write_pcap
from deepflow_tpu_torch.aggregator import window
from deepflow_tpu_torch.enrich import platform
from deepflow_tpu_torch.flowlog.server import FlowLogIngester
from deepflow_tpu_torch.ingest.framing import FlowHeader, MessageType, encode_frame
from deepflow_tpu_torch.ingest.receiver import Receiver
from deepflow_tpu_torch.querier import QueryEngine
from deepflow_tpu_torch.storage.store import ColumnarStore

CPU = torch.device("cpu")
T0 = 1_700_000_000  # 20 s into its minute
SRV_HTTP, SRV_GRPC, SRV_DNS, SRV_BULK = 0x0A000201, 0x0A000202, 0x0A000203, 0x0A000204
DROPPED_NET = 0x0A000900  # 10.0.9.0/24: the DROP ACL's source
MY_REGION = 2
SQL = (
    "SELECT Count() AS c, Sum(byte_tx) AS b, Max(rtt) AS r FROM l4_flow_log",
    "SELECT server_port AS p, Count() AS c, Sum(packet_tx) AS pk FROM l4_flow_log "
    "GROUP BY server_port ORDER BY p",
    "SELECT l7_protocol AS p, status_code AS s, Count() AS c FROM l7_flow_log "
    "GROUP BY l7_protocol, status_code ORDER BY p, s",
    "SELECT endpoint AS e, Count() AS c FROM l7_flow_log GROUP BY endpoint ORDER BY e",
)


def _h2_frame(ftype, flags, stream, body):
    return len(body).to_bytes(3, "big") + bytes([ftype, flags]) + stream.to_bytes(4, "big") + body


def _lit(name_idx, value):
    return bytes([0x40 | name_idx, len(value)]) + value


def _capture() -> list[tuple[int, int, bytes]]:
    pkts = []

    def add(t, us, frame):
        pkts.append((t, us, frame))

    for i in range(12):  # HTTP/1.1 keep-alive: 3 requests each
        cli, sport, t = 0x0A000101 + i % 5, 40000 + i, T0 + i % 4
        add(t, 0, craft_tcp(cli, SRV_HTTP, sport, 80, flags=TCP_SYN, seq=1))
        add(t, 150 + i, craft_tcp(SRV_HTTP, cli, 80, sport, flags=TCP_SYN | TCP_ACK, seq=9, ack=2))
        add(t, 300 + i, craft_tcp(cli, SRV_HTTP, sport, 80, flags=TCP_ACK, seq=2, ack=10))
        seq, sseq = 2, 10
        for k in range(3):
            tk = t + 20 * k
            req = f"GET /api/item/{k} HTTP/1.1\r\nHost: shop\r\n\r\n".encode()
            code = b"503 Unavailable" if (i + k) % 5 == 0 else b"200 OK"
            resp = b"HTTP/1.1 " + code + b"\r\nContent-Length: 0\r\n\r\n"
            add(tk, 500, craft_tcp(cli, SRV_HTTP, sport, 80, flags=TCP_ACK | TCP_PSH, seq=seq,
                                   ack=sseq, payload=req))
            add(tk, 900 + 10 * i, craft_tcp(SRV_HTTP, cli, 80, sport, flags=TCP_ACK | TCP_PSH,
                                            seq=sseq, ack=seq + len(req), payload=resp))
            seq, sseq = seq + len(req), sseq + len(resp)
        if i % 2:
            add(t + 45, 0, craft_tcp(cli, SRV_HTTP, sport, 80, flags=TCP_FIN | TCP_ACK, seq=seq))
            add(t + 45, 80, craft_tcp(SRV_HTTP, cli, 80, sport, flags=TCP_FIN | TCP_ACK, seq=sseq))
    req_hdr = b"\x83" + _lit(4, b"/pkg.Svc/Get") + _lit(31, b"application/grpc")
    resp_hdr = b"\x88" + _lit(31, b"application/grpc")
    for i in range(4):  # gRPC unary calls
        cli, sport, t = 0x0A000111 + i, 45000 + i, T0 + 50
        req = _h2_frame(1, 4, 1, req_hdr) + _h2_frame(0, 1, 1, b"\x00\x00\x00\x00\x03abc")
        resp = _h2_frame(1, 4, 1, resp_hdr) + _h2_frame(0, 1, 1, b"\x00\x00\x00\x00\x02ok")
        add(t, 0, craft_tcp(cli, SRV_GRPC, sport, 50051, flags=TCP_ACK | TCP_PSH, seq=100,
                            payload=req))
        add(t, 700, craft_tcp(SRV_GRPC, cli, 50051, sport, flags=TCP_ACK | TCP_PSH, seq=500,
                              payload=resp))
    for i in range(6):  # DNS query + response
        q = (0x1000 + i).to_bytes(2, "big") + b"\x01\x00\x00\x01\x00\x00\x00\x00\x00\x00" \
            + b"\x03www\x04shop\x00\x00\x01\x00\x01"
        r = q[:2] + b"\x81\x80" + q[4:]
        add(T0 + 10 + 2 * (i // 3), 10 + i, craft_udp(0x0A000121, SRV_DNS, 53000 + i, 53, q))
        add(T0 + 10 + 2 * (i // 3), 400 + i, craft_udp(SRV_DNS, 0x0A000121, 53, 53000 + i, r))
    for k in range(12):  # bulk TCP with one resend (the PCAP ACL's port)
        seq = 1 + 1400 * (k if k != 7 else 3)
        add(T0 + 5 + k // 4, 100 * k, craft_tcp(0x0A000131, SRV_BULK, 46000, 9000,
                                                flags=TCP_ACK | TCP_PSH, seq=seq,
                                                payload=bytes(range(256)) * 5))
    for k in range(4):  # SSH, excluded by the capture filter
        add(T0 + k, 50, craft_tcp(0x0A000141, SRV_HTTP, 47000, 22, flags=TCP_ACK, seq=k))
    for k in range(5):  # sources the DROP ACL removes
        add(T0 + k, 60, craft_tcp(DROPPED_NET + 1 + k, SRV_HTTP, 48000 + k, 80, flags=TCP_SYN))
    # a far-future packet so the first minute closes during the replay
    add(T0 + 115, 0, craft_tcp(0x0A000101, SRV_HTTP, 39999, 80, flags=TCP_SYN, seq=1))
    pkts.sort(key=lambda x: (x[0], x[1]))
    return pkts


class _ListSender:
    def __init__(self):
        self.msgs = []

    def send(self, msgs):
        self.msgs.extend(msgs)


def _config(pkg_main, pkg_window, pkg_packet, pkg_policy, pkg_dispatcher):
    return pkg_main.AgentConfig(
        flow_capacity=1 << 9, batch_size=256, l4_log_throttle=4,
        metrics_window=pkg_window.WindowConfig(capacity=1 << 12),
        capture_filter=pkg_packet.CaptureFilter(exclude_ports=(22,)),
        acls=(pkg_policy.Acl(id=1, action=pkg_policy.ACTION_DROP, src="10.0.9.0/24"),
              pkg_policy.Acl(id=2, action=pkg_policy.ACTION_PCAP, dst_ports=(9000, 9000))),
        dispatcher=pkg_dispatcher.DispatcherConfig(mode="mirror", macs=(0x020000000002,)),
    )


MSG_TYPES = ("METRICS", "TAGGEDFLOW", "PROTOCOLLOG", "RAW_PCAP")


def _run_agent(ref: bool, path):
    if ref:
        cfg = _config(ref_main, ref_window, ref_packet, ref_policy, ref_dispatcher)
        mt = ref_main.MessageType
        senders = {getattr(mt, m): _ListSender() for m in MSG_TYPES}
        agent = ref_main.Agent(cfg, senders=senders)
    else:
        cfg = _config(main, window, packet, policy, dispatcher)
        senders = {getattr(MessageType, m): _ListSender() for m in MSG_TYPES}
        agent = main.Agent(cfg, senders=senders, device=CPU)
    counters = agent.run_pcap(path, batch_size=64)
    return {"counters": counters, "msgs": {int(k): s.msgs for k, s in senders.items()},
            "flow_map": agent.flow_map.get_counters(),
            "flow_aggr": agent.flow_aggr.get_counters(),
            "throttle": dict(agent.l4_throttle.counters)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("cap") / "agent.pcap"
    write_pcap(path, _capture())
    return {"ref": _run_agent(True, path), "port": _run_agent(False, path)}


def test_every_message_equal_byte_for_byte(runs):
    ref, port = runs["ref"]["msgs"], runs["port"]["msgs"]
    assert sorted(ref) == sorted(port)
    for mt in ref:
        assert port[mt] == ref[mt], MessageType(mt).name
    for m in MSG_TYPES:  # the capture drives every output lane
        assert port[int(getattr(MessageType, m))], m


def test_counters_equal(runs):
    ref, port = runs["ref"], runs["port"]
    for k in ("counters", "flow_map", "flow_aggr", "throttle"):
        assert port[k] == ref[k], k
    c = port["counters"]
    assert c["packets_filtered"] == 4 and c["packets_dropped_policy"] == 5 and c["pcap_sent"] > 0
    assert port["throttle"]["dropped"] > 0  # the 4-row throttle sampled
    assert port["flow_map"]["dropped_overflow"] == port["flow_aggr"]["dropped_overflow"] == 0


def _platform(mod):
    """One registry: every crafted address is a pod's, in this region
    except the bulk server's."""
    pt = mod.PlatformInfoTable(my_region_id=MY_REGION)
    ips = ([0x0A000101 + i for i in range(5)] + [0x0A000111 + i for i in range(4)]
           + [0x0A000121, 0x0A000131, SRV_HTTP, SRV_GRPC, SRV_DNS, SRV_BULK])
    for pod, ip in enumerate(ips, start=1):
        pt.add_info(epc_id=0, ips=[ip], pod_id=pod, region_id=MY_REGION + (ip == SRV_BULK),
                    pod_node_id=10 + pod % 3, pod_group_id=20 + pod % 4, pod_group_type=101,
                    subnet_id=30 + pod, az_id=1, pod_cluster_id=1)
    return pt


def _frames(msgs, mt):
    return [encode_frame(FlowHeader(msg_type=int(mt), agent_id=1, organization_id=1),
                         msgs[i:i + 16]) for i in range(0, len(msgs), 16)]


def _ingest(ref: bool, frames, total: int, root):
    if ref:
        state = _platform(ref_platform).build()
        recv, store, cls = RefReceiver(), RefStore(root), RefFlowLogIngester
    else:
        state = _platform(platform).build(device=CPU)
        recv, store, cls = Receiver(), ColumnarStore(root), FlowLogIngester
    recv.start()
    ing = cls(recv, store, platform_state=state, n_workers=2,
              writer_args={"flush_interval_s": 0.05})
    try:
        with socket.create_connection(("127.0.0.1", recv.tcp_port)) as s:
            s.sendall(b"".join(frames))
            deadline = time.time() + 60
            while ing.get_counters()["rows_written"] < total:
                assert time.time() < deadline, ing.get_counters()
                time.sleep(0.02)
        ing.flush()
        counters = ing.get_counters()
    finally:
        ing.stop()
        recv.stop()
    return counters


def _canonical(cols: dict) -> dict:
    names = sorted(cols)
    keys = [np.unique(cols[k], return_inverse=True)[1] for k in names]
    order = np.lexsort(keys[::-1])
    return {k: np.asarray(cols[k])[order] for k in names}


@pytest.fixture(scope="module")
def stores(runs, tmp_path_factory):
    from deepflow_tpu_torch.flowlog.codec import decode_rows
    from deepflow_tpu_torch.flowlog.schema import L4_FLOW_LOG, L7_FLOW_LOG

    msgs = runs["port"]["msgs"]
    frames, total = [], 0
    for mt, schema in ((MessageType.TAGGEDFLOW, L4_FLOW_LOG),
                       (MessageType.PROTOCOLLOG, L7_FLOW_LOG)):
        frames += _frames(msgs[int(mt)], mt)
        total += int(decode_rows(schema, msgs[int(mt)])[0].valid.sum())
    roots = {k: tmp_path_factory.mktemp(f"{k}_flow_log") for k in ("ref", "port")}
    counters = {k: _ingest(k == "ref", frames, total, roots[k]) for k in ("ref", "port")}
    return {"roots": roots, "counters": counters, "total": total}


def test_flow_log_ingester_stores_equal_rows(stores):
    ref, port = RefStore(stores["roots"]["ref"]), ColumnarStore(stores["roots"]["port"])
    assert stores["counters"]["port"] == stores["counters"]["ref"]
    assert stores["counters"]["port"]["rows_written"] == stores["total"] > 0
    assert port.databases() == ref.databases() == ["flow_log"]
    assert port.tables("flow_log") == ref.tables("flow_log") == ["l4_flow_log", "l7_flow_log"]
    for t in port.tables("flow_log"):
        assert port.schema("flow_log", t).to_json() == ref.schema("flow_log", t).to_json()
        a, b = _canonical(port.scan("flow_log", t)), _canonical(ref.scan("flow_log", t))
        for k in b:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (t, k)
    pods = port.scan("flow_log", "l4_flow_log", columns=["pod_id_0", "pod_id_1"])
    assert (pods["pod_id_0"] > 0).any() and (pods["pod_id_1"] > 0).any()  # enriched
    l7 = port.scan("flow_log", "l7_flow_log", columns=["endpoint", "status_code", "l7_protocol"])
    assert {"/pkg.Svc/Get", "/api/item", "www.shop"} <= set(l7["endpoint"].tolist())
    assert {200, 503} <= set(l7["status_code"].tolist())
    assert len(set(l7["l7_protocol"].tolist())) == 3  # HTTP/1.1, gRPC, DNS


def _same(got, want):
    assert got.columns == want.columns and got.rows == want.rows > 0
    for c in want.columns:
        g, w = np.asarray(got.values[c]), np.asarray(want.values[c])
        assert g.dtype == w.dtype and np.array_equal(g, w), c


@pytest.mark.parametrize("sql", SQL)
def test_each_engine_reads_the_others_flow_log_store(stores, sql):
    q = sql.replace("FROM l4_flow_log", "FROM flow_log.l4_flow_log").replace(
        "FROM l7_flow_log", "FROM flow_log.l7_flow_log")
    ref_root, port_root = stores["roots"]["ref"], stores["roots"]["port"]
    ref_on_port = RefQueryEngine(RefStore(port_root), cache=False).execute(q)
    port_on_ref = QueryEngine(ColumnarStore(ref_root), cache=False, device=CPU).execute(q)
    port_on_port = QueryEngine(ColumnarStore(port_root), cache=False, device=CPU).execute(q)
    _same(port_on_ref, ref_on_port)
    _same(port_on_port, ref_on_port)


def test_agent_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        main.Agent(main.AgentConfig(), senders={})
