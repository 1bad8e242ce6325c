"""Synthetic flow replay — the test/bench firehose (port copy of
deepflow_tpu/ingest/replay.py: the same seed gives the same records and
arrays as the JAX package's generators).

Stands in for the reference's pcap-replay tools: generates
accumulated-flow records over a fixed population of 5-tuples with
realistic field distributions, either as python dicts (oracle input) or
as ready-made SoA FlowBatches (device input). Deterministic per seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..datamodel.batch import FLOW_RECORD_TAG_FIELDS, FlowBatch
from ..datamodel.code import Direction, L7Protocol, SignalSource
from ..datamodel.schema import APP_METER, FLOW_METER


@dataclasses.dataclass
class SyntheticFlowGen:
    num_tuples: int = 10_000  # unique flow population (BASELINE config 1)
    seed: int = 0
    start_time: int = 1_700_000_000
    agent_id: int = 1
    # fraction of flows with both directions known / one / none
    p_both_dirs: float = 0.7
    p_one_dir: float = 0.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.num_tuples
        self.pop = {
            "ip0": rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32),
            "ip1": rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32),
            "port": rng.choice(
                np.array([80, 443, 3306, 6379, 8080, 9092], dtype=np.uint32), n
            ),
            "proto": rng.choice(np.array([6, 6, 6, 17], dtype=np.uint32), n),
            "epc0": rng.integers(1, 50, n, dtype=np.uint32),
            "epc1": rng.integers(1, 50, n, dtype=np.uint32),
            "pod0": rng.integers(1, 500, n, dtype=np.uint32),
            "gpid0": rng.integers(0, 1000, n, dtype=np.uint32),
            "gpid1": rng.integers(0, 1000, n, dtype=np.uint32),
        }
        u = rng.random(n)
        self.pop_dir0 = np.where(u < self.p_both_dirs + self.p_one_dir, np.uint32(Direction.CLIENT_TO_SERVER), 0)
        self.pop_dir1 = np.where(u < self.p_both_dirs, np.uint32(Direction.SERVER_TO_CLIENT), 0)
        self._rng = rng

    def _draw(self, batch: int, t: int):
        rng = self._rng
        idx = rng.integers(0, self.num_tuples, batch)
        pkts = rng.integers(1, 100, batch)
        bytes_ = pkts * rng.integers(64, 1400, batch)
        rtt = rng.integers(100, 50_000, batch)
        return idx, pkts, bytes_, rtt

    def records(self, batch: int, t: int) -> list[dict]:
        """One batch of flow dicts at timestamp t (oracle/codec input)."""
        idx, pkts, bytes_, rtt = self._draw(batch, t)
        p = self.pop
        out = []
        for i in range(batch):
            j = int(idx[i])
            out.append(
                {
                    "timestamp": t,
                    "global_thread_id": 1,
                    "agent_id": self.agent_id,
                    "signal_source": int(SignalSource.PACKET),
                    "ip0_w3": int(p["ip0"][j]),
                    "ip1_w3": int(p["ip1"][j]),
                    "l3_epc_id": int(p["epc0"][j]),
                    "l3_epc_id1": int(p["epc1"][j]),
                    "gpid0": int(p["gpid0"][j]),
                    "gpid1": int(p["gpid1"][j]),
                    "pod_id": int(p["pod0"][j]),
                    "protocol": int(p["proto"][j]),
                    "server_port": int(p["port"][j]),
                    "tap_type": 3,
                    "tap_port": 1,
                    "direction0": int(self.pop_dir0[j]),
                    "direction1": int(self.pop_dir1[j]),
                    "is_active_host0": 1,
                    "is_active_host1": 1,
                    "is_active_service": 1,
                    "meter": {
                        "packet_tx": int(pkts[i]),
                        "packet_rx": int(pkts[i] // 2),
                        "byte_tx": int(bytes_[i]),
                        "byte_rx": int(bytes_[i] // 2),
                        "l3_byte_tx": int(bytes_[i] * 9 // 10),
                        "l3_byte_rx": int(bytes_[i] * 9 // 20),
                        "new_flow": 1,
                        "closed_flow": 0,
                        "rtt_max": int(rtt[i]),
                        "rtt_sum": int(rtt[i]),
                        "rtt_count": 1,
                        "syn": 1,
                        "synack": 1,
                    },
                }
            )
        return out

    def flow_batch(self, batch: int, t: int) -> FlowBatch:
        """Columnar batch straight into the device pipeline (fast path)."""
        idx, pkts, bytes_, rtt = self._draw(batch, t)
        p = self.pop
        tags = {f: np.zeros(batch, dtype=np.uint32) for f in FLOW_RECORD_TAG_FIELDS}
        tags["timestamp"][:] = t
        tags["global_thread_id"][:] = 1
        tags["agent_id"][:] = self.agent_id
        tags["signal_source"][:] = int(SignalSource.PACKET)
        tags["ip0_w3"] = p["ip0"][idx]
        tags["ip1_w3"] = p["ip1"][idx]
        tags["l3_epc_id"] = p["epc0"][idx]
        tags["l3_epc_id1"] = p["epc1"][idx]
        tags["gpid0"] = p["gpid0"][idx]
        tags["gpid1"] = p["gpid1"][idx]
        tags["pod_id"] = p["pod0"][idx]
        tags["protocol"] = p["proto"][idx]
        tags["server_port"] = p["port"][idx]
        tags["tap_type"][:] = 3
        tags["tap_port"][:] = 1
        tags["direction0"] = self.pop_dir0[idx]
        tags["direction1"] = self.pop_dir1[idx]
        tags["is_active_host0"][:] = 1
        tags["is_active_host1"][:] = 1
        tags["is_active_service"][:] = 1

        meters = np.zeros((batch, FLOW_METER.num_fields), dtype=np.float32)
        col = FLOW_METER.index
        meters[:, col("packet_tx")] = pkts
        meters[:, col("packet_rx")] = pkts // 2
        meters[:, col("byte_tx")] = bytes_
        meters[:, col("byte_rx")] = bytes_ // 2
        meters[:, col("l3_byte_tx")] = bytes_ * 9 // 10
        meters[:, col("l3_byte_rx")] = bytes_ * 9 // 20
        meters[:, col("new_flow")] = 1
        meters[:, col("rtt_max")] = rtt
        meters[:, col("rtt_sum")] = rtt
        meters[:, col("rtt_count")] = 1
        meters[:, col("syn")] = 1
        meters[:, col("synack")] = 1
        return FlowBatch(tags=tags, meters=meters, valid=np.ones(batch, dtype=bool))


@dataclasses.dataclass
class SyntheticAppGen:
    """L7 request-log firehose (BASELINE config 2): a service population
    with per-service endpoint sets, RED meters and log-normal-ish request
    latencies. Emits AppMeterWithFlow-shaped records/batches."""

    num_services: int = 64
    endpoints_per_service: int = 16
    seed: int = 0
    agent_id: int = 1
    p_error: float = 0.02

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.num_services
        self.svc = {
            "ip1": rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32),
            "port": rng.choice(np.array([80, 443, 8080, 9000], dtype=np.uint32), n),
            "epc1": rng.integers(1, 50, n, dtype=np.uint32),
            "l7": rng.choice(
                np.array(
                    [L7Protocol.HTTP1, L7Protocol.GRPC, L7Protocol.MYSQL, L7Protocol.REDIS],
                    dtype=np.uint32,
                ),
                n,
            ),
            # median latency per service, µs
            "lat_med": rng.integers(500, 20_000, n).astype(np.float64),
        }
        self._rng = rng

    def _draw(self, batch: int):
        rng = self._rng
        svc = rng.integers(0, self.num_services, batch)
        ep = rng.integers(0, self.endpoints_per_service, batch)
        # endpoint_hash as the reference computes it agent-side (a hash of
        # the endpoint string); here a mixed function of (svc, ep).
        ep_hash = (
            (svc.astype(np.uint64) * np.uint64(2654435761) + ep.astype(np.uint64))
            & np.uint64(0xFFFFFFFF)
        ).astype(np.uint32)
        client_ip = rng.integers(0x0A000000, 0x0AFFFFFF, batch, dtype=np.uint32)
        lat = (self.svc["lat_med"][svc] * rng.lognormal(0.0, 0.6, batch)).astype(np.uint32)
        err = rng.random(batch) < self.p_error
        return svc, ep_hash, client_ip, lat, err

    def records(self, batch: int, t: int, draw=None) -> list[dict]:
        svc, ep_hash, client_ip, lat, err = draw if draw is not None else self._draw(batch)
        s = self.svc
        out = []
        for i in range(batch):
            j = int(svc[i])
            out.append(
                {
                    "timestamp": t,
                    "global_thread_id": 1,
                    "agent_id": self.agent_id,
                    "signal_source": int(SignalSource.PACKET),
                    "ip0_w3": int(client_ip[i]),
                    "ip1_w3": int(s["ip1"][j]),
                    "l3_epc_id": 10,
                    "l3_epc_id1": int(s["epc1"][j]),
                    "protocol": 6,
                    "server_port": int(s["port"][j]),
                    "tap_type": 3,
                    "tap_port": 1,
                    "l7_protocol": int(s["l7"][j]),
                    "endpoint_hash": int(ep_hash[i]),
                    "direction0": int(Direction.CLIENT_TO_SERVER),
                    "direction1": int(Direction.SERVER_TO_CLIENT),
                    "is_active_host0": 1,
                    "is_active_host1": 1,
                    "is_active_service": 1,
                    "meter": {
                        "request": 1,
                        "response": 1,
                        "rrt_max": int(lat[i]),
                        "rrt_sum": int(lat[i]),
                        "rrt_count": 1,
                        "server_error": int(err[i]),
                    },
                }
            )
        return out

    def app_batch(self, batch: int, t: int, draw=None) -> FlowBatch:
        """Columnar batch (meters follow APP_METER). Pass the same `draw`
        (from `_draw`) to records() and app_batch to get both views of one
        workload — the conformance test uses that to pin their equivalence.
        """
        svc, ep_hash, client_ip, lat, err = draw if draw is not None else self._draw(batch)
        s = self.svc
        tags = {f: np.zeros(batch, dtype=np.uint32) for f in FLOW_RECORD_TAG_FIELDS}
        tags["timestamp"][:] = t
        tags["global_thread_id"][:] = 1
        tags["agent_id"][:] = self.agent_id
        tags["signal_source"][:] = int(SignalSource.PACKET)
        tags["ip0_w3"] = client_ip
        tags["ip1_w3"] = s["ip1"][svc]
        tags["l3_epc_id"][:] = 10
        tags["l3_epc_id1"] = s["epc1"][svc]
        tags["protocol"][:] = 6
        tags["server_port"] = s["port"][svc]
        tags["tap_type"][:] = 3
        tags["tap_port"][:] = 1
        tags["l7_protocol"] = s["l7"][svc]
        tags["endpoint_hash"] = ep_hash
        tags["direction0"][:] = int(Direction.CLIENT_TO_SERVER)
        tags["direction1"][:] = int(Direction.SERVER_TO_CLIENT)
        tags["is_active_host0"][:] = 1
        tags["is_active_host1"][:] = 1
        tags["is_active_service"][:] = 1

        meters = np.zeros((batch, APP_METER.num_fields), dtype=np.float32)
        col = APP_METER.index
        meters[:, col("request")] = 1
        meters[:, col("response")] = 1
        meters[:, col("rrt_max")] = lat
        meters[:, col("rrt_sum")] = lat
        meters[:, col("rrt_count")] = 1
        meters[:, col("server_error")] = err
        return FlowBatch(tags=tags, meters=meters, valid=np.ones(batch, dtype=bool))


@dataclasses.dataclass
class SyntheticTaggedFlowGen:
    """Per-second TaggedFlow emission stream for the flow-log plane.

    Models what FlowMap's inject_flush_ticker hands to FlowAggr
    (flow_map.rs:555 → flow_aggr.rs:216): every active flow emits one row
    per second carrying delta counters and its current lifecycle state;
    the final emission carries close_type. Flow lifetimes are drawn so a
    slice of the population spans minute boundaries — the case
    minute_merge exists for.
    """

    num_flows: int = 1000
    seed: int = 0
    agent_id: int = 1
    max_life_s: int = 90

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.num_flows
        self.flow_id = rng.integers(1, 1 << 62, n).astype(np.uint64)
        self.ip0 = rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32)
        self.ip1 = rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32)
        self.cport = rng.integers(32768, 61000, n, dtype=np.uint32)
        self.sport = rng.choice(np.array([80, 443, 3306, 6379], dtype=np.uint32), n)
        self.epc0 = rng.integers(1, 50, n, dtype=np.uint32)
        self.epc1 = rng.integers(1, 50, n, dtype=np.uint32)
        self.start_off = rng.integers(0, 30, n)
        self.life = rng.integers(1, self.max_life_s, n)
        self._rng = rng

    def batches_for_second(self, t0: int, sec: int, schema=None):
        """FlowLogBatch of all flows active at t0+sec (may be empty)."""
        from ..flowlog.aggr import FlowLogBatch
        from ..flowlog.schema import L4_FLOW_LOG

        schema = schema or L4_FLOW_LOG
        rng = self._rng
        active = np.nonzero(
            (self.start_off <= sec) & (sec < self.start_off + self.life)
        )[0]
        n = len(active)
        ints = np.zeros((n, len(schema.ints)), np.uint32)
        nums = np.zeros((n, len(schema.nums)), np.float32)
        ii = schema.int_index
        ni = schema.num_index
        fid = self.flow_id[active]
        ints[:, ii("flow_id_hi")] = (fid >> np.uint64(32)).astype(np.uint32)
        ints[:, ii("flow_id_lo")] = (fid & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ints[:, ii("agent_id")] = self.agent_id
        ints[:, ii("ip0_w3")] = self.ip0[active]
        ints[:, ii("ip1_w3")] = self.ip1[active]
        ints[:, ii("client_port")] = self.cport[active]
        ints[:, ii("server_port")] = self.sport[active]
        ints[:, ii("protocol")] = 6
        ints[:, ii("l3_epc_id_0")] = self.epc0[active]
        ints[:, ii("l3_epc_id_1")] = self.epc1[active]
        ints[:, ii("tap_type")] = 3
        ints[:, ii("tap_side")] = 1
        ints[:, ii("start_time")] = t0 + self.start_off[active]
        ints[:, ii("end_time")] = t0 + sec
        is_first = self.start_off[active] == sec
        is_last = (self.start_off[active] + self.life[active] - 1) == sec
        # lifecycle: 1 opening, 2 established, 3 closed
        ints[:, ii("state")] = np.where(is_last, 3, np.where(is_first, 1, 2))
        ints[:, ii("close_type")] = np.where(is_last, 1, 0)  # 1 = TCP_FIN
        ints[:, ii("status")] = 1
        ints[:, ii("tcp_flags_bit_0")] = np.where(
            is_first, 0x02, np.where(is_last, 0x11, 0x10)
        )
        pkts = rng.integers(1, 50, n)
        nums[:, ni("packet_tx")] = pkts
        nums[:, ni("packet_rx")] = pkts // 2
        nums[:, ni("byte_tx")] = pkts * rng.integers(64, 1400, n)
        nums[:, ni("byte_rx")] = (pkts // 2) * rng.integers(64, 1400, n)
        nums[:, ni("syn_count")] = is_first.astype(np.float32)
        nums[:, ni("rtt")] = np.where(is_first, rng.integers(100, 40_000, n), 0)
        nums[:, ni("retrans_tx")] = rng.random(n) < 0.05
        return FlowLogBatch(schema, ints, nums, np.ones(n, bool))


@dataclasses.dataclass
class SyntheticL7LogGen:
    """L7 request-log record stream (AppProtoLogs analog) with string
    fields for the l7_flow_log path."""

    num_services: int = 32
    seed: int = 0
    agent_id: int = 1

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.num_services
        self.ip1 = rng.integers(0x0A000000, 0x0AFFFFFF, n, dtype=np.uint32)
        self.port = rng.choice(np.array([80, 443, 8080], dtype=np.uint32), n)
        self.l7 = rng.choice(
            np.array([L7Protocol.HTTP1, L7Protocol.GRPC, L7Protocol.MYSQL], dtype=np.uint32), n
        )
        self.domain = [f"svc-{i}.example.local" for i in range(n)]
        self._rng = rng

    def batch(self, batch: int, t: int):
        from ..flowlog.aggr import FlowLogBatch
        from ..flowlog.schema import L7_FLOW_LOG

        schema = L7_FLOW_LOG
        rng = self._rng
        svc = rng.integers(0, self.num_services, batch)
        ints = np.zeros((batch, len(schema.ints)), np.uint32)
        nums = np.zeros((batch, len(schema.nums)), np.float32)
        ii = schema.int_index
        ints[:, ii("flow_id_hi")] = rng.integers(0, 1 << 31, batch)
        ints[:, ii("flow_id_lo")] = rng.integers(0, 1 << 31, batch)
        ints[:, ii("agent_id")] = self.agent_id
        ints[:, ii("ip0_w3")] = rng.integers(0x0A000000, 0x0AFFFFFF, batch)
        ints[:, ii("ip1_w3")] = self.ip1[svc]
        ints[:, ii("client_port")] = rng.integers(32768, 61000, batch)
        ints[:, ii("server_port")] = self.port[svc]
        ints[:, ii("protocol")] = 6
        ints[:, ii("l7_protocol")] = self.l7[svc]
        ints[:, ii("type")] = 2  # session
        ints[:, ii("status")] = np.where(rng.random(batch) < 0.03, 4, 1)
        ints[:, ii("status_code")] = np.where(ints[:, ii("status")] == 4, 500, 200)
        ints[:, ii("start_time")] = t
        ints[:, ii("end_time")] = t
        ints[:, ii("response_duration")] = rng.integers(200, 100_000, batch)
        ints[:, ii("tap_side")] = 1
        strs = {f.name: [""] * batch for f in schema.strs}
        for r in range(batch):
            s = int(svc[r])
            strs["request_type"][r] = "GET"
            strs["request_domain"][r] = self.domain[s]
            strs["request_resource"][r] = f"/api/v1/item/{int(rng.integers(0, 50))}"
            strs["endpoint"][r] = f"/api/v1/item/{{id}}"
            strs["app_service"][r] = f"svc-{s}"
        return FlowLogBatch(schema, ints, nums, np.ones(batch, bool), strs)
