"""Synthetic flow replay — the test/bench firehose (port copy of
deepflow_tpu/ingest/replay.py::SyntheticFlowGen: the same seed gives the
same arrays as the JAX package's generator).

Stands in for the reference's pcap-replay tools: generates
accumulated-flow records over a fixed population of 5-tuples with
realistic field distributions, either as python dicts (oracle input) or
as ready-made SoA FlowBatches (device input). Deterministic per seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..datamodel.batch import FLOW_RECORD_TAG_FIELDS, FlowBatch
from ..datamodel.code import Direction, SignalSource
from ..datamodel.schema import FLOW_METER


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
