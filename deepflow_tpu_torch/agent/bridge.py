"""FlowMap emissions → metrics-pipeline input.

Port copy of deepflow_tpu/agent/bridge.py.

In the reference, FlowMap's per-second TaggedFlow batches feed BOTH the
collector chain (QuadrupleGenerator → Collector → metric Documents) and
FlowAggr (minute flow logs) from the same queue (trident.rs pipeline
wiring). The L4_FLOW_LOG emission rows already ARE the FlowAggr input;
this bridge produces the other consumer's shape — a `FlowBatch` of tag
columns + FLOW_METER meters for `L4Pipeline.ingest`.
"""

from __future__ import annotations

import numpy as np

from ..datamodel.batch import FLOW_RECORD_TAG_FIELDS, FlowBatch
from ..datamodel.code import Direction
from ..datamodel.schema import FLOW_METER
from ..flowlog.aggr import FlowLogBatch
from ..flowlog.schema import L4_FLOW_LOG
from .flow_map import CLOSE_NONE, CLOSE_TIMEOUT

_M = FLOW_METER.index


def emissions_to_flow_batch(b: FlowLogBatch, *, epc0: int = 0, epc1: int = 0,
                            possible=None) -> FlowBatch:
    """L4_FLOW_LOG emission rows → metrics-path FlowBatch.

    `possible`: optional PossibleHostTable (agent/possible.py). When
    given, is_active_host0/1 come from observed-traffic activity
    instead of the all-active default (the quadruple generator's
    possible_host consult, quadruple_generator.rs:342)."""
    assert b.schema is L4_FLOW_LOG
    s = b.schema
    n = b.size
    tags = {f: np.zeros(n, np.uint32) for f in FLOW_RECORD_TAG_FIELDS}
    ic = b.col

    tags["timestamp"] = ic("end_time").astype(np.uint32)
    tags["agent_id"] = ic("agent_id").astype(np.uint32)
    tags["signal_source"] = ic("signal_source").astype(np.uint32)
    tags["is_ipv6"] = ic("is_ipv6").astype(np.uint32)
    for w in range(4):
        tags[f"ip0_w{w}"] = ic(f"ip0_w{w}").astype(np.uint32)
        tags[f"ip1_w{w}"] = ic(f"ip1_w{w}").astype(np.uint32)
    tags["l3_epc_id"][:] = epc0
    tags["l3_epc_id1"][:] = epc1
    tags["protocol"] = ic("protocol").astype(np.uint32)
    tags["server_port"] = ic("server_port").astype(np.uint32)
    tags["tap_port"] = ic("tap_port").astype(np.uint32)
    tags["tap_type"] = ic("tap_type").astype(np.uint32)
    tags["l7_protocol"] = ic("l7_protocol").astype(np.uint32)
    tags["direction0"][:] = int(Direction.CLIENT_TO_SERVER)
    tags["direction1"][:] = int(Direction.SERVER_TO_CLIENT)
    if possible is None:
        tags["is_active_host0"][:] = 1
        tags["is_active_host1"][:] = 1
    else:
        from .possible import _hash_ips

        valid_rows = np.asarray(b.valid, bool)
        ts_valid = tags["timestamp"][valid_rows]
        now = int(ts_valid.max()) if ts_valid.size else 0
        ip0 = np.stack([tags[f"ip0_w{w}"] for w in range(4)], axis=1)
        ip1 = np.stack([tags[f"ip1_w{w}"] for w in range(4)], axis=1)
        k0, k1 = _hash_ips(ip0), _hash_ips(ip1)  # hash once per side
        # an endpoint that transmitted in this flow is active by
        # observation; the table remembers it across flows/windows.
        # Invalid padding rows must neither stamp the table nor move
        # the clock.
        sent0 = valid_rows & (ic("packet_tx").astype(np.int64) > 0)
        sent1 = valid_rows & (ic("packet_rx").astype(np.int64) > 0)
        possible.add_keys(k0[sent0], now)
        possible.add_keys(k1[sent1], now)
        tags["is_active_host0"] = possible.check_keys(k0, now).astype(np.uint32)
        tags["is_active_host1"] = possible.check_keys(k1, now).astype(np.uint32)

    meters = np.zeros((n, FLOW_METER.num_fields), np.float32)
    for src, dst in (
        ("packet_tx", "packet_tx"),
        ("packet_rx", "packet_rx"),
        ("byte_tx", "byte_tx"),
        ("byte_rx", "byte_rx"),
        ("l4_byte_tx", "l4_byte_tx"),
        ("l4_byte_rx", "l4_byte_rx"),
        ("syn_count", "syn"),
        ("synack_count", "synack"),
        ("retrans_tx", "retrans_tx"),
        ("retrans_rx", "retrans_rx"),
    ):
        meters[:, _M(dst)] = b.col(src)

    close_type = ic("close_type")
    meters[:, _M("closed_flow")] = (close_type != CLOSE_NONE).astype(np.float32)
    meters[:, _M("new_flow")] = (ic("is_new_flow") != 0).astype(np.float32)
    meters[:, _M("tcp_timeout")] = (close_type == CLOSE_TIMEOUT).astype(np.float32)

    rtt_c = b.col("rtt_client_max")
    rtt_s = b.col("rtt_server_max")
    rtt = b.col("rtt")
    have = rtt > 0
    meters[:, _M("rtt_max")] = rtt
    meters[:, _M("rtt_sum")] = rtt
    meters[:, _M("rtt_count")] = have.astype(np.float32)
    meters[:, _M("rtt_client_max")] = rtt_c
    meters[:, _M("rtt_client_sum")] = rtt_c
    meters[:, _M("rtt_client_count")] = (rtt_c > 0).astype(np.float32)
    meters[:, _M("rtt_server_max")] = rtt_s
    meters[:, _M("rtt_server_sum")] = rtt_s
    meters[:, _M("rtt_server_count")] = (rtt_s > 0).astype(np.float32)

    return FlowBatch(tags=tags, meters=meters, valid=b.valid.copy())
