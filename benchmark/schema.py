"""Frozen copies of the rollup's data layout, for the benchmark's
generator and reference.

Nothing here imports the system under test: the column orders, meter
merge ops, enum values and the raw-tag packing plan are written out as
the L4 rollup defines them (flow record columns, the document tag
schema with its key flags, the FlowMeter schema). A change to any of
them in the program is a change of the rollup's output, which the
reference then flags.
"""

from __future__ import annotations

# Columns of a decoded flow record, in the record's order.
FLOW_FIELDS = (
    "timestamp", "global_thread_id", "agent_id", "signal_source", "is_ipv6",
    "ip0_w0", "ip0_w1", "ip0_w2", "ip0_w3", "ip1_w0", "ip1_w1", "ip1_w2", "ip1_w3",
    "mac0_hi", "mac0_lo", "mac1_hi", "mac1_lo", "l3_epc_id", "l3_epc_id1",
    "gpid0", "gpid1", "pod_id", "protocol", "server_port", "tap_port", "tap_type",
    "l7_protocol", "direction0", "direction1", "is_active_host0", "is_active_host1",
    "is_vip0", "is_vip1", "is_active_service", "endpoint_hash", "biz_type", "time_span",
)

# Document tag columns, in order; the two non-key columns keep the
# value of the first row of their group.
DOC_FIELDS = (
    "code_id", "meter_id", "global_thread_id", "agent_id", "is_ipv6",
    "ip0_w0", "ip0_w1", "ip0_w2", "ip0_w3", "ip1_w0", "ip1_w1", "ip1_w2", "ip1_w3",
    "l3_epc_id", "l3_epc_id1", "mac0_hi", "mac0_lo", "mac1_hi", "mac1_lo",
    "direction", "tap_side", "protocol", "acl_gid", "server_port", "tap_port",
    "tap_type", "l7_protocol", "gpid0", "gpid1", "endpoint_hash", "time_span",
    "biz_type", "signal_source", "pod_id",
)
DOC_NON_KEY = ("tap_side", "pod_id")
DOC_KEY_INDEX = tuple(i for i, f in enumerate(DOC_FIELDS) if f not in DOC_NON_KEY)
DOC_NON_KEY_INDEX = tuple(DOC_FIELDS.index(f) for f in DOC_NON_KEY)

# FlowMeter columns: (name, op, reverse partner) — op "S" sums, "M"
# takes the max. The server-side single doc swaps each tx/rx pair and
# zeroes direction_score.
METER_FIELDS = (
    ("packet_tx", "S", "packet_rx"), ("packet_rx", "S", "packet_tx"),
    ("byte_tx", "S", "byte_rx"), ("byte_rx", "S", "byte_tx"),
    ("l3_byte_tx", "S", "l3_byte_rx"), ("l3_byte_rx", "S", "l3_byte_tx"),
    ("l4_byte_tx", "S", "l4_byte_rx"), ("l4_byte_rx", "S", "l4_byte_tx"),
    ("new_flow", "S", ""), ("closed_flow", "S", ""), ("l7_request", "S", ""),
    ("l7_response", "S", ""), ("syn", "S", ""), ("synack", "S", ""),
    ("direction_score", "M", ""), ("rtt_max", "M", ""), ("rtt_client_max", "M", ""),
    ("rtt_server_max", "M", ""), ("srt_max", "M", ""), ("art_max", "M", ""),
    ("rrt_max", "M", ""), ("cit_max", "M", ""), ("tls_rtt_max", "M", ""),
    ("rtt_sum", "S", ""), ("rtt_client_sum", "S", ""), ("rtt_server_sum", "S", ""),
    ("srt_sum", "S", ""), ("art_sum", "S", ""), ("rrt_sum", "S", ""), ("cit_sum", "S", ""),
    ("tls_rtt_sum", "S", ""), ("rtt_count", "S", ""), ("rtt_client_count", "S", ""),
    ("rtt_server_count", "S", ""), ("srt_count", "S", ""), ("art_count", "S", ""),
    ("rrt_count", "S", ""), ("cit_count", "S", ""), ("tls_rtt_count", "S", ""),
    ("retrans_tx", "S", ""), ("retrans_rx", "S", ""), ("zero_win_tx", "S", ""),
    ("zero_win_rx", "S", ""), ("retrans_syn", "S", ""), ("retrans_synack", "S", ""),
    ("client_rst_flow", "S", ""), ("server_rst_flow", "S", ""),
    ("client_ack_miss", "S", ""), ("server_syn_miss", "S", ""),
    ("client_half_close_flow", "S", ""), ("server_half_close_flow", "S", ""),
    ("client_source_port_reuse", "S", ""), ("client_establish_reset", "S", ""),
    ("server_reset", "S", ""), ("server_queue_lack", "S", ""),
    ("server_establish_reset", "S", ""), ("tcp_timeout", "S", ""),
    ("l7_client_error", "S", ""), ("l7_server_error", "S", ""), ("l7_timeout", "S", ""),
    ("flow_load", "S", ""), ("flow_count", "S", ""),
)
METER_NAMES = tuple(f[0] for f in METER_FIELDS)
METER_SUM = tuple(i for i, f in enumerate(METER_FIELDS) if f[1] == "S")
METER_MAX = tuple(i for i, f in enumerate(METER_FIELDS) if f[1] == "M")
METER_REVERSE_PERM = tuple(METER_NAMES.index(f[2]) if f[2] else i
                           for i, f in enumerate(METER_FIELDS))
METER_ZERO_ON_REVERSE = (METER_NAMES.index("direction_score"),)

# enum values of the flow and document model
DIR_NONE, DIR_C2S, DIR_S2C, DIR_LOCAL = 0, 1, 2, 4
DIR_APP = 48
DIR_SIDE_MASK = 0xF8
SIG_PACKET, SIG_XFLOW, SIG_EBPF, SIG_OTEL = 0, 1, 3, 4
CODE_SINGLE_IP_PORT, CODE_SINGLE_MAC_IP_PORT = 1, 2
CODE_EDGE_IP_PORT, CODE_EDGE_MAC_IP_PORT = 5, 6
METER_ID_FLOW = 1
EPC_INTERNET_U16 = 0xFFFE
TCP, UDP = 6, 17

# The raw-record group-by key: 32-bit columns pass as words, narrower
# ones pack into shared words (field, shift, width), and one last word
# folds every value's bits above its width (zero for in-range records).
RAW_WIDE = ("endpoint_hash", "gpid0", "gpid1", "ip0_w0", "ip0_w1", "ip0_w2", "ip0_w3",
            "ip1_w0", "ip1_w1", "ip1_w2", "ip1_w3", "mac0_lo", "mac1_lo", "pod_id",
            "tap_port", "time_span", "timestamp")
RAW_PACKED = (
    (("agent_id", 0, 16), ("global_thread_id", 16, 16)),
    (("l3_epc_id", 0, 16), ("l3_epc_id1", 16, 16)),
    (("mac0_hi", 0, 16), ("mac1_hi", 16, 16)),
    (("server_port", 0, 16), ("biz_type", 16, 8), ("direction0", 24, 8)),
    (("direction1", 0, 8), ("l7_protocol", 8, 8), ("protocol", 16, 8),
     ("signal_source", 24, 8)),
    (("tap_type", 0, 8), ("is_active_host0", 8, 1), ("is_active_host1", 9, 1),
     ("is_active_service", 10, 1), ("is_ipv6", 11, 1), ("is_vip0", 12, 1),
     ("is_vip1", 13, 1)),
)
