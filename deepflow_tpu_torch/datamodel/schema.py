"""Declarative tag/meter column registries — the device-facing ABI
(port copy of deepflow_tpu/datamodel/schema.py).

The reference's `Tagger` struct (document.rs:287-340) and meter structs
(meter.rs:88-560) become *named columns* of fixed dtype here. Every device
kernel is schema-driven: merge ops, reverse permutations and key-column
masks are all derived from these tables instead of hand-written per field,
so adding a field is a one-line change.

Merge semantics (meter.rs `sequential_merge`):
  * SUM  — counters (packets, bytes, latency sums/counts, anomalies).
  * MAX  — watermarks (latency maxima, direction_score).
`reverse()` (meter.rs:169-177) swaps tx/rx pairs and zeroes
direction_score; we encode it as a column permutation + zero mask.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


class MergeOp(enum.Enum):
    SUM = "sum"
    MAX = "max"


@dataclasses.dataclass(frozen=True)
class MeterField:
    name: str
    op: MergeOp
    # Name of the field this one swaps with under reverse(); "" = no swap.
    reverse_with: str = ""
    # Zeroed on reverse (direction_score semantics, meter.rs:174).
    zero_on_reverse: bool = False


@dataclasses.dataclass(frozen=True)
class MeterSchema:
    """A flat meter layout: one f32 device column per field."""

    name: str
    fields: tuple[MeterField, ...]

    def __post_init__(self):
        object.__setattr__(self, "_index", {f.name: i for i, f in enumerate(self.fields)})

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    def index(self, name: str) -> int:
        return self._index[name]

    @property
    def sum_mask(self) -> np.ndarray:
        return np.array([f.op is MergeOp.SUM for f in self.fields], dtype=bool)

    @property
    def max_mask(self) -> np.ndarray:
        return np.array([f.op is MergeOp.MAX for f in self.fields], dtype=bool)

    @property
    def reverse_perm(self) -> np.ndarray:
        """Column permutation implementing meter reverse() as a gather."""
        perm = np.arange(self.num_fields, dtype=np.int32)
        for i, f in enumerate(self.fields):
            if f.reverse_with:
                perm[i] = self.index(f.reverse_with)
        return perm

    @property
    def reverse_zero_mask(self) -> np.ndarray:
        return np.array([f.zero_on_reverse for f in self.fields], dtype=bool)

    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]


def _sum(name: str, reverse_with: str = "") -> MeterField:
    return MeterField(name, MergeOp.SUM, reverse_with)


def _max(name: str, zero_on_reverse: bool = False) -> MeterField:
    return MeterField(name, MergeOp.MAX, zero_on_reverse=zero_on_reverse)


# FlowMeter = Traffic + Latency + Performance + Anomaly + FlowLoad
# (meter.rs:88-134, 141-176, 302-333, 345-366, 416-430).
#
# FlowLoad deviation: the reference updates flow_load with a sequential,
# order-dependent rule (meter.rs:420-428). A data-parallel reduce needs a
# commutative op, so we model load/flow_count as SUM of per-record deltas;
# the oracle mirrors this definition, and the divergence is bounded by the
# per-window closed-flow count (documented in ARCHITECTURE.md §5).
FLOW_METER = MeterSchema(
    "flow",
    tuple(
        [
            # Traffic (meter.rs:133-176)
            _sum("packet_tx", "packet_rx"),
            _sum("packet_rx", "packet_tx"),
            _sum("byte_tx", "byte_rx"),
            _sum("byte_rx", "byte_tx"),
            _sum("l3_byte_tx", "l3_byte_rx"),
            _sum("l3_byte_rx", "l3_byte_tx"),
            _sum("l4_byte_tx", "l4_byte_rx"),
            _sum("l4_byte_rx", "l4_byte_tx"),
            _sum("new_flow"),
            _sum("closed_flow"),
            _sum("l7_request"),
            _sum("l7_response"),
            _sum("syn"),
            _sum("synack"),
            _max("direction_score", zero_on_reverse=True),
            # Latency (meter.rs:202-276): 8 maxima, 8 sums, 8 counts.
            _max("rtt_max"),
            _max("rtt_client_max"),
            _max("rtt_server_max"),
            _max("srt_max"),
            _max("art_max"),
            _max("rrt_max"),
            _max("cit_max"),
            _max("tls_rtt_max"),
            _sum("rtt_sum"),
            _sum("rtt_client_sum"),
            _sum("rtt_server_sum"),
            _sum("srt_sum"),
            _sum("art_sum"),
            _sum("rrt_sum"),
            _sum("cit_sum"),
            _sum("tls_rtt_sum"),
            _sum("rtt_count"),
            _sum("rtt_client_count"),
            _sum("rtt_server_count"),
            _sum("srt_count"),
            _sum("art_count"),
            _sum("rrt_count"),
            _sum("cit_count"),
            _sum("tls_rtt_count"),
            # Performance (meter.rs:311-333)
            _sum("retrans_tx"),
            _sum("retrans_rx"),
            _sum("zero_win_tx"),
            _sum("zero_win_rx"),
            _sum("retrans_syn"),
            _sum("retrans_synack"),
            # Anomaly (meter.rs:345-391)
            _sum("client_rst_flow"),
            _sum("server_rst_flow"),
            _sum("client_ack_miss"),
            _sum("server_syn_miss"),
            _sum("client_half_close_flow"),
            _sum("server_half_close_flow"),
            _sum("client_source_port_reuse"),
            _sum("client_establish_reset"),
            _sum("server_reset"),
            _sum("server_queue_lack"),
            _sum("server_establish_reset"),
            _sum("tcp_timeout"),
            _sum("l7_client_error"),
            _sum("l7_server_error"),
            _sum("l7_timeout"),
            # FlowLoad (see deviation note above)
            _sum("flow_load"),
            _sum("flow_count"),
        ]
    ),
)

# AppMeter = AppTraffic + AppLatency + AppAnomaly (meter.rs:433-545).
APP_METER = MeterSchema(
    "app",
    tuple(
        [
            _sum("request", "response"),
            _sum("response", "request"),
            _max("direction_score", zero_on_reverse=True),
            _max("rrt_max"),
            _sum("rrt_sum"),
            _sum("rrt_count"),
            _sum("client_error"),
            _sum("server_error"),
            _sum("timeout"),
        ]
    ),
)

# UsageMeter (meter.rs:547-560). Emitted by the ACL/policy doc path
# (collector.rs:440-487); its fields map 1:1 onto Traffic columns so the L4
# stash can host Usage docs in the same meter matrix, discriminated by the
# `meter_id` tag column.
USAGE_METER = MeterSchema(
    "usage",
    tuple(
        [
            _sum("packet_tx", "packet_rx"),
            _sum("packet_rx", "packet_tx"),
            _sum("byte_tx", "byte_rx"),
            _sum("byte_rx", "byte_tx"),
            _sum("l3_byte_tx", "l3_byte_rx"),
            _sum("l3_byte_rx", "l3_byte_tx"),
            _sum("l4_byte_tx", "l4_byte_rx"),
            _sum("l4_byte_rx", "l4_byte_tx"),
        ]
    ),
)


@dataclasses.dataclass(frozen=True)
class TagField:
    name: str
    # All tag columns are uint32 on device. `key` says whether the column
    # participates in the group-by fingerprint (all of them do by default —
    # inactive fields are zeroed per Code by the fanout stage, reproducing
    # StashKey equality, collector.rs:128-139).
    key: bool = True


@dataclasses.dataclass(frozen=True)
class TagSchema:
    fields: tuple[TagField, ...]

    def __post_init__(self):
        object.__setattr__(self, "_index", {f.name: i for i, f in enumerate(self.fields)})

    @property
    def num_fields(self) -> int:
        return len(self.fields)

    def index(self, name: str) -> int:
        return self._index[name]

    def indices(self, names: Sequence[str]) -> np.ndarray:
        return np.array([self.index(n) for n in names], dtype=np.int32)

    @property
    def key_mask(self) -> np.ndarray:
        return np.array([f.key for f in self.fields], dtype=bool)

    def field_names(self) -> list[str]:
        return [f.name for f in self.fields]


# Tagger → columns (document.rs:287-340). IPs are 4×u32 words (IPv4 in
# word 3, words 0-2 zero, matching a right-aligned big-endian v6 layout);
# MACs are 2×u32 (hi16/lo32).
TAG_SCHEMA = TagSchema(
    tuple(
        [
            TagField("code_id"),  # dense CodeId — the fast_id CodeID bits
            TagField("meter_id"),  # MeterId discriminant (flow/app/usage)
            TagField("global_thread_id"),
            TagField("agent_id"),
            TagField("is_ipv6"),
            TagField("ip0_w0"),
            TagField("ip0_w1"),
            TagField("ip0_w2"),
            TagField("ip0_w3"),
            TagField("ip1_w0"),
            TagField("ip1_w1"),
            TagField("ip1_w2"),
            TagField("ip1_w3"),
            TagField("l3_epc_id"),  # i16 stored as u16 (sign-folded)
            TagField("l3_epc_id1"),
            TagField("mac0_hi"),
            TagField("mac0_lo"),
            TagField("mac1_hi"),
            TagField("mac1_lo"),
            TagField("direction"),
            # tap_side is a pure function of direction (document.rs:243) —
            # not part of StashKey equality.
            TagField("tap_side", key=False),
            TagField("protocol"),
            TagField("acl_gid"),
            TagField("server_port"),
            TagField("tap_port"),
            TagField("tap_type"),
            TagField("l7_protocol"),
            TagField("gpid0"),
            TagField("gpid1"),
            TagField("endpoint_hash"),
            TagField("time_span"),
            TagField("biz_type"),
            TagField("signal_source"),
            # pod_id rides along for server-side enrichment but is absent
            # from StashKey (collector.rs:128-139) — first-writer-wins.
            TagField("pod_id", key=False),
        ]
    )
)
