"""Struct-of-arrays batch containers — host↔device ABI (port copy of
deepflow_tpu/datamodel/batch.py).

`FlowBatch` is the decoded input: one row per accumulated flow interval
(what the reference calls `FlowMeterWithFlow` entering `Collector::collect_l4`,
collector.rs:380). `DocBatch` is the post-fanout stream of candidate
documents: a u32 tag matrix + f32 meter matrix + timestamp + validity mask,
the shape every device kernel consumes.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from .schema import FLOW_METER, TAG_SCHEMA, MeterSchema, TagSchema

# Input columns of a decoded flow record (pre-fanout). Everything u32
# except meters. direction0/1 use Direction values; is_active_host* are
# 0/1 flags (collector.rs:489-499 activity gating).
FLOW_RECORD_TAG_FIELDS: tuple[str, ...] = (
    "timestamp",  # seconds
    "global_thread_id",
    "agent_id",
    "signal_source",
    "is_ipv6",
    "ip0_w0",
    "ip0_w1",
    "ip0_w2",
    "ip0_w3",
    "ip1_w0",
    "ip1_w1",
    "ip1_w2",
    "ip1_w3",
    "mac0_hi",
    "mac0_lo",
    "mac1_hi",
    "mac1_lo",
    "l3_epc_id",
    "l3_epc_id1",
    "gpid0",
    "gpid1",
    "pod_id",
    "protocol",
    "server_port",
    "tap_port",
    "tap_type",
    "l7_protocol",
    "direction0",
    "direction1",
    "is_active_host0",
    "is_active_host1",
    "is_vip0",
    "is_vip1",
    "is_active_service",
    # L7-only fields (AppMeterWithFlow, collector.rs:101-112); zero for L4
    # records.
    "endpoint_hash",
    "biz_type",
    "time_span",
)

# The raw-tag packing plan (fingerprint hot path) must cover exactly
# these columns — a field added here without a width entry would be
# silently dropped from the group-by key, so fail at import instead.
from .code import RAW_TAG_PACK as _RAW_TAG_PACK  # noqa: E402

assert set(_RAW_TAG_PACK.field_names()) == set(FLOW_RECORD_TAG_FIELDS), (
    "RAW_TAG_WIDTHS (datamodel/code.py) out of sync with FLOW_RECORD_TAG_FIELDS"
)


@dataclasses.dataclass
class FlowBatch:
    """Decoded flow records, columnar. tags: [N] u32 per field; meters:
    [N, FLOW_METER.num_fields] f32; valid: [N] bool (padding mask)."""

    tags: dict[str, np.ndarray]
    meters: np.ndarray
    valid: np.ndarray

    @property
    def size(self) -> int:
        return int(self.meters.shape[0])

    @classmethod
    def from_records(cls, records: list[Mapping], meter_schema: MeterSchema = FLOW_METER) -> "FlowBatch":
        """Build a batch from per-flow dicts (test/replay convenience)."""
        n = len(records)
        tags = {f: np.zeros(n, dtype=np.uint32) for f in FLOW_RECORD_TAG_FIELDS}
        meters = np.zeros((n, meter_schema.num_fields), dtype=np.float32)
        for i, r in enumerate(records):
            for f in FLOW_RECORD_TAG_FIELDS:
                if f in r:
                    tags[f][i] = np.uint32(int(r[f]) & 0xFFFFFFFF)
            m = r.get("meter", {})
            for name, v in m.items():
                meters[i, meter_schema.index(name)] = v
        return cls(tags=tags, meters=meters, valid=np.ones(n, dtype=bool))

    def pad_to(self, n: int) -> "FlowBatch":
        """Pad to a static batch size (fixed shapes keep the step shapes,
        and so the accumulator ring, stable)."""
        cur = self.size
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"batch of {cur} cannot pad to {n}")
        pad = n - cur
        tags = {k: np.concatenate([v, np.zeros(pad, dtype=v.dtype)]) for k, v in self.tags.items()}
        meters = np.concatenate([self.meters, np.zeros((pad, self.meters.shape[1]), dtype=self.meters.dtype)])
        valid = np.concatenate([self.valid, np.zeros(pad, dtype=bool)])
        return FlowBatch(tags=tags, meters=meters, valid=valid)

    def slice(self, start: int, stop: int) -> "FlowBatch":
        """Row-range view (the feeder splits decoded chunks across
        bucket boundaries; numpy basic slicing keeps this copy-free)."""
        return FlowBatch(
            tags={k: v[start:stop] for k, v in self.tags.items()},
            meters=self.meters[start:stop],
            valid=self.valid[start:stop],
        )

    @classmethod
    def concat(cls, parts: list["FlowBatch"]) -> "FlowBatch":
        """Row-wise concatenation of same-schema batches."""
        if len(parts) == 1:
            return parts[0]
        keys = parts[0].tags.keys()
        return cls(
            tags={k: np.concatenate([p.tags[k] for p in parts]) for k in keys},
            meters=np.concatenate([p.meters for p in parts]),
            valid=np.concatenate([p.valid for p in parts]),
        )


@dataclasses.dataclass
class DocBatch:
    """Candidate documents after tag fanout.

    tags:      [N, TAG_SCHEMA.num_fields] u32
    meters:    [N, meter_schema.num_fields] f32
    timestamp: [N] u32 (seconds)
    valid:     [N] bool
    """

    tags: np.ndarray
    meters: np.ndarray
    timestamp: np.ndarray
    valid: np.ndarray
    tag_schema: TagSchema = TAG_SCHEMA
    meter_schema: MeterSchema = FLOW_METER

    @property
    def size(self) -> int:
        return int(self.tags.shape[0])

    def tag(self, name: str) -> np.ndarray:
        return self.tags[:, self.tag_schema.index(name)]

    def meter(self, name: str) -> np.ndarray:
        return self.meters[:, self.meter_schema.index(name)]

    def to_dicts(self) -> list[dict]:
        """Expand valid rows to python dicts (tests / JSON export)."""
        out = []
        tag_names = self.tag_schema.field_names()
        meter_names = self.meter_schema.field_names()
        for i in range(self.size):
            if not self.valid[i]:
                continue
            out.append(
                {
                    "timestamp": int(self.timestamp[i]),
                    "tag": {n: int(self.tags[i, j]) for j, n in enumerate(tag_names)},
                    "meter": {n: float(self.meters[i, j]) for j, n in enumerate(meter_names)},
                }
            )
        return out
