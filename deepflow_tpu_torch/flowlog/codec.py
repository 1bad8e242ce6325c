"""Schema-driven flow-log wire codec.

Port copy of deepflow_tpu/flowlog/codec.py.

The reference ships flow logs as protobuf `TaggedFlow` / `AppProtoLogsData`
messages (message/flow_log.proto:14,211) inside the standard framed
transport. Our wire format keeps the proto3 encoding primitives (varint /
length-delimited, so frames remain debuggable with stock pb tooling) but
derives the message layout from the LogSchema instead of a hand-kept
.proto tree: int lanes get field ids 1..Ki, num lanes Ki+1..Ki+Kn
(varint of the integral value), string columns after that
(length-delimited UTF-8). Zero values are omitted, proto3-style.

One codec serves every LogSchema — l4, l7, and any future log table —
and the columnar decode fills SoA lanes directly, never building row
objects (the DecodePB stance, libs/app/codec.go:28).
"""

from __future__ import annotations

import numpy as np

from ..ingest.codec import _iter_fields, _put_varint
from .aggr import FlowLogBatch
from .schema import LogSchema


def encode_rows(batch: FlowLogBatch) -> list[bytes]:
    s = batch.schema
    ki, kn = len(s.ints), len(s.nums)
    out = []
    ints = batch.ints
    nums = batch.nums
    for r in range(batch.size):
        if not batch.valid[r]:
            continue
        buf = bytearray()
        for i in range(ki):
            v = int(ints[r, i])
            if v:
                _put_varint(buf, (i + 1) << 3 | 0)
                _put_varint(buf, v)
        for j in range(kn):
            v = int(nums[r, j])
            if v:
                _put_varint(buf, (ki + 1 + j) << 3 | 0)
                _put_varint(buf, v)
        if batch.strs:
            for k, f in enumerate(s.strs):
                sv = batch.strs[f.name][r]
                if sv:
                    b = sv.encode()
                    _put_varint(buf, (ki + kn + 1 + k) << 3 | 2)
                    _put_varint(buf, len(b))
                    buf += b
        out.append(bytes(buf))
    return out


def decode_rows(schema: LogSchema, msgs: list[bytes]) -> tuple[FlowLogBatch, int]:
    """Decode messages → FlowLogBatch; returns (batch, decode_errors)."""
    ki, kn = len(schema.ints), len(schema.nums)
    ks = len(schema.strs)
    n = len(msgs)
    ints = np.zeros((n, ki), np.uint32)
    nums = np.zeros((n, kn), np.float32)
    strs: dict[str, list[str]] = {f.name: [""] * n for f in schema.strs}
    valid = np.zeros(n, bool)
    errors = 0
    for r, msg in enumerate(msgs):
        try:
            for field, v in _iter_fields(msg):
                if 1 <= field <= ki:
                    ints[r, field - 1] = v & 0xFFFFFFFF
                elif ki < field <= ki + kn:
                    nums[r, field - ki - 1] = float(v)
                elif ki + kn < field <= ki + kn + ks and isinstance(v, (bytes, bytearray)):
                    strs[schema.strs[field - ki - kn - 1].name][r] = bytes(v).decode(
                        errors="replace"
                    )
            valid[r] = True
        except Exception:
            errors += 1
    return FlowLogBatch(schema, ints, nums, valid, strs if ks else None), errors
