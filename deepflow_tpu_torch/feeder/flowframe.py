"""Columnar FlowBatch wire frames — the feeder's flow-record transport
(port copy of deepflow_tpu/feeder/flowframe.py; byte-compatible).

Documents already have a wire form (ingest/codec.py, metric.proto), but
the windowed rollup pipelines consume PRE-fanout flow records
(datamodel/batch.FlowBatch), for which the reference has no
server-ingestible encoding — its collectors receive flows in-process
over queues (quadruple_generator.rs:275). This module gives flow
records the same self-contained-frame property the receiver's Document
lane has, so multi-queue fan-in can carry them through the SAME
Receiver/OverwriteQueue plumbing (MessageType.TAGGEDFLOW lane): one
frame = one columnar chunk, header + [len][body] framing identical to
every other lane (ingest/framing.encode_frame), body a fixed-layout
LE dump of the tag matrix + meter matrix.

Layout (all little-endian):

    u32 magic   'WOLF' (0x464C4F57 reads "FLOW" in LE byte order)
    u32 version (1)
    u32 n_rows
    u32 n_tag_fields   — must equal len(FLOW_RECORD_TAG_FIELDS)
    u32 n_meter_fields — must equal FLOW_METER.num_fields
    u32 [n_tag_fields, n_rows] tag matrix, FLOW_RECORD_TAG_FIELDS order
    f32 [n_rows, n_meter_fields] meter matrix

Only valid rows are encoded (the decoder returns an all-valid batch);
field COUNTS are checked at decode so schema drift fails loudly rather
than bit-casting misaligned columns. `peek_rows` reads the record count
from the header alone — the feeder's shed accounting must know how many
records a dropped frame carried without paying for its decode.
"""

from __future__ import annotations

import struct

import numpy as np

from ..datamodel.batch import FLOW_RECORD_TAG_FIELDS, FlowBatch
from ..datamodel.schema import FLOW_METER
from ..ingest.framing import FlowHeader, MessageType, encode_frame

FLOWFRAME_MAGIC = 0x464C4F57
FLOWFRAME_VERSION = 1
_HDR = struct.Struct("<IIIII")


def encode_flowbatch_body(fb: FlowBatch) -> bytes:
    """One FlowBatch (valid rows only) → one flowframe message body."""
    keep = np.flatnonzero(fb.valid)
    n = int(keep.size)
    tags = np.stack(
        [np.asarray(fb.tags[f], dtype="<u4")[keep] for f in FLOW_RECORD_TAG_FIELDS]
    )
    meters = np.ascontiguousarray(fb.meters[keep].astype("<f4"))
    return (
        _HDR.pack(
            FLOWFRAME_MAGIC,
            FLOWFRAME_VERSION,
            n,
            len(FLOW_RECORD_TAG_FIELDS),
            FLOW_METER.num_fields,
        )
        + tags.tobytes()
        + meters.tobytes()
    )


def encode_flowbatch_frames(
    fb: FlowBatch,
    *,
    agent_id: int = 0,
    org_id: int = 0,
    max_rows_per_frame: int = 2048,
) -> list[bytes]:
    """FlowBatch → raw wire frames (header + framed body) on the
    TAGGEDFLOW lane, chunked so every frame stays well under
    MAX_FRAME_SIZE. These are exactly what `Receiver` queues hold and
    what the feeder drains."""
    frames = []
    for off in range(0, max(fb.size, 1), max_rows_per_frame):
        chunk = fb.slice(off, off + max_rows_per_frame)
        if not np.any(chunk.valid):
            continue
        header = FlowHeader(
            msg_type=int(MessageType.TAGGEDFLOW),
            agent_id=agent_id,
            organization_id=org_id,
        )
        frames.append(encode_frame(header, [encode_flowbatch_body(chunk)]))
    return frames


def peek_rows(body: bytes) -> int:
    """Record count from the body header alone (shed accounting — a
    dropped frame is counted, never decoded)."""
    if len(body) < _HDR.size:
        return 0
    magic, version, n, _t, _m = _HDR.unpack_from(body, 0)
    if magic != FLOWFRAME_MAGIC:
        return 0
    return int(n)


def decode_flowframe_body(body: bytes) -> FlowBatch:
    """One flowframe message body → all-valid FlowBatch. Raises
    ValueError on magic/version/field-count/size drift (the untrusted-
    edge stance every decoder in ingest/ takes)."""
    if len(body) < _HDR.size:
        raise ValueError("flowframe: short body")
    magic, version, n, t, m = _HDR.unpack_from(body, 0)
    if magic != FLOWFRAME_MAGIC:
        raise ValueError(f"flowframe: bad magic {magic:#x}")
    if version != FLOWFRAME_VERSION:
        raise ValueError(f"flowframe: version {version} != {FLOWFRAME_VERSION}")
    if t != len(FLOW_RECORD_TAG_FIELDS) or m != FLOW_METER.num_fields:
        raise ValueError(
            f"flowframe: field counts ({t}, {m}) != "
            f"({len(FLOW_RECORD_TAG_FIELDS)}, {FLOW_METER.num_fields}) — "
            "schema drift between sender and receiver"
        )
    need = _HDR.size + 4 * t * n + 4 * n * m
    if len(body) < need:
        raise ValueError(f"flowframe: truncated body ({len(body)} < {need})")
    off = _HDR.size
    tag_mat = np.frombuffer(body, dtype="<u4", count=t * n, offset=off).reshape(t, n)
    off += 4 * t * n
    meters = np.frombuffer(body, dtype="<f4", count=n * m, offset=off).reshape(n, m)
    tags = {
        f: np.ascontiguousarray(tag_mat[i])
        for i, f in enumerate(FLOW_RECORD_TAG_FIELDS)
    }
    return FlowBatch(
        tags=tags,
        meters=np.ascontiguousarray(meters),
        valid=np.ones(n, dtype=bool),
    )
