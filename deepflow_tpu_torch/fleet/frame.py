"""Fleet telemetry frame — the cross-host observability wire unit
(port of deepflow_tpu/fleet/frame.py; byte-equal frames).

One compact frame per collector tick per host, carrying that host's
telemetry in the SUMMARY domain (merge sketches/log-hists,
never raw samples):

  * counter samples — the tick's `StatsPoint`s (module, tags, fields),
  * log-hist dumps — nonzero `(bin, count)` pairs from the existing
    `hist_dump()` faces (freshness tiers, span stages) — histograms
    add bin-for-bin across hosts; quantile summaries don't,
  * alert series states — rule name + worst state + value, so the
    aggregator can worst-roll-up per rule fleet-wide,
  * HBM ledger rows + census summary — the per-host device-memory and
    compile-pressure pane,

all tagged `(host, shard_group, epoch)` so the merged store rows keep
per-host attribution as plain PromQL labels.

The wire format is the existing framed-TCP ABI (`ingest/framing.py`):
a 19-byte flow header with `msg_type = DFSTATS` (the reference's
self-telemetry lane) over one deflate/zstd-compressed JSON message —
so `FrameReassembler`, the codec negotiation, and the handoff
transport all apply unchanged. JSON keeps ints exact (the bit-exact
merge pin rides on that) and the compressor makes "compact" true in
practice: a frame is dominated by sparse hist pairs, not samples.
"""

from __future__ import annotations

import dataclasses
import json

from ..ingest.framing import (
    FlowHeader,
    MessageType,
    best_encoder,
    compress_body,
    decompress_body,
    encode_frame,
    split_messages,
)

#: the fleet lane's message type — DFSTATS is the reference's
#: self-telemetry msg_type, which is exactly what this frame carries
FLEET_MSG_TYPE = MessageType.DFSTATS

FRAME_VERSION = 1


@dataclasses.dataclass(frozen=True)
class FleetFrame:
    """One host's per-tick telemetry summary (decoded form)."""

    host: str
    group: str  # "" = host-wide (multi-group hosts tag per point)
    epoch: int
    seq: int
    timestamp: float
    #: ((timestamp, module, {tag: value}, {field: number}), ...)
    points: tuple = ()
    #: {face: {lane: [[bin, count], ...]}} — sparse log-hist dumps
    hists: dict = dataclasses.field(default_factory=dict)
    #: ({"name", "state", "value", "transitions"}, ...) per alert rule
    alerts: tuple = ()
    #: HBM ledger snapshot rows (profiling/ledger.py shape)
    hbm: tuple = ()
    #: census summary scalars (profiling/census.py get_counters shape)
    census: dict = dataclasses.field(default_factory=dict)


def encode_fleet_frame(frame: FleetFrame, *, agent_id: int = 0,
                       encoder: int | None = None) -> bytes:
    """FleetFrame → one wire frame (header + compressed JSON body)."""
    body = json.dumps(
        {
            "v": FRAME_VERSION,
            "host": frame.host,
            "group": frame.group,
            "epoch": int(frame.epoch),
            "seq": int(frame.seq),
            "t": frame.timestamp,
            "points": [
                [ts, module, tags, fields]
                for (ts, module, tags, fields) in frame.points
            ],
            "hists": frame.hists,
            "alerts": list(frame.alerts),
            "hbm": list(frame.hbm),
            "census": frame.census,
        },
        separators=(",", ":"),
    ).encode()
    enc = best_encoder() if encoder is None else encoder
    return encode_frame(
        FlowHeader(msg_type=int(FLEET_MSG_TYPE), agent_id=agent_id),
        [body], encoder=enc,
    )


def decode_fleet_frame(header: FlowHeader, body: bytes) -> FleetFrame:
    """(header, body) from a FrameReassembler → FleetFrame. Raises
    ValueError on a wrong message type or version — the aggregator
    counts these as decode errors, never silently skips."""
    if header.msg_type != int(FLEET_MSG_TYPE):
        raise ValueError(
            f"not a fleet frame: msg_type={header.msg_type}"
        )
    (msg,) = split_messages(decompress_body(body, header.encoder))
    obj = json.loads(msg)
    if obj.get("v") != FRAME_VERSION:
        raise ValueError(f"unknown fleet frame version {obj.get('v')!r}")
    return FleetFrame(
        host=str(obj["host"]),
        group=str(obj.get("group", "")),
        epoch=int(obj.get("epoch", 0)),
        seq=int(obj.get("seq", 0)),
        timestamp=float(obj.get("t", 0.0)),
        points=tuple(
            (p[0], p[1], p[2], p[3]) for p in obj.get("points", ())
        ),
        hists={
            str(face): {
                str(lane): [[int(b), int(c)] for b, c in pairs]
                for lane, pairs in lanes.items()
            }
            for face, lanes in obj.get("hists", {}).items()
        },
        alerts=tuple(obj.get("alerts", ())),
        hbm=tuple(obj.get("hbm", ())),
        census=dict(obj.get("census", {})),
    )


__all__ = [
    "FLEET_MSG_TYPE",
    "FRAME_VERSION",
    "FleetFrame",
    "encode_fleet_frame",
    "decode_fleet_frame",
    "compress_body",  # re-exported for bench/diagnostics symmetry
]
