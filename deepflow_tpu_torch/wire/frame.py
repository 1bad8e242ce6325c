"""DFPUSH frame — the wire delivery plane's cross-host push unit (port
copy of deepflow_tpu/wire/frame.py).

The fleet plane ships telemetry SUMMARIES host → aggregator on
DFSTATS; this lane ships *query results and alert notifications* the
same way — host-local subscription evaluations pushed upstream so ONE
eval per host per event batch can fan out to N wire clients on the
aggregator, instead of N clients each pulling every host.

One frame = one control or data message, compact JSON over the
existing framed-TCP ABI (`ingest/framing.py`, 19-byte flow header,
deflate/zstd body) with `msg_type = DFPUSH` (21 — this build's
extension of the reference registry, which ends at DATADOG=20). The
lane is DUPLEX over one dialed socket, unlike the one-way DFSTATS
lane: the router sends control frames down the same connection the
host pushes results up.

Frame kinds:

  * `hello`  — host → router on (re)connect: names the host; the
    router answers by (re)sending one `sub` per active distinct query,
    so reconnect resumes the subscription set with no host-side state.
  * `sub`    — router → host: subscribe this normalized query spec
    (`body` = spec dict); `query_id` is the router-assigned identity
    every later frame carries.
  * `unsub`  — router → host: the last wire watcher for the query is
    gone; drop the host-local subscription.
  * `result` — host → router: one subscription evaluation. `seq` is a
    per-(host, query) monotone counter — delivery is at-least-once
    across reconnects (the publisher retains the unacked frame,
    HandoffSender stance), so the router dedups on `(host, query_id,
    seq)`. `body` = {"now", "partial", "series"}.
  * `alert`  — host → router: one alert-engine notification dict; the
    router fans it to every `alerts=1` wire watcher.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

from ..ingest.framing import (
    FlowHeader,
    MessageType,
    best_encoder,
    decompress_body,
    encode_frame,
    split_messages,
)

#: the push lane's message type — see MessageType.DFPUSH in framing.py
PUSH_MSG_TYPE = MessageType.DFPUSH

PUSH_FRAME_VERSION = 1

PUSH_KINDS = ("hello", "sub", "unsub", "result", "alert")


@dataclasses.dataclass(frozen=True)
class PushFrame:
    """One DFPUSH message (decoded form)."""

    kind: str  # one of PUSH_KINDS
    host: str = ""  # sending host (hello/result/alert)
    query_id: str = ""  # router-assigned query identity (sub/unsub/result)
    seq: int = 0  # per-(host, query) result sequence (result)
    body: dict = dataclasses.field(default_factory=dict)


def normalize_query_spec(spec: dict) -> tuple:
    """Canonical dedup key for a wire query spec: whitespace-collapsed
    query text + the evaluation parameters that change the answer.
    "ONE upstream subscription per distinct query fleet-wide" rides on
    this — `rate(x[1m])` and ` rate(x[1m]) ` are the same question."""
    kind = str(spec.get("kind", "promql"))
    if kind not in ("promql", "sql"):
        raise ValueError(f"unknown wire query kind {kind!r}")
    query = " ".join(str(spec.get("query", "")).split())
    if not query:
        raise ValueError("wire query spec has no query text")
    return (
        kind,
        query,
        str(spec.get("db", "deepflow_system")),
        str(spec.get("table", "deepflow_system")),
        int(spec.get("span_s", 60)),
        int(spec.get("step", 1)),
        int(spec.get("lookback_s", 300)),
    )


def query_id_for(key: tuple) -> str:
    """Stable short id for a normalized spec key — the wire name every
    sub/result frame carries (content-derived, so two routers agree)."""
    digest = hashlib.sha1(json.dumps(list(key)).encode()).hexdigest()
    return "q" + digest[:12]


def spec_from_key(key: tuple) -> dict:
    """Inverse of normalize_query_spec — the dict shipped in `sub`."""
    kind, query, db, table, span_s, step, lookback_s = key
    return {
        "kind": kind, "query": query, "db": db, "table": table,
        "span_s": span_s, "step": step, "lookback_s": lookback_s,
    }


def encode_push_frame(frame: PushFrame, *, agent_id: int = 0,
                      encoder: int | None = None) -> bytes:
    """PushFrame → one wire frame (header + compressed JSON body)."""
    if frame.kind not in PUSH_KINDS:
        raise ValueError(f"unknown push frame kind {frame.kind!r}")
    body = json.dumps(
        {
            "v": PUSH_FRAME_VERSION,
            "kind": frame.kind,
            "host": frame.host,
            "qid": frame.query_id,
            "seq": int(frame.seq),
            "body": frame.body,
        },
        separators=(",", ":"),
    ).encode()
    enc = best_encoder() if encoder is None else encoder
    return encode_frame(
        FlowHeader(msg_type=int(PUSH_MSG_TYPE), agent_id=agent_id),
        [body], encoder=enc,
    )


def decode_push_frame(header: FlowHeader, body: bytes) -> PushFrame:
    """(header, body) from a FrameReassembler → PushFrame. Raises
    ValueError on a wrong message type or version — both ends count
    these as decode errors, never silently skip."""
    if header.msg_type != int(PUSH_MSG_TYPE):
        raise ValueError(f"not a push frame: msg_type={header.msg_type}")
    (msg,) = split_messages(decompress_body(body, header.encoder))
    obj = json.loads(msg)
    if obj.get("v") != PUSH_FRAME_VERSION:
        raise ValueError(f"unknown push frame version {obj.get('v')!r}")
    kind = str(obj.get("kind", ""))
    if kind not in PUSH_KINDS:
        raise ValueError(f"unknown push frame kind {kind!r}")
    return PushFrame(
        kind=kind,
        host=str(obj.get("host", "")),
        query_id=str(obj.get("qid", "")),
        seq=int(obj.get("seq", 0)),
        body=dict(obj.get("body", {})),
    )


__all__ = [
    "PUSH_MSG_TYPE",
    "PUSH_FRAME_VERSION",
    "PUSH_KINDS",
    "PushFrame",
    "normalize_query_spec",
    "query_id_for",
    "spec_from_key",
    "encode_push_frame",
    "decode_push_frame",
]
