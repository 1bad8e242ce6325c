"""L7 engine: per-flow protocol inference, request/response pairing,
and dual emission (request logs + RED metrics).

Port copy of deepflow_tpu/agent/l7/engine.py.

Mirrors the reference composition: protocol_logs parsers emit
AppProtoLogs entries with per-flow RRT tracked by pairing requests to
responses (protocol_logs/perf/ rrt caches keyed by request_id/stream);
the same events feed the AppMeter path via L7QuadrupleGenerator. Here
`process()` consumes a parsed PacketBatch (+ its snap buffer for
payload slices), keeps per-flow inference and pending-request state,
and returns (L7_FLOW_LOG rows for the PROTOCOLLOG wire, AppMeter
FlowBatch for the L7 metrics pipeline).

Pairing: DNS/MySQL match on request_id (txid / seq window), HTTP/Redis
FIFO per flow (HTTP/1 has no ids; pipelining pairs in order). Pending
requests older than `session_timeout_s` emit as timeout sessions —
the reference's rrt-cache timeout semantics.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from ...datamodel.batch import FLOW_RECORD_TAG_FIELDS, FlowBatch
from ...datamodel.code import Direction, L7Protocol, SignalSource
from ...datamodel.schema import APP_METER
from ...flowlog.aggr import FlowLogBatch
from ...flowlog.schema import L7_FLOW_LOG
from ..packet import PROTO_ICMP, PROTO_TCP, PROTO_UDP, PacketBatch
from .parsers import (
    MSG_REQUEST,
    MSG_RESPONSE,
    STATUS_CLIENT_ERROR,
    STATUS_OK,
    STATUS_SERVER_ERROR,
    L7Message,
    infer_protocol,
    parse_payload,
)

STATUS_TIMEOUT = 5
_M = APP_METER.index

# l7 log type column (l7_flow_log.go type)
TYPE_REQUEST = 0
TYPE_RESPONSE = 1
TYPE_SESSION = 2


# the wire codec's endpoint hash — ONE hash per endpoint string across
# the packet path and the wire-decode path, or per-endpoint series split
from ...ingest.codec import _hash_str


@dataclasses.dataclass
class _Pending:
    msg: L7Message
    ts_us: int
    row: dict  # flow identity fields


@dataclasses.dataclass
class _FlowL7:
    protocol: int = L7Protocol.UNKNOWN
    tries: int = 0
    pending: deque = dataclasses.field(default_factory=deque)
    by_id: dict = dataclasses.field(default_factory=dict)
    last_seen_us: int = 0
    # per-direction parser state (HTTP/2 HPACK dynamic tables — each
    # side of the connection keeps its own, RFC 7541 §2.2)
    parser_ctx: dict = dataclasses.field(default_factory=dict)


_MAX_INFER_TRIES = 8  # reference: bounded per-flow inference attempts
_MAX_PENDING = 64


class L7Engine:
    def __init__(self, *, agent_id: int = 1, session_timeout_s: int = 30):
        self.agent_id = agent_id
        self.session_timeout_s = session_timeout_s
        self._flows: dict[tuple, _FlowL7] = {}
        self.counters = {
            "payloads_in": 0,
            "inferred": 0,
            "sessions": 0,
            "timeouts": 0,
            "parse_miss": 0,
        }

    # -- main entry -----------------------------------------------------
    def process(self, buf: np.ndarray, p: PacketBatch) -> tuple[FlowLogBatch, FlowBatch]:
        """One capture batch → (l7 log rows, AppMeter records)."""
        sessions: list[dict] = []
        buf = np.asarray(buf, np.uint8)
        idx = np.nonzero(
            p.valid
            & (p.payload_len > 0)
            & ((p.protocol == PROTO_TCP) | (p.protocol == PROTO_UDP) | (p.protocol == PROTO_ICMP))
        )[0]
        for i in idx:
            self._one_packet(buf, p, int(i), sessions)
        # session-timeout sweep on the batch's max clock
        if p.size:
            now_us = int(p.timestamp_s.max()) * 1_000_000
            self._sweep_timeouts(now_us, sessions)
        return self._emit(sessions)

    def _flow_key(self, p: PacketBatch, i: int) -> tuple[tuple, int]:
        """→ (canonical flow key, flow-relative direction of packet i):
        direction 0 = the packet's source is the key's low endpoint.
        Derived here because the src tuple is already in hand — callers
        must not rebuild it per protocol."""
        a = (tuple(int(w) for w in p.ip_src[i]), int(p.port_src[i]))
        b = (tuple(int(w) for w in p.ip_dst[i]), int(p.port_dst[i]))
        lo, hi = (a, b) if a <= b else (b, a)
        return (lo, hi, int(p.protocol[i])), 0 if a == lo else 1

    def _one_packet(self, buf, p: PacketBatch, i: int, sessions: list) -> None:
        self.counters["payloads_in"] += 1
        off = int(p.payload_off[i])
        end = min(off + int(p.payload_len[i]), buf.shape[1])
        payload = buf[i, off:end].tobytes()
        if not payload:
            return
        key, d = self._flow_key(p, i)
        fl = self._flows.get(key)
        if fl is None:
            fl = self._flows[key] = _FlowL7()
        fl.last_seen_us = int(p.timestamp_s[i]) * 1_000_000 + int(p.timestamp_us[i])

        sport, dport = int(p.port_src[i]), int(p.port_dst[i])
        if fl.protocol == L7Protocol.UNKNOWN:
            if fl.tries >= _MAX_INFER_TRIES:
                return
            fl.tries += 1
            if int(p.protocol[i]) == PROTO_ICMP:
                # ICMP never enters the TCP/UDP probe chain: echo frames
                # go straight to PING, everything else stays UNKNOWN
                from .parsers_w4 import check_ping

                if not check_ping(payload):
                    return
                proto = L7Protocol.PING
            else:
                proto = infer_protocol(payload, dport) or infer_protocol(payload, sport)
            if proto == L7Protocol.UNKNOWN:
                return
            fl.protocol = proto
            self.counters["inferred"] += 1

        ctx = None
        if fl.protocol in (L7Protocol.HTTP2, L7Protocol.GRPC):
            from .http2 import Hpack

            ctx = fl.parser_ctx.setdefault(d, Hpack())
        elif fl.protocol == L7Protocol.KAFKA:
            # correlation-id bookkeeping: responses are only
            # recognizable against outstanding requests (kafka.rs
            # keeps the same per-flow session state). The packet's
            # flow-relative direction rides along so a request whose
            # api words alias a pending corr can't be taken for a
            # response.
            ctx = fl.parser_ctx.setdefault("kafka", {})
            ctx["dir"] = d
        msg = parse_payload(fl.protocol, payload, ctx)
        if msg is None:
            self.counters["parse_miss"] += 1
            return
        # parser-level refinement: HTTP/2 flows carrying
        # content-type application/grpc become GRPC for the whole flow
        if msg.protocol not in (fl.protocol, L7Protocol.UNKNOWN):
            fl.protocol = msg.protocol
        ts_us = int(p.timestamp_s[i]) * 1_000_000 + int(p.timestamp_us[i])
        ident = {
            "is_ipv6": int(p.is_ipv6[i]),
            **{f"ip{0}_w{w}": int(p.ip_src[i, w]) for w in range(4)},
            **{f"ip{1}_w{w}": int(p.ip_dst[i, w]) for w in range(4)},
            "client_port": sport,
            "server_port": dport,
            "protocol": int(p.protocol[i]),
            "l7_protocol": fl.protocol,
        }
        if msg.msg_type == MSG_REQUEST:
            if len(fl.pending) >= _MAX_PENDING:
                evicted = fl.pending.popleft()
                if evicted.msg.request_id is not None:  # keep by_id in sync
                    fl.by_id.pop(evicted.msg.request_id, None)
            entry = _Pending(msg, ts_us, ident)
            fl.pending.append(entry)
            if msg.request_id is not None:
                fl.by_id[msg.request_id] = entry
        else:
            if 100 <= msg.status_code < 200:
                # informational (100 Continue): not a final response —
                # pairing on it would orphan the real one
                return
            entry = None
            if msg.request_id is not None and msg.request_id in fl.by_id:
                entry = fl.by_id.pop(msg.request_id)
                try:
                    fl.pending.remove(entry)
                except ValueError:
                    pass
            elif msg.request_id is None and fl.pending:
                entry = fl.pending.popleft()
                if entry.msg.request_id is not None:
                    fl.by_id.pop(entry.msg.request_id, None)
            self.counters["sessions"] += 1
            if entry is None:
                # orphan response: the packet flows server→client, so the
                # identity must be swapped to keep ip0/client_port = client
                swapped = {
                    **ident,
                    **{f"ip0_w{w}": ident[f"ip1_w{w}"] for w in range(4)},
                    **{f"ip1_w{w}": ident[f"ip0_w{w}"] for w in range(4)},
                    "client_port": ident["server_port"],
                    "server_port": ident["client_port"],
                }
                sessions.append(
                    {**swapped, "req": None, "resp": msg, "ts_us": ts_us, "rrt_us": 0}
                )
            else:
                sessions.append(
                    {
                        **entry.row,
                        "req": entry.msg,
                        "resp": msg,
                        "ts_us": ts_us,
                        "req_ts_us": entry.ts_us,
                        "rrt_us": max(0, ts_us - entry.ts_us),
                    }
                )

    def _sweep_timeouts(self, now_us: int, sessions: list) -> None:
        limit = self.session_timeout_s * 1_000_000
        for key, fl in list(self._flows.items()):
            while fl.pending and now_us - fl.pending[0].ts_us > limit:
                entry = fl.pending.popleft()
                if entry.msg.request_id is not None:
                    fl.by_id.pop(entry.msg.request_id, None)
                self.counters["timeouts"] += 1
                sessions.append(
                    {
                        **entry.row,
                        "req": entry.msg,
                        "resp": None,
                        "ts_us": entry.ts_us,
                        "req_ts_us": entry.ts_us,
                        "rrt_us": 0,
                    }
                )
            # evict idle flows (inferred or not) — per-flow L7 state must
            # not outlive the connection
            if not fl.pending and now_us - fl.last_seen_us > 2 * limit:
                del self._flows[key]

    # -- emission -------------------------------------------------------
    def _emit(self, sessions: list[dict]) -> tuple[FlowLogBatch, FlowBatch]:
        s = L7_FLOW_LOG
        n = len(sessions)
        ints = np.zeros((n, len(s.ints)), np.uint32)
        nums = np.zeros((n, len(s.nums)), np.float32)
        strs = {f.name: [""] * n for f in s.strs}
        tags = {f: np.zeros(n, np.uint32) for f in FLOW_RECORD_TAG_FIELDS}
        meters = np.zeros((n, APP_METER.num_fields), np.float32)
        ii = s.int_index

        for r, sess in enumerate(sessions):
            req: L7Message | None = sess["req"]
            resp: L7Message | None = sess["resp"]
            head = req or resp
            timeout = resp is None
            status = STATUS_TIMEOUT if timeout else resp.status
            sec = sess["ts_us"] // 1_000_000
            for f in ("is_ipv6", "client_port", "server_port", "protocol", "l7_protocol"):
                ints[r, ii(f)] = sess[f]
            for side in (0, 1):
                for w in range(4):
                    ints[r, ii(f"ip{side}_w{w}")] = sess[f"ip{side}_w{w}"]
            ints[r, ii("agent_id")] = self.agent_id
            ints[r, ii("type")] = (
                TYPE_SESSION if req and resp else TYPE_REQUEST if req else TYPE_RESPONSE
            )
            # ids/codes are pairing cookies, not quantities — mask into
            # the u32 columns (bRPC correlation ids are 64-bit varints,
            # Tars iRet is signed)
            ints[r, ii("request_id")] = ((head.request_id or 0) if head else 0) & 0xFFFFFFFF
            ints[r, ii("status")] = status
            ints[r, ii("status_code")] = (resp.status_code if resp else 0) & 0xFFFFFFFF
            ints[r, ii("start_time")] = sess.get("req_ts_us", sess["ts_us"]) // 1_000_000
            ints[r, ii("end_time")] = sec
            ints[r, ii("response_duration")] = sess["rrt_us"]
            ints[r, ii("tap_side")] = 1
            if req:
                strs["request_type"][r] = req.request_type
                strs["request_domain"][r] = req.request_domain
                strs["request_resource"][r] = req.request_resource
                strs["endpoint"][r] = req.endpoint
                # header-carried trace context (traceparent/B3/sw8):
                # packet spans join instrumented traces through the
                # same l7_flow_log columns the OTel lane fills
                strs["trace_id"][r] = req.trace_id
                strs["span_id"][r] = req.span_id
            if resp and resp.request_resource and resp.status in (
                STATUS_CLIENT_ERROR,
                STATUS_SERVER_ERROR,
            ):
                strs["response_exception"][r] = resp.request_resource

            # AppMeter record (fill_l7_stats inputs)
            tags["timestamp"][r] = sec
            tags["agent_id"][r] = self.agent_id
            tags["signal_source"][r] = int(SignalSource.PACKET)
            for w in range(4):
                tags[f"ip0_w{w}"][r] = sess[f"ip0_w{w}"]
                tags[f"ip1_w{w}"][r] = sess[f"ip1_w{w}"]
            tags["is_ipv6"][r] = sess["is_ipv6"]
            tags["protocol"][r] = sess["protocol"]
            tags["server_port"][r] = sess["server_port"]
            tags["l7_protocol"][r] = sess["l7_protocol"]
            tags["endpoint_hash"][r] = _hash_str(req.endpoint if req else "")
            tags["direction0"][r] = int(Direction.CLIENT_TO_SERVER)
            tags["direction1"][r] = int(Direction.SERVER_TO_CLIENT)
            tags["is_active_host0"][r] = 1
            tags["is_active_host1"][r] = 1
            tags["is_active_service"][r] = 1
            meters[r, _M("request")] = 1 if req else 0
            meters[r, _M("response")] = 1 if resp else 0
            if sess["rrt_us"]:
                meters[r, _M("rrt_max")] = sess["rrt_us"]
                meters[r, _M("rrt_sum")] = sess["rrt_us"]
                meters[r, _M("rrt_count")] = 1
            meters[r, _M("client_error")] = status == STATUS_CLIENT_ERROR
            meters[r, _M("server_error")] = status == STATUS_SERVER_ERROR
            meters[r, _M("timeout")] = status == STATUS_TIMEOUT

        log_batch = FlowLogBatch(s, ints, nums, np.ones(n, bool), strs)
        app_batch = FlowBatch(tags=tags, meters=meters, valid=np.ones(n, bool))
        return log_batch, app_batch
