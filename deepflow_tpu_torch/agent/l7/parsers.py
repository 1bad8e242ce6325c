"""L7 protocol parsers: HTTP/1.x, DNS, Redis (RESP), MySQL.

Port copy of deepflow_tpu/agent/l7/parsers.py.

The reference implements 20+ parsers behind `L7ProtocolParserInterface`
(protocol_logs/mod.rs): each exposes a cheap `check_payload` probe used
for per-flow protocol inference, and a full parse producing request/
response records with RED fields. Same structure here, host-side —
byte-string protocol parsing is irreducibly sequential per message, so
it stays on CPU feeding the device pipelines (exactly where the
reference runs it). SQL text is obfuscated before leaving the parser
(sql_obfuscate.rs stance: literals never reach storage).

Parsers cited: http.rs, dns.rs, redis.rs, mysql.rs under
agent/src/flow_generator/protocol_logs/ of the reference.
"""

from __future__ import annotations

import dataclasses
import re

from ...datamodel.code import L7Protocol

MSG_REQUEST = 0
MSG_RESPONSE = 1

# L7ResponseStatus (protocol_logs/pb_adapter.rs semantics, condensed)
STATUS_OK = 1
STATUS_CLIENT_ERROR = 3
STATUS_SERVER_ERROR = 4


@dataclasses.dataclass
class L7Message:
    protocol: int
    msg_type: int  # MSG_REQUEST / MSG_RESPONSE
    version: str = ""
    request_type: str = ""  # method / command / qtype
    request_domain: str = ""  # host / db / query name
    request_resource: str = ""  # path / statement / key
    endpoint: str = ""  # normalized resource
    # pairing id (DNS txid…). None = protocol has no ids (FIFO pairing);
    # 0 is a VALID id — DNS txids may legitimately be zero
    request_id: int | None = None
    status: int = STATUS_OK
    status_code: int = 0
    # distributed-tracing context carried in protocol headers
    # (traceparent / B3 / sw8 — http.rs ON_HEADER trace extraction);
    # lets packet-observed spans join instrumented traces
    trace_id: str = ""
    span_id: str = ""


# ---------------------------------------------------------------------------
# HTTP/1.x (http.rs)

_HTTP_METHODS = (
    b"GET ", b"POST ", b"PUT ", b"DELETE ", b"HEAD ", b"OPTIONS ",
    b"PATCH ", b"TRACE ", b"CONNECT ",
)
_N_PATH_SEGMENTS = 2  # endpoint = first two path segments (http.rs endpoint trim)


def check_http(payload: bytes) -> bool:
    return payload.startswith(_HTTP_METHODS) or payload.startswith(b"HTTP/1.")


def trace_context_from_header(name: str, value: str) -> tuple[str, str]:
    """One trace header → (trace_id, span_id); empty strings when the
    header carries no usable context. Supported generations mirror
    http.rs: W3C `traceparent`, Zipkin B3 (`x-b3-traceid` /
    `x-b3-spanid`), SkyWalking `sw8` (base64 segments)."""
    name = name.lower()
    if name == "traceparent":
        parts = value.split("-")
        if (
            len(parts) >= 3
            and len(parts[1]) == 32
            and len(parts[2]) == 16
            # W3C-invalid all-zero trace and parent ids
            and set(parts[1]) != {"0"}
            and set(parts[2]) != {"0"}
            and all(c in "0123456789abcdef" for c in parts[1] + parts[2])
        ):
            return parts[1], parts[2]
    elif name == "x-b3-traceid":
        v = value.strip().lower()
        if len(v) in (16, 32) and all(c in "0123456789abcdef" for c in v):
            return v, ""
    elif name == "x-b3-spanid":
        v = value.strip().lower()
        if len(v) == 16 and all(c in "0123456789abcdef" for c in v):
            return "", v
    elif name == "sw8":
        # 1-<b64(trace id)>-<b64(segment id)>-<span idx>-…
        import base64

        parts = value.split("-")
        if len(parts) >= 4:
            try:
                tid = base64.b64decode(parts[1] + "=" * (-len(parts[1]) % 4)).decode()
                seg = base64.b64decode(parts[2] + "=" * (-len(parts[2]) % 4)).decode()
                return tid, f"{seg}-{parts[3]}"
            except Exception:
                return "", ""
    return "", ""


def _merge_trace(trace: tuple[str, str], new: tuple[str, str]) -> tuple[str, str]:
    return (trace[0] or new[0], trace[1] or new[1])


TRACE_HEADERS = ("traceparent", "x-b3-traceid", "x-b3-spanid", "sw8")
_TRACE_HEADERS_B = tuple(h.encode() for h in TRACE_HEADERS)


def trace_from_headers(get) -> tuple[str, str]:
    """(trace_id, span_id) from a header lookup callable `get(name) ->
    value | None` — the one shared walk over every supported trace
    generation (HTTP/1 lines, HTTP/2 hpack maps, and Dubbo attachments
    all feed this)."""
    trace = ("", "")
    for name in TRACE_HEADERS:
        v = get(name)
        if v:
            trace = _merge_trace(trace, trace_context_from_header(name, v))
    return trace


def parse_http(payload: bytes) -> L7Message | None:
    try:
        head, _, _ = payload.partition(b"\r\n\r\n")
        lines = head.split(b"\r\n")
        first = lines[0]
        if first.startswith(b"HTTP/1."):
            parts = first.split(b" ", 2)
            code = int(parts[1]) if len(parts) > 1 and parts[1].isdigit() else 0
            status = (
                STATUS_CLIENT_ERROR
                if 400 <= code < 500
                else STATUS_SERVER_ERROR if code >= 500 else STATUS_OK
            )
            return L7Message(
                protocol=L7Protocol.HTTP1,
                msg_type=MSG_RESPONSE,
                version=first[5:8].decode(errors="replace"),
                status=status,
                status_code=code,
            )
        for m in _HTTP_METHODS:
            if first.startswith(m):
                method = m.strip().decode()
                parts = first.split(b" ", 2)
                uri = parts[1].decode(errors="replace") if len(parts) > 1 else ""
                version = (
                    parts[2][5:8].decode(errors="replace") if len(parts) > 2 else ""
                )
                host = ""
                hdrs: dict[bytes, bytes] = {}
                for ln in lines[1:]:
                    k, _, v = ln.partition(b":")
                    key = k.strip().lower()
                    if key == b"host":
                        host = v.strip().decode(errors="replace")
                    elif key in _TRACE_HEADERS_B:
                        hdrs.setdefault(key, v.strip())
                trace = trace_from_headers(
                    lambda n: (hdrs.get(n.encode()) or b"").decode(errors="replace")
                )
                path = uri.split("?", 1)[0]
                endpoint = endpoint_from_path(path, _N_PATH_SEGMENTS)
                return L7Message(
                    protocol=L7Protocol.HTTP1,
                    msg_type=MSG_REQUEST,
                    version=version,
                    request_type=method,
                    request_domain=host,
                    request_resource=path,
                    endpoint=endpoint,
                    trace_id=trace[0],
                    span_id=trace[1],
                )
        return None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# DNS (dns.rs) — UDP payload

_QTYPES = {1: "A", 2: "NS", 5: "CNAME", 6: "SOA", 12: "PTR", 15: "MX", 16: "TXT", 28: "AAAA", 33: "SRV"}


def _dns_check_raw(payload: bytes, port: int) -> bool:
    if len(payload) < 12:
        return False
    qd = int.from_bytes(payload[4:6], "big")
    opcode_ok = (payload[2] >> 3) & 0xF in (0, 1, 2)
    return (port == 53 or 1 <= qd <= 4) and opcode_ok and qd >= 1


def _dns_tcp_strip(payload: bytes, port: int = 0) -> bytes:
    """DNS over TCP prefixes the message with a u16 length (RFC 1035
    §4.2.2; dns.rs handles both transports). Only strip when the raw
    bytes do NOT already form a plausible DNS message — a UDP query
    whose txid happens to equal len-2 must not lose its first bytes."""
    if _dns_check_raw(payload, port):
        return payload
    if len(payload) >= 14 and int.from_bytes(payload[:2], "big") == len(payload) - 2:
        return payload[2:]
    return payload


def check_dns(payload: bytes, port: int = 0) -> bool:
    return _dns_check_raw(_dns_tcp_strip(payload, port), port)


def parse_dns(payload: bytes) -> L7Message | None:
    try:
        payload = _dns_tcp_strip(payload)
        if len(payload) < 12:
            return None
        txid = int.from_bytes(payload[0:2], "big")
        flags = int.from_bytes(payload[2:4], "big")
        is_resp = bool(flags & 0x8000)
        rcode = flags & 0xF
        # parse the first question name
        labels = []
        off = 12
        while off < len(payload):
            ln = payload[off]
            if ln == 0:
                off += 1
                break
            if ln >= 0xC0 or off + 1 + ln > len(payload):  # compression in QD is invalid
                return None
            labels.append(payload[off + 1 : off + 1 + ln].decode(errors="replace"))
            off += 1 + ln
        qtype = int.from_bytes(payload[off : off + 2], "big") if off + 2 <= len(payload) else 0
        name = ".".join(labels)
        if is_resp:
            status = (
                STATUS_OK
                if rcode == 0
                else STATUS_CLIENT_ERROR if rcode == 3 else STATUS_SERVER_ERROR
            )
            return L7Message(
                protocol=L7Protocol.DNS,
                msg_type=MSG_RESPONSE,
                request_id=txid,
                request_domain=name,
                status=status,
                status_code=rcode,
            )
        return L7Message(
            protocol=L7Protocol.DNS,
            msg_type=MSG_REQUEST,
            request_id=txid,
            request_type=_QTYPES.get(qtype, str(qtype)),
            request_domain=name,
            request_resource=name,
            endpoint=name,
        )
    except Exception:
        return None


# ---------------------------------------------------------------------------
# Redis RESP (redis.rs)


def check_redis(payload: bytes) -> bool:
    return len(payload) >= 4 and payload[:1] in (b"*", b"+", b"-", b"$", b":") and b"\r\n" in payload[:64]


def parse_redis(payload: bytes) -> L7Message | None:
    try:
        first = payload[:1]
        if first == b"*":  # request: array of bulk strings
            lines = payload.split(b"\r\n")
            # lines: *N, $len, CMD, $len, arg...
            if len(lines) < 3 or not lines[1].startswith(b"$"):
                return None
            cmd = lines[2].decode(errors="replace").upper()
            args = [
                lines[i].decode(errors="replace")
                for i in range(4, min(len(lines), 8), 2)
                if i < len(lines) and not lines[i].startswith((b"$", b"*"))
            ]
            return L7Message(
                protocol=L7Protocol.REDIS,
                msg_type=MSG_REQUEST,
                request_type=cmd,
                request_resource=" ".join([cmd] + args[:1]),
                endpoint=cmd,
            )
        if first == b"-":  # error reply
            return L7Message(
                protocol=L7Protocol.REDIS,
                msg_type=MSG_RESPONSE,
                status=STATUS_SERVER_ERROR,
                request_resource=payload[1:].split(b"\r\n")[0].decode(errors="replace"),
            )
        if first in (b"+", b"$", b":"):
            return L7Message(protocol=L7Protocol.REDIS, msg_type=MSG_RESPONSE)
        return None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# MySQL (mysql.rs) — classic protocol, header [len u24 LE][seq u8]

_COM_QUERY = 0x03
_COM_STMT_PREPARE = 0x16
_COM_STMT_EXECUTE = 0x17
_COM_NAMES = {0x01: "COM_QUIT", 0x03: "COM_QUERY", 0x0E: "COM_PING", 0x16: "COM_STMT_PREPARE", 0x17: "COM_STMT_EXECUTE"}

_SQL_STR = re.compile(r"'(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"")
_SQL_NUM = re.compile(r"\b\d+(?:\.\d+)?\b")


def obfuscate_sql(stmt: str) -> str:
    """Literal stripping (sql/sql_obfuscate.rs): values never stored."""
    stmt = _SQL_STR.sub("?", stmt)
    return _SQL_NUM.sub("?", stmt)


def _mysql_greeting(payload: bytes) -> bool:
    """Server handshake v10: [len u24][seq=0][0x0a]["x.y.z\\0"…] — the
    signature mysql.rs uses to classify off-port flows (the server
    greets first, so this is the first payload the probe sees)."""
    if len(payload) < 7 or payload[3] != 0 or payload[4] != 0x0A:
        return False
    nul = payload.find(b"\x00", 5, 5 + 24)
    if nul < 0:
        return False
    ver = payload[5:nul]
    return bool(ver) and all(0x20 < b < 0x7F for b in ver) and ver[0:1].isdigit()


def check_mysql(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 5:
        return False
    ln = int.from_bytes(payload[0:3], "little")
    if not 0 < ln <= len(payload) - 4:
        return False
    return port == 3306 or _mysql_greeting(payload)


def parse_mysql(payload: bytes) -> L7Message | None:
    try:
        if len(payload) < 5:
            return None
        seq = payload[3]
        cmd = payload[4]
        if seq == 0 and cmd in _COM_NAMES:  # request
            stmt = ""
            if cmd in (_COM_QUERY, _COM_STMT_PREPARE):
                stmt = obfuscate_sql(payload[5:].decode(errors="replace"))
            verb = stmt.split(" ", 1)[0].upper() if stmt else _COM_NAMES[cmd]
            return L7Message(
                protocol=L7Protocol.MYSQL,
                msg_type=MSG_REQUEST,
                request_type=verb,
                request_resource=stmt,
                endpoint=verb,
            )
        if cmd == 0x00 and seq > 0:  # OK packet
            return L7Message(protocol=L7Protocol.MYSQL, msg_type=MSG_RESPONSE)
        if cmd == 0xFF and seq > 0:  # ERR packet
            code = int.from_bytes(payload[5:7], "little") if len(payload) >= 7 else 0
            status = STATUS_CLIENT_ERROR if 1000 <= code < 2000 else STATUS_SERVER_ERROR
            return L7Message(
                protocol=L7Protocol.MYSQL,
                msg_type=MSG_RESPONSE,
                status=status,
                status_code=code,
            )
        ln = int.from_bytes(payload[0:3], "little")
        if seq == 1 and 0x01 <= cmd <= 0xFA and ln <= 9:
            # resultset reply: the FIRST response packet (seq=1) is a tiny
            # lenenc column count — SELECTs answer with these, not OK
            # packets (mysql.rs resultset handling). seq==1 + length≤9
            # excludes multi-packet request continuations and row packets
            return L7Message(protocol=L7Protocol.MYSQL, msg_type=MSG_RESPONSE)
        return None
    except Exception:
        return None


# ---------------------------------------------------------------------------
# registry + inference (the check_payload trial loop, protocol_logs/mod.rs)

_PARSERS: list[tuple[int, object, object]] = [
    (L7Protocol.HTTP1, check_http, parse_http),
    (L7Protocol.DNS, check_dns, parse_dns),
    (L7Protocol.REDIS, check_redis, parse_redis),
    (L7Protocol.MYSQL, check_mysql, parse_mysql),
]

_PORT_HINTS = {
    53: L7Protocol.DNS,
    3306: L7Protocol.MYSQL,
    6379: L7Protocol.REDIS,
    443: L7Protocol.TLS,
    5432: L7Protocol.POSTGRESQL,
    9092: L7Protocol.KAFKA,
    27017: L7Protocol.MONGODB,
    20880: L7Protocol.DUBBO,
    1883: L7Protocol.MQTT,
    11211: L7Protocol.MEMCACHED,
    4222: L7Protocol.NATS,
    5672: L7Protocol.AMQP,
    6650: L7Protocol.PULSAR,
    61616: L7Protocol.OPENWIRE,
    1521: L7Protocol.ORACLE,
    12200: L7Protocol.SOFARPC,
    30490: L7Protocol.SOME_IP,
    30509: L7Protocol.SOME_IP,
}


def register_parser(protocol: int, check, parse) -> None:
    """Extension seat (the reference's L7ProtocolParserInterface registry,
    protocol_logs/mod.rs impl_protocol_parser!)."""
    for i, (p, _c, _p) in enumerate(_PARSERS):
        if p == protocol:
            _PARSERS[i] = (protocol, check, parse)
            return
    _PARSERS.append((protocol, check, parse))


def infer_protocol(payload: bytes, server_port: int = 0) -> int:
    """Try each parser's cheap probe; port hints break ties first."""
    hint = _PORT_HINTS.get(server_port)
    ordered = sorted(_PARSERS, key=lambda p: 0 if p[0] == hint else 1)
    for proto, check, _ in ordered:
        try:
            if check.__code__.co_argcount > 1:  # port-aware probes
                if check(payload, server_port):
                    return proto
            elif check(payload):
                return proto
        except Exception:
            continue
    return L7Protocol.UNKNOWN


def endpoint_from_path(path: str, n_segments: int = 2) -> str:
    """Endpoint = first n path segments, query stripped (the http.rs
    endpoint trim; shared by HTTP/1 and HTTP/2)."""
    bare = path.split("?", 1)[0]
    segs = [s for s in bare.split("/") if s]
    return "/" + "/".join(segs[:n_segments])


def parse_payload(protocol: int, payload: bytes, ctx=None) -> L7Message | None:
    """Dispatch to the protocol's parser. `ctx` is per-flow parser state
    (today: the HTTP/2 connection's Hpack dynamic table) handed to
    parsers that declare a second positional argument."""
    for proto, _, parse in _PARSERS:
        if proto == protocol:
            if ctx is not None and parse.__code__.co_argcount > 1:
                return parse(payload, ctx)
            return parse(payload)
    return None


def _register_wave2() -> None:
    """Wave-2 parsers live in sibling modules; importing here keeps the
    single registry while avoiding a cyclic import at module top."""
    from . import parsers_ext as ext
    from .http2 import check_http2, parse_http2

    register_parser(L7Protocol.HTTP2, check_http2, parse_http2)
    register_parser(L7Protocol.TLS, ext.check_tls, ext.parse_tls)
    register_parser(L7Protocol.POSTGRESQL, ext.check_postgresql, ext.parse_postgresql)
    register_parser(L7Protocol.MONGODB, ext.check_mongodb, ext.parse_mongodb)
    register_parser(L7Protocol.DUBBO, ext.check_dubbo, ext.parse_dubbo)
    from . import parsers_mq as mq
    from . import parsers_rpc as rpc

    register_parser(L7Protocol.FASTCGI, rpc.check_fastcgi, rpc.parse_fastcgi)
    register_parser(L7Protocol.ROCKETMQ, rpc.check_rocketmq, rpc.parse_rocketmq)
    register_parser(L7Protocol.MQTT, mq.check_mqtt, mq.parse_mqtt)
    register_parser(L7Protocol.MEMCACHED, mq.check_memcached, mq.parse_memcached)
    register_parser(L7Protocol.NATS, mq.check_nats, mq.parse_nats)
    register_parser(L7Protocol.AMQP, mq.check_amqp, mq.parse_amqp)
    # kafka last: its request heuristic is the loosest (mq/kafka.rs also
    # orders bespoke-magic protocols before it)
    register_parser(L7Protocol.KAFKA, ext.check_kafka, ext.parse_kafka)


def _register_wave4() -> None:
    """Wave 4: the remaining reference parsers (rpc/mq/sql/ping.rs).
    All have strict magics, so they slot in ahead of kafka's loose
    heuristic; ping goes last (its only guard is the ICMP checksum)."""
    from . import parsers_w4 as w4

    kafka = next(p for p in _PARSERS if p[0] == L7Protocol.KAFKA)
    _PARSERS.remove(kafka)
    register_parser(L7Protocol.SOFARPC, w4.check_sofarpc, w4.parse_sofarpc)
    register_parser(L7Protocol.BRPC, w4.check_brpc, w4.parse_brpc)
    register_parser(L7Protocol.TARS, w4.check_tars, w4.parse_tars)
    register_parser(L7Protocol.SOME_IP, w4.check_someip, w4.parse_someip)
    register_parser(L7Protocol.PULSAR, w4.check_pulsar, w4.parse_pulsar)
    register_parser(L7Protocol.OPENWIRE, w4.check_openwire, w4.parse_openwire)
    register_parser(L7Protocol.ZMTP, w4.check_zmtp, w4.parse_zmtp)
    register_parser(L7Protocol.ORACLE, w4.check_oracle, w4.parse_oracle)
    _PARSERS.append(kafka)
    # PING parses only ICMP flows; the engine dispatches those directly
    # (engine._one_packet), so its probe never fires on TCP/UDP payloads
    register_parser(L7Protocol.PING, lambda p, port=0: False, w4.parse_ping)


_register_wave2()
_register_wave4()

# GRPC rides the HTTP2 parser (content-type dispatch); parse_payload on
# GRPC must resolve too
from .http2 import parse_http2 as _p2  # noqa: E402

register_parser(L7Protocol.GRPC, lambda p, port=0: False, _p2)
