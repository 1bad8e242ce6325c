"""L7 parsers, wave 2: TLS, Kafka, PostgreSQL, MongoDB, Dubbo.

Port copy of deepflow_tpu/agent/l7/parsers_ext.py.

Behavioral peers of the reference parsers (protocol_logs/{tls.rs,
mq/kafka.rs, sql/postgresql.rs, sql/mongo.rs, rpc/dubbo.rs}); all wire
layouts implemented from the public protocol specs. Each exposes the
same (check, parse) pair as parsers.py and registers into its registry.
"""

from __future__ import annotations

import struct

from ...datamodel.code import L7Protocol
from .parsers import (
    MSG_REQUEST,
    MSG_RESPONSE,
    STATUS_CLIENT_ERROR,
    STATUS_OK,
    STATUS_SERVER_ERROR,
    L7Message,
    obfuscate_sql,
)

# ---------------------------------------------------------------------------
# TLS (tls.rs) — record layer + ClientHello SNI / ServerHello version

_TLS_HANDSHAKE = 22
_CLIENT_HELLO = 1
_SERVER_HELLO = 2
_TLS_VERSIONS = {0x0301: "1.0", 0x0302: "1.1", 0x0303: "1.2", 0x0304: "1.3"}


def check_tls(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 6:
        return False
    typ, maj, mi = payload[0], payload[1], payload[2]
    return typ in (20, 21, 22, 23) and maj == 3 and mi <= 4 and (
        typ != _TLS_HANDSHAKE or payload[5] in (_CLIENT_HELLO, _SERVER_HELLO)
    )


def _hello_fields(body: bytes) -> tuple[int, str]:
    """(legacy_version, sni) from a ClientHello body; best effort."""
    try:
        ver = int.from_bytes(body[0:2], "big")
        off = 2 + 32  # version + random
        sid_len = body[off]
        off += 1 + sid_len
        cs_len = int.from_bytes(body[off : off + 2], "big")
        off += 2 + cs_len
        comp_len = body[off]
        off += 1 + comp_len
        if off + 2 > len(body):
            return ver, ""
        ext_len = int.from_bytes(body[off : off + 2], "big")
        off += 2
        end = min(off + ext_len, len(body))
        while off + 4 <= end:
            etype = int.from_bytes(body[off : off + 2], "big")
            elen = int.from_bytes(body[off + 2 : off + 4], "big")
            off += 4
            if etype == 0 and off + 5 <= len(body):  # server_name
                # list_len u16, type u8, name_len u16
                name_len = int.from_bytes(body[off + 3 : off + 5], "big")
                return ver, body[off + 5 : off + 5 + name_len].decode(errors="replace")
            off += elen
        return ver, ""
    except (IndexError, struct.error):
        return 0, ""


def parse_tls(payload: bytes) -> L7Message | None:
    try:
        if payload[0] != _TLS_HANDSHAKE:
            return None
        hs_type = payload[5]
        body = payload[9 : 9 + int.from_bytes(payload[6:9], "big")]
        if hs_type == _CLIENT_HELLO:
            ver, sni = _hello_fields(body)
            return L7Message(
                protocol=L7Protocol.TLS,
                msg_type=MSG_REQUEST,
                version=_TLS_VERSIONS.get(ver, ""),
                request_type="ClientHello",
                request_domain=sni,
                request_resource=sni,
                endpoint=sni,
            )
        if hs_type == _SERVER_HELLO:
            ver = int.from_bytes(body[0:2], "big") if len(body) >= 2 else 0
            return L7Message(
                protocol=L7Protocol.TLS,
                msg_type=MSG_RESPONSE,
                version=_TLS_VERSIONS.get(ver, ""),
                request_type="ServerHello",
            )
        return None
    except (IndexError, struct.error):
        return None


# ---------------------------------------------------------------------------
# Kafka (mq/kafka.rs) — [size u32][api_key u16][api_ver u16][corr u32]
#                       [client_id u16-prefixed]

# api_key -> (name, max request version): the version cap is the request/
# response discriminator — a "request" whose version exceeds its API's
# ceiling is a response whose correlation id happened to alias the field
# (kafka.rs keeps per-flow session state for the same purpose).
_KAFKA_APIS = {
    0: ("Produce", 11), 1: ("Fetch", 17), 2: ("ListOffsets", 9),
    3: ("Metadata", 13), 8: ("OffsetCommit", 9), 9: ("OffsetFetch", 9),
    10: ("FindCoordinator", 6), 11: ("JoinGroup", 9), 12: ("Heartbeat", 4),
    13: ("LeaveGroup", 5), 14: ("SyncGroup", 5), 15: ("DescribeGroups", 5),
    16: ("ListGroups", 5), 17: ("SaslHandshake", 1), 18: ("ApiVersions", 4),
    19: ("CreateTopics", 7), 20: ("DeleteTopics", 6),
    36: ("SaslAuthenticate", 2),
}
_KAFKA_MAX_API = 74


def check_kafka(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 12:
        return False
    size = int.from_bytes(payload[0:4], "big")
    api_key = int.from_bytes(payload[4:6], "big")
    api_ver = int.from_bytes(payload[6:8], "big")
    entry = _KAFKA_APIS.get(api_key)
    req_ok = size + 4 >= len(payload) and entry is not None and api_ver <= entry[1]
    return (port == 9092 and size > 0) or req_ok


def parse_kafka(payload: bytes, ctx: dict | None = None) -> L7Message | None:
    """`ctx` is the flow's parser state (kafka.rs keeps the same): a
    response frame is just [size][correlation_id][body], so matching it
    to an outstanding request's correlation id is the only reliable
    request/response discriminator."""
    try:
        if len(payload) < 8:
            return None
        # response-first: a correlation id matching an outstanding
        # request beats the loose api_key heuristic — but only for
        # packets NOT traveling in the request direction (low api
        # words alias low sequential corr ids otherwise)
        corr = int.from_bytes(payload[4:8], "big")
        if ctx is not None and corr in ctx.get("pending", {}):
            req_dir = ctx.get("req_dir")
            if req_dir is None or ctx.get("dir") != req_dir:
                ctx["pending"].pop(corr, None)
                return L7Message(
                    protocol=L7Protocol.KAFKA,
                    msg_type=MSG_RESPONSE,
                    request_id=corr,
                )
        api_key = int.from_bytes(payload[4:6], "big")
        api_ver = int.from_bytes(payload[6:8], "big")
        entry = _KAFKA_APIS.get(api_key)
        looks_req = entry is not None and api_ver <= entry[1] and len(payload) >= 12
        known_req_dir = None if ctx is None else ctx.get("req_dir")
        blocked = (
            looks_req
            and known_req_dir is not None
            and ctx.get("dir") is not None
            and ctx["dir"] != known_req_dir
        )
        if blocked:
            # a request-looking frame traveling in the RESPONSE
            # direction is usually a response whose corr words alias an
            # api header (retransmit/evicted/duplicate) — but repeated
            # contradictions mean req_dir itself was seeded wrong
            # (capture started mid-stream on an aliasing response), so
            # two strikes flip it and the frame registers as a request
            ctx["contra"] = ctx.get("contra", 0) + 1
            if ctx["contra"] >= 2:
                ctx["req_dir"] = ctx["dir"]
                ctx["contra"] = 0
                ctx.get("pending", {}).clear()
                blocked = False
        if looks_req and not blocked:
            corr = int.from_bytes(payload[8:12], "big")
            if ctx is not None:
                ctx["contra"] = 0
                if ctx.get("req_dir") is None:
                    ctx["req_dir"] = ctx.get("dir")
                pending = ctx.setdefault("pending", {})
                pending[corr] = None
                while len(pending) > 64:  # engine's _MAX_PENDING stance
                    pending.pop(next(iter(pending)))
            name = entry[0]
            return L7Message(
                protocol=L7Protocol.KAFKA,
                msg_type=MSG_REQUEST,
                version=str(api_ver),
                request_type=name,
                request_resource="",
                endpoint=name,
                request_id=corr,
            )
        # stateless fallback: [size][correlation_id], nothing request-like
        return L7Message(
            protocol=L7Protocol.KAFKA,
            msg_type=MSG_RESPONSE,
            request_id=corr,
        )
    except (IndexError, struct.error):
        return None


# ---------------------------------------------------------------------------
# PostgreSQL (sql/postgresql.rs) — typed messages ['Q' len sql...], etc.

_PG_REQ = {b"Q": "QUERY", b"P": "PARSE", b"B": "BIND", b"E": "EXECUTE", b"F": "FASTPATH"}
_PG_RESP_OK = (b"C", b"T", b"D", b"Z", b"1", b"2", b"n", b"s")
# CommandComplete tags (command word leads); used to disambiguate the
# 'C' byte from the frontend Close message (both use the tag)
_PG_COMPLETE_TAGS = (
    b"SELECT", b"INSERT", b"UPDATE", b"DELETE", b"BEGIN", b"COMMIT",
    b"ROLLBACK", b"FETCH", b"COPY", b"CREATE", b"DROP", b"ALTER", b"SET",
    b"MOVE", b"TRUNCATE",
)
# ErrorResponse field-type bytes (severity/code lead in practice)
_PG_ERR_FIELDS = b"SVC"


def _pg_is_error_response(payload: bytes) -> bool:
    """'E' is both frontend Execute and backend ErrorResponse; the error
    body is field-structured ([type u8][cstr]...) while Execute is
    [portal cstr][maxrows i32]."""
    body = payload[5:]
    return bool(body) and body[0:1] in (b"S", b"V") and b"\x00" in body


def _pg_wellformed(payload: bytes) -> bool:
    """Byte stream starts with a plausible [type][len u32 BE] message
    chain. Continuation segments of a large result set are raw row bytes
    whose accidental first byte may alias a type code, but their "length"
    is random — requiring the chain to land exactly on a boundary (or
    run past the segment only on its FINAL message) rejects them."""
    off = 0
    n = len(payload)
    msgs = 0
    while off < n:
        if off + 5 > n:
            return msgs > 0  # trailing partial header after valid msgs
        ln = int.from_bytes(payload[off + 1 : off + 5], "big")
        if ln < 4 or ln > 1 << 24:
            return False
        if off + 1 + ln > n:
            # a message larger than the captured segment is legitimate
            # (big DataRow spanning TCP segments) — but only as the
            # stream's FINAL message; random continuation "lengths"
            # rarely land in [4, 16M]
            return True
        off += 1 + ln
        msgs += 1
        if msgs >= 4:  # enough evidence
            return True
    return off == n


def check_postgresql(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 5:
        return False
    if payload[0:1] in _PG_REQ or payload[0:1] in (b"R", b"S", b"K", b"C", b"T", b"E"):
        ln = int.from_bytes(payload[1:5], "big")
        return 4 <= ln <= 1 << 24 and (port == 5432 or ln <= len(payload) + 16)
    # startup message: len u32, protocol 3.0 = 196608
    ln = int.from_bytes(payload[0:4], "big")
    proto = int.from_bytes(payload[4:8], "big") if len(payload) >= 8 else 0
    return proto in (196608, 80877103) and ln <= 1 << 16


def parse_postgresql(payload: bytes) -> L7Message | None:
    try:
        t = payload[0:1]
        if t == b"E" and not _pg_is_error_response(payload):
            return L7Message(
                protocol=L7Protocol.POSTGRESQL,
                msg_type=MSG_REQUEST,
                request_type="EXECUTE",
                endpoint="EXECUTE",
            )
        if t == b"C" and not payload[5:].split(b"\x00", 1)[0].startswith(
            _PG_COMPLETE_TAGS
        ):
            # frontend Close ('S'/'P' + name), not CommandComplete
            return L7Message(
                protocol=L7Protocol.POSTGRESQL,
                msg_type=MSG_REQUEST,
                request_type="CLOSE",
                endpoint="CLOSE",
            )
        if t == b"Q" or t == b"P":
            body = payload[5:]
            if t == b"P":  # Parse: statement name \0 query \0
                _, _, body = body.partition(b"\x00")
            sql = body.split(b"\x00", 1)[0].decode(errors="replace")
            stmt = obfuscate_sql(sql)
            verb = stmt.split(" ", 1)[0].upper() if stmt else _PG_REQ[t]
            return L7Message(
                protocol=L7Protocol.POSTGRESQL,
                msg_type=MSG_REQUEST,
                request_type=verb,
                request_resource=stmt,
                endpoint=verb,
            )
        if t == b"C":  # CommandComplete ("SELECT 1\0")
            tag = payload[5:].split(b"\x00", 1)[0].decode(errors="replace")
            return L7Message(
                protocol=L7Protocol.POSTGRESQL,
                msg_type=MSG_RESPONSE,
                request_resource=tag,
            )
        if t == b"E":  # ErrorResponse: fields [code u8][str \0]...
            severity, code = "", ""
            off = 5
            while off < len(payload) and payload[off] != 0:
                f = payload[off : off + 1]
                end = payload.index(b"\x00", off + 1)
                val = payload[off + 1 : end].decode(errors="replace")
                if f == b"S":
                    severity = val
                elif f == b"C":
                    code = val
                off = end + 1
            status = (
                STATUS_CLIENT_ERROR
                if code.startswith(("42", "22", "23"))  # syntax/data/integrity
                else STATUS_SERVER_ERROR
            )
            return L7Message(
                protocol=L7Protocol.POSTGRESQL,
                msg_type=MSG_RESPONSE,
                status=status,
                request_resource=f"{severity} {code}".strip(),
            )
        if t in _PG_RESP_OK and _pg_wellformed(payload):
            return L7Message(protocol=L7Protocol.POSTGRESQL, msg_type=MSG_RESPONSE)
        return None
    except (IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# MongoDB (sql/mongo.rs) — wire header [len i32 LE][req id][responseTo][op]

_OP_MSG = 2013
_OP_QUERY = 2004
_OP_REPLY = 1
_MONGO_OPS = {_OP_MSG, _OP_QUERY, _OP_REPLY, 2001, 2002, 2005, 2006, 2007, 2010, 2011, 2012}
_MONGO_CMDS = (
    "find", "insert", "update", "delete", "aggregate", "count", "distinct",
    "findAndModify", "getMore", "hello", "isMaster", "ping", "saslStart",
    "saslContinue", "listCollections", "listDatabases", "create", "drop",
)


def check_mongodb(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 16:
        return False
    ln = int.from_bytes(payload[0:4], "little")
    op = int.from_bytes(payload[12:16], "little")
    return op in _MONGO_OPS and 16 <= ln <= 48 << 20 and (port == 27017 or ln <= len(payload) + 64)


def _bson_first_key(doc: bytes) -> str:
    """First element name of a BSON document (the command verb)."""
    if len(doc) < 6:
        return ""
    # [len i32][etype u8][name \0]...
    end = doc.find(b"\x00", 5)
    if end < 0:
        return ""
    return doc[5:end].decode(errors="replace")


def parse_mongodb(payload: bytes) -> L7Message | None:
    try:
        if len(payload) < 16:
            return None
        req_id = int.from_bytes(payload[4:8], "little")
        response_to = int.from_bytes(payload[8:12], "little")
        op = int.from_bytes(payload[12:16], "little")
        is_resp = response_to != 0 or op == _OP_REPLY
        cmd = ""
        if op == _OP_MSG and len(payload) > 21:
            # [flags u32][section kind u8][BSON doc]
            cmd = _bson_first_key(payload[21:])
        elif op == _OP_QUERY:
            # [flags u32][fullCollectionName \0][skip][ret][BSON]
            end = payload.find(b"\x00", 20)
            if end > 0:
                cmd = payload[20:end].decode(errors="replace")
        if is_resp:
            return L7Message(
                protocol=L7Protocol.MONGODB,
                msg_type=MSG_RESPONSE,
                request_id=response_to or req_id,
            )
        known = cmd in _MONGO_CMDS or "." in cmd
        return L7Message(
            protocol=L7Protocol.MONGODB,
            msg_type=MSG_REQUEST,
            request_type=cmd if known or cmd else f"op_{op}",
            request_resource=cmd,
            endpoint=cmd,
            request_id=req_id,
        )
    except (IndexError, struct.error):
        return None


# ---------------------------------------------------------------------------
# Dubbo (rpc/dubbo.rs) — magic 0xdabb header + hessian2 body strings

_DUBBO_MAGIC = b"\xda\xbb"
_FLAG_REQUEST = 0x80
_FLAG_EVENT = 0x20


def check_dubbo(payload: bytes, port: int = 0) -> bool:
    return len(payload) >= 16 and payload[:2] == _DUBBO_MAGIC


def _hessian_attachment(body: bytes, key: str) -> str:
    """Value of a string-keyed attachment in a Dubbo request body: the
    attachments map encodes keys as hessian2 short strings (1-byte
    length), so the exact byte pattern [len][key] locates it; the value
    is read with the same short/medium string rules _hessian_strings
    handles. Used for the trace-context attachments (sw8/traceparent —
    dubbo.rs pulls the same keys)."""
    marker = bytes([len(key)]) + key.encode()
    i = body.find(marker)
    if i < 0:
        return ""
    off = i + len(marker)
    if off >= len(body):
        return ""
    ln = body[off]
    if 0x30 <= ln <= 0x33 and off + 1 < len(body):  # medium string
        ln = ((ln - 0x30) << 8) + body[off + 1]
        off += 2
    elif ln < 0x20:
        off += 1
    else:
        return ""
    if off + ln > len(body):
        return ""
    return body[off : off + ln].decode(errors="replace")


def _hessian_strings(body: bytes, limit: int = 4) -> list[str]:
    """Leading hessian2-encoded short strings ("2.0.2", service, version,
    method). Short strings are length-prefixed with 0x00-0x1f."""
    out = []
    off = 0
    while off < len(body) and len(out) < limit:
        ln = body[off]
        if 0x30 <= ln <= 0x33 and off + 1 < len(body):  # medium string
            ln = ((ln - 0x30) << 8) + body[off + 1]
            off += 2
        elif ln < 0x20:
            off += 1
        else:
            break
        if off + ln > len(body):
            break
        out.append(body[off : off + ln].decode(errors="replace"))
        off += ln
    return out


def parse_dubbo(payload: bytes) -> L7Message | None:
    try:
        if payload[:2] != _DUBBO_MAGIC or len(payload) < 16:
            return None
        flags = payload[2]
        status = payload[3]
        req_id = int.from_bytes(payload[4:12], "big")
        body = payload[16:]
        if flags & _FLAG_REQUEST:
            if flags & _FLAG_EVENT:
                return L7Message(
                    protocol=L7Protocol.DUBBO,
                    msg_type=MSG_REQUEST,
                    request_type="heartbeat",
                    request_id=req_id,
                )
            strs = _hessian_strings(body)
            # [dubbo version, service, service version, method]
            service = strs[1] if len(strs) > 1 else ""
            method = strs[3] if len(strs) > 3 else ""
            from .parsers import trace_from_headers

            trace = trace_from_headers(lambda n: _hessian_attachment(body, n))
            return L7Message(
                protocol=L7Protocol.DUBBO,
                msg_type=MSG_REQUEST,
                version=strs[0] if strs else "",
                request_type=method,
                request_domain=service,
                request_resource=f"{service}.{method}" if service else method,
                endpoint=service,
                request_id=req_id,
                trace_id=trace[0],
                span_id=trace[1],
            )
        # Dubbo status registry: 20 OK; client-side faults: 30
        # CLIENT_TIMEOUT, 40 BAD_REQUEST, 90 CLIENT_ERROR; server-side:
        # 31 SERVER_TIMEOUT, 50 BAD_RESPONSE, 60 SERVICE_NOT_FOUND,
        # 70 SERVICE_ERROR, 80 SERVER_ERROR
        st = (
            STATUS_OK
            if status == 20
            else STATUS_CLIENT_ERROR
            if status in (30, 40, 90)
            else STATUS_SERVER_ERROR
        )
        return L7Message(
            protocol=L7Protocol.DUBBO,
            msg_type=MSG_RESPONSE,
            status=st,
            status_code=status,
            request_id=req_id,
        )
    except (IndexError, struct.error):
        return None
