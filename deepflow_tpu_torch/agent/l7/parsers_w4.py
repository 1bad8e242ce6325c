"""L7 parsers, wave 4: SofaRPC (Bolt), bRPC, Tars, SOME/IP, Pulsar,
OpenWire, ZMTP, Oracle TNS, ICMP Ping.

Port copy of deepflow_tpu/agent/l7/parsers_w4.py.

Behavioral peers of protocol_logs/rpc/{sofa_rpc.rs, brpc.rs, tars.rs,
some_ip.rs}, mq/{pulsar.rs, openwire.rs, zmtp.rs}, sql/oracle.rs and
ping.rs; wire layouts from the public protocol specs (Bolt, brpc RPC
spec, Tars JCE, AUTOSAR SOME/IP, Pulsar BaseCommand, ActiveMQ OpenWire,
ZMTP/3.x, Oracle TNS, RFC 792).
"""

from __future__ import annotations

from ...datamodel.code import L7Protocol
from .parsers import (
    MSG_REQUEST,
    MSG_RESPONSE,
    STATUS_CLIENT_ERROR,
    STATUS_OK,
    STATUS_SERVER_ERROR,
    L7Message,
)

# ---------------------------------------------------------------------------
# SofaRPC / Bolt v1+v2 (rpc/sofa_rpc.rs) — header:
#   proto(1) [v2: ver1(1)] type(1) cmdcode(2) ver2(1) reqid(4) codec(1)
#   [v2: switch(1)] (req: timeout(4) | resp: status(2))
#   classlen(2) headerlen(2) contentlen(4) classname[classlen] header...

_BOLT_TYPE_RESP = 0
_BOLT_TYPE_REQ = 1
_BOLT_TYPE_ONEWAY = 2
_BOLT_CMD_HEARTBEAT = 0
_BOLT_CMD_REQ = 1
_BOLT_CMD_RESP = 2


def _bolt_header(payload: bytes):
    if len(payload) < 20:
        return None
    proto = payload[0]
    if proto == 1:
        off = 1
    elif proto == 2:
        off = 2  # ver1 byte
    else:
        return None
    typ = payload[off]
    cmd = int.from_bytes(payload[off + 1 : off + 3], "big")
    if typ not in (_BOLT_TYPE_RESP, _BOLT_TYPE_REQ, _BOLT_TYPE_ONEWAY):
        return None
    if cmd not in (_BOLT_CMD_HEARTBEAT, _BOLT_CMD_REQ, _BOLT_CMD_RESP):
        return None
    req_id = int.from_bytes(payload[off + 4 : off + 8], "big")
    p = off + 9  # past ver2, reqid, codec
    if proto == 2:
        p += 1  # switch byte
    # exact per-variant minimum: truncated tail slices would silently
    # decode as 0 through int.from_bytes, misparsing len fields
    body_off = p + (2 if typ == _BOLT_TYPE_RESP else 4) + 8
    if len(payload) < body_off:
        return None
    resp_status = 0
    if typ == _BOLT_TYPE_RESP:
        resp_status = int.from_bytes(payload[p : p + 2], "big")
        p += 2
    else:
        p += 4  # timeout
    class_len = int.from_bytes(payload[p : p + 2], "big")
    hdr_len = int.from_bytes(payload[p + 2 : p + 4], "big")
    content_len = int.from_bytes(payload[p + 4 : p + 8], "big")
    body = p + 8
    if class_len > 4096 or hdr_len > 65535 or content_len > (1 << 26):
        return None
    return typ, cmd, req_id, resp_status, class_len, hdr_len, body


def check_sofarpc(payload: bytes, port: int = 0) -> bool:
    h = _bolt_header(payload)
    if h is None:
        return False
    typ, cmd, _rid, _st, class_len, hdr_len, body = h
    # codec byte is always set on real Bolt frames (1=hessian, 11/12 =
    # protobuf/json); 0 rejects the all-zero lookalikes
    codec_off = (1 if payload[0] == 1 else 2) + 8
    if payload[codec_off] == 0:
        return False
    if cmd == _BOLT_CMD_HEARTBEAT:
        # heartbeats carry no class/header/content at all
        return class_len == 0 and hdr_len == 0 and len(payload) <= body
    # requests carry a java class name; cheap sanity on its bytes
    name = payload[body : body + class_len]
    return class_len == 0 or all(0x20 < b < 0x7F for b in name)


def _bolt_kv_headers(buf: bytes) -> dict:
    """Bolt string headers: repeated [len(4) key][len(4) value]."""
    out, p = {}, 0
    while p + 8 <= len(buf):
        klen = int.from_bytes(buf[p : p + 4], "big")
        if p + 4 + klen + 4 > len(buf):
            break
        key = buf[p + 4 : p + 4 + klen].decode(errors="replace")
        p += 4 + klen
        vlen = int.from_bytes(buf[p : p + 4], "big")
        if p + 4 + vlen > len(buf):
            break
        val = buf[p + 4 : p + 4 + vlen].decode(errors="replace")
        p += 4 + vlen
        out[key] = val
    return out


def parse_sofarpc(payload: bytes) -> L7Message | None:
    h = _bolt_header(payload)
    if h is None:
        return None
    typ, cmd, req_id, resp_status, class_len, hdr_len, body = h
    if typ in (_BOLT_TYPE_REQ, _BOLT_TYPE_ONEWAY):
        hdrs = _bolt_kv_headers(payload[body + class_len : body + class_len + hdr_len])
        service = hdrs.get("sofa_head_target_service") or hdrs.get(
            "service", ""
        )
        method = hdrs.get("sofa_head_method_name", "")
        return L7Message(
            protocol=L7Protocol.SOFARPC,
            msg_type=MSG_REQUEST,
            request_type="heartbeat" if cmd == _BOLT_CMD_HEARTBEAT else "call",
            request_resource=service,
            endpoint=f"{service}/{method}" if method else service,
            request_id=req_id,
        )
    # response: status 0 ok; 8 = client-side error band (bolt spec)
    status = STATUS_OK
    if resp_status != 0:
        status = STATUS_CLIENT_ERROR if resp_status == 8 else STATUS_SERVER_ERROR
    return L7Message(
        protocol=L7Protocol.SOFARPC,
        msg_type=MSG_RESPONSE,
        request_id=req_id,
        status=status,
        status_code=resp_status,
    )


# ---------------------------------------------------------------------------
# bRPC "standard" protocol (rpc/brpc.rs) — "PRPC" + body_size(4) +
# meta_size(4) + RpcMeta protobuf (request{service,method}, response
# {error_code}, correlation_id).


def _pb_fields(buf: bytes):
    """Minimal protobuf walk → yields (field_no, wire_type, value)."""
    p = 0
    while p < len(buf):
        tag = 0
        shift = 0
        while p < len(buf):
            b = buf[p]
            tag |= (b & 0x7F) << shift
            p += 1
            shift += 7
            if not b & 0x80:
                break
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            v = 0
            shift = 0
            while p < len(buf):
                b = buf[p]
                v |= (b & 0x7F) << shift
                p += 1
                shift += 7
                if not b & 0x80:
                    break
            yield field, wt, v
        elif wt == 2:  # length-delimited
            ln = 0
            shift = 0
            while p < len(buf):
                b = buf[p]
                ln |= (b & 0x7F) << shift
                p += 1
                shift += 7
                if not b & 0x80:
                    break
            yield field, wt, buf[p : p + ln]
            p += ln
        elif wt == 1:
            yield field, wt, buf[p : p + 8]
            p += 8
        elif wt == 5:
            yield field, wt, buf[p : p + 4]
            p += 4
        else:
            return


def check_brpc(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 12 or payload[:4] != b"PRPC":
        return False
    meta_size = int.from_bytes(payload[8:12], "big")
    return meta_size <= int.from_bytes(payload[4:8], "big")


def parse_brpc(payload: bytes) -> L7Message | None:
    if len(payload) < 12 or payload[:4] != b"PRPC":
        return None
    meta_size = int.from_bytes(payload[8:12], "big")
    meta = payload[12 : 12 + meta_size]
    service = method = ""
    corr_id = None
    err_code = 0
    is_resp = False
    for field, wt, val in _pb_fields(meta):
        if field == 1 and wt == 2:  # RpcRequestMeta
            for f2, w2, v2 in _pb_fields(val):
                if f2 == 1 and w2 == 2:
                    service = v2.decode(errors="replace")
                elif f2 == 2 and w2 == 2:
                    method = v2.decode(errors="replace")
        elif field == 2 and wt == 2:  # RpcResponseMeta
            is_resp = True
            for f2, w2, v2 in _pb_fields(val):
                if f2 == 1 and w2 == 0:
                    err_code = v2
        elif field == 4 and wt == 0:  # correlation_id
            corr_id = val
    if is_resp:
        return L7Message(
            protocol=L7Protocol.BRPC,
            msg_type=MSG_RESPONSE,
            request_id=corr_id,
            status=STATUS_SERVER_ERROR if err_code else STATUS_OK,
            status_code=err_code,
        )
    return L7Message(
        protocol=L7Protocol.BRPC,
        msg_type=MSG_REQUEST,
        request_type=method,
        request_resource=service,
        endpoint=f"{service}/{method}" if service else method,
        request_id=corr_id,
    )


# ---------------------------------------------------------------------------
# Tars (rpc/tars.rs) — packet: len(4) + JCE-encoded RequestPacket:
#   tag1 iVersion(short) tag2 cPacketType(byte) tag3 iMessageType(int)
#   tag4 iRequestId(int) tag5 sServantName(str) tag6 sFuncName(str)
# response: tag5 iRet(int) on version>=3 … we read the low tags only.

_JCE_INT8, _JCE_INT16, _JCE_INT32, _JCE_INT64 = 0, 1, 2, 3
_JCE_STRING1, _JCE_STRING4 = 6, 7
_JCE_ZERO = 12


def _jce_fields(buf: bytes, limit: int = 8):
    """Yield (tag, value) for the leading flat JCE fields. Tolerates
    truncation (TCP segmentation can cut a stream on any byte): a field
    whose bytes are missing simply ends the walk."""
    p = 0
    n = len(buf)
    while p < n and limit > 0:
        head = buf[p]
        tag, typ = head >> 4, head & 0x0F
        p += 1
        if tag == 0xF:
            if p >= n:
                return
            tag = buf[p]
            p += 1
        if typ == _JCE_INT8:
            if p >= n:
                return
            yield tag, buf[p]
            p += 1
        elif typ == _JCE_INT16:
            yield tag, int.from_bytes(buf[p : p + 2], "big")
            p += 2
        elif typ == _JCE_INT32:
            yield tag, int.from_bytes(buf[p : p + 4], "big")
            p += 4
        elif typ == _JCE_INT64:
            yield tag, int.from_bytes(buf[p : p + 8], "big")
            p += 8
        elif typ == _JCE_STRING1:
            if p >= n:
                return
            ln = buf[p]
            yield tag, buf[p + 1 : p + 1 + ln]
            p += 1 + ln
        elif typ == _JCE_STRING4:
            ln = int.from_bytes(buf[p : p + 4], "big")
            yield tag, buf[p + 4 : p + 4 + ln]
            p += 4 + ln
        elif typ == _JCE_ZERO:
            yield tag, 0
        else:
            return
        limit -= 1


_TARS_VERSIONS = (1, 2, 3)


def check_tars(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 8:
        return False
    pkt_len = int.from_bytes(payload[:4], "big")
    if pkt_len < 8 or pkt_len > (1 << 24):
        return False
    fields = dict(_jce_fields(payload[4:], limit=2))
    return fields.get(1) in _TARS_VERSIONS and fields.get(2, 0) in (0, 1)


def parse_tars(payload: bytes) -> L7Message | None:
    if len(payload) < 8:
        return None
    fields = dict(_jce_fields(payload[4:], limit=8))
    if fields.get(1) not in _TARS_VERSIONS:
        return None
    servant = fields.get(5, b"")
    func = fields.get(6, b"")
    if isinstance(servant, bytes) and servant:
        # RequestPacket: tag4 iRequestId, tag5 sServantName, tag6 sFuncName
        servant_s = servant.decode(errors="replace")
        func_s = func.decode(errors="replace") if isinstance(func, bytes) else ""
        return L7Message(
            protocol=L7Protocol.TARS,
            msg_type=MSG_REQUEST,
            version=str(fields.get(1)),
            request_type=func_s,
            request_resource=servant_s,
            endpoint=f"{servant_s}/{func_s}" if func_s else servant_s,
            request_id=fields.get(4),
        )
    # ResponsePacket: tag3 iRequestId, tag4 iMessageType, tag5 iRet
    ret = fields.get(5, 0) if isinstance(fields.get(5), int) else 0
    if ret >= 1 << 31:  # JCE ints are signed
        ret -= 1 << 32
    return L7Message(
        protocol=L7Protocol.TARS,
        msg_type=MSG_RESPONSE,
        version=str(fields.get(1)),
        request_id=fields.get(3),
        status=STATUS_OK if ret == 0 else STATUS_SERVER_ERROR,
        status_code=ret,
    )


# ---------------------------------------------------------------------------
# SOME/IP (rpc/some_ip.rs) — 16-byte header:
#   service_id(2) method_id(2) length(4) client_id(2) session_id(2)
#   proto_ver(1)=1 iface_ver(1) msg_type(1) return_code(1)

_SOMEIP_TYPES = {
    0x00: "REQUEST",
    0x01: "REQUEST_NO_RETURN",
    0x02: "NOTIFICATION",
    0x80: "RESPONSE",
    0x81: "ERROR",
    0x20: "TP_REQUEST",
    0x21: "TP_REQUEST_NO_RETURN",
    0x23: "TP_NOTIFICATION",
    0xA0: "TP_RESPONSE",
    0xA1: "TP_ERROR",
}


def check_someip(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 16:
        return False
    length = int.from_bytes(payload[4:8], "big")
    proto_ver = payload[12]
    msg_type = payload[14]
    return proto_ver == 1 and msg_type in _SOMEIP_TYPES and length >= 8


def parse_someip(payload: bytes) -> L7Message | None:
    if not check_someip(payload):
        return None
    service_id = int.from_bytes(payload[0:2], "big")
    method_id = int.from_bytes(payload[2:4], "big")
    session_id = int.from_bytes(payload[10:12], "big")
    msg_type = payload[14]
    ret = payload[15]
    is_resp = bool(msg_type & 0x80)
    return L7Message(
        protocol=L7Protocol.SOME_IP,
        msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
        request_type=_SOMEIP_TYPES[msg_type],
        request_resource=str(service_id),
        endpoint=f"{service_id}/{method_id:#06x}",
        request_id=session_id,
        status=STATUS_SERVER_ERROR if ret not in (0, 1) else STATUS_OK,
        status_code=ret,
    )


# ---------------------------------------------------------------------------
# Pulsar (mq/pulsar.rs) — frame: total_size(4) command_size(4) +
# BaseCommand protobuf {type enum = field 1 varint}.

_PULSAR_CMDS = {
    2: "CONNECT", 3: "CONNECTED", 4: "SUBSCRIBE", 5: "PRODUCER",
    6: "SEND", 7: "SEND_RECEIPT", 8: "SEND_ERROR", 9: "MESSAGE",
    10: "ACK", 11: "FLOW", 12: "UNSUBSCRIBE", 13: "SUCCESS",
    14: "ERROR", 15: "CLOSE_PRODUCER", 16: "CLOSE_CONSUMER",
    17: "PRODUCER_SUCCESS", 18: "PING", 19: "PONG",
    21: "PARTITIONED_METADATA", 22: "PARTITIONED_METADATA_RESPONSE",
    23: "LOOKUP", 24: "LOOKUP_RESPONSE",
}
# broker→client command types (pair as responses)
_PULSAR_RESP = {3, 7, 8, 9, 13, 14, 17, 19, 22, 24}


def check_pulsar(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 9:
        return False
    total = int.from_bytes(payload[:4], "big")
    cmd_size = int.from_bytes(payload[4:8], "big")
    if cmd_size + 4 > total or total > (1 << 26):
        return False
    # field 1 (type) may legally appear after other BaseCommand fields
    for field, wt, val in _pb_fields(payload[8 : 8 + cmd_size]):
        if field == 1 and wt == 0:
            return val in _PULSAR_CMDS
    return False


def parse_pulsar(payload: bytes) -> L7Message | None:
    if len(payload) < 9:
        return None
    cmd_size = int.from_bytes(payload[4:8], "big")
    cmd_type = None
    for field, wt, val in _pb_fields(payload[8 : 8 + cmd_size]):
        if field == 1 and wt == 0:
            cmd_type = val
            break
    name = _PULSAR_CMDS.get(cmd_type)
    if name is None:
        return None
    return L7Message(
        protocol=L7Protocol.PULSAR,
        msg_type=MSG_RESPONSE if cmd_type in _PULSAR_RESP else MSG_REQUEST,
        request_type=name,
        status=STATUS_SERVER_ERROR if name in ("SEND_ERROR", "ERROR") else STATUS_OK,
    )


# ---------------------------------------------------------------------------
# OpenWire / ActiveMQ (mq/openwire.rs) — frame: length(4) dtype(1)…
# WIREFORMAT_INFO (1) carries the b"ActiveMQ" magic.

_OPENWIRE_TYPES = {
    1: "WIREFORMAT_INFO", 2: "BROKER_INFO", 3: "CONNECTION_INFO",
    4: "SESSION_INFO", 5: "CONSUMER_INFO", 6: "PRODUCER_INFO",
    7: "TRANSACTION_INFO", 8: "DESTINATION_INFO", 9: "REMOVE_SUBSCRIPTION_INFO",
    10: "KEEP_ALIVE_INFO", 11: "SHUTDOWN_INFO", 12: "REMOVE_INFO",
    14: "CONTROL_COMMAND", 15: "FLUSH_COMMAND", 16: "CONNECTION_ERROR",
    21: "MESSAGE_DISPATCH", 22: "MESSAGE_ACK", 23: "ACTIVEMQ_MESSAGE",
    24: "ACTIVEMQ_BYTES_MESSAGE", 25: "ACTIVEMQ_MAP_MESSAGE",
    26: "ACTIVEMQ_OBJECT_MESSAGE", 27: "ACTIVEMQ_STREAM_MESSAGE",
    28: "ACTIVEMQ_TEXT_MESSAGE", 30: "RESPONSE", 31: "EXCEPTION_RESPONSE",
    32: "DATA_RESPONSE", 34: "INTEGER_RESPONSE",
}
_OPENWIRE_RESP = {16, 21, 30, 31, 32, 34}


def check_openwire(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 5:
        return False
    length = int.from_bytes(payload[:4], "big")
    dtype = payload[4]
    if dtype == 1:  # WireFormatInfo: magic follows the dtype byte
        return payload[5:13] == b"ActiveMQ"
    return dtype in _OPENWIRE_TYPES and 1 <= length <= (1 << 26) and port == 61616


def parse_openwire(payload: bytes) -> L7Message | None:
    if len(payload) < 5:
        return None
    dtype = payload[4]
    name = _OPENWIRE_TYPES.get(dtype)
    if name is None:
        return None
    return L7Message(
        protocol=L7Protocol.OPENWIRE,
        msg_type=MSG_RESPONSE if dtype in _OPENWIRE_RESP else MSG_REQUEST,
        request_type=name,
        status=STATUS_SERVER_ERROR if dtype in (16, 31) else STATUS_OK,
    )


# ---------------------------------------------------------------------------
# ZMTP 3.x (mq/zmtp.rs) — greeting: 0xFF pad(8) 0x7F major(1) minor(1)
# mechanism(20, NUL-padded) as-server(1) filler(31); then frames:
# flags(1: MORE|LONG|COMMAND) size(1 or 8) body.

_ZMTP_MECHANISMS = (b"NULL", b"PLAIN", b"CURVE", b"GSSAPI")


def check_zmtp(payload: bytes, port: int = 0) -> bool:
    if len(payload) >= 12 and payload[0] == 0xFF and payload[9] == 0x7F:
        if payload[10] != 3:
            return False
        mech = payload[12:32].rstrip(b"\x00") if len(payload) >= 32 else b""
        return len(payload) < 32 or mech in _ZMTP_MECHANISMS
    # command frame: flags(1) size(1 short / 8 long) name_len(1) name…
    if len(payload) >= 4 and payload[0] in (0x04, 0x06):
        if payload[0] == 0x06 and len(payload) < 11:
            return False
        name_len = payload[2] if payload[0] == 0x04 else payload[9]
        off = 3 if payload[0] == 0x04 else 10
        name = payload[off : off + name_len]
        return name in (b"READY", b"ERROR", b"SUBSCRIBE", b"CANCEL", b"PING", b"PONG", b"HELLO", b"WELCOME", b"INITIATE")
    return False


def parse_zmtp(payload: bytes) -> L7Message | None:
    # a flow greeting-classified as ZMTP later delivers arbitrary
    # (possibly truncated) frames — never raise, just skip them
    if not check_zmtp(payload):
        return None
    if payload[0] == 0xFF:  # greeting
        mech = (
            payload[12:32].rstrip(b"\x00").decode(errors="replace")
            if len(payload) >= 32
            else ""
        )
        return L7Message(
            protocol=L7Protocol.ZMTP,
            msg_type=MSG_REQUEST,
            version=f"3.{payload[11]}" if len(payload) > 11 else "3",
            request_type="greeting",
            request_resource=mech,
        )
    name_len = payload[2] if payload[0] == 0x04 else payload[9]
    off = 3 if payload[0] == 0x04 else 10
    name = payload[off : off + name_len].decode(errors="replace")
    return L7Message(
        protocol=L7Protocol.ZMTP,
        msg_type=MSG_RESPONSE
        if name in ("WELCOME", "PONG", "ERROR")
        else MSG_REQUEST,
        request_type=name,
        status=STATUS_SERVER_ERROR if name == "ERROR" else STATUS_OK,
    )


# ---------------------------------------------------------------------------
# Oracle TNS (sql/oracle.rs) — packet: length(2) checksum(2) type(1)
# flags(1) header_checksum(2). Type 1=CONNECT 2=ACCEPT 4=REFUSE 6=DATA
# 11=RESEND 12=MARKER.

_TNS_TYPES = {
    1: "CONNECT", 2: "ACCEPT", 3: "ACK", 4: "REFUSE", 5: "REDIRECT",
    6: "DATA", 7: "NULL", 9: "ABORT", 11: "RESEND", 12: "MARKER",
    13: "ATTENTION", 14: "CONTROL",
}
_TNS_RESP = {2, 4, 5, 11}


def check_oracle(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 8:
        return False
    pkt_len = int.from_bytes(payload[:2], "big")
    ptype = payload[4]
    if ptype not in _TNS_TYPES:
        return False
    if ptype == 1:  # CONNECT carries "(DESCRIPTION=" connect data
        return b"(DESCRIPTION=" in payload or b"(CONNECT_DATA=" in payload
    return pkt_len == len(payload) or port == 1521


def parse_oracle(payload: bytes) -> L7Message | None:
    if len(payload) < 8:
        return None
    ptype = payload[4]
    name = _TNS_TYPES.get(ptype)
    if name is None:
        return None
    service = ""
    if ptype == 1:
        i = payload.find(b"SERVICE_NAME=")
        if i >= 0:
            j = payload.find(b")", i)
            service = payload[i + 13 : j].decode(errors="replace")
    return L7Message(
        protocol=L7Protocol.ORACLE,
        msg_type=MSG_RESPONSE if ptype in _TNS_RESP else MSG_REQUEST,
        request_type=name,
        request_domain=service,
        status=STATUS_SERVER_ERROR if ptype in (4, 9) else STATUS_OK,
    )


# ---------------------------------------------------------------------------
# Ping (ping.rs) — ICMP echo: type(1)=8 req /0 reply, code(1)=0,
# checksum(2), id(2), seq(2). The dispatcher hands the ICMP message as
# the "payload" for IPPROTO_ICMP flows.


def _inet_checksum(buf: bytes) -> int:
    if len(buf) % 2:
        buf += b"\x00"
    s = sum(int.from_bytes(buf[i : i + 2], "big") for i in range(0, len(buf), 2))
    while s >> 16:
        s = (s & 0xFFFF) + (s >> 16)
    return ~s & 0xFFFF


def check_ping(payload: bytes, port: int = 0) -> bool:
    # only reachable from the engine's ICMP branch (never probed against
    # TCP/UDP payloads), so no checksum requirement: snap-truncated echo
    # payloads must still classify
    return len(payload) >= 8 and payload[0] in (0, 8) and payload[1] == 0


def parse_ping(payload: bytes) -> L7Message | None:
    if not check_ping(payload):
        return None
    icmp_type = payload[0]
    ident = int.from_bytes(payload[4:6], "big")
    seq = int.from_bytes(payload[6:8], "big")
    return L7Message(
        protocol=L7Protocol.PING,
        msg_type=MSG_REQUEST if icmp_type == 8 else MSG_RESPONSE,
        request_type="echo",
        # one logical "request" per (id, seq) pair — rpc-style pairing
        request_id=(ident << 16) | seq,
    )
