"""L7 parsers, wave 3: MQTT, memcached, NATS, AMQP.

Port copy of deepflow_tpu/agent/l7/parsers_mq.py.

Behavioral peers of protocol_logs/mq/{mqtt.rs, nats.rs, amqp.rs} and
sql/memcached.rs; wire layouts from the public protocol specs.
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
# MQTT (mq/mqtt.rs) — fixed header: [type:4|flags:4][remaining varint]

_MQTT_TYPES = {
    1: "CONNECT", 2: "CONNACK", 3: "PUBLISH", 4: "PUBACK", 5: "PUBREC",
    6: "PUBREL", 7: "PUBCOMP", 8: "SUBSCRIBE", 9: "SUBACK",
    10: "UNSUBSCRIBE", 11: "UNSUBACK", 12: "PINGREQ", 13: "PINGRESP",
    14: "DISCONNECT",
}
# control packets the broker sends (pair as responses)
_MQTT_RESP = {2, 4, 5, 7, 9, 11, 13}


def _mqtt_varint(buf: bytes, off: int) -> tuple[int, int]:
    v = shift = 0
    while off < len(buf) and shift <= 21:
        b = buf[off]
        v |= (b & 0x7F) << shift
        off += 1
        shift += 7
        if not b & 0x80:
            return v, off
    return -1, off


def check_mqtt(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 2:
        return False
    ptype = payload[0] >> 4
    if ptype not in _MQTT_TYPES:
        return False
    ln, hdr_end = _mqtt_varint(payload, 1)
    if ln < 0:
        return False
    if ptype == 1:  # CONNECT carries the protocol name
        name_len = int.from_bytes(payload[hdr_end : hdr_end + 2], "big")
        name = payload[hdr_end + 2 : hdr_end + 2 + name_len]
        return name in (b"MQTT", b"MQIsdp")
    return port == 1883 or hdr_end + ln == len(payload)


def parse_mqtt(payload: bytes) -> L7Message | None:
    try:
        ptype = payload[0] >> 4
        name = _MQTT_TYPES.get(ptype)
        if name is None:
            return None
        _ln, off = _mqtt_varint(payload, 1)
        topic = client_id = ""
        status = STATUS_OK
        code = 0
        if ptype == 1:  # CONNECT: proto name, level, flags, keepalive,
            # [v5: properties], client id
            nlen = int.from_bytes(payload[off : off + 2], "big")
            p = off + 2 + nlen
            level = payload[p]
            p += 1 + 1 + 2  # level, connect flags, keepalive
            if level >= 5:  # MQTT 5 properties: varint length + body
                plen, p = _mqtt_varint(payload, p)
                p += max(plen, 0)
            clen = int.from_bytes(payload[p : p + 2], "big")
            client_id = payload[p + 2 : p + 2 + clen].decode(errors="replace")
        elif ptype == 2:  # CONNACK: flags + return code
            code = payload[off + 1] if len(payload) > off + 1 else 0
            if code:
                status = STATUS_SERVER_ERROR
        elif ptype == 3:  # PUBLISH: topic
            tlen = int.from_bytes(payload[off : off + 2], "big")
            topic = payload[off + 2 : off + 2 + tlen].decode(errors="replace")
        elif ptype in (8, 10):  # (UN)SUBSCRIBE: packet id [v5 props] topic
            p = off + 2
            # v5 detection without connection state: a valid v3 topic
            # length never starts with 0x00-high-byte+varint-looking
            # properties; probe — if the u16 at p yields a non-UTF8 or
            # zero-length topic and byte p parses as a properties varint
            # whose skip lands on a valid topic, prefer that. Cheap form:
            # try v3 first, fall back to skipping a properties varint.
            tlen = int.from_bytes(payload[p : p + 2], "big")
            if tlen == 0 or p + 2 + tlen > len(payload):
                plen, q = _mqtt_varint(payload, p)
                if plen >= 0:
                    p = q + plen
                    tlen = int.from_bytes(payload[p : p + 2], "big")
            topic = payload[p + 2 : p + 2 + tlen].decode(errors="replace")
        return L7Message(
            protocol=L7Protocol.MQTT,
            msg_type=MSG_RESPONSE if ptype in _MQTT_RESP else MSG_REQUEST,
            request_type=name,
            request_domain=client_id,
            request_resource=topic,
            endpoint=topic or name,
            status=status,
            status_code=code,
        )
    except (IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# memcached (sql/memcached.rs) — text protocol

_MC_STORE = (b"set", b"add", b"replace", b"append", b"prepend", b"cas")
_MC_REQ = _MC_STORE + (b"get", b"gets", b"gat", b"gats", b"delete", b"incr",
                       b"decr", b"touch", b"stats", b"flush_all", b"version",
                       b"verbosity", b"quit")
_MC_RESP = (b"VALUE", b"STORED", b"NOT_STORED", b"EXISTS", b"NOT_FOUND",
            b"DELETED", b"TOUCHED", b"END", b"OK", b"VERSION", b"STAT",
            b"ERROR", b"CLIENT_ERROR", b"SERVER_ERROR")


def check_memcached(payload: bytes, port: int = 0) -> bool:
    if b"\r\n" not in payload[:1024]:
        return False
    first = payload.split(b"\r\n", 1)[0].split(b" ", 1)[0]
    return first in _MC_REQ or first in _MC_RESP


def parse_memcached(payload: bytes) -> L7Message | None:
    try:
        line = payload.split(b"\r\n", 1)[0]
        parts = line.split(b" ")
        word = parts[0]
        if word in _MC_REQ:
            cmd = word.decode()
            return L7Message(
                protocol=L7Protocol.MEMCACHED,
                msg_type=MSG_REQUEST,
                request_type=cmd,
                request_resource=line.decode(errors="replace"),
                endpoint=cmd,
            )
        if word in _MC_RESP:
            status = STATUS_OK
            if word == b"SERVER_ERROR":
                status = STATUS_SERVER_ERROR
            elif word in (b"ERROR", b"CLIENT_ERROR"):
                status = STATUS_CLIENT_ERROR
            return L7Message(
                protocol=L7Protocol.MEMCACHED,
                msg_type=MSG_RESPONSE,
                status=status,
                request_resource=line.decode(errors="replace"),
            )
        return None
    except (IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# NATS (mq/nats.rs) — text control lines

_NATS_CLIENT = (b"CONNECT", b"PUB", b"HPUB", b"SUB", b"UNSUB", b"PING")
_NATS_SERVER = (b"INFO", b"MSG", b"HMSG", b"+OK", b"-ERR", b"PONG")


def check_nats(payload: bytes, port: int = 0) -> bool:
    head = payload[:16].upper()
    return any(head.startswith(w + b" ") or head.startswith(w + b"\r")
               for w in _NATS_CLIENT + _NATS_SERVER)


def parse_nats(payload: bytes) -> L7Message | None:
    try:
        line = payload.split(b"\r\n", 1)[0]
        parts = line.split(b" ")
        verb = parts[0].upper().decode(errors="replace")
        subject = ""
        status = STATUS_OK
        if verb in ("PUB", "HPUB", "SUB", "MSG", "HMSG", "UNSUB"):
            subject = parts[1].decode(errors="replace") if len(parts) > 1 else ""
        if verb == "-ERR":
            status = STATUS_SERVER_ERROR
        is_resp = parts[0].upper() in _NATS_SERVER
        return L7Message(
            protocol=L7Protocol.NATS,
            msg_type=MSG_RESPONSE if is_resp else MSG_REQUEST,
            request_type=verb,
            request_resource=subject,
            endpoint=subject or verb,
            status=status,
        )
    except (IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# AMQP 0-9-1 (mq/amqp.rs) — "AMQP\0\0\x09\x01" header + framed methods

_AMQP_CLASSES = {10: "Connection", 20: "Channel", 40: "Exchange",
                 50: "Queue", 60: "Basic", 85: "Confirm", 90: "Tx"}
_AMQP_METHODS = {
    (10, 10): "Start", (10, 11): "StartOk", (10, 30): "Tune",
    (10, 31): "TuneOk", (10, 40): "Open", (10, 41): "OpenOk",
    (10, 50): "Close", (10, 51): "CloseOk",
    (20, 10): "Open", (20, 11): "OpenOk", (20, 40): "Close", (20, 41): "CloseOk",
    (40, 10): "Declare", (40, 11): "DeclareOk",
    (50, 10): "Declare", (50, 11): "DeclareOk", (50, 20): "Bind", (50, 21): "BindOk",
    (60, 20): "Consume", (60, 21): "ConsumeOk", (60, 40): "Publish",
    (60, 60): "Deliver", (60, 70): "Get", (60, 71): "GetOk", (60, 80): "Ack",
}
# *Ok methods pair as responses to their request; Start/Tune are the
# SERVER's handshake requests (answered by client StartOk/TuneOk) and
# Deliver is a server push — requests, or FIFO pairing inverts every
# handshake's client/server identity
_AMQP_RESP_METHODS = {m for m in _AMQP_METHODS if m[1] % 10 == 1}


def check_amqp(payload: bytes, port: int = 0) -> bool:
    if payload.startswith(b"AMQP\x00"):
        return True
    if len(payload) < 8:
        return False
    ftype = payload[0]
    size = int.from_bytes(payload[3:7], "big")
    # off-port we demand the whole frame in the segment WITH the 0xCE
    # frame-end octet (spec §2.3.5) — that end marker is what keeps
    # arbitrary length-prefixed binary from classifying as AMQP; on
    # :5672 a frame may span segments, so only a sane size bound applies
    if ftype not in (1, 2, 3, 8):
        return False
    if size + 8 <= len(payload):
        return payload[7 + size] == 0xCE
    return port == 5672 and size < 1 << 24


def parse_amqp(payload: bytes) -> L7Message | None:
    try:
        if payload.startswith(b"AMQP\x00"):
            return L7Message(
                protocol=L7Protocol.AMQP,
                msg_type=MSG_REQUEST,
                request_type="ProtocolHeader",
                version=f"{payload[6]}.{payload[7]}" if len(payload) >= 8 else "",
            )
        ftype = payload[0]
        if ftype != 1:  # header/body/heartbeat frames carry no method
            return L7Message(protocol=L7Protocol.AMQP, msg_type=MSG_REQUEST,
                             request_type={2: "ContentHeader", 3: "ContentBody",
                                           8: "Heartbeat"}.get(ftype, "Frame"))
        class_id = int.from_bytes(payload[7:9], "big")
        method_id = int.from_bytes(payload[9:11], "big")
        cname = _AMQP_CLASSES.get(class_id, str(class_id))
        mname = _AMQP_METHODS.get((class_id, method_id), str(method_id))
        req_type = f"{cname}.{mname}"
        status = STATUS_OK
        if (class_id, method_id) in ((10, 50), (20, 40)):  # Close carries a code
            code = int.from_bytes(payload[11:13], "big")
            if code >= 400:
                status = STATUS_SERVER_ERROR if code >= 500 else STATUS_CLIENT_ERROR
        return L7Message(
            protocol=L7Protocol.AMQP,
            msg_type=MSG_RESPONSE
            if (class_id, method_id) in _AMQP_RESP_METHODS
            else MSG_REQUEST,
            request_type=req_type,
            endpoint=req_type,
            status=status,
        )
    except (IndexError, ValueError):
        return None
