"""L7 parsers, wave 4: FastCGI + RocketMQ.

Port copy of deepflow_tpu/agent/l7/parsers_rpc.py.

Behavioral peers of protocol_logs/rpc/fastcgi.rs and mq/rocketmq.rs;
wire layouts from the public protocol specs:

  * FastCGI: 8-byte records [version=1][type][requestId u16]
    [contentLength u16][paddingLength][reserved]; BEGIN_REQUEST=1 opens,
    PARAMS=4 carries name-value pairs (REQUEST_METHOD / REQUEST_URI),
    STDOUT=6 carries the response head ("Status: NNN"), END_REQUEST=3.
  * RocketMQ remoting: [frame len u32][header meta u32: serializer in
    the top byte, JSON header length in the low 24 bits][JSON header]
    [body]. Header fields: code, flag (bit0 = response), opaque
    (correlation id), language, version, extFields{topic, consumerGroup,
    queueId...}, remark.
"""

from __future__ import annotations

import json

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
# FastCGI

_FCGI_BEGIN = 1
_FCGI_END = 3
_FCGI_PARAMS = 4
_FCGI_STDOUT = 6
_FCGI_TYPES = set(range(1, 12))


def _fcgi_records(payload: bytes):
    off = 0
    while off + 8 <= len(payload):
        version, rtype = payload[off], payload[off + 1]
        req_id = int.from_bytes(payload[off + 2 : off + 4], "big")
        clen = int.from_bytes(payload[off + 4 : off + 6], "big")
        plen = payload[off + 6]
        if version != 1 or rtype not in _FCGI_TYPES:
            return
        if rtype == 1 and clen != 8:  # spec: BEGIN_REQUEST body is exactly 8B
            return
        yield rtype, req_id, payload[off + 8 : off + 8 + clen]
        off += 8 + clen + plen


def _fcgi_params(content: bytes) -> dict:
    out = {}
    off = 0
    n = len(content)
    while off < n:
        lens = []
        for _ in range(2):
            if off >= n:
                return out
            ln = content[off]
            if ln >> 7:
                ln = int.from_bytes(content[off : off + 4], "big") & 0x7FFFFFFF
                off += 4
            else:
                off += 1
            lens.append(ln)
        k = content[off : off + lens[0]]
        v = content[off + lens[0] : off + lens[0] + lens[1]]
        off += lens[0] + lens[1]
        out[k.decode(errors="replace")] = v.decode(errors="replace")
    return out


def check_fastcgi(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 8 or payload[0] != 1:
        return False
    return payload[1] in _FCGI_TYPES and (
        port == 9000 or next(_fcgi_records(payload), None) is not None
    )


def parse_fastcgi(payload: bytes) -> L7Message | None:
    try:
        method = uri = ""
        req_id = None
        saw_req = saw_resp = False
        status = STATUS_OK
        code = 0
        for rtype, rid, content in _fcgi_records(payload):
            req_id = rid
            if rtype in (_FCGI_BEGIN, _FCGI_PARAMS):
                saw_req = True
                if rtype == _FCGI_PARAMS and content:
                    params = _fcgi_params(content)
                    method = params.get("REQUEST_METHOD", method)
                    uri = params.get("REQUEST_URI", params.get("SCRIPT_NAME", uri))
            elif rtype in (_FCGI_STDOUT, _FCGI_END):
                saw_resp = True
                if rtype == _FCGI_STDOUT and content.startswith(b"Status:"):
                    head = content.split(b"\r\n", 1)[0][7:].strip()
                    digits = head.split(b" ", 1)[0]
                    if digits.isdigit():
                        code = int(digits)
                        status = (
                            STATUS_CLIENT_ERROR
                            if 400 <= code < 500
                            else STATUS_SERVER_ERROR if code >= 500 else STATUS_OK
                        )
        if saw_req and not saw_resp:
            from .parsers import endpoint_from_path

            return L7Message(
                protocol=L7Protocol.FASTCGI,
                msg_type=MSG_REQUEST,
                request_type=method,
                request_resource=uri,
                endpoint=endpoint_from_path(uri) if uri else "",
                request_id=req_id,
            )
        if saw_resp:
            return L7Message(
                protocol=L7Protocol.FASTCGI,
                msg_type=MSG_RESPONSE,
                status=status,
                status_code=code,
                request_id=req_id,
            )
        return None
    except (IndexError, ValueError):
        return None


# ---------------------------------------------------------------------------
# RocketMQ

_ROCKETMQ_CODES = {
    10: "SEND_MESSAGE", 11: "PULL_MESSAGE", 12: "QUERY_MESSAGE",
    14: "QUERY_CONSUMER_OFFSET", 15: "UPDATE_CONSUMER_OFFSET",
    34: "HEART_BEAT", 35: "UNREGISTER_CLIENT", 36: "CONSUMER_SEND_MSG_BACK",
    38: "GET_CONSUMER_LIST_BY_GROUP", 105: "GET_ROUTEINFO_BY_TOPIC",
    310: "SEND_MESSAGE_V2", 320: "SEND_BATCH_MESSAGE",
}
_ROCKETMQ_RESP = {0: "SUCCESS", 1: "SYSTEM_ERROR", 2: "SYSTEM_BUSY",
                  3: "REQUEST_CODE_NOT_SUPPORTED"}


def check_rocketmq(payload: bytes, port: int = 0) -> bool:
    if len(payload) < 12:
        return False
    total = int.from_bytes(payload[0:4], "big")
    meta = int.from_bytes(payload[4:8], "big")
    hlen = meta & 0xFFFFFF
    serializer = meta >> 24
    # only the JSON serializer (0) is parseable below; accepting the
    # binary one would pin flows to a protocol that then never parses
    # (and its loose shape swallows SofaRPC/Bolt frames)
    return (
        4 <= total <= 1 << 25
        and serializer == 0
        and 2 <= hlen
        and hlen + 4 <= total
        and payload[8:9] == b"{"
    )


def parse_rocketmq(payload: bytes) -> L7Message | None:
    try:
        meta = int.from_bytes(payload[4:8], "big")
        hlen = meta & 0xFFFFFF
        if meta >> 24 != 0:  # ROCKETMQ (binary) headers: code+flag only
            return None
        header = json.loads(payload[8 : 8 + hlen])
        code = int(header.get("code", 0))
        flag = int(header.get("flag", 0))
        opaque = int(header.get("opaque", 0))
        ext = header.get("extFields") or {}
        topic = str(ext.get("topic", ext.get("b", "")))
        group = str(ext.get("consumerGroup", ext.get("group", ext.get("a", ""))))
        if flag & 1:  # response
            rstatus = STATUS_OK if code == 0 else STATUS_SERVER_ERROR
            return L7Message(
                protocol=L7Protocol.ROCKETMQ,
                msg_type=MSG_RESPONSE,
                request_type=_ROCKETMQ_RESP.get(code, str(code)),
                status=rstatus,
                status_code=code,
                request_id=opaque,
            )
        name = _ROCKETMQ_CODES.get(code, str(code))
        return L7Message(
            protocol=L7Protocol.ROCKETMQ,
            msg_type=MSG_REQUEST,
            request_type=name,
            request_domain=group,
            request_resource=topic,
            endpoint=topic or name,
            request_id=opaque,
        )
    except (IndexError, ValueError, TypeError):
        return None
