"""HTTP/2 + gRPC parser — frames, HPACK header decode, gRPC detection.

Port copy of deepflow_tpu/agent/l7/http2.py.

Mirrors the behavior of the reference's h2 path (protocol_logs/http.rs:
the HTTP/2 branch parses HEADERS frames via an HPACK decoder, detects
gRPC from the content-type, maps :path to the request resource and
grpc-status/:status to the response status). Implementation is from the
public RFC specs, not the reference code:

  * RFC 9113 frame layout: [len u24 BE][type u8][flags u8][stream u31].
  * RFC 7541 HPACK: static table, dynamic table (append semantics),
    indexed / literal header fields, integer prefix coding, and the
    spec's canonical Huffman code (the packed table below is the RFC
    7541 Appendix B data).

The per-flow parser is stateless across packets except for the optional
`Hpack` dynamic table a caller may thread through a connection.
"""

from __future__ import annotations

import dataclasses

from ...datamodel.code import L7Protocol
from .parsers import (
    MSG_REQUEST,
    MSG_RESPONSE,
    STATUS_CLIENT_ERROR,
    STATUS_OK,
    STATUS_SERVER_ERROR,
    L7Message,
)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_SETTINGS = 0x4

# -- RFC 7541 Appendix B Huffman code, packed as "code_hex:length" ------
_HUFF_PACKED = "1ff8:13,7fffd8:23,fffffe2:28,fffffe3:28,fffffe4:28,fffffe5:28,fffffe6:28,fffffe7:28,fffffe8:28,ffffea:24,3ffffffc:30,fffffe9:28,fffffea:28,3ffffffd:30,fffffeb:28,fffffec:28,fffffed:28,fffffee:28,fffffef:28,ffffff0:28,ffffff1:28,ffffff2:28,3ffffffe:30,ffffff3:28,ffffff4:28,ffffff5:28,ffffff6:28,ffffff7:28,ffffff8:28,ffffff9:28,ffffffa:28,ffffffb:28,14:6,3f8:10,3f9:10,ffa:12,1ff9:13,15:6,f8:8,7fa:11,3fa:10,3fb:10,f9:8,7fb:11,fa:8,16:6,17:6,18:6,0:5,1:5,2:5,19:6,1a:6,1b:6,1c:6,1d:6,1e:6,1f:6,5c:7,fb:8,7ffc:15,20:6,ffb:12,3fc:10,1ffa:13,21:6,5d:7,5e:7,5f:7,60:7,61:7,62:7,63:7,64:7,65:7,66:7,67:7,68:7,69:7,6a:7,6b:7,6c:7,6d:7,6e:7,6f:7,70:7,71:7,72:7,fc:8,73:7,fd:8,1ffb:13,7fff0:19,1ffc:13,3ffc:14,22:6,7ffd:15,3:5,23:6,4:5,24:6,5:5,25:6,26:6,27:6,6:5,74:7,75:7,28:6,29:6,2a:6,7:5,2b:6,76:7,2c:6,8:5,9:5,2d:6,77:7,78:7,79:7,7a:7,7b:7,7ffe:15,7fc:11,3ffd:14,1ffd:13,ffffffc:28,fffe6:20,3fffd2:22,fffe7:20,fffe8:20,3fffd3:22,3fffd4:22,3fffd5:22,7fffd9:23,3fffd6:22,7fffda:23,7fffdb:23,7fffdc:23,7fffdd:23,7fffde:23,ffffeb:24,7fffdf:23,ffffec:24,ffffed:24,3fffd7:22,7fffe0:23,ffffee:24,7fffe1:23,7fffe2:23,7fffe3:23,7fffe4:23,1fffdc:21,3fffd8:22,7fffe5:23,3fffd9:22,7fffe6:23,7fffe7:23,ffffef:24,3fffda:22,1fffdd:21,fffe9:20,3fffdb:22,3fffdc:22,7fffe8:23,7fffe9:23,1fffde:21,7fffea:23,3fffdd:22,3fffde:22,fffff0:24,1fffdf:21,3fffdf:22,7fffeb:23,7fffec:23,1fffe0:21,1fffe1:21,3fffe0:22,1fffe2:21,7fffed:23,3fffe1:22,7fffee:23,7fffef:23,fffea:20,3fffe2:22,3fffe3:22,3fffe4:22,7ffff0:23,3fffe5:22,3fffe6:22,7ffff1:23,3ffffe0:26,3ffffe1:26,fffeb:20,7fff1:19,3fffe7:22,7ffff2:23,3fffe8:22,1ffffec:25,3ffffe2:26,3ffffe3:26,3ffffe4:26,7ffffde:27,7ffffdf:27,3ffffe5:26,fffff1:24,1ffffed:25,7fff2:19,1fffe3:21,3ffffe6:26,7ffffe0:27,7ffffe1:27,3ffffe7:26,7ffffe2:27,fffff2:24,1fffe4:21,1fffe5:21,3ffffe8:26,3ffffe9:26,ffffffd:28,7ffffe3:27,7ffffe4:27,7ffffe5:27,fffec:20,fffff3:24,fffed:20,1fffe6:21,3fffe9:22,1fffe7:21,1fffe8:21,7ffff3:23,3fffea:22,3fffeb:22,1ffffee:25,1ffffef:25,fffff4:24,fffff5:24,3ffffea:26,7ffff4:23,3ffffeb:26,7ffffe6:27,3ffffec:26,3ffffed:26,7ffffe7:27,7ffffe8:27,7ffffe9:27,7ffffea:27,7ffffeb:27,ffffffe:28,7ffffec:27,7ffffed:27,7ffffee:27,7ffffef:27,7fffff0:27,3ffffee:26,3fffffff:30"  # noqa: E501

# decode map: (code, length) -> symbol; walked bit-by-bit
_HUFF_DECODE: dict[tuple[int, int], int] = {}
for _sym, _entry in enumerate(_HUFF_PACKED.split(",")):
    _c, _l = _entry.split(":")
    _HUFF_DECODE[(int(_c, 16), int(_l))] = _sym


def huffman_decode(data: bytes) -> str:
    out = []
    code = 0
    length = 0
    for byte in data:
        for bit in range(7, -1, -1):
            code = (code << 1) | ((byte >> bit) & 1)
            length += 1
            sym = _HUFF_DECODE.get((code, length))
            if sym is not None:
                if sym == 256:  # EOS in data is an error; stop
                    return "".join(out)
                out.append(chr(sym))
                code = 0
                length = 0
            elif length > 30:
                return "".join(out)  # malformed
    return "".join(out)


# -- RFC 7541 Appendix A static table (name, value) ---------------------
STATIC_TABLE = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]


class Hpack:
    """Minimal HPACK decoder state (dynamic table, append-at-front)."""

    def __init__(self, max_entries: int = 256):
        self.dynamic: list[tuple[str, str]] = []
        self.max_entries = max_entries

    def _lookup(self, idx: int) -> tuple[str, str]:
        if 1 <= idx <= len(STATIC_TABLE):
            return STATIC_TABLE[idx - 1]
        d = idx - len(STATIC_TABLE) - 1
        if 0 <= d < len(self.dynamic):
            return self.dynamic[d]
        return ("", "")

    def _insert(self, name: str, value: str) -> None:
        self.dynamic.insert(0, (name, value))
        del self.dynamic[self.max_entries:]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        """HPACK header block → [(name, value)]; best-effort on damage."""
        headers = []
        i = 0
        n = len(block)

        def read_int(prefix_bits: int) -> int:
            nonlocal i
            mask = (1 << prefix_bits) - 1
            v = block[i] & mask
            i += 1
            if v < mask:
                return v
            shift = 0
            while i < n:
                b = block[i]
                i += 1
                v += (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            return v

        def read_str() -> str:
            nonlocal i
            if i >= n:
                return ""
            huff = bool(block[i] & 0x80)
            ln = read_int(7)
            raw = block[i : i + ln]
            i += ln
            return huffman_decode(raw) if huff else raw.decode("utf-8", "replace")

        while i < n:
            b = block[i]
            if b & 0x80:  # indexed field
                idx = read_int(7)
                headers.append(self._lookup(idx))
            elif b & 0x40:  # literal with incremental indexing
                idx = read_int(6)
                name = self._lookup(idx)[0] if idx else read_str()
                value = read_str()
                self._insert(name, value)
                headers.append((name, value))
            elif b & 0x20:  # dynamic table size update
                read_int(5)
            else:  # literal without indexing / never indexed (prefix 4)
                idx = read_int(4)
                name = self._lookup(idx)[0] if idx else read_str()
                value = read_str()
                headers.append((name, value))
        return headers


@dataclasses.dataclass
class H2Frame:
    type: int
    flags: int
    stream_id: int
    payload: bytes


def iter_frames(payload: bytes):
    """Yield frames from a packet payload (preface skipped if present)."""
    off = 0
    if payload.startswith(PREFACE):
        off = len(PREFACE)
    n = len(payload)
    while off + 9 <= n:
        ln = int.from_bytes(payload[off : off + 3], "big")
        typ = payload[off + 3]
        flags = payload[off + 4]
        stream = int.from_bytes(payload[off + 5 : off + 9], "big") & 0x7FFFFFFF
        body = payload[off + 9 : off + 9 + ln]
        if typ > 0x9 or ln > 1 << 20:  # not an h2 stream after all
            return
        yield H2Frame(typ, flags, stream, body)
        off += 9 + ln


def check_http2(payload: bytes, port: int = 0) -> bool:
    if payload.startswith(PREFACE):
        return True
    # standalone frame heuristic: valid type + sane length + SETTINGS or
    # HEADERS near the front (the reference's h2c sniff in http.rs)
    if len(payload) < 9:
        return False
    ln = int.from_bytes(payload[0:3], "big")
    typ = payload[3]
    if typ == FRAME_SETTINGS:
        return ln % 6 == 0 and ln <= 1024
    return typ == FRAME_HEADERS and ln <= len(payload)


_N_PATH_SEGMENTS = 2


def parse_http2(payload: bytes, hpack: Hpack | None = None) -> L7Message | None:
    """First HEADERS frame in the payload → request/response message.

    gRPC: content-type application/grpc → protocol GRPC, endpoint =
    /package.Service/Method from :path, grpc-status maps onto status.
    """
    hp = hpack or Hpack()
    try:
        return _parse_http2_inner(payload, hp)
    except Exception:
        return None


def _parse_http2_inner(payload: bytes, hp: Hpack) -> L7Message | None:
    for fr in iter_frames(payload):
        if fr.type != FRAME_HEADERS:
            continue
        body = fr.payload
        pad = body[0] if fr.flags & 0x8 and body else 0
        off = 1 if fr.flags & 0x8 else 0
        if fr.flags & 0x20:  # PRIORITY fields
            off += 5
        block = body[off : len(body) - pad if pad else len(body)]
        headers = dict(hp.decode(block))
        if not headers:
            return None
        is_grpc = headers.get("content-type", "").startswith("application/grpc")
        proto = L7Protocol.GRPC if is_grpc else L7Protocol.HTTP2
        if ":method" in headers:  # request
            from .parsers import endpoint_from_path, trace_from_headers

            path = headers.get(":path", "")
            bare = path.split("?", 1)[0]
            # gRPC paths are exactly /package.Service/Method — the
            # 2-segment trim keeps them whole
            endpoint = endpoint_from_path(bare, _N_PATH_SEGMENTS)
            trace = trace_from_headers(headers.get)
            return L7Message(
                protocol=proto,
                msg_type=MSG_REQUEST,
                version="2",
                request_type=headers[":method"],
                request_domain=headers.get(":authority", headers.get("host", "")),
                request_resource=bare,
                endpoint=endpoint,
                request_id=fr.stream_id,
                trace_id=trace[0],
                span_id=trace[1],
            )
        if ":status" in headers or "grpc-status" in headers:
            grpc_status = headers.get("grpc-status")
            raw_code = headers.get(":status") or "0"
            code = int(raw_code) if raw_code.isdigit() else 0
            if grpc_status is not None and grpc_status.isdigit():
                g = int(grpc_status)
                status = STATUS_OK if g == 0 else STATUS_SERVER_ERROR
                code = g if g else code
            else:
                status = (
                    STATUS_CLIENT_ERROR
                    if 400 <= code < 500
                    else STATUS_SERVER_ERROR if code >= 500 else STATUS_OK
                )
            return L7Message(
                protocol=proto,
                msg_type=MSG_RESPONSE,
                version="2",
                status=status,
                status_code=code,
                request_id=fr.stream_id,
            )
        return None  # trailers-only or damaged
    return None
