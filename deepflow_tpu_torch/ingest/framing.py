"""Telemetry wire framing (port copy of deepflow_tpu/ingest/framing.py).

Byte-compatible with the reference's framed TCP/UDP protocol:

  * 19-byte flow header (uniform_sender.rs:110-147): frame_size u32 BE,
    msg_type u8, version u16 LE (0x8000), encoder u8, team_id u32 LE,
    organization_id u16 LE, reserved_1 u16, agent_id u16 LE,
    reserved_2 u8. frame_size counts the whole frame, header included.
  * message-type registry (droplet-message.go:31-88).
  * frame body: back-to-back [len u32 LE][message] records, optionally
    compressed (the header's encoder byte).

The server side parses the header to route by msg_type and extract
org/team/agent identity (receiver.go:631-700 semantics); the receiver's
`FrameReassembler` cuts a TCP stream into frames.
"""

from __future__ import annotations

import dataclasses
import enum
import struct
import zlib

try:  # optional real zstd (not in every image)
    import zstandard as _zstd
except ImportError:  # pragma: no cover - image-dependent
    _zstd = None


class MessageType(enum.IntEnum):
    """droplet-message.go:36-60."""

    COMPRESS = 0
    SYSLOG = 1
    SERVER_DFSTATS = 2
    METRICS = 3
    TAGGEDFLOW = 4
    PROTOCOLLOG = 5
    OPENTELEMETRY = 6
    PROMETHEUS = 7
    TELEGRAF = 8
    PACKETSEQUENCE = 9
    DFSTATS = 10
    OPENTELEMETRY_COMPRESSED = 11
    RAW_PCAP = 12
    PROFILE = 13
    PROC_EVENT = 14
    ALERT_EVENT = 15
    K8S_EVENT = 16
    APPLICATION_LOG = 17
    AGENT_LOG = 18
    SKYWALKING = 19
    DATADOG = 20
    # DFPUSH is this build's extension (like ENCODER_DEFLATE below): the
    # wire delivery plane's cross-host push lane — subscription results
    # and alert notifications routed host → FleetSubscriptionRouter.
    # The reference registry ends at DATADOG=20, so 21 is the first free
    # id; the header ABI is unchanged.
    DFPUSH = 21


HEADER_VERSION = 0x8000
HEADER_LEN = 19

# frame_size is BE; everything after msg_type is LE (uniform_sender.rs
# Header::encode mixes endianness exactly like this).
_HDR_TAIL = struct.Struct("<HBIHHHB")  # version, encoder, team, org, rsvd1, agent, rsvd2


@dataclasses.dataclass
class FlowHeader:
    msg_type: int
    frame_size: int = 0  # filled by encode_frame
    version: int = HEADER_VERSION
    encoder: int = 0  # 0 = raw; compression codecs are negotiated ids
    team_id: int = 0
    organization_id: int = 0
    agent_id: int = 0

    def encode(self) -> bytes:
        return (
            struct.pack(">I", self.frame_size)
            + struct.pack("B", self.msg_type)
            + _HDR_TAIL.pack(
                self.version, self.encoder, self.team_id, self.organization_id, 0, self.agent_id, 0
            )
        )

    @classmethod
    def parse(cls, buf: bytes) -> "FlowHeader":
        if len(buf) < HEADER_LEN:
            raise ValueError(f"short header: {len(buf)} < {HEADER_LEN}")
        (frame_size,) = struct.unpack_from(">I", buf, 0)
        msg_type = buf[4]
        version, encoder, team, org, _r1, agent, _r2 = _HDR_TAIL.unpack_from(buf, 5)
        return cls(
            msg_type=msg_type,
            frame_size=frame_size,
            version=version,
            encoder=encoder,
            team_id=team,
            organization_id=org,
            agent_id=agent,
        )


# Upper bound on one wire frame; shared by sender and receiver so a frame
# that encodes is always accepted (a frame at/over the reassembler's limit
# would otherwise desync the whole stream into byte-wise resync).
MAX_FRAME_SIZE = (1 << 24) - 1


# Body compression codecs carried in the header's encoder byte. The
# reference knows Raw=0 and Zstd=3 (trident.rs:382-387 SenderEncoder;
# compression applied over the whole message buffer before framing,
# uniform_sender.rs:230). Deflate=4 is this build's extension: the image
# has no zstd library, so the always-available zlib codec fills the seat
# behind the same flag mechanism; real zstd engages automatically when
# the `zstandard` module is importable.
ENCODER_RAW = 0
ENCODER_ZSTD = 3
ENCODER_DEFLATE = 4


def best_encoder() -> int:
    """The strongest codec this process can both encode and decode."""
    return ENCODER_ZSTD if _zstd is not None else ENCODER_DEFLATE


def compress_body(body: bytes, encoder: int) -> bytes:
    if encoder == ENCODER_RAW:
        return body
    if encoder == ENCODER_ZSTD:
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this image")
        return _zstd.ZstdCompressor().compress(body)
    if encoder == ENCODER_DEFLATE:
        return zlib.compress(body, level=1)
    raise ValueError(f"unknown encoder {encoder}")


def decompress_body(body: bytes, encoder: int, max_size: int = MAX_FRAME_SIZE) -> bytes:
    """Inverse of compress_body, with a decompressed-size bound so a
    malicious/corrupt frame cannot balloon memory (zip-bomb guard)."""
    if encoder == ENCODER_RAW:
        return body
    if encoder == ENCODER_ZSTD:
        if _zstd is None:
            raise ValueError("zstd codec unavailable in this image")
        return _zstd.ZstdDecompressor().decompress(body, max_output_size=max_size)
    if encoder == ENCODER_DEFLATE:
        d = zlib.decompressobj()
        out = d.decompress(body, max_size)
        if d.unconsumed_tail:
            raise ValueError(f"decompressed frame exceeds {max_size} bytes")
        return out
    raise ValueError(f"unknown encoder {encoder}")


def encode_frame(
    header: FlowHeader, messages: list[bytes], encoder: int = ENCODER_RAW
) -> bytes:
    """One wire frame: header + [len u32 LE][pb] per message; the body is
    compressed when `encoder` names a codec (header.encoder records it)."""
    body = b"".join(struct.pack("<I", len(m)) + m for m in messages)
    if encoder != ENCODER_RAW:
        body = compress_body(body, encoder)
    header.encoder = encoder
    frame_size = HEADER_LEN + len(body)
    if frame_size > MAX_FRAME_SIZE:
        raise ValueError(
            f"frame too large: {frame_size} > {MAX_FRAME_SIZE}; batch fewer messages"
        )
    header.frame_size = frame_size
    return header.encode() + body


def split_messages(payload: bytes) -> list[bytes]:
    """Frame body → message list (inverse of encode_frame's body)."""
    return [payload[o:o + ln] for o, ln in split_message_spans(payload)]


def split_message_spans(payload: bytes) -> list[tuple[int, int]]:
    """Frame body → [(offset, len)] of each message, without
    materializing slices (the decoders read the buffer at these spans)."""
    spans = []
    off = 0
    n = len(payload)
    while off + 4 <= n:
        (size,) = struct.unpack_from("<I", payload, off)
        off += 4
        if off + size > n:
            raise ValueError(f"truncated message at {off}: need {size}, have {n - off}")
        spans.append((off, size))
        off += size
    if off != n:
        raise ValueError(f"trailing garbage: {n - off} bytes")
    return spans


class FrameReassembler:
    """Incremental TCP stream → frames (the receiver's flow-header scan,
    receiver.go:515-585). Feed arbitrary chunks; yields (header, body)."""

    def __init__(self, max_frame: int = MAX_FRAME_SIZE + 1):
        self._buf = bytearray()
        self.max_frame = max_frame
        self.bad_frames = 0

    def feed(self, chunk: bytes) -> list[tuple[FlowHeader, bytes]]:
        self._buf += chunk
        frames = []
        while True:
            if len(self._buf) < HEADER_LEN:
                return frames
            header = FlowHeader.parse(bytes(self._buf[:HEADER_LEN]))
            if (
                header.frame_size < HEADER_LEN
                or header.frame_size >= self.max_frame
                or header.version != HEADER_VERSION
            ):
                # resync: drop one byte (malformed stream)
                self.bad_frames += 1
                del self._buf[0]
                continue
            if len(self._buf) < header.frame_size:
                return frames
            body = bytes(self._buf[HEADER_LEN : header.frame_size])
            del self._buf[: header.frame_size]
            frames.append((header, body))
