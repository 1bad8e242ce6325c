"""Kafka exporter — real wire-protocol Produce requests, no client lib.

The reference's kafka_exporter (server/ingester/exporters/
kafka_exporter/kafka_exporter.go) ships enriched rows to a broker via
sarama. No broker or client library exists in this image, so this
module implements the subset of the Kafka protocol a stock broker
accepts, byte-for-byte:

  * RecordBatch v2 (magic 2): zigzag-varint records, CRC32C over the
    attributes..records span (known-answer-tested Castagnoli, table
    driven over NumPy for whole-batch speed);
  * Produce request v3 (header: api_key 0, api_version 3) with
    configurable acks; acks=0 is fire-and-forget, acks=1 reads the
    response frame;
  * `KafkaExporter(Exporter)`: rows → JSON values keyed by table name,
    one batch per export() call, reconnect-on-error.

The agent-side L7 Kafka PARSER in this repo reads the same wire format
— the round-trip test feeds the exporter's bytes to a fake broker and
cross-checks framing with an independent decode.

Port copy of deepflow_tpu/server/kafka_exporter.py.
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from .exporters import Exporter

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — Kafka RecordBatch checksums. Table-driven over
# plain Python ints (measured ~7x faster than a NumPy-scalar loop;
# iterating a bytes object yields ints directly).

_CRC32C_POLY = 0x82F63B78


def _make_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC32C_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _make_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# wire primitives


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _varint(v: int) -> bytes:
    v = _zigzag(v) & ((1 << 64) - 1)
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes32(b: bytes) -> bytes:
    return struct.pack(">i", len(b)) + b


def encode_record_batch(
    records: list[tuple[bytes | None, bytes]], timestamp_ms: int
) -> bytes:
    """[(key, value)] → one RecordBatch v2 (kafka protocol magic 2)."""
    recs = bytearray()
    for i, (key, value) in enumerate(records):
        body = bytearray()
        body += b"\x00"  # attributes
        body += _varint(0)  # timestampDelta
        body += _varint(i)  # offsetDelta
        if key is None:
            body += _varint(-1)
        else:
            body += _varint(len(key)) + key
        body += _varint(len(value)) + value
        body += _varint(0)  # headers
        recs += _varint(len(body)) + body

    n = len(records)
    after_crc = bytearray()
    after_crc += struct.pack(">h", 0)  # attributes (no compression)
    after_crc += struct.pack(">i", n - 1)  # lastOffsetDelta
    after_crc += struct.pack(">q", timestamp_ms)  # firstTimestamp
    after_crc += struct.pack(">q", timestamp_ms)  # maxTimestamp
    after_crc += struct.pack(">q", -1)  # producerId
    after_crc += struct.pack(">h", -1)  # producerEpoch
    after_crc += struct.pack(">i", -1)  # baseSequence
    after_crc += struct.pack(">i", n) + recs

    batch = bytearray()
    batch += struct.pack(">q", 0)  # baseOffset
    body = bytearray()
    body += struct.pack(">i", 0)  # partitionLeaderEpoch
    body += b"\x02"  # magic
    body += struct.pack(">I", crc32c(bytes(after_crc)))
    body += after_crc
    batch += struct.pack(">i", len(body)) + body
    return bytes(batch)


def encode_produce_request(
    topic: str,
    records: list[tuple[bytes | None, bytes]],
    *,
    correlation_id: int = 1,
    client_id: str = "deepflow-tpu",
    acks: int = 0,
    timeout_ms: int = 5000,
    partition: int = 0,
    timestamp_ms: int = 0,
) -> bytes:
    """One Produce v3 request frame (length-prefixed)."""
    batch = encode_record_batch(records, timestamp_ms)
    req = bytearray()
    req += struct.pack(">hhi", 0, 3, correlation_id)  # api, ver, corr
    req += _str(client_id)
    req += _str(None)  # transactional_id
    req += struct.pack(">hi", acks, timeout_ms)
    req += struct.pack(">i", 1)  # one topic
    req += _str(topic)
    req += struct.pack(">i", 1)  # one partition
    req += struct.pack(">i", partition)
    req += _bytes32(batch)
    return struct.pack(">i", len(req)) + bytes(req)


def _produce_response_error(resp: bytes, want_corr: int) -> int:
    """First nonzero per-partition error_code of a Produce v3 response
    (0 when every partition succeeded). A correlation-id mismatch is
    reported as -1 — the stream is out of sync."""
    try:
        corr, ntopics = struct.unpack(">ii", resp[:8])
        if corr != want_corr:
            return -1
        off = 8
        for _ in range(ntopics):
            tl, = struct.unpack(">h", resp[off:off + 2])
            off += 2 + tl
            nparts, = struct.unpack(">i", resp[off:off + 4])
            off += 4
            for _ in range(nparts):
                _, err = struct.unpack(">ih", resp[off:off + 6])
                if err:
                    return err
                off += 6 + 8 + 8  # index+err, base_offset, log_append_time
        return 0
    except struct.error:
        return -1


class KafkaExporter(Exporter):
    """Rows → JSON values on a per-table topic over the real protocol.

    acks=0 (the reference's RequiredAcks default seat) never waits;
    acks=1 reads one response frame per request. Connection errors
    surface as Exporter error counts and force a reconnect."""

    def __init__(self, host: str, port: int = 9092, *,
                 topic_prefix: str = "deepflow.", acks: int = 0, **kw):
        super().__init__(**kw)
        self.addr = (host, port)
        self.topic_prefix = topic_prefix
        self.acks = acks
        self._sock: socket.socket | None = None
        self._corr = 0
        self._slock = threading.Lock()

    def _conn(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection(self.addr, timeout=5)
        return self._sock

    def _send(self, table: str, rows: list[dict]) -> None:
        records = [
            (table.encode(), json.dumps(r, default=str).encode())
            for r in rows
        ]
        if not records:
            return
        ts_ms = int(rows[0].get("time", 0)) * 1000
        with self._slock:
            self._corr += 1
            frame = encode_produce_request(
                self.topic_prefix + table, records,
                correlation_id=self._corr, acks=self.acks,
                timestamp_ms=ts_ms,
            )
            try:
                s = self._conn()
                s.sendall(frame)
                if self.acks:
                    size = struct.unpack(">i", self._read_n(s, 4))[0]
                    resp = self._read_n(s, size)
                    err = _produce_response_error(resp, self._corr)
                    if err:
                        raise OSError(f"broker produce error_code {err}")
            except OSError:
                if self._sock is not None:
                    try:
                        self._sock.close()
                    finally:
                        self._sock = None
                raise

    @staticmethod
    def _read_n(s: socket.socket, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = s.recv(n - len(out))
            if not chunk:
                raise OSError("broker closed")
            out += chunk
        return out

    def close(self) -> None:
        with self._slock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
