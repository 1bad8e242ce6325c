"""metric.proto Document codec — wire-compatible, dependency-free.
Port copy of deepflow_tpu/ingest/codec.py.

Hand-rolled proto3 wire format (varint + length-delimited submessages)
for the Document message tree of message/metric.proto:14-196:

    Document{timestamp=1, tag=2 (MiniTag{field=1 MiniField, code=2}),
             meter=3 (Meter{meter_id=1, flow=2, usage=3, app=4}),
             flags=4}

Field ids below cite metric.proto exactly; the agent-side encoder this
must interoperate with is document.rs:363-418 + meter pb impls. Encoding
walks DocBatch rows; decoding fills SoA columns. This is the reference
implementation the JAX package's native C++ decoder must match —
the Python path stays as the conformance oracle for it.

Strings (app_service/app_instance/endpoint) are dictionary-encoded at
decode into a per-batch StringDict (SmartEncoding boundary, flow_tag
pattern): the device only ever sees endpoint_hash / service ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..datamodel.batch import DocBatch
from ..datamodel.code import CODE_OF_ID, CodeId, MeterId
from ..datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA, USAGE_METER, MeterSchema
from ..ops.hashing import fingerprint64_np

_T = TAG_SCHEMA

# ---------------------------------------------------------------------------
# proto3 wire primitives

_VARINT = 0
_LEN = 2


def _put_varint(buf: bytearray, v: int):
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _get_varint(buf: bytes, off: int) -> tuple[int, int]:
    out = 0
    shift = 0
    n = len(buf)
    while True:
        if off >= n:
            # truncated input is a rejected frame, same as overflow —
            # decoders at the untrusted edge catch ValueError uniformly
            raise ValueError("truncated varint")
        b = buf[off]
        off += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, off
        shift += 7
        if shift >= 70:
            raise ValueError("varint overflow")


def _put_tag_varint(buf: bytearray, field: int, v: int):
    if v:
        _put_varint(buf, field << 3 | _VARINT)
        _put_varint(buf, v)


def _put_tag_i32(buf: bytearray, field: int, v: int):
    """proto3 int32: negatives as 10-byte two's-complement varint."""
    if v:
        _put_varint(buf, field << 3 | _VARINT)
        _put_varint(buf, v & ((1 << 64) - 1) if v < 0 else v)


def _put_tag_bytes(buf: bytearray, field: int, v: bytes):
    if v:
        _put_varint(buf, field << 3 | _LEN)
        _put_varint(buf, len(v))
        buf += v


# unconditional writers (the _put_tag_* family skips falsy values —
# encoders that must emit zero/empty fields use these). THE shared
# protobuf writer helpers: formats.py and trident_grpc.py import them.
def pb_varint(out: bytearray, field: int, v: int) -> None:
    _put_varint(out, field << 3 | 0)
    _put_varint(out, int(v) & ((1 << 64) - 1))


def pb_bytes(out: bytearray, field: int, b: bytes) -> None:
    _put_varint(out, field << 3 | _LEN)
    _put_varint(out, len(b))
    out += b


def pb_str(out: bytearray, field: int, s: str) -> None:
    pb_bytes(out, field, s.encode())


def pb_fixed64(out: bytearray, field: int, v: int) -> None:
    _put_varint(out, field << 3 | 1)
    out += (int(v) & ((1 << 64) - 1)).to_bytes(8, "little")


def _iter_fields(buf: bytes):
    off = 0
    n = len(buf)
    while off < n:
        key, off = _get_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, off = _get_varint(buf, off)
            yield field, v
        elif wire == _LEN:
            size, off = _get_varint(buf, off)
            yield field, buf[off : off + size]
            off += size
        elif wire == 5:  # fixed32
            yield field, int.from_bytes(buf[off : off + 4], "little")
            off += 4
        elif wire == 1:  # fixed64
            yield field, int.from_bytes(buf[off : off + 8], "little")
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")


# ---------------------------------------------------------------------------
# meter layout tables: column name → (submessage field id, field id)
# (metric.proto:70-196)

FLOW_METER_LAYOUT: dict[str, tuple[int, int]] = {
    # Traffic = 1
    "packet_tx": (1, 1), "packet_rx": (1, 2), "byte_tx": (1, 3), "byte_rx": (1, 4),
    "l3_byte_tx": (1, 5), "l3_byte_rx": (1, 6), "l4_byte_tx": (1, 7), "l4_byte_rx": (1, 8),
    "new_flow": (1, 9), "closed_flow": (1, 10), "l7_request": (1, 11), "l7_response": (1, 12),
    "syn": (1, 13), "synack": (1, 14), "direction_score": (1, 15),
    # Latency = 2
    "rtt_max": (2, 1), "rtt_client_max": (2, 2), "rtt_server_max": (2, 3), "srt_max": (2, 4),
    "art_max": (2, 5), "rrt_max": (2, 6), "cit_max": (2, 19),
    "rtt_sum": (2, 7), "rtt_client_sum": (2, 8), "rtt_server_sum": (2, 9), "srt_sum": (2, 10),
    "art_sum": (2, 11), "rrt_sum": (2, 12), "cit_sum": (2, 20),
    "rtt_count": (2, 13), "rtt_client_count": (2, 14), "rtt_server_count": (2, 15),
    "srt_count": (2, 16), "art_count": (2, 17), "rrt_count": (2, 18), "cit_count": (2, 21),
    # Performance = 3
    "retrans_tx": (3, 1), "retrans_rx": (3, 2), "zero_win_tx": (3, 3), "zero_win_rx": (3, 4),
    "retrans_syn": (3, 5), "retrans_synack": (3, 6),
    # Anomaly = 4
    "client_rst_flow": (4, 1), "server_rst_flow": (4, 2), "server_syn_miss": (4, 3),
    "client_ack_miss": (4, 4), "client_half_close_flow": (4, 5), "server_half_close_flow": (4, 6),
    "client_source_port_reuse": (4, 7), "client_establish_reset": (4, 8), "server_reset": (4, 9),
    "server_queue_lack": (4, 10), "server_establish_reset": (4, 11), "tcp_timeout": (4, 12),
    "l7_client_error": (4, 13), "l7_server_error": (4, 14), "l7_timeout": (4, 15),
    # FlowLoad = 5. flow_count is a framework-internal column (the
    # commutative flow_load model, schema.py) — not on the wire.
    "flow_load": (5, 1),
}

APP_METER_LAYOUT: dict[str, tuple[int, int]] = {
    # AppTraffic = 1
    "request": (1, 1), "response": (1, 2), "direction_score": (1, 3),
    # AppLatency = 2
    "rrt_max": (2, 1), "rrt_sum": (2, 2), "rrt_count": (2, 3),
    # AppAnomaly = 3
    "client_error": (3, 1), "server_error": (3, 2), "timeout": (3, 3),
}

USAGE_METER_LAYOUT: dict[str, tuple[int, int]] = {
    # UsageMeter is flat (metric.proto:160-169): submessage id 0 = flat
    "packet_tx": (0, 1), "packet_rx": (0, 2), "byte_tx": (0, 3), "byte_rx": (0, 4),
    "l3_byte_tx": (0, 5), "l3_byte_rx": (0, 6), "l4_byte_tx": (0, 7), "l4_byte_rx": (0, 8),
}

# Meter.{flow=2, usage=3, app=4} (metric.proto:71-76)
_METER_OF_ID = {
    int(MeterId.FLOW): (2, FLOW_METER, FLOW_METER_LAYOUT),
    int(MeterId.USAGE): (3, USAGE_METER, USAGE_METER_LAYOUT),
    int(MeterId.APP): (4, APP_METER, APP_METER_LAYOUT),
}

_ID_OF_CODE = {int(v): k for k, v in CODE_OF_ID.items()}


@dataclasses.dataclass
class StringDict:
    """Per-batch string dictionary (SmartEncoding sidecar): value → id."""

    values: list[str] = dataclasses.field(default_factory=list)
    _index: dict[str, int] = dataclasses.field(default_factory=dict)

    def intern(self, s: str) -> int:
        """0 is reserved for the empty string."""
        if not s:
            return 0
        i = self._index.get(s)
        if i is None:
            i = len(self.values) + 1
            self.values.append(s)
            self._index[s] = i
        return i

    def lookup(self, i: int) -> str:
        return "" if i == 0 else self.values[i - 1]


def _hash_str(s: str) -> int:
    """Stable u32 fingerprint for strings entering tag columns (the
    agent's endpoint_hash role)."""
    if not s:
        return 0
    data = s.encode()
    pad = (-len(data)) % 4
    words = np.frombuffer(data + b"\0" * pad, dtype="<u4").reshape(1, -1)
    hi, _ = fingerprint64_np(words)
    return int(hi[0])


# ---------------------------------------------------------------------------
# encode


def _encode_minifield(tag_row, strings: dict[str, str]) -> bytes:
    t = lambda name: int(tag_row[_T.index(name)])
    buf = bytearray()
    is_v6 = t("is_ipv6")
    if is_v6:
        ip = b"".join(int(t(f"ip0_w{w}")).to_bytes(4, "big") for w in range(4))
        ip1 = b"".join(int(t(f"ip1_w{w}")).to_bytes(4, "big") for w in range(4))
    else:
        ip = t("ip0_w3").to_bytes(4, "big")
        ip1 = t("ip1_w3").to_bytes(4, "big")
    _put_tag_bytes(buf, 1, ip if any(ip) else b"")
    _put_tag_bytes(buf, 2, ip1 if any(ip1) else b"")
    _put_tag_varint(buf, 3, t("global_thread_id"))
    _put_tag_varint(buf, 4, is_v6)

    def unfold_epc(v):  # u16 sign-fold → i32
        return v - 0x10000 if v >= 0x8000 else v

    _put_tag_i32(buf, 5, unfold_epc(t("l3_epc_id")))
    _put_tag_i32(buf, 6, unfold_epc(t("l3_epc_id1")))
    _put_tag_varint(buf, 7, t("mac0_hi") << 32 | t("mac0_lo"))
    _put_tag_varint(buf, 8, t("mac1_hi") << 32 | t("mac1_lo"))
    _put_tag_varint(buf, 9, t("direction"))
    _put_tag_varint(buf, 10, t("tap_side"))
    _put_tag_varint(buf, 11, t("protocol"))
    _put_tag_varint(buf, 12, t("acl_gid"))
    _put_tag_varint(buf, 13, t("server_port"))
    _put_tag_varint(buf, 14, t("agent_id"))  # vtap_id
    _put_tag_varint(buf, 15, t("tap_port"))
    _put_tag_varint(buf, 16, t("tap_type"))
    _put_tag_varint(buf, 17, t("l7_protocol"))
    _put_tag_varint(buf, 20, t("gpid0"))
    _put_tag_varint(buf, 21, t("gpid1"))
    _put_tag_varint(buf, 22, t("signal_source"))
    _put_tag_bytes(buf, 23, strings.get("app_service", "").encode())
    _put_tag_bytes(buf, 24, strings.get("app_instance", "").encode())
    _put_tag_bytes(buf, 25, strings.get("endpoint", "").encode())
    _put_tag_varint(buf, 27, t("pod_id"))
    _put_tag_varint(buf, 28, t("biz_type"))
    return bytes(buf)


def _encode_meter(meter_row, meter_id: int) -> bytes:
    sub_field, schema, layout = _METER_OF_ID[meter_id]
    subs: dict[int, bytearray] = {}
    flat = bytearray()
    _put_tag_varint(flat, 1, meter_id)
    for i, f in enumerate(schema.fields):
        loc = layout.get(f.name)
        if loc is None:
            continue
        sub, fid = loc
        v = int(meter_row[i])
        if not v:
            continue
        if sub == 0:
            target = subs.setdefault(-1, bytearray())
        else:
            target = subs.setdefault(sub, bytearray())
        _put_tag_varint(target, fid, v)
    inner = bytearray()
    if -1 in subs:  # flat UsageMeter
        inner += subs[-1]
    else:
        for sub in sorted(subs):
            _put_tag_bytes(inner, sub, bytes(subs[sub]))
    _put_tag_bytes(flat, sub_field, bytes(inner))
    return bytes(flat)


def encode_document(
    timestamp: int,
    tag_row,
    meter_row,
    flags: int = 0,
    strings: dict[str, str] | None = None,
) -> bytes:
    """One DocBatch row → Document pb bytes."""
    meter_id = int(tag_row[_T.index("meter_id")])
    code = int(CODE_OF_ID.get(CodeId(int(tag_row[_T.index("code_id")])), 0))
    minitag = bytearray()
    _put_tag_bytes(minitag, 1, _encode_minifield(tag_row, strings or {}))
    _put_tag_varint(minitag, 2, code)

    buf = bytearray()
    _put_tag_varint(buf, 1, int(timestamp))
    _put_tag_bytes(buf, 2, bytes(minitag))
    _put_tag_bytes(buf, 3, _encode_meter(meter_row, meter_id))
    _put_tag_varint(buf, 4, int(flags))
    return bytes(buf)


def encode_docbatch(db: DocBatch, flags: int = 0) -> list[bytes]:
    return [
        encode_document(db.timestamp[i], db.tags[i], db.meters[i], flags)
        for i in range(db.size)
        if db.valid[i]
    ]


# ---------------------------------------------------------------------------
# decode


@dataclasses.dataclass
class DecodedBatch:
    """SoA decode result for one meter type."""

    meter_id: int
    meter_schema: MeterSchema
    tags: np.ndarray  # [N, T] u32
    meters: np.ndarray  # [N, M] f32
    timestamp: np.ndarray  # [N] u32
    flags: np.ndarray  # [N] u32
    strings: StringDict
    # per-row string dictionary ids (app_service/app_instance/endpoint)
    service_ids: np.ndarray  # [N, 3] u32

    def to_docbatch(self) -> DocBatch:
        return DocBatch(
            tags=self.tags,
            meters=self.meters,
            timestamp=self.timestamp,
            valid=np.ones(self.tags.shape[0], dtype=bool),
            tag_schema=_T,
            meter_schema=self.meter_schema,
        )


class DocumentDecoder:
    """pb Documents → per-meter SoA batches (the DecodePB hot loop,
    libs/app/codec.go:28, reimplemented columnar)."""

    def __init__(self):
        self.decode_errors = 0
        self.unknown_codes = 0

    def decode_parts(
        self, parts: list[tuple[bytes, list[tuple[int, int]]]]
    ) -> dict[int, DecodedBatch]:
        """Span-based twin of NativeDocumentDecoder.decode_parts (the
        Python path still slices — it is the fallback, not the fast
        path)."""
        msgs = [body[o:o + ln] for body, spans in parts for o, ln in spans]
        return self.decode(msgs)

    def decode(self, messages: list[bytes]) -> dict[int, DecodedBatch]:
        rows: dict[int, list] = {}
        strings = StringDict()
        for msg in messages:
            try:
                row = self._decode_one(msg, strings)
            except Exception:
                # hostile/corrupt wire data must never kill the batch —
                # count and continue (unmarshaller.go decode_errors stance)
                self.decode_errors += 1
                continue
            rows.setdefault(row[0], []).append(row)

        out = {}
        for meter_id, rlist in rows.items():
            _, schema, _ = _METER_OF_ID[meter_id]
            n = len(rlist)
            tags = np.zeros((n, _T.num_fields), dtype=np.uint32)
            meters = np.zeros((n, schema.num_fields), dtype=np.float32)
            ts = np.zeros(n, dtype=np.uint32)
            flags = np.zeros(n, dtype=np.uint32)
            service_ids = np.zeros((n, 3), dtype=np.uint32)
            for i, (_, t, tag_vec, meter_vec, fl, sids) in enumerate(rlist):
                ts[i] = t
                tags[i] = tag_vec
                meters[i] = meter_vec
                flags[i] = fl
                service_ids[i] = sids
            out[meter_id] = DecodedBatch(
                meter_id=meter_id,
                meter_schema=schema,
                tags=tags,
                meters=meters,
                timestamp=ts,
                flags=flags,
                strings=strings,
                service_ids=service_ids,
            )
        return out

    def _decode_one(self, msg: bytes, strings: StringDict):
        ts = 0
        flags = 0
        minitag = b""
        meter_buf = b""
        for field, v in _iter_fields(msg):
            if field == 1:
                ts = v & 0xFFFFFFFF  # native twin masks to u32 too
            elif field == 2:
                minitag = v
            elif field == 3:
                meter_buf = v
            elif field == 4:
                flags = v & 0xFFFFFFFF

        code = 0
        minifield = b""
        for field, v in _iter_fields(minitag):
            if field == 1:
                minifield = v
            elif field == 2:
                code = v

        tag_vec = np.zeros(_T.num_fields, dtype=np.uint32)
        sids = np.zeros(3, dtype=np.uint32)
        raw_strs: dict[int, str] = {}

        def set_tag(name, v):
            tag_vec[_T.index(name)] = v & 0xFFFFFFFF

        for field, v in _iter_fields(minifield):
            if field == 1 or field == 2:
                pre = "ip0" if field == 1 else "ip1"
                b = v
                if len(b) == 4:
                    set_tag(f"{pre}_w3", int.from_bytes(b, "big"))
                elif len(b) == 16:
                    for w in range(4):
                        set_tag(f"{pre}_w{w}", int.from_bytes(b[w * 4 : w * 4 + 4], "big"))
            elif field == 3:
                set_tag("global_thread_id", v)
            elif field == 4:
                set_tag("is_ipv6", v)
            elif field in (5, 6):
                # i32 sign-fold back to u16 (schema.py TAG_SCHEMA note)
                iv = v - (1 << 64) if v >> 63 else v
                set_tag("l3_epc_id" if field == 5 else "l3_epc_id1", iv & 0xFFFF)
            elif field == 7:
                set_tag("mac0_hi", v >> 32)
                set_tag("mac0_lo", v & 0xFFFFFFFF)
            elif field == 8:
                set_tag("mac1_hi", v >> 32)
                set_tag("mac1_lo", v & 0xFFFFFFFF)
            elif field == 9:
                set_tag("direction", v)
            elif field == 10:
                set_tag("tap_side", v)
            elif field == 11:
                set_tag("protocol", v)
            elif field == 12:
                set_tag("acl_gid", v)
            elif field == 13:
                set_tag("server_port", v)
            elif field == 14:
                set_tag("agent_id", v)
            elif field == 15:
                set_tag("tap_port", v)
            elif field == 16:
                set_tag("tap_type", v)
            elif field == 17:
                set_tag("l7_protocol", v)
            elif field == 20:
                set_tag("gpid0", v)
            elif field == 21:
                set_tag("gpid1", v)
            elif field == 22:
                set_tag("signal_source", v)
            elif field in (23, 24, 25):
                # defer interning until the row fully decodes — a row that
                # errors later must not pollute the shared StringDict (the
                # native decoder skips error rows entirely)
                s = v.decode(errors="replace")
                raw_strs[field - 23] = s
                if field == 25:
                    set_tag("endpoint_hash", _hash_str(s))
            elif field == 27:
                set_tag("pod_id", v)
            elif field == 28:
                set_tag("biz_type", v)

        code_id = _ID_OF_CODE.get(code)
        if code_id is None:
            self.unknown_codes += 1
            code_id = CodeId.NONE
        set_tag("code_id", int(code_id))

        meter_id = 0
        sub_bufs: dict[int, bytes] = {}
        for field, v in _iter_fields(meter_buf):
            if field == 1:
                meter_id = v
            elif isinstance(v, (bytes, bytearray)):
                sub_bufs[field] = v
        if meter_id not in _METER_OF_ID:
            raise ValueError(f"unknown meter_id {meter_id}")
        sub_field, schema, layout = _METER_OF_ID[meter_id]
        set_tag("meter_id", meter_id)

        meter_vec = np.zeros(schema.num_fields, dtype=np.float32)
        inner = sub_bufs.get(sub_field, b"")
        rev = {loc: name for name, loc in layout.items()}
        if meter_id == int(MeterId.USAGE):
            for fid, v in _iter_fields(inner):
                name = rev.get((0, fid))
                if name:
                    meter_vec[schema.index(name)] = v
        else:
            for sub, subbuf in _iter_fields(inner):
                if not isinstance(subbuf, (bytes, bytearray)):
                    continue
                for fid, v in _iter_fields(subbuf):
                    name = rev.get((sub, fid))
                    if name:
                        meter_vec[schema.index(name)] = v

        for j, s in raw_strs.items():
            sids[j] = strings.intern(s)
        return meter_id, ts, tag_vec, meter_vec, flags, sids
