"""Third-party trace imports: SkyWalking segments + Datadog traces.

The reference converts both formats into L7FlowLog spans inside the
flow_log decoder (decoder.go:289 handleSkyWalking, :338 handleDatadog;
converters under log_data/sw_import and log_data/dd_import). Same target
here: each import yields the OtelSpan shape the OTel lane already turns
into l7_flow_log rows + trace-tree spans, so every downstream plane
(tables, tracing, RED metrics) is shared.

Wire formats, from the public protocols:
  * SkyWalking: SegmentObject protobuf (skywalking-data-collect-protocol
    language-agent/Tracing.proto v3): traceId=1, traceSegmentId=2,
    spans=3[SpanObject], service=4, serviceInstance=5. SpanObject:
    spanId=1, parentSpanId=2 (i32, -1 = root), startTime=3 ms,
    endTime=4 ms, refs=5[SegmentReference{refType=1, traceId=2,
    parentTraceSegmentId=3, parentSpanId=4}], operationName=6, peer=7,
    spanType=8 (0 Entry/1 Exit/2 Local), spanLayer=9, componentId=10,
    isError=11, tags=12[KeyStringValuePair{key=1, value=2}].
  * Datadog: the MsgPack v0.4 trace payload is out of scope without a
    msgpack codec in-image; the JSON form (array of arrays of spans with
    trace_id/span_id/parent_id/service/name/resource/start/duration/
    error/meta) decodes natively and is what our collector accepts.

Port copy of deepflow_tpu/integration/trace_imports.py.
"""

from __future__ import annotations

import json

from .formats import OtelSpan, _iter_fields, _zigzag_free_i64


def _pb_str(v) -> str:
    return bytes(v).decode("utf-8", "replace")


def _parse_sw_span(buf: bytes) -> dict:
    s = {
        "span_id": 0, "parent_span_id": -1, "start_ms": 0, "end_ms": 0,
        "op": "", "is_error": False, "span_type": 0, "refs_parent": "",
        "peer": "", "tags": {},
    }
    for f, v in _iter_fields(buf):
        if f == 1:
            s["span_id"] = _zigzag_free_i64(v)
        elif f == 2:
            s["parent_span_id"] = _zigzag_free_i64(v)
        elif f == 3:
            s["start_ms"] = _zigzag_free_i64(v)
        elif f == 4:
            s["end_ms"] = _zigzag_free_i64(v)
        elif f == 5 and isinstance(v, (bytes, bytearray, memoryview)):
            # SegmentReference: parentTraceSegmentId=3 (string),
            # parentSpanId=4
            ref_seg, ref_span = "", -1
            for rf, rv in _iter_fields(bytes(v)):
                if rf == 3 and isinstance(rv, (bytes, bytearray, memoryview)):
                    ref_seg = _pb_str(rv)
                elif rf == 4 and not isinstance(rv, (bytes, bytearray, memoryview)):
                    ref_span = _zigzag_free_i64(rv)
            if ref_seg:
                s["refs_parent"] = f"{ref_seg}-{ref_span}"
        elif f == 6 and isinstance(v, (bytes, bytearray, memoryview)):
            s["op"] = _pb_str(v)
        elif f == 7 and isinstance(v, (bytes, bytearray, memoryview)):
            s["peer"] = _pb_str(v)
        elif f == 8:
            s["span_type"] = _zigzag_free_i64(v)
        elif f == 11:
            s["is_error"] = bool(_zigzag_free_i64(v))
        elif f == 12 and isinstance(v, (bytes, bytearray, memoryview)):
            k = val = ""
            for tf, tv in _iter_fields(bytes(v)):
                if tf == 1:
                    k = _pb_str(tv)
                elif tf == 2:
                    val = _pb_str(tv)
            if k:
                s["tags"][k] = val
    return s


def parse_skywalking_segment(data: bytes) -> list[OtelSpan]:
    """SegmentObject pb → OtelSpans (sw_import seat). Span ids are
    segment-scoped in SkyWalking, so wire ids are '<segment>-<span_id>';
    cross-segment parents come from SegmentReference."""
    trace_id = segment_id = service = instance = ""
    raw_spans = []
    try:
        for f, v in _iter_fields(data):
            if f == 1 and isinstance(v, (bytes, bytearray, memoryview)):
                trace_id = _pb_str(v)
            elif f == 2 and isinstance(v, (bytes, bytearray, memoryview)):
                segment_id = _pb_str(v)
            elif f == 3 and isinstance(v, (bytes, bytearray, memoryview)):
                raw_spans.append(_parse_sw_span(bytes(v)))
            elif f == 4 and isinstance(v, (bytes, bytearray, memoryview)):
                service = _pb_str(v)
            elif f == 5 and isinstance(v, (bytes, bytearray, memoryview)):
                instance = _pb_str(v)
    except Exception:
        return []
    if not trace_id or not raw_spans:
        return []
    out = []
    for s in raw_spans:
        if s["parent_span_id"] >= 0:
            parent = f"{segment_id}-{s['parent_span_id']}"
        else:
            parent = s["refs_parent"]  # cross-segment or root
        out.append(
            OtelSpan(
                service=service,
                name=s["op"],
                trace_id=trace_id,
                span_id=f"{segment_id}-{s['span_id']}",
                parent_span_id=parent,
                kind=3 if s["span_type"] == 1 else 2,  # Exit→client
                start_us=s["start_ms"] * 1000,
                end_us=s["end_ms"] * 1000,
                status_code=2 if s["is_error"] else 0,
                attributes={
                    **s["tags"],
                    **({"sw8.instance": instance} if instance else {}),
                    **({"net.peer.name": s["peer"]} if s["peer"] else {}),
                },
            )
        )
    return out


def parse_datadog_traces(data: bytes) -> list[OtelSpan]:
    """Datadog JSON trace payload → OtelSpans (dd_import seat)."""
    try:
        payload = json.loads(data)
    except (ValueError, UnicodeDecodeError):
        return []
    if not isinstance(payload, list):
        return []
    out = []
    for trace in payload:
        if not isinstance(trace, list):
            continue
        for sp in trace:
            if not isinstance(sp, dict):
                continue
            try:
                meta = sp.get("meta") or {}
                if not isinstance(meta, dict):
                    meta = {}
                start_ns = int(sp.get("start") or 0)
                dur_ns = int(sp.get("duration") or 0)
                out.append(
                    OtelSpan(
                        service=str(sp.get("service", "")),
                        name=str(sp.get("resource", sp.get("name", ""))),
                        trace_id=format(int(sp.get("trace_id") or 0), "032x"),
                        span_id=format(int(sp.get("span_id") or 0), "016x"),
                        parent_span_id=(
                            format(int(sp["parent_id"]), "016x")
                            if sp.get("parent_id")
                            else ""
                        ),
                        kind=3 if meta.get("span.kind") == "client" else 2,
                        start_us=start_ns // 1000,
                        end_us=(start_ns + dur_ns) // 1000,
                        status_code=2 if int(sp.get("error") or 0) else 0,
                        attributes={str(k): str(v) for k, v in meta.items()},
                    )
                )
            except (TypeError, ValueError):
                continue  # one malformed span must not drop its siblings
    return out
