"""Flow-log column registries.

Port copy of deepflow_tpu/flowlog/schema.py.

Unlike metric Documents (pure SUM/MAX meters), flow-log rows need richer
merge classes when the minute aggregator folds per-second TaggedFlow
emissions of one flow into a single log row (flow_aggr.rs:216
minute_merge): identity columns keep the first value, lifecycle columns
the *latest* (close_type/status follow the flow's last state), times are
MIN/MAX, counters SUM, TCP flags OR. Each column declares its class here
and the device kernel derives its reduction — same declarative pattern as
datamodel/schema.py.

Device layout: `ints` [N, Ki] u32 (FIRST/LAST/MIN/MAX/OR) and `nums`
[N, Kn] f32 (SUM/MAX). f32 counters are exact to 2^24 per flow·minute
(ARCHITECTURE §5 exactness stance; flow-log sums never cross windows).
String columns are host-side only (wire + storage, never on device).

Column sets abridge the reference's row models
(server/ingester/flow_log/log_data/l4_flow_log.go:44-214,
l7_flow_log.go:63-212) to the fields the pipelines populate.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class LogOp(enum.Enum):
    FIRST = "first"  # identity: value from the earliest emission
    LAST = "last"  # lifecycle: value from the latest emission
    MIN = "min"  # start_time
    MAX = "max"  # end_time (int) — for f32 watermarks too
    OR = "or"  # tcp flag bitmasks
    SUM = "sum"  # counters (f32 lane)


_INT_OPS = (LogOp.FIRST, LogOp.LAST, LogOp.MIN, LogOp.MAX, LogOp.OR)
_NUM_OPS = (LogOp.SUM, LogOp.MAX)


@dataclasses.dataclass(frozen=True)
class LogField:
    name: str
    op: LogOp
    kind: str = "int"  # "int" (u32 device) | "num" (f32 device) | "str" (host)


@dataclasses.dataclass(frozen=True)
class LogSchema:
    name: str
    key: tuple[str, ...]  # merge key columns (within a window slot)
    fields: tuple[LogField, ...]

    def __post_init__(self):
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate columns in {self.name}")
        for f in self.fields:
            if f.kind == "int" and f.op not in _INT_OPS:
                raise ValueError(f"{f.name}: op {f.op} invalid for int lane")
            if f.kind == "num" and f.op not in _NUM_OPS:
                raise ValueError(f"{f.name}: op {f.op} invalid for num lane")
        object.__setattr__(self, "ints", tuple(f for f in self.fields if f.kind == "int"))
        object.__setattr__(self, "nums", tuple(f for f in self.fields if f.kind == "num"))
        object.__setattr__(self, "strs", tuple(f for f in self.fields if f.kind == "str"))
        object.__setattr__(self, "_int_idx", {f.name: i for i, f in enumerate(self.ints)})
        object.__setattr__(self, "_num_idx", {f.name: i for i, f in enumerate(self.nums)})
        for k in self.key:
            if k not in self._int_idx:
                raise ValueError(f"key column {k} must be an int column")

    def int_index(self, name: str) -> int:
        return self._int_idx[name]

    def num_index(self, name: str) -> int:
        return self._num_idx[name]

    def int_cols_with(self, op: LogOp) -> np.ndarray:
        return np.array(
            [i for i, f in enumerate(self.ints) if f.op is op], dtype=np.int32
        )

    def num_cols_with(self, op: LogOp) -> np.ndarray:
        return np.array(
            [i for i, f in enumerate(self.nums) if f.op is op], dtype=np.int32
        )

    @property
    def key_cols(self) -> np.ndarray:
        return np.array([self.int_index(k) for k in self.key], dtype=np.int32)


def _i(name, op=LogOp.FIRST):
    return LogField(name, op, "int")


def _n(name, op=LogOp.SUM):
    return LogField(name, op, "num")


def _s(name):
    return LogField(name, LogOp.FIRST, "str")


# L4 flow log (l4_flow_log.go:44-214 abridged). One row per flow per
# minute; minute_merge folds per-second TaggedFlow emissions.
L4_FLOW_LOG = LogSchema(
    "l4_flow_log",
    key=("flow_id_hi", "flow_id_lo"),
    fields=tuple(
        [
            _i("flow_id_hi"),
            _i("flow_id_lo"),
            _i("agent_id"),
            # identity (DataLinkLayer/NetworkLayer/TransportLayer groups)
            _i("is_ipv6"),
            *[_i(f"ip{s}_w{w}") for s in (0, 1) for w in range(4)],
            _i("mac0_hi"),
            _i("mac0_lo"),
            _i("mac1_hi"),
            _i("mac1_lo"),
            _i("l3_epc_id_0"),
            _i("l3_epc_id_1"),
            _i("client_port"),
            _i("server_port"),
            _i("protocol"),
            _i("tap_type"),
            _i("tap_port"),
            _i("tap_side"),
            _i("gpid_0"),
            _i("gpid_1"),
            _i("signal_source"),
            _i("l7_protocol"),
            _i("pod_id_0"),
            _i("pod_id_1"),
            # lifecycle
            _i("start_time", LogOp.MIN),
            _i("end_time", LogOp.MAX),
            _i("status", LogOp.LAST),
            _i("close_type", LogOp.LAST),
            _i("state", LogOp.LAST),
            # set on the flow's first emission; OR so a minute window
            # containing the flow's birth keeps the mark
            _i("is_new_flow", LogOp.OR),
            _i("tcp_flags_bit_0", LogOp.OR),
            _i("tcp_flags_bit_1", LogOp.OR),
            # counters (FlowPerfStats / metrics peers)
            _n("packet_tx"),
            _n("packet_rx"),
            _n("byte_tx"),
            _n("byte_rx"),
            _n("l3_byte_tx"),
            _n("l3_byte_rx"),
            _n("l4_byte_tx"),
            _n("l4_byte_rx"),
            _n("total_packet_tx"),
            _n("total_packet_rx"),
            _n("total_byte_tx"),
            _n("total_byte_rx"),
            _n("syn_count"),
            _n("synack_count"),
            _n("retrans_tx"),
            _n("retrans_rx"),
            _n("zero_win_tx"),
            _n("zero_win_rx"),
            _n("rtt", LogOp.MAX),
            _n("rtt_client_max", LogOp.MAX),
            _n("rtt_server_max", LogOp.MAX),
            _n("srt_max", LogOp.MAX),
            _n("art_max", LogOp.MAX),
            _n("rrt_max", LogOp.MAX),
            _n("cit_max", LogOp.MAX),
            _n("srt_sum"),
            _n("art_sum"),
            _n("rrt_sum"),
            _n("cit_sum"),
            _n("srt_count"),
            _n("art_count"),
            _n("rrt_count"),
            _n("cit_count"),
        ]
    ),
)


# L7 request log (l7_flow_log.go:63-212 abridged). One row per request /
# response / session — never merged, only throttled.
L7_FLOW_LOG = LogSchema(
    "l7_flow_log",
    key=("flow_id_hi", "flow_id_lo"),
    fields=tuple(
        [
            _i("flow_id_hi"),
            _i("flow_id_lo"),
            _i("agent_id"),
            _i("is_ipv6"),
            *[_i(f"ip{s}_w{w}") for s in (0, 1) for w in range(4)],
            _i("l3_epc_id_0"),
            _i("l3_epc_id_1"),
            _i("client_port"),
            _i("server_port"),
            _i("protocol"),
            _i("tap_type"),
            _i("tap_port"),
            _i("tap_side"),
            _i("gpid_0"),
            _i("gpid_1"),
            _i("signal_source"),
            _i("l7_protocol"),
            _i("pod_id_0"),
            _i("pod_id_1"),
            _i("version"),
            _i("type"),  # 0 request / 1 response / 2 session
            _i("request_id"),
            _i("status"),  # ok / client_error / server_error / timeout
            _i("status_code"),
            _i("start_time"),  # µs within-second handled host-side; s here
            _i("end_time"),
            _i("response_duration"),  # µs
            _s("request_type"),
            _s("request_domain"),
            _s("request_resource"),
            _s("endpoint"),
            _s("response_exception"),
            _s("trace_id"),
            _s("span_id"),
            _s("parent_span_id"),
            _s("x_request_id"),
            _s("app_service"),
            _s("app_instance"),
        ]
    ),
)
