"""Straight-line NumPy/dict oracle for the L4/L7 rollups.

Port copy of deepflow_tpu/oracle/numpy_oracle.py.

Independent re-implementation of the reference semantics (fanout rules of
collector.rs:500-607/694-821/882-1095, merge rules of meter.rs:97-276)
with Python dicts and exact int64 accumulators. The jit pipeline must
agree with this scorer exactly on meters (within f32 representability)
and on the emitted key set — this is the conformance harness the
reference repo lacks (SURVEY §4).

Kept deliberately scalar/dict-shaped: no tensors, no sorting tricks — so a
bug in the device path can't be mirrored here by construction. (The L4
and L7 paths do share one record walker, parameterized the same way the
reference parameterizes its tagger builders — the shared logic *is* the
shared reference semantics, collector.rs:882/984 get_*_tagger.)
"""

from __future__ import annotations

import dataclasses

from ..datamodel.code import CodeId, Direction, MeterId, SignalSource
from ..datamodel.schema import APP_METER, FLOW_METER, MergeOp, TAG_SCHEMA, MeterSchema
from ..aggregator.fanout import EPC_INTERNET_U16, FanoutConfig, TCP, UDP

_SIDE_MASK = 0xF8


@dataclasses.dataclass
class OracleDoc:
    window: int
    tag: dict
    meter: dict  # int64 values


def _merge_meter(into: dict, add: dict, schema: MeterSchema) -> None:
    for f in schema.fields:
        if f.op is MergeOp.SUM:
            into[f.name] += add[f.name]
        else:
            into[f.name] = max(into[f.name], add[f.name])


def _reversed_meter(m: dict, schema: MeterSchema) -> dict:
    out = dict(m)
    for f in schema.fields:
        if f.reverse_with:
            out[f.name] = m[f.reverse_with]
        if f.zero_on_reverse:
            out[f.name] = 0
    return out


def _empty_tag() -> dict:
    return {n: 0 for n in TAG_SCHEMA.field_names()}


def _tap_side(direction: int) -> int:
    return direction


def _rollup(
    records: list[dict],
    config: FanoutConfig,
    interval: int,
    app: bool,
) -> dict[tuple, OracleDoc]:
    schema = APP_METER if app else FLOW_METER
    meter_id = int(MeterId.APP if app else MeterId.FLOW)
    out: dict[tuple, OracleDoc] = {}
    key_fields = [f.name for f in TAG_SCHEMA.fields if f.key]

    for r in records:
        ts = int(r["timestamp"])
        window = ts // interval
        meter = {f.name: int(r.get("meter", {}).get(f.name, 0)) for f in schema.fields}

        sig = int(r.get("signal_source", 0))
        is_otel = sig == SignalSource.OTEL
        is_packet = sig == SignalSource.PACKET
        proto = int(r.get("protocol", 0))
        dirs = [int(r.get("direction0", 0)), int(r.get("direction1", 0))]
        active = [int(r.get("is_active_host0", 0)), int(r.get("is_active_host1", 0))]
        vip = [int(r.get("is_vip0", 0)), int(r.get("is_vip1", 0))]

        # whole-record drops (collector.rs:489-493, :684-687, :794)
        if config.inactive_ip_aggregation and not active[0] and not active[1]:
            continue
        l7p = int(r.get("l7_protocol", 0))
        if app and l7p == 0 and not is_otel:
            continue

        def epc_fix(v):
            v = int(v) & 0xFFFF
            return 0 if (v >= 0x8000 and is_otel) else v

        epc = [epc_fix(r.get("l3_epc_id", 0)), epc_fix(r.get("l3_epc_id1", 0))]
        ips = [
            [int(r.get(f"ip0_w{w}", 0)) for w in range(4)],
            [int(r.get(f"ip1_w{w}", 0)) for w in range(4)],
        ]
        macs = [
            (int(r.get("mac0_hi", 0)), int(r.get("mac0_lo", 0))),
            (int(r.get("mac1_hi", 0)), int(r.get("mac1_lo", 0))),
        ]

        ignore_port = (not int(r.get("is_active_service", 0)) and config.inactive_server_port_aggregation) or (
            proto != TCP and proto != UDP
        )
        dst_port = 0 if ignore_port else int(r.get("server_port", 0))

        shared_tag = dict(
            meter_id=meter_id,
            global_thread_id=config.global_thread_id,
            agent_id=config.agent_id,
            is_ipv6=int(r.get("is_ipv6", 0)),
            protocol=proto,
            tap_type=int(r.get("tap_type", 0)),
            signal_source=sig,
            pod_id=int(r.get("pod_id", 0)),
        )
        if app:
            shared_tag.update(
                l7_protocol=l7p,
                endpoint_hash=int(r.get("endpoint_hash", 0)),
                biz_type=int(r.get("biz_type", 0)),
                time_span=int(r.get("time_span", 0)),
            )

        docs: list[tuple[dict, dict]] = []

        # --- single docs ---
        for ep in (0, 1):
            d = dirs[ep]
            if d == 0:
                continue
            pure = (d & _SIDE_MASK) == 0
            dir_ok = (pure or not is_packet) if app else pure
            if not dir_ok:
                continue
            if config.inactive_ip_aggregation and not active[ep]:
                continue
            tag = _empty_tag()
            if config.inactive_ip_aggregation:
                keep_ip = bool(active[ep])
            elif ep == 0:
                keep_ip = (epc[0] != EPC_INTERNET_U16) or is_otel
            else:
                keep_ip = True
            ip = ips[ep] if keep_ip else [0, 0, 0, 0]
            has_mac = bool(vip[ep]) or d == Direction.LOCAL_TO_LOCAL
            if app:
                code = CodeId.SINGLE_MAC_IP_PORT_APP if has_mac else CodeId.SINGLE_IP_PORT_APP
            else:
                code = CodeId.SINGLE_MAC_IP_PORT if has_mac else CodeId.SINGLE_IP_PORT
            tag.update(
                code_id=int(code),
                ip0_w0=ip[0],
                ip0_w1=ip[1],
                ip0_w2=ip[2],
                ip0_w3=ip[3],
                l3_epc_id=epc[ep],
                mac0_hi=macs[ep][0] if has_mac else 0,
                mac0_lo=macs[ep][1] if has_mac else 0,
                direction=d,
                tap_side=_tap_side(d),
                server_port=0 if ep == 0 else dst_port,
                gpid0=int(r.get("gpid0" if ep == 0 else "gpid1", 0)),
                **shared_tag,
            )
            m = meter if (ep == 0 or app) else _reversed_meter(meter, schema)
            docs.append((tag, m))

        # --- edge docs ---
        both_none = dirs[0] == 0 and dirs[1] == 0
        edge_ok = True if app else sig in (SignalSource.PACKET, SignalSource.XFLOW)
        if edge_ok:
            edge_dirs = []
            for ep in (0, 1):
                if dirs[ep] != 0:
                    edge_dirs.append(dirs[ep])
                elif ep == 1 and both_none:
                    edge_dirs.append(Direction.APP if is_otel else Direction.NONE)
            for d in edge_dirs:
                tag = _empty_tag()
                if config.inactive_ip_aggregation:
                    keep0, keep1 = bool(active[0]), bool(active[1])
                else:
                    keep0 = (epc[0] != EPC_INTERNET_U16) or is_otel
                    keep1 = True
                src_ip = ips[0] if keep0 else [0, 0, 0, 0]
                dst_ip = ips[1] if keep1 else [0, 0, 0, 0]
                is_ll = d == Direction.LOCAL_TO_LOCAL
                m0 = macs[0] if (vip[0] or is_ll) else (0, 0)
                m1 = macs[1] if (vip[1] or is_ll) else (0, 0)
                any_mac = any(m0) or any(m1)
                if app:
                    code = CodeId.EDGE_MAC_IP_PORT_APP if any_mac else CodeId.EDGE_IP_PORT_APP
                else:
                    code = CodeId.EDGE_MAC_IP_PORT if any_mac else CodeId.EDGE_IP_PORT
                tag.update(
                    code_id=int(code),
                    ip0_w0=src_ip[0],
                    ip0_w1=src_ip[1],
                    ip0_w2=src_ip[2],
                    ip0_w3=src_ip[3],
                    ip1_w0=dst_ip[0],
                    ip1_w1=dst_ip[1],
                    ip1_w2=dst_ip[2],
                    ip1_w3=dst_ip[3],
                    l3_epc_id=epc[0],
                    l3_epc_id1=epc[1],
                    mac0_hi=m0[0],
                    mac0_lo=m0[1],
                    mac1_hi=m1[0],
                    mac1_lo=m1[1],
                    direction=int(d),
                    tap_side=_tap_side(int(d)),
                    server_port=dst_port,
                    tap_port=int(r.get("tap_port", 0)),
                    gpid0=int(r.get("gpid0", 0)),
                    gpid1=int(r.get("gpid1", 0)),
                    **shared_tag,
                )
                docs.append((tag, meter))

        for tag, m in docs:
            key = (window,) + tuple(tag[k] for k in key_fields)
            if key in out:
                _merge_meter(out[key].meter, m, schema)
            else:
                out[key] = OracleDoc(window=window, tag=dict(tag), meter=dict(m))
    return out


def oracle_l4_rollup(
    records: list[dict],
    config: FanoutConfig,
    interval: int = 1,
) -> dict[tuple, OracleDoc]:
    """records: list of flow dicts (FlowBatch.from_records schema, int
    values + 'meter' sub-dict). Returns {(window, key_tuple): OracleDoc}.
    Key tuple = values of TAG_SCHEMA key columns, matching the device
    fingerprint's equality.
    """
    return _rollup(records, config, interval, app=False)


def oracle_l7_rollup(
    records: list[dict],
    config: FanoutConfig,
    interval: int = 1,
) -> dict[tuple, OracleDoc]:
    """L7 twin of oracle_l4_rollup (fill_l7_stats semantics)."""
    return _rollup(records, config, interval, app=True)
