"""Document fanout — vectorized `fill_l4_stats` / `fill_l7_stats` (port of
deepflow_tpu/aggregator/fanout.py).

Every flow emits a fixed [4, N] block of candidate docs with a validity
mask: lanes 0/1 are the ep0/ep1 single docs, lanes 2/3 the ep0/ep1 edge
docs (lane 3 doubles as the both-directions-unknown rest doc). Tag
construction mirrors get_single_tagger / get_edge_tagger of the
reference collector (collector.rs:882-1095); columns a doc's Code does
not cover are zeroed, which makes "fingerprint all key columns"
equivalent to StashKey equality. The module docstring of the JAX
package lists the L4 / L7 deltas; this port keeps them one for one.

Elementwise PyTorch on u32 lanes (ops/u32.py); no kernel is needed.
"""

from __future__ import annotations

import dataclasses

import torch

from ..datamodel.code import CodeId, Direction, MeterId, SignalSource
from ..datamodel.schema import FLOW_METER, TAG_SCHEMA

_T = TAG_SCHEMA

# Docs emitted per flow: ep0/ep1 single + ep0/ep1 edge (lane 3 doubles as
# the rest doc). Fill accounting everywhere keys off this constant.
FANOUT_LANES = 4

TCP = 6
UDP = 17
EPC_INTERNET_U16 = 0xFFFE  # -2 as u16 (EPC_INTERNET, npb_pcap_policy)

_DIR_SIDE_MASK = 0xF8  # document.rs MASK_SIDE


@dataclasses.dataclass(frozen=True)
class FanoutConfig:
    """CollectorConfig subset (agent/src/config/handler.rs CollectorAccess)."""

    inactive_ip_aggregation: bool = False
    inactive_server_port_aggregation: bool = False
    agent_id: int = 1
    global_thread_id: int = 1


def _make_lanes(tags: dict, meters_t: torch.Tensor, valid: torch.Tensor,
                config: FanoutConfig, app: bool):
    """Build the four (cols, lane_valid, lane_meter_t) lanes.

    meters_t is column-major [M, N]; lane meters come back [M, N]."""
    n = meters_t.shape[1]
    dev = meters_t.device
    zero = torch.zeros((n,), dtype=torch.int64, device=dev)

    dir0 = tags["direction0"]
    dir1 = tags["direction1"]
    sig = tags["signal_source"]
    is_otel = sig == int(SignalSource.OTEL)
    is_packet = sig == int(SignalSource.PACKET)
    is_pkt_or_xflow = is_packet | (sig == int(SignalSource.XFLOW))
    proto = tags["protocol"]

    active0 = tags["is_active_host0"] != 0
    active1 = tags["is_active_host1"] != 0
    vip0 = tags["is_vip0"] != 0
    vip1 = tags["is_vip1"] != 0

    # Whole-record gates: both-hosts-inactive drop (collector.rs:489-493,
    # :684-687) and, for L7, the unknown-protocol drop (:794,:816); eBPF
    # flows never reach the L4 plane (quadruple_generator.rs:420-423).
    if config.inactive_ip_aggregation:
        valid = valid & (active0 | active1)
    if app:
        valid = valid & ((tags["l7_protocol"] != 0) | is_otel)
    else:
        valid = valid & (sig != int(SignalSource.EBPF))

    # reversed meter for the L4 server-endpoint single doc (meter.rs:169-176)
    if app:
        meters_rev_t = meters_t
    else:
        perm = torch.from_numpy(FLOW_METER.reverse_perm.astype("int64")).to(dev)
        zmask = torch.from_numpy(~FLOW_METER.reverse_zero_mask).to(
            device=dev, dtype=meters_t.dtype)
        meters_rev_t = meters_t[perm, :] * zmask[:, None]

    # ignore_server_port (collector.rs:877)
    inactive_service = tags["is_active_service"] == 0
    ignore_port = (inactive_service & config.inactive_server_port_aggregation) | (
        (proto != TCP) & (proto != UDP)
    )
    dst_port = torch.where(ignore_port, zero, tags["server_port"])

    # get_l3_epc_id (collector.rs:1097): negative epc + OTel → 0, on the
    # u16 sign-folded form
    def epc_fix(epc):
        epc = epc & 0xFFFF
        return torch.where((epc >= 0x8000) & is_otel, zero, epc)

    epc0 = epc_fix(tags["l3_epc_id"])
    epc1 = epc_fix(tags["l3_epc_id1"])

    ip0 = [tags[f"ip0_w{w}"] for w in range(4)]
    ip1 = [tags[f"ip1_w{w}"] for w in range(4)]

    def masked_ip(ip, keep):
        return [torch.where(keep, w, zero) for w in ip]

    meter_id = MeterId.APP if app else MeterId.FLOW
    shared_cols = {
        "meter_id": torch.full((n,), int(meter_id), dtype=torch.int64, device=dev),
        "global_thread_id": torch.full((n,), config.global_thread_id,
                                       dtype=torch.int64, device=dev),
        "agent_id": torch.full((n,), config.agent_id, dtype=torch.int64, device=dev),
        "is_ipv6": tags["is_ipv6"],
        "protocol": proto,
        "tap_type": tags["tap_type"],
        "signal_source": sig,
        "pod_id": tags["pod_id"],
    }
    if app:
        shared_cols.update(
            l7_protocol=tags["l7_protocol"],
            endpoint_hash=tags["endpoint_hash"],
            biz_type=tags["biz_type"],
            time_span=tags["time_span"],
        )

    def code(cond, yes: CodeId, no: CodeId):
        return torch.where(cond, int(yes), int(no))

    # ---- single docs (lanes 0, 1) -------------------------------------
    def single_lane(ep):
        d = dir0 if ep == 0 else dir1
        active = active0 if ep == 0 else active1
        vip = vip0 if ep == 0 else vip1
        epc = epc0 if ep == 0 else epc1
        ip = ip0 if ep == 0 else ip1
        gpid = tags["gpid0"] if ep == 0 else tags["gpid1"]
        mac = (tags["mac0_hi"], tags["mac0_lo"]) if ep == 0 else (tags["mac1_hi"], tags["mac1_lo"])

        # emission gate: pure c/s/local directions; L7 additionally
        # admits sided directions for non-Packet sources
        pure_dir = (d & _DIR_SIDE_MASK) == 0
        dir_ok = (pure_dir | ~is_packet) if app else pure_dir
        lane_valid = valid & (d != 0) & dir_ok
        if config.inactive_ip_aggregation:
            lane_valid = lane_valid & active

        # ip rewrite (get_single_tagger, Managed mode)
        if config.inactive_ip_aggregation:
            keep_ip = active
        elif ep == 0:
            keep_ip = (epc0 != EPC_INTERNET_U16) | is_otel
        else:
            keep_ip = torch.ones((n,), dtype=torch.bool, device=dev)
        ip_w = masked_ip(ip, keep_ip)

        has_mac = vip | (d == int(Direction.LOCAL_TO_LOCAL))
        if app:
            code_id = code(has_mac, CodeId.SINGLE_MAC_IP_PORT_APP, CodeId.SINGLE_IP_PORT_APP)
        else:
            code_id = code(has_mac, CodeId.SINGLE_MAC_IP_PORT, CodeId.SINGLE_IP_PORT)
        cols = {
            **shared_cols,
            "code_id": code_id,
            "ip0_w0": ip_w[0],
            "ip0_w1": ip_w[1],
            "ip0_w2": ip_w[2],
            "ip0_w3": ip_w[3],
            "l3_epc_id": epc,
            "mac0_hi": torch.where(has_mac, mac[0], zero),
            "mac0_lo": torch.where(has_mac, mac[1], zero),
            "direction": d,
            "tap_side": d,  # TapSide::from(Direction) is the identity bit pattern
            # the client-side resource ignores the service port
            # (collector.rs:948-955)
            "server_port": zero if ep == 0 else dst_port,
            "gpid0": gpid,
        }
        return cols, lane_valid, (meters_t if ep == 0 else meters_rev_t)

    # ---- edge docs (lanes 2, 3) ---------------------------------------
    both_none = (dir0 == 0) & (dir1 == 0)

    def edge_lane(ep):
        d = dir0 if ep == 0 else dir1
        if ep == 1:
            # rest-doc fold: both directions unknown → direction None
            # (or App for OTel), tap_side Rest (collector.rs:584-607)
            rest = torch.where(is_otel, int(Direction.APP), int(Direction.NONE))
            d = torch.where(both_none, rest, d)
            lane_valid = valid & ((dir1 != 0) | both_none)
        else:
            lane_valid = valid & (d != 0)
        if not app:
            # L4 edge docs exist only for Packet/XFlow (fill_edge_l4_stats)
            lane_valid = lane_valid & is_pkt_or_xflow

        # ip rewrite (get_edge_tagger, Managed)
        if config.inactive_ip_aggregation:
            keep0, keep1 = active0, active1
        else:
            keep0 = (epc0 != EPC_INTERNET_U16) | is_otel
            keep1 = torch.ones((n,), dtype=torch.bool, device=dev)
        src_ip = masked_ip(ip0, keep0)
        dst_ip = masked_ip(ip1, keep1)

        # vip gating of macs except local-local (collector.rs:1030-1043)
        is_ll = d == int(Direction.LOCAL_TO_LOCAL)
        keep_mac0 = vip0 | is_ll
        keep_mac1 = vip1 | is_ll
        mac0_hi = torch.where(keep_mac0, tags["mac0_hi"], zero)
        mac0_lo = torch.where(keep_mac0, tags["mac0_lo"], zero)
        mac1_hi = torch.where(keep_mac1, tags["mac1_hi"], zero)
        mac1_lo = torch.where(keep_mac1, tags["mac1_lo"], zero)
        any_mac = (mac0_hi | mac0_lo | mac1_hi | mac1_lo) != 0
        if app:
            code_id = code(any_mac, CodeId.EDGE_MAC_IP_PORT_APP, CodeId.EDGE_IP_PORT_APP)
        else:
            code_id = code(any_mac, CodeId.EDGE_MAC_IP_PORT, CodeId.EDGE_IP_PORT)

        cols = {
            **shared_cols,
            "code_id": code_id,
            "ip0_w0": src_ip[0],
            "ip0_w1": src_ip[1],
            "ip0_w2": src_ip[2],
            "ip0_w3": src_ip[3],
            "ip1_w0": dst_ip[0],
            "ip1_w1": dst_ip[1],
            "ip1_w2": dst_ip[2],
            "ip1_w3": dst_ip[3],
            "l3_epc_id": epc0,
            "l3_epc_id1": epc1,
            "mac0_hi": mac0_hi,
            "mac0_lo": mac0_lo,
            "mac1_hi": mac1_hi,
            "mac1_lo": mac1_lo,
            "direction": d,
            "tap_side": d,
            "server_port": dst_port,
            "tap_port": tags["tap_port"],
            "gpid0": tags["gpid0"],
            "gpid1": tags["gpid1"],
        }
        return cols, lane_valid, meters_t

    return [single_lane(0), single_lane(1), edge_lane(0), edge_lane(1)]


def _fanout_impl(tags: dict, meters: torch.Tensor, valid: torch.Tensor,
                 config: FanoutConfig, app: bool):
    meters_t = meters.t()  # [M, N] view — column-major from here on
    n = meters_t.shape[1]
    lanes = _make_lanes(tags, meters_t, valid, config, app)

    zero = torch.zeros((n,), dtype=torch.int64, device=meters.device)
    lane_tag_blocks, lane_valids, lane_meters = [], [], []
    for cols, lv, mt in lanes:
        rows = [zero] * _T.num_fields
        for name, arr in cols.items():
            rows[_T.index(name)] = arr
        lane_tag_blocks.append(torch.stack(rows))  # [T, n]
        lane_valids.append(lv)
        lane_meters.append(mt)

    doc_tags = torch.cat(lane_tag_blocks, dim=1)  # [T, 4n], lane-major
    doc_meters = torch.cat(lane_meters, dim=1)  # [M, 4n]
    doc_valid = torch.cat(lane_valids)
    ts = tags["timestamp"].repeat(FANOUT_LANES)
    return doc_tags, doc_meters, ts, doc_valid


def fanout_l4(tags: dict, meters: torch.Tensor, valid: torch.Tensor,
              config: FanoutConfig):
    """FlowBatch lanes → column-major doc arrays.

    tags: dict of [N] u32 lanes named per FLOW_RECORD_TAG_FIELDS;
    meters: [N, M] f32 FlowMeter rows; valid: [N] bool. Returns
    (doc_tags [T, 4N] u32, doc_meters [M, 4N] f32, doc_ts [4N] u32,
    doc_valid [4N] bool), lane-major along the row axis."""
    return _fanout_impl(tags, meters, valid, config, app=False)


def fanout_l7(tags: dict, meters: torch.Tensor, valid: torch.Tensor,
              config: FanoutConfig):
    """AppMeterWithFlow lanes → L7 doc arrays of shape [4N, ...]; same
    contract as fanout_l4 with meters following APP_METER."""
    return _fanout_impl(tags, meters, valid, config, app=True)
