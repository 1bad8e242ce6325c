"""Device-resident FlowMap — the agent's flow-generation hot loop (port
of deepflow_tpu/agent/flow_map.py).

The reference's `FlowMap::inject_meta_packet` (flow_generator/
flow_map.rs:710) probes a host hash map per packet, runs a per-packet
TCP state machine (flow_state.rs) and TcpPerf RTT estimation
(perf/tcp.rs), and a 1s `inject_flush_ticker` (flow_map.rs:555) emits
`TaggedFlow`s. This rebuild replaces per-packet probing with the same
sort→segment machinery as every other hot loop in the framework:

  * the flow table is a `LogStashState` over the FLOW_STATE schema
    (slot pinned to 0 — no windowing; the 5-tuple is the key) on the
    map's device,
  * a packet batch becomes flow-row updates on the host
    (`packets_to_flow_rows`, numpy: canonicalized endpoint pair +
    per-direction conditional columns, the seq-list retransmission
    pass) uploaded in one copy and merged in one sort,
  * `tick(now)` computes per-flow TCP state from the accumulated
    flag/time aggregates with torch ops on the device, closes flows
    (FIN/RST/timeout), emits per-second delta rows (L4_FLOW_LOG schema)
    and zeroes the delta counters.

Device→host traffic: `inject` fetches nothing; `tick` fetches one
scalar pair (rows emitted, flows closed), then — when it emits — one
packed block of the emitted rows. `host_fetches` counts them.

The handshake clocks are u32 µs lanes carried as int64 (ops/u32.py):
the RTT legs are masked to 32 bits before the bound test, so a
handshake straddling the 2^32 µs wrap measures as in the reference's
wrapping u32 arithmetic.

A reference quirk kept on purpose: the tick compacts every emitted lane
except the close mask, and `tick` indexes the compacted rows with the
first n entries of the uncompacted mask to release `seq_tracker` keys
(reference flow_map.py:550-552). When an idle, still-open flow sits
among the first n table rows, the keys of other flows are released;
later retransmission counts follow from that, in both packages.

Documented deviations from the sequential reference (conformance tests
pin these semantics):
  * TCP state derives from cumulative per-direction flag sets, not
    packet order — SYN→SYN+ACK→FIN/RST transitions are order-free, so
    flow accounting matches; mid-stream anomalies (e.g. data-before-
    handshake) are not distinguished.
  * RTT: client = t(first SYN+ACK) − t(first SYN); server = t(first
    pure ACK from the SYN side) − t(first SYN+ACK). TcpPerf's
    continuous per-ACK srt/art tracking is approximated by the
    handshake estimate.
  * Retransmissions: a host-side per-(flow, direction) seen-byte
    interval list (the TcpPerf seq_list) flags data segments whose whole
    range was already sent, in arrival order across batches.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..device import resolve_device
from ..flowlog.aggr import (
    FlowLogBatch,
    LogStashState,
    host_fetch,
    log_stash_init,
    log_stash_merge,
    upload_rows,
)
from ..flowlog.schema import L4_FLOW_LOG, LogOp, LogSchema, LogField
from ..ops.hashing import fingerprint64_np
from ..ops.segment import SENTINEL_SLOT
from ..ops.u32 import MASK, to_i32_bits
from ..utils.stats import register_countable
from .packet import TCP_ACK, TCP_FIN, TCP_RST, TCP_SYN, PacketBatch

_ABSENT = 0xFFFFFFFF  # MIN-lane identity for "time never seen"


def _i(name, op=LogOp.FIRST):
    return LogField(name, op, "int")


def _n(name, op=LogOp.SUM):
    return LogField(name, op, "num")


FLOW_STATE = LogSchema(
    "flow_state",
    key=(
        "is_ipv6",
        "ep0_w0", "ep0_w1", "ep0_w2", "ep0_w3",
        "ep1_w0", "ep1_w1", "ep1_w2", "ep1_w3",
        "ep0_port", "ep1_port", "protocol",
    ),
    fields=tuple(
        [
            _i("is_ipv6"),
            *[_i(f"ep{s}_w{w}") for s in (0, 1) for w in range(4)],
            _i("ep0_port"),
            _i("ep1_port"),
            _i("protocol"),
            _i("tunnel_type"),
            _i("start_time", LogOp.MIN),
            _i("last_seen", LogOp.MAX),
            _i("flags_d0", LogOp.OR),  # d0 = packets sent by ep0
            _i("flags_d1", LogOp.OR),
            _i("syn_time", LogOp.MIN),  # _ABSENT when unseen
            _i("synack_time", LogOp.MIN),
            _i("ack_time_d0", LogOp.MIN),  # first pure-ACK per direction
            _i("ack_time_d1", LogOp.MIN),
            _i("syn_dir", LogOp.OR),  # bit0: ep0 sent SYN, bit1: ep1
            _i("emitted", LogOp.OR),  # set by tick() after first emission
            # dispatcher orientation (dispatcher.py): which endpoints
            # terminate locally (L2End), and the tap the flow rode
            _i("l2_end_ep0", LogOp.OR),
            _i("l2_end_ep1", LogOp.OR),
            _i("tap_type", LogOp.MAX),  # one tap per flow; MAX merges idempotently
            # delta counters (zeroed by tick() after each emission)
            _n("packet_d0"),
            _n("packet_d1"),
            _n("byte_d0"),
            _n("byte_d1"),
            _n("l4_byte_d0"),
            _n("l4_byte_d1"),
            _n("syn_count"),
            _n("synack_count"),
            _n("retrans_d0"),
            _n("retrans_d1"),
            # lifetime totals (never reset)
            _n("total_packet_d0"),
            _n("total_packet_d1"),
            _n("total_byte_d0"),
            _n("total_byte_d1"),
        ]
    ),
)

_II = FLOW_STATE.int_index
_NI = FLOW_STATE.num_index

# flow states (flow_state.rs FlowState, condensed)
STATE_OPENING = 1
STATE_ESTABLISHED = 2
STATE_CLOSING = 3
STATE_CLOSED = 4

# close types (flow.rs CloseType, condensed)
CLOSE_NONE = 0
CLOSE_FIN = 1
CLOSE_CLIENT_RST = 2
CLOSE_SERVER_RST = 3
CLOSE_TIMEOUT = 5


@dataclasses.dataclass(frozen=True)
class FlowTimeouts:
    """flow timeout config (agent config flow.flow_timeout analog)."""

    opening: int = 5
    established: int = 300
    closing: int = 35


# ---------------------------------------------------------------------------
# packet batch → flow-row updates (pure function of PacketBatch columns)


def packets_to_flow_rows(
    p: PacketBatch, seq_tracker: dict | None = None, orient=None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PacketBatch → (ints [N, Ki], nums [N, Kn], valid) FLOW_STATE rows.

    Endpoint canonicalization: ep0 is the lexicographically smaller
    (ip, port); dir=1 when the sender is ep1. Both directions of one
    connection land on the same key, like FlowMapKey's symmetric hash.
    """
    n = p.size
    src_key = [p.ip_src[:, w].astype(np.uint64) for w in range(4)] + [p.port_src.astype(np.uint64)]
    dst_key = [p.ip_dst[:, w].astype(np.uint64) for w in range(4)] + [p.port_dst.astype(np.uint64)]
    swap = np.zeros(n, bool)
    decided = np.zeros(n, bool)
    for s, d in zip(src_key, dst_key):
        gt = ~decided & (s > d)
        lt = ~decided & (s < d)
        swap |= gt
        decided |= gt | lt
    d1 = swap  # sender is ep1

    ints = np.zeros((n, len(FLOW_STATE.ints)), np.uint32)
    nums = np.zeros((n, len(FLOW_STATE.nums)), np.float32)

    ints[:, _II("is_ipv6")] = p.is_ipv6
    for w in range(4):
        ints[:, _II(f"ep0_w{w}")] = np.where(d1, p.ip_dst[:, w], p.ip_src[:, w])
        ints[:, _II(f"ep1_w{w}")] = np.where(d1, p.ip_src[:, w], p.ip_dst[:, w])
    ints[:, _II("ep0_port")] = np.where(d1, p.port_dst, p.port_src)
    ints[:, _II("ep1_port")] = np.where(d1, p.port_src, p.port_dst)
    ints[:, _II("protocol")] = p.protocol
    ints[:, _II("tunnel_type")] = p.tunnel_type
    ints[:, _II("start_time")] = p.timestamp_s
    ints[:, _II("last_seen")] = p.timestamp_s
    ints[:, _II("flags_d0")] = np.where(~d1, p.tcp_flags, 0)
    ints[:, _II("flags_d1")] = np.where(d1, p.tcp_flags, 0)

    f = p.tcp_flags
    is_syn = (f & TCP_SYN != 0) & (f & TCP_ACK == 0)
    is_synack = (f & TCP_SYN != 0) & (f & TCP_ACK != 0)
    pure_ack = (f == TCP_ACK) & (p.payload_len == 0)
    # handshake clocks run in µs (mod 2^32) so RTTs keep microsecond
    # resolution like the reference's TcpPerf (perf/tcp.rs works on
    # 64-bit µs Timestamps); the 71-minute wrap only matters if a
    # handshake straddles it — u32 subtraction still yields the right
    # difference then, only the MIN merge order could pick the later
    # timestamp (documented approximation)
    ts_us32 = (
        p.timestamp_s.astype(np.uint64) * np.uint64(1_000_000)
        + p.timestamp_us.astype(np.uint64)
    ).astype(np.uint32)
    ints[:, _II("syn_time")] = np.where(is_syn, ts_us32, _ABSENT)
    ints[:, _II("synack_time")] = np.where(is_synack, ts_us32, _ABSENT)
    ints[:, _II("ack_time_d0")] = np.where(pure_ack & ~d1, ts_us32, _ABSENT)
    ints[:, _II("ack_time_d1")] = np.where(pure_ack & d1, ts_us32, _ABSENT)
    ints[:, _II("syn_dir")] = np.where(is_syn, np.where(d1, 2, 1), 0)

    if orient is not None:
        tap, end_src, end_dst = orient
        ints[:, _II("tap_type")] = tap
        # src/dst are packet-relative; fold onto the canonical ep0/ep1
        ints[:, _II("l2_end_ep0")] = np.where(d1, end_dst, end_src)
        ints[:, _II("l2_end_ep1")] = np.where(d1, end_src, end_dst)
    else:
        # no dispatcher: the historical local single-host stance —
        # everything terminates here (tap_side resolves to the client
        # view, matching the pre-mode behavior)
        ints[:, _II("tap_type")] = 3  # TAP_CLOUD
        ints[:, _II("l2_end_ep0")] = 1
        ints[:, _II("l2_end_ep1")] = 1

    one = np.ones(n, np.float32)
    nums[:, _NI("packet_d0")] = np.where(~d1, one, 0)
    nums[:, _NI("packet_d1")] = np.where(d1, one, 0)
    nums[:, _NI("byte_d0")] = np.where(~d1, p.packet_len, 0)
    nums[:, _NI("byte_d1")] = np.where(d1, p.packet_len, 0)
    nums[:, _NI("l4_byte_d0")] = np.where(~d1, p.payload_len, 0)
    nums[:, _NI("l4_byte_d1")] = np.where(d1, p.payload_len, 0)
    nums[:, _NI("syn_count")] = is_syn
    nums[:, _NI("synack_count")] = is_synack
    nums[:, _NI("total_packet_d0")] = nums[:, _NI("packet_d0")]
    nums[:, _NI("total_packet_d1")] = nums[:, _NI("packet_d1")]
    nums[:, _NI("total_byte_d0")] = nums[:, _NI("byte_d0")]
    nums[:, _NI("total_byte_d1")] = nums[:, _NI("byte_d1")]

    # within-batch retransmission detection: an exact duplicate
    # (flow, dir, seq, len) data segment is a resend. Plain reordering of
    # disjoint ranges is NOT flagged (an arrival-order prefix-max scheme
    # would false-positive on any reordered link); partial-overlap
    # retransmits are missed — documented approximation
    key_mat = ints[:, FLOW_STATE.key_cols]
    hi, lo = fingerprint64_np(key_mat)
    is_data = (p.protocol == 6) & (p.payload_len > 0)
    order = np.lexsort((p.payload_len, p.seq, d1.astype(np.int64), lo, hi))
    same = np.zeros(n, bool)
    if n > 1:
        cols = [hi, lo, d1.astype(np.uint32), p.seq, p.payload_len]
        eq = np.ones(n - 1, bool)
        for c in cols:
            cs = c[order]
            eq &= cs[1:] == cs[:-1]
        same[1:] = eq
    retrans = np.zeros(n, bool)
    retrans[order] = same & is_data[order]

    if seq_tracker is not None and n:
        # the seq-list pass processes packets in arrival order, so it
        # subsumes the within-batch duplicate rule above
        retrans = _seq_list_retrans(
            seq_tracker, hi, lo, d1, p.seq, p.payload_len, is_data
        )
    nums[:, _NI("retrans_d0")] = retrans & ~d1
    nums[:, _NI("retrans_d1")] = retrans & d1

    return ints, nums, p.valid.copy()


SEQ_LIST_MAX_LEN = 16  # perf/tcp.rs:80


def _seq_list_retrans(tracker: dict, hi, lo, d1, seq, plen, is_data):
    """Per-(flow, dir) seen-byte interval lists — the TcpPerf seq_list
    (perf/tcp.rs:84, is_retrans_segment:266): a data segment whose whole
    range was already transmitted is a retransmission. Sequential in
    arrival order (duplicates inside one batch count too), carried
    across batches via `tracker`. Sequence wrap is handled by storing
    intervals as signed offsets from the flow's first-seen seq; at 16
    intervals the two oldest merge (the reference merges at the tail,
    tcp.rs:330). Partial overlaps are NOT flagged (the reference splits
    and counts only fully-seen ranges the same way)."""
    n = hi.shape[0]
    out = np.zeros(n, bool)
    idx = np.nonzero(is_data)[0]
    for i in idx:
        key = (int(hi[i]), int(lo[i]), int(d1[i]))
        s32 = int(seq[i])
        ln = int(plen[i])
        # pop + reinsert on EVERY touch: dict order then approximates
        # LRU, so the overflow eviction in FlowMap.inject (which deletes
        # the oldest-quarter of keys) sheds idle flows, not the
        # long-lived active ones whose cross-batch retrans detection
        # matters most (update-in-place left dict order
        # at insertion time, evicting exactly the wrong entries).
        ent = tracker.pop(key, None)
        if ent is None:
            anchor = s32
            ivals: list[list[int]] = []
        else:
            anchor, ivals = ent
        # wrap-tolerant signed offset from the anchor
        s = ((s32 - anchor + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
        e = s + ln
        covered = any(a <= s and e <= b for a, b in ivals)
        if covered:
            out[i] = True
            tracker[key] = (anchor, ivals)  # refresh recency on hit too
            continue
        # insert + merge (list stays sorted and disjoint; adjacency
        # merges so contiguous transmissions form one range)
        before = [iv for iv in ivals if iv[1] < s]
        after = [iv for iv in ivals if iv[0] > e]
        for a, b in ivals:
            if not (b < s or a > e):
                s, e = min(a, s), max(b, e)
        merged = before + [(s, e)] + after
        if len(merged) > SEQ_LIST_MAX_LEN:
            merged[0] = (merged[0][0], merged[1][1])
            del merged[1]
        tracker[key] = (anchor, merged)
    return out



# ---------------------------------------------------------------------------
# tick: state classification, close, emission, delta reset

_DELTA_COLS = (
    "packet_d0", "packet_d1", "byte_d0", "byte_d1", "l4_byte_d0",
    "l4_byte_d1", "syn_count", "synack_count", "retrans_d0", "retrans_d1",
)
# per-row tick lanes shipped with the emitted rows, in block order; the
# uncompacted close mask rides last
_TICK_LANES = ("tcp_state", "close_type", "client_is_ep1", "rtt_client", "rtt_server",
               "new_flow")
_DELTA_MASK: dict = {}


def _delta_mask(device: torch.device) -> torch.Tensor:
    """[Kn] bool: the delta lanes a tick zeroes, once per device."""
    m = _DELTA_MASK.get(device)
    if m is None:
        a = np.zeros(len(FLOW_STATE.nums), bool)
        a[[_NI(c) for c in _DELTA_COLS]] = True
        m = _DELTA_MASK[device] = torch.from_numpy(a).to(device)
    return m


def _flow_tick_impl(state: LogStashState, now: int, timeouts: FlowTimeouts):
    """One tick on the state's device → (new state, lanes). `lanes`
    holds the per-row outputs over all table rows (uncompacted, int64 /
    bool), `emit`, the stable emitted-first `order` and the emitted
    `count` (0-dim); `emission_block` gathers the emitted rows."""
    ints, nums = state.ints, state.nums
    valid = state.valid

    def icol(name):
        return ints[:, _II(name)]

    def ncol(name):
        return nums[:, _NI(name)]

    f0, f1 = icol("flags_d0"), icol("flags_d1")
    fboth = f0 | f1
    is_tcp = icol("protocol") == 6
    syn_seen = (fboth & TCP_SYN) != 0
    synack = icol("synack_time") != _ABSENT
    fin0 = (f0 & TCP_FIN) != 0
    fin1 = (f1 & TCP_FIN) != 0
    rst = (fboth & TCP_RST) != 0

    tcp_state = torch.where(
        synack & syn_seen,
        torch.where(fin0 & fin1, STATE_CLOSED,
                    torch.where(fin0 | fin1, STATE_CLOSING, STATE_ESTABLISHED)),
        torch.where(syn_seen, STATE_OPENING, STATE_ESTABLISHED),  # mid-stream pickup
    )
    tcp_state = torch.where(is_tcp, tcp_state, STATE_ESTABLISHED)

    # guard the u32 subtraction: capture clocks can run ahead of the
    # tick clock, and a wrapped idle would timeout-close live flows
    last_seen = icol("last_seen")
    idle = torch.where(last_seen >= now, 0, now - last_seen)
    timeout_s = torch.where(
        tcp_state == STATE_OPENING,
        timeouts.opening,
        torch.where(tcp_state == STATE_ESTABLISHED, timeouts.established, timeouts.closing),
    )
    timed_out = valid & (idle >= timeout_s)
    done = valid & is_tcp & ((fin0 & fin1) | rst)
    closing_flow = done | timed_out

    # close_type: RST attribution by which side reset; FIN; timeout.
    # client = SYN sender; without a handshake, the lower port is taken
    # as the server (the reference's port-number heuristic)
    syn_dir = icol("syn_dir")
    client_is_ep1 = torch.where(
        syn_dir != 0,
        (syn_dir & 1) == 0,
        icol("ep0_port") < icol("ep1_port"),
    )
    rst0 = (f0 & TCP_RST) != 0
    server_rst = torch.where(client_is_ep1, rst0, (f1 & TCP_RST) != 0)
    close_type = torch.where(
        rst,
        torch.where(server_rst, CLOSE_SERVER_RST, CLOSE_CLIENT_RST),
        torch.where(fin0 & fin1, CLOSE_FIN, CLOSE_TIMEOUT),
    )
    close_type = torch.where(closing_flow, close_type, CLOSE_NONE)

    active = valid & (ncol("packet_d0") + ncol("packet_d1") > 0)
    emit = active | closing_flow

    # RTT in µs (handshake lanes carry the µs-mod-2^32 clock; matches
    # the reference's µs TcpPerf, perf/tcp.rs)
    syn_t, synack_t = icol("syn_time"), icol("synack_time")
    ack_t = torch.where(client_is_ep1, icol("ack_time_d1"), icol("ack_time_d0"))
    # wrap-tolerant ordering: the u32 µs difference (masked to 32 bits,
    # as the reference's wrapping u32 subtraction) is the true RTT as
    # long as it lands under 2^31, so a clock wrap between SYN and
    # SYN-ACK still measures correctly
    d_cli = (synack_t - syn_t) & MASK
    d_srv = (ack_t - synack_t) & MASK
    # handshake legs are bounded (5 min in µs): rejects both nonsense
    # orderings and the post-wrap pure-ACK displacing the handshake ACK
    # in the MIN lane on flows that live across a 71-min clock wrap
    bound = 300_000_000
    have_cli = (syn_t != _ABSENT) & (synack_t != _ABSENT) & (d_cli < bound)
    have_srv = (synack_t != _ABSENT) & (ack_t != _ABSENT) & (d_srv < bound)

    lanes = {
        "close": closing_flow,
        "tcp_state": tcp_state,
        "close_type": close_type,
        "client_is_ep1": client_is_ep1,
        "rtt_client": torch.where(have_cli, d_cli, 0),
        "rtt_server": torch.where(have_srv, d_srv, 0),
        "new_flow": (icol("emitted") == 0) & emit,
        "ints": ints,
        "nums": nums,
        "emit": emit,
        "count": emit.sum(),
        # emitted rows first, each group in table order (the reference's
        # stable argsort of where(emit, 0, 1))
        "order": torch.sort((~emit).to(torch.int32), stable=True).indices,
    }

    # post-emission state: closed flows leave; emitted flows zero their
    # delta lanes and set `emitted`
    new_nums = torch.where(emit[:, None] & _delta_mask(nums.device), 0.0, nums)
    new_ints = ints.clone()
    new_ints[:, _II("emitted")] = torch.where(emit, 1, ints[:, _II("emitted")])
    new_valid = valid & ~closing_flow
    new_state = dataclasses.replace(
        state,
        ints=new_ints,
        nums=new_nums,
        valid=new_valid,
        slot=torch.where(new_valid, state.slot, SENTINEL_SLOT),
    )
    return new_state, lanes


def emission_block(lanes: dict, n: int) -> torch.Tensor:
    """The n emitted rows as one [n, Ki + Kn + 7] int32 block of bit
    patterns: the compacted FLOW_STATE ints and nums, the compacted
    `_TICK_LANES`, then the first n entries of the UNcompacted close
    mask (the reference's `raw["close"][:n]`)."""
    idx = lanes["order"][:n]
    ext = torch.stack([lanes[k][idx].to(torch.int64) for k in _TICK_LANES]
                      + [lanes["close"][:n].to(torch.int64)], dim=1)
    return torch.cat([to_i32_bits(lanes["ints"][idx]), lanes["nums"][idx].view(torch.int32),
                      to_i32_bits(ext)], dim=1)


def unpack_emission(block: np.ndarray) -> dict:
    """Host side of `emission_block`: the reference's `raw` dict of the
    emitted rows (uint32 lanes, bool flags) plus the close mask."""
    ki, kn = len(FLOW_STATE.ints), len(FLOW_STATE.nums)
    u = block.view(np.uint32)
    raw = {"ints": np.ascontiguousarray(u[:, :ki]),
           "nums": np.ascontiguousarray(block[:, ki:ki + kn]).view(np.float32)}
    for j, k in enumerate(_TICK_LANES + ("close",)):
        raw[k] = np.ascontiguousarray(u[:, ki + kn + j])
    for k in ("client_is_ep1", "new_flow", "close"):
        raw[k] = raw[k].astype(bool)
    return raw


# ---------------------------------------------------------------------------
# host side


class FlowMap:
    """inject packets, tick every second, emit L4_FLOW_LOG delta rows.
    The flow table lives on `device` (default CUDA; raises without it)."""

    def __init__(
        self,
        *,
        capacity: int = 1 << 16,
        batch_size: int = 1 << 12,
        timeouts: FlowTimeouts = FlowTimeouts(),
        agent_id: int = 1,
        dispatcher=None,
        device=None,
    ):
        self.capacity = capacity
        self.batch_size = batch_size
        self.timeouts = timeouts
        self.agent_id = agent_id
        self.dispatcher = dispatcher
        self.device = resolve_device(device)
        self.state = log_stash_init(capacity, FLOW_STATE, self.device)
        # host-side per-(flow, dir) seq interval lists for cross-batch
        # retrans detection; bounded. Entries move to the dict tail on
        # every touch (_seq_list_retrans pop+reinsert), so the
        # oldest-quarter eviction below approximates LRU — idle flows
        # go first, active long-lived flows keep their seq history
        self.seq_tracker: dict = {}
        self.seq_tracker_cap = max(1024, 4 * capacity)
        self.counters = {"packets_in": 0, "invalid_packets": 0, "flows_emitted": 0, "flows_closed": 0}
        self.host_fetches = 0  # device→host copies (not a reference counter)
        register_countable("flow_map", self)

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        self.host_fetches += 1
        return host_fetch(x)

    def get_counters(self):
        c = dict(self.counters)
        got = self._fetch(torch.stack([self.state.dropped_overflow, self.state.valid.sum()]))
        c["dropped_overflow"] = int(got[0])
        c["occupancy"] = int(got[1])
        return c

    def inject(self, p: PacketBatch, orient=None) -> None:
        if orient is None and self.dispatcher is not None:
            orient = self.dispatcher.orient(p)
        ints, nums, valid = packets_to_flow_rows(p, self.seq_tracker, orient)
        if len(self.seq_tracker) > self.seq_tracker_cap:
            # dict head = least-recently-touched (pop+reinsert in
            # _seq_list_retrans); drop a quarter, and always at least
            # enough to get back under the cap
            n_evict = max(
                len(self.seq_tracker) - self.seq_tracker_cap,
                self.seq_tracker_cap // 4,
            )
            for k in list(itertools.islice(iter(self.seq_tracker), n_evict)):
                del self.seq_tracker[k]
        n = ints.shape[0]
        if n > self.batch_size:
            raise ValueError(f"packet batch {n} > batch_size {self.batch_size}")
        pad = self.batch_size - n
        ints = np.pad(ints, ((0, pad), (0, 0)))
        # padded MIN lanes must hold the identity, not 0
        for c in ("syn_time", "synack_time", "ack_time_d0", "ack_time_d1", "start_time"):
            ints[n:, _II(c)] = _ABSENT if c != "start_time" else 0
        nums = np.pad(nums, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
        self.counters["packets_in"] += int(valid.sum())
        self.counters["invalid_packets"] += int((~p.valid).sum())

        key_mat = ints[:, FLOW_STATE.key_cols]
        hi, lo = fingerprint64_np(key_mat)
        # slot 0: keyed purely by 5-tuple
        rows = upload_rows(np.zeros(self.batch_size, np.uint32), hi, lo, ints, nums, valid,
                           self.device)
        self.state = log_stash_merge(self.state, *rows, FLOW_STATE)

    def tick(self, now: int) -> FlowLogBatch:
        """1s flush ticker: emit per-second TaggedFlow deltas + closes."""
        self.state, lanes = _flow_tick_impl(self.state, int(now), self.timeouts)
        head = self._fetch(torch.stack([lanes["count"], lanes["close"].sum()]))
        n, n_closed = int(head[0]), int(head[1])
        raw = unpack_emission(self._fetch(emission_block(lanes, n))) if n else {}
        self.counters["flows_emitted"] += n
        # closed flows release their seq-tracker entries — without this,
        # churn would evict still-active flows' marks (FIFO backstop)
        # while dead keys lingered. `close` is the uncompacted mask's
        # head over the compacted rows, as in the reference
        if n and self.seq_tracker:
            closed = raw["close"]
            if closed.any():
                fi = raw["ints"][closed]
                hi, lo = fingerprint64_np(fi[:, FLOW_STATE.key_cols])
                for h, l in zip(hi, lo):
                    for d in (0, 1):
                        self.seq_tracker.pop((int(h), int(l), d), None)
        emitted = _emission_to_l4_rows(raw, n, now, self.agent_id)
        self.counters["flows_closed"] += n_closed
        return emitted

    def drain(self, now: int) -> FlowLogBatch:
        """Force-close everything (shutdown): emit with timeout close."""
        saved = self.timeouts
        self.timeouts = FlowTimeouts(opening=0, established=0, closing=0)
        try:
            return self.tick(now)
        finally:
            self.timeouts = saved


def _emission_to_l4_rows(raw: dict, n: int, now: int, agent_id: int) -> FlowLogBatch:
    """Tick output → L4_FLOW_LOG rows: client side becomes side 0."""
    s = L4_FLOW_LOG
    ints_out = np.zeros((n, len(s.ints)), np.uint32)
    nums_out = np.zeros((n, len(s.nums)), np.float32)
    if n == 0:
        return FlowLogBatch(s, ints_out, nums_out, np.ones(0, bool))
    fi = raw["ints"]
    fn = raw["nums"]
    cli1 = raw["client_is_ep1"].astype(bool)
    ii, ni = s.int_index, s.num_index

    key_mat = fi[:, FLOW_STATE.key_cols]
    hi, lo = fingerprint64_np(key_mat)
    ints_out[:, ii("flow_id_hi")] = hi
    ints_out[:, ii("flow_id_lo")] = lo
    ints_out[:, ii("agent_id")] = agent_id
    ints_out[:, ii("is_ipv6")] = fi[:, _II("is_ipv6")]
    for w in range(4):
        ep0, ep1 = fi[:, _II(f"ep0_w{w}")], fi[:, _II(f"ep1_w{w}")]
        ints_out[:, ii(f"ip0_w{w}")] = np.where(cli1, ep1, ep0)
        ints_out[:, ii(f"ip1_w{w}")] = np.where(cli1, ep0, ep1)
    p0, p1 = fi[:, _II("ep0_port")], fi[:, _II("ep1_port")]
    ints_out[:, ii("client_port")] = np.where(cli1, p1, p0)
    ints_out[:, ii("server_port")] = np.where(cli1, p0, p1)
    ints_out[:, ii("protocol")] = fi[:, _II("protocol")]
    # dispatcher orientation → tap_type + tap_side (TapSide::from(L2End),
    # document.rs): client-local → c(1), server-local → s(2), both → 1
    # (the reference reports the client view), neither → rest(0)
    tap = fi[:, _II("tap_type")]
    ints_out[:, ii("tap_type")] = np.where(tap > 0, tap, 3)
    e0 = fi[:, _II("l2_end_ep0")].astype(bool)
    e1 = fi[:, _II("l2_end_ep1")].astype(bool)
    cli_end = np.where(cli1, e1, e0)
    srv_end = np.where(cli1, e0, e1)
    ints_out[:, ii("tap_side")] = np.where(
        cli_end, 1, np.where(srv_end, 2, 0)
    )
    ints_out[:, ii("signal_source")] = 0
    ints_out[:, ii("start_time")] = fi[:, _II("start_time")]
    ints_out[:, ii("end_time")] = now
    ints_out[:, ii("status")] = 1
    ints_out[:, ii("close_type")] = raw["close_type"]
    ints_out[:, ii("state")] = raw["tcp_state"]
    new = raw["new_flow"].astype(bool)
    ints_out[:, ii("is_new_flow")] = new
    fl0, fl1 = fi[:, _II("flags_d0")], fi[:, _II("flags_d1")]
    ints_out[:, ii("tcp_flags_bit_0")] = np.where(cli1, fl1, fl0)
    ints_out[:, ii("tcp_flags_bit_1")] = np.where(cli1, fl0, fl1)

    def dmap(base):
        a = fn[:, _NI(f"{base}_d0")]
        b = fn[:, _NI(f"{base}_d1")]
        return np.where(cli1, b, a), np.where(cli1, a, b)

    for src, (tx, rx) in (
        ("packet", dmap("packet")),
        ("byte", dmap("byte")),
        ("l4_byte", dmap("l4_byte")),
        ("retrans", dmap("retrans")),
        ("total_packet", dmap("total_packet")),
        ("total_byte", dmap("total_byte")),
    ):
        nums_out[:, ni(f"{src}_tx")] = tx
        nums_out[:, ni(f"{src}_rx")] = rx
    nums_out[:, ni("syn_count")] = fn[:, _NI("syn_count")]
    nums_out[:, ni("synack_count")] = fn[:, _NI("synack_count")]
    # handshake RTT is stamped once, on the flow's first emission —
    # re-stamping every second would weight RTT stats by flow lifetime
    nums_out[:, ni("rtt")] = np.where(
        new, (raw["rtt_client"] + raw["rtt_server"]).astype(np.float32), 0
    )
    nums_out[:, ni("rtt_client_max")] = np.where(new, raw["rtt_client"], 0)
    nums_out[:, ni("rtt_server_max")] = np.where(new, raw["rtt_server"], 0)
    return FlowLogBatch(s, ints_out, nums_out, np.ones(n, bool))
