"""ACL policy labeler — the agent's policy plane, vectorized.

Port copy of deepflow_tpu/agent/policy.py.

The reference's policy module (agent/src/policy/labeler.rs endpoint
resolution; first_path/fast_path.rs ACL matching) classifies every
packet against operator ACLs and attaches actions: NPB forwarding,
policy-triggered PCAP, drop. Its two-tier first-path/fast-path cache
exists because scalar per-packet matching is expensive on a CPU; here
the whole batch matches against the whole ACL table in one broadcast
pass ([A, N] masks), which IS the fast path on this architecture —
no per-flow cache to invalidate (documented deviation).

Actions follow the reference's semantics:
  * DROP    — packet removed before FlowMap/L7 (policy drop).
  * PCAP    — packet captured into the pcap plane (RAW_PCAP frames →
              pcap ingester, server/ingester/pcap).
  * NPB     — counted and labeled; there is no packet-broker fabric in
              this environment, so NPB marks flows for export only.
ACL order is priority order: the first matching ACL wins
(first_path.rs first-hit semantics).
"""

from __future__ import annotations

import dataclasses
import logging
import struct

import numpy as np

from .packet import PacketBatch

ACTION_NONE = 0
ACTION_NPB = 1
ACTION_PCAP = 2
ACTION_DROP = 3


def parse_cidr(cidr: str) -> tuple[int, int]:
    """'10.0.0.0/8' → (u32 net, prefix_len). '0.0.0.0/0' matches any."""
    ip, _, plen = cidr.partition("/")
    parts = [int(x) for x in ip.split(".")]
    net = (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]
    return net, int(plen or 32)


@dataclasses.dataclass(frozen=True)
class Acl:
    """One ACL entry (reference: trisolaris-pushed FlowAcl). IPv4 CIDRs;
    prefix 0 means any address (and also matches IPv6 packets — "any"
    is address-family agnostic, everything narrower is v4-only)."""

    id: int
    action: int = ACTION_NONE
    src: str = "0.0.0.0/0"
    dst: str = "0.0.0.0/0"
    src_ports: tuple | None = None  # (lo, hi) inclusive
    dst_ports: tuple | None = None
    protocol: int = 0  # 0 = any IP protocol
    symmetric: bool = True  # match the reverse direction too

    def __post_init__(self):
        # 0 is the no-match sentinel in match() output; an id-0 ACL's
        # hits would be silently dropped from usage metering
        if self.id < 1:
            raise ValueError(f"ACL id must be >= 1, got {self.id}")


class PolicyLabeler:
    def __init__(self, acls: list[Acl]):
        self.acls = list(acls)
        n = len(self.acls)
        self._ids = np.asarray([a.id for a in self.acls], np.uint32)
        self._actions = np.asarray([a.action for a in self.acls], np.uint32)
        self._proto = np.asarray([a.protocol for a in self.acls], np.uint32)
        self._sym = np.asarray([a.symmetric for a in self.acls], bool)

        def nets(field):
            net = np.zeros(n, np.uint32)
            mask = np.zeros(n, np.uint32)
            for i, a in enumerate(self.acls):
                v, plen = parse_cidr(getattr(a, field))
                net[i] = v
                mask[i] = ((0xFFFFFFFF << (32 - plen)) & 0xFFFFFFFF) if plen else 0
            return net & mask, mask

        self._src_net, self._src_mask = nets("src")
        self._dst_net, self._dst_mask = nets("dst")

        def ports(field):
            lo = np.zeros(n, np.uint32)
            hi = np.full(n, 65535, np.uint32)
            for i, a in enumerate(self.acls):
                r = getattr(a, field)
                if r is not None:
                    lo[i], hi[i] = r
            return lo, hi

        self._sp_lo, self._sp_hi = ports("src_ports")
        self._dp_lo, self._dp_hi = ports("dst_ports")
        self.counters = {"matched": 0, "dropped": 0, "pcap": 0, "npb": 0}

    def match(self, p: PacketBatch) -> tuple[np.ndarray, np.ndarray]:
        """→ (acl_id[N] u32, action[N] u32); 0/NONE where nothing hits.
        One broadcast pass: [A, 1] ACL columns against [N] packet rows.
        """
        if not self.acls:
            z = np.zeros(p.size, np.uint32)
            return z, z
        ip_s = p.ip_src[:, 3].astype(np.uint32)[None, :]  # [1, N]
        ip_d = p.ip_dst[:, 3].astype(np.uint32)[None, :]
        v4 = (p.is_ipv6 == 0)[None, :]
        sp = p.port_src[None, :]
        dp = p.port_dst[None, :]

        src_net = self._src_net[:, None]
        src_mask = self._src_mask[:, None]
        dst_net = self._dst_net[:, None]
        dst_mask = self._dst_mask[:, None]

        def side(ip, net, mask):
            # mask 0 ("any") also admits IPv6; narrower CIDRs are v4-only
            return ((ip & mask) == net) & (v4 | (mask == 0))

        proto_ok = (self._proto[:, None] == 0) | (
            self._proto[:, None] == p.protocol[None, :]
        )
        fwd = (
            side(ip_s, src_net, src_mask)
            & side(ip_d, dst_net, dst_mask)
            & (sp >= self._sp_lo[:, None]) & (sp <= self._sp_hi[:, None])
            & (dp >= self._dp_lo[:, None]) & (dp <= self._dp_hi[:, None])
        )
        rev = (
            side(ip_d, src_net, src_mask)
            & side(ip_s, dst_net, dst_mask)
            & (dp >= self._sp_lo[:, None]) & (dp <= self._sp_hi[:, None])
            & (sp >= self._dp_lo[:, None]) & (sp <= self._dp_hi[:, None])
        )
        hits = proto_ok & (fwd | (rev & self._sym[:, None]))  # [A, N]
        hits &= p.valid[None, :]

        any_hit = hits.any(axis=0)
        first = np.argmax(hits, axis=0)  # lowest ACL index = priority
        acl_id = np.where(any_hit, self._ids[first], 0).astype(np.uint32)
        action = np.where(any_hit, self._actions[first], 0).astype(np.uint32)
        # orientation of the winning ACL for the usage-doc tx/rx split
        self.last_forward = (proto_ok & fwd)[first, np.arange(p.size)] & any_hit

        self.counters["matched"] += int(any_hit.sum())
        self.counters["dropped"] += int((action == ACTION_DROP).sum())
        self.counters["pcap"] += int((action == ACTION_PCAP).sum())
        self.counters["npb"] += int((action == ACTION_NPB).sum())
        return acl_id, action


def pcap_frames(buf: np.ndarray, p: PacketBatch, idx: np.ndarray,
                acl_id: np.ndarray) -> list[bytes]:
    """Policy-PCAP packets → the pcap plane's binary frame layout
    ([flow_id u64 BE][ts_us u64 BE][len u32 BE][bytes] — must match
    server/events.py _pcap's `>QQI`). flow_id carries the ACL id so the
    pcap table records which policy fired."""
    out = []
    for i in idx:
        i = int(i)
        ln = min(int(p.packet_len[i]), buf.shape[1])
        ts = int(p.timestamp_s[i]) * 1_000_000 + int(p.timestamp_us[i])
        pkt = buf[i, :ln].tobytes()
        out.append(struct.pack(">QQI", int(acl_id[i]), ts, len(pkt)) + pkt)
    return out


class PolicyMeterAggregator:
    """ACL usage docs — the policy doc path (collector.rs:440-487).

    Packets matching an ACL accumulate per-(minute, acl_gid) UsageMeter
    lanes; `flush()` emits traffic_policy-shaped documents (CodeId.ACL,
    MeterId.USAGE) as a DocBatch carried in the FLOW_METER matrix (its
    packet/byte lanes — USAGE_METER maps 1:1 onto Traffic columns,
    datamodel/schema.py). tx = the ACL's forward orientation."""

    INTERVAL = 60

    def __init__(self, *, agent_id: int = 1):
        self.agent_id = agent_id
        self._acc: dict[tuple[int, int], np.ndarray] = {}  # (minute, acl) → [4]

    def update(self, p: PacketBatch, acl_id: np.ndarray, action: np.ndarray,
               forward: np.ndarray) -> None:
        sel = (acl_id > 0) & (action != ACTION_DROP) & p.valid
        if not sel.any():
            return
        minutes = (p.timestamp_s[sel] // self.INTERVAL).astype(np.int64)
        acls = acl_id[sel].astype(np.int64)
        fwd = forward[sel]
        nbytes = p.packet_len[sel].astype(np.int64)
        for key in np.unique(np.stack([minutes, acls], axis=1), axis=0):
            m = (minutes == key[0]) & (acls == key[1])
            row = self._acc.setdefault((int(key[0]), int(key[1])), np.zeros(4, np.int64))
            row[0] += int((m & fwd).sum())           # packet_tx
            row[1] += int((m & ~fwd).sum())          # packet_rx
            row[2] += int(nbytes[m & fwd].sum())     # byte_tx
            row[3] += int(nbytes[m & ~fwd].sum())    # byte_rx

    def flush(self, now_s: int):
        """Emit closed minutes (< current one) as a DocBatch, or None."""
        from ..datamodel.code import CodeId, MeterId
        from ..datamodel.schema import FLOW_METER, TAG_SCHEMA

        cur_min = now_s // self.INTERVAL
        done = [k for k in self._acc if k[0] < cur_min]
        if not done:
            return None
        n = len(done)
        tags = np.zeros((n, TAG_SCHEMA.num_fields), np.uint32)
        meters = np.zeros((n, FLOW_METER.num_fields), np.float32)
        ts = np.zeros((n,), np.uint32)
        mi = FLOW_METER.index
        for r, key in enumerate(sorted(done)):
            minute, acl = key
            row = self._acc.pop(key)
            ts[r] = minute * self.INTERVAL
            tags[r, TAG_SCHEMA.index("code_id")] = CodeId.ACL
            tags[r, TAG_SCHEMA.index("meter_id")] = MeterId.USAGE
            tags[r, TAG_SCHEMA.index("agent_id")] = self.agent_id
            tags[r, TAG_SCHEMA.index("acl_gid")] = acl
            meters[r, mi("packet_tx")] = row[0]
            meters[r, mi("packet_rx")] = row[1]
            meters[r, mi("byte_tx")] = row[2]
            meters[r, mi("byte_rx")] = row[3]
        from ..datamodel.batch import DocBatch

        return DocBatch(
            tags=tags, meters=meters, timestamp=ts,
            valid=np.ones((n,), bool),
            tag_schema=TAG_SCHEMA, meter_schema=FLOW_METER,
        )


_ACTION_NAMES = {
    "none": ACTION_NONE, "npb": ACTION_NPB, "pcap": ACTION_PCAP,
    "drop": ACTION_DROP,
}


def acls_from_config(spec: list[dict]) -> tuple[Acl, ...]:
    """Trisolaris-pushed FlowAcl payload → Acl tuple. Each entry:
    {"id": int, "action": "npb"|"pcap"|"drop"|"none", "src": cidr,
     "dst": cidr, "src_ports": [lo, hi], "dst_ports": [lo, hi],
     "protocol": int, "symmetric": bool} — all but id optional."""
    out = []
    for e in spec:
        if int(e.get("id", 0)) < 1:
            # a remotely pushed bad entry must not abort the whole
            # dynamic-config apply — skip it, keep the rest
            logging.warning("dropping ACL with invalid id %r", e.get("id"))
            continue
        out.append(
            Acl(
                id=int(e["id"]),
                action=_ACTION_NAMES.get(str(e.get("action", "none")).lower(), ACTION_NONE),
                src=e.get("src", "0.0.0.0/0"),
                dst=e.get("dst", "0.0.0.0/0"),
                src_ports=tuple(e["src_ports"]) if e.get("src_ports") else None,
                dst_ports=tuple(e["dst_ports"]) if e.get("dst_ports") else None,
                protocol=int(e.get("protocol", 0)),
                symmetric=bool(e.get("symmetric", True)),
            )
        )
    return tuple(out)
