"""IP geolocation — the server/libs/geo seat.

Port copy of deepflow_tpu/utils/geo.py.

The reference ships a compiled IP→(region, province, ISP) table used by
flow-log enrichment (server/libs/geo). Same shape here: a CIDR table →
two sorted u32 arrays → vectorized `np.searchsorted` lookups, so a
whole column geolocates in one call. The built-in table covers the
special-use ranges every deployment needs (RFC 1918/6598/3927, loopback,
multicast); production tables load via `GeoTable.from_cidrs` with
operator data (the reference's table is a licensed database, not
shippable).
"""

from __future__ import annotations

import ipaddress

import numpy as np

UNKNOWN = 0

# built-in labels (id 0 reserved for unknown/public)
BUILTIN_LABELS = {
    0: "public",
    1: "private-10",
    2: "private-172",
    3: "private-192",
    4: "loopback",
    5: "link-local",
    6: "cgn-100.64",
    7: "multicast",
}

_BUILTIN_CIDRS = [
    ("10.0.0.0/8", 1),
    ("172.16.0.0/12", 2),
    ("192.168.0.0/16", 3),
    ("127.0.0.0/8", 4),
    ("169.254.0.0/16", 5),
    ("100.64.0.0/10", 6),
    ("224.0.0.0/4", 7),
]


class GeoTable:
    """DISJOINT sorted-interval IPv4 lookup: starts[i] ≤ ip ≤ ends[i] →
    ids[i]. Build via from_cidrs, which flattens arbitrary (nested /
    overlapping) CIDRs into disjoint ranges with most-specific-wins —
    the shape real geo tables have (a province /24 carved from an ISP
    /16 must not shadow the rest of the /16)."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray, ids: np.ndarray,
                 labels: dict[int, str]):
        order = np.argsort(starts)
        self.starts = starts[order]
        self.ends = ends[order]
        self.ids = ids[order]
        self.labels = dict(labels)

    @classmethod
    def from_cidrs(cls, cidrs: list[tuple[str, int]],
                   labels: dict[int, str] | None = None) -> "GeoTable":
        nets = []
        for cidr, gid in cidrs:
            net = ipaddress.ip_network(cidr)
            nets.append(
                (int(net.network_address), int(net.broadcast_address),
                 net.prefixlen, gid)
            )
        # flatten: sweep over boundary points; within each elementary
        # segment the longest-prefix (most specific) covering net wins
        points = sorted({p for s, e, _l, _g in nets for p in (s, e + 1)})
        starts, ends, ids = [], [], []
        for lo, hi_excl in zip(points, points[1:]):
            best = None
            for s, e, plen, gid in nets:
                if s <= lo and hi_excl - 1 <= e:
                    if best is None or plen > best[0]:
                        best = (plen, gid)
            if best is not None:
                # merge with the previous segment when contiguous + same id
                if starts and ids[-1] == best[1] and ends[-1] == lo - 1:
                    ends[-1] = hi_excl - 1
                else:
                    starts.append(lo)
                    ends.append(hi_excl - 1)
                    ids.append(best[1])
        return cls(
            np.asarray(starts, np.uint32),
            np.asarray(ends, np.uint32),
            np.asarray(ids, np.uint32),
            labels or dict(BUILTIN_LABELS),
        )

    @classmethod
    def builtin(cls) -> "GeoTable":
        return cls.from_cidrs(_BUILTIN_CIDRS)

    def lookup(self, ips: np.ndarray) -> np.ndarray:
        """[N] u32 IPv4 → [N] u32 geo ids (UNKNOWN when no range hits)."""
        ips = np.asarray(ips, np.uint32)
        if len(self.starts) == 0:
            return np.zeros(ips.shape, np.uint32)
        idx = np.searchsorted(self.starts, ips, side="right") - 1
        idx_c = np.clip(idx, 0, len(self.starts) - 1)
        hit = (idx >= 0) & (ips <= self.ends[idx_c])
        return np.where(hit, self.ids[idx_c], np.uint32(UNKNOWN))

    def label(self, gid: int) -> str:
        return self.labels.get(int(gid), "public")
