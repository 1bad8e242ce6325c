"""Tag enrichment — the device-side `DocumentExpand` (port of
deepflow_tpu/enrich/platform.py).

The reference enriches every document on the ingest host by chasing
hash-map pointers per doc (unmarshaller/handle_document.go:114-270,
grpc_platformdata.go:263-392): gpid→pod fill, pod→info, MAC→info,
(EPC,IP)→info fallback chain, pod-service / custom-service resolution,
auto_service / auto_instance priority encoding, multicast peer fill,
other-region drop and OTel fixups.

Here the whole batch is enriched on the device: the controller-synced
platform metadata is compiled by the host into `DeviceHashTable`s and a
dense info matrix (ops/hashtable.py), and `enrich_docs` resolves every
doc row with vectorized probes and gathers, no per-row host work. The
fallback chain becomes nested `torch.where` selects; the region filter
becomes a keep mask. Every lane is an integer (the u32 rule of
ops/u32.py), so the card and the CPU give the same bits.

Deviation from the reference service (kept from the JAX package):
pod-service resolution is keyed on (pod_group_id | pod_node_id,
protocol, port) with port-0 wildcard rows; custom services are keyed on
(EPC, IP[, port]) like the reference's QueryCustomService.

`enrich_docs` runs eagerly: each side is ten table lookups of
`max_probes` unrolled gathers, their murmur key folds and the select
chains, so one call is thousands of small launches (PERF.md §6–§7).
"""

from __future__ import annotations

import dataclasses
import ipaddress

import numpy as np
import torch

from ..datamodel.code import CodeId, SignalSource
from ..datamodel.schema import TAG_SCHEMA
from ..device import resolve_device
from ..ops.hashing import fingerprint64_np, fingerprint64_words
from ..ops.hashtable import DeviceHashTable, build_table, empty_table
from ..ops.u32 import from_numpy_u32

_T = TAG_SCHEMA

# EPC sentinel values, i16 sign-folded to u16 (datatype/endpoint.go:28-30).
EPC_INTERNET = 0xFFFE  # -2
EPC_UNKNOWN = 0

# TagSource bits (flow-metrics/tag.go:257-266).
TS_GPID = 1
TS_POD_ID = 2
TS_MAC = 4
TS_EPC_IP = 8
TS_PEER = 16

# AutoService/AutoInstance type codes (trident.proto:332-364,
# ingester/common/common.go:145-193).
TYPE_INTERNET_IP = 0
TYPE_IP = 255
TYPE_POD = 10
TYPE_POD_SERVICE = 11
TYPE_POD_NODE = 14
TYPE_POD_CLUSTER = 103
TYPE_CUSTOM_SERVICE = 104
TYPE_PROCESS = 120
DEVICE_TYPE_POD_SERVICE = 11

# Info matrix column layout (grpc.Info, grpc_platformdata.go:64-90).
INFO_FIELDS = (
    "region_id",
    "host_id",
    "l3_device_id",
    "l3_device_type",
    "subnet_id",
    "pod_node_id",
    "pod_ns_id",
    "az_id",
    "pod_group_id",
    "pod_group_type",
    "pod_id",
    "pod_cluster_id",
)
_I = {n: i for i, n in enumerate(INFO_FIELDS)}

# Per-side enrichment output columns.
ENRICH_FIELDS = INFO_FIELDS + (
    "service_id",
    "auto_instance_id",
    "auto_instance_type",
    "auto_service_id",
    "auto_service_type",
    "tag_source",
)

# Table-key seeds: each keyspace prepends a distinct discriminator column
# so fingerprints never collide across tables.
_KS_MAC = 1
_KS_EPC_IP = 2
_KS_POD_SVC = 3
_KS_CUSTOM_SVC = 4

#: the tables of a PlatformState, in the order convert.py carries them
TABLES = ("pod_t", "mac_t", "epcip_t", "gproc_t", "podsvc_t", "customsvc_t")


def _ip_words(ip) -> tuple[int, tuple[int, int, int, int]]:
    """Accept '1.2.3.4', 'fd00::1', int (v4), or (is_v6, words) →
    (is_v6, 4×u32 words, v4 right-aligned in word 3)."""
    if isinstance(ip, tuple):
        return ip
    if isinstance(ip, int):
        return 0, (0, 0, 0, ip & 0xFFFFFFFF)
    addr = ipaddress.ip_address(ip)
    n = int(addr)
    if addr.version == 4:
        return 0, (0, 0, 0, n)
    return 1, tuple((n >> s) & 0xFFFFFFFF for s in (96, 64, 32, 0))


def _fold_epc(epc: int) -> int:
    return epc & 0xFFFF


def _fp_np(cols: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    mat = np.stack([np.asarray(c, np.uint32) for c in cols], axis=1)
    return fingerprint64_np(mat)


@dataclasses.dataclass
class PlatformState:
    """Device-resident platform metadata (one refresh generation)."""

    infos: torch.Tensor  # [M, len(INFO_FIELDS)] u32 lanes; row 0 = zero info
    gproc_rows: torch.Tensor  # [G, 2] u32 lanes (agent_id, pod_id); row 0 = zeros
    pod_t: DeviceHashTable  # pod_id → info row
    mac_t: DeviceHashTable  # fp(epc, mac) → info row
    epcip_t: DeviceHashTable  # fp(is_v6, epc, ip words) → info row
    gproc_t: DeviceHashTable  # gpid → gproc row
    podsvc_t: DeviceHashTable  # fp(kind, id, proto, port) → service_id
    customsvc_t: DeviceHashTable  # fp(is_v6, epc, ip words, port) → service_id
    my_region_id: int  # 0 = no region filtering

    @property
    def device(self) -> torch.device:
        return self.infos.device


class PlatformInfoTable:
    """Host-side registry; `build()` compiles to a `PlatformState`.

    The controller sync path (trisolaris push → PlatformInfoTable
    refresh, grpc_platformdata.go:147) maps to: apply updates here,
    rebuild, and swap the new state into the ingester — generation
    semantics instead of in-place LRU mutation.
    """

    def __init__(self, my_region_id: int = 0):
        self.my_region_id = my_region_id
        self._infos: list[dict] = []
        self._pod: dict[int, int] = {}
        self._mac: dict[tuple[int, int], int] = {}  # (epc, mac48) → info idx
        self._epcip: dict[tuple, int] = {}  # (is_v6, epc, words) → info idx
        self._gproc: dict[int, tuple[int, int]] = {}  # gpid → (agent, pod)
        self._podsvc: dict[tuple, int] = {}  # (kind, id, proto, port) → svc
        self._customsvc: dict[tuple, int] = {}  # (is_v6, epc, words, port) → svc

    # -- population ----------------------------------------------------
    def add_info(self, *, epc_id: int = 0, ips=(), mac: int = 0, pod_id: int = 0, **fields):
        """Register one resource (interface/pod) with its metadata.

        `fields` are INFO_FIELDS values; `ips`/`mac`/`pod_id` key it.
        """
        unknown = set(fields) - set(INFO_FIELDS)
        if unknown:
            raise KeyError(f"unknown info fields: {unknown}")
        idx = len(self._infos) + 1  # row 0 is the zero info
        rec = {f: int(fields.get(f, 0)) for f in INFO_FIELDS}
        if pod_id:
            rec["pod_id"] = int(pod_id)  # keys double as Info.PodID
        self._infos.append(rec)
        epc = _fold_epc(epc_id)
        if pod_id:
            self._pod[pod_id] = idx
        if mac:
            self._mac[(epc, mac)] = idx
        for ip in ips:
            is_v6, words = _ip_words(ip)
            self._epcip[(is_v6, epc, words)] = idx
        return idx

    def add_gprocess(self, gpid: int, agent_id: int, pod_id: int):
        self._gproc[gpid] = (agent_id, pod_id)

    def add_pod_service(self, service_id: int, *, pod_group_id: int = 0, pod_node_id: int = 0,
                        protocol: int = 0, server_port: int = 0):
        """port/protocol 0 rows act as wildcards (any-port service)."""
        if pod_group_id:
            self._podsvc[(0, pod_group_id, protocol, server_port)] = service_id
        if pod_node_id:
            self._podsvc[(1, pod_node_id, protocol, server_port)] = service_id

    def add_custom_service(self, service_id: int, *, epc_id: int, ip, server_port: int = 0):
        is_v6, words = _ip_words(ip)
        self._customsvc[(is_v6, _fold_epc(epc_id), words, server_port)] = service_id

    # -- compile -------------------------------------------------------
    def build(self, device=None) -> PlatformState:
        """Compile the registry onto `device` (default CUDA; raises
        without it)."""
        dev = resolve_device(device)
        infos = np.zeros((len(self._infos) + 1, len(INFO_FIELDS)), dtype=np.uint32)
        for i, rec in enumerate(self._infos):
            infos[i + 1] = [rec[f] for f in INFO_FIELDS]

        gproc_rows = np.zeros((len(self._gproc) + 1, 2), dtype=np.uint32)
        g_keys, g_vals = [], []
        for i, (gpid, (agent, pod)) in enumerate(self._gproc.items()):
            gproc_rows[i + 1] = (agent, pod)
            g_keys.append(gpid)
            g_vals.append(i + 1)

        def table(d: dict, key_fn) -> DeviceHashTable:
            if not d:
                return empty_table(dev)
            cols = [key_fn(k) for k in d]
            hi, lo = _fp_np([np.array([c[j] for c in cols], np.uint32)
                             for j in range(len(cols[0]))])
            return build_table(hi, lo, np.array(list(d.values()), np.uint32), device=dev)

        def keyed(keys, values) -> DeviceHashTable:
            if not len(keys):
                return empty_table(dev)
            return build_table(np.zeros(len(keys), np.uint32), np.asarray(keys, np.uint32),
                               np.asarray(values, np.uint32), device=dev)

        return PlatformState(
            infos=from_numpy_u32(infos, dev),
            gproc_rows=from_numpy_u32(gproc_rows, dev),
            pod_t=keyed(list(self._pod.keys()), list(self._pod.values())),
            mac_t=table(self._mac, lambda k: (_KS_MAC, k[0], (k[1] >> 32) & 0xFFFF,
                                              k[1] & 0xFFFFFFFF)),
            epcip_t=table(self._epcip, lambda k: (_KS_EPC_IP, k[0], k[1], *k[2])),
            gproc_t=keyed(g_keys, g_vals),
            podsvc_t=table(self._podsvc, lambda k: (_KS_POD_SVC, *k)),
            customsvc_t=table(self._customsvc,
                              lambda k: (_KS_CUSTOM_SVC, k[0], k[1], *k[2], k[3])),
            my_region_id=int(self.my_region_id),
        )


def _lookup_fp(t: DeviceHashTable, cols):
    hi, lo = fingerprint64_words(cols)
    return t.lookup(hi, lo)


def _is_multicast(is_v6, w0, w3):
    v4 = (w3 >> 28) == 0xE
    v6 = (w0 >> 24) == 0xFF
    return torch.where(is_v6 != 0, v6, v4)


def _enrich_side(state: PlatformState, col, side: int, is_edge, is_otel):
    """Resolve one endpoint: the getPlatformInfos fallback chain
    (handle_document.go:41-112) + service/auto encodings (:137-240).
    `col(name)` returns the [N] u32 lane of a tag column."""
    epc0 = col("l3_epc_id")
    n = epc0.shape[0]
    dev = epc0.device
    zero = torch.zeros(n, dtype=torch.int64, device=dev)

    def const(v):
        return torch.full((n,), v, dtype=torch.int64, device=dev)

    sfx = "" if side == 0 else "1"
    epc = col("l3_epc_id" + sfx) & 0xFFFF
    gpid = col("gpid0" if side == 0 else "gpid1")
    mac_hi = col(f"mac{side}_hi")
    mac_lo = col(f"mac{side}_lo")
    ipw = [col(f"ip{side}_w{w}") for w in range(4)]
    is_v6 = col("is_ipv6")
    agent_id = col("agent_id")
    pod = col("pod_id") if side == 0 else zero

    # side 1 participates only in edge docs; side 0 always.
    not_internet = epc != EPC_INTERNET
    in_play = (is_edge & not_internet) if side == 1 else not_internet
    tag_source = zero

    # gpid → pod fill (QueryGprocessInfo; agent match required)
    g_row, g_found = state.gproc_t.lookup(zero, gpid)
    g_row = torch.where(g_found, g_row, 0)
    g_agent = state.gproc_rows[g_row, 0]
    g_pod = state.gproc_rows[g_row, 1]
    use_gproc = (in_play & (gpid != 0) & (pod == 0) & g_found & (g_pod != 0)
                 & (g_agent == agent_id))
    pod = torch.where(use_gproc, g_pod, pod)
    tag_source = tag_source | torch.where(use_gproc, TS_GPID, 0)

    # pod → info
    try_pod = in_play & (pod != 0)
    pod_idx, pod_found = state.pod_t.lookup(zero, pod)
    pod_hit = try_pod & pod_found
    tag_source = tag_source | torch.where(try_pod, TS_POD_ID, 0)

    # mac → info (key includes EPC, grpc_platformdata.go:63)
    try_mac = in_play & ~pod_hit & ((mac_hi | mac_lo) != 0)
    mac_idx, mac_found = _lookup_fp(state.mac_t, [const(_KS_MAC), epc, mac_hi, mac_lo])
    mac_hit = try_mac & mac_found
    tag_source = tag_source | torch.where(try_mac, TS_MAC, 0)

    # (EPC, IP) → info
    ip_idx, ip_found = _lookup_fp(state.epcip_t, [const(_KS_EPC_IP), is_v6, epc, *ipw])
    try_ip = in_play & ~pod_hit & ~mac_hit
    ip_hit = try_ip & ip_found
    tag_source = tag_source | torch.where(try_ip, TS_EPC_IP, 0)

    have = pod_hit | mac_hit | ip_hit
    idx = torch.where(pod_hit, pod_idx, torch.where(mac_hit, mac_idx, torch.where(ip_hit, ip_idx, 0)))
    info = torch.where(have[:, None], state.infos[idx], 0)

    out = {f: info[:, _I[f]] for f in INFO_FIELDS}
    # matched info overwrites PodID (handle_document.go:192 t.PodID =
    # info.PodID); with no info the original/gpid-filled pod survives for
    # the auto_instance chain (GetAutoInstance takes t.PodID)
    out["pod_id"] = torch.where(have, out["pod_id"], pod)

    # -- pod service (IsPodServiceIP gate, handle_document.go:151,194-202)
    dev_type = out["l3_device_type"]
    server_port = col("server_port")
    protocol = col("protocol")
    is_pod_svc_ip = ((dev_type == DEVICE_TYPE_POD_SERVICE) | (out["pod_id"] != 0)
                     | (out["pod_node_id"] != 0))
    if side == 0:
        # single-side with valid port → port-matched; else any-port, and
        # pod-node-only endpoints don't match (handle_document.go:199).
        use_port = (server_port > 0) & ~is_edge
        port_key = torch.where(use_port, server_port, zero)
        proto_key = torch.where(use_port, protocol, zero)
        gate = have & is_pod_svc_ip & (
            use_port | (dev_type == DEVICE_TYPE_POD_SERVICE) | (out["pod_id"] != 0))
    else:
        port_key = server_port
        proto_key = protocol
        gate = have & is_pod_svc_ip

    svc = zero
    svc_found = torch.zeros(n, dtype=torch.bool, device=dev)
    for kind, ident in ((0, out["pod_group_id"]), (1, out["pod_node_id"])):
        for p_proto, p_port in ((proto_key, port_key), (zero, zero)):
            v, f = _lookup_fp(state.podsvc_t,
                              [const(_KS_POD_SVC), const(kind), ident, p_proto, p_port])
            use = gate & (ident != 0) & f & ~svc_found
            svc = torch.where(use, v, svc)
            svc_found = svc_found | use
    out["service_id"] = svc

    # -- custom service (QueryCustomService: exact port then any-port).
    # Side 0 uses the port only for single-side docs (handle_document.go:236-238);
    # side 1 always does (:178).
    cs_port = server_port if side == 1 else torch.where(~is_edge, server_port, zero)
    cs = zero
    cs_found = torch.zeros(n, dtype=torch.bool, device=dev)
    for p in (cs_port, zero):
        v, f = _lookup_fp(state.customsvc_t, [const(_KS_CUSTOM_SVC), is_v6, epc, *ipw, p])
        use = f & ~cs_found & not_internet
        cs = torch.where(use, v, cs)
        cs_found = cs_found | use

    # -- auto instance / auto service priority chains (common.go:160-193)
    is_internet = ~not_internet

    def chain(*pairs, fallback):
        cid, ctype = fallback
        cid = torch.where(is_internet, 0, cid)
        ctype = torch.where(is_internet, TYPE_INTERNET_IP, ctype)
        for pid, ptype in reversed(pairs):
            take = pid > 0
            cid = torch.where(take, pid, cid)
            ctype = torch.where(take, ptype, ctype)
        return cid, ctype

    dev_id = out["l3_device_id"]
    out["auto_instance_id"], out["auto_instance_type"] = chain(
        (out["pod_id"], TYPE_POD),
        (gpid, TYPE_PROCESS),
        (out["pod_node_id"], TYPE_POD_NODE),
        (dev_id, dev_type),
        fallback=(out["subnet_id"], TYPE_IP),
    )
    out["auto_service_id"], out["auto_service_type"] = chain(
        (cs, TYPE_CUSTOM_SERVICE),
        (svc, TYPE_POD_SERVICE),
        (out["pod_group_id"], out["pod_group_type"]),
        (gpid, TYPE_PROCESS),
        (out["pod_cluster_id"], TYPE_POD_CLUSTER),
        (dev_id, dev_type),
        fallback=(out["subnet_id"], TYPE_IP),
    )

    # OTel: Internet-typed endpoints display as plain IP (handle_document.go:255-266)
    for f in ("auto_service_type", "auto_instance_type"):
        out[f] = torch.where(is_otel & (out[f] == TYPE_INTERNET_IP), TYPE_IP, out[f])

    out["tag_source"] = tag_source
    return out, have


def enrich_docs(state: PlatformState, tags, valid):
    """Enrich a doc batch on the state's device: [N, T] u32 tag matrix
    (host uint32 array or u32-lane tensor) and [N] bool valid →
    (side0 dict, side1 dict, keep mask, other_region_drops) — dicts of
    [N] u32 lanes keyed by ENRICH_FIELDS, a [N] bool keep and a 0-dim
    int64 drop count.

    keep = valid ∧ ¬other-region (the reference returns an error per doc
    and drops it, handle_document.go:170-231).
    """
    dev = state.device
    if isinstance(tags, torch.Tensor):
        tags = tags.to(dev)
    else:
        tags = from_numpy_u32(tags, dev)
    if isinstance(valid, torch.Tensor):
        valid = valid.to(dev)
    else:
        valid = torch.from_numpy(np.array(valid, dtype=bool)).to(dev)
    tags_t = tags.t().contiguous()  # one contiguous [N] lane per tag column

    def col(name):
        return tags_t[_T.index(name)]

    code_id = col("code_id")
    is_edge = (code_id >= int(CodeId.EDGE_IP_PORT)) & (code_id <= int(CodeId.EDGE_MAC_IP_PORT_APP))
    is_otel = col("signal_source") == int(SignalSource.OTEL)
    # exact CLIENT/SERVER compare — sided variants (e.g. SERVER_NODE) are
    # not region-checked in the reference (handle_document.go:171,221)
    tap_side = col("tap_side")

    side0, have0 = _enrich_side(state, col, 0, is_edge, is_otel)
    side1, have1 = _enrich_side(state, col, 1, is_edge, is_otel)

    # multicast peer fill (handle_document.go:154-168, 203-217)
    is_v6 = col("is_ipv6")
    mc0 = _is_multicast(is_v6, col("ip0_w0"), col("ip0_w3"))
    mc1 = _is_multicast(is_v6, col("ip1_w0"), col("ip1_w3"))
    fill0 = ~have0 & have1 & mc0 & is_edge
    fill1 = ~have1 & have0 & mc1 & is_edge
    for f in ("region_id", "subnet_id", "az_id"):
        side0[f] = torch.where(fill0, side1[f], side0[f])
        side1[f] = torch.where(fill1, side0[f], side1[f])
    side0["tag_source"] = side0["tag_source"] | torch.where(fill0, TS_PEER, 0)
    side1["tag_source"] = side1["tag_source"] | torch.where(fill1, TS_PEER, 0)

    # other-region filter (handle_document.go:170-231): single-side docs
    # must match my region; edge docs check the observation side.
    my = int(state.my_region_id)
    if my != 0:
        r0, r1 = side0["region_id"], side1["region_id"]
        bad_single = ~is_edge & (r0 != 0) & (r0 != my)
        bad_edge_client = is_edge & (tap_side == 1) & (r0 != 0) & (r0 != my)
        bad_edge_server = is_edge & (tap_side == 2) & (r1 != 0) & (r1 != my)
        other_region = bad_single | bad_edge_client | bad_edge_server
    else:
        other_region = torch.zeros_like(valid)
    keep = valid & ~other_region
    drops = (valid & other_region).sum()
    return side0, side1, keep, drops
