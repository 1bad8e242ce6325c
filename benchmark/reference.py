"""The plain reference of the L4 1 s rollup, and the comparison that
decides `correct`.

Written in plain PyTorch over the records the benchmark's generator
made, on whatever device it is given; it imports nothing of the system
under test. For one window it takes the window's raw records from the
batches that carried them, fans each out into the four document lanes
of the L4 collector (client and server single docs, the two edge docs),
groups the documents by their key columns and reduces the meters:
sums in float64 — the meters are whole numbers, so the sums are exact
in any order — and maxima. The two non-key columns keep the values of
the group's first document in arrival order: batch, then lane, then
the record's raw fingerprint (the order in which a batch's pre-reduced
records reach the stash), which is why the murmur fold and the
raw-tag packing are frozen here.

`window_schedule` replays the host's window protocol (open span, late
gate, advance) from each batch's event-time bounds. `compare_docs`
holds one of the system's closed windows against the reference's.
"""

from __future__ import annotations

import dataclasses

import torch

from . import schema
from .u32 import fingerprint, pack_words

S = schema
N_DOC = len(S.DOC_FIELDS)
N_METER = len(S.METER_NAMES)


def raw_fingerprint(cols: dict):
    """(hi, lo) of the raw-record group-by key (every flow column)."""
    return fingerprint(pack_words(cols, S.RAW_WIDE, S.RAW_PACKED))


def fanout_l4(cols: dict, meters: torch.Tensor):
    """The four document lanes of each packet flow record, as the L4
    collector builds them with its default settings (no inactive-IP or
    inactive-port aggregation). `cols` maps flow columns to [n] int64
    lanes, `meters` is [n, M]. Returns a list of ([n, D] tags, [n] valid,
    [n, M] meters) for lanes 0–3."""
    n = meters.shape[0]
    dev = meters.device
    zero = torch.zeros((n,), dtype=torch.int64, device=dev)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    sig = cols["signal_source"]
    is_otel = sig == S.SIG_OTEL
    is_packet = sig == S.SIG_PACKET
    valid = valid & (sig != S.SIG_EBPF)
    dir0, dir1 = cols["direction0"], cols["direction1"]
    proto = cols["protocol"]
    vip0, vip1 = cols["is_vip0"] != 0, cols["is_vip1"] != 0

    perm = torch.tensor(S.METER_REVERSE_PERM, device=dev)
    rev = meters[:, perm].clone()
    rev[:, list(S.METER_ZERO_ON_REVERSE)] = 0

    ignore_port = (proto != S.TCP) & (proto != S.UDP)
    dst_port = torch.where(ignore_port, zero, cols["server_port"])

    def epc_fix(e):
        e = e & 0xFFFF
        return torch.where((e >= 0x8000) & is_otel, zero, e)

    epc0, epc1 = epc_fix(cols["l3_epc_id"]), epc_fix(cols["l3_epc_id1"])
    ip0 = [cols[f"ip0_w{w}"] for w in range(4)]
    ip1 = [cols[f"ip1_w{w}"] for w in range(4)]
    keep0 = (epc0 != S.EPC_INTERNET_U16) | is_otel
    shared = {
        "meter_id": zero + S.METER_ID_FLOW, "global_thread_id": zero + 1,
        "agent_id": zero + 1, "is_ipv6": cols["is_ipv6"], "protocol": proto,
        "tap_type": cols["tap_type"], "signal_source": sig, "pod_id": cols["pod_id"],
    }

    def matrix(d: dict) -> torch.Tensor:
        out = torch.zeros((n, N_DOC), dtype=torch.int64, device=dev)
        for k, v in d.items():
            out[:, S.DOC_FIELDS.index(k)] = v
        return out

    lanes = []
    for ep in (0, 1):
        d = dir0 if ep == 0 else dir1
        lane_valid = valid & (d != 0) & ((d & S.DIR_SIDE_MASK) == 0)
        keep = keep0 if ep == 0 else torch.ones_like(valid)
        ip = [torch.where(keep, w, zero) for w in (ip0 if ep == 0 else ip1)]
        vip = vip0 if ep == 0 else vip1
        has_mac = vip | (d == S.DIR_LOCAL)
        mac = ((cols["mac0_hi"], cols["mac0_lo"]) if ep == 0
               else (cols["mac1_hi"], cols["mac1_lo"]))
        tags = {
            **shared,
            "code_id": torch.where(has_mac, S.CODE_SINGLE_MAC_IP_PORT, S.CODE_SINGLE_IP_PORT),
            "ip0_w0": ip[0], "ip0_w1": ip[1], "ip0_w2": ip[2], "ip0_w3": ip[3],
            "l3_epc_id": epc0 if ep == 0 else epc1,
            "mac0_hi": torch.where(has_mac, mac[0], zero),
            "mac0_lo": torch.where(has_mac, mac[1], zero),
            "direction": d, "tap_side": d,
            "server_port": zero if ep == 0 else dst_port,
            "gpid0": cols["gpid0"] if ep == 0 else cols["gpid1"],
        }
        lanes.append((matrix(tags), lane_valid, meters if ep == 0 else rev))
    both_none = (dir0 == 0) & (dir1 == 0)
    for ep in (0, 1):
        d = dir0 if ep == 0 else dir1
        if ep == 1:
            d = torch.where(both_none, torch.where(is_otel, S.DIR_APP, S.DIR_NONE), d)
            lane_valid = valid & ((dir1 != 0) | both_none)
        else:
            lane_valid = valid & (d != 0)
        lane_valid = lane_valid & (is_packet | (sig == S.SIG_XFLOW))
        is_ll = d == S.DIR_LOCAL
        m0 = [torch.where(vip0 | is_ll, cols[f], zero) for f in ("mac0_hi", "mac0_lo")]
        m1 = [torch.where(vip1 | is_ll, cols[f], zero) for f in ("mac1_hi", "mac1_lo")]
        any_mac = (m0[0] | m0[1] | m1[0] | m1[1]) != 0
        src = [torch.where(keep0, w, zero) for w in ip0]
        tags = {
            **shared,
            "code_id": torch.where(any_mac, S.CODE_EDGE_MAC_IP_PORT, S.CODE_EDGE_IP_PORT),
            **{f"ip0_w{w}": src[w] for w in range(4)},
            **{f"ip1_w{w}": ip1[w] for w in range(4)},
            "l3_epc_id": epc0, "l3_epc_id1": epc1,
            "mac0_hi": m0[0], "mac0_lo": m0[1], "mac1_hi": m1[0], "mac1_lo": m1[1],
            "direction": d, "tap_side": d, "server_port": dst_port,
            "tap_port": cols["tap_port"], "gpid0": cols["gpid0"], "gpid1": cols["gpid1"],
        }
        lanes.append((matrix(tags), lane_valid, meters))
    return lanes


@dataclasses.dataclass
class WindowDocs:
    """One window's documents: [G, D] int64 tags and [G, M] meters,
    rows in ascending order of their key columns."""

    tags: torch.Tensor
    meters: torch.Tensor


def rollup(parts, meter_dtype=torch.float64) -> WindowDocs:
    """The documents of one window from its record `parts`: a list of
    (cols, meters) in arrival order, one per batch that carried records
    of the window (each already cut to those records). Sums and maxima
    run in `meter_dtype`."""
    tags, meters, order, rhi, rlo = [], [], [], [], []
    for p, (cols, m) in enumerate(parts):
        hi, lo = raw_fingerprint(cols)
        for lane, (t, v, lm) in enumerate(fanout_l4(cols, m.to(meter_dtype))):
            tags.append(t[v])
            meters.append(lm[v])
            order.append(torch.full((int(v.sum()),), 4 * p + lane, dtype=torch.int64,
                                    device=t.device))
            rhi.append(hi[v])
            rlo.append(lo[v])
    tags, meters = torch.cat(tags), torch.cat(meters)
    # arrival order: (batch, lane, raw fingerprint), by stable LSD sorts
    pos = torch.arange(tags.shape[0], device=tags.device)
    for key in (torch.cat(rlo), torch.cat(rhi), torch.cat(order)):
        pos = pos[torch.sort(key[pos], stable=True).indices]
    tags, meters = tags[pos], meters[pos]
    keys, inv = torch.unique(tags[:, list(S.DOC_KEY_INDEX)], dim=0, return_inverse=True)
    g = keys.shape[0]
    first = torch.full((g,), tags.shape[0], dtype=torch.int64, device=tags.device)
    first.scatter_reduce_(0, inv, torch.arange(tags.shape[0], device=tags.device), "amin")
    out_tags = tags[first]
    out_m = torch.zeros((g, N_METER), dtype=meter_dtype, device=tags.device)
    sums = list(S.METER_SUM)
    out_m[:, sums] = torch.zeros((g, len(sums)), dtype=meter_dtype,
                                 device=tags.device).index_add_(0, inv, meters[:, sums])
    for c in S.METER_MAX:
        col = torch.zeros((g,), dtype=meter_dtype, device=tags.device)
        out_m[:, c] = col.scatter_reduce(0, inv, meters[:, c], "amax", include_self=False)
    return WindowDocs(tags=out_tags, meters=out_m)


def window_parts(stream, w: int, last_batch: int, dtype=torch.float32):
    """The record parts of window w: the rows of each replay batch that
    are stamped w (batches w − t0 to w − t0 + the mix's largest
    lateness, those handed in by `last_batch`), as (cols, meters)
    pairs."""
    parts = []
    first = w - stream.start_time
    for k in range(first, first + stream.max_late + 1):
        if k < 0 or k > last_batch:
            continue
        tags, meters, _ = stream.batch(stream.pool_of(k), stream.time_of(k))
        keep = tags[0] == w
        parts.append(({f: tags[i][keep] for i, f in enumerate(S.FLOW_FIELDS)},
                      meters[keep].to(dtype)))
    return parts


def window_schedule(bounds, delay: int, interval: int = 1) -> list[dict]:
    """The host's window protocol over per-batch (t_min, t_max): for each
    batch the late gate its records meet and the windows its advance
    closes ([lo, hi))."""
    start = None
    out = []
    for t_min, t_max in bounds:
        gate = 0 if start is None else start
        if start is None:
            start = max(0, min(t_min, t_max - delay)) // interval
        new = max(t_max - delay, 0) // interval
        closes = (start, new) if start < new else None
        start = max(start, new)
        out.append({"gate": gate, "closes": closes, "t_min": t_min})
    return out


def docs_of_batch(stream, b: int) -> tuple[int, int]:
    """(valid document rows after the batch-local pre-reduce, distinct
    raw records) of pool batch b — the same for every replay of it."""
    tags, meters, _ = stream.batch(b, stream.start_time + 1)
    cols = {f: tags[i] for i, f in enumerate(S.FLOW_FIELDS)}
    var = [i for i in range(tags.shape[0]) if not bool((tags[i] == tags[i][0]).all())]
    _, first = _unique_rows(tags[var].t())
    distinct = {f: v[first] for f, v in cols.items()}
    lanes = fanout_l4(distinct, meters[first])
    return sum(int(v.sum()) for _, v, _ in lanes), int(first.shape[0])


def _unique_rows(x: torch.Tensor):
    """(inverse, first row of each distinct row) of an [n, k] matrix."""
    _, inv = torch.unique(x, dim=0, return_inverse=True)
    first = torch.full((int(inv.max()) + 1,), x.shape[0], dtype=torch.int64, device=x.device)
    first.scatter_reduce_(0, inv, torch.arange(x.shape[0], device=x.device), "amin")
    return inv, first


def compare_docs(prog_tags: torch.Tensor, prog_meters: torch.Tensor,
                 ref: WindowDocs) -> dict:
    """Hold one of the system's closed windows ([n, D] tags, [n, M] f32
    meters) against the reference's. Returns the numbers compared:
    `docs_unmatched` (document keys on one side only, or repeated on the
    program's), `nonkey_mismatch` (matched documents whose non-key
    columns differ), `max_mismatch` (matched MAX meter cells that
    differ), `sum_exact_mismatch` (matched SUM cells below 2^24 that
    differ: every partial sum of these non-negative whole numbers is
    exact in float32, in any order) and `sum_rel_gap` (the widest gap of
    a SUM cell at or above 2^24, relative to the reference's value)."""
    dev = ref.tags.device
    p_tags = prog_tags.to(dev, torch.int64)
    p_meters = prog_meters.to(dev, torch.float64)
    ki = list(S.DOC_KEY_INDEX)
    p_keys, p_inv, p_cnt = torch.unique(p_tags[:, ki], dim=0, return_inverse=True,
                                        return_counts=True)
    r_keys = ref.tags[:, ki]
    both, inv, cnt = torch.unique(torch.cat([p_keys, r_keys]), dim=0, return_inverse=True,
                                  return_counts=True)
    unmatched = int((cnt == 1).sum()) + int((p_cnt - 1).sum())
    out = {"docs_unmatched": unmatched, "nonkey_mismatch": 0, "max_mismatch": 0,
           "sum_exact_mismatch": 0, "sum_rel_gap": 0.0}
    # matched rows: the program's first row of each key, aligned to the
    # reference's row of the same key
    pos_of = torch.full((both.shape[0],), -1, dtype=torch.int64, device=dev)
    pos_of[inv[p_keys.shape[0]:]] = torch.arange(r_keys.shape[0], device=dev)
    p_first = torch.full((p_keys.shape[0],), p_tags.shape[0], dtype=torch.int64, device=dev)
    p_first.scatter_reduce_(0, p_inv, torch.arange(p_tags.shape[0], device=dev), "amin")
    r_row = pos_of[inv[:p_keys.shape[0]]]
    ok = r_row >= 0
    if not bool(ok.any()):
        return out
    pr, rr = p_first[ok], r_row[ok]
    nk = list(S.DOC_NON_KEY_INDEX)
    out["nonkey_mismatch"] = int((p_tags[pr][:, nk] != ref.tags[rr][:, nk]).any(1).sum())
    mx = list(S.METER_MAX)
    out["max_mismatch"] = int((p_meters[pr][:, mx] != ref.meters[rr][:, mx].double()).sum())
    sm = list(S.METER_SUM)
    r_sum = ref.meters[rr][:, sm].double()
    p_sum = p_meters[pr][:, sm]
    small = r_sum.abs() < 2**24
    out["sum_exact_mismatch"] = int(((p_sum != r_sum) & small).sum())
    gap = torch.where(small, 0.0, (p_sum - r_sum).abs() / r_sum.abs().clamp(min=1.0))
    out["sum_rel_gap"] = float(gap.max()) if gap.numel() else 0.0
    return out
