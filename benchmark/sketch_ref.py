"""The plain reference of the per-window sketch plane, and its
comparison with a closed window's sketch block.

The plane folds each batch's pre-reduced flow records — one per
distinct raw record of the batch — into its window's summary: HLL
registers of the client address per service group, a count-min plane of
byte weights per flow key, a log-binned histogram of the mean round-trip
time per group, and a weighted majority-vote heavy-hitter sketch with one
challenger per bucket and batch (the heaviest run of one flow key, the
smallest key on ties). The reference recomputes all four from the
generator's records, batch by batch in arrival order, with exact sums
(float64 meters, int64 counters, wrapped to 32 bits where the plane's
int32 lanes wrap).

The program sums each pre-reduced record's bytes in float32, so a flow's
byte weight can differ from the exact one in the last bits once it
passes 2^24; the count-min counters, the histogram bins and the votes
are therefore compared by their widest relative gap, and the HLL
registers, the update count and the candidate keys exactly.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import schema as S
from .reference import _unique_rows
from .u32 import MASK, clz32, cms_cols, fingerprint, mul, topk_cols

I32_MAX = 2**31 - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 value of its low 32 bits (as int64)."""
    x = x & MASK
    return torch.where(x >= 2**31, x - 2**32, x)


def prereduce(cols: dict, meters: torch.Tensor, meter_dtype=torch.float64):
    """Distinct raw records of one batch's part, in raw-fingerprint-free
    order, with summed (and maxed) meters: (cols, meters)."""
    names = list(S.FLOW_FIELDS)
    tags = torch.stack([cols[f] for f in names])
    var = [i for i in range(tags.shape[0]) if not bool((tags[i] == tags[i][0]).all())]
    inv, first = _unique_rows(tags[var].t())
    g = first.shape[0]
    m = meters.to(meter_dtype)
    out = torch.zeros((g, m.shape[1]), dtype=meter_dtype, device=m.device)
    sums = list(S.METER_SUM)
    out[:, sums] = out[:, sums].index_add(0, inv, m[:, sums])
    for c in S.METER_MAX:
        out[:, c] = torch.zeros((g,), dtype=meter_dtype, device=m.device).scatter_reduce(
            0, inv, m[:, c], "amax", include_self=False)
    return {f: cols[f][first] for f in names}, out


def plane_inputs(cols: dict, meters: torch.Tensor, cfg: dict) -> dict:
    """The plane's per-record inputs: group, client fingerprint, flow key
    fingerprint, byte weight (float→int32 saturating truncation), mean
    RTT, and the key's id preview."""
    ip0 = [cols[f"ip0_w{w}"] for w in range(4)]
    ip1 = [cols[f"ip1_w{w}"] for w in range(4)]
    port, proto = cols["server_port"], cols["protocol"]
    c_hi, c_lo = fingerprint(ip0)
    k_hi, k_lo = fingerprint(ip0 + ip1 + [port, proto])
    mi = S.METER_NAMES.index
    byte = meters[:, mi("byte_tx")].double()
    count = meters[:, mi("rtt_count")].double()
    weight = torch.trunc(torch.nan_to_num(byte).clamp(-(2**31), I32_MAX)).long()
    group = ((mul(cols["l3_epc_id1"], 131) + port) & MASK) % cfg["num_groups"]
    return {
        "group": group, "client_hi": c_hi, "client_lo": c_lo, "key_hi": k_hi,
        "key_lo": k_lo, "weight": weight,
        "rtt": meters[:, mi("rtt_sum")].double() / count.clamp(min=1.0),
        "rtt_valid": count > 0, "id_a": ip0[3], "id_b": ((port << 16) & MASK) | (proto & 0xFFFF),
    }


def hist_bin(rtt: torch.Tensor, hist: dict) -> torch.Tensor:
    v = torch.clamp(rtt, min=hist["vmin"])
    b = torch.floor(torch.log(v / hist["vmin"]) / math.log(hist["gamma"]))
    return b.clamp(0, hist["bins"] - 1).long()


def window_sketch(parts, cfg: dict, meter_dtype=torch.float64) -> dict:
    """The reference block of one window from its record parts (arrival
    order): n_updates, hll [G, m], cms [D, W] (unwrapped int64), hist
    [G, B], the top-K lanes (votes, hi, lo, id_a, id_b) [d, C] and the
    distinct clients counted exactly."""
    g, m = cfg["num_groups"], 1 << cfg["hll_precision"]
    d_cms, w_cms = cfg["cms_depth"], cfg["cms_width"]
    d_tk, c_tk = cfg["topk_rows"], cfg["topk_cols"]
    hist = cfg["hist"]
    dev = parts[0][1].device
    hll = torch.zeros(g * m, dtype=torch.int64, device=dev)
    cms = torch.zeros(d_cms * w_cms, dtype=torch.int64, device=dev)
    hst = torch.zeros(g * hist["bins"], dtype=torch.int64, device=dev)
    votes = torch.zeros((d_tk, c_tk), dtype=torch.int64, device=dev)
    lanes = [torch.zeros((d_tk, c_tk), dtype=torch.int64, device=dev) for _ in range(4)]
    n_updates = 0
    clients = []
    for cols, meters in parts:
        rc, rm = prereduce(cols, meters, meter_dtype)
        x = plane_inputs(rc, rm, cfg)
        n = x["group"].shape[0]
        n_updates += n
        clients.append(torch.stack([x["client_hi"], x["client_lo"]], 1))
        reg = x["client_lo"] & (m - 1)
        rho = clz32(x["client_hi"]) + 1
        hll.scatter_reduce_(0, x["group"] * m + reg, rho, "amax")
        b = hist_bin(x["rtt"], hist)
        hst.index_add_(0, (x["group"] * hist["bins"] + b)[x["rtt_valid"]],
                       torch.ones(n, dtype=torch.int64, device=dev)[x["rtt_valid"]])
        # runs of one flow key, their int32-wrapped weights and the key order
        keys = torch.stack([x["key_hi"], x["key_lo"]], 1)
        uk, inv = torch.unique(keys, dim=0, return_inverse=True)
        rw = _wrap32(torch.zeros(uk.shape[0], dtype=torch.int64, device=dev)
                     .index_add_(0, inv, _wrap32(x["weight"])))
        cms.index_add_(0, (cms_cols(uk[:, 0], uk[:, 1], d_cms, w_cms)
                           + torch.arange(d_cms, device=dev)[:, None] * w_cms).reshape(-1),
                       torch.zeros(uk.shape[0], dtype=torch.int64, device=dev)
                       .index_add_(0, inv, x["weight"]).repeat(d_cms))
        first = torch.full((uk.shape[0],), n, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
        ida, idb = x["id_a"][first], x["id_b"][first]
        rank = torch.arange(uk.shape[0], device=dev)  # unique() sorts keys ascending
        for r in range(d_tk):
            col = topk_cols(uk[:, 0], uk[:, 1], r, c_tk)
            heavy = torch.full((c_tk,), -(2**31), dtype=torch.int64, device=dev)
            heavy.scatter_reduce_(0, col, rw, "amax")
            is_heavy = rw == heavy[col]
            win = torch.full((c_tk,), uk.shape[0], dtype=torch.int64, device=dev)
            win.scatter_reduce_(0, col, torch.where(is_heavy, rank, uk.shape[0]), "amin")
            got = win < uk.shape[0]
            wr = win.clamp(max=uk.shape[0] - 1)
            hw = torch.where(got, heavy.clamp(min=0), 0)
            h_hi, h_lo = uk[wr, 0], uk[wr, 1]
            v = votes[r]
            live = v > 0
            same = live & (lanes[0][r] == h_hi) & (lanes[1][r] == h_lo)
            challenged = _wrap32(torch.where(live, v - hw, -hw))
            take = got & ~same & (challenged < 0)
            new_v = torch.where(same, _wrap32(v + hw),
                                torch.where(take, _wrap32(-challenged), challenged))
            votes[r] = torch.where(got, new_v, v)
            for lane, val in zip(lanes, (h_hi, h_lo, ida[wr], idb[wr])):
                lane[r] = torch.where(take, val, lane[r])
    distinct = int(torch.unique(torch.cat(clients), dim=0).shape[0])
    return {"n_updates": n_updates, "hll": hll.view(g, m), "cms": cms.view(d_cms, w_cms),
            "hist": hst.view(g, hist["bins"]), "votes": votes, "tk": lanes,
            "distinct_exact": distinct}


def hll_estimate(regs: np.ndarray) -> float:
    """Classic HLL with the small-range correction, over the register
    union of all groups."""
    r = regs.max(axis=0).astype(np.float64)
    m = r.shape[0]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / np.sum(np.exp2(-r))
    zeros = float(np.sum(r == 0))
    if raw <= 2.5 * m and zeros > 0:
        return m * math.log(m / zeros)
    return raw


def compare_block(block, cfg: dict, parts, meter_dtype=torch.float64) -> dict:
    """Numbers of one window's sketch block against the reference's:
    `sk_updates_gap`, `hll_mismatch` (registers), `cms_rel_gap`,
    `hist_moved_gap` (share of rows in another bin), `topk_keys_unmatched`
    (candidate keys on one side only), `topk_vote_gap` (relative to the
    largest vote) and `distinct_rel_gap` (the block's distinct() against
    the exact count of clients). A missing block fails every number."""
    ref = window_sketch(parts, cfg, meter_dtype)
    if block is None:
        return {"sk_updates_gap": ref["n_updates"], "hll_mismatch": ref["hll"].numel(),
                "cms_rel_gap": 1.0, "hist_moved_gap": 1.0, "topk_keys_unmatched": 1,
                "topk_vote_gap": 1.0, "distinct_rel_gap": 1.0}
    hll = ref["hll"].cpu().numpy()
    cms = ref["cms"].cpu().numpy()
    hst = ref["hist"].cpu().numpy()
    p_cms = np.asarray(block.cms, dtype=np.int64)
    diff = (p_cms - cms) & MASK
    diff = np.where(diff >= 2**31, diff - 2**32, diff)
    hist_gap = float(np.abs(np.asarray(block.hist) - hst).sum()) / max(2.0 * hst.sum(), 1.0)
    live = ref["votes"] > 0
    r_keys = sorted(zip(ref["tk"][0][live].tolist(), ref["tk"][1][live].tolist(),
                        ref["votes"][live].tolist()))
    p_keys = sorted(zip(np.asarray(block.tk_hi, np.int64).tolist(),
                        np.asarray(block.tk_lo, np.int64).tolist(),
                        np.asarray(block.tk_votes, np.int64).tolist()))
    rk = [(a, b) for a, b, _ in r_keys]
    pk = [(a, b) for a, b, _ in p_keys]
    unmatched = sum(1 for k in set(rk) | set(pk) if rk.count(k) != pk.count(k))
    vmax = max([v for _, _, v in r_keys] + [1])
    vote_gap = (max(abs(a[2] - b[2]) for a, b in zip(r_keys, p_keys)) / vmax
                if not unmatched and r_keys else (0.0 if not unmatched else 1.0))
    exact = max(ref["distinct_exact"], 1)
    return {
        "sk_updates_gap": abs(int(block.n_updates) - ref["n_updates"]),
        "hll_mismatch": int((np.asarray(block.hll) != hll).sum()),
        "cms_rel_gap": float((np.abs(diff) / np.maximum(cms, 1)).max()),
        "hist_moved_gap": hist_gap,
        "topk_keys_unmatched": unmatched,
        "topk_vote_gap": float(vote_gap),
        "distinct_rel_gap": abs(block.distinct() - exact) / exact,
    }


def touched_cells(stream, b: int, cfg: dict) -> tuple[int, int]:
    """(HLL registers, count-min counters) the records of pool batch b
    touch in one fused update: distinct (window, group, register) over
    its distinct raw records, distinct (window, row, column) over its
    (window, flow key) runs."""
    tags, meters, _ = stream.batch(b, stream.start_time + 1)
    cols = {f: tags[i] for i, f in enumerate(S.FLOW_FIELDS)}
    rc, rm = prereduce(cols, meters)
    x = plane_inputs(rc, rm, cfg)
    m = 1 << cfg["hll_precision"]
    win = rc["timestamp"]
    hll = torch.unique(torch.stack([win, x["group"], x["client_lo"] & (m - 1)], 1), dim=0)
    runs = torch.unique(torch.stack([win, x["key_hi"], x["key_lo"]], 1), dim=0)
    cols_ = cms_cols(runs[:, 1], runs[:, 2], cfg["cms_depth"], cfg["cms_width"])
    cells = torch.stack([runs[:, 0].repeat(cfg["cms_depth"]),
                         torch.arange(cfg["cms_depth"], device=runs.device)
                         .repeat_interleave(runs.shape[0]), cols_.reshape(-1)], 1)
    return int(hll.shape[0]), int(torch.unique(cells, dim=0).shape[0])
