"""Invertible top-K heavy-hitter sketch (port of deepflow_tpu/ops/topk.py).

`[rows, cols]` buckets per window slot; each key maps to one bucket per
hash row through an avalanche of its 64-bit fingerprint, and every
bucket runs a weighted MJRTY vote. Per batch, each bucket sees ONE
challenger — the heaviest (window, key) run among the rows that hash
there, first-seen on ties — extracted from the sketch plane's shared
(window, key_hi, key_lo) sort (`topk_challengers_presorted`), and the
vote epilogue `_apply_challengers` folds it in. On the card the
challenger scan runs inside the fused sketch kernel
(ops/sketch_fused.py); the epilogue stays outside it, as in the
reference.

Lane dtypes: votes int32; key and id lanes int32 bit patterns of u32
values (ops/u32.to_i32_bits), so that a packed block row is one int32
concatenation. `topk_init` builds such lanes; `topk_update` is the
reference's multi-sort ORACLE — one fresh stable 3-key (bucket, key_hi,
key_lo) sort per hash row — which the sketch plane takes under
DEEPFLOW_SHARED_SORT=0 and which the shared-sort path equals bit for
bit. `topk_tile` (pool promotion) and `topk_merge` act on lane tuples;
`topk_candidates`/`topk_select` are the host inversion over fetched
blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .cms import as_i32
from .segment import sort_perm
from .u32 import MASK, mul, to_i32_bits

MIX_A = 0x7FEB352D
MIX_B = 0x846CA68B


def topk_init(rows: int, cols: int, ring: int = 1, *, device=None):
    """→ (votes, key_hi, key_lo, id_a, id_b) int32 lanes, each [ring,
    rows, cols] on `device` (ring = per-window slots; 1 = a single
    sketch). votes <= 0 marks an empty bucket."""
    dev = resolve_device(device)
    return tuple(torch.zeros((ring, rows, cols), dtype=torch.int32, device=dev)
                 for _ in range(5))


def bucket_cols(key_hi: torch.Tensor, key_lo: torch.Tensor, row: int,
                cols: int) -> torch.Tensor:
    """[N] int64 bucket column of hash row `row` for u32 key lanes
    (Kirsch–Mitzenmacher base + an avalanche unlike the count-min's)."""
    assert cols & (cols - 1) == 0, "cols must be a power of two"
    h = (key_hi + mul(key_lo, row + 1)) & MASK
    h = h ^ (h >> 16)
    h = mul(h, MIX_A)
    h = h ^ (h >> 15)
    h = mul(h, MIX_B)
    h = h ^ (h >> 16)
    return h & (cols - 1)


def _apply_challengers(lanes, challengers):
    """Weighted-MJRTY vote epilogue: apply, per hash row, ONE challenger
    per flat [R*C] bucket. `lanes` = (votes, hi, lo, ia, ib), each
    [R, d, C] int32; `challengers` is a list of (got, h_hi, h_lo, h_ia,
    h_ib, hw) per hash row, flat [R*C], hw ≥ 0 and 0 wherever got is
    False. Returns new lane tensors (int32 adds wrap like XLA's)."""
    votes, l_hi, l_lo, l_ia, l_ib = (x.clone() for x in lanes)
    r_ring, _, c = votes.shape
    for r, (got, h_hi, h_lo, h_ia, h_ib, hw) in enumerate(challengers):
        v = votes[:, r, :].reshape(-1)
        bh = l_hi[:, r, :].reshape(-1)
        bl = l_lo[:, r, :].reshape(-1)
        ba = l_ia[:, r, :].reshape(-1)
        bb = l_ib[:, r, :].reshape(-1)
        live = v > 0
        same = live & (bh == h_hi) & (bl == h_lo)
        challenged = torch.where(live, v - hw, -hw)
        take = got & ~same & (challenged < 0)
        new_v = torch.where(same, v + hw, torch.where(take, -challenged, challenged))
        new_v = torch.where(got, new_v, v)
        votes[:, r, :] = new_v.view(r_ring, c)
        l_hi[:, r, :] = torch.where(take, h_hi, bh).view(r_ring, c)
        l_lo[:, r, :] = torch.where(take, h_lo, bl).view(r_ring, c)
        l_ia[:, r, :] = torch.where(take, h_ia, ba).view(r_ring, c)
        l_ib[:, r, :] = torch.where(take, h_ib, bb).view(r_ring, c)
    return votes, l_hi, l_lo, l_ia, l_ib


def _heaviest_run(seg, rw, s_hi, s_lo, s_ia, s_ib, segs: int) -> tuple:
    """One hash row's challengers over rows in sorted order: per bucket
    `seg` (segs = none) the heaviest run weight `rw` and its first row
    (the stable tie-break) → (got, h_hi, h_lo, h_ia, h_ib, hw), flat
    [segs], key/id lanes as int32 bits."""
    n = s_hi.shape[0]
    dev = s_hi.device
    heavy_w = torch.full((segs + 1,), -(2 ** 31), dtype=torch.int32, device=dev)
    heavy_w.scatter_reduce_(0, seg, rw, "amax")
    heavy_w = heavy_w[:segs]
    is_heavy = (seg < segs) & (rw == heavy_w[seg.clamp(max=segs - 1)])
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    win_row = torch.full((segs + 1,), n, dtype=torch.int64, device=dev)
    win_row.scatter_reduce_(0, seg, torch.where(is_heavy, iota, n), "amin")
    win_row = win_row[:segs]
    got = win_row < n
    wr = win_row.clamp(0, n - 1)
    hw = torch.where(got, heavy_w.clamp(min=0), 0)
    return (got, to_i32_bits(s_hi[wr]), to_i32_bits(s_lo[wr]), to_i32_bits(s_ia[wr]),
            to_i32_bits(s_ib[wr]), hw)


def topk_update(lanes, slot, key_hi, key_lo, id_a, id_b, weight, valid):
    """One batch of weighted observations into the [R, d, C] lanes — the
    multi-sort oracle: per hash row one fresh stable (bucket, key_hi,
    key_lo) sort, run weights, and per bucket the heaviest run's first
    row as the challenger. `slot` [N] is the per-row ring index; rows
    with slot outside [0, R) or valid False are dropped. key/id lanes
    are u32 (int64); `weight` is cast to int32 as XLA casts it. Returns
    new lane tensors."""
    r_ring, d, c = lanes[0].shape
    n = key_hi.shape[0]
    segs = r_ring * c
    if n == 0:  # no row: no bucket gets a challenger
        return tuple(x.clone() for x in lanes)
    slot = slot.to(torch.int64)
    w = torch.where(valid, as_i32(weight), 0)
    ok = valid & (slot >= 0) & (slot < r_ring)
    challengers = []
    for r in range(d):
        seg = torch.where(ok, slot * c + bucket_cols(key_hi, key_lo, r, c), segs)
        perm = sort_perm(seg, key_hi, key_lo)
        s_seg, s_hi, s_lo = seg[perm], key_hi[perm], key_lo[perm]
        first = torch.ones(n, dtype=torch.bool, device=key_hi.device)
        first[1:] = ((s_seg[1:] != s_seg[:-1]) | (s_hi[1:] != s_hi[:-1])
                     | (s_lo[1:] != s_lo[:-1]))
        run_id = torch.cumsum(first, 0) - 1
        run_w = torch.zeros(n, dtype=torch.int32, device=key_hi.device)
        run_w.index_add_(0, run_id, w[perm])
        challengers.append(_heaviest_run(s_seg, run_w[run_id], s_hi, s_lo, id_a[perm],
                                         id_b[perm], segs))
    return _apply_challengers(lanes, challengers)


def topk_challengers_presorted(s_slot, s_hi, s_lo, s_ia, s_ib, rw, s_mask,
                               r_ring: int, d: int, c: int):
    """Per-hash-row challenger extraction from the ALREADY SORTED batch
    (zero sorts). `rw` [N] int32 is each row's (window, key)-run weight
    under the phase mask `s_mask`; key/id lanes are u32 (int64). A
    bucket only receives rows of one window (the phase span is alias-
    free), so the shared order restricted to a bucket is (key, original
    position): the heaviest run wins, its first row on ties. Returns the
    `_apply_challengers` input list, id lanes as int32 bits."""
    segs = r_ring * c
    if s_hi.shape[0] == 0:  # no row: no bucket got a challenger
        none = torch.zeros((segs,), dtype=torch.int32, device=s_hi.device)
        return [(none != 0,) + (none,) * 5 for _ in range(d)]
    return [_heaviest_run(
        torch.where(s_mask, s_slot * c + bucket_cols(s_hi, s_lo, r, c), segs), rw, s_hi, s_lo,
        s_ia, s_ib, segs) for r in range(d)]


def topk_tile(lanes, cols: int):
    """Up-tile one pooled compact slot's lanes ([d, Cc] each) to [d, cols]
    wide buckets (pool promotion). The bucket hash is width-independent,
    so a key's compact bucket is its wide bucket mod Cc: tiling keeps the
    key's own entry in its true wide bucket; the copies in other wide
    buckets are spurious candidates that `topk_select` dedupes."""
    cc = lanes[0].shape[-1]
    assert cols % cc == 0 and cols & (cols - 1) == 0, (cc, cols)
    return tuple(torch.tile(x, (1, cols // cc)) for x in lanes)


def topk_merge(a, b):
    """Bucket-wise MJRTY combine of two same-shape lane tuples (votes,
    hi, lo, ia, ib): the same key adds votes; different keys leave the
    heavier key with the vote difference."""
    va, ha, la, aa, ab = a
    vb, hb, lb, ba, bb = b
    va, vb = va.clamp(min=0), vb.clamp(min=0)
    same = (ha == hb) & (la == lb)
    take_b = ~same & (vb > va)
    v = torch.where(same, va + vb, (va - vb).abs())
    return (v,) + tuple(torch.where(take_b, y, x)
                        for x, y in ((ha, hb), (la, lb), (aa, ba), (ab, bb)))


def topk_candidates(votes, key_hi, key_lo, id_a, id_b):
    """Host inversion, step 1: every surviving bucket (votes > 0) →
    flat numpy candidate arrays (key_hi, key_lo, id_a, id_b, votes)."""
    v = np.asarray(votes).reshape(-1)
    keep = v > 0

    def flat(x):
        return np.asarray(x).reshape(-1)[keep]

    return flat(key_hi), flat(key_lo), flat(id_a), flat(id_b), v[keep]


def topk_select(cand_hi, cand_lo, cand_ia, cand_ib, estimates, k: int):
    """Host inversion, step 2: dedupe candidates by key, rank by the
    caller's (count-min) estimate, return the top k →
    (hi, lo, id_a, id_b, est int64)."""
    if len(cand_hi) == 0:
        z = np.zeros((0,), np.uint32)
        return z, z, z, z, np.zeros((0,), np.int64)
    key = cand_hi.astype(np.uint64) << np.uint64(32) | cand_lo.astype(np.uint64)
    _, first = np.unique(key, return_index=True)
    est = np.asarray(estimates)[first]
    rank = np.argsort(-est, kind="stable")[: max(0, k)]
    rows = first[rank]
    return (cand_hi[rows], cand_lo[rows], cand_ia[rows], cand_ib[rows],
            est[rank].astype(np.int64))
