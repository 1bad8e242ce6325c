"""Sort-based group-by reduction (port of deepflow_tpu/ops/segment.py).

    stable sorts of (slot, key_hi, key_lo) → head flags → segment ids
      → segmented SUM/MAX (ops/segreduce.py: the CUDA kernel on the card,
        plain PyTorch on the CPU) with num_segments = cap
      → representative-row gathers only at the ≤cap segment heads

The reference sorts with one stable 3-key `lax.sort`; among equal keys
the lowest original row supplies the kept tags. PyTorch has no
multi-key sort, so `sort_keys` runs two stable `torch.sort` passes:
first on `lo`, then on one packed int64 key ((slot − 2^31) << 32) + hi,
which orders like the unsigned pair (slot, hi) — SENTINEL_SLOT
included — and never leaves int64. Stable LSD passes give the same
order, ties included. The sketch plane's one shared batch sort
(aggregator/sketchplane.py) reuses the same two passes (`sort_perm`),
with the absolute window in place of the slot and no sentinel rekey.

The incremental merge fold (aggregator/stash.py) merges two runs that
are already sorted by (slot, hi, lo) without sorting them again:
`merge_ranks` finds each element's merged position by a vectorized
binary search (`lex_searchsorted`) into the other run, and
`merge_order` inverts the ranks — a permutation — with one scatter.

Sort census. `sort_census()` opens a per-thread tally that `note_sort`
bumps once per LOGICAL sort: one `sort_perm` call is one sort, although
it runs two `torch.sort` passes. profiling/census.py opens it around a
bucket's first dispatch, the twin of the reference's jaxpr walk over
`sort` equations (`census.py:91-132`). Outside a tally `note_sort` is
one attribute read.

Layout at the interface matches the reference: tags column-major
[T, N], meters row-major [N, M] (row-contiguous — the kernel reads one
row per step), key lanes u32 (ops/u32.py lane rule).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from contextlib import contextmanager

import numpy as np
import torch

from .segreduce import sorted_segment_sum_max
from .u32 import U32_MAX

# Sentinel slot value for invalid rows: sorts after every real window.
SENTINEL_SLOT = 0xFFFFFFFF


def _use_shared_sort() -> bool:
    """The sketch plane's one shared batch sort (default). Bit-exact vs
    the multi-sort oracle, which DEEPFLOW_SHARED_SORT=0 restores: one
    fresh 3-key sort per top-K hash row and fold phase — the
    reference's knob, read at call time."""
    return os.environ.get("DEEPFLOW_SHARED_SORT", "1") != "0"


_SORTS = threading.local()


@contextmanager
def sort_census():
    """Tally the logical sorts this thread runs inside the block:
    yields {"sorts": n, "plane_sorts": n}, the plane's share filled by
    aggregator/sketchplane.sketch_plane_step. Tallies nest; the inner
    one counts alone."""
    prev = getattr(_SORTS, "tally", None)
    tally = {"sorts": 0, "plane_sorts": 0}
    _SORTS.tally = tally
    try:
        yield tally
    finally:
        _SORTS.tally = prev


def active_sort_tally() -> dict | None:
    """This thread's open tally, or None."""
    return getattr(_SORTS, "tally", None)


def note_sort() -> None:
    """Count one logical sort into this thread's open tally, if any."""
    tally = getattr(_SORTS, "tally", None)
    if tally is not None:
        tally["sorts"] += 1


def _use_fused_gather() -> bool:
    """Read meter rows through the sort permutation inside the kernel
    (default). DEEPFLOW_FUSED_GATHER=0 gathers them into sorted order
    first and runs the pre-gathered launcher — the reference's knob,
    read at call time."""
    return os.environ.get("DEEPFLOW_FUSED_GATHER", "1") != "0"


@dataclasses.dataclass
class Grouped:
    """Result of one group-by reduce over N input rows. Payloads are
    column-major; key/flag lanes have leading dim `cap`; `seg_valid`
    marks live segments (a prefix, in sorted key order)."""

    slot: torch.Tensor  # [cap] u32 — window index per segment
    key_hi: torch.Tensor  # [cap] u32
    key_lo: torch.Tensor  # [cap] u32
    tags: torch.Tensor  # [T, cap] u32 — representative (first) row's tags
    meters: torch.Tensor  # [M, cap] f32 — reduced
    seg_valid: torch.Tensor  # [cap] bool
    num_segments: torch.Tensor  # 0-dim int64 — live segments (may exceed cap)


def sort_perm(slot, key_hi, key_lo) -> torch.Tensor:
    """The stable (slot, hi, lo) order of three u32 lanes as an int64
    permutation (sorted position → original row): a stable pass on lo,
    then one on the packed ((slot − 2^31) << 32) + hi."""
    note_sort()
    p1 = torch.sort(key_lo, stable=True).indices
    packed = ((slot[p1] - (1 << 31)) << 32) + key_hi[p1]
    return p1[torch.sort(packed, stable=True).indices]


def sort_keys(slot, key_hi, key_lo, valid):
    """Normalize invalid rows to (SENTINEL_SLOT, U32_MAX, U32_MAX) and
    sort stably by (slot, hi, lo). Returns (s_slot, s_hi, s_lo, perm)
    with perm int64 mapping sorted position → original row."""
    slot = torch.where(valid, slot, SENTINEL_SLOT)
    key_hi = torch.where(valid, key_hi, U32_MAX)
    key_lo = torch.where(valid, key_lo, U32_MAX)
    perm = sort_perm(slot, key_hi, key_lo)
    return slot[perm], key_hi[perm], key_lo[perm], perm


def segment_ids(s_slot, s_hi, s_lo, cap: int):
    """Sorted key lanes → (seg_id int32 [N] ascending, first_pos int32
    [cap], num_seg 0-dim int64). Dead (sentinel) rows get id N, which
    sorts after every live id; first_pos is searchsorted-left."""
    n = s_slot.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=s_slot.device)
    head[1:] = ((s_slot[1:] != s_slot[:-1]) | (s_hi[1:] != s_hi[:-1])
                | (s_lo[1:] != s_lo[:-1]))
    live_row = s_slot != SENTINEL_SLOT
    num_seg = (head & live_row).sum()
    seg_id = torch.cumsum(head, 0, dtype=torch.int32) - 1
    seg_id = torch.where(live_row, seg_id, n)
    first_pos = torch.searchsorted(
        seg_id, torch.arange(cap, dtype=torch.int32, device=s_slot.device),
        out_int32=True,
    )
    return seg_id, first_pos, num_seg


def groupby_reduce(slot, key_hi, key_lo, tags_t, meters_rows, valid,
                   sum_cols: np.ndarray, max_cols: np.ndarray,
                   out_capacity: int | None = None) -> Grouped:
    """Group rows by (slot, key_hi, key_lo) and reduce meters.

    slot/key_hi/key_lo: [N] u32 lanes (invalid rows are re-keyed to the
    sentinel); tags_t [T, N] u32; meters_rows [N, M] f32 row-contiguous;
    valid [N] bool. sum_cols/max_cols partition range(M). Segments past
    `out_capacity` (default N) are dropped but counted in num_segments.
    """
    s_slot, s_hi, s_lo, perm = sort_keys(slot, key_hi, key_lo, valid)
    return groupby_reduce_sorted(s_slot, s_hi, s_lo, perm, tags_t, meters_rows,
                                 sum_cols, max_cols, out_capacity=out_capacity)


def groupby_reduce_sorted(s_slot, s_hi, s_lo, perm, tags_t, meters_rows,
                          sum_cols: np.ndarray, max_cols: np.ndarray,
                          out_capacity: int | None = None) -> Grouped:
    """The post-sort phase of `groupby_reduce`: key lanes in ascending
    (slot, hi, lo) order, pre-normalized; `perm` maps sorted position →
    original row of tags_t / meters_rows."""
    n = s_slot.shape[0]
    m = meters_rows.shape[1]
    cap = int(out_capacity) if out_capacity is not None else n
    dev = s_slot.device
    seg_id, first_pos, num_seg = segment_ids(s_slot, s_hi, s_lo, cap)

    if m:
        perm32 = perm.to(torch.int32)
        if _use_fused_gather():
            ps, pm = sorted_segment_sum_max(meters_rows, seg_id, cap, first_pos,
                                            perm=perm32)
        else:
            ps, pm = sorted_segment_sum_max(
                meters_rows.index_select(0, perm), seg_id, cap, first_pos
            )
        is_sum = np.zeros((m,), bool)
        is_sum[np.asarray(sum_cols, np.int64)] = True
        out_meters = torch.where(torch.from_numpy(is_sum).to(dev)[None, :], ps, pm).t()
    else:
        out_meters = torch.zeros((0, cap), dtype=meters_rows.dtype, device=dev)

    k = torch.arange(cap, device=dev)
    seg_valid = k < torch.clamp(num_seg, max=cap)
    fp = torch.where(seg_valid, first_pos.long(), 0)
    out_slot = torch.where(seg_valid, s_slot[fp], SENTINEL_SLOT)
    out_hi = torch.where(seg_valid, s_hi[fp], 0)
    out_lo = torch.where(seg_valid, s_lo[fp], 0)
    rep_orig = perm[fp]
    out_tags = torch.where(seg_valid[None, :], tags_t[:, rep_orig], 0)
    out_meters = torch.where(seg_valid[None, :], out_meters, 0.0).contiguous()
    return Grouped(slot=out_slot, key_hi=out_hi, key_lo=out_lo, tags=out_tags,
                   meters=out_meters, seg_valid=seg_valid, num_segments=num_seg)


def _lex_less(a_sl, a_hi, a_lo, b_sl, b_hi, b_lo):
    """Elementwise lexicographic (slot, hi, lo) compare of u32 lanes."""
    return (a_sl < b_sl) | ((a_sl == b_sl) & ((a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))))


def lex_searchsorted(keys, queries, *, side: str) -> torch.Tensor:
    """`searchsorted` over a lexicographic (slot, hi, lo) triple: keys
    [N] ascending under `_lex_less`, queries [Q] → [Q] int64 insertion
    points (side="left": keys strictly less; "right": keys less or
    equal). A binary search unrolled ceil(log2(N+1)) times, one 3-lane
    gather and compare per step."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    k_sl, k_hi, k_lo = keys
    q_sl, q_hi, q_lo = queries
    n = int(k_sl.shape[0])
    lo = torch.zeros(q_sl.shape, dtype=torch.int64, device=q_sl.device)
    if n == 0:
        return lo
    hi = torch.full(q_sl.shape, n, dtype=torch.int64, device=q_sl.device)
    for _ in range(n.bit_length()):
        # a finished lane (lo == hi == n) would read past the end: clamp
        # it, its result is masked out below
        mid = ((lo + hi) >> 1).clamp_(max=n - 1)
        m_sl, m_hi, m_lo = k_sl[mid], k_hi[mid], k_lo[mid]
        if side == "left":
            go_right = _lex_less(m_sl, m_hi, m_lo, q_sl, q_hi, q_lo)
        else:
            go_right = ~_lex_less(q_sl, q_hi, q_lo, m_sl, m_hi, m_lo)
        active = lo < hi
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo


def merge_ranks(first, second):
    """Merged positions of two key-sorted (slot, hi, lo) runs: `first`
    elements precede equal `second` elements and each run keeps its own
    order — the order a stable sort of first ‖ second gives. Returns
    (rank_first [S], rank_second [A]) int64, together a permutation of
    [0, S + A)."""
    dev = first[0].device
    rank_f = torch.arange(first[0].shape[0], device=dev) + lex_searchsorted(
        second, first, side="left")
    rank_s = torch.arange(second[0].shape[0], device=dev) + lex_searchsorted(
        first, second, side="right")
    return rank_f, rank_s


def merge_order(rank_f, rank_s, payload_f, payload_s) -> torch.Tensor:
    """Invert merge ranks into a gather order: [S + A] int64 whose
    position p holds the payload of the element of merged rank p. The
    ranks are a permutation, so one scatter does it (the reference's
    DEEPFLOW_MERGE_SCATTER=1 form; its default sort gives the same)."""
    rank = torch.cat([rank_f, rank_s])
    order = torch.empty_like(rank)
    order[rank] = torch.cat([payload_f, payload_s]).to(torch.int64)
    return order
