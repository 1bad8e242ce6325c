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
order, ties included.

Layout at the interface matches the reference: tags column-major
[T, N], meters row-major [N, M] (row-contiguous — the kernel reads one
row per step), key lanes u32 (ops/u32.py lane rule).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .segreduce import sorted_segment_sum_max
from .u32 import U32_MAX

# Sentinel slot value for invalid rows: sorts after every real window.
SENTINEL_SLOT = 0xFFFFFFFF


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


def sort_keys(slot, key_hi, key_lo, valid):
    """Normalize invalid rows to (SENTINEL_SLOT, U32_MAX, U32_MAX) and
    sort stably by (slot, hi, lo). Returns (s_slot, s_hi, s_lo, perm)
    with perm int64 mapping sorted position → original row."""
    slot = torch.where(valid, slot, SENTINEL_SLOT)
    key_hi = torch.where(valid, key_hi, U32_MAX)
    key_lo = torch.where(valid, key_lo, U32_MAX)
    p1 = torch.sort(key_lo, stable=True).indices
    packed = ((slot[p1] - (1 << 31)) << 32) + key_hi[p1]
    perm = p1[torch.sort(packed, stable=True).indices]
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
