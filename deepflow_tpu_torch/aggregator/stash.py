"""Device-resident document stash (port of deepflow_tpu/aggregator/stash.py).

A fixed-capacity table of (window slot, 64-bit key, tag row, meter row),
kept sorted by (slot, key) by construction: every fold re-sorts the
concatenation of stash and accumulator ring, reduces duplicate keys with
the schema's SUM/MAX ops and keeps the first `capacity` segments.
Segments beyond capacity are dropped and counted (`dropped_overflow`);
since the sort is (slot, key)-ordered, drops land on the newest
window's keys and closing windows are never evicted.

Two folds share this file, as in the reference: the full fold
(`_fold_impl`, one sort of the [S + A] concatenation) and the
incremental merge fold (`_merge_fold_impl`: sort only the ring, rank-
merge it against the standing stash order, optionally bounded to the
windows about to close). The merge fold needs the CANONICAL layout —
live rows a (slot, key)-sorted positional prefix — which every fold
leaves, the compacting range flush (`compact=True`) keeps and
`stash_canonicalize` restores. Both folds are bit-equal.

The JAX package's functions are pure and donate their inputs; here the
accumulator ring is updated IN PLACE (`_append_impl` writes its slice,
the folds reset the slot lanes they consume), which saves a ring-sized
copy per batch.

The live read plane's `stash_snapshot_range` packs the open windows'
rows in the flush layout without touching the stash.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..datamodel.schema import MeterSchema, TagSchema
from ..ops.segment import (
    SENTINEL_SLOT,
    groupby_reduce,
    groupby_reduce_sorted,
    merge_order,
    merge_ranks,
    note_sort,
    sort_perm,
)
from ..ops.u32 import U32_MAX, to_i32_bits


@dataclasses.dataclass
class StashState:
    slot: torch.Tensor  # [S] u32 absolute window index (SENTINEL = empty)
    key_hi: torch.Tensor  # [S] u32
    key_lo: torch.Tensor  # [S] u32
    tags: torch.Tensor  # [T, S] u32 (column-major)
    meters: torch.Tensor  # [M, S] f32
    valid: torch.Tensor  # [S] bool
    dropped_overflow: torch.Tensor  # 0-dim int64, running count of shed segments

    @property
    def capacity(self) -> int:
        return self.slot.shape[0]


@dataclasses.dataclass
class AccumState:
    """Raw-row accumulator ring in front of the stash: each batch is
    appended at the host-tracked fill offset, and ONE sort+reduce folds
    many batches. Invalid rows are sentinel-keyed at append time."""

    slot: torch.Tensor  # [A] u32 (SENTINEL = empty / invalid)
    key_hi: torch.Tensor  # [A] u32
    key_lo: torch.Tensor  # [A] u32
    tags: torch.Tensor  # [T, A] u32
    meters: torch.Tensor  # [M, A] f32

    @property
    def capacity(self) -> int:
        return self.slot.shape[0]


def _lanes(capacity: int, tag_schema: TagSchema, meter_schema: MeterSchema, device):
    i64 = dict(dtype=torch.int64, device=device)
    return dict(
        slot=torch.full((capacity,), SENTINEL_SLOT, **i64),
        key_hi=torch.zeros((capacity,), **i64),
        key_lo=torch.zeros((capacity,), **i64),
        tags=torch.zeros((tag_schema.num_fields, capacity), **i64),
        meters=torch.zeros((meter_schema.num_fields, capacity),
                           dtype=torch.float32, device=device),
    )


def stash_init(capacity: int, tag_schema: TagSchema, meter_schema: MeterSchema,
               *, device) -> StashState:
    lanes = _lanes(capacity, tag_schema, meter_schema, device)
    return StashState(
        **lanes,
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        dropped_overflow=torch.zeros((), dtype=torch.int64, device=device),
    )


def accum_init(capacity: int, tag_schema: TagSchema, meter_schema: MeterSchema,
               *, device) -> AccumState:
    return AccumState(**_lanes(capacity, tag_schema, meter_schema, device))


def sum_max_cols(meter_schema: MeterSchema) -> tuple[np.ndarray, np.ndarray]:
    """The schema's SUM and MAX meter column indices."""
    return (np.nonzero(meter_schema.sum_mask)[0].astype(np.int32),
            np.nonzero(meter_schema.max_mask)[0].astype(np.int32))


def fold_operands(state: StashState, slot, key_hi, key_lo, tags_t, meters_t, valid):
    """The [S + N] group-by operands of a fold: stash rows then batch
    rows, with the meter plane transposed to the row-contiguous [S+N, M]
    layout the segmented-reduce kernel reads."""
    return (
        torch.cat([state.slot, slot]),
        torch.cat([state.key_hi, key_hi]),
        torch.cat([state.key_lo, key_lo]),
        torch.cat([state.tags, tags_t], dim=1),
        torch.cat([state.meters, meters_t], dim=1).t().contiguous(),
        torch.cat([state.valid, valid]),
    )


def _from_grouped(state: StashState, g) -> StashState:
    """The stash a fold's group-by leaves: its segments, with the ones
    past capacity counted into `dropped_overflow`."""
    return StashState(
        slot=g.slot, key_hi=g.key_hi, key_lo=g.key_lo, tags=g.tags, meters=g.meters,
        valid=g.seg_valid,
        dropped_overflow=state.dropped_overflow
        + torch.clamp(g.num_segments - state.capacity, min=0),
    )


def _merge_impl(state: StashState, slot, key_hi, key_lo, tags_t, meters_t, valid,
                sum_cols, max_cols) -> StashState:
    return _from_grouped(state, groupby_reduce(
        *fold_operands(state, slot, key_hi, key_lo, tags_t, meters_t, valid),
        sum_cols, max_cols, out_capacity=state.capacity,
    ))


def _append_impl(acc: AccumState, slot, key_hi, key_lo, tags_t, meters_t, valid,
                 offset: int) -> AccumState:
    """Write one batch into the ring at `offset` (in place). The caller's
    plan (plan_append) guarantees the fit; a misfit raises instead of
    clamping the offset like the reference's dynamic_update_slice."""
    offset = int(offset)
    n = slot.shape[0]
    if offset < 0 or offset + n > acc.capacity:
        raise ValueError(
            f"append of {n} rows at offset {offset} overflows the "
            f"{acc.capacity}-row accumulator ring"
        )
    end = offset + n
    acc.slot[offset:end] = torch.where(valid, slot, SENTINEL_SLOT)
    acc.key_hi[offset:end] = key_hi
    acc.key_lo[offset:end] = key_lo
    acc.tags[:, offset:end] = tags_t
    acc.meters[:, offset:end] = meters_t
    return acc


def _fold_impl(state: StashState, acc: AccumState, sum_cols, max_cols):
    """One sort+reduce over [S + A] rows → fresh stash + emptied ring
    (only the slot lane is reset — sentinel slots make the other lanes
    unreachable, and the next appends overwrite them)."""
    new_state = _merge_impl(state, acc.slot, acc.key_hi, acc.key_lo, acc.tags,
                            acc.meters, acc.slot != SENTINEL_SLOT,
                            sum_cols, max_cols)
    acc.slot.fill_(SENTINEL_SLOT)
    return new_state, acc


def _fold_counted_impl(state: StashState, acc: AccumState, sum_cols, max_cols):
    """`_fold_impl` + the fold_rows scalar (live stash rows + live ring
    rows the fold's keyed sort touched), a device tensor that rides the
    next counter block's CB_FOLD_ROWS lane."""
    fold_rows = state.valid.sum() + (acc.slot != SENTINEL_SLOT).sum()
    new_state, new_acc = _fold_impl(state, acc, sum_cols, max_cols)
    return new_state, new_acc, fold_rows


def stash_fold_counted(state: StashState, acc: AccumState, meter_schema: MeterSchema):
    """Schema-keyed `_fold_counted_impl` → (state, acc, fold_rows)."""
    return _fold_counted_impl(state, acc, *sum_max_cols(meter_schema))


def check_fold_mode(mode: str) -> None:
    """The fold_mode membership check every entry point shares."""
    if mode not in ("full", "merge"):
        raise ValueError(f"fold_mode must be 'full' or 'merge', got {mode!r}")


def _normalized_keys(slot, key_hi, key_lo, keep):
    """Key lanes with every row outside `keep` re-keyed to (SENTINEL,
    U32_MAX, U32_MAX): it sorts after every live row."""
    return (torch.where(keep, slot, SENTINEL_SLOT), torch.where(keep, key_hi, U32_MAX),
            torch.where(keep, key_lo, U32_MAX))


def stash_canonicalize(state: StashState) -> StashState:
    """Re-establish the canonical layout (live rows a (slot, key)-
    ascending positional prefix, dead rows sentinel-keyed behind) with
    one keyed sort; every live row's content is kept bit for bit. For a
    stash that left it, such as one restored from an old checkpoint."""
    sl, hi, lo = _normalized_keys(state.slot, state.key_hi, state.key_lo, state.valid)
    order = sort_perm(sl, hi, lo)
    return StashState(
        slot=sl[order], key_hi=state.key_hi[order], key_lo=state.key_lo[order],
        tags=state.tags[:, order], meters=state.meters[:, order],
        valid=state.valid[order], dropped_overflow=state.dropped_overflow,
    )


def merge_operands(state: StashState, na_sl, na_hi, na_lo, a_perm, acc_tags, acc_meters):
    """The `groupby_reduce_sorted` operands of a rank-merge fold: one run
    merged against the canonical stash. `na_*` are the run's normalized
    key lanes in ring order and `a_perm` their stable sort; the payload
    lanes (`acc_tags` [T, A], `acc_meters` [M, A]) stay unsorted. Returns
    the merged key lanes, the merged order (merged position → row of
    stash ‖ run) and the [T, S+A] tags / row-contiguous [S+A, M] meters
    it indexes — the reduce kernel reads the meter rows through it."""
    s = state.capacity
    ns = _normalized_keys(state.slot, state.key_hi, state.key_lo, state.valid)
    rank_s, rank_a = merge_ranks(ns, (na_sl[a_perm], na_hi[a_perm], na_lo[a_perm]))
    order = merge_order(rank_s, rank_a, torch.arange(s, device=a_perm.device), s + a_perm)
    s_sl, s_hi, s_lo = (torch.cat([a, b])[order] for a, b in zip(ns, (na_sl, na_hi, na_lo)))
    return (s_sl, s_hi, s_lo, order, torch.cat([state.tags, acc_tags], dim=1),
            torch.cat([state.meters, acc_meters], dim=1).t().contiguous())


def _sorted_merge_reduce(state: StashState, na_sl, na_hi, na_lo, a_perm, acc_tags,
                         acc_meters, sum_cols, max_cols) -> StashState:
    """Rank-merge one run against the canonical stash (`merge_operands`)
    and segment-reduce the merged order into a fresh stash."""
    return _from_grouped(state, groupby_reduce_sorted(
        *merge_operands(state, na_sl, na_hi, na_lo, a_perm, acc_tags, acc_meters),
        sum_cols, max_cols, out_capacity=state.capacity,
    ))


def merge_fold_keys(acc: AccumState, hi_window):
    """(fold_mask, normalized ring key lanes, their stable sort) of a
    merge fold: ring rows with slot < hi_window fold, the rest are re-
    keyed to sort last."""
    fold_mask = acc.slot < hi_window
    na = _normalized_keys(acc.slot, acc.key_hi, acc.key_lo, fold_mask)
    return fold_mask, na, sort_perm(*na)


def _merge_fold_impl(state: StashState, acc: AccumState, hi_window, sum_cols, max_cols):
    """Rank-merge fold: sort the ring only, merge it against the sorted
    stash and reduce the merged run. Only ring rows with slot < hi_window
    fold (SENTINEL_SLOT = every live row: the full-set fold); consumed
    rows turn sentinel in place, the rest stay in the ring untouched.
    Requires the canonical stash layout. Returns (state, acc, fold_rows)
    with fold_rows the ring rows this fold sorted."""
    fold_mask, na, a_perm = merge_fold_keys(acc, hi_window)
    new_state = _sorted_merge_reduce(state, *na, a_perm, acc.tags, acc.meters, sum_cols,
                                     max_cols)
    acc.slot.masked_fill_(fold_mask, SENTINEL_SLOT)
    return new_state, acc, fold_mask.sum()


def stash_merge_fold(state: StashState, acc: AccumState, meter_schema: MeterSchema,
                     hi_window: int | None = None):
    """Schema-keyed merge fold → (state, acc, fold_rows). `hi_window`
    None folds every live row (the ring empties: callers reset their fill
    cursor); otherwise only rows with slot < hi_window (the span-bounded
    window advance: callers keep their fill cursor)."""
    hi = SENTINEL_SLOT if hi_window is None else int(hi_window)
    return _merge_fold_impl(state, acc, hi, *sum_max_cols(meter_schema))


def plan_append(fill: int, capacity: int | None, rows: int) -> str:
    """Host-side accumulator decision: 'init' — no ring yet or one too
    small for this batch (fold pending rows BEFORE replacing the ring);
    'fold' — this batch won't fit behind `fill`; 'ok' — append at `fill`."""
    if capacity is None or rows > capacity:
        return "init"
    if fill + rows > capacity:
        return "fold"
    return "ok"


# Packed flush-row layout: [window, key_hi, key_lo, tags…, meters(bitcast)…]
FLUSH_META_COLS = 3


def pack_u32_columns(slot, key_hi, key_lo, tags, meters, valid=None):
    """The packed u32 layout: [K+T+M, S] rows slot, key_hi, key_lo,
    (valid,) tags…, bitcast(meters)…, as int32 bit patterns (the host
    views them as uint32 — byte-identical to the reference's matrix).
    K = FLUSH_META_COLS, +1 with the optional valid lane (the checkpoint
    layout)."""
    meta = [slot[None, :], key_hi[None, :], key_lo[None, :]]
    if valid is not None:
        meta.append(valid.to(torch.int64)[None, :])
    u32 = to_i32_bits(torch.cat(meta + [tags], dim=0))
    return torch.cat([u32, meters.contiguous().view(torch.int32)], dim=0)


def _pack_window_range(state: StashState, lo: int, hi: int):
    """Pack every live row with lo ≤ slot < hi into a row-major
    [S, 3+T+M] matrix ordered by (window, stash position). Returns
    (mask, packed, total)."""
    mask = state.valid & (state.slot >= lo) & (state.slot < hi)
    rank = torch.where(mask, state.slot, SENTINEL_SLOT)
    note_sort()
    order = torch.sort(rank, stable=True).indices
    cols = pack_u32_columns(state.slot, state.key_hi, state.key_lo,
                            state.tags, state.meters)  # [3+T+M, S]
    packed = cols[:, order].t().contiguous()  # [S, 3+T+M]
    return mask, packed, mask.sum()


def _flush_range_impl(state: StashState, lo_window: int, hi_window: int, *,
                      compact: bool = False):
    """Close every window in [lo_window, hi_window): their rows come out
    front-compacted in ONE packed matrix (plus the row count) and their
    slots are reclaimed. Rows are ordered by (window, stash position).

    `compact` keeps the canonical layout the merge fold needs: on a
    canonical stash the flushed rows are the positional prefix [0, total)
    (the closing windows hold the smallest live slots — the window
    managers flush older windows first), so rolling every lane by
    `total` moves the survivors to the front. The flushed output is the
    same either way."""
    mask, packed, total = _pack_window_range(state, lo_window, hi_window)
    slot = torch.where(mask, SENTINEL_SLOT, state.slot)
    valid = state.valid & ~mask
    if not compact:
        return dataclasses.replace(state, slot=slot, valid=valid), packed, total
    idx = (torch.arange(state.capacity, device=slot.device) + total) % state.capacity
    return StashState(
        slot=slot[idx], key_hi=state.key_hi[idx], key_lo=state.key_lo[idx],
        tags=state.tags[:, idx], meters=state.meters[:, idx], valid=valid[idx],
        dropped_overflow=state.dropped_overflow,
    ), packed, total


def stash_snapshot_range(state: StashState, lo_window: int, hi_window):
    """READ-ONLY twin of `_flush_range_impl` (the live read plane): pack
    every live row in [lo_window, hi_window) — same order, layout and
    unpack — without reclaiming a slot or compacting. The stash is not
    written, so the later real flush of the same windows emits the same
    rows plus whatever arrived after the snapshot. Returns (packed,
    total)."""
    _, packed, total = _pack_window_range(state, lo_window, hi_window)
    return packed, total


def unpack_flush_rows(rows: np.ndarray, num_tags: int):
    """Split fetched packed flush rows ([n, 3+T+M] u32, host) back into
    (window, key_hi, key_lo, tags [n, T], meters [n, M] f32)."""
    t0 = FLUSH_META_COLS
    meters = np.ascontiguousarray(rows[:, t0 + num_tags:]).view(np.float32)
    return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, t0:t0 + num_tags], meters
