"""Device-resident document stash — full-fold half (port of
deepflow_tpu/aggregator/stash.py).

A fixed-capacity table of (window slot, 64-bit key, tag row, meter row),
kept sorted by (slot, key) by construction: every fold re-sorts the
concatenation of stash and accumulator ring, reduces duplicate keys with
the schema's SUM/MAX ops and keeps the first `capacity` segments.
Segments beyond capacity are dropped and counted (`dropped_overflow`);
since the sort is (slot, key)-ordered, drops land on the newest
window's keys and closing windows are never evicted.

The JAX package's functions are pure and donate their inputs; here the
accumulator ring is updated IN PLACE (`_append_impl` writes its slice,
`_fold_impl` resets the slot lane), which saves a ring-sized copy per
batch. The incremental merge-fold, the live snapshot and the compacting
range flush are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..datamodel.schema import MeterSchema, TagSchema
from ..ops.segment import SENTINEL_SLOT, groupby_reduce
from ..ops.u32 import to_i32_bits


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


def _merge_impl(state: StashState, slot, key_hi, key_lo, tags_t, meters_t, valid,
                sum_cols, max_cols) -> StashState:
    s = state.capacity
    g = groupby_reduce(
        *fold_operands(state, slot, key_hi, key_lo, tags_t, meters_t, valid),
        sum_cols, max_cols, out_capacity=s,
    )
    dropped = torch.clamp(g.num_segments - s, min=0)
    return StashState(
        slot=g.slot, key_hi=g.key_hi, key_lo=g.key_lo, tags=g.tags,
        meters=g.meters, valid=g.seg_valid,
        dropped_overflow=state.dropped_overflow + dropped,
    )


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


def pack_u32_columns(slot, key_hi, key_lo, tags, meters):
    """The packed flush layout: [3+T+M, S] u32 rows slot, key_hi, key_lo,
    tags…, bitcast(meters)…, as int32 bit patterns (the host views them
    as uint32 — byte-identical to the reference's matrix)."""
    meta = [slot[None, :], key_hi[None, :], key_lo[None, :]]
    u32 = to_i32_bits(torch.cat(meta + [tags], dim=0))
    return torch.cat([u32, meters.contiguous().view(torch.int32)], dim=0)


def _pack_window_range(state: StashState, lo: int, hi: int):
    """Pack every live row with lo ≤ slot < hi into a row-major
    [S, 3+T+M] matrix ordered by (window, stash position). Returns
    (mask, packed, total)."""
    mask = state.valid & (state.slot >= lo) & (state.slot < hi)
    rank = torch.where(mask, state.slot, SENTINEL_SLOT)
    order = torch.sort(rank, stable=True).indices
    cols = pack_u32_columns(state.slot, state.key_hi, state.key_lo,
                            state.tags, state.meters)  # [3+T+M, S]
    packed = cols[:, order].t().contiguous()  # [S, 3+T+M]
    return mask, packed, mask.sum()


def _flush_range_impl(state: StashState, lo_window: int, hi_window: int):
    """Close every window in [lo_window, hi_window): their rows come out
    front-compacted in ONE packed matrix (plus the row count) and their
    slots are reclaimed. Rows are ordered by (window, stash position)."""
    mask, packed, total = _pack_window_range(state, lo_window, hi_window)
    new_state = dataclasses.replace(
        state,
        slot=torch.where(mask, SENTINEL_SLOT, state.slot),
        valid=state.valid & ~mask,
    )
    return new_state, packed, total


def unpack_flush_rows(rows: np.ndarray, num_tags: int):
    """Split fetched packed flush rows ([n, 3+T+M] u32, host) back into
    (window, key_hi, key_lo, tags [n, T], meters [n, M] f32)."""
    t0 = FLUSH_META_COLS
    meters = np.ascontiguousarray(rows[:, t0 + num_tags:]).view(np.float32)
    return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, t0:t0 + num_tags], meters
