"""Device-side multi-resolution rollup cascade (port of
deepflow_tpu/aggregator/cascade.py).

DeepFlow keeps a 1 s AND a 1 m series and downsamples 1m→1h→1d. The
cascade builds the coarser tiers as folds of closed windows instead of a
second ingest:

  * **Exact meters**: every window advance already packs the closing
    windows into ONE [S, 3+T+M] flush matrix on the device
    (stash._flush_range_impl). The cascade consumes that same device
    tensor before the host fetches it: each row is re-keyed to its parent
    window (slot // ratio, key words unchanged — doc fingerprints carry
    no timestamp) and merged into a bounded per-tier stash with tier 0's
    overflow stance (newest-window shed, counted). A 1 m tier window
    closes as the fold of its ≤ 60 closed 1 s windows; the 1 h tier folds
    closed 1 m flush rows the same way.

  * **Sketches**: closed 1 s `WindowSketchBlock`s merge host-side per
    parent window (register max, counter add, candidate union), so
    merge-of-60 equals build-over-60.

  * **Host syncs**: tier steps and tier flushes are extra device work on
    the advance path only, and read nothing back. The reference picks its
    tier-step branch with a `lax.cond` on two device values; here every
    branch's writes are computed on masks and selected with
    `torch.where`, so the host never learns which branch ran. Their
    outputs ride the advance drain's two transfers (the scalar fetch
    widens by one lane per tier flush, the row fetch appends the tier
    rows), so an ingest stays within 3 fetches.

Tier-close rule: parent window p of a ratio-r tier closes when every
child window < (p+1)·r has closed, i.e. when tier 0's advance target
`hi` satisfies p < hi // r. Late-row admission is therefore tier 0's.

Counter lanes: a device [2] u32 lane vector (cumulative rows folded into
tiers, cumulative tier-stash overflow sheds) rides the append step's
counter block (CB_CASCADE_ROWS / CB_CASCADE_SHED) — zero extra fetches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..datamodel.schema import MeterSchema, TagSchema
from ..ops.segment import SENTINEL_SLOT
from ..ops.u32 import MASK, U32_MAX
from .sketchplane import WindowSketchBlock
from .stash import (
    FLUSH_META_COLS,
    AccumState,
    StashState,
    _flush_range_impl,
    _merge_fold_impl,
    _merge_impl,
    accum_init,
    stash_init,
    sum_max_cols,
    unpack_flush_rows,
)


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    """Tier layout: `intervals` are the coarser resolutions to maintain
    above the owning manager's base interval, ascending, each an exact
    multiple of the previous (e.g. (60,) for a 1m tier over a 1s
    pipeline, (60, 3600) to add an hourly tier). `capacity` bounds each
    tier's stash rows — overflow sheds newest-window keys, counted
    (the exact stance tier 0 has)."""

    intervals: tuple[int, ...] = (60,)
    capacity: int = 1 << 14

    def __post_init__(self):
        if not self.intervals:
            raise ValueError("CascadeConfig.intervals must name ≥1 tier")
        if list(self.intervals) != sorted(set(self.intervals)):
            raise ValueError(
                f"cascade intervals must be ascending unique, got {self.intervals}"
            )
        if self.capacity <= 0:
            raise ValueError("cascade capacity must be positive")

    def validate_base(self, base_interval: int) -> None:
        prev = base_interval
        for iv in self.intervals:
            if iv % prev != 0 or iv <= prev:
                raise ValueError(
                    f"cascade tier {iv}s is not a proper multiple of the "
                    f"previous resolution {prev}s — parent windows would "
                    "not align with child window boundaries"
                )
            prev = iv

    def meta(self) -> dict:
        """JSON-able form for checkpoint meta."""
        return {"intervals": list(self.intervals), "capacity": self.capacity}

    @classmethod
    def from_meta(cls, m: dict) -> "CascadeConfig":
        return cls(intervals=tuple(m["intervals"]), capacity=m["capacity"])


def _parent_columns(packed, hi, *, ratio: int, num_tags: int):
    """Split a packed flush matrix ([P, 3+T+M] int32 bits) into
    parent-keyed fold columns — (parent, key_hi, key_lo, tags [T, P],
    meters [M, P], valid). Rows with window < `hi` (a host int or a
    0-dim tensor) are exactly the rows that flushed: dead rows carry
    SENTINEL, still-open rows windows ≥ hi. The lanes are masked to u32
    BEFORE the compare — a SENTINEL slot reads −1 as int32 bits."""
    meta = packed[:, :FLUSH_META_COLS + num_tags].t().to(torch.int64) & MASK
    slot = meta[0]
    valid = slot < hi
    parent = torch.where(valid, slot // ratio, U32_MAX)
    meters = packed[:, FLUSH_META_COLS + num_tags:].view(torch.float32).t()
    return parent, meta[1], meta[2], meta[FLUSH_META_COLS:], meters, valid


def _add_lanes(lanes, rows, shed):
    """lanes + [rows, shed] (0-dim int64 device tensors — a host scalar
    would cost an upload that waits for the device), wrapping at 2^32
    like the reference's u32 lanes."""
    return (lanes + torch.stack([rows, shed])) & MASK


def _ring_fold_impl(tier: StashState, acc: AccumState, lanes, sum_cols, max_cols):
    """Merge the tier accumulator ring into the tier stash and reset it
    (in place). Overflow sheds count into lanes[1] (CB_CASCADE_SHED).

    The reference's default (DEEPFLOW_SHARED_SORT=1) sorts only the
    ring's rows and rank-merges them against the standing tier stash —
    which every producer keeps canonical (groupby reduces, compacting
    tier flushes). The port always takes that path: the full-set merge
    fold of stash.py."""
    prev_dropped = tier.dropped_overflow
    tier, acc, _ = _merge_fold_impl(tier, acc, SENTINEL_SLOT, sum_cols, max_cols)
    shed = tier.dropped_overflow - prev_dropped
    return tier, acc, _add_lanes(lanes, torch.zeros_like(shed), shed)


def tier_ring_fold(tier: StashState, acc: AccumState, lanes, meter_schema: MeterSchema):
    """Schema-keyed `_ring_fold_impl` → (tier, acc, lanes)."""
    return _ring_fold_impl(tier, acc, lanes, *sum_max_cols(meter_schema))


def _select_stash(take, new: StashState, old: StashState) -> StashState:
    """Every lane of `new` where the 0-dim bool `take` holds, else `old`'s."""
    return StashState(**{f.name: torch.where(take, getattr(new, f.name), getattr(old, f.name))
                         for f in dataclasses.fields(StashState)})


def merge_row_lanes(acc: AccumState, cols):
    """The rows a tier merge adds to the tier stash: the ring's (live
    where not sentinel) ‖ the rows of `cols` (`_parent_columns` output),
    as (slot, key_hi, key_lo, tags [T, N], meters [M, N], valid) — the
    reference's operand order."""
    fp, fh, fl, ft, fm, fv = cols
    return (torch.cat([acc.slot, fp]), torch.cat([acc.key_hi, fh]),
            torch.cat([acc.key_lo, fl]), torch.cat([acc.tags, ft], dim=1),
            torch.cat([acc.meters, fm], dim=1), torch.cat([acc.slot != SENTINEL_SLOT, fv]))


def _tier_step_impl(tier: StashState, acc: AccumState, fill, lanes, packed, total, hi, *,
                    ratio: int, num_tags: int, sum_cols, max_cols, prefix: int):
    """One advance's closed rows into the tier — tier 0's own
    append/amortize architecture one level up. Returns (tier, acc, fill,
    lanes); the ring is written in place and `fill` (0-dim int64) stays
    on the device.

    The flushed rows sit in the positional prefix [0, total) of `packed`,
    so when total ≤ `prefix` the step copies packed[:prefix] — parent-
    re-keyed, out-of-range rows sentinel-masked — into the ring at
    `fill`, and the expensive merge runs once per ~A/prefix advances. The
    reference's `lax.cond` picks among:

      * append       — total ≤ prefix and the ring has room;
      * fold+append  — total ≤ prefix, ring full: merge the ring into
                       the stash first, then append at 0;
      * direct fold  — total > prefix (multi-window jump / shutdown
                       drain): merge ring + the FULL packed matrix in
                       one sort, ring resets.

    Both predicates are device values, so here every branch's writes are
    computed and selected on masks; nothing is read back. One merge of
    stash ‖ ring ‖ packed rows (valid only when total > prefix) serves
    both merging branches — for fold+append it is the full-sort form of
    the reference's rank-merge ring fold, which gives the same stash
    (the segmented reduce sees the same rows in the same order). It runs
    at every advance and is kept only when a merging branch was taken.
    Lane 0 counts rows at arrival, lane 1 tier-stash sheds at merges."""
    cols = _parent_columns(packed, hi, ratio=ratio, num_tags=num_tags)
    fp, fh, fl, ft, fm, fv = cols
    if prefix >= packed.shape[0]:
        # degenerate geometry (tiny child stash): always direct-fold
        new = _merge_impl(tier, *merge_row_lanes(acc, cols), sum_cols, max_cols)
        acc.slot.fill_(SENTINEL_SLOT)
        return new, acc, torch.zeros_like(fill), _add_lanes(
            lanes, fv.sum(), new.dropped_overflow - tier.dropped_overflow)
    direct = total > prefix
    merged = direct | (fill + prefix > acc.capacity)
    new = _merge_impl(tier, *merge_row_lanes(acc, (*cols[:5], fv & direct)), sum_cols,
                      max_cols)
    shed = torch.where(merged, new.dropped_overflow - tier.dropped_overflow, 0)
    tier = _select_stash(merged, new, tier)
    # the ring: a merge empties it, then packed[:prefix] lands at 0
    # (fold+append) or at the fill cursor (append); a direct fold appends
    # nothing (every row sentinel-masked)
    acc.slot.masked_fill_(merged, SENTINEL_SLOT)
    idx = torch.arange(prefix, device=fill.device) + torch.where(merged, 0, fill)
    pv = fv[:prefix]
    acc.slot.index_copy_(0, idx, torch.where(pv & ~direct, fp[:prefix], SENTINEL_SLOT))
    acc.key_hi.index_copy_(0, idx, fh[:prefix])
    acc.key_lo.index_copy_(0, idx, fl[:prefix])
    acc.tags.index_copy_(1, idx, ft[:, :prefix])
    acc.meters.index_copy_(1, idx, fm[:, :prefix])
    fill = torch.where(direct, 0, torch.where(merged, prefix, fill + prefix))
    rows = torch.where(direct, fv.sum(), pv.sum())
    return tier, acc, fill, _add_lanes(lanes, rows, shed)


def tier_step(tier: StashState, acc: AccumState, fill, lanes, packed, total, hi, *,
              ratio: int, meter_schema: MeterSchema, num_tags: int, prefix: int):
    """Schema-keyed `_tier_step_impl` → (tier, acc, fill, lanes)."""
    sum_cols, max_cols = sum_max_cols(meter_schema)
    return _tier_step_impl(tier, acc, fill, lanes, packed, total, hi, ratio=ratio,
                           num_tags=num_tags, sum_cols=sum_cols, max_cols=max_cols,
                           prefix=prefix)


def tier_prefix(child_capacity: int) -> int:
    """Per-advance append width: HALF the child stash — a typical
    advance's flushed rows fit, so the direct fold is left to multi-
    window jumps and shutdown drains."""
    return max(child_capacity // 2, 256)


def tier_ring_rows(child_capacity: int) -> int:
    """Tier accumulator ring capacity: 4 appends between merges."""
    return 4 * tier_prefix(child_capacity)


def merge_into_parent(pending: dict, window: int, ratio: int,
                      block: WindowSketchBlock) -> None:
    """Re-window the child block onto its parent index (merge() checks
    the window, so the first child anchors a copy) and fold it into the
    parent's pending merge."""
    parent = window // ratio
    reblk = dataclasses.replace(block, window=parent)
    have = pending.get(parent)
    pending[parent] = reblk if have is None else have.merge(reblk)


@dataclasses.dataclass
class TierFlush:
    """One tier's closed-window flush handles, produced at an advance
    and drained (fetched) with the same transfers as the tier-0 rows."""

    tier: int  # 0-based index into CascadeConfig.intervals
    interval: int  # seconds per tier window
    packed: torch.Tensor  # [S, 3+T+M] int32 bits (device)
    total: torch.Tensor  # 0-dim int64 (device)
    lo: int  # closed parent-window range [lo, hi)
    hi: int


class TierCascade:
    """Per-manager cascade state: one bounded StashState per tier, its
    accumulator ring and device fill cursor, the host watermarks (parent
    windows flushed so far), the device counter lanes and the host-side
    per-parent sketch merge. Single-device."""

    def __init__(self, config: CascadeConfig, base_interval: int,
                 tag_schema: TagSchema, meter_schema: MeterSchema, *, device):
        config.validate_base(base_interval)
        self.config = config
        self.base_interval = base_interval
        self.tag_schema = tag_schema
        self.meter_schema = meter_schema
        self.num_tags = tag_schema.num_fields
        self.device = device
        # child→tier window ratio per tier (tier 0 folds base windows)
        res = (base_interval,) + tuple(config.intervals)
        self.ratios = tuple(res[i + 1] // res[i] for i in range(len(config.intervals)))
        self.tiers: list[StashState] = [
            stash_init(config.capacity, tag_schema, meter_schema, device=device)
            for _ in config.intervals
        ]
        # per-tier accumulator ring, sized lazily from its child's stash
        # (tier i > 0's child is the previous tier's stash), and its fill
        # cursor — a device scalar, so no branch of the tier step needs
        # the host
        self.accs: list[AccumState | None] = [None] * len(config.intervals)
        self.fills: list[torch.Tensor] = [self._zero() for _ in config.intervals]
        # first parent window NOT yet flushed, per tier (host ints)
        self.watermarks: list[int] = [0] * len(config.intervals)
        # device [rows, shed] lane vector — rides the counter block
        self.lanes_dev = torch.zeros((2,), dtype=torch.int64, device=device)
        # host-side sketch tier: parent window → merged child block, per
        # tier (tier i's closed blocks feed tier i+1's pending)
        self.pending_blocks: list[dict[int, WindowSketchBlock]] = [
            {} for _ in config.intervals
        ]
        self.tier_windows_flushed = 0  # host counter (all tiers)

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def _ring_fold(self, i: int) -> None:
        self.tiers[i], self.accs[i], self.lanes_dev = tier_ring_fold(
            self.tiers[i], self.accs[i], self.lanes_dev, self.meter_schema)
        self.fills[i] = self._zero()

    # -- device side (advance path) --------------------------------------
    def on_advance(self, packed, total, hi: int) -> list[TierFlush]:
        """Fold the advance's packed flush matrix through the tiers and
        flush every tier window that closed. `packed`/`total` are the
        tier-0 flush matrix and its device row count; `hi` tier 0's new
        span start (windows < hi closed). Device work only — nothing here
        fetches; the returned TierFlush handles ride the drain's bundled
        transfers."""
        out: list[TierFlush] = []
        src, src_total, src_hi = packed, total, int(hi)
        for i, ratio in enumerate(self.ratios):
            child_rows = src.shape[0]
            ring_rows = tier_ring_rows(child_rows)
            if self.accs[i] is None or self.accs[i].capacity < ring_rows:
                if self.accs[i] is not None:
                    # a grown child stash would overflow the old ring —
                    # fold pending rows in before replacing it
                    self._ring_fold(i)
                self.accs[i] = accum_init(ring_rows, self.tag_schema, self.meter_schema,
                                          device=self.device)
                self.fills[i] = self._zero()
            self.tiers[i], self.accs[i], self.fills[i], self.lanes_dev = tier_step(
                self.tiers[i], self.accs[i], self.fills[i], self.lanes_dev, src,
                src_total, src_hi, ratio=ratio, meter_schema=self.meter_schema,
                num_tags=self.num_tags, prefix=tier_prefix(child_rows),
            )
            hi_t = src_hi // ratio
            if hi_t <= self.watermarks[i]:
                break  # nothing closed at this tier → nothing deeper either
            # the flushed parents must see every appended child row: the
            # amortized merge runs now (once per tier close)
            self._ring_fold(i)
            lo_t = self.watermarks[i]
            # compacting flush: the tier stash keeps the canonical layout
            # the ring fold's rank merge needs
            self.tiers[i], t_packed, t_total = _flush_range_impl(self.tiers[i], lo_t, hi_t,
                                                                 compact=True)
            out.append(TierFlush(tier=i, interval=self.config.intervals[i],
                                 packed=t_packed, total=t_total, lo=lo_t, hi=hi_t))
            self.watermarks[i] = hi_t
            src, src_total, src_hi = t_packed, t_total, hi_t
        return out

    # -- host side (drain path) ------------------------------------------
    def feed_block(self, tier: int, window: int, block: WindowSketchBlock) -> None:
        """Merge one closed child block into its parent's pending merge
        (tier 0 children feed tier index 0; a closed tier-i window's
        merged block feeds tier i+1)."""
        if tier >= len(self.ratios):
            return
        merge_into_parent(self.pending_blocks[tier], window, self.ratios[tier], block)

    def take_tier_windows(self, tf: TierFlush, rows: np.ndarray, total: int):
        """Fetched tier flush rows → FlushedWindow list (window order),
        marrying each parent's merged sketch block; parents in [lo, hi)
        whose exact rows were all shed but whose children had sketch
        blocks become sketch-only windows (count == 0). Closed blocks
        cascade one level up before leaving."""
        from .window import FlushedWindow  # cycle: window.py imports us

        i = tf.tier
        flushed: list[FlushedWindow] = []
        if total:
            win, key_hi, key_lo, tags, meters = unpack_flush_rows(rows, self.num_tags)
            bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1]]).tolist() + [total]
            for a, b in zip(bounds, bounds[1:]):
                w = int(win[a])
                flushed.append(FlushedWindow(
                    window_idx=w, start_time=w * tf.interval, key_hi=key_hi[a:b],
                    key_lo=key_lo[a:b], tags=tags[a:b], meters=meters[a:b], count=b - a,
                    tier=i + 1, interval=tf.interval,
                ))
        for f in flushed:
            f.sketches = self.pending_blocks[i].pop(f.window_idx, None)
        exact = {f.window_idx for f in flushed}
        for w in sorted(self.pending_blocks[i]):
            if tf.lo <= w < tf.hi and w not in exact:
                flushed.append(FlushedWindow.sketch_only(
                    w, w * tf.interval, self.pending_blocks[i].pop(w),
                    num_tags=self.num_tags, num_meters=self.meter_schema.num_fields,
                    tier=i + 1, interval=tf.interval))
        flushed.sort(key=lambda f: f.window_idx)
        for f in flushed:
            if f.sketches is not None:
                self.feed_block(i + 1, f.window_idx, f.sketches)
        self.tier_windows_flushed += len(flushed)
        return flushed

    # -- shutdown / checkpoint -------------------------------------------
    def settle_rings(self) -> None:
        """Fold every tier accumulator ring into its stash — ring rows
        must reach the stash before a snapshot, so the rings need no
        serialization (a restore starts them empty)."""
        for i in range(len(self.tiers)):
            if self.accs[i] is not None:
                self._ring_fold(i)

    def flush_hi(self) -> int:
        """The tier-0 `hi` that closes every tier window (flush_all)."""
        return U32_MAX

    def get_counters(self) -> dict:
        """Host ints only (fetch-free); the device lane mirrors live on
        the owning manager."""
        return {
            "cascade_tiers": len(self.config.intervals),
            "cascade_tier_windows": self.tier_windows_flushed,
            "cascade_pending_blocks": sum(len(p) for p in self.pending_blocks),
        }


# ---------------------------------------------------------------------------
# checkpoint support — (de)serialization of the host-side pending sketch
# merges, in the reference's array layout (the tier stashes pack through
# stash.pack_u32_columns like tier 0)

_BLOCK_FIELDS = ("hll", "cms", "hist", "tk_hi", "tk_lo", "tk_ida", "tk_idb", "tk_votes")


def pending_block_arrays(pending: list[dict]) -> tuple[list, dict]:
    """(meta list, arrays dict) for every pending parent block: an open
    minute/hour window's partially-merged sketch must survive a
    checkpoint. `pending` is the per-tier parent→block dict list."""
    meta, arrays = [], {}
    for tier, pend in enumerate(pending):
        for w, blk in sorted(pend.items()):
            key = f"cascblk_{tier}_{w}"
            meta.append({"tier": tier, "window": w, "key": key, "n_updates": blk.n_updates})
            for f in _BLOCK_FIELDS:
                arrays[f"{key}_{f}"] = np.asarray(getattr(blk, f))
    return meta, arrays


def restore_pending_blocks(pending: list[dict], meta: list, arrays: dict,
                           sketch_config) -> None:
    for m in meta:
        key = m["key"]
        pending[int(m["tier"])][int(m["window"])] = WindowSketchBlock(
            window=int(m["window"]), config=sketch_config, n_updates=int(m["n_updates"]),
            **{f: arrays[f"{key}_{f}"] for f in _BLOCK_FIELDS},
        )


__all__ = [
    "CascadeConfig",
    "TierCascade",
    "TierFlush",
    "tier_step",
    "tier_ring_fold",
    "tier_prefix",
    "tier_ring_rows",
    "merge_into_parent",
    "pending_block_arrays",
    "restore_pending_blocks",
]
