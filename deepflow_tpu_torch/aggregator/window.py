"""Window ring controller — SubQuadGen/Collector window semantics (port of
deepflow_tpu/aggregator/window.py, sync exact-only mode).

  * time is bucketed into fixed `interval` windows;
  * a window stays open for `delay` seconds after its end to absorb
    out-of-order arrivals, then is flushed;
  * arrivals older than the oldest open window are dropped and counted
    (`drop_before_window`, collector.rs:386-391).

Control flow is host-driven; the data path stays on the device. Each
batch is one append step that also computes the versioned COUNTER BLOCK
(layout v7, 21 u32 lanes — identical to the reference's); the host
fetches that block (one transfer), and a window advance costs two more
(row count + the packed flush matrix), independent of batch size and of
how many windows closed. Every device→host transfer goes through
`host_fetch`, so a test can count them.

Not ported yet (WindowConfig raises NotImplementedError): the sketch
plane, the rollup cascade, fold_mode="merge", the K-batch counter ring
(stats_ring > 1) and async_drain; retry/chaos seams, lineage, spans,
profiling registration and live snapshots are absent.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..datamodel.schema import FLOW_METER, TAG_SCHEMA, MeterSchema, TagSchema
from ..device import resolve_device
from ..ops.u32 import MASK, U32_MAX
from .stash import (
    AccumState,
    StashState,
    _append_impl,
    _flush_range_impl,
    accum_init,
    plan_append,
    stash_fold_counted,
    stash_init,
    unpack_flush_rows,
)


def host_fetch(x: torch.Tensor) -> np.ndarray:
    """THE device→host fetch boundary for the windowed path: every
    transfer WindowManager performs goes through here."""
    return x.detach().cpu().numpy()


# Versioned on-device counter block — a CONTRACT with the reference
# (deepflow_tpu/aggregator/window.py:142-173): element 0 carries the
# version so a stale host parser fails loudly instead of mis-slicing.
COUNTER_BLOCK_VERSION = 7
(
    CB_VERSION,  # constant COUNTER_BLOCK_VERSION
    CB_T_MAX,  # max valid timestamp (pre-gate)
    CB_T_MIN,  # min valid timestamp (pre-gate)
    CB_N_VALID,  # valid rows this batch (pre-gate)
    CB_N_LATE,  # rows dropped by the late-arrival gate
    CB_PREREDUCE_SHED,  # unique keys shed by batch_prereduce this batch
    CB_EXCESS_HITS,  # doc rows whose packed-key excess word != 0
    CB_STASH_OCCUPANCY,  # valid stash rows at dispatch (post-fold)
    CB_STASH_EVICTIONS,  # cumulative stash overflow drops at dispatch
    CB_RING_FILL,  # accumulator rows already occupied at dispatch
    CB_FEEDER_SHED,  # records shed by the feeder before this batch
    CB_FOLD_ROWS,  # rows the last fold's keyed sort touched
    CB_SKETCH_ROWS,  # sketch plane (not ported: 0)
    CB_SKETCH_SHED,
    CB_CASCADE_ROWS,  # rollup cascade (not ported: 0)
    CB_CASCADE_SHED,
    CB_SNAPSHOT_READS,  # live read plane (not ported: 0)
    CB_SNAPSHOT_BYTES,
    CB_SKETCH_POOL_SPILL,  # pooled sketch memory (not ported: 0)
    CB_SKETCH_POOL_OCC,
    CB_SKETCH_PROMOTIONS,
) = range(21)
CB_LEN = 21
CB_FIELDS = (
    "version", "t_max", "t_min", "n_valid", "n_late", "prereduce_shed",
    "excess_word_hits", "stash_occupancy", "stash_evictions", "ring_fill",
    "feeder_shed", "fold_rows", "sketch_rows", "sketch_shed",
    "cascade_rows", "cascade_shed", "snapshot_reads", "snapshot_bytes",
    "sketch_pool_spill", "sketch_pool_occ", "sketch_promotions",
)


def batch_stats(timestamp, valid, start_window: int, interval: int, aux=None):
    """Per-batch bookkeeping on the device: returns (gated_valid, window,
    stats[5] u32) with stats = [t_max, t_min, n_valid, n_late, aux].
    `start_window` 0 = no gate yet. t_max/t_min are over pre-gate valid
    rows (0 / U32_MAX when none)."""
    window = timestamp // interval
    late = valid & (window < start_window)
    gated = valid & ~late
    zero = torch.zeros((), dtype=torch.int64, device=timestamp.device)
    stats = torch.stack([
        torch.where(valid, timestamp, 0).max(),
        torch.where(valid, timestamp, U32_MAX).min(),
        valid.sum(),
        late.sum(),
        zero if aux is None else torch.as_tensor(aux, device=timestamp.device),
    ]) & MASK
    return gated, window, stats


def batch_counter_block(timestamp, valid, start_window: int, interval: int, *,
                        aux=None, excess_hits=None, stash_valid=None,
                        stash_evictions=None, ring_fill=None, feeder_shed=None,
                        fold_rows=None):
    """`batch_stats` widened into the v7 counter block (one int64 tensor
    of CB_LEN u32 lanes). The sketch / cascade / snapshot / pool lanes
    belong to planes this package has not ported and stay 0."""
    gated, window, stats = batch_stats(timestamp, valid, start_window, interval, aux=aux)
    dev = timestamp.device

    def lane(x):
        return torch.as_tensor(0 if x is None else x, dtype=torch.int64, device=dev)

    occ = lane(None) if stash_valid is None else stash_valid.sum()
    tail = torch.stack([lane(excess_hits), occ, lane(stash_evictions),
                        lane(ring_fill), lane(feeder_shed), lane(fold_rows)])
    block = torch.cat([
        torch.full((1,), COUNTER_BLOCK_VERSION, dtype=torch.int64, device=dev),
        stats,
        tail & MASK,
        torch.zeros((CB_LEN - 12,), dtype=torch.int64, device=dev),
    ])
    return gated, window, block


def _raw_append_step(acc, offset: int, start_window: int, stash_valid, stash_evict,
                     feeder_shed: int, fold_rows, timestamp, key_hi, key_lo,
                     tags, meters, valid, *, interval: int):
    """One raw doc batch: late gate + counter block + ring append."""
    gated, window, block = batch_counter_block(
        timestamp, valid, start_window, interval,
        stash_valid=stash_valid, stash_evictions=stash_evict, ring_fill=offset,
        feeder_shed=feeder_shed, fold_rows=fold_rows,
    )
    acc = _append_impl(acc, window, key_hi, key_lo, tags, meters, gated, offset)
    return acc, block


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    interval: int = 1  # seconds per window
    delay: int = 2  # seconds a window stays open past its end
    capacity: int = 1 << 14  # stash rows shared by all open windows
    # batches accumulated between sort+reduce folds; a fold also fires
    # before any window flush so flushed windows see every row
    accum_batches: int = 8
    # reference options this package has not ported yet: set, they raise
    async_drain: bool = False
    stats_ring: int = 1
    fold_mode: str = "full"
    sketch: object | None = None
    cascade: object | None = None

    def __post_init__(self):
        if self.fold_mode not in ("full", "merge"):
            raise ValueError(f"fold_mode must be 'full' or 'merge', got {self.fold_mode!r}")
        unported = {
            "sketch": self.sketch is not None,
            "cascade": self.cascade is not None,
            "fold_mode='merge'": self.fold_mode == "merge",
            "stats_ring>1": self.stats_ring != 1,
            "async_drain": self.async_drain,
        }
        missing = [k for k, on in unported.items() if on]
        if missing:
            raise NotImplementedError(
                f"WindowConfig options not ported to deepflow_tpu_torch yet: "
                f"{', '.join(missing)}"
            )


@dataclasses.dataclass
class _FlushEntry:
    """One dispatched-but-not-yet-fetched window advance."""

    packed: torch.Tensor  # [S, 3+T+M] int32 bits (device)
    total: torch.Tensor  # 0-dim int64 (device)
    lo: int
    hi: int


@dataclasses.dataclass
class FlushedWindow:
    """One closed window's documents, host-resident and compacted
    (row-major [n, T] u32 tags / [n, M] f32 meters)."""

    window_idx: int  # absolute window index (timestamp // interval)
    start_time: int  # window start in seconds
    key_hi: np.ndarray  # [n] u32
    key_lo: np.ndarray  # [n] u32
    tags: np.ndarray  # [n, T] u32
    meters: np.ndarray  # [n, M] f32
    count: int
    sketches: object | None = None  # sketch plane (not ported: always None)
    tier: int = 0  # rollup cascade tier (not ported: always 0)
    interval: int = 0
    partial: bool = False  # live snapshot view (not ported: always False)


class WindowManager:
    """Owns one stash + the open-window span for one granularity."""

    def __init__(self, config: WindowConfig, tag_schema: TagSchema = TAG_SCHEMA,
                 meter_schema: MeterSchema = FLOW_METER, *, device=None):
        self.config = config
        self.tag_schema = tag_schema
        self.meter_schema = meter_schema
        self.device = resolve_device(device)
        self.state: StashState = stash_init(config.capacity, tag_schema,
                                            meter_schema, device=self.device)
        self.acc: AccumState | None = None  # sized on first batch
        self.fill = 0  # host-tracked accumulator rows
        self.start_window: int | None = None  # oldest open window idx
        self.drop_before_window = 0
        self.total_docs_in = 0
        self.total_flushed = 0
        self.aux_count = 0  # stats[4] accumulator (pre-reduce shed)
        # counter-block mirror (as of the last stats fetch)
        self.excess_word_hits = 0
        self.stash_occupancy = 0
        self.stash_evictions = 0
        self.device_ring_fill = 0
        self.fold_rows = 0
        self.feeder_shed = 0
        # the last fold's touched-row count, a device scalar riding into
        # the next dispatch's counter block (zero transfer)
        self._fold_rows_dev = torch.zeros((), dtype=torch.int64, device=self.device)
        self.n_advances = 0
        self.host_fetches = 0
        self.bytes_fetched = 0
        self.bytes_uploaded = 0  # callers add their upload sizes
        self._pending_flush: list[_FlushEntry] = []

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """host_fetch + transfer accounting (count + bytes)."""
        arr = host_fetch(x)
        self.host_fetches += 1
        self.bytes_fetched += arr.nbytes
        return arr

    # -- device→host drains ---------------------------------------------
    def _drain_flush(self, entry: _FlushEntry) -> list[FlushedWindow]:
        """Fetch ONE packed flush result (row count, then rows) and split
        it into windows."""
        total = int(self._fetch(entry.total))
        if total == 0:
            return []
        rows = self._fetch(entry.packed[:total]).view(np.uint32)
        self.total_flushed += total
        return self._split_rows(rows, total)

    def _split_rows(self, rows: np.ndarray, total: int) -> list[FlushedWindow]:
        """Packed (window, stash position)-ordered rows → per-window
        FlushedWindows."""
        if total == 0:
            return []
        win, key_hi, key_lo, tags, meters = unpack_flush_rows(
            rows, self.tag_schema.num_fields
        )
        flushed = []
        bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1]]).tolist() + [total]
        for a, b in zip(bounds, bounds[1:]):
            w = int(win[a])
            flushed.append(FlushedWindow(
                window_idx=w, start_time=w * self.config.interval,
                key_hi=key_hi[a:b], key_lo=key_lo[a:b], tags=tags[a:b],
                meters=meters[a:b], count=b - a,
            ))
        return flushed

    def _drain_ready(self, ready: list[_FlushEntry]) -> list[FlushedWindow]:
        out = []
        for entry in ready:
            out.extend(self._drain_flush(entry))
        return out

    def _fold(self):
        """Full-set fold: every accumulated row reaches the stash and the
        ring resets."""
        if self.fill == 0:
            return
        self.state, self.acc, self._fold_rows_dev = stash_fold_counted(
            self.state, self.acc, self.meter_schema
        )
        self.fill = 0

    def window_of(self, timestamp):
        return timestamp // self.config.interval

    # -- stats processing (the ONE per-batch host sync) ------------------
    def _process_stats(self, stats_dev: torch.Tensor) -> None:
        self._process_block([int(v) for v in self._fetch(stats_dev)])

    def _process_block(self, vec: list[int]) -> None:
        """One batch's counter block → host counters, open-span advance
        and the (dispatched, not yet fetched) range flush."""
        if len(vec) != CB_LEN or vec[CB_VERSION] != COUNTER_BLOCK_VERSION:
            raise ValueError(
                f"counter block {vec[:1]}… of {len(vec)} lanes is not the "
                f"v{COUNTER_BLOCK_VERSION} CB_LEN={CB_LEN} block — "
                "device/host layout drift"
            )
        t_max, t_min, n_valid, n_late, aux = vec[CB_T_MAX:CB_PREREDUCE_SHED + 1]
        self.excess_word_hits += vec[CB_EXCESS_HITS]
        self.stash_occupancy = vec[CB_STASH_OCCUPANCY]
        self.stash_evictions = vec[CB_STASH_EVICTIONS]
        self.device_ring_fill = vec[CB_RING_FILL]
        self.feeder_shed += vec[CB_FEEDER_SHED]
        self.fold_rows = vec[CB_FOLD_ROWS]
        self.aux_count += aux
        if n_valid == 0:
            return
        if self.start_window is None:
            # open far enough back that data older than the first batch
            # but within `delay` is still accepted
            # (quadruple_generator.rs:782-783)
            self.start_window = self.window_of(
                max(0, min(t_min, t_max - self.config.delay))
            )
        self.drop_before_window += n_late
        self.total_docs_in += n_valid - n_late

        # Advance: every window whose end is more than `delay` behind the
        # newest arrival closes now (move_window,
        # quadruple_generator.rs:339); all closed windows flush in ONE
        # packed matrix.
        new_start = self.window_of(max(t_max - self.config.delay, 0))
        if self.start_window < new_start:
            self._fold()
            self.state, packed, total = _flush_range_impl(
                self.state, self.start_window, new_start
            )
            self._pending_flush.append(
                _FlushEntry(packed, total, self.start_window, new_start)
            )
            self.start_window = new_start
            self.n_advances += 1

    # -- ingest ----------------------------------------------------------
    def ingest(self, timestamp, key_hi, key_lo, tags, meters, valid,
               feeder_shed: int = 0) -> list[FlushedWindow]:
        """Merge a raw doc batch (device tensors: u32 lanes, [T, N] tags,
        [M, N] meters, bool valid); advance and flush closed windows."""
        interval = self.config.interval

        def dispatch(acc, offset, start_window):
            st = self.state
            return _raw_append_step(
                acc, offset, start_window, st.valid, st.dropped_overflow,
                feeder_shed, self._fold_rows_dev, timestamp, key_hi, key_lo,
                tags, meters, valid, interval=interval,
            )

        return self.ingest_step(dispatch, int(timestamp.shape[0]))

    def ingest_step(self, dispatch, rows: int,
                    ring_rows: int | None = None) -> list[FlushedWindow]:
        """Window protocol around a caller-supplied append step.

        `dispatch(acc, offset, start_window)` returns (new_acc, counter
        block); `rows` is the number of accumulator rows it appends;
        `ring_rows` (≥ rows) sizes the ring for a larger coming batch."""
        if rows == 0:
            return self.settle()
        ready, self._pending_flush = self._pending_flush, []

        plan = plan_append(self.fill, self.acc.capacity if self.acc else None, rows)
        if plan == "init":
            self._fold()  # pending rows must reach the stash first
            if self.fill:
                raise AssertionError(
                    f"accumulator ring re-init with {self.fill} pending rows"
                )
            base = max(ring_rows or rows, rows)
            self.acc = accum_init(max(self.config.accum_batches * base, rows),
                                  self.tag_schema, self.meter_schema,
                                  device=self.device)
        elif plan == "fold":
            self._fold()
        sw = 0 if self.start_window is None else self.start_window
        self.acc, stats_dev = dispatch(self.acc, self.fill, sw)
        self.fill += rows
        self._process_stats(stats_dev)
        ready.extend(self._pending_flush)
        self._pending_flush = []
        return self._drain_ready(ready)

    def settle(self) -> list[FlushedWindow]:
        """Fetch every dispatched-but-unfetched flush (sync mode holds
        none between calls; flush_all relies on this to drain its own)."""
        ready, self._pending_flush = self._pending_flush, []
        return self._drain_ready(ready)

    def flush_all(self) -> list[FlushedWindow]:
        """Drain every open window (shutdown path)."""
        flushed = self.settle()
        if self.start_window is None:
            return flushed
        self._fold()
        self.state, packed, total = _flush_range_impl(self.state, 0, U32_MAX)
        self._pending_flush.append(_FlushEntry(packed, total, 0, U32_MAX))
        flushed += self.settle()
        for f in flushed:
            self.start_window = max(self.start_window, f.window_idx + 1)
        return flushed

    def get_counters(self) -> dict:
        """Fetch-free counters: host ints and the counter-block mirror."""
        return {
            "doc_in": self.total_docs_in,
            "flushed_doc": self.total_flushed,
            "drop_before_window": self.drop_before_window,
            "prereduce_shed": self.aux_count,
            "excess_word_hits": self.excess_word_hits,
            "stash_occupancy": self.stash_occupancy,
            "stash_evictions": self.stash_evictions,
            "acc_fill": self.fill,
            "device_ring_fill": self.device_ring_fill,
            "fold_rows": self.fold_rows,
            "window_advances": self.n_advances,
            "host_fetches": self.host_fetches,
            "bytes_fetched": self.bytes_fetched,
            "bytes_uploaded": self.bytes_uploaded,
            "feeder_shed": self.feeder_shed,
        }

    @property
    def counters(self) -> dict:
        """get_counters + live stash scalars (two fetches)."""
        out = self.get_counters()
        out["drop_overflow"] = int(self._fetch(self.state.dropped_overflow))
        out["occupancy"] = int(self._fetch(self.state.valid.sum()))
        return out
