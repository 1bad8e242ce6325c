"""L4 flow-log minute aggregation + throttled sampling (port of
deepflow_tpu/flowlog/aggr.py).

The reference's FlowAggr thread merges the per-second `TaggedFlow`
emissions of each flow into one minute-level log row keyed by flow_id
(`minute_merge`, agent/src/collector/flow_aggr.rs:216), then samples the
output through a per-second reservoir `ThrottlingQueue` (flow_aggr.rs:500,
send_with_throttling :558).

The merge is the sort → segment-reduce pattern of the metrics stash,
extended with the flow-log merge classes (FIRST/LAST/MIN/MAX/OR int
lanes — see schema.py), as eager PyTorch on the state's device. Arrival
order is the sort tiebreak: stash rows concatenate before batch rows and
the (slot, hi, lo) sort is stable (`ops/segment.py::sort_perm`), so
FIRST takes a segment's oldest row and LAST its newest, as in the
reference's `lax.sort(..., num_keys=3)`.

Lanes follow the port's u32 rule (ops/u32.py): slot, key and int lanes
are int64 tensors holding u32 values; num lanes are float32. Every
reduction mirrors the reference's `jax.ops.segment_*` over all
concatenated rows, the invalid rows' sentinel segment and the empty
segments' identities included, so a state compares lane for lane with
the reference's (`convert.log_stash_{from,to}_numpy`).

Device→host traffic: `MinuteAggr` fetches the live minutes with their
row counts once per flush (one small block), then one packed block of
rows per closing minute; `host_fetches` counts them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.hashing import fingerprint64_np
from ..ops.segment import SENTINEL_SLOT, sort_perm
from ..ops.u32 import MASK, U32_MAX, to_i32_bits
from ..utils.stats import register_countable
from .schema import L4_FLOW_LOG, LogOp, LogSchema

_OR_BITS = 16  # OR lanes are bitmasks ≤16 bits (TCP flags)


@dataclasses.dataclass
class FlowLogBatch:
    """SoA flow-log rows: int/num lanes + host string columns."""

    schema: LogSchema
    ints: np.ndarray  # [N, Ki] u32
    nums: np.ndarray  # [N, Kn] f32
    valid: np.ndarray  # [N] bool
    strs: dict[str, list[str]] | None = None

    @property
    def size(self) -> int:
        return self.ints.shape[0]

    def col(self, name: str) -> np.ndarray:
        s = self.schema
        if name in s._int_idx:
            return self.ints[:, s.int_index(name)]
        return self.nums[:, s.num_index(name)]

    @staticmethod
    def from_rows(schema: LogSchema, rows: list[dict]) -> "FlowLogBatch":
        n = len(rows)
        ints = np.zeros((n, len(schema.ints)), np.uint32)
        nums = np.zeros((n, len(schema.nums)), np.float32)
        strs: dict[str, list[str]] = {f.name: [""] * n for f in schema.strs}
        for r, row in enumerate(rows):
            for k, v in row.items():
                if k in schema._int_idx:
                    ints[r, schema.int_index(k)] = v
                elif k in schema._num_idx:
                    nums[r, schema.num_index(k)] = v
                elif k in strs:
                    strs[k][r] = v
        return FlowLogBatch(schema, ints, nums, np.ones(n, bool), strs or None)

    def to_rows(self) -> list[dict]:
        out = []
        for r in range(self.size):
            if not self.valid[r]:
                continue
            d = {f.name: int(self.ints[r, i]) for i, f in enumerate(self.schema.ints)}
            d.update(
                {f.name: float(self.nums[r, i]) for i, f in enumerate(self.schema.nums)}
            )
            if self.strs:
                d.update({k: v[r] for k, v in self.strs.items()})
            out.append(d)
        return out


# ---------------------------------------------------------------------------
# device state and merge


@dataclasses.dataclass
class LogStashState:
    slot: torch.Tensor  # [S] u32 minute index (SENTINEL = empty)
    key_hi: torch.Tensor  # [S] u32
    key_lo: torch.Tensor  # [S] u32
    ints: torch.Tensor  # [S, Ki] u32 lanes
    nums: torch.Tensor  # [S, Kn] f32
    valid: torch.Tensor  # [S] bool
    dropped_overflow: torch.Tensor  # 0-dim int64

    @property
    def capacity(self) -> int:
        return self.slot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.slot.device


def log_stash_init(capacity: int, schema: LogSchema, device=None) -> LogStashState:
    """An empty stash on `device` (default CUDA; raises without it)."""
    dev = resolve_device(device)
    return LogStashState(
        slot=torch.full((capacity,), SENTINEL_SLOT, dtype=torch.int64, device=dev),
        key_hi=torch.zeros((capacity,), dtype=torch.int64, device=dev),
        key_lo=torch.zeros((capacity,), dtype=torch.int64, device=dev),
        ints=torch.zeros((capacity, len(schema.ints)), dtype=torch.int64, device=dev),
        nums=torch.zeros((capacity, len(schema.nums)), dtype=torch.float32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        dropped_overflow=torch.zeros((), dtype=torch.int64, device=dev),
    )


_COLS: dict = {}


def _cols(schema: LogSchema, device: torch.device) -> dict:
    """The schema's column groups as int64 index tensors on `device`,
    built once per (schema, device): FIRST/LAST/MIN/MAX/OR int lanes and
    SUM/MAX num lanes, plus the [O·16] bit-shift lane of the OR merge."""
    key = (schema, device)
    got = _COLS.get(key)
    if got is None:
        def idx(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        got = {op: idx(schema.int_cols_with(op))
               for op in (LogOp.FIRST, LogOp.LAST, LogOp.MIN, LogOp.MAX, LogOp.OR)}
        got["num_sum"] = idx(schema.num_cols_with(LogOp.SUM))
        got["num_max"] = idx(schema.num_cols_with(LogOp.MAX))
        got["bits"] = torch.arange(_OR_BITS, dtype=torch.int64, device=device)
        _COLS[key] = got
    return got


def _segment(vals: torch.Tensor, seg_id: torch.Tensor, n: int, how: str, identity):
    """[N, K] → [n, K] per-segment reduction (`how`: "sum", "amin",
    "amax"); segments with no row hold `identity`."""
    out = torch.full((n, vals.shape[1]), identity, dtype=vals.dtype, device=vals.device)
    if how == "sum":
        return out.index_add_(0, seg_id, vals)
    return out.scatter_reduce_(0, seg_id[:, None].expand_as(vals), vals, how,
                               include_self=True)


def _seg_reduce_ints(ints_sorted, seg_id, first_pos, last_pos, n, cols):
    """Apply per-class reductions to the sorted u32 int lanes."""
    ki = ints_sorted.shape[1]
    out = torch.zeros((n, ki), dtype=torch.int64, device=ints_sorted.device)
    first_cols, last_cols = cols[LogOp.FIRST], cols[LogOp.LAST]
    min_cols, max_cols, or_cols = cols[LogOp.MIN], cols[LogOp.MAX], cols[LogOp.OR]
    if first_cols.numel():
        out[:, first_cols] = ints_sorted[:, first_cols][first_pos]
    if last_cols.numel():
        out[:, last_cols] = ints_sorted[:, last_cols][last_pos]
    # MIN/MAX run on the u32 values; empty segments get the op identity
    # (0xFFFFFFFF / 0), as the reference's segment_min / segment_max
    if min_cols.numel():
        out[:, min_cols] = _segment(ints_sorted[:, min_cols], seg_id, n, "amin", U32_MAX)
    if max_cols.numel():
        out[:, max_cols] = _segment(ints_sorted[:, max_cols], seg_id, n, "amax", 0)
    if or_cols.numel():
        # OR = per-bit segment max over the low _OR_BITS bits: higher
        # bits are dropped, as in the reference
        bits = cols["bits"]
        vals = ints_sorted[:, or_cols]  # [N, O]
        b = ((vals[:, :, None] >> bits) & 1).to(torch.int32).reshape(vals.shape[0], -1)
        red = _segment(b, seg_id, n, "amax", 0).reshape(n, or_cols.numel(), _OR_BITS)
        out[:, or_cols] = (red.to(torch.int64) << bits).sum(dim=-1)
    return out


def log_stash_merge(state: LogStashState, slot, key_hi, key_lo, ints, nums, valid,
                    schema: LogSchema) -> LogStashState:
    """Merge a batch of rows (u32 lanes slot/key_hi/key_lo [B], ints
    [B, Ki], f32 nums [B, Kn], bool valid [B], on the state's device)
    into the stash: one stable sort of stash ‖ batch by (slot, hi, lo),
    per-class segment reductions, and the first `capacity` segments kept
    (`dropped_overflow` counts the live ones cut)."""
    s = state.capacity
    dev = state.device
    cols = _cols(schema, dev)
    all_valid = torch.cat([state.valid, valid])
    all_slot = torch.where(all_valid, torch.cat([state.slot, slot]), SENTINEL_SLOT)
    all_hi = torch.where(all_valid, torch.cat([state.key_hi, key_hi]), U32_MAX)
    all_lo = torch.where(all_valid, torch.cat([state.key_lo, key_lo]), U32_MAX)
    all_ints = torch.cat([state.ints, ints], dim=0)
    all_nums = torch.cat([state.nums, nums], dim=0)
    n = all_slot.shape[0]

    # stable sort → ties keep concat (arrival) order: stash before batch
    perm = sort_perm(all_slot, all_hi, all_lo)
    s_slot, s_hi, s_lo = all_slot[perm], all_hi[perm], all_lo[perm]

    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = (s_slot[1:] != s_slot[:-1]) | (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])
    seg_id = torch.cumsum(first, 0) - 1  # int64, ascending
    total = seg_id[-1] + 1

    # a segment's first and last sorted position; an empty segment reads
    # position n − 1 (first) and 0 (last), the reference's clipped
    # segment_min / segment_max identities
    k = torch.arange(n, dtype=torch.int64, device=dev)
    first_pos = torch.searchsorted(seg_id, k).clamp_(max=n - 1)
    last_pos = torch.where(k < total, torch.searchsorted(seg_id, k, right=True) - 1, 0)

    ints_sorted = all_ints[perm]
    nums_sorted = all_nums[perm]
    ints_out = _seg_reduce_ints(ints_sorted, seg_id, first_pos, last_pos, n, cols)

    nums_out = torch.zeros((n, nums_sorted.shape[1]), dtype=torch.float32, device=dev)
    sum_cols, nmax_cols = cols["num_sum"], cols["num_max"]
    if sum_cols.numel():
        nums_out[:, sum_cols] = _segment(nums_sorted[:, sum_cols], seg_id, n, "sum", 0.0)
    if nmax_cols.numel():
        part = _segment(nums_sorted[:, nmax_cols], seg_id, n, "amax", float("-inf"))
        nums_out[:, nmax_cols] = torch.where(torch.isfinite(part), part, 0.0)

    slot_out = s_slot[first_pos]
    seg_valid = (k < total) & (slot_out != SENTINEL_SLOT)
    slot_out = torch.where(seg_valid, slot_out, SENTINEL_SLOT)
    dropped = torch.clamp(seg_valid.sum() - s, min=0)
    return LogStashState(
        slot=slot_out[:s],
        key_hi=s_hi[first_pos][:s],
        key_lo=s_lo[first_pos][:s],
        ints=ints_out[:s],
        nums=nums_out[:s],
        valid=seg_valid[:s],
        dropped_overflow=state.dropped_overflow + dropped,
    )


def _log_flush(state: LogStashState, slot_idx: int):
    """Close one minute slot: compact its rows to the output prefix on
    device so the host transfer is O(emitted rows), not O(capacity).
    Returns (new state, {"count": 0-dim, "ints", "nums"})."""
    mask = state.valid & (state.slot == int(slot_idx))
    order = torch.sort((~mask).to(torch.int32), stable=True).indices
    out = {
        "count": mask.sum(),
        "ints": state.ints[order],
        "nums": state.nums[order],
    }
    new_state = dataclasses.replace(
        state,
        slot=torch.where(mask, SENTINEL_SLOT, state.slot),
        valid=state.valid & ~mask,
    )
    return new_state, out


def pack_rows(ints: torch.Tensor, nums: torch.Tensor) -> torch.Tensor:
    """[N, Ki] u32 lanes ‖ [N, Kn] f32 → one [N, Ki + Kn] int32 block of
    bit patterns, for a single device→host copy (`unpack_rows`)."""
    return torch.cat([to_i32_bits(ints), nums.view(torch.int32)], dim=1)


def unpack_rows(block: np.ndarray, ki: int) -> tuple[np.ndarray, np.ndarray]:
    """Host side of `pack_rows`: (uint32 [N, Ki], float32 [N, Kn])."""
    return (np.ascontiguousarray(block[:, :ki]).view(np.uint32),
            np.ascontiguousarray(block[:, ki:]).view(np.float32))


def upload_rows(slot, hi, lo, ints, nums, valid, device):
    """One host batch of merge rows → device tensors in ONE host→device
    copy: u32 slot / key_hi / key_lo [B] and ints [B, Ki], f32 nums
    [B, Kn] and bool valid [B] travel as one [B, Ki + Kn + 4] int32
    block. Returns (slot, key_hi, key_lo, ints, nums, valid) as the
    merge takes them (u32 lanes int64, nums float32, valid bool)."""
    ki = ints.shape[1]
    block = np.concatenate([
        np.stack([slot, hi, lo], axis=1).astype(np.uint32),
        np.asarray(ints, np.uint32),
        np.ascontiguousarray(nums, np.float32).view(np.uint32),
        np.asarray(valid, np.uint32)[:, None],
    ], axis=1)
    t = torch.from_numpy(block.view(np.int32)).to(device)
    u = t[:, :3 + ki].to(torch.int64) & MASK
    return (u[:, 0].contiguous(), u[:, 1].contiguous(), u[:, 2].contiguous(),
            u[:, 3:].contiguous(), t[:, 3 + ki:-1].contiguous().view(torch.float32),
            t[:, -1] != 0)


def host_fetch(x: torch.Tensor) -> np.ndarray:
    """The device→host boundary of the MinuteAggr and FlowMap host loops."""
    return x.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# host side


class MinuteAggr:
    """FlowAggr analog: minute_merge of per-second flow emissions.

    Windows: a flow row lands in minute slot end_time//60; slots flush
    once `now` passes slot end + delay (flow_aggr thread ticks on its
    input's 1s cadence, flushing the previous minute — flow_aggr.rs:216).
    The stash lives on `device` (default CUDA; raises without it).
    """

    def __init__(
        self,
        schema: LogSchema = L4_FLOW_LOG,
        *,
        capacity: int = 1 << 16,
        batch_size: int = 4096,
        delay_s: int = 10,
        device=None,
    ):
        self.schema = schema
        self.batch_size = batch_size
        self.delay_s = delay_s
        self.device = resolve_device(device)
        self.state = log_stash_init(capacity, schema, self.device)
        self._time_col = schema.int_index("end_time")
        self._max_time = 0
        self.counters = {"rows_in": 0, "rows_out": 0, "drop_before_window": 0}
        self._flushed_min = -1  # minutes ≤ this are closed
        self.host_fetches = 0  # device→host copies (not a reference counter)
        register_countable("flow_aggr", self, schema=schema.name)

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        self.host_fetches += 1
        return host_fetch(x)

    def get_counters(self):
        c = dict(self.counters)
        c["dropped_overflow"] = int(self._fetch(self.state.dropped_overflow))
        return c

    def ingest(self, batch: FlowLogBatch) -> list[FlowLogBatch]:
        assert batch.schema is self.schema
        n = batch.size
        if n > self.batch_size:
            raise ValueError(f"batch {n} > batch_size {self.batch_size}")
        pad = self.batch_size - n
        ints = np.pad(batch.ints, ((0, pad), (0, 0)))
        nums = np.pad(batch.nums, ((0, pad), (0, 0)))
        valid = np.pad(batch.valid, (0, pad))

        t = ints[:, self._time_col].astype(np.int64)
        slot = (t // 60).astype(np.uint32)
        # late rows for already-flushed minutes are dropped and counted
        # (drop_before_window stance, collector.rs:386-391)
        late = valid & (slot <= np.uint32(self._flushed_min)) if self._flushed_min >= 0 else np.zeros_like(valid)
        self.counters["drop_before_window"] += int(late.sum())
        valid = valid & ~late

        key_mat = ints[:, self.schema.key_cols]
        hi, lo = fingerprint64_np(key_mat)
        rows = upload_rows(slot, hi, lo, ints, nums, valid, self.device)
        self.state = log_stash_merge(self.state, *rows, self.schema)
        self.counters["rows_in"] += int(valid.sum())
        self._max_time = max(self._max_time, int(t[valid].max()) if valid.any() else 0)
        return self._flush_due()

    def _live_minutes(self) -> tuple[np.ndarray, np.ndarray]:
        """(minutes, rows) of the live slots, ascending, in one fetch."""
        m, c = torch.unique(self.state.slot[self.state.valid], return_counts=True)
        got = self._fetch(torch.stack([m, c]))
        return got[0], got[1]

    def _flush_due(self) -> list[FlowLogBatch]:
        due_until = (self._max_time - self.delay_s) // 60 - 1
        if due_until <= self._flushed_min:
            return []
        # sync live slots once per closing minute — flush only minutes
        # that actually hold rows (time jumps don't cause slot sweeps)
        minutes, rows = self._live_minutes()
        out = [self._flush_slot(int(m), int(r)) for m, r in zip(minutes, rows)
               if int(m) <= due_until]
        self._flushed_min = due_until
        return [b for b in out if b.size]

    def _flush_slot(self, minute: int, n: int) -> FlowLogBatch:
        """Flush one live minute of `n` rows (known from `_live_minutes`):
        one packed fetch of its rows."""
        self.state, raw = _log_flush(self.state, minute)
        ints, nums = unpack_rows(self._fetch(pack_rows(raw["ints"][:n], raw["nums"][:n])),
                                 len(self.schema.ints))
        self.counters["rows_out"] += n
        return FlowLogBatch(self.schema, ints, nums, np.ones(n, bool))

    def drain(self) -> list[FlowLogBatch]:
        out = []
        minutes, rows = self._live_minutes()
        for m, r in zip(minutes, rows):
            b = self._flush_slot(int(m), int(r))
            if b.size:
                out.append(b)
            self._flushed_min = max(self._flushed_min, int(m))
        return out


class ThrottlingQueue:
    """Per-second reservoir sampler (flow_aggr.rs:500 ThrottlingQueue;
    server twin throttler/throttling_queue.go).

    Keeps ≤ throttle rows per distinct second bucket; once a bucket
    overflows, each further row replaces a random kept slot with
    probability throttle/seen — classic reservoir, deterministic here via
    a seeded generator.
    """

    def __init__(self, throttle: int = 1000, seed: int = 0, time_col: str = "end_time"):
        self.throttle = throttle
        self.time_col = time_col
        self._rng = np.random.default_rng(seed)
        self._buckets: dict[int, tuple[int, list]] = {}
        self.counters = {"in": 0, "kept": 0, "dropped": 0}

    def put(self, batch: FlowLogBatch) -> None:
        ts = batch.col(self.time_col)
        rows = np.nonzero(batch.valid)[0]
        self.counters["in"] += len(rows)
        for r in rows:
            sec = int(ts[r])
            seen, kept = self._buckets.get(sec, (0, []))
            if seen < self.throttle:
                kept.append((batch, int(r)))
            else:
                j = int(self._rng.integers(0, seen + 1))
                if j < self.throttle:
                    kept[j] = (batch, int(r))
            self._buckets[sec] = (seen + 1, kept)

    def drain(self, up_to_sec: int | None = None) -> list[FlowLogBatch]:
        """Emit buckets with second < up_to_sec (None = all)."""
        out = []
        for sec in sorted(self._buckets):
            if up_to_sec is not None and sec >= up_to_sec:
                continue
            seen, kept = self._buckets.pop(sec)
            self.counters["kept"] += len(kept)
            self.counters["dropped"] += seen - len(kept)
            if kept:
                out.append(_gather_rows(kept))
        return out


def _gather_rows(kept: list[tuple[FlowLogBatch, int]]) -> FlowLogBatch:
    schema = kept[0][0].schema
    ints = np.stack([b.ints[r] for b, r in kept])
    nums = np.stack([b.nums[r] for b, r in kept])
    strs = None
    if any(b.strs for b, _ in kept):
        strs = {
            f.name: [(b.strs[f.name][r] if b.strs else "") for b, r in kept]
            for f in schema.strs
        }
    return FlowLogBatch(schema, ints, nums, np.ones(len(kept), bool), strs)
