"""Window ring controller — SubQuadGen/Collector window semantics (port of
deepflow_tpu/aggregator/window.py).

  * time is bucketed into fixed `interval` windows;
  * a window stays open for `delay` seconds after its end to absorb
    out-of-order arrivals, then is flushed;
  * arrivals older than the oldest open window are dropped and counted
    (`drop_before_window`, collector.rs:386-391).

Control flow is host-driven; the data path stays on the device. Each
batch is one append step that also computes the versioned COUNTER BLOCK
(layout v7, 21 u32 lanes — identical to the reference's); the host
fetches that block (one transfer), and a window advance costs two more
(the scalar vector [row count, pending sketch blocks, closed wide
slots], then ONE packed transfer of flush rows ‖ closed sketch blocks ‖
their window ids ‖ the wide arena's rows and ids when a wide slot closed),
independent of batch size and of how many windows closed. Every
device→host transfer goes through `host_fetch`, so a test can count
them.

With `WindowConfig(cascade=CascadeConfig(...))` each advance also folds
the flush matrix into coarser tiers (aggregator/cascade.py: 1 m, 1 h …)
on the device; a closing tier window's rows ride the same two transfers
(one more scalar lane per tier flush, its rows appended to the row
fetch), and closed tier windows collect for `pop_tier_windows()`.

With `WindowConfig(sketch=SketchConfig(...))` the same step also folds
the batch into the per-window sketch plane (aggregator/sketchplane.py,
slab or pool mode): closed windows come out with
`FlushedWindow.sketches`, and a window whose exact rows were all shed
still comes out, sketch-only (count == 0). With fold_mode="merge" the
folds rank-merge the sorted ring into the stash, and an advance folds
only the closing span (aggregator/stash.py); the windows are the same.

Two options defer the per-batch fetch. `stats_ring = K > 1` writes
each counter block into a device [K, CB_LEN] ring and fetches the ring
once per K dispatches; the late gate moves to a device [start_window,
opened] pair (`_stats_ring_push`), so the flushed output is the same as
with per-batch fetching. `async_drain` defers each block's fetch by one
ingest call: windows come out one call later, identical. `settle()`
drains both, then the dispatched flushes.

The live read plane: `snapshot_open()` folds the accumulator ring into
the stash and reads every open window's rows plus the open sketch slots
in two fetches, without closing anything (`OpenSnapshot`, windows with
`partial=True`); the later flush of a window supersedes its snapshot.
Reads are rate-limited by `WindowConfig.min_snapshot_interval`, counted
in `snapshot_reads` / `snapshot_bytes`, and mirrored into counter-block
lanes 16–17.

Every dispatch of the append step and every device→host fetch passes a
chaos seam (`chaos.SITE_DISPATCH` before the step runs, `SITE_FETCH`
before the copy) under the retry policy of utils/retry.py, in the
reference's order, so a fault plan's call indices name the same
dispatch and fetch in both packages; retries are counted in
`dispatch_retries` / `fetch_retries`.

Self-observability: the host stage spans of utils/spans (`ingest.dispatch`,
`stats.fetch`, `window.advance`, `window.fold`, `flush.drain`,
`query.snapshot`) on `self.tracer` — two perf_counter calls each, never
a device sync — and `device_planes()`, the Profilable face the manager
registers on the process-wide device-memory ledger at construction
(weakly; `close()` deregisters eagerly).

Absent: lineage.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import chaos
from ..datamodel.schema import FLOW_METER, TAG_SCHEMA, MeterSchema, TagSchema
from ..device import resolve_device
from ..ops.hashing import fingerprint64_words
from ..ops.u32 import MASK, U32_MAX, add, mul, shl, to_i32_bits
from ..utils.retry import RetryPolicy, decorrelated_rng, is_dispatch_transient, retry_call
from ..utils.spans import (
    SPAN_FLUSH_DRAIN,
    SPAN_INGEST_DISPATCH,
    SPAN_QUERY_SNAPSHOT,
    SPAN_STATS_FETCH,
    SPAN_WINDOW_ADVANCE,
    SPAN_WINDOW_FOLD,
    SpanTracer,
)
from .cascade import CascadeConfig, TierCascade, TierFlush
from .sketchplane import (
    SENTINEL_WIN,
    SketchConfig,
    SketchState,
    WindowSketchBlock,
    _flatten_open_snapshot,
    _pool_mode,
    hold_blocks,
    scalar_tensor,
    sketch_drain,
    sketch_init,
    sketch_plane_step,
    unpack_drained,
)
from .stash import (
    AccumState,
    StashState,
    _append_impl,
    _flush_range_impl,
    accum_init,
    check_fold_mode,
    plan_append,
    stash_fold_counted,
    stash_merge_fold,
    stash_init,
    stash_snapshot_range,
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
    CB_SKETCH_ROWS,  # cumulative rows folded into the sketch plane
    CB_SKETCH_SHED,  # cumulative rows the sketch plane counted-shed
    CB_CASCADE_ROWS,  # cumulative rows the cascade's tier folds consumed
    CB_CASCADE_SHED,  # cumulative tier-stash overflow sheds
    CB_SNAPSHOT_READS,  # cumulative live snapshot_open() reads
    CB_SNAPSHOT_BYTES,  # cumulative live snapshot bytes fetched (mod 2^32)
    CB_SKETCH_POOL_SPILL,  # cumulative rows the full pool could not seat
    CB_SKETCH_POOL_OCC,  # seated ring slots + closed wide slots at dispatch
    CB_SKETCH_PROMOTIONS,  # cumulative compact → wide promotions (0 in slab mode)
) = range(21)
CB_LEN = 21
CB_FIELDS = (
    "version", "t_max", "t_min", "n_valid", "n_late", "prereduce_shed",
    "excess_word_hits", "stash_occupancy", "stash_evictions", "ring_fill",
    "feeder_shed", "fold_rows", "sketch_rows", "sketch_shed",
    "cascade_rows", "cascade_shed", "snapshot_reads", "snapshot_bytes",
    "sketch_pool_spill", "sketch_pool_occ", "sketch_promotions",
)


def batch_stats(timestamp, valid, start_window, interval: int, aux=None):
    """Per-batch bookkeeping on the device: returns (gated_valid, window,
    stats[5] u32) with stats = [t_max, t_min, n_valid, n_late, aux].
    `start_window` (a host int or a 0-dim device tensor; 0 = no gate yet)
    is never read back. t_max/t_min are over pre-gate valid rows (0 /
    U32_MAX when none)."""
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


def batch_counter_block(timestamp, valid, start_window, interval: int, *,
                        aux=None, excess_hits=None, stash_valid=None,
                        stash_evictions=None, ring_fill=None, feeder_shed=None,
                        fold_rows=None, sketch_rows=None, sketch_shed=None,
                        cascade_rows=None, cascade_shed=None, snapshot_reads=None,
                        snapshot_bytes=None, sketch_pool_spill=None,
                        sketch_pool_occ=None, sketch_promotions=None):
    """`batch_stats` widened into the v7 counter block (one int64 tensor
    of CB_LEN u32 lanes); an absent lane is 0."""
    gated, window, stats = batch_stats(timestamp, valid, start_window, interval, aux=aux)
    dev = timestamp.device

    def lane(x):
        return torch.as_tensor(0 if x is None else x, dtype=torch.int64, device=dev)

    occ = lane(None) if stash_valid is None else stash_valid.sum()
    tail = torch.stack([lane(excess_hits), occ, lane(stash_evictions),
                        lane(ring_fill), lane(feeder_shed), lane(fold_rows),
                        lane(sketch_rows), lane(sketch_shed), lane(cascade_rows),
                        lane(cascade_shed), lane(snapshot_reads), lane(snapshot_bytes),
                        lane(sketch_pool_spill), lane(sketch_pool_occ),
                        lane(sketch_promotions)])
    block = torch.cat([
        torch.full((1,), COUNTER_BLOCK_VERSION, dtype=torch.int64, device=dev),
        stats,
        tail & MASK,
    ])
    return gated, window, block


def sketch_counter_lanes(sk: SketchState | None) -> dict:
    """The counter-block lanes the sketch plane feeds (`batch_counter_block`
    keywords): cumulative rows and shed, pool spill and promotions, and the
    pool occupancy gauge — seated ring slots plus closed wide slots awaiting
    their drain (0 in slab mode, whose pool fields are empty)."""
    if sk is None:
        return {}
    occ = (sk.slot_of != -1).sum() + (sk.wide_close != SENTINEL_WIN).sum()
    return dict(sketch_rows=sk.rows, sketch_shed=sk.shed, sketch_pool_spill=sk.pool_spill,
                sketch_pool_occ=occ, sketch_promotions=sk.pool_promos)


def _raw_append_step(acc, offset: int, start_window, stash_valid, stash_evict,
                     feeder_shed: int, fold_rows, casc_lanes, snap_lanes, timestamp, key_hi,
                     key_lo, tags, meters, valid, *, interval: int,
                     sk: SketchState | None = None):
    """One raw doc batch: late gate + counter block (with the cascade's
    [rows, shed] lanes, the live read's [reads, bytes] lanes and those of
    the sketch plane `sk`) + ring append."""
    gated, window, block = batch_counter_block(
        timestamp, valid, start_window, interval,
        stash_valid=stash_valid, stash_evictions=stash_evict, ring_fill=offset,
        feeder_shed=feeder_shed, fold_rows=fold_rows, cascade_rows=casc_lanes[0],
        cascade_shed=casc_lanes[1], snapshot_reads=snap_lanes[0],
        snapshot_bytes=snap_lanes[1], **sketch_counter_lanes(sk),
    )
    acc = _append_impl(acc, window, key_hi, key_lo, tags, meters, gated, offset)
    return acc, block


def sketch_tag_indices(tag_schema: TagSchema, meter_schema: MeterSchema) -> tuple:
    """Static column-index tuple of the sketch-enabled raw-doc step:
    ip0/ip1 words, server_port / protocol / l3_epc_id1, and the byte /
    rtt meter columns. Raises naming the missing field."""
    try:
        t = tag_schema.index
        m = meter_schema.index
        return (tuple(t(f"ip0_w{w}") for w in range(4))
                + tuple(t(f"ip1_w{w}") for w in range(4))
                + (t("server_port"), t("protocol"), t("l3_epc_id1"),
                   m("byte_tx"), m("rtt_sum"), m("rtt_count")))
    except KeyError as e:
        raise ValueError(
            f"sketch plane needs tag/meter column {e} which this tag schema / "
            f"{meter_schema.name} meter schema does not declare"
        ) from e


def sketch_plane_inputs(num_groups: int, *, ip0, ip1, server_port, protocol,
                        l3_epc_id1, byte_w, rtt_sum, rtt_count) -> dict:
    """The plane's per-row inputs from raw columns (u32 lanes, f32
    meters), shared by every sketch-enabled step so all entry points
    sketch identical quantities: the HLL entity is the client address
    (ip0 words), the flow key the (ip0, ip1, server_port, protocol)
    fingerprint, the group (l3_epc_id1·131 + server_port) mod G, the
    heavy-hitter weight byte_tx, the id preview (ip0_w3,
    port<<16 | proto)."""
    ip0, ip1 = list(ip0), list(ip1)
    port, proto = server_port, protocol
    client_hi, client_lo = fingerprint64_words(ip0)
    key_hi, key_lo = fingerprint64_words(ip0 + ip1 + [port, proto])
    return dict(
        group=add(mul(l3_epc_id1, 131), port) % num_groups,
        client_hi=client_hi, client_lo=client_lo, key_hi=key_hi, key_lo=key_lo,
        weight=byte_w, rtt=rtt_sum / torch.clamp(rtt_count, min=1.0),
        rtt_valid=rtt_count > 0, id_a=ip0[3],
        id_b=shl(port, 16) | (proto & 0xFFFF),
    )


def sketch_inputs_from_matrix(tags, meters, num_groups: int, ix: tuple) -> dict:
    """`sketch_plane_inputs` over column-major [T, N] tags / [M, N]
    meters via the `sketch_tag_indices` tuple."""
    (i00, i01, i02, i03, i10, i11, i12, i13,
     ix_port, ix_proto, ix_epc, m_byte, m_rs, m_rc) = ix
    return sketch_plane_inputs(
        num_groups, ip0=[tags[i] for i in (i00, i01, i02, i03)],
        ip1=[tags[i] for i in (i10, i11, i12, i13)],
        server_port=tags[ix_port], protocol=tags[ix_proto], l3_epc_id1=tags[ix_epc],
        byte_w=meters[m_byte], rtt_sum=meters[m_rs], rtt_count=meters[m_rc],
    )


def sketch_inputs_from_columns(tags: dict, meters, num_groups: int, meter_ix) -> dict:
    """`sketch_plane_inputs` over a flow-column dict + row-major [N, M]
    meters (`meter_ix` = the meter schema's index function)."""
    return sketch_plane_inputs(
        num_groups, ip0=[tags[f"ip0_w{w}"] for w in range(4)],
        ip1=[tags[f"ip1_w{w}"] for w in range(4)],
        server_port=tags["server_port"], protocol=tags["protocol"],
        l3_epc_id1=tags["l3_epc_id1"], byte_w=meters[:, meter_ix("byte_tx")],
        rtt_sum=meters[:, meter_ix("rtt_sum")], rtt_count=meters[:, meter_ix("rtt_count")],
    )


def sketch_span_bounds(start_window, ts, valid, *, interval: int, delay: int):
    """(base_w, close_w) 0-dim tensors: the pre-/post-batch open-span
    starts under the host's rules — close_w is `_process_block`'s
    advance target max(gate, (t_max − delay)//interval), base_w the
    opening rule's max(gate, min(t_min//interval, close_w)). A batch
    without valid rows gives (gate, gate): t_max = 0 and t_min = U32_MAX
    reduce both formulas to the gate. `start_window` is a host int or a
    0-dim tensor; nothing is fetched."""
    sw = scalar_tensor(start_window)
    t_max = torch.where(valid, ts, 0).max()
    t_min = torch.where(valid, ts, U32_MAX).min()
    t_adj = torch.where(t_max > delay, t_max - delay, 0)
    close_w = torch.maximum(sw, t_adj // interval)
    base_w = torch.maximum(sw, torch.minimum(t_min // interval, close_w))
    return base_w, close_w


def _raw_append_step_sk(acc, offset: int, start_window, stash_valid, stash_evict,
                        feeder_shed: int, fold_rows, casc_lanes, snap_lanes, sk: SketchState,
                        timestamp, key_hi, key_lo, tags, meters, valid, *, interval: int,
                        delay: int, ix: tuple, spec):
    """`_raw_append_step` with the sketch plane folded in: the caller's
    doc fingerprint is the flow key, the client identity re-derives from
    the ip0 tag words, and the counter block carries the sketch lanes.
    Returns (acc, block, sk)."""
    base_w, close_w = sketch_span_bounds(start_window, timestamp, valid,
                                         interval=interval, delay=delay)
    inp = sketch_inputs_from_matrix(tags, meters, sk.hll.shape[1], ix)
    inp["key_hi"], inp["key_lo"] = key_hi, key_lo
    sk = sketch_plane_step(sk, spec, window=timestamp // interval, valid=valid,
                           base_w=base_w, close_w=close_w, **inp)
    acc, block = _raw_append_step(
        acc, offset, start_window, stash_valid, stash_evict, feeder_shed, fold_rows,
        casc_lanes, snap_lanes, timestamp, key_hi, key_lo, tags, meters, valid,
        interval=interval, sk=sk,
    )
    return acc, block, sk


def _stats_ring_push(ring, k: int, sw_state, block, *, interval: int, delay: int):
    """Device side of the K-batch counter ring: write one batch's counter
    block into row `k` of the [K, CB_LEN] ring (in place) and advance the
    device-resident window gate `sw_state` = [start_window, opened] —
    without a host sync, so the host fetches the whole ring once per K
    dispatches. Returns (ring, new sw_state).

    The update replicates `_process_block`'s host bookkeeping exactly:
    after ANY non-empty block the host span ends at max(previous,
    (t_max − delay) // interval) — on the opening batch it first opens
    at max(0, min(t_min, t_max − delay)) but then advances to that same
    value within the SAME block (open_w ≤ adv_w always), so adv_w is the
    post-block gate in both cases. The late gate of every deferred batch
    therefore sees the SAME start_window it would have seen under
    per-batch fetching — the invariant that makes the K-ring flush output
    bit-exact against the per-batch oracle: no row that per-batch mode
    would late-drop can reach a window the deferred flush later closes.
    u32 values ride int64 lanes; every value stays in [0, 2^32)."""
    ring[k] = block
    t_max = block[CB_T_MAX]
    has = block[CB_N_VALID] > 0
    t_adj = torch.where(t_max > delay, t_max - delay, 0)
    new_sw = torch.where(has, torch.maximum(sw_state[0], t_adj // interval), sw_state[0])
    opened = ((sw_state[1] > 0) | has).long()
    return ring, torch.stack([new_sw, opened])


@dataclasses.dataclass(frozen=True)
class WindowConfig:
    interval: int = 1  # seconds per window
    delay: int = 2  # seconds a window stays open past its end
    capacity: int = 1 << 14  # stash rows shared by all open windows
    # batches accumulated between sort+reduce folds; a fold also fires
    # before any window flush so flushed windows see every row
    accum_batches: int = 8
    # per-window sketch plane (aggregator/sketchplane.py, slab mode)
    sketch: SketchConfig | None = None
    # "full" re-sorts stash + ring at every fold; "merge" sorts only the
    # ring and rank-merges it into the stash, and a window advance folds
    # only the closing span (stash.py). Bit-equal flushed windows.
    fold_mode: str = "full"
    # rollup cascade (aggregator/cascade.py): fold closed windows into
    # coarser tiers (1 m, 1 h …) on the device; tier windows surface via
    # WindowManager.pop_tier_windows(). None = off.
    cascade: CascadeConfig | None = None
    # defer each batch's counter-block fetch by one ingest call: flushed
    # windows come out one call later, identical; counters trail by ≤ 1
    # batch. flush_all()/settle() always settle.
    async_drain: bool = False
    # K-batch counter ring: K batches' counter blocks collect in a device
    # [K, CB_LEN] ring fetched once per K dispatches; the late gate moves
    # to device state (_stats_ring_push), so flushed rows stay bit-exact
    # vs per-batch fetching, and windows close up to K − 1 batches later.
    # 1 = per-batch fetch. Mutually exclusive with async_drain.
    stats_ring: int = 1
    # live read plane: minimum wall-clock seconds between two device
    # snapshot reads; snapshot_open() inside it returns the cached
    # OpenSnapshot (force=True bypasses)
    min_snapshot_interval: float = 0.25

    def __post_init__(self):
        check_fold_mode(self.fold_mode)
        for name, cls in (("sketch", SketchConfig), ("cascade", CascadeConfig)):
            value = getattr(self, name)
            if value is not None and not isinstance(value, cls):
                raise TypeError(
                    f"WindowConfig.{name} takes a deepflow_tpu_torch {cls.__name__}, got "
                    f"{type(value).__name__}"
                )
        if self.cascade is not None:
            self.cascade.validate_base(self.interval)

    @property
    def ring(self) -> int:
        """Number of simultaneously-open windows (the sketch ring R)."""
        return self.delay // self.interval + 2


@dataclasses.dataclass
class _FlushEntry:
    """One dispatched-but-not-yet-fetched window advance: the packed
    exact flush handles plus, with the sketch plane on, its drained
    pending blocks (clones — the plane writes its own buffer on)."""

    packed: torch.Tensor  # [S, 3+T+M] int32 bits (device)
    total: torch.Tensor  # 0-dim int64 (device)
    lo: int
    hi: int
    pend: torch.Tensor | None = None  # [P + 1, WIDE] int32 bits ([P + 1, CW] pooled)
    pend_win: torch.Tensor | None = None  # [P + 1] u32 lane
    pend_n: torch.Tensor | None = None  # 0-dim int64
    # pool mode: the wide arena's rows ([Pw, WIDE] int32 bits) and window
    # ids ([Pw] u32 lane, SENTINEL_WIN where the slot did not close)
    wide_rows: torch.Tensor | None = None
    wide_wins: torch.Tensor | None = None
    # the cascade's closed tier flushes at this advance
    tiers: list[TierFlush] = dataclasses.field(default_factory=list)


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
    # the window's sketch summary (sketch plane on); count == 0 with a
    # block attached means the exact stash shed every row of the window
    sketches: WindowSketchBlock | None = None
    # rollup-cascade provenance: 0 = the manager's own resolution; N ≥ 1 =
    # the Nth cascade tier, with `interval` its seconds per window
    # (window_idx and start_time are already in tier units)
    tier: int = 0
    interval: int = 0
    # live read plane: True = a snapshot of a still-OPEN window (the later
    # real flush supersedes it); flushed windows are always False
    partial: bool = False

    @classmethod
    def sketch_only(cls, window_idx: int, start_time: int, sketches, *, num_tags: int,
                    num_meters: int, **kw) -> "FlushedWindow":
        """A window with no exact rows (all shed, or none in a snapshot
        yet) that its sketch block still covers."""
        return cls(window_idx=window_idx, start_time=start_time,
                   key_hi=np.zeros((0,), np.uint32), key_lo=np.zeros((0,), np.uint32),
                   tags=np.zeros((0, num_tags), np.uint32),
                   meters=np.zeros((0, num_meters), np.float32), count=0,
                   sketches=sketches, **kw)


@dataclasses.dataclass
class OpenSnapshot:
    """One pull of the open window span: partial=True FlushedWindows in
    the flush's row layout and (window, stash position) order, with the
    open sketch slots attached where the plane is on. `seq` increments
    per actual device read (cached returns keep theirs); `open_from` is
    the open span's first second (None = nothing ingested yet)."""

    windows: list[FlushedWindow]
    taken_monotonic: float
    open_from: int | None = None
    seq: int = 0


def attach_open_sketch_blocks(windows: list[FlushedWindow], merged: dict, *,
                              interval: int, num_tags: int,
                              num_meters: int) -> list[FlushedWindow]:
    """The open snapshot's block-marry rule: attach each window's open
    sketch block, add a row-less partial window for every block whose
    window has no exact rows, and return the list sorted by window.
    `merged` (window → block) is consumed."""
    for f in windows:
        f.sketches = merged.pop(f.window_idx, None)
    for w in sorted(merged):
        windows.append(FlushedWindow.sketch_only(w, w * interval, merged[w], num_tags=num_tags,
                                                 num_meters=num_meters, partial=True))
    windows.sort(key=lambda f: f.window_idx)
    return windows


class WindowManager:
    """Owns one stash + the open-window span for one granularity."""

    def __init__(self, config: WindowConfig, tag_schema: TagSchema = TAG_SCHEMA,
                 meter_schema: MeterSchema = FLOW_METER, *, device=None):
        if config.stats_ring < 1:
            raise ValueError("stats_ring must be >= 1")
        if config.stats_ring > 1 and config.async_drain:
            raise ValueError(
                "stats_ring > 1 already defers stats fetches; combining it "
                "with async_drain would double-defer — pick one"
            )
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
        # merge mode flushes through the compacting range flush, which
        # keeps the canonical layout the rank merge requires
        self._flush_compact = config.fold_mode == "merge"
        self.n_advances = 0
        self.host_fetches = 0
        self.bytes_fetched = 0
        self.bytes_uploaded = 0  # callers add their upload sizes
        self._pending_flush: list[_FlushEntry] = []
        # per-window sketch plane: device state + the raw-doc step's
        # column indices, the counter-block lane mirrors, and closed
        # blocks fetched before their window's exact rows flushed
        self.sk: SketchState | None = None
        self._sketch_ix: tuple | None = None
        self.sketch_rows = 0
        self.sketch_shed = 0
        # pooled sketch memory: cumulative spills and promotions, and the
        # occupancy gauge (0 in slab mode)
        self.sketch_pool_spill = 0
        self.sketch_pool_occ = 0
        self.sketch_promotions = 0
        self._sketch_blocks: dict[int, WindowSketchBlock] = {}
        if config.sketch is not None:
            self._sketch_ix = sketch_tag_indices(tag_schema, meter_schema)
            self.sk = sketch_init(config.sketch, config.ring, device=self.device)
        # rollup cascade: device tier stashes + host watermarks and pending
        # sketch merges; the counter-block lane mirrors; closed tier
        # windows held for pop_tier_windows (drop-oldest beyond the cap,
        # counted)
        self.cascade: TierCascade | None = None
        self.cascade_rows = 0
        self.cascade_shed = 0
        self.tier_flushed: list[FlushedWindow] = []
        self.max_held_tier_windows = 4096
        self.tier_windows_dropped = 0
        # cached zero [rows, shed] lane vector (cascade off)
        self._zero_lanes = torch.zeros((2,), dtype=torch.int64, device=self.device)
        if config.cascade is not None:
            self.cascade = TierCascade(config.cascade, config.interval, tag_schema,
                                       meter_schema, device=self.device)
        # live read plane: host-authoritative snapshot counters, the cached
        # device [reads, bytes] vector riding into every counter block
        # (rebuilt only when a snapshot is taken, so no per-batch upload),
        # the rate-limit cache, and the lanes' mirrors as of the last
        # fetched block
        self.snapshot_reads = 0
        self.snapshot_bytes = 0
        self.snapshot_seq = 0
        self._snap_lanes_dev = torch.zeros((2,), dtype=torch.int64, device=self.device)
        self._snapshot_cache: OpenSnapshot | None = None
        self.device_snapshot_reads = 0
        self.device_snapshot_bytes = 0
        # async_drain: the deferred counter block (device), fetched next call
        self._pending_stats: torch.Tensor | None = None
        # K-batch counter ring (stats_ring > 1): the device [K, CB_LEN]
        # ring, the blocks in it awaiting the fetch, and the device gate
        # [start_window, opened]; the host span catches up at each drain
        k = config.stats_ring
        self._cb_ring = (torch.zeros((k, CB_LEN), dtype=torch.int64, device=self.device)
                         if k > 1 else None)
        self._ring_count = 0
        self._sw_state = (torch.zeros((2,), dtype=torch.int64, device=self.device)
                          if k > 1 else None)
        # transient-failure policy: dispatch and fetch retry with backoff
        # and jitter (a per-instance rng; the chaos plan's own seeded rng
        # keeps fault injection deterministic)
        self.retry_policy = RetryPolicy()
        self._retry_rng = decorrelated_rng(0xD15EA5E)
        self.dispatch_retries = 0
        self.fetch_retries = 0
        self.tracer = SpanTracer()
        # the device profiling plane: every tensor this manager owns is
        # enumerable via device_planes(), and the manager registers WEAKLY
        # on the process-wide ledger (GC removes it, close() eagerly)
        from ..profiling.ledger import register_profilable

        self._ledger_src = register_profilable(
            "window_manager", self, interval=f"{config.interval}s",
            sketch=str(config.sketch is not None), cascade=str(config.cascade is not None),
        )

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """host_fetch behind the SITE_FETCH seam, retried on transient
        faults (the device tensor stays valid across a failed fetch), +
        transfer accounting (count + bytes)."""

        def once():
            chaos.maybe_fail(chaos.SITE_FETCH)
            return host_fetch(x)

        def on_retry(_attempt, _exc):
            self.fetch_retries += 1

        arr = retry_call(once, self.retry_policy, on_retry=on_retry, rng=self._retry_rng)
        self.host_fetches += 1
        self.bytes_fetched += arr.nbytes
        return arr

    # -- device→host drains ---------------------------------------------
    def _drain_flush(self, entry: _FlushEntry) -> list[FlushedWindow]:
        """Fetch ONE packed flush result and split it into windows: two
        transfers whatever rides along. With the sketch plane or the
        cascade on, the scalar fetch widens to [row count, pending blocks
        (sketch on), closed wide slots (pool mode), tier row counts…] and
        the row fetch becomes one int32 concatenation (flush rows ‖ block
        rows ‖ block window ids, then, when a wide slot closed, every wide
        row ‖ its window id — the host skips the open ones — then the
        rows of each tier flush); the blocks marry their windows, and a
        block whose window has no exact rows in this drain's range
        becomes a sketch-only window. Closed blocks then feed the
        cascade's parent merges, and the tier windows are built."""
        scalars = [entry.total]
        if entry.pend is not None:
            scalars.append(entry.pend_n)
        if entry.wide_rows is not None:
            scalars.append((entry.wide_wins != SENTINEL_WIN).sum())
        scalars += [tf.total for tf in entry.tiers]
        vec = [int(v) for v in self._fetch(torch.stack(scalars) if len(scalars) > 1
                                           else scalars[0]).reshape(-1)]
        total = vec[0]
        n_blocks = vec[1] if entry.pend is not None else 0
        n_wide = vec[2] if entry.wide_rows is not None else 0
        tier_totals = vec[len(vec) - len(entry.tiers):]
        groups = []  # (block rows, window ids) riding the row transfer
        if n_blocks:
            groups.append((entry.pend[:n_blocks], entry.pend_win[:n_blocks]))
        if n_wide:
            groups.append((entry.wide_rows, entry.wide_wins))
        if total == 0 and not groups and not any(tier_totals):
            # nothing to transfer; held blocks may still marry this range
            # and a tier window may close sketch-only
            if not self._sketch_blocks and not entry.tiers:
                return []
            flat = np.zeros((0,), np.uint32)
        else:
            parts = [entry.packed[:total].reshape(-1)]
            for rows, wins in groups:
                parts += [rows.reshape(-1), to_i32_bits(wins)]
            parts += [tf.packed[:t].reshape(-1) for tf, t in zip(entry.tiers, tier_totals)]
            flat = self._fetch(torch.cat(parts) if len(parts) > 1 else parts[0]
                               ).view(np.uint32)
        row_cols = entry.packed.shape[1]
        o = total * row_cols
        self.total_flushed += total
        flushed = self._split_rows(flat[:o].reshape(total, row_cols))
        for rows, _ in groups:
            k, width = rows.shape
            block_rows = flat[o:o + k * width].reshape(k, width)
            wins = flat[o + k * width:o + k * width + k]
            o += k * width + k
            keep = wins != np.uint32(SENTINEL_WIN)
            for blk in unpack_drained(block_rows[keep], wins[keep], self.config.sketch):
                have = self._sketch_blocks.get(blk.window)
                self._sketch_blocks[blk.window] = blk if have is None else have.merge(blk)
        for f in flushed:
            f.sketches = self._sketch_blocks.pop(f.window_idx, None)
        exact_wins = {f.window_idx for f in flushed}
        for w in sorted(self._sketch_blocks):
            if entry.lo <= w < entry.hi and w not in exact_wins:
                flushed.append(FlushedWindow.sketch_only(
                    w, w * self.config.interval, self._sketch_blocks.pop(w),
                    num_tags=self.tag_schema.num_fields,
                    num_meters=self.meter_schema.num_fields))
        flushed.sort(key=lambda f: f.window_idx)
        if self.cascade is not None:
            # this drain's closed child blocks feed the parent merges
            # BEFORE the tier windows are built, so a parent closing in
            # the same drain sees every child
            for f in flushed:
                if f.sketches is not None:
                    self.cascade.feed_block(0, f.window_idx, f.sketches)
            tier_wins = []
            for tf, t in zip(entry.tiers, tier_totals):
                t_rows = flat[o:o + t * row_cols].reshape(t, row_cols)
                o += t * row_cols
                tier_wins += self.cascade.take_tier_windows(tf, t_rows, t)
            self.tier_windows_dropped += hold_blocks(self.tier_flushed, tier_wins,
                                                     self.max_held_tier_windows)
        return flushed

    def _split_rows(self, rows: np.ndarray, *, partial: bool = False) -> list[FlushedWindow]:
        """Packed (window, stash position)-ordered rows → per-window
        FlushedWindows; the flush drain and the live snapshot
        (partial=True) split alike."""
        total = rows.shape[0]
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
                meters=meters[a:b], count=b - a, partial=partial,
            ))
        return flushed

    def _drain_ready(self, ready: list[_FlushEntry]) -> list[FlushedWindow]:
        if not ready:
            return []
        with self.tracer.span(SPAN_FLUSH_DRAIN):
            out = []
            for entry in ready:
                out.extend(self._drain_flush(entry))
            return out

    def _fold(self):
        """Full-set fold: every accumulated row reaches the stash and the
        ring resets. fold_mode picks the full re-sort or the rank merge."""
        if self.fill == 0:
            return
        fold = stash_merge_fold if self.config.fold_mode == "merge" else stash_fold_counted
        with self.tracer.span(SPAN_WINDOW_FOLD):
            self.state, self.acc, self._fold_rows_dev = fold(self.state, self.acc,
                                                             self.meter_schema)
        self.fill = 0

    def _fold_span(self, hi_window: int):
        """Span-bounded advance fold (merge mode): merge only the ring rows
        with slot < hi_window — the windows about to flush. `fill` stays:
        consumed rows turn sentinel in place, and their ring space comes
        back at the next full fold (plan_append)."""
        if self.fill == 0:
            return
        with self.tracer.span(SPAN_WINDOW_FOLD):
            self.state, self.acc, self._fold_rows_dev = stash_merge_fold(
                self.state, self.acc, self.meter_schema, hi_window=hi_window
            )

    def window_of(self, timestamp):
        return timestamp // self.config.interval

    # -- stats processing (the ONE per-batch host sync) ------------------
    def _process_stats(self, stats_dev: torch.Tensor) -> None:
        with self.tracer.span(SPAN_STATS_FETCH):
            vec = [int(v) for v in self._fetch(stats_dev)]
        self._process_block(vec)

    def _drain_stats_ring(self) -> None:
        """Fetch the filled prefix of the counter ring in ONE transfer and
        replay every block in dispatch order: window advances land where
        per-batch fetching would have put them, discovered (and flushed)
        at the drain instead of mid-ring."""
        if self._ring_count == 0:
            return
        with self.tracer.span(SPAN_STATS_FETCH):
            rows = self._fetch(self._cb_ring[:self._ring_count])
        self._ring_count = 0
        for row in rows:
            self._process_block([int(v) for v in row])

    def _sync_device_sw(self) -> None:
        """Reset the device gate state to the host span (after flush_all,
        a checkpoint restore or any external start_window change). Only
        meaningful with stats_ring > 1; requires a drained ring."""
        if self._sw_state is None:
            return
        if self._ring_count:
            raise RuntimeError("cannot resync device gate over a filled ring")
        sw = 0 if self.start_window is None else self.start_window
        opened = 0 if self.start_window is None else 1
        self._sw_state = torch.tensor([sw, opened], dtype=torch.int64, device=self.device)

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
        # cumulative device scalars — mirror, don't accumulate
        self.sketch_rows = vec[CB_SKETCH_ROWS]
        self.sketch_shed = vec[CB_SKETCH_SHED]
        self.cascade_rows = vec[CB_CASCADE_ROWS]
        self.cascade_shed = vec[CB_CASCADE_SHED]
        # the live read's lanes as the device carried them at that
        # dispatch (the host ints stay authoritative)
        self.device_snapshot_reads = vec[CB_SNAPSHOT_READS]
        self.device_snapshot_bytes = vec[CB_SNAPSHOT_BYTES]
        self.sketch_pool_spill = vec[CB_SKETCH_POOL_SPILL]
        self.sketch_pool_occ = vec[CB_SKETCH_POOL_OCC]
        self.sketch_promotions = vec[CB_SKETCH_PROMOTIONS]
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
            with self.tracer.span(SPAN_WINDOW_ADVANCE):
                # flushed windows must see every accumulated row of the
                # closing span; merge mode folds only that span
                if self.config.fold_mode == "merge":
                    self._fold_span(new_start)
                else:
                    self._fold()
                self.state, packed, total = _flush_range_impl(
                    self.state, self.start_window, new_start, compact=self._flush_compact
                )
                self._pending_flush.append(
                    self._make_flush_entry(packed, total, self.start_window, new_start)
                )
            self.start_window = new_start
            self.n_advances += 1

    def _make_flush_entry(self, packed, total, lo: int, hi: int) -> _FlushEntry:
        """The exact flush handles, widened with the sketch plane's
        drained pending blocks (every slot below `hi` closes first) and
        the cascade's tier fold + flush handles (device work only; the
        drain bundles them into its two transfers)."""
        entry = _FlushEntry(packed=packed, total=total, lo=int(lo), hi=int(hi))
        if self.sk is not None:
            (self.sk, entry.pend, entry.pend_win, entry.pend_n, entry.wide_rows,
             entry.wide_wins) = sketch_drain(self.sk, hi)
        if self.cascade is not None:
            entry.tiers = self.cascade.on_advance(packed, total, int(hi))
        return entry

    def _cascade_lanes(self) -> torch.Tensor:
        """Device [rows, shed] vector for the counter block's cascade
        lanes: the cascade's when configured, a cached zero vector
        otherwise."""
        return self._zero_lanes if self.cascade is None else self.cascade.lanes_dev

    def pop_tier_windows(self) -> list[FlushedWindow]:
        """Drain the cascade's closed tier windows (1 m, 1 h …), oldest
        first. Each carries tier ≥ 1 and its tier `interval`; count == 0
        with a sketch block attached means the exact tier stash shed the
        window but the merged child sketches still cover it."""
        out, self.tier_flushed = self.tier_flushed, []
        return out

    # -- live read plane -------------------------------------------------
    def _snapshot_lanes(self) -> torch.Tensor:
        """Device [reads, bytes] vector for counter-block lanes 16–17."""
        return self._snap_lanes_dev

    def snapshot_open(self, *, force: bool = False) -> OpenSnapshot:
        """Pull a read-only snapshot of the OPEN window span: every stash
        row with slot ≥ start_window (the accumulator ring is folded in
        first: device work, no fetch) plus the open sketch slots, in two
        fetches (the row count, then rows ‖ blocks ‖ window ids). Nothing
        is closed, so the later flush of these windows emits the same
        rows plus what arrived after the snapshot: flushed rows supersede
        a window's snapshot.

        Within `min_snapshot_interval` seconds of the last read the cached
        OpenSnapshot returns (same `seq`); `force=True` bypasses. Under
        stash overflow the eager fold can shed at the read instead of at
        the next fold — counted the same way."""
        now = time.monotonic()
        cached = self._snapshot_cache
        if (not force and cached is not None
                and now - cached.taken_monotonic < self.config.min_snapshot_interval):
            return cached
        with self.tracer.span(SPAN_QUERY_SNAPSHOT):
            snap = self._read_open_snapshot(now)
        self.snapshot_seq += 1
        snap.seq = self.snapshot_seq
        self._snap_lanes_dev = torch.tensor(
            [self.snapshot_reads & MASK, self.snapshot_bytes & MASK], dtype=torch.int64,
            device=self.device)
        self._snapshot_cache = snap
        return snap

    def _read_open_snapshot(self, now: float) -> OpenSnapshot:
        if self.start_window is None:
            self.snapshot_reads += 1
            return OpenSnapshot(windows=[], taken_monotonic=now)
        b0, f0 = self.bytes_fetched, self.host_fetches
        self._fold()  # ring rows → stash (exact; no fetch)
        packed, total = stash_snapshot_range(self.state, self.start_window, U32_MAX)
        # the row count travels as 4 bytes, as the reference's does
        total_i = int(self._fetch(total.to(torch.int32)))
        row_cols = packed.shape[1]
        parts = [packed[:total_i].reshape(-1)]
        if self.sk is not None:
            blocks = _flatten_open_snapshot(self.sk)
            parts += [blocks.reshape(-1), to_i32_bits(self.sk.win)]
        if total_i or self.sk is not None:
            flat = self._fetch(torch.cat(parts) if len(parts) > 1 else parts[0]
                               ).view(np.uint32)
        else:
            flat = np.zeros((0,), np.uint32)
        nb = total_i * row_cols
        windows = self._split_rows(flat[:nb].reshape(total_i, row_cols), partial=True)
        if self.sk is not None:
            r, width = blocks.shape
            block_rows = flat[nb:nb + r * width].reshape(r, width)
            wins = flat[nb + r * width:]
            live = wins != np.uint32(SENTINEL_WIN)
            open_blocks = {blk.window: blk for blk in unpack_drained(
                block_rows[live], wins[live], self.config.sketch)}
            windows = attach_open_sketch_blocks(
                windows, open_blocks, interval=self.config.interval,
                num_tags=self.tag_schema.num_fields,
                num_meters=self.meter_schema.num_fields)
        self.snapshot_reads += 1
        self.snapshot_bytes += self.bytes_fetched - b0
        assert self.host_fetches - f0 <= 2, "snapshot must stay a 2-fetch read"
        return OpenSnapshot(windows=windows, taken_monotonic=now,
                            open_from=self.start_window * self.config.interval)

    # -- ingest ----------------------------------------------------------
    def ingest(self, timestamp, key_hi, key_lo, tags, meters, valid,
               feeder_shed: int = 0) -> list[FlushedWindow]:
        """Merge a raw doc batch (device tensors: u32 lanes, [T, N] tags,
        [M, N] meters, bool valid); advance and flush closed windows (with
        async_drain those the previous batch closed; with a counter ring
        those its drains close)."""
        interval = self.config.interval

        def dispatch(acc, offset, start_window):
            st = self.state
            if self.sk is not None:
                return _raw_append_step_sk(
                    acc, offset, start_window, st.valid, st.dropped_overflow,
                    feeder_shed, self._fold_rows_dev, self._cascade_lanes(),
                    self._snapshot_lanes(), self.sk, timestamp, key_hi, key_lo, tags,
                    meters, valid, interval=interval, delay=self.config.delay,
                    ix=self._sketch_ix, spec=self.config.sketch.hist,
                )
            return _raw_append_step(
                acc, offset, start_window, st.valid, st.dropped_overflow,
                feeder_shed, self._fold_rows_dev, self._cascade_lanes(),
                self._snapshot_lanes(), timestamp, key_hi, key_lo, tags, meters, valid,
                interval=interval,
            )

        return self.ingest_step(dispatch, int(timestamp.shape[0]))

    def ingest_step(self, dispatch, rows: int,
                    ring_rows: int | None = None) -> list[FlushedWindow]:
        """Window protocol around a caller-supplied append step.

        `dispatch(acc, offset, start_window)` returns (new_acc, counter
        block), plus the updated sketch plane when it is on; `rows` is
        the number of accumulator rows it appends; `ring_rows` (≥ rows)
        sizes the ring for a larger coming batch. `start_window` is a
        host int, or with stats_ring > 1 the device gate (a 0-dim tensor
        the step must not read back). An empty batch only drains the
        flushes already dispatched."""
        if rows == 0:
            return self._settle_ready()
        ready, self._pending_flush = self._pending_flush, []
        if self._pending_stats is not None:
            # async: the previous batch's block moves the span BEFORE this
            # batch's gate, exactly as in sync mode
            stats, self._pending_stats = self._pending_stats, None
            self._process_stats(stats)

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
        k = self.config.stats_ring
        if k > 1:
            # the gate stays on the device between ring drains: the host
            # span may lag by up to K − 1 batches, the gate never does
            sw = self._sw_state[0]
        else:
            sw = 0 if self.start_window is None else self.start_window

        def dispatch_once():
            # the seam fires BEFORE the step, which writes the ring (and
            # the sketch plane) in place: a retried injected fault never
            # meets a half-applied step
            chaos.maybe_fail(chaos.SITE_DISPATCH)
            return dispatch(self.acc, self.fill, sw)

        def on_retry(_attempt, _exc):
            self.dispatch_retries += 1

        with self.tracer.span(SPAN_INGEST_DISPATCH):
            out = retry_call(dispatch_once, self.retry_policy, on_retry=on_retry,
                             rng=self._retry_rng, classify=is_dispatch_transient)
        if self.sk is not None:
            self.acc, stats_dev, self.sk = out
        else:
            self.acc, stats_dev = out
        self.fill += rows
        if k > 1:
            self._cb_ring, self._sw_state = _stats_ring_push(
                self._cb_ring, self._ring_count, self._sw_state, stats_dev,
                interval=self.config.interval, delay=self.config.delay)
            self._ring_count += 1
            if self._ring_count >= k:
                self._drain_stats_ring()
        elif self.config.async_drain:
            # defer only this batch's block; the previous batch's flush
            # (dispatched above, before this append) is fetched below
            self._pending_stats = stats_dev
        else:
            self._process_stats(stats_dev)
        ready.extend(self._pending_flush)
        self._pending_flush = []
        return self._drain_ready(ready)

    def _settle_ready(self) -> list[FlushedWindow]:
        """Drain the dispatched flushes without appending anything."""
        ready, self._pending_flush = self._pending_flush, []
        return self._drain_ready(ready)

    def settle(self) -> list[FlushedWindow]:
        """Fetch every deferred buffer — the counter ring's blocks, the
        pending async block, then the dispatched flushes — so the host
        counters and span agree with the device. Returns the windows
        that were in flight (their rows have left the stash)."""
        self._drain_stats_ring()
        if self._pending_stats is not None:
            stats, self._pending_stats = self._pending_stats, None
            self._process_stats(stats)
        return self._settle_ready()

    def flush_all(self) -> list[FlushedWindow]:
        """Drain every open window (shutdown path); with the cascade on,
        every tier window closes too (`hi` = `TierCascade.flush_hi()`)."""
        flushed = self.settle()
        if self.start_window is None:
            return flushed
        self._fold()
        hi = U32_MAX if self.cascade is None else self.cascade.flush_hi()
        self.state, packed, total = _flush_range_impl(self.state, 0, hi,
                                                      compact=self._flush_compact)
        self._pending_flush.append(self._make_flush_entry(packed, total, 0, hi))
        flushed += self._settle_ready()
        for f in flushed:
            self.start_window = max(self.start_window, f.window_idx + 1)
        # the host span jumped past every drained window: the device gate
        # follows, or a straggler would re-open an emitted window (the
        # ring was drained by settle() above)
        self._sync_device_sw()
        return flushed

    # -- device profiling plane ------------------------------------------
    def device_planes(self) -> dict:
        """Profilable face: every device-resident plane this manager
        owns, by name (the reference's vocabulary) — the ledger reads
        storage sizes only, zero fetches. The enumeration IS the
        ownership contract: a new device buffer on the manager without a
        plane entry here fails the ledger reconciliation."""
        planes: dict[str, object] = {
            "stash": self.state,
            "accumulator": self.acc,  # None until the first batch
            "stats_ring": [self._cb_ring, self._sw_state],
            "lanes": [self._fold_rows_dev, self._zero_lanes, self._snap_lanes_dev],
            # async-drain holds: the deferred counter block plus every
            # dispatched-but-unfetched flush's device handles
            "pending_flush": [self._pending_stats] + [
                [e.packed, e.total, e.pend, e.pend_win, e.pend_n, e.wide_rows,
                 e.wide_wins] + [[tf.packed, tf.total] for tf in e.tiers]
                for e in self._pending_flush
            ],
        }
        if self.sk is not None:
            sk = self.sk
            if _pool_mode(sk):
                # pooled memory splits the plane four ways: the compact
                # arena, the wide arena, the pending drain buffer and the
                # routing/counter meta
                planes["sketch_pool_hot"] = [sk.p_hll, sk.p_cms, sk.p_hist, sk.p_tkv,
                                             sk.p_tkh, sk.p_tkl, sk.p_tia, sk.p_tib]
                planes["sketch_pool_wide"] = [sk.hll, sk.cms, sk.hist, sk.tk_votes,
                                              sk.tk_hi, sk.tk_lo, sk.tk_ida, sk.tk_idb]
                planes["sketch_pending"] = [sk.pend, sk.pend_win]
                planes["sketch_meta"] = [sk.win, sk.count, sk.slot_of, sk.wide_close,
                                         sk.wide_count, sk.rows, sk.shed, sk.pend_n,
                                         sk.pool_spill, sk.pool_promos, sk.promote_fill]
            else:
                planes["sketch"] = sk
        if self.cascade is not None:
            planes["cascade"] = [self.cascade.tiers, self.cascade.accs, self.cascade.fills,
                                 self.cascade.lanes_dev]
        return planes

    def close(self) -> None:
        """Eager teardown of the ledger registration (the weakref gets
        there eventually; close() makes it synchronous)."""
        from ..profiling.ledger import default_ledger

        default_ledger.deregister(self._ledger_src)

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
            # transient faults the retry policy absorbed
            "dispatch_retries": self.dispatch_retries,
            "fetch_retries": self.fetch_retries,
            "feeder_shed": self.feeder_shed,
            # counter-ring blocks awaiting the 1/K fetch: host counters may
            # trail the device by that many batches
            "stats_ring_pending": self._ring_count,
            # sketch plane (CB lanes as of the last fetched block)
            "sketch_rows": self.sketch_rows,
            "sketch_shed": self.sketch_shed,
            "sketch_pool_spill": self.sketch_pool_spill,
            "sketch_pool_occ": self.sketch_pool_occ,
            "sketch_promotions": self.sketch_promotions,
            # rollup cascade (CB lanes as of the last fetched block) and
            # the held tier windows (rising dropped = nobody pops)
            "cascade_rows": self.cascade_rows,
            "cascade_shed": self.cascade_shed,
            "tier_windows_held": len(self.tier_flushed),
            "tier_windows_dropped": self.tier_windows_dropped,
            # live read plane: host-authoritative, and the device lanes as
            # of the last fetched block
            "snapshot_reads": self.snapshot_reads,
            "snapshot_bytes": self.snapshot_bytes,
            "device_snapshot_reads": self.device_snapshot_reads,
            "device_snapshot_bytes": self.device_snapshot_bytes,
            **(self.cascade.get_counters() if self.cascade is not None else {}),
        }

    @property
    def counters(self) -> dict:
        """get_counters + live stash scalars (two fetches)."""
        out = self.get_counters()
        out["drop_overflow"] = int(self._fetch(self.state.dropped_overflow))
        out["occupancy"] = int(self._fetch(self.state.valid.sum()))
        return out
