"""Flow-metrics rollup pipelines, L4 network + L7 application (port of
deepflow_tpu/aggregator/pipeline.py).

Per batch: optional batch-local pre-reduce → [sketch plane] → fanout →
packed-word doc fingerprint → late gate + counter block → accumulator
ring append, as one eager PyTorch step on the pipeline's device;
`WindowManager` drives the window protocol around it. The segmented
reduces inside the pre-reduce and the fold (full or merge) run the CUDA
kernel of kernels/segreduce.cu on the card, the slab sketch plane's
fused HLL / count-min / top-K update the kernel of
kernels/sketch_fused.cu (pool mode takes plain scatters).

The sketch plane (`WindowConfig(sketch=SketchConfig(...))`, slab or
pool mode) folds the pre-reduced flow rows BEFORE the fanout, so a flow
counts once; closed blocks collect in `closed_sketches` for
`pop_closed_sketches()`. Unlike the reference's RollupPipeline, whose
counter block leaves the pool lanes 18–20 at 0, the port fills them
from the plane, as both packages' WindowManager.ingest does.

With the rollup cascade (`WindowConfig(cascade=CascadeConfig(...))`)
closed 1 m / 1 h tier windows come out of `pop_tier_docbatches()`;
`DualGranularityPipeline` serves the 1 s and 1 m series from one
pipeline that way, and `DoubleIngestPipeline` — two pipelines, every
batch ingested twice — is kept as its conformance oracle.

`RollupPipeline.snapshot_open()` is the live read of the open windows
(WindowManager.snapshot_open); its [reads, bytes] lanes ride every
counter block. The WindowManager's counter ring (`stats_ring`) and
`async_drain` apply to every pipeline step.

A pipeline with a cascade lists its tiers with the server's datasource
registry (`server.datasource.register_cascade_tiers`), weakly held.

Self-observability, as in the reference: every pipeline registers its
fetch-free counters (`tpu_pipeline`) and its WindowManager's stage spans
(`tpu_pipeline_spans`) on the default StatsCollector, weakly; beyond the
reference's, `stage()` records `stage.pack` and `stage.upload` (with
the bytes uploaded) and the step `step.prereduce`, `step.sketch` and
`step.fanout` with their device time (utils/spans ROLLUP_SPAN_NAMES); the
manager is on the device-memory ledger (profiling/ledger.py). The first
dispatch of each bucket shape is observed by the step census
(profiling/census.py, step "fused_step", the reference's name):
argument shapes, host wall and the logical sorts the step runs.
`profile_snapshot()` joins the per-plane bytes and this pipeline's
census rows; `telemetry()` adds the counters and the span summary;
`close()` deregisters everything eagerly.

Window lineage: `attach_lineage(tracker)` wires a
tracing/lineage.LineageTracker through the pipeline and its manager:
`stage()` takes the batch's host event-time bounds before the upload and
stamps the upload hop, and `ingest_staged` binds them to the dispatch.
Host wall stamps only — no device fetch.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from ..datamodel.batch import DocBatch, FlowBatch
from ..datamodel.code import DOC_KEY_PACK, RAW_TAG_PACK, DocumentFlag, pack_tag_words
from ..datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA, MeterSchema
from ..device import resolve_device
from ..ops.hashing import fingerprint64_words
from ..ops.segment import groupby_reduce, sort_census
from ..ops.u32 import from_numpy_u32
from ..utils.spans import (
    SPAN_STAGE_PACK,
    SPAN_STAGE_UPLOAD,
    SPAN_STEP_FANOUT,
    SPAN_STEP_PREREDUCE,
    SPAN_STEP_SKETCH,
)
from ..utils.stats import register_countable
from .fanout import FANOUT_LANES, FanoutConfig, fanout_l4, fanout_l7
from ..ops.segment import SENTINEL_SLOT
from .stash import _append_impl, _fold_impl, _merge_fold_impl, check_fold_mode, sum_max_cols
from .cascade import CascadeConfig
from .sketchplane import SketchConfig, SketchState, hold_blocks, sketch_plane_step
from .window import (
    FlushedWindow,
    WindowConfig,
    WindowManager,
    batch_counter_block,
    sketch_counter_lanes,
    sketch_inputs_from_columns,
    sketch_span_bounds,
)

# per-instance census service keys (see RollupPipeline.__init__)
_PIPELINE_SEQ = itertools.count(1)

# DOC_KEY_PACK covers exactly the TAG_SCHEMA key columns — drift between
# the schema and the packing widths table fails at import.
assert set(DOC_KEY_PACK.field_names()) == {
    f.name for f in TAG_SCHEMA.fields if f.key
}, "DOC_KEY_WIDTHS out of sync with TAG_SCHEMA key columns"


def _doc_fingerprint(doc_tags: torch.Tensor, with_excess: bool = False):
    """(hi, lo[, excess]) over a [T, N] doc tag matrix via the packed-word
    plan (both murmur seeds fold the same ~22 words). `excess` is the
    packing-guard word: nonzero for rows whose tag values overflow the
    declared DOC_KEY_WIDTHS."""
    cols = {f: doc_tags[TAG_SCHEMA.index(f)] for f in DOC_KEY_PACK.field_names()}
    words = pack_tag_words(cols, DOC_KEY_PACK)
    hi, lo = fingerprint64_words(words)
    if with_excess:
        excess = words[-1] if DOC_KEY_PACK.packed else torch.zeros_like(hi)
        return hi, lo, excess
    return hi, lo


def prereduce_keys(tags: dict, interval: int):
    """The pre-reduce's group-by key: (slot, hi, lo) over the packed raw
    tag words, plus the [T, N] tag payload stacked in sorted-name order."""
    names = sorted(tags)
    tags_t = torch.stack([tags[k] for k in names])
    hi, lo = fingerprint64_words(pack_tag_words(tags, RAW_TAG_PACK))
    return names, tags["timestamp"] // interval, hi, lo, tags_t


def batch_prereduce(tags: dict, meters, valid, interval: int, cap: int,
                    sum_cols, max_cols):
    """Batch-local pre-reduce BEFORE fanout: group raw rows by their full
    tag fingerprint (timestamp included) and reduce meters. Exact, since
    identical raw rows give identical docs in every fanout lane and the
    lanes' meter transforms commute with per-column sum/max. Returns
    (tags, meters [cap, M], valid, dropped) — keys beyond `cap` are shed
    and counted in `dropped`."""
    names, slot, hi, lo, tags_t = prereduce_keys(tags, interval)
    g = groupby_reduce(slot, hi, lo, tags_t, meters, valid, sum_cols, max_cols,
                       out_capacity=cap)
    r_tags = {k: g.tags[i] for i, k in enumerate(names)}
    dropped = torch.clamp(g.num_segments - cap, min=0)
    return r_tags, g.meters.t().contiguous(), g.seg_valid, dropped


def pack_flow_batch(batch: FlowBatch) -> tuple:
    """The host half of the upload: (sorted tag names, [T, N] u32 tag
    matrix, [N, M] C-contiguous f32 meters, [N] bool valid). The meters
    are copied only where read-only (decoded wire frames) or not f32."""
    names = tuple(sorted(batch.tags))
    tags = np.stack([np.asarray(batch.tags[k]) for k in names]).astype(np.uint32, copy=False)
    return (names, tags, np.require(batch.meters, np.float32, ["C", "W"]),
            np.asarray(batch.valid, bool))


def upload_flow_batch(packed: tuple, device) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """A pack_flow_batch → (tag lanes dict, [N, M] f32 meters, [N] bool)
    on `device`; the tag columns travel as ONE u32 upload."""
    names, tag_mat, meters, valid = packed
    mat = from_numpy_u32(tag_mat, device)
    return ({k: mat[i] for i, k in enumerate(names)}, torch.from_numpy(meters).to(device),
            torch.from_numpy(valid).to(device))


def sketch_flow_rows(sk: SketchState, spec, tags: dict, meters, valid, start_window, *,
                     interval: int, delay: int, meter_ix) -> SketchState:
    """The sketch plane over (pre-reduced) flow rows: span bounds from
    the rows' own timestamps and the gate, then one plane step."""
    ts = tags["timestamp"]
    base_w, close_w = sketch_span_bounds(start_window, ts, valid,
                                         interval=interval, delay=delay)
    inp = sketch_inputs_from_columns(tags, meters, sk.hll.shape[1], meter_ix)
    return sketch_plane_step(sk, spec, window=ts // interval, valid=valid,
                             base_w=base_w, close_w=close_w, **inp)


def make_ingest_step(fanout_config: FanoutConfig, interval: int = 1, app: bool = False,
                     batch_unique_cap: int | None = None, fold_mode: str = "full", *,
                     sketch_config: SketchConfig | None = None, delay: int = 2,
                     device=None):
    """Build the device step pair: FlowBatch lanes → stash.

    Returns (append, fold):

      (stash, acc) = append(stash, acc, offset, tags, meters, valid)
      (stash, acc) = fold(stash, acc)

    With `sketch_config` set, append also folds the per-window sketch
    plane (from the pre-reduced rows, before the fanout):

      (stash, acc, sk) = append(stash, acc, offset, sk, tags, meters,
                                valid, start_window)

    where `sk` comes from sketchplane.sketch_init and `start_window` is
    the host's open-span gate; `delay` must match the window manager's.

    `append` runs per batch: optional pre-reduce → fanout → fingerprint
    → one ring write at `offset` (a host int the caller advances).
    `fold` is the amortized fold of the ring into the stash: with
    `fold_mode` "full" one sort+reduce over [S + A] rows, with "merge"
    the rank merge of the sorted ring into the stash. `tags` is a
    dict of [N] u32 lanes (or a FlowBatch's numpy columns, uploaded to
    `device`); stash/acc come from stash_init/accum_init on `device`.
    The ring and the sketch plane are written in place."""
    check_fold_mode(fold_mode)
    dev = resolve_device(device)
    fanout_fn = fanout_l7 if app else fanout_l4
    meter_schema = APP_METER if app else FLOW_METER
    sum_cols, max_cols = sum_max_cols(meter_schema)

    def _lanes(tags, meters, valid):
        if isinstance(meters, np.ndarray):
            return upload_flow_batch(
                pack_flow_batch(FlowBatch(tags=tags, meters=meters, valid=valid)), dev)
        return tags, meters, valid

    def _base_append(stash, acc, offset, tags, meters, valid, sk=None, start_window=0):
        tags, meters, valid = _lanes(tags, meters, valid)
        if batch_unique_cap is not None:
            tags, meters, valid, dropped = batch_prereduce(
                tags, meters, valid, interval, batch_unique_cap, sum_cols, max_cols
            )
            stash = dataclasses.replace(
                stash, dropped_overflow=stash.dropped_overflow + dropped
            )
        if sk is not None:
            sk = sketch_flow_rows(sk, sketch_config.hist, tags, meters, valid,
                                  start_window, interval=interval, delay=delay,
                                  meter_ix=meter_schema.index)
        doc_tags, doc_meters, ts, doc_valid = fanout_fn(tags, meters, valid, fanout_config)
        hi, lo = _doc_fingerprint(doc_tags)
        acc = _append_impl(acc, ts // interval, hi, lo, doc_tags, doc_meters,
                           doc_valid, offset)
        return stash, acc, sk

    if sketch_config is None:
        def append(stash, acc, offset, tags, meters, valid):
            stash, acc, _ = _base_append(stash, acc, offset, tags, meters, valid)
            return stash, acc
    else:
        def append(stash, acc, offset, sk, tags, meters, valid, start_window):
            return _base_append(stash, acc, offset, tags, meters, valid, sk, start_window)

    def fold(stash, acc):
        if fold_mode == "merge":
            return _merge_fold_impl(stash, acc, SENTINEL_SLOT, sum_cols, max_cols)[:2]
        return _fold_impl(stash, acc, sum_cols, max_cols)

    return append, fold


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    fanout: FanoutConfig = FanoutConfig()
    window: WindowConfig = WindowConfig()
    batch_size: int = 4096  # static pad size for flow batches
    # batch-local pre-reduce before fanout (batch_prereduce); None = off
    batch_unique_cap: int | None = None
    # shape buckets: each batch pads to the smallest bucket ≥ its rows
    # instead of to batch_size (sorted unique; larger batches raise)
    bucket_sizes: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.bucket_sizes is not None:
            bs = tuple(self.bucket_sizes)
            if not bs or list(bs) != sorted(set(bs)) or bs[0] <= 0:
                raise ValueError(
                    f"bucket_sizes must be sorted unique positive ints, got {bs}"
                )


def rollup_step(p, acc, offset: int, start_window, stash_valid, stash_evict,
                feeder_shed: int, fold_rows, casc_lanes, snap_lanes, sk, tags: dict, meters,
                valid):
    """One batch: [pre-reduce →] [sketch plane →] fanout →
    fingerprint → counter block (with the cascade's [rows, shed] and
    the live read's [reads, bytes] lanes) → ring append, under the
    spans step.prereduce, step.sketch and step.fanout (host and
    device time). Returns (acc, counter block), plus the sketch plane
    when it is on. `start_window` is a host int or the device gate
    (stats_ring > 1). `p` is the pipeline, or one shard of a sharded
    one (parallel/sharded.py): it supplies `config`, `fanout_fn`,
    `meter_schema`, `_sum_cols` / `_max_cols`, `tracer` and `device`."""
    window_cfg = p.config.window
    interval = window_cfg.interval
    span, dev = p.tracer.span, p.device
    aux = None
    cap_u = p.config.batch_unique_cap
    if cap_u is not None:
        with span(SPAN_STEP_PREREDUCE, dev):
            tags, meters, valid, aux = batch_prereduce(
                tags, meters, valid, interval, cap_u, p._sum_cols, p._max_cols
            )
    if sk is not None:
        # from the pre-reduced rows, before the fanout: a flow counts
        # once (doc-lane replication would multiply its weights)
        with span(SPAN_STEP_SKETCH, dev):
            sk = sketch_flow_rows(sk, window_cfg.sketch.hist, tags, meters, valid,
                                  start_window, interval=interval,
                                  delay=window_cfg.delay,
                                  meter_ix=p.meter_schema.index)
    with span(SPAN_STEP_FANOUT, dev):
        doc_tags, doc_meters, ts, doc_valid = p.fanout_fn(
            tags, meters, valid, p.config.fanout
        )
        hi, lo, excess = _doc_fingerprint(doc_tags, with_excess=True)
        gated, window, block = batch_counter_block(
            ts, doc_valid, start_window, interval, aux=aux,
            excess_hits=((excess != 0) & doc_valid).sum(),
            stash_valid=stash_valid, stash_evictions=stash_evict,
            ring_fill=offset, feeder_shed=feeder_shed, fold_rows=fold_rows,
            cascade_rows=casc_lanes[0], cascade_shed=casc_lanes[1],
            snapshot_reads=snap_lanes[0], snapshot_bytes=snap_lanes[1],
            **sketch_counter_lanes(sk),
        )
        acc = _append_impl(acc, window, hi, lo, doc_tags, doc_meters, gated, offset)
    return (acc, block) if sk is None else (acc, block, sk)


@dataclasses.dataclass
class StagedBatch:
    """A bucket-padded batch already uploaded to the pipeline's device
    whose append step has not run yet."""

    tags: dict  # name → [B] u32 lane (device)
    meters: torch.Tensor  # [B, M] f32 (device)
    valid: torch.Tensor  # [B] bool (device)
    padded_rows: int  # B — the bucket this batch padded to
    # lineage plane: the batch's host-side event-time bounds (valid rows
    # only), taken in stage() BEFORE the upload — t_max < t_min means
    # "not computed" (no lineage attached)
    t_min: int = 0
    t_max: int = -1


class RollupPipeline:
    """Single-granularity (e.g. 1 s) rollup pipeline: fanout →
    fingerprint → windowed stash fold, with host-driven window flushes.
    Runs on `device` (default CUDA; raises without it)."""

    fanout_fn = staticmethod(fanout_l4)
    meter_schema: MeterSchema = FLOW_METER

    def __init__(self, config: PipelineConfig = PipelineConfig(), *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.wm = WindowManager(config.window, TAG_SCHEMA, self.meter_schema,
                                device=self.device)
        self._sum_cols, self._max_cols = sum_max_cols(self.meter_schema)
        # closed-window sketch blocks, held for pop_closed_sketches();
        # bounded: beyond the cap the oldest drops and is counted
        self.closed_sketches: list = []
        self.max_held_sketches = 512
        self.sketch_blocks_dropped = 0
        # the cascade's merged tier sketch blocks, held the same way
        self.closed_tier_sketches: list = []
        self.tier_sketch_blocks_dropped = 0
        if config.window.cascade is not None:
            # the datasource listing reflects which tiers this cascade
            # serves; lazy import — the aggregator must not hard-depend
            # on the server layer
            from ..server.datasource import register_cascade_tiers

            register_cascade_tiers(self.meter_schema.name, config.window.cascade.intervals,
                                   owner=self)
        self.tracer = self.wm.tracer  # host stage spans (utils/spans)
        # self-telemetry registration, weakly held; handles kept so
        # close() can deregister eagerly
        tags = dict(kind=type(self).__name__, interval=f"{config.window.interval}s")
        self._stats_srcs = [register_countable("tpu_pipeline", self, **tags),
                            register_countable("tpu_pipeline_spans", self.tracer, **tags)]
        # the step census (read at construction, so a test can swap in a
        # fresh one); a per-INSTANCE service key, since two live pipelines
        # of one class and interval may run different steps
        from ..profiling import census as census_mod

        self._census = census_mod.default_census
        self._census_service = (f"{type(self).__name__}:{config.window.interval}s"
                                f"#{next(_PIPELINE_SEQ)}")
        # window lineage plane: opt-in via attach_lineage
        self._lineage = None

    def attach_lineage(self, tracker) -> None:
        """Wire a tracing/lineage.LineageTracker through this pipeline:
        stage() stamps the upload hop and takes the batch's host
        event-time bounds, ingest_staged binds them to the dispatch, and
        the wrapped WindowManager records advance/flush/tier/snapshot
        hops and the freshness lags. Host wall stamps only — zero new
        device fetches."""
        self._lineage = tracker
        self.wm.attach_lineage(tracker)

    _step = rollup_step

    def _pad_target(self, rows: int) -> int:
        buckets = self.config.bucket_sizes
        if not buckets:
            return self.config.batch_size
        for b in buckets:
            if rows <= b:
                return b
        raise ValueError(
            f"batch of {rows} rows exceeds the largest shape bucket "
            f"{buckets[-1]}; the feeder must slice to max(bucket_sizes)"
        )

    def stage(self, batch: FlowBatch) -> StagedBatch | None:
        """Pad to the shape bucket and upload (spans stage.pack, then
        stage.upload with the bytes uploaded). None for an all-padding
        batch."""
        lin = self._lineage
        t_min, t_max, s0 = 0, -1, 0.0
        with self.tracer.span(SPAN_STAGE_PACK):
            batch = batch.pad_to(self._pad_target(batch.size))
            if not np.any(batch.valid):
                return None
            if lin is not None:
                # host event-time bounds BEFORE the upload (numpy — free);
                # the dispatch binds them to the lineage window span
                ts = np.asarray(batch.tags["timestamp"])[batch.valid]
                if ts.size:
                    t_min, t_max = int(ts.min()), int(ts.max())
                s0 = lin.clock()
            packed = pack_flow_batch(batch)
        with self.tracer.span(SPAN_STAGE_UPLOAD) as up:
            tags, meters, valid = upload_flow_batch(packed, self.device)
            up.bytes = 4 * len(tags) * batch.size + meters.nbytes + valid.nbytes
        self.wm.bytes_uploaded += up.bytes
        if lin is not None:
            lin.note_stage(s0)
        return StagedBatch(tags=tags, meters=meters, valid=valid,
                           padded_rows=batch.size, t_min=t_min, t_max=t_max)

    def ingest(self, batch: FlowBatch, feeder_shed: int = 0) -> list[DocBatch]:
        """Feed one decoded flow batch; returns any closed windows."""
        staged = self.stage(batch)
        if staged is None:
            return self._convert_flushed(self.wm.settle())
        return self.ingest_staged(staged, feeder_shed=feeder_shed)

    def ingest_staged(self, staged: StagedBatch, feeder_shed: int = 0) -> list[DocBatch]:
        """Run the append step for an already-staged batch."""
        cap_u = self.config.batch_unique_cap
        rows = FANOUT_LANES * (cap_u or staged.padded_rows)
        max_rows = FANOUT_LANES * (
            cap_u or (self.config.bucket_sizes or (self.config.batch_size,))[-1]
        )

        key = (self._census_service, "fused_step", staged.padded_rows)
        first = not self._census.seen(*key)

        def dispatch(acc, offset, start_window):
            st = self.wm.state
            args = (acc, offset, start_window, st.valid, st.dropped_overflow, feeder_shed,
                    self.wm._fold_rows_dev, self.wm._cascade_lanes(),
                    self.wm._snapshot_lanes(), self.wm.sk, staged.tags, staged.meters,
                    staged.valid)
            if not first:
                return self._step(*args)
            # census capture, a bucket's first dispatch only: shapes and
            # dtypes (host metadata), the logical sorts, the outputs
            self._census.observe(*key, self._step, args)
            with sort_census() as tally:
                out = self._step(*args)
            self._census.note_sorts(*key, tally)
            self._census.note_outputs(*key, out)
            return out

        window_span = None
        if self._lineage is not None and staged.t_max >= staged.t_min:
            iv = self.config.window.interval
            window_span = (staged.t_min // iv, staged.t_max // iv)
        t0 = time.perf_counter()
        flushed = self.wm.ingest_step(dispatch, rows, ring_rows=max_rows,
                                      window_span=window_span)
        if first:
            # the first dispatch's host wall is the bucket's warmup tax
            # (no device sync: the counter-block fetch inside already
            # waited for the step when it is not deferred)
            self._census.note_compile(*key, time.perf_counter() - t0)
        return self._convert_flushed(flushed)

    def drain(self) -> list[DocBatch]:
        return self._convert_flushed(self.wm.flush_all())

    def snapshot_open(self, *, force: bool = False):
        """The live read: a read-only OpenSnapshot of the open window span
        (rate-limited; WindowManager.snapshot_open). Ingest is untouched;
        the read costs 2 fetches."""
        return self.wm.snapshot_open(force=force)

    def _convert_flushed(self, flushed: list[FlushedWindow]) -> list[DocBatch]:
        """FlushedWindows → DocBatches; closed sketch blocks are captured
        into `closed_sketches` (a sketch-only window — every exact row
        shed — gives a block but no DocBatch)."""
        blocks = [f.sketches for f in flushed if f.sketches is not None]
        self.sketch_blocks_dropped += hold_blocks(self.closed_sketches, blocks,
                                                  self.max_held_sketches)
        return [self._to_docbatch(f) for f in flushed if f.count]

    def pop_closed_sketches(self) -> list:
        """Drain the accumulated WindowSketchBlocks (oldest first)."""
        out, self.closed_sketches = self.closed_sketches, []
        return out

    def pop_tier_windows(self) -> list[FlushedWindow]:
        """Drain the cascade's closed tier windows — FlushedWindows with
        tier ≥ 1 and the tier interval set."""
        return self.wm.pop_tier_windows()

    def pop_tier_docbatches(self) -> list[tuple[int, DocBatch]]:
        """Closed cascade tier windows as (tier_interval_s, DocBatch)
        pairs, oldest first. Merged tier sketch blocks are captured into
        `closed_tier_sketches` (a sketch-only tier window contributes a
        block but no DocBatch)."""
        windows = self.wm.pop_tier_windows()
        blocks = [f.sketches for f in windows if f.sketches is not None]
        self.tier_sketch_blocks_dropped += hold_blocks(self.closed_tier_sketches, blocks,
                                                       self.max_held_sketches)
        return [(f.interval, self._to_docbatch(f)) for f in windows if f.count]

    def _to_docbatch(self, f: FlushedWindow) -> DocBatch:
        return DocBatch(
            tags=f.tags,
            meters=f.meters,
            timestamp=np.full((f.count,), f.start_time, dtype=np.uint32),
            valid=np.ones((f.count,), dtype=bool),
            tag_schema=TAG_SCHEMA,
            meter_schema=self.meter_schema,
        )

    def get_counters(self) -> dict:
        """Fetch-free counters (WindowManager.get_counters) plus the held
        sketch blocks and the drop-oldest overflow count."""
        out = self.wm.get_counters()
        out["sketch_blocks_held"] = len(self.closed_sketches)
        out["sketch_blocks_dropped"] = self.sketch_blocks_dropped
        out["tier_sketch_blocks_held"] = len(self.closed_tier_sketches)
        out["tier_sketch_blocks_dropped"] = self.tier_sketch_blocks_dropped
        return out

    # -- device profiling plane ------------------------------------------
    def device_planes(self) -> dict:
        """Profilable face — the owning WindowManager's planes (the
        manager is the one registered on the ledger, so the flat tpu_hbm_*
        lanes never double-count a pipeline-wrapped manager)."""
        return self.wm.device_planes()

    def profile_snapshot(self, *, analyze: bool = False) -> dict:
        """This pipeline's profile record: per-plane device bytes and the
        census rows of its step (`analyze=True` adds the bytes bound of
        the recorded shapes; nothing runs on the device)."""
        from ..profiling.ledger import plane_bytes

        seen: set = set()
        return {
            "hbm_bytes": {name: plane_bytes(tree, seen)[0]
                          for name, tree in sorted(self.wm.device_planes().items())},
            "census": [r for r in self._census.snapshot(analyze=analyze)
                       if r["service"] == self._census_service],
        }

    def close(self) -> None:
        """Eager teardown: the manager leaves the ledger and the
        pipeline's Countable rows stop."""
        self.wm.close()
        from ..utils.stats import default_collector

        for src in self._stats_srcs:
            default_collector.deregister(src)

    def telemetry(self) -> dict:
        """JSON-able snapshot: the fetch-free counters, the per-stage span
        summary and the profile record (no analysis)."""
        return {"counters": self.get_counters(), "spans": self.tracer.summary(),
                "profile": self.profile_snapshot()}

    @property
    def counters(self) -> dict:
        out = dict(self.wm.counters)
        out["prereduce_dropped"] = out.pop("prereduce_shed")
        return out

    @property
    def flags(self) -> DocumentFlag:
        if self.config.window.interval == 1:
            return DocumentFlag.PER_SECOND_METRICS
        return DocumentFlag.NONE


class L4Pipeline(RollupPipeline):
    """network / network_map rollup (FlowMeter docs)."""


class L7Pipeline(RollupPipeline):
    """application / application_map rollup (AppMeter docs)."""

    fanout_fn = staticmethod(fanout_l7)
    meter_schema = APP_METER


class DualGranularityPipeline:
    """SECOND + MINUTE rollups from one flow stream, one append step per
    batch.

    The reference server runs one generator per granularity over the
    same flow queue, and the 1 m docs feed the downsampler chain
    (1m→1h→1d). Here the minute series is the rollup cascade's 1 m tier —
    a device-side fold of closed 1 s windows — so dual-granularity
    traffic costs one ingest per batch plus a tier step per advance.

    ingest() returns (flags, DocBatch) pairs: PER_SECOND_METRICS for 1 s
    windows, NONE for 1 m. Minute docs for minute M surface once every
    1 s window of M has closed. Minute ADMISSION equals the 1 s delay: a
    row too late for its second is too late for its minute. Tiers coarser than a minute accumulate in
    `coarse_tiers` as (interval, DocBatch), not in the (flags, DocBatch)
    stream, whose flags tell only second from minute."""

    def __init__(self, config: PipelineConfig = PipelineConfig(), *, app: bool = False,
                 cascade: CascadeConfig | None = None, device=None):
        cls = L7Pipeline if app else L4Pipeline
        if config.window.cascade is None:
            # the minute tier keeps the 1 s stash's capacity
            casc = cascade or CascadeConfig(intervals=(60,), capacity=config.window.capacity)
            config = dataclasses.replace(
                config, window=dataclasses.replace(config.window, cascade=casc))
        elif cascade is not None and cascade != config.window.cascade:
            raise ValueError(
                f"conflicting cascade configs: the window config carries "
                f"{config.window.cascade} but cascade={cascade} was also "
                "passed — silently preferring one would drop tiers"
            )
        if 60 not in config.window.cascade.intervals:
            raise ValueError(
                "DualGranularityPipeline needs a 1m cascade tier (its contract IS the "
                f"minute series); got intervals={config.window.cascade.intervals}"
            )
        self.pipe = cls(config, device=device)
        self.coarse_tiers: list[tuple[int, DocBatch]] = []

    @property
    def second(self) -> RollupPipeline:
        """Compat alias: consumers address the 1 s pipeline as `.second`."""
        return self.pipe

    def _tier_docs(self) -> list[tuple[DocumentFlag, DocBatch]]:
        out, coarse = [], []
        for interval, db in self.pipe.pop_tier_docbatches():
            if interval == 60:
                out.append((DocumentFlag.NONE, db))
            else:
                coarse.append((interval, db))
        # bounded drop-oldest, like every other held buffer
        hold_blocks(self.coarse_tiers, coarse, 512)
        return out

    def ingest(self, batch) -> list[tuple[DocumentFlag, DocBatch]]:
        out = [(self.pipe.flags, db) for db in self.pipe.ingest(batch)]
        return out + self._tier_docs()

    def drain(self) -> list[tuple[DocumentFlag, DocBatch]]:
        out = [(self.pipe.flags, db) for db in self.pipe.drain()]
        return out + self._tier_docs()

    @property
    def counters(self) -> dict:
        c = self.pipe.counters
        # the "minute" face: the cascade's lanes inside the one pipeline's
        # counters
        return {
            "second": c,
            "minute": {
                "cascade_rows": c.get("cascade_rows", 0),
                "cascade_shed": c.get("cascade_shed", 0),
                "tier_windows": c.get("cascade_tier_windows", 0),
            },
        }

    def telemetry(self) -> dict:
        t = self.pipe.telemetry()
        return {"second": t, "minute": {"counters": self.counters["minute"]}}


class DoubleIngestPipeline:
    """Dual granularity the old way: a full second ingest into a parallel
    minute pipeline. Kept only as the conformance oracle of
    `DualGranularityPipeline`, which gives the same (flags, DocBatch)
    stream from one ingest per batch. Its minute pipeline admits rows
    up to `MINUTE_DELAY` seconds late, the reference's default."""

    MINUTE_DELAY = 10

    def __init__(self, config: PipelineConfig = PipelineConfig(), *, app: bool = False,
                 device=None):
        cls = L7Pipeline if app else L4Pipeline
        self.second = cls(config, device=device)
        minute_window = dataclasses.replace(config.window, interval=60,
                                            delay=self.MINUTE_DELAY, cascade=None)
        self.minute = cls(dataclasses.replace(config, window=minute_window), device=device)

    def ingest(self, batch) -> list[tuple[DocumentFlag, DocBatch]]:
        out = [(self.second.flags, db) for db in self.second.ingest(batch)]
        out += [(self.minute.flags, db) for db in self.minute.ingest(batch)]
        return out

    def drain(self) -> list[tuple[DocumentFlag, DocBatch]]:
        out = [(self.second.flags, db) for db in self.second.drain()]
        out += [(self.minute.flags, db) for db in self.minute.drain()]
        return out

    @property
    def counters(self) -> dict:
        return {"second": self.second.counters, "minute": self.minute.counters}

    def telemetry(self) -> dict:
        return {"second": self.second.telemetry(), "minute": self.minute.telemetry()}
