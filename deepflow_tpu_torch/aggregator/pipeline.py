"""Flow-metrics rollup pipelines, L4 network + L7 application (port of
deepflow_tpu/aggregator/pipeline.py, sketch-free, cascade-free, full fold).

Per batch: optional batch-local pre-reduce → fanout → packed-word doc
fingerprint → late gate + counter block → accumulator ring append, as
one eager PyTorch step on the pipeline's device; `WindowManager` drives
the window protocol around it. The segmented reduces inside the
pre-reduce and the fold run the CUDA kernel of kernels/segreduce.cu on
the card.

Not ported yet: countable registration, profiling census, lineage,
sketch plane and cascade (DualGranularityPipeline), live snapshots.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..datamodel.batch import DocBatch, FlowBatch
from ..datamodel.code import DOC_KEY_PACK, RAW_TAG_PACK, DocumentFlag, pack_tag_words
from ..datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA, MeterSchema
from ..device import resolve_device
from ..ops.hashing import fingerprint64_words
from ..ops.segment import groupby_reduce
from ..ops.u32 import from_numpy_u32
from .fanout import FANOUT_LANES, FanoutConfig, fanout_l4, fanout_l7
from .stash import _append_impl, _fold_impl, sum_max_cols
from .window import FlushedWindow, WindowConfig, WindowManager, batch_counter_block

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


def upload_flow_batch(batch: FlowBatch, device) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """Host FlowBatch → (tag lanes dict, [N, M] f32 meters, [N] bool) on
    `device`; the tag columns travel as ONE packed u32 upload."""
    names = sorted(batch.tags)
    mat = from_numpy_u32(np.stack([np.asarray(batch.tags[k]) for k in names]), device)
    tags = {k: mat[i] for i, k in enumerate(names)}
    meters = torch.from_numpy(np.ascontiguousarray(batch.meters, np.float32)).to(device)
    valid = torch.from_numpy(np.asarray(batch.valid, bool)).to(device)
    return tags, meters, valid


def make_ingest_step(fanout_config: FanoutConfig, interval: int = 1, app: bool = False,
                     batch_unique_cap: int | None = None, *, device=None):
    """Build the device step pair: FlowBatch lanes → stash.

    Returns (append, fold):

      (stash, acc) = append(stash, acc, offset, tags, meters, valid)
      (stash, acc) = fold(stash, acc)

    `append` runs per batch: optional pre-reduce → fanout → fingerprint
    → one ring write at `offset` (a host int the caller advances).
    `fold` is the amortized sort+reduce over [S + A] rows. `tags` is a
    dict of [N] u32 lanes (or a FlowBatch's numpy columns, uploaded to
    `device`); stash/acc come from stash_init/accum_init on `device`.
    The ring is written in place. The reference's sketch plane and
    merge fold are not ported."""
    dev = resolve_device(device)
    fanout_fn = fanout_l7 if app else fanout_l4
    sum_cols, max_cols = sum_max_cols(APP_METER if app else FLOW_METER)

    def _lanes(tags, meters, valid):
        if isinstance(meters, np.ndarray):
            return upload_flow_batch(FlowBatch(tags=tags, meters=meters, valid=valid), dev)
        return tags, meters, valid

    def append(stash, acc, offset, tags, meters, valid):
        tags, meters, valid = _lanes(tags, meters, valid)
        if batch_unique_cap is not None:
            tags, meters, valid, dropped = batch_prereduce(
                tags, meters, valid, interval, batch_unique_cap, sum_cols, max_cols
            )
            stash = dataclasses.replace(
                stash, dropped_overflow=stash.dropped_overflow + dropped
            )
        doc_tags, doc_meters, ts, doc_valid = fanout_fn(tags, meters, valid, fanout_config)
        hi, lo = _doc_fingerprint(doc_tags)
        acc = _append_impl(acc, ts // interval, hi, lo, doc_tags, doc_meters,
                           doc_valid, offset)
        return stash, acc

    def fold(stash, acc):
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


@dataclasses.dataclass
class StagedBatch:
    """A bucket-padded batch already uploaded to the pipeline's device
    whose append step has not run yet."""

    tags: dict  # name → [B] u32 lane (device)
    meters: torch.Tensor  # [B, M] f32 (device)
    valid: torch.Tensor  # [B] bool (device)
    padded_rows: int  # B — the bucket this batch padded to


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

    def _step(self, acc, offset: int, start_window: int, stash_valid, stash_evict,
              feeder_shed: int, fold_rows, tags: dict, meters, valid):
        """One batch: [pre-reduce →] fanout → fingerprint → counter block
        → ring append. Returns (acc, counter block)."""
        interval = self.config.window.interval
        aux = None
        cap_u = self.config.batch_unique_cap
        if cap_u is not None:
            tags, meters, valid, aux = batch_prereduce(
                tags, meters, valid, interval, cap_u, self._sum_cols, self._max_cols
            )
        doc_tags, doc_meters, ts, doc_valid = self.fanout_fn(
            tags, meters, valid, self.config.fanout
        )
        hi, lo, excess = _doc_fingerprint(doc_tags, with_excess=True)
        gated, window, block = batch_counter_block(
            ts, doc_valid, start_window, interval, aux=aux,
            excess_hits=((excess != 0) & doc_valid).sum(),
            stash_valid=stash_valid, stash_evictions=stash_evict,
            ring_fill=offset, feeder_shed=feeder_shed, fold_rows=fold_rows,
        )
        acc = _append_impl(acc, window, hi, lo, doc_tags, doc_meters, gated, offset)
        return acc, block

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
        """Pad to the shape bucket and upload. None for an all-padding
        batch."""
        batch = batch.pad_to(self._pad_target(batch.size))
        if not np.any(batch.valid):
            return None
        tags, meters, valid = upload_flow_batch(batch, self.device)
        self.wm.bytes_uploaded += (
            4 * len(tags) * batch.size + meters.nbytes + valid.nbytes
        )
        return StagedBatch(tags=tags, meters=meters, valid=valid,
                           padded_rows=batch.size)

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

        def dispatch(acc, offset, start_window):
            st = self.wm.state
            return self._step(acc, offset, start_window, st.valid,
                              st.dropped_overflow, feeder_shed,
                              self.wm._fold_rows_dev, staged.tags,
                              staged.meters, staged.valid)

        return self._convert_flushed(
            self.wm.ingest_step(dispatch, rows, ring_rows=max_rows)
        )

    def drain(self) -> list[DocBatch]:
        return self._convert_flushed(self.wm.flush_all())

    def _convert_flushed(self, flushed: list[FlushedWindow]) -> list[DocBatch]:
        return [self._to_docbatch(f) for f in flushed if f.count]

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
        """Fetch-free counters (WindowManager.get_counters)."""
        return self.wm.get_counters()

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
