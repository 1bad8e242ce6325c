"""Sharded pipeline — batch-dim data parallelism + cross-shard sketch
merges (port of deepflow_tpu/parallel/sharded.py).

The scaling model, as in the reference:

  * The flow batch splits over the flattened (host, chip) mesh: shard d
    takes rows d·n … (d+1)·n of a [D·n] batch and runs the single-chip
    append → sketch plane → fold → flush functions of aggregator/ on
    its own device. Exact document stashes never merge across shards;
    the host concatenates each window's rows in shard order.
  * Sketch planes merge at window close: `window_close` takes the
    register max / counter sum over both mesh axes for the per-second
    view, and the max over `chip`, then over `host`, for the pod-wide
    1-minute HLL view (BASELINE config 5).

The reference runs each step as one `shard_map` over [D]-leading
arrays. Here the state is a LIST of per-shard `StashState` /
`AccumState` / `SketchState`, each on its mesh device, and each step
loops over the shards, launching the same kernels (kernels/segreduce.cu
in every pre-reduce, fold, merge fold and tier merge,
kernels/sketch_fused.cu in the slab sketch plane). The only
collectives are `_pmax` and `_psum`: each gathers a group's tensors onto
the group's first device, reduces, and hands the result back to every
shard — on one device a plain amax / sum over a stack.

`ShardedWindowManager` is the host-driven window protocol around it:
the late gate and the advance are decided on the host before the
dispatch, an advance drains every shard in ONE scalar fetch plus ONE
row fetch (the shards' outputs are concatenated on the first shard's
device first), and `snapshot_open` reads the open span in two. Every
fetch passes the `aggregator.window.host_fetch` seam (late-bound, so a
test can count it) behind the `chaos.SITE_FETCH` seam and the retry
policy; every dispatch behind `chaos.SITE_DISPATCH`.

Self-observability, as in the reference: the manager emits the
pipeline stage spans on its own tracer (`ingest.dispatch`,
`window.advance` — ONE span per advance, the sketch close before the
append and the fold after it measured together — `window.fold`,
`flush.drain`, `query.snapshot`; the sharded path has no counter block,
so no `stats.fetch`), registers its counters (`tpu_sharded_pipeline`)
and spans (`tpu_sharded_pipeline_spans`) on the default StatsCollector
and its planes on the device-memory ledger with `devices=D`, lists its
cascade tiers with the server's datasource registry, and reports
`telemetry()`: counters, span summary and the per-plane bytes with the
device count.

Not ported: lineage (`attach_lineage`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from .. import chaos
from ..aggregator import window as window_mod
from ..aggregator.cascade import (
    CascadeConfig,
    _ring_fold_impl,
    _tier_step_impl,
    merge_into_parent,
    tier_prefix,
    tier_ring_rows,
)
from ..aggregator.fanout import FANOUT_LANES, FanoutConfig
from ..aggregator.pipeline import make_ingest_step
from ..aggregator.sketchplane import (
    SENTINEL_WIN,
    PoolConfig,
    SketchConfig,
    SketchState,
    _flatten_open_snapshot,
    _pool_mode,
    hold_blocks,
    sketch_drain,
    sketch_init,
    sketch_plane_step,
    unpack_drained,
)
from ..aggregator.stash import (
    AccumState,
    StashState,
    _flush_range_impl,
    _fold_counted_impl,
    _merge_fold_impl,
    accum_init,
    check_fold_mode,
    plan_append,
    stash_init,
    stash_snapshot_range,
    sum_max_cols,
    unpack_flush_rows,
)
from ..aggregator.window import (
    FlushedWindow,
    OpenSnapshot,
    attach_open_sketch_blocks,
    sketch_inputs_from_columns,
)
from ..datamodel.batch import DocBatch
from ..datamodel.schema import FLOW_METER, TAG_SCHEMA
from ..ops.histogram import LogHistSpec
from ..ops.segment import SENTINEL_SLOT
from ..ops.u32 import U32_MAX, from_numpy_u32, to_i32_bits
from ..utils.retry import RetryPolicy, decorrelated_rng, is_dispatch_transient, retry_call
from ..utils.spans import (
    SPAN_FLUSH_DRAIN,
    SPAN_INGEST_DISPATCH,
    SPAN_QUERY_SNAPSHOT,
    SPAN_WINDOW_ADVANCE,
    SPAN_WINDOW_FOLD,
    SpanTracer,
)
from ..utils.stats import register_countable
from .mesh import MESH_AXES

# the per-window plane is the single-chip SketchState, one per shard
SketchPlanes = SketchState

AXIS_HOST, AXIS_CHIP = MESH_AXES


@dataclasses.dataclass
class MergedSketchView:
    """Cross-mesh merged view of the open ring (window_close output): one
    tensor per shard, each on its shard's device, all equal."""

    hll: list  # [G, m] int32 per shard
    cms: list  # [depth, width] int32 per shard
    hist: list  # [G, B] int32 per shard


def _on(dev: torch.device):
    """Make `dev` the current CUDA device while a shard's kernels launch
    (the wrappers launch on the current device's stream)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _groups(mesh, axes) -> list[list[int]]:
    """Flat shard indices of each reduction group over `axes` (one axis
    name or a tuple of them): shards that differ only along `axes`."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = tuple(mesh.axis_names)
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    keep = [i for i, a in enumerate(names) if a not in axes]
    red = [i for i, a in enumerate(names) if a in axes]
    n_keep = int(np.prod([idx.shape[i] for i in keep], dtype=np.int64))
    return idx.transpose(keep + red).reshape(n_keep, -1).tolist()


def _reduce(xs: list, mesh, axes, op) -> list:
    devs = mesh.flat()
    out = [None] * len(xs)
    for members in _groups(mesh, axes):
        root = devs[members[0]]
        r = op(torch.stack([xs[i].to(root) for i in members]))
        for i in members:
            out[i] = r.to(devs[i])
    return out


def _pmax(xs: list, mesh, axes) -> list:
    """Elementwise max over mesh `axes` of the per-shard tensors `xs`:
    every shard gets its group's result."""
    return _reduce(xs, mesh, axes, lambda s: s.amax(0))


def _psum(xs: list, mesh, axes) -> list:
    """Elementwise sum (in the tensors' own dtype) over mesh `axes`."""
    return _reduce(xs, mesh, axes, lambda s: s.sum(0, dtype=s.dtype))


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    fanout: FanoutConfig = FanoutConfig()
    interval: int = 1
    capacity_per_device: int = 1 << 12
    num_services: int = 256
    hll_precision: int = 10
    cms_depth: int = 4
    cms_width: int = 1 << 14
    hist: LogHistSpec = LogHistSpec(bins=512, vmin=1.0, gamma=1.04)
    # per-window sketch ring: must cover delay//interval + 2 of the
    # window manager driving this pipeline (checked there)
    sketch_ring: int = 8
    topk_rows: int = 2
    topk_cols: int = 1 << 9
    sketch_pending: int = 16
    # pooled sketch memory per shard (SketchConfig.pool)
    sketch_pool: PoolConfig | None = None
    # batches accumulated per shard between folds
    accum_batches: int = 8
    # per-shard batch-local pre-reduce before the fanout; None = off
    batch_unique_cap: int | None = None
    # "full" re-sorts each shard's stash + ring, "merge" rank-merges
    fold_mode: str = "full"
    # rollup cascade intervals, kept per shard; () = off
    cascade: tuple[int, ...] = ()
    cascade_capacity: int = 1 << 12

    def __post_init__(self):
        check_fold_mode(self.fold_mode)
        if self.cascade:
            CascadeConfig(intervals=self.cascade,
                          capacity=self.cascade_capacity).validate_base(self.interval)

    def sketch_config(self) -> SketchConfig:
        return SketchConfig(
            num_groups=self.num_services, hll_precision=self.hll_precision,
            cms_depth=self.cms_depth, cms_width=self.cms_width, hist=self.hist,
            topk_rows=self.topk_rows, topk_cols=self.topk_cols,
            pending=self.sketch_pending, pool=self.sketch_pool,
        )


class ShardedPipeline:
    """Per-shard ingest steps + the cross-shard window-close merges.

    `mesh` is a `parallel.mesh.Mesh`, or a `parallel.topology.MeshTopology`
    whose group `shard_group` this pipeline serves (its meta then rides
    the sharded checkpoint). Every per-shard method takes and returns
    lists indexed by shard, each element on its shard's device."""

    def __init__(self, mesh, config: ShardedConfig = ShardedConfig(), *,
                 shard_group: int = 0):
        from .topology import MeshTopology

        self.topology: MeshTopology | None = None
        if isinstance(mesh, MeshTopology):
            self.topology = mesh
            mesh = mesh.group_mesh(shard_group)
        self.shard_group = shard_group
        self.mesh = mesh
        self.config = config
        self.n_devices = mesh.size
        self.axes = tuple(mesh.axis_names)
        self.devices = mesh.flat()
        self._tag_names: tuple | None = None  # fixed on the first step()
        self._append, _ = make_ingest_step(config.fanout, config.interval,
                                           batch_unique_cap=config.batch_unique_cap,
                                           device=self.devices[0])
        self._sum_cols, self._max_cols = sum_max_cols(FLOW_METER)

    # -- state ----------------------------------------------------------
    def init_state(self) -> tuple[list[StashState], list[SketchState]]:
        c = self.config
        stash = [stash_init(c.capacity_per_device, TAG_SCHEMA, FLOW_METER, device=d)
                 for d in self.devices]
        sketches = [sketch_init(c.sketch_config(), c.sketch_ring, device=d)
                    for d in self.devices]
        return stash, sketches

    def init_acc(self, doc_rows_per_device: int) -> list[AccumState]:
        """Per-shard accumulator ring of accum_batches × one batch's
        fanout rows."""
        cap = self.config.accum_batches * doc_rows_per_device
        return [accum_init(cap, TAG_SCHEMA, FLOW_METER, device=d) for d in self.devices]

    # -- step -----------------------------------------------------------
    def shard_inputs(self, tags, meters, valid) -> list[tuple]:
        """Host flow columns [D·n] → per-shard device lanes: shard d takes
        rows d·n … (d+1)·n (the reference's contiguous reshape), its tags
        as ONE packed [T, n] u32 upload in sorted tag-name order."""
        d = self.n_devices
        if self._tag_names is None:
            self._tag_names = tuple(sorted(tags))
        mat = np.stack([np.asarray(tags[k], dtype=np.uint32) for k in self._tag_names])
        total = mat.shape[1]
        if total % d:
            raise ValueError(f"batch of {total} rows does not split over {d} devices")
        n = total // d
        meters = np.asarray(meters, np.float32)
        valid = np.asarray(valid, bool)
        out = []
        for i, dev in enumerate(self.devices):
            rows = slice(i * n, (i + 1) * n)
            lanes = from_numpy_u32(mat[:, rows], dev)
            out.append((
                {k: lanes[j] for j, k in enumerate(self._tag_names)},
                # decoded wire frames hand over read-only buffers: copy those
                torch.from_numpy(np.require(meters[rows], np.float32, ["C", "W"])).to(dev),
                torch.from_numpy(np.require(valid[rows], bool, ["C", "W"])).to(dev),
            ))
        return out

    def step(self, stash, acc, offset, sketches, tags, meters, valid,
             start_window: int = 0, close_below: int = 0):
        """One batch: tags {field: [D·n]} u32, meters [D·n, M], valid
        [D·n] (host arrays). Each shard appends its rows at the host-
        tracked `offset` and folds its raw flow rows into its sketch
        plane between the replicated span bounds: `start_window` (the
        host's gate) and `close_below` (on an advancing batch the new
        span start, which closes every older slot in this step; 0 = close
        nothing). Returns (stash, acc, sketches); rings and planes are
        written in place."""
        c = self.config
        out_s, out_a, out_k = [], [], []
        for d, (tags1, meters1, valid1) in enumerate(self.shard_inputs(tags, meters, valid)):
            with _on(self.devices[d]):
                st, ac = self._append(stash[d], acc[d], offset, tags1, meters1, valid1)
                sk = sketches[d]
                inp = sketch_inputs_from_columns(tags1, meters1, sk.hll.shape[1],
                                                 FLOW_METER.index)
                sk = sketch_plane_step(sk, c.hist, window=tags1["timestamp"] // c.interval,
                                       valid=valid1, base_w=start_window,
                                       close_w=close_below, **inp)
            out_s.append(st)
            out_a.append(ac)
            out_k.append(sk)
        return out_s, out_a, out_k

    def fold(self, stash, acc, hi_window=None):
        """Fold each shard's ring into its stash. Returns (stash, acc,
        fold_rows) with fold_rows one 0-dim device count per shard.
        `hi_window` (fold_mode="merge" only) folds only ring rows with
        slot < hi_window; the rest stay — callers keep their fill cursor."""
        if hi_window is not None and self.config.fold_mode != "merge":
            raise ValueError("span-bounded fold requires fold_mode='merge'")
        hi = SENTINEL_SLOT if hi_window is None else int(hi_window)
        merge = self.config.fold_mode == "merge"
        out = []
        for d, dev in enumerate(self.devices):
            with _on(dev):
                if merge:
                    out.append(_merge_fold_impl(stash[d], acc[d], hi, self._sum_cols,
                                                self._max_cols))
                else:
                    # full mode ignores the span bound (never span-folded)
                    out.append(_fold_counted_impl(stash[d], acc[d], self._sum_cols,
                                                  self._max_cols))
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    # -- window close ---------------------------------------------------
    def window_close(self, sketches):
        """Merge the open sketch ring across the mesh: returns (sketches,
        MergedSketchView, pod_1m). Each shard first folds its ring (HLL
        max, count-min and histogram sums over the slot axis); the view
        is the max / sum over both axes, `pod_1m` the HLL max over
        `chip`, then over `host` — every shard gets the same values. The
        planes are not reset (per-window slots close in-step)."""
        hll_l = [sk.hll.amax(0) for sk in sketches]
        cms_l = [sk.cms.sum(0, dtype=torch.int32) for sk in sketches]
        hist_l = [sk.hist.sum(0, dtype=torch.int32) for sk in sketches]
        view = MergedSketchView(hll=_pmax(hll_l, self.mesh, self.axes),
                                cms=_psum(cms_l, self.mesh, self.axes),
                                hist=_psum(hist_l, self.mesh, self.axes))
        pod_1m = _pmax(_pmax(hll_l, self.mesh, AXIS_CHIP), self.mesh, AXIS_HOST)
        return sketches, view, pod_1m

    def sketch_drain(self, sketches, close_below):
        """Close every sketch slot below `close_below` on every shard and
        hand out the pending blocks: per-shard lists (sketches, pend,
        pend_win, pend_n, wide_rows, wide_wins) as `sketchplane.
        sketch_drain` returns them (the wide lists hold None in slab
        mode)."""
        outs = []
        for d, dev in enumerate(self.devices):
            with _on(dev):
                outs.append(sketch_drain(sketches[d], close_below))
        return tuple([o[i] for o in outs] for i in range(6))

    # -- live read plane -------------------------------------------------
    def snapshot_open_ranges(self, stash, sketches, lo_window):
        """Read-only per-shard snapshot of the open span: (packed [S,
        3+T+M] int32 bits, totals 0-dim int64, open-slot block rows,
        their window ids) per shard; nothing is written."""
        out = ([], [], [], [])
        for d, dev in enumerate(self.devices):
            with _on(dev):
                packed, total = stash_snapshot_range(stash[d], lo_window, U32_MAX)
                for lst, x in zip(out, (packed, total, _flatten_open_snapshot(sketches[d]),
                                        sketches[d].win)):
                    lst.append(x)
        return out

    # -- doc flush ------------------------------------------------------
    def flush_window(self, stash, window_idx):
        """Flush one closed window from every shard: the one-window
        `flush_range` (the reference's per-window oracle shape is not
        ported). Merge mode refuses it, as the reference does."""
        if self.config.fold_mode == "merge":
            raise ValueError(
                "flush_window (per-window oracle) breaks the canonical stash layout "
                "fold_mode='merge' requires; use flush_range"
            )
        return self.flush_range(stash, int(window_idx), int(window_idx) + 1)

    def flush_range(self, stash, lo_window, hi_window):
        """Flush every window in [lo, hi) from every shard's stash: per-
        shard lists (stash, packed [S, 3+T+M] int32 bits, totals 0-dim).
        Merge mode flushes through the compacting flush (canonical
        layout)."""
        compact = self.config.fold_mode == "merge"
        out = []
        for d, dev in enumerate(self.devices):
            with _on(dev):
                out.append(_flush_range_impl(stash[d], int(lo_window), int(hi_window),
                                             compact=compact))
        return [o[0] for o in out], [o[1] for o in out], [o[2] for o in out]

    # -- rollup cascade --------------------------------------------------
    def init_tier_state(self) -> tuple[list[list[StashState]], list[torch.Tensor]]:
        """Per-tier lists of per-shard tier stashes, and each shard's
        [rows, shed] cascade counter lanes."""
        c = self.config
        tiers = [[stash_init(c.cascade_capacity, TAG_SCHEMA, FLOW_METER, device=d)
                  for d in self.devices] for _ in c.cascade]
        lanes = [torch.zeros((2,), dtype=torch.int64, device=d) for d in self.devices]
        return tiers, lanes

    def init_tier_acc(self, child_rows: int):
        """Per-shard tier accumulator rings of `child_rows` rows and their
        0-dim device fill cursors."""
        return ([accum_init(child_rows, TAG_SCHEMA, FLOW_METER, device=d)
                 for d in self.devices],
                [torch.zeros((), dtype=torch.int64, device=d) for d in self.devices])

    def tier_step_fn(self, ratio: int):
        """The cascade tier step for one child→parent ratio, per shard:
        fn(tiers, accs, fills, lanes, packed, totals, hi) → (tiers, accs,
        fills, lanes) — the single-chip `_tier_step_impl` on each shard
        (tiers never merge across shards)."""
        nt = TAG_SCHEMA.num_fields

        def fn(tiers, accs, fills, lanes, packed, totals, hi):
            out = []
            for d, dev in enumerate(self.devices):
                with _on(dev):
                    out.append(_tier_step_impl(
                        tiers[d], accs[d], fills[d], lanes[d], packed[d], totals[d], int(hi),
                        ratio=ratio, num_tags=nt, sum_cols=self._sum_cols,
                        max_cols=self._max_cols, prefix=tier_prefix(packed[d].shape[0])))
            return tuple([o[i] for o in out] for i in range(4))

        return fn

    def tier_ring_fold_fn(self):
        """fn(tiers, accs, lanes) → (tiers, accs, lanes): each shard's tier
        ring merged into its tier stash (before every tier flush and at
        checkpoint)."""

        def fn(tiers, accs, lanes):
            out = []
            for d, dev in enumerate(self.devices):
                with _on(dev):
                    out.append(_ring_fold_impl(tiers[d], accs[d], lanes[d], self._sum_cols,
                                               self._max_cols))
            return tuple([o[i] for o in out] for i in range(3))

        return fn

    def tier_flush_range_fn(self):
        """fn(tiers, lo, hi) → (tiers, packed, totals): the tier stashes'
        flush, always compacting (the ring fold rank-merges against the
        canonical layout)."""

        def fn(tiers, lo, hi):
            out = []
            for d, dev in enumerate(self.devices):
                with _on(dev):
                    out.append(_flush_range_impl(tiers[d], int(lo), int(hi), compact=True))
            return tuple([o[i] for o in out] for i in range(3))

        return fn


class ShardedWindowManager:
    """Host-driven window controller for the mesh path — the sharded twin
    of aggregator/window.WindowManager (the same open-span / late-drop /
    flush protocol), emitting DocBatches from the per-shard stashes at
    every window close."""

    def __init__(self, pipe: ShardedPipeline, delay: int = 2, *,
                 min_snapshot_interval: float = 0.25):
        self.pipe = pipe
        self.interval = pipe.config.interval
        self.delay = delay
        self.min_snapshot_interval = min_snapshot_interval
        self._sk_cfg = pipe.config.sketch_config()
        ring_needed = delay // pipe.config.interval + 2
        if pipe.config.sketch_ring < ring_needed:
            raise ValueError(
                f"sketch_ring={pipe.config.sketch_ring} cannot hold the {ring_needed} "
                f"simultaneously-open windows of delay={delay}/interval="
                f"{pipe.config.interval} — per-window sketch slots would alias"
            )
        self.stash, self.sketches = pipe.init_state()
        self.acc: list | None = None  # per-shard rings, sized on the first batch
        self.fill = 0  # host-tracked rows per shard ring
        self.start_window: int | None = None
        self.drop_before_window = 0
        self.total_docs_in = 0
        self.total_flushed = 0
        self.n_advances = 0
        # the last fold's row counts (device, per shard); the host mirror
        # rides the advance drain's scalar fetch
        self.fold_rows = 0
        self._fold_rows_dev: list | None = None
        # merged sketch views of the last advance (None until one)
        self.global_view: MergedSketchView | None = None
        self.pod_1m: list | None = None
        # closed blocks merged across shards, window order; bounded
        self.closed_sketches: list = []
        self.max_held_sketches = 512
        self.sketch_blocks_closed = 0
        self.sketch_blocks_dropped = 0
        # pooled sketch memory, summed over shards at advance drains
        self.sketch_pool_spill = 0
        self.sketch_promotions = 0
        self.sketch_pool_occ = 0
        # rollup cascade: per-tier lists of per-shard state, host
        # watermarks, parent sketch merges and held tier windows
        self._cascade_intervals = tuple(pipe.config.cascade)
        self.tier_stashes: list = []
        self.tier_accs: list = []
        self.tier_fills: list = []
        self.tier_watermarks: list[int] = []
        self._tier_ratios: list[int] = []
        self.cascade_lanes: list | None = None
        self.cascade_rows = 0
        self.cascade_shed = 0
        self._tier_pending_blocks: list[dict] = []
        self.tier_flushed: list = []  # [(interval_s, DocBatch)]
        self.max_held_tier_windows = 4096
        self.tier_windows_dropped = 0
        self.tier_windows_flushed = 0
        self.closed_tier_sketches: list = []
        self.tier_sketch_blocks_dropped = 0
        if self._cascade_intervals:
            res = (self.interval,) + self._cascade_intervals
            self._tier_ratios = [res[i + 1] // res[i]
                                 for i in range(len(self._cascade_intervals))]
            self.tier_stashes, self.cascade_lanes = pipe.init_tier_state()
            self.tier_accs = [None] * len(self._cascade_intervals)
            self.tier_fills = [None] * len(self._cascade_intervals)
            self.tier_watermarks = [0] * len(self._cascade_intervals)
            self._tier_pending_blocks = [{} for _ in self._cascade_intervals]
            from ..server.datasource import register_cascade_tiers

            register_cascade_tiers("flow", self._cascade_intervals, owner=self)
        self.host_fetches = 0
        self.bytes_fetched = 0
        self.bytes_uploaded = 0
        # live read plane (host ints are the only accounting: the sharded
        # path has no counter block)
        self.snapshot_reads = 0
        self.snapshot_bytes = 0
        self.snapshot_seq = 0
        self._snapshot_cache: OpenSnapshot | None = None
        # transient-failure policy for dispatches and fetches
        self.retry_policy = RetryPolicy()
        self._retry_rng = decorrelated_rng(0x5A4DED)
        self.dispatch_retries = 0
        self.fetch_retries = 0
        self.tracer = SpanTracer(service="deepflow_tpu.sharded_pipeline")
        # multi-host placement labels: with a MeshTopology, rows carry the
        # shard group + process so a fleet dashboard can tell hosts apart
        topo_tags = {}
        if pipe.topology is not None:
            topo_tags = {"group": str(pipe.shard_group),
                         "process": str(pipe.topology.process_index)}
        self._stats_srcs = [
            register_countable("tpu_sharded_pipeline", self, devices=str(pipe.n_devices),
                               **topo_tags),
            register_countable("tpu_sharded_pipeline_spans", self.tracer,
                               devices=str(pipe.n_devices), **topo_tags),
        ]
        # weakly on the ledger with the device count, so its rows carry
        # bytes per device next to the totals
        from ..profiling.ledger import register_profilable

        self._ledger_src = register_profilable(
            "sharded_window_manager", self, devices=pipe.n_devices,
            interval=f"{self.interval}s", cascade=str(bool(self._cascade_intervals)))

    # WindowManager's fetch: `window.host_fetch` (looked up at each call,
    # so a test can count it) behind the SITE_FETCH seam, retried on
    # transient faults, with the same count and byte accounting
    _fetch = window_mod.WindowManager._fetch

    def _gather(self, xs) -> torch.Tensor:
        """Per-shard tensors flattened and concatenated in shard order on
        the first shard's device — one fetch then covers the mesh."""
        dev0 = self.pipe.devices[0]
        return torch.cat([x.reshape(-1).to(dev0) for x in xs])

    def get_counters(self) -> dict:
        """Host ints only (fetch-free). `flow_in` counts pre-fanout flow
        rows — the single-chip `doc_in` counts docs."""
        return {
            "flow_in": self.total_docs_in,
            "flushed_doc": self.total_flushed,
            "drop_before_window": self.drop_before_window,
            "acc_fill": self.fill,
            "window_advances": self.n_advances,
            # rows the last DRAINED fold touched, summed over shards
            "fold_rows": self.fold_rows,
            "host_fetches": self.host_fetches,
            "bytes_fetched": self.bytes_fetched,
            "bytes_uploaded": self.bytes_uploaded,
            "dispatch_retries": self.dispatch_retries,
            "fetch_retries": self.fetch_retries,
            "sketch_blocks_closed": self.sketch_blocks_closed,
            "sketch_blocks_held": len(self.closed_sketches),
            "sketch_blocks_dropped": self.sketch_blocks_dropped,
            "sketch_pool_spill": self.sketch_pool_spill,
            "sketch_promotions": self.sketch_promotions,
            "sketch_pool_occ": self.sketch_pool_occ,
            "cascade_rows": self.cascade_rows,
            "cascade_shed": self.cascade_shed,
            "cascade_tier_windows": self.tier_windows_flushed,
            "tier_windows_held": len(self.tier_flushed),
            "tier_windows_dropped": self.tier_windows_dropped,
            "snapshot_reads": self.snapshot_reads,
            "snapshot_bytes": self.snapshot_bytes,
        }

    def pop_closed_sketches(self) -> list:
        """Drain the closed WindowSketchBlocks merged across shards
        (window order)."""
        out, self.closed_sketches = self.closed_sketches, []
        return out

    def device_planes(self) -> dict:
        """Every per-shard device plane this manager owns, by name."""
        planes: dict[str, object] = {
            "stash": self.stash,
            "accumulator": self.acc,  # None until the first batch
            "lanes": [self._fold_rows_dev],
        }
        if _pool_mode(self.sketches[0]):
            planes["sketch_pool_hot"] = [
                [sk.p_hll, sk.p_cms, sk.p_hist, sk.p_tkv, sk.p_tkh, sk.p_tkl, sk.p_tia,
                 sk.p_tib] for sk in self.sketches]
            planes["sketch_pool_wide"] = [
                [sk.hll, sk.cms, sk.hist, sk.tk_votes, sk.tk_hi, sk.tk_lo, sk.tk_ida,
                 sk.tk_idb] for sk in self.sketches]
            planes["sketch_pending"] = [[sk.pend, sk.pend_win] for sk in self.sketches]
            planes["sketch_meta"] = [
                [sk.win, sk.count, sk.slot_of, sk.wide_close, sk.wide_count, sk.rows,
                 sk.shed, sk.pend_n, sk.pool_spill, sk.pool_promos, sk.promote_fill]
                for sk in self.sketches]
        else:
            planes["sketch"] = self.sketches
        if self._tier_ratios:
            planes["cascade"] = [self.tier_stashes, self.tier_accs, self.tier_fills,
                                 self.cascade_lanes]
        return planes

    def telemetry(self) -> dict:
        """JSON-able counters + span summary + the per-plane device bytes
        with the device count."""
        from ..profiling.ledger import plane_bytes

        seen: set = set()
        return {
            "counters": self.get_counters(),
            "spans": self.tracer.summary(),
            "profile": {
                "hbm_bytes": {name: plane_bytes(tree, seen)[0]
                              for name, tree in sorted(self.device_planes().items())},
                "devices": self.pipe.n_devices,
            },
        }

    def close(self) -> None:
        """Eager teardown: the manager leaves the ledger, its Countable
        rows stop, and every device plane is dropped so its memory
        returns to the allocator. The manager is unusable afterwards."""
        from ..profiling.ledger import default_ledger
        from ..utils.stats import default_collector

        default_ledger.deregister(self._ledger_src)
        for src in self._stats_srcs:
            default_collector.deregister(src)
        self.stash = self.sketches = self.acc = self._fold_rows_dev = None
        self.tier_stashes, self.tier_accs, self.tier_fills = [], [], []
        self.cascade_lanes = self.global_view = self.pod_1m = None
        self._snapshot_cache = None

    def _fold(self):
        """Full-set fold (kernel per fold_mode): the rings empty and the
        fill cursor resets."""
        if self.fill == 0 or self.acc is None:
            return
        with self.tracer.span(SPAN_WINDOW_FOLD):
            self.stash, self.acc, self._fold_rows_dev = self.pipe.fold(self.stash, self.acc)
        self.fill = 0

    def _fold_span(self, hi_window: int):
        """Span-bounded advance fold (fold_mode="merge"): only ring rows
        with slot < hi_window; `fill` stays (consumed rows turn sentinel
        in place, the next full fold reclaims the ring)."""
        if self.fill == 0 or self.acc is None:
            return
        with self.tracer.span(SPAN_WINDOW_FOLD):
            self.stash, self.acc, self._fold_rows_dev = self.pipe.fold(
                self.stash, self.acc, hi_window=hi_window)

    def _cascade_advance(self, packed, totals, hi: int) -> list:
        """Fold this drain's packed flush rows into each shard's tier
        stashes and flush every tier window that closed (device work
        only; outputs ride the drain's two transfers). Each entry: (tier
        idx, interval, packed list, totals list, lo_t, hi_t).

        The twin of TierCascade.on_advance over per-shard state: lazy
        ring sizing with a pre-growth fold, the tier step, the early break
        when nothing closes, the ring fold before every tier flush, and
        tier chaining."""
        p = self.pipe
        tier_flushes = []
        src, src_total, src_hi = packed, totals, int(hi)
        for i, ratio in enumerate(self._tier_ratios):
            ring_rows = tier_ring_rows(src[0].shape[0])
            if self.tier_accs[i] is None or self.tier_accs[i][0].capacity < ring_rows:
                if self.tier_accs[i] is not None:
                    # fold pending rows before replacing the ring
                    self.tier_stashes[i], _, self.cascade_lanes = p.tier_ring_fold_fn()(
                        self.tier_stashes[i], self.tier_accs[i], self.cascade_lanes)
                self.tier_accs[i], self.tier_fills[i] = p.init_tier_acc(ring_rows)
            (self.tier_stashes[i], self.tier_accs[i], self.tier_fills[i],
             self.cascade_lanes) = p.tier_step_fn(ratio)(
                self.tier_stashes[i], self.tier_accs[i], self.tier_fills[i],
                self.cascade_lanes, src, src_total, src_hi)
            hi_t = src_hi // ratio
            if hi_t <= self.tier_watermarks[i]:
                break  # nothing closed here → nothing deeper either
            self._settle_tier_ring(i)  # flushed parents see every child row
            lo_t = self.tier_watermarks[i]
            self.tier_stashes[i], t_packed, t_totals = p.tier_flush_range_fn()(
                self.tier_stashes[i], lo_t, hi_t)
            tier_flushes.append((i, self._cascade_intervals[i], t_packed, t_totals, lo_t, hi_t))
            self.tier_watermarks[i] = hi_t
            src, src_total, src_hi = t_packed, t_totals, hi_t
        return tier_flushes

    def _drain_range(self, lo: int, hi: int) -> list:
        """Flush [lo, hi) from every shard and regroup the rows into per-
        window DocBatches; closed sketch blocks, pool wide slots and tier
        rows drain in the same transfers and merge across shards by
        window. The host pays ONE scalar fetch ([totals, fold rows,
        pending blocks, (closed wide slots), (cascade lanes), tier totals…,
        (pool lanes)], D lanes each) + ONE concatenated block fetch,
        whatever D is and however many windows closed."""
        p = self.pipe
        d = p.n_devices
        self.stash, packed, totals = p.flush_range(self.stash, lo, hi)
        # forced close at `hi`: every shard closes the same windows, even
        # one whose rows never reached the advancing timestamp
        (self.sketches, pend, pend_win, pend_n,
         wide_rows, wide_wins) = p.sketch_drain(self.sketches, hi)
        has_wide = wide_rows[0] is not None and wide_rows[0].shape[0] > 0
        tier_flushes = self._cascade_advance(packed, totals, hi) if self._tier_ratios else []
        fr = self._fold_rows_dev
        if fr is None:
            fr = [torch.zeros((), dtype=torch.int64, device=dv) for dv in p.devices]
        scal = [self._gather(totals), self._gather(fr), self._gather(pend_n)]
        if has_wide:
            scal.append(self._gather([(w != SENTINEL_WIN).sum() for w in wide_wins]))
        if self._tier_ratios:
            scal.append(self._gather(self.cascade_lanes))
        scal += [self._gather(tf[3]) for tf in tier_flushes]
        pool_on = _pool_mode(self.sketches[0])
        if pool_on:
            sks = self.sketches
            scal += [self._gather([sk.pool_spill for sk in sks]),
                     self._gather([sk.pool_promos for sk in sks]),
                     self._gather([(sk.slot_of != -1).sum() + (sk.wide_close != SENTINEL_WIN).sum()
                                   for sk in sks])]
        bundled = self._fetch(to_i32_bits(torch.cat(scal)))
        if pool_on:
            self.sketch_pool_spill = int(bundled[-3 * d:-2 * d].sum())
            self.sketch_promotions = int(bundled[-2 * d:-d].sum())
            self.sketch_pool_occ = int(bundled[-d:].sum())
        totals_np = bundled[:d]
        self.fold_rows = int(bundled[d:2 * d].sum())
        pend_np = bundled[2 * d:3 * d]
        o = 3 * d
        n_wide = 0
        if has_wide:
            n_wide = int(bundled[o:o + d].sum())
            o += d
        if self._tier_ratios:
            lanes_np = bundled[o:o + 2 * d].reshape(d, 2)
            self.cascade_rows = int(lanes_np[:, 0].sum())
            self.cascade_shed = int(lanes_np[:, 1].sum())
            o += 2 * d
        tier_totals_np = [bundled[o + j * d:o + (j + 1) * d] for j in range(len(tier_flushes))]
        max_t = int(totals_np.max())
        max_p = int(pend_np.max())
        tier_max = [int(t.max()) for t in tier_totals_np]
        if max_t == 0 and max_p == 0 and n_wide == 0 and not tier_flushes:
            # nothing flushed and no tier closed; with a tier flush the
            # drain goes on even when every count is zero — a sketch-only
            # tier window must release its parent block now
            return []
        row_cols = packed[0].shape[1]
        wide = pend[0].shape[1]
        if max_t == 0 and max_p == 0 and n_wide == 0 and not any(tier_max):
            flat = np.zeros((0,), np.uint32)  # nothing to transfer
        else:
            parts = [self._gather([x[:max_t] for x in packed]),
                     self._gather([x[:max_p] for x in pend]),
                     self._gather([to_i32_bits(x[:max_p]) for x in pend_win])]
            if n_wide:
                # the whole (small) arena: the host filters SENTINEL wins
                parts += [self._gather(wide_rows),
                          self._gather([to_i32_bits(w) for w in wide_wins])]
            for (_, _, t_packed, _, _, _), tm in zip(tier_flushes, tier_max):
                parts.append(self._gather([x[:tm] for x in t_packed]))
            flat = self._fetch(torch.cat(parts)).view(np.uint32)
        nb = d * max_t * row_cols
        npend = d * max_p * wide
        block = flat[:nb].reshape(d, max_t, row_cols)
        pend_rows = flat[nb:nb + npend].reshape(d, max_p, wide)
        pend_wins = flat[nb + npend:nb + npend + d * max_p].reshape(d, max_p)
        to = nb + npend + d * max_p
        w_rows = w_wins = None
        if n_wide:
            pw, wide_w = wide_rows[0].shape
            w_rows = flat[to:to + d * pw * wide_w].reshape(d, pw, wide_w)
            to += d * pw * wide_w
            w_wins = flat[to:to + d * pw].reshape(d, pw)
            to += d * pw
        tier_blocks = []
        for tm in tier_max:
            tier_blocks.append(flat[to:to + d * tm * row_cols].reshape(d, tm, row_cols))
            to += d * tm * row_cols
        merged: dict[int, object] = {}

        def merge_in(rows, wins):
            for blk in unpack_drained(rows, wins, self._sk_cfg):
                have = merged.get(blk.window)
                merged[blk.window] = blk if have is None else have.merge(blk)

        for dev in range(d):
            n = int(pend_np[dev])
            merge_in(pend_rows[dev, :n], pend_wins[dev, :n])
        if n_wide:
            # a window promoted on one shard and compact on another
            # unifies here
            for dev in range(d):
                keep = w_wins[dev] != np.uint32(SENTINEL_WIN)
                merge_in(w_rows[dev][keep], w_wins[dev][keep])
        ordered = [merged[w] for w in sorted(merged)]
        self.sketch_blocks_closed += len(ordered)
        self.sketch_blocks_dropped += hold_blocks(self.closed_sketches, ordered,
                                                  self.max_held_sketches)
        if self._tier_ratios:
            # closed child blocks feed the parent merges BEFORE the tier
            # windows are built, so a parent closing now sees every child
            for blk in ordered:
                self._feed_tier_block(0, blk.window, blk)
            self._take_tier_windows(tier_flushes, tier_totals_np, tier_blocks)
        if max_t == 0:
            return []
        per_dev = [unpack_flush_rows(block[i, :int(t)], TAG_SCHEMA.num_fields)
                   for i, t in enumerate(totals_np)]
        flushed = self._group_rows_by_window(per_dev, self.interval)
        for db in flushed:
            self.total_flushed += db.size
        return flushed

    def _group_rows_by_window(self, per_dev, interval: int) -> list:
        """Shard-major regroup of unpacked flush rows into per-window
        DocBatches (tier 0 and the cascade tiers alike)."""
        flushed = []
        for w in sorted({int(w) for win, *_ in per_dev for w in np.unique(win)}):
            tags_out = np.concatenate([tags[win == w] for win, _, _, tags, _ in per_dev])
            n = tags_out.shape[0]
            flushed.append(DocBatch(
                tags=tags_out,
                meters=np.concatenate([met[win == w] for win, _, _, _, met in per_dev]),
                timestamp=np.full((n,), w * interval, dtype=np.uint32),
                valid=np.ones((n,), dtype=bool), tag_schema=TAG_SCHEMA,
                meter_schema=FLOW_METER,
            ))
        return flushed

    def _feed_tier_block(self, tier: int, window: int, blk) -> None:
        """Merge one closed child block into its parent's pending merge."""
        if tier >= len(self._tier_ratios):
            return
        merge_into_parent(self._tier_pending_blocks[tier], window, self._tier_ratios[tier], blk)

    def _take_tier_windows(self, tier_flushes, tier_totals_np, tier_blocks) -> None:
        """Fetched tier rows → per-window tier DocBatches (merged across
        shards, window order) + the parents' merged sketch blocks; closed
        tier blocks cascade one level up."""
        for (i, interval, _p, _t, lo_t, hi_t), t_np, rows in zip(
                tier_flushes, tier_totals_np, tier_blocks):
            per_dev = [unpack_flush_rows(rows[dev, :int(t)], TAG_SCHEMA.num_fields)
                       for dev, t in enumerate(t_np)]
            batches = self._group_rows_by_window(per_dev, interval)
            self.tier_windows_flushed += len(batches)
            self.tier_windows_dropped += hold_blocks(
                self.tier_flushed, [(interval, db) for db in batches],
                self.max_held_tier_windows)
            pend = self._tier_pending_blocks[i]
            closed_blocks = [pend.pop(w) for w in sorted(pend) if lo_t <= w < hi_t]
            for blk in closed_blocks:
                self._feed_tier_block(i + 1, blk.window, blk)
            self.tier_sketch_blocks_dropped += hold_blocks(
                self.closed_tier_sketches, closed_blocks, self.max_held_sketches)

    def pop_tier_docbatches(self) -> list:
        """Drain the cascade's closed tier windows as (tier_interval_s,
        DocBatch) pairs, oldest first; merged tier sketch blocks collect
        in `closed_tier_sketches`."""
        out, self.tier_flushed = self.tier_flushed, []
        return out

    def _settle_tier_ring(self, i: int) -> None:
        self.tier_stashes[i], self.tier_accs[i], self.cascade_lanes = (
            self.pipe.tier_ring_fold_fn()(self.tier_stashes[i], self.tier_accs[i],
                                          self.cascade_lanes))
        self.tier_fills[i] = [torch.zeros_like(f) for f in self.tier_fills[i]]

    def settle_tier_rings(self) -> None:
        """Fold every tier ring into its stash (the checkpoint rule: ring
        rows reach the stash before a snapshot, so rings never
        serialize)."""
        for i in range(len(self.tier_stashes)):
            if self.tier_accs[i] is not None:
                self._settle_tier_ring(i)

    # -- live read plane -------------------------------------------------
    def snapshot_open(self, *, force: bool = False) -> OpenSnapshot:
        """A read-only snapshot of the open span from every shard's stash
        and open sketch slots, merged on the host: a window's rows
        concatenate shard by shard (the drain's order), its blocks merge.
        Nothing on the device changes, so the later flush supersedes the
        partials. Two fetches ([D] totals, then one concatenated block);
        rate-limited by `min_snapshot_interval` (`force=True` bypasses)."""
        now = time.monotonic()
        cached = self._snapshot_cache
        if (not force and cached is not None
                and now - cached.taken_monotonic < self.min_snapshot_interval):
            return cached
        with self.tracer.span(SPAN_QUERY_SNAPSHOT):
            snap = self._read_open_snapshot(now)
        self.snapshot_seq += 1
        snap.seq = self.snapshot_seq
        self._snapshot_cache = snap
        return snap

    def _read_open_snapshot(self, now: float) -> OpenSnapshot:
        if self.start_window is None:
            self.snapshot_reads += 1
            return OpenSnapshot(windows=[], taken_monotonic=now)
        b0, f0 = self.bytes_fetched, self.host_fetches
        self._fold()  # ring rows → stashes (exact, no fetch)
        packed, totals, blocks, wins = self.pipe.snapshot_open_ranges(
            self.stash, self.sketches, self.start_window)
        d = self.pipe.n_devices
        totals_np = self._fetch(self._gather(totals).to(torch.int32))
        max_t = int(totals_np.max())
        row_cols = packed[0].shape[1]
        r, wide = blocks[0].shape
        flat = self._fetch(torch.cat([
            self._gather([x[:max_t] for x in packed]), self._gather(blocks),
            self._gather([to_i32_bits(w) for w in wins]),
        ])).view(np.uint32)
        nb = d * max_t * row_cols
        rows = flat[:nb].reshape(d, max_t, row_cols)
        block_rows = flat[nb:nb + d * r * wide].reshape(d, r, wide)
        win_np = flat[nb + d * r * wide:].reshape(d, r)
        per_dev = [unpack_flush_rows(rows[i, :int(t)], TAG_SCHEMA.num_fields)
                   for i, t in enumerate(totals_np)]
        windows: list[FlushedWindow] = []
        for w in sorted({int(w) for win, *_ in per_dev for w in np.unique(win)}):
            hi_k, lo_k, tg, mt = (np.concatenate([x[k][x[0] == w] for x in per_dev])
                                  for k in (1, 2, 3, 4))
            windows.append(FlushedWindow(
                window_idx=w, start_time=w * self.interval, key_hi=hi_k, key_lo=lo_k,
                tags=tg, meters=mt, count=int(tg.shape[0]), partial=True))
        merged: dict[int, object] = {}
        for dev in range(d):
            live = win_np[dev] != np.uint32(SENTINEL_WIN)
            for blk in unpack_drained(block_rows[dev][live], win_np[dev][live], self._sk_cfg):
                have = merged.get(blk.window)
                merged[blk.window] = blk if have is None else have.merge(blk)
        windows = attach_open_sketch_blocks(
            windows, merged, interval=self.interval, num_tags=TAG_SCHEMA.num_fields,
            num_meters=FLOW_METER.num_fields)
        self.snapshot_reads += 1
        self.snapshot_bytes += self.bytes_fetched - b0
        assert self.host_fetches - f0 <= 2, "snapshot must stay a 2-fetch read"
        return OpenSnapshot(windows=windows, taken_monotonic=now,
                            open_from=self.start_window * self.interval)

    def ingest(self, tags, meters, valid) -> list:
        """Feed one flow batch (host columns; the row count divisible by
        the shard count); returns DocBatches of the windows that closed.
        The late gate and the advance are decided on the host before the
        dispatch."""
        ts_np = np.asarray(tags["timestamp"])
        valid_np = np.asarray(valid)
        if not valid_np.any():
            return []
        t_max = int(ts_np[valid_np].max())
        if self.start_window is None:
            t_min = int(ts_np[valid_np].min())
            self.start_window = max(0, min(t_min, t_max - self.delay)) // self.interval
        late = valid_np & (ts_np // self.interval < self.start_window)
        n_late = int(late.sum())
        if n_late:
            self.drop_before_window += n_late
            valid = valid_np & ~late
        self.total_docs_in += int(valid_np.sum()) - n_late

        # the advance is decided before the merge: the batch at t_max
        # belongs to the new window, so the sketch views close first (the
        # doc flush follows the merge — rows within `delay` land first)
        new_start = max(t_max - self.delay, 0) // self.interval
        advancing = self.start_window < new_start
        close_us, adv_wall = 0, 0.0
        if advancing:
            # the advance's work is split around the append (sketch close
            # before, fold after): measured here and emitted below as ONE
            # window.advance span, so counts match `window_advances`
            adv_wall = time.time()
            t0 = time.perf_counter()
            self.sketches, self.global_view, self.pod_1m = self.pipe.window_close(self.sketches)
            close_us = int((time.perf_counter() - t0) * 1e6)

        per_dev = int(ts_np.shape[0]) // self.pipe.n_devices
        # with the pre-reduce on, every append writes 4 × cap rows
        cap_u = self.pipe.config.batch_unique_cap
        rows_per_device = FANOUT_LANES * (cap_u if cap_u else per_dev)
        cap = self.acc[0].capacity if self.acc is not None else None
        plan = plan_append(self.fill, cap, rows_per_device)
        if plan == "init":
            self._fold()  # pending rows reach the stash before the ring is replaced
            if self.fill:
                raise AssertionError(
                    f"accumulator ring re-init with {self.fill} pending per-device rows — "
                    "fold before replacing the ring"
                )
            self.acc = self.pipe.init_acc(max(rows_per_device, 1))
            self.fill = 0
        elif plan == "fold":
            self._fold()
        nb = lambda a: getattr(a, "nbytes", 0)
        self.bytes_uploaded += sum(nb(v) for v in tags.values()) + nb(meters) + nb(valid)

        def dispatch_once():
            # the seam fires before the step, which writes the rings and
            # planes in place: a retried injected fault meets no
            # half-applied step
            chaos.maybe_fail(chaos.SITE_DISPATCH)
            return self.pipe.step(self.stash, self.acc, self.fill, self.sketches, tags,
                                  meters, valid, start_window=self.start_window or 0,
                                  close_below=new_start if advancing else 0)

        def on_retry(_attempt, _exc):
            self.dispatch_retries += 1

        with self.tracer.span(SPAN_INGEST_DISPATCH):
            self.stash, self.acc, self.sketches = retry_call(
                dispatch_once, self.retry_policy, on_retry=on_retry, rng=self._retry_rng,
                classify=is_dispatch_transient)
        self.fill += rows_per_device

        flushed = []
        if advancing:
            t0 = time.perf_counter()
            # flushed windows must see every accumulated row of the
            # closing span; merge mode folds only that span
            if self.pipe.config.fold_mode == "merge":
                self._fold_span(new_start)
            else:
                self._fold()
            self.tracer.record(SPAN_WINDOW_ADVANCE,
                               close_us + int((time.perf_counter() - t0) * 1e6),
                               start_s=adv_wall)
            with self.tracer.span(SPAN_FLUSH_DRAIN):
                flushed = self._drain_range(self.start_window, new_start)
            self.start_window = new_start
            self.n_advances += 1
        return flushed

    def make_feeder(self, queues, bucket_sizes, config=None, *, journal_dir=None, **kw):
        """This shard group behind a feeder runtime: flowframes from
        `queues` coalesce into bucket-shaped batches whose sizes divide
        the shard count (feeder/runtime.ShardedFeedSink). `journal_dir`
        opens this host's FrameJournal under it, named by
        `MeshTopology.host_path` (group and process index), so recovery
        replays only this host's frames; it needs a MeshTopology-built
        pipeline."""
        from ..feeder import FeederConfig, FeederRuntime, ShardedFeedSink

        if journal_dir is not None:
            if "journal" in kw:
                raise ValueError("pass journal= or journal_dir=, not both")
            from pathlib import Path

            from ..feeder.journal import FrameJournal

            topo = self.pipe.topology
            if topo is None:
                raise ValueError(
                    "journal_dir= needs a MeshTopology-built pipeline — per-host "
                    "journal naming derives from the process index"
                )
            kw["journal"] = FrameJournal(topo.host_path(Path(journal_dir) / "feeder.journal",
                                                        group=self.pipe.shard_group))
        return FeederRuntime(queues, ShardedFeedSink(self, bucket_sizes),
                             config or FeederConfig(), **kw)

    def drain(self) -> list:
        """Flush every open window (shutdown path). The open span moves
        past each drained window, so a straggler cannot re-open and
        re-emit it."""
        # the shutdown fold stays outside window.advance: the span count
        # equals `window_advances`, as on the single-chip path
        self._fold()
        with self.tracer.span(SPAN_FLUSH_DRAIN):
            flushed = self._drain_range(0, int(SENTINEL_SLOT))
        for db in flushed:
            if self.start_window is not None:
                self.start_window = max(self.start_window,
                                        int(db.timestamp[0]) // self.interval + 1)
        return flushed
