"""Feeder runtime — multi-queue fan-in for the windowed append step (port
of deepflow_tpu/feeder/runtime.py).

The stage between the receiver's overwrite queues and a pipeline:

  * **fan-in**: drain N overwrite queues round-robin (optionally
    weighted), rotating the start queue each pump so no queue starves;
  * **shape-bucketed coalescing**: decoded records accumulate in a
    pending buffer and emit as batches padded to one of a small set of
    buckets, so the accumulator ring keeps its size across mixed
    traffic;
  * **backpressure + deterministic shedding**: per-queue high/low
    watermarks with hysteresis; a queue above its high watermark gets a
    doubled drain budget but only the NEWEST half is admitted — the
    oldest frames are shed WHOLE, counted per frame via a header peek
    (no decode), in the feeder's counters and in the counter block's
    CB_FEEDER_SHED lane of the next dispatched batch;
  * **double-buffered upload**: `PipelineFeedSink` stages batch i+1
    (its upload to the device) before dispatching batch i.

Fault tolerance — every failure class on the feeder→device→flush path
is retried, contained, or counted:

  * **poisoned-frame quarantine**: sink codecs catch every decode failure
    at `FrameCodecBase.decode_frame`, count it and park the head bytes in
    a bounded ring — corrupt wire data never raises into `pump()`;
  * **graceful degradation**: when a sink dispatch fails even after the
    window manager's transient retries, the runtime turns DEGRADED:
    drain budgets halve, admitted frames are shed WHOLE and counted
    (`lost_records` / `degraded_shed_records`), and every
    `probe_interval` pumps one probe batch goes through the full
    dispatch path; a success turns it healthy again;
  * **crash-loop guard**: `serve()` contains every pump exception and
    restarts the loop with capped exponential backoff (`pump_errors`,
    `pump_failstreak`);
  * **frame journal**: with `journal=` set, every admitted frame is
    appended (pump boundaries marked) BEFORE decode, so recovery =
    `load_window_state(checkpoint)` + `replay_journal` through the normal
    decode path, bit-exact against an uninterrupted run (journal.py has
    the barrier protocol; `checkpoint()` is the flush → snapshot →
    rotate barrier).

`PipelineFeedSink` feeds flow records to a RollupPipeline through
`pipeline.stage()` / `pipeline.ingest_staged()`; `ShardedFeedSink` to a
parallel/sharded.ShardedWindowManager through `swm.ingest()`.

Self-telemetry: the runtime registers itself (`tpu_feeder`) and its
tracer (`tpu_feeder_spans`) on the default StatsCollector, and
`PipelineFeedSink` registers its double-buffered staged upload on the
device-memory ledger (plane `staged`).

Not ported with it: `WindowManagerFeedSink` and `DocChunk` (the pb-Document path through
`ingest/codec.py`), and the push-event bus and lineage hooks of
`FeederRuntime` (`event_bus=`, `lineage=`, and `FeederConfig.event_db` /
`event_table`).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from collections import deque
from pathlib import Path

from .. import chaos
from ..datamodel.batch import FlowBatch
from ..ingest.framing import HEADER_LEN, FlowHeader, MessageType, split_message_spans
from ..utils.retry import RetryPolicy, decorrelated_rng
from ..utils.spans import (
    SPAN_FEEDER_COALESCE,
    SPAN_FEEDER_DISPATCH,
    SPAN_FEEDER_DRAIN,
    SpanTracer,
)
from ..utils.stats import register_countable
from .flowframe import decode_flowframe_body, peek_rows

_log = logging.getLogger(__name__)


@dataclasses.dataclass
class FlowChunk:
    """Flow records (pre-fanout) in the pending buffer, wrapping a FlowBatch."""

    fb: FlowBatch

    @property
    def rows(self) -> int:
        return self.fb.size

    def split(self, n: int) -> tuple["FlowChunk", "FlowChunk"]:
        return FlowChunk(self.fb.slice(0, n)), FlowChunk(self.fb.slice(n, self.fb.size))


# ---------------------------------------------------------------------------
# sinks

QUARANTINE_KEEP = 8  # poisoned frames retained for diagnosis (head bytes)


class FrameCodecBase:
    """The poisoned-frame quarantine boundary every sink codec shares.

    `decode_frame` NEVER raises: any failure — magic/version/field
    drift, truncation, a decoder bug, an injected chaos fault — is
    counted (`decode_errors`), the frame's head bytes parked in a
    bounded `quarantine` ring, and None returned. Subclasses implement
    `_decode_frame`, raising on drift."""

    def __init__(self):
        self.decode_errors = 0
        self.quarantine: deque = deque(maxlen=QUARANTINE_KEEP)

    def _decode_frame(self, raw: bytes):
        raise NotImplementedError

    def decode_frame(self, raw: bytes):
        try:
            chaos.maybe_fail(chaos.SITE_DECODE)
            return self._decode_frame(raw)
        except Exception as exc:
            self.decode_errors += 1
            self.quarantine.append((type(exc).__name__, str(exc)[:160], bytes(raw[:64])))
            return None


class _FlowFrameCodec(FrameCodecBase):
    """Decode face of sinks that take flowframe (TAGGEDFLOW) frames."""

    def count_records(self, raw: bytes) -> int:
        body = raw[HEADER_LEN:]
        return sum(peek_rows(body[o:o + ln]) for o, ln in split_message_spans(body))

    def _decode_frame(self, raw: bytes) -> FlowChunk | None:
        header = FlowHeader.parse(raw[:HEADER_LEN])
        if header.msg_type != int(MessageType.TAGGEDFLOW):
            raise ValueError(f"flow sink got msg_type {header.msg_type}")
        body = raw[HEADER_LEN:]
        parts = [decode_flowframe_body(body[o:o + ln]) for o, ln in split_message_spans(body)]
        if not parts:
            return None
        return FlowChunk(FlowBatch.concat(parts))


class PipelineFeedSink(_FlowFrameCodec):
    """Flow records → RollupPipeline, with the double-buffered upload:
    `emit` STAGES the new batch (its upload) and dispatches the
    PREVIOUSLY staged one. Outputs therefore trail by one emitted batch
    until flush().

    Dispatch-failure contract: when the held batch's dispatch raises,
    its rows are counted into `lost_records` and the FRESHLY staged batch
    survives in the double buffer — the runtime's next (probe) emit
    dispatches it, so one device hiccup costs exactly one batch."""

    def __init__(self, pipeline, *, double_buffer: bool = True):
        super().__init__()
        if not pipeline.config.bucket_sizes:
            raise ValueError(
                "PipelineFeedSink needs PipelineConfig.bucket_sizes — the "
                "feeder's pad-to-bucket contract is what keeps the step shapes "
                "(and the accumulator ring) stable"
            )
        self.pipeline = pipeline
        self.double_buffer = double_buffer
        self.bucket_sizes = tuple(pipeline.config.bucket_sizes)
        self._held = None  # (StagedBatch, shed, rows) awaiting dispatch
        self._shed_carry = 0  # shed count whose batch had no valid rows
        self.lost_records = 0  # rows lost to failed dispatches
        # the staged upload awaiting dispatch is device memory this sink
        # owns: weakly on the ledger, next to the manager's planes
        from ..profiling.ledger import register_profilable

        self._ledger_src = register_profilable("feeder_sink", self)

    def device_planes(self) -> dict:
        held = self._held
        staged = held[0] if held is not None else None
        return {"staged": None if staged is None else [
            list(staged.tags.values()), staged.meters, staged.valid]}

    def emit(self, chunks: list[FlowChunk], rows: int, bucket: int, shed: int) -> list:
        fb = FlowBatch.concat([c.fb for c in chunks])
        assert fb.size == rows
        carried = self._shed_carry
        shed += carried
        self._shed_carry = 0
        try:
            staged = self.pipeline.stage(fb)  # pads to `bucket`, uploads
        except Exception:
            # admission itself failed (e.g. device OOM on the upload):
            # this batch's rows are gone and counted; the runtime re-arms
            # only the shed IT passed in, so the carry goes back
            self.lost_records += rows
            self._shed_carry += carried
            raise
        try:
            out = self.flush()  # dispatch the previously staged batch
        except Exception:
            # the HELD batch failed (flush counted its rows lost); keep the
            # new batch staged for the probe emit. += not =: flush() may
            # have just deposited the failed batch's own held_shed
            if staged is not None:
                self._held = (staged, 0, rows)
            self._shed_carry += carried
            raise
        if staged is None:  # all-padding emit — carry its shed forward
            self._shed_carry = shed
        elif self.double_buffer:
            self._held = (staged, shed, rows)
        else:
            try:
                out += self.pipeline.ingest_staged(staged, feeder_shed=shed)
            except Exception:
                self.lost_records += rows
                self._shed_carry += carried
                raise
        return out

    def flush(self) -> list:
        """Dispatch the held double-buffered batch, if any."""
        if self._held is None:
            return []
        held, held_shed, held_rows = self._held
        self._held = None
        try:
            return self.pipeline.ingest_staged(held, feeder_shed=held_shed)
        except Exception:
            # the batch's rows are lost (counted), but its attached shed
            # count survives into the carry, or the device-plane
            # feeder_shed lane would undercount
            self.lost_records += held_rows
            self._shed_carry += held_shed
            raise

    def snapshot(self):
        """Refresh the pipeline's open-window snapshot (rate-limited) —
        the feeder's between-pump scheduling hook."""
        return self.pipeline.snapshot_open()


class ShardedFeedSink(_FlowFrameCodec):
    """Flow records → ShardedWindowManager (one feeder per shard group).
    Bucket sizes must divide by the mesh's shard count: the sharded step
    splits the rows evenly across shards."""

    def __init__(self, swm, bucket_sizes: tuple[int, ...]):
        super().__init__()
        d = swm.pipe.n_devices
        bad = [b for b in bucket_sizes if b % d]
        if bad:
            raise ValueError(f"bucket sizes {bad} not divisible by device count {d}")
        self.swm = swm
        self.bucket_sizes = tuple(bucket_sizes)
        self.feeder_shed = 0  # the sharded path has no counter block

    def emit(self, chunks: list[FlowChunk], rows: int, bucket: int, shed: int) -> list:
        fb = FlowBatch.concat([c.fb for c in chunks]).pad_to(bucket)
        out = self.swm.ingest(fb.tags, fb.meters, fb.valid)
        # counted only once the batch landed: on a failed dispatch the
        # runtime re-owns the shed
        self.feeder_shed += shed
        return out

    def flush(self) -> list:
        return []

    def snapshot(self):
        """Refresh the sharded manager's open-window snapshot (the
        feeder's between-pump live-read hook)."""
        return self.swm.snapshot_open()


# ---------------------------------------------------------------------------
# the runtime


@dataclasses.dataclass(frozen=True)
class FeederConfig:
    # frames a queue may contribute per visit (scaled by its weight)
    frames_per_queue: int = 16
    # queue visits per pump() = rounds × len(queues)
    rounds_per_pump: int = 4
    # per-queue depth watermarks, as a fraction of queue capacity, with
    # hysteresis: ≥ high enters pressure (doubled drain budget, oldest
    # half shed), ≤ low leaves it
    high_watermark: float = 0.75
    low_watermark: float = 0.25
    # relative drain weights per queue (None = equal); a weight-2 queue
    # contributes 2× frames_per_queue per visit
    weights: tuple[int, ...] | None = None
    # emit the sub-bucket tail at the end of each pump (freshness) —
    # off, records wait for a full max-size bucket (efficiency)
    emit_partial: bool = True
    # pumps between probe dispatches while DEGRADED
    probe_interval: int = 8
    # serve(): max flushed-output batches held for on_flush redelivery
    # while the callback keeps failing; beyond it the OLDEST are shed and
    # counted (held_outputs_shed lanes). 0 = unbounded.
    max_held_outputs: int = 256
    # refresh the sink's open-window snapshot every N pumps, after the
    # pump's last emit (the read never interleaves into a pump's emit
    # sequence). The sink must expose `snapshot()`. 0 = off.
    snapshot_interval_pumps: int = 0


class FeederRuntime:
    """Drains N overwrite queues into shape-bucketed batches for one
    windowed sink. Drive it explicitly with `pump()` or via the
    `serve()` polling thread."""

    def __init__(self, queues: list, sink, config: FeederConfig = FeederConfig(), *,
                 name: str = "feeder", tracer: SpanTracer | None = None, journal=None):
        if not queues:
            raise ValueError("need at least one queue")
        if config.weights is not None and len(config.weights) != len(queues):
            raise ValueError(f"{len(config.weights)} weights for {len(queues)} queues")
        if not getattr(sink, "bucket_sizes", None):
            raise ValueError("sink must declare bucket_sizes")
        self.queues = list(queues)
        self.sink = sink
        self.config = config
        self.buckets = tuple(sorted(sink.bucket_sizes))
        self.name = name
        self.tracer = tracer if tracer is not None else SpanTracer(
            service="deepflow_tpu.feeder")
        self._journal = journal
        self._weights = config.weights or (1,) * len(queues)
        self._pressure = [False] * len(queues)
        self._chunks: deque = deque()
        self._rows = 0
        self._shed_pending = 0  # records shed since the last emit
        self._rr = 0  # rotating first-queue index (starvation-proof)
        self._lock = threading.Lock()
        # serializes pump/flush/checkpoint/replay against each other: a
        # checkpoint racing the serve() thread could otherwise admit (and
        # journal) frames between the barrier flush and sync_offset —
        # below the barrier offset but absent from the snapshot, so replay
        # would skip them. RLock: checkpoint() calls flush() re-entrantly.
        self._pump_mutex = threading.RLock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # degraded-mode state machine
        self.degraded = False
        self._probe_now = True
        self._probe_countdown = 0
        self._pump_failstreak = 0  # consecutive serve()-loop pump failures
        self.counters = {
            "frames_in": 0,
            "records_in": 0,
            "bad_frames": 0,
            "batches_out": 0,
            "records_out": 0,
            "pad_rows": 0,
            "shed_frames": 0,
            "shed_records": 0,
            "pressure_events": 0,
            # fault-tolerance lanes
            "emit_failures": 0,
            "lost_records": 0,
            "degraded_entries": 0,
            "degraded_exits": 0,
            "degraded_shed_records": 0,
            "probe_attempts": 0,
            "pump_errors": 0,
            "flush_callback_errors": 0,
            "held_outputs_shed": 0,
            "held_output_shed_records": 0,
            "checkpoint_aborts": 0,
            "replayed_frames": 0,
            # live read scheduling
            "snapshots_taken": 0,
            "snapshot_errors": 0,
        }
        self._pump_count = 0
        self.last_snapshot = None  # most recent scheduled OpenSnapshot
        self._snapshot_err_logged = False
        # False after a checkpoint() that aborted — callers that prune old
        # checkpoints or journals MUST check it first
        self.last_checkpoint_ok = True
        self._held_shed_logged = False
        register_countable("tpu_feeder", self, name=name)
        register_countable("tpu_feeder_spans", self.tracer, name=name)

    # -- countable face --------------------------------------------------
    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["pending_rows"] = self._rows
        out["queue_overwritten"] = sum(int(getattr(q, "overwritten", 0)) for q in self.queues)
        out["queues_in_pressure"] = sum(self._pressure)
        out["degraded"] = int(self.degraded)
        out["pump_failstreak"] = self._pump_failstreak
        out["healthy"] = int(not self.degraded and self._pump_failstreak == 0)
        out["last_checkpoint_ok"] = int(self.last_checkpoint_ok)
        out["decode_errors"] = int(getattr(self.sink, "decode_errors", 0))
        if self._journal is not None:
            for k, v in self._journal.get_counters().items():
                out[f"journal_{k}"] = v
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    # -- degraded-mode state machine -------------------------------------
    def _count_records_safe(self, raw: bytes) -> int:
        """Header-peek record count that survives corrupt frames — the
        shed accounting must never be the thing that raises."""
        try:
            return self.sink.count_records(raw)
        except Exception:
            return 0

    def _enter_degraded(self) -> None:
        self._probe_countdown = self.config.probe_interval
        self._probe_now = False
        if not self.degraded:
            self.degraded = True
            self._count("degraded_entries")
            _log.warning(
                "feeder %s: sink dispatch failed after retries — entering "
                "degraded mode (shedding, probing every %d pumps)",
                self.name, self.config.probe_interval,
            )

    def _note_emit_ok(self) -> None:
        if self.degraded:
            self.degraded = False
            self._count("degraded_exits")
            _log.warning("feeder %s: probe dispatch succeeded — leaving degraded mode",
                         self.name)

    def _probe_tick(self) -> None:
        """Per-pump probe schedule: healthy pumps always dispatch;
        degraded pumps shed until the countdown elapses, then let one
        pump's batches through as the probe."""
        if not self.degraded:
            self._probe_now = True
            return
        self._probe_countdown -= 1
        if self._probe_countdown <= 0:
            self._probe_now = True
            self._probe_countdown = self.config.probe_interval
        else:
            self._probe_now = False

    def _shed_frame(self, raw: bytes) -> None:
        """Degraded-mode shed: whole frames, counted via header peek."""
        self._count("shed_frames")
        n = self._count_records_safe(raw)
        self._count("shed_records", n)
        self._count("degraded_shed_records", n)
        with self._lock:
            self._shed_pending += n

    # -- drain + shed ----------------------------------------------------
    def _visit(self, i: int, admit: list) -> int:
        """Drain queue i once; append admitted frames, shed the rest.
        Returns frames drained. Deterministic: the decision depends only
        on queue depth at visit time and the configured watermarks."""
        q = self.queues[i]
        budget = self._weights[i] * self.config.frames_per_queue
        if self.degraded:
            budget = max(1, budget // 2)
        cap = int(getattr(q, "capacity", 0) or 0)
        if cap:
            depth = len(q)
            if not self._pressure[i] and depth >= self.config.high_watermark * cap:
                self._pressure[i] = True
                self._count("pressure_events")
            elif self._pressure[i] and depth <= self.config.low_watermark * cap:
                self._pressure[i] = False
        if self._pressure[i]:
            # pressure: drain twice the budget, admit only the NEWEST
            # `budget` frames, shed the oldest WHOLE and count every
            # dropped record via the header peek
            drained = q.gets(2 * budget, timeout_ms=0)
            cut = max(len(drained) - budget, 0)
            for raw in drained[:cut]:
                self._count("shed_frames")
                n = self._count_records_safe(raw)
                self._count("shed_records", n)
                with self._lock:
                    self._shed_pending += n
            admit.extend(drained[cut:])
            return len(drained)
        drained = q.gets(budget, timeout_ms=0)
        admit.extend(drained)
        return len(drained)

    # -- coalescing ------------------------------------------------------
    def _take(self, n: int) -> list:
        """Pop exactly n rows of chunks from the pending buffer."""
        out = []
        need = n
        while need > 0:
            c = self._chunks.popleft()
            if c.rows <= need:
                out.append(c)
                need -= c.rows
            else:
                head, tail = c.split(need)
                out.append(head)
                self._chunks.appendleft(tail)
                need = 0
        self._rows -= n
        return out

    def _emit(self, rows: int, bucket: int) -> list:
        chunks = self._take(rows)
        if self.degraded:
            # a dispatch attempted while degraded IS the probe
            self._count("probe_attempts")
        with self._lock:
            shed, self._shed_pending = self._shed_pending, 0
        lost0 = getattr(self.sink, "lost_records", None)
        try:
            with self.tracer.span(SPAN_FEEDER_DISPATCH):
                out = self.sink.emit(chunks, rows, bucket, shed)
        except Exception:
            # containment: the dispatch failed even after the window
            # manager's transient retries. Count what was lost (a double
            # buffer keeps the staged batch), re-arm the undelivered shed
            # for the next successful batch, and turn degraded.
            lost = rows if lost0 is None else self.sink.lost_records - lost0
            self._count("emit_failures")
            self._count("lost_records", lost)
            # records_out counts rows that LEFT the coalescing buffer in
            # both outcomes (records_in = records_out + pending_rows always
            # holds); delivered = records_out − lost_records
            self._count("records_out", rows)
            with self._lock:
                self._shed_pending += lost + shed
            self._enter_degraded()
            return []
        self._note_emit_ok()
        self._count("batches_out")
        self._count("records_out", rows)
        self._count("pad_rows", bucket - rows)
        return out

    def _admit(self, chunk, out: list) -> None:
        self._chunks.append(chunk)
        self._rows += chunk.rows
        max_b = self.buckets[-1]
        while self._rows >= max_b:
            out.extend(self._emit(max_b, max_b))
            if self.degraded:
                # the emit just failed — the remaining rows wait for the probe
                break

    def _bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def _process_frame(self, raw: bytes, out: list) -> None:
        """Decode one admitted frame through the sink codec and coalesce
        it — the single path pump() and replay_journal() share, so
        recovery exercises no special-case decode code."""
        errs0 = int(getattr(self.sink, "decode_errors", 0))
        try:
            chunk = self.sink.decode_frame(raw)
        except Exception:
            # sinks quarantine internally (FrameCodecBase); this guard
            # covers foreign sink implementations only
            self._count("bad_frames")
            return
        if int(getattr(self.sink, "decode_errors", 0)) > errs0:
            self._count("bad_frames")  # quarantined by the codec
            return
        self._count("frames_in")
        if chunk is None or chunk.rows == 0:
            return
        self._count("records_in", chunk.rows)
        self._admit(chunk, out)

    # -- the pump --------------------------------------------------------
    def pump(self) -> list:
        """One fan-in cycle: drain every queue (rounds_per_pump visits
        each, rotating the start index), decode + coalesce into bucket
        batches, emit them into the sink, and — with emit_partial — flush
        the sub-bucket tail padded to its smallest bucket. Returns
        whatever the sink's window controller flushed."""
        with self._pump_mutex:
            return self._pump_locked()

    def _pump_locked(self) -> list:
        out: list = []
        self._probe_tick()
        dispatch0 = self.counters["batches_out"] + self.counters["emit_failures"]
        nq = len(self.queues)
        for _ in range(self.config.rounds_per_pump):
            admit: list = []
            with self.tracer.span(SPAN_FEEDER_DRAIN):
                drained = 0
                for j in range(nq):
                    drained += self._visit((self._rr + j) % nq, admit)
            self._rr = (self._rr + 1) % nq
            if not admit and not drained:
                break
            with self.tracer.span(SPAN_FEEDER_COALESCE):
                # one shed decision per round: frames the live run sheds
                # and counts are NOT journaled — replay would resurrect
                # rows the counters already declared shed
                shedding = self.degraded and not self._probe_now
                # journal the WHOLE admitted round before touching the
                # device: a kill anywhere downstream (dispatch, fetch,
                # flush) then loses nothing the journal can't replay
                if self._journal is not None and not shedding:
                    for raw in admit:
                        self._journal.append(raw)
                for raw in admit:
                    if shedding:
                        self._shed_frame(raw)
                        continue
                    self._process_frame(raw, out)
        if self.config.emit_partial and self._rows > 0 and (
                self._probe_now or not self.degraded):
            out.extend(self._emit(self._rows, self._bucket_for(self._rows)))
        if self._journal is not None:
            self._journal.mark()
        if (self.degraded and self._probe_now
                and self.counters["batches_out"] + self.counters["emit_failures"]
                == dispatch0):
            # the probe pump had no data to send, so nothing was tested:
            # keep the probe armed instead of re-arming the countdown
            self._probe_countdown = 0
        # live snapshot scheduling: AFTER the pump's last emit, BEFORE the
        # next pump's first dispatch. Guarded: a broken snapshot path
        # degrades the live view, never the pump.
        if self.config.snapshot_interval_pumps > 0:
            self._pump_count += 1
            if (self._pump_count % self.config.snapshot_interval_pumps == 0
                    and hasattr(self.sink, "snapshot")):
                try:
                    self.last_snapshot = self.sink.snapshot()
                    self._count("snapshots_taken")
                except Exception:
                    self._count("snapshot_errors")
                    if not self._snapshot_err_logged:
                        self._snapshot_err_logged = True
                        _log.exception("feeder %s: open-window snapshot failed — live "
                                       "reads degrade to flushed-only", self.name)
        return out

    def flush(self) -> list:
        """Emit every pending record (tail bucket) and push anything the
        sink holds (the double-buffered staged batch); does NOT drain the
        sink's open windows — that stays the owner's shutdown call."""
        with self._pump_mutex:
            out: list = []
            if self._rows > 0:
                out.extend(self._emit(self._rows, self._bucket_for(self._rows)))
            lost0 = getattr(self.sink, "lost_records", None)
            try:
                with self.tracer.span(SPAN_FEEDER_DISPATCH):
                    out.extend(self.sink.flush())
            except Exception:
                lost = 0 if lost0 is None else self.sink.lost_records - lost0
                self._count("emit_failures")
                self._count("lost_records", lost)
                with self._lock:
                    self._shed_pending += lost
                self._enter_degraded()
            return out

    # -- journal recovery ------------------------------------------------
    def checkpoint(self, save) -> list:
        """The flush → snapshot → rotate checkpoint barrier.

        Flushes every pending row and the sink's staged batch (so the
        window state covers all admitted frames), calls `save(barrier)` —
        a closure around e.g. checkpoint.save_window_state, with `barrier`
        = {"journal_epoch", "journal_offset"} to embed in the snapshot
        meta — then rotates the journal. Returns every output the barrier
        flushed (including whatever `save` returns, e.g. save_window_state's
        in-flight windows); callers must emit them BEFORE treating the
        checkpoint as durable.

        If the barrier flush fails to deliver (a sink dispatch error) or
        the save raises, the checkpoint ABORTS — counted
        (`checkpoint_aborts`) and logged, journal not rotated: the
        previous checkpoint plus the intact journal still recover
        everything. `last_checkpoint_ok` records per-call success; callers
        that prune older checkpoints or journals after this call MUST
        check it. A KillPoint (process death) is a BaseException and
        still pierces.

        Safe to call from any thread while serve() runs: the pump mutex
        holds the barrier (flush → sync_offset → save → rotate) closed
        against concurrent admits."""
        with self._pump_mutex:
            ef0 = self.counters["emit_failures"]
            out = self.flush()
            if self.counters["emit_failures"] > ef0:
                self.last_checkpoint_ok = False
                self._count("checkpoint_aborts")
                _log.warning(
                    "feeder %s: checkpoint aborted — the barrier flush failed "
                    "to deliver; journal kept (not rotated), snapshot not "
                    "written", self.name,
                )
                return out
            try:
                barrier = None
                if self._journal is not None:
                    epoch, off = self._journal.sync_offset()
                    barrier = {"journal_epoch": epoch, "journal_offset": off}
                res = save(barrier)
            except Exception:
                # the barrier flush's outputs already left the manager
                # state and the caller is their only route out: deliver
                # them, keep the journal
                self.last_checkpoint_ok = False
                self._count("checkpoint_aborts")
                _log.exception(
                    "feeder %s: checkpoint aborted — snapshot save failed; "
                    "journal kept (not rotated), flushed outputs delivered",
                    self.name,
                )
                return out
            if res:
                out.extend(res)
            if self._journal is not None:
                self._journal.rotate()
            self.last_checkpoint_ok = True
            return out

    def quiesce(self, save, *, max_pumps: int = 64) -> list:
        """Drain-to-barrier for an ownership handover: pump until every
        queue is empty and no rows are pending, then run the checkpoint
        barrier. The snapshot + rotated journal are then the complete
        transferable state of this feeder's sink.

        Loud by contract: a queue whose backlog stops SHRINKING across a
        pump (a producer still feeding it — fence admission first) or an
        aborted barrier checkpoint raises chaos.RebalanceAbortError with
        the already-flushed outputs on `.outputs`. `max_pumps` is slack
        on top of the backlog-sized budget. Returns every output the
        drain and barrier flushed."""
        with self._pump_mutex:
            out: list = []
            qlen = sum(len(q) for q in self.queues)
            # fenced admission ⇒ every pump strictly shrinks the backlog ⇒
            # at most one pump per queued frame (+ slack for tail emits)
            for _ in range(qlen + max_pumps):
                out.extend(self.pump())
                if self._rows == 0 and all(len(q) == 0 for q in self.queues):
                    break
                now_qlen = sum(len(q) for q in self.queues)
                if now_qlen >= qlen and now_qlen > 0:
                    err = chaos.RebalanceAbortError(
                        f"feeder {self.name}: queue backlog did not shrink across a "
                        f"quiesce pump ({qlen} → {now_qlen} frames) — admission was "
                        "not fenced before the handover"
                    )
                    err.outputs = out
                    raise err
                qlen = now_qlen
            else:
                err = chaos.RebalanceAbortError(
                    f"feeder {self.name}: rows still pending after the quiesce pump "
                    "budget — the sink is not draining"
                )
                err.outputs = out
                raise err
            out.extend(self.checkpoint(save))
            if not self.last_checkpoint_ok:
                err = chaos.RebalanceAbortError(
                    f"feeder {self.name}: handover barrier checkpoint aborted — "
                    "state not transferable; the previous checkpoint and the "
                    "un-rotated journal still recover everything on THIS host"
                )
                err.outputs = out
                raise err
            return out

    def replay_journal(self, path, *, barrier: dict | None = None) -> list:
        """Recovery: replay a (crashed) feeder's journal through the
        NORMAL decode path. FRAME records flow through _process_frame
        (same coalescing, same bucket emits), MARK records re-create the
        pump-boundary tail emits — so batch boundaries, and therefore f32
        meter fold order and flushed rows, are bit-exact vs the
        uninterrupted run. `barrier` (from the checkpoint meta) skips
        records the snapshot already covers when the crash landed between
        save and rotate; a rotated journal (epoch advanced) replays in
        full. Frames are re-journaled into THIS runtime's journal, so
        recovery itself is crash-safe. After the replay, call pump(): it
        completes the interrupted pump's tail emit.

        Replaying from THIS runtime's own journal path is safe: the
        entries are read up front and the live journal is rotated first,
        so replayed frames are re-appended exactly once into the fresh
        epoch."""
        from .journal import REC_FRAME, REC_MARK, read_journal

        with self._pump_mutex:
            out: list = []
            epoch, entries, truncated = read_journal(path)
            if self._journal is not None:
                try:
                    aliased = Path(path).resolve() == self._journal.path.resolve()
                except OSError:
                    aliased = False
                if aliased:
                    self._journal.rotate()
            skip_off = -1
            if barrier and barrier.get("journal_epoch") == epoch:
                skip_off = int(barrier.get("journal_offset", 0))
            if truncated:
                _log.warning("feeder %s: journal %s has a torn tail (crash mid-write) — "
                             "replaying the clean prefix", self.name, path)
            for kind, payload, off in entries:
                if off < skip_off:
                    continue
                if kind == REC_FRAME:
                    if self._journal is not None:
                        self._journal.append(payload)
                    self._count("replayed_frames")
                    self._process_frame(payload, out)
                elif kind == REC_MARK:
                    if self.config.emit_partial and self._rows > 0:
                        out.extend(self._emit(self._rows, self._bucket_for(self._rows)))
                    if self._journal is not None:
                        self._journal.mark()
            return out

    # -- thread ----------------------------------------------------------
    def _hold_for_redelivery(self, held: list, new: list) -> list:
        """Extend the serve() redelivery buffer, bounded by
        config.max_held_outputs: beyond the cap the OLDEST outputs are
        shed and counted (held_outputs_shed / held_output_shed_records),
        logged once per overflow episode."""
        held.extend(new)
        cap = self.config.max_held_outputs
        if cap and len(held) > cap:
            drop = len(held) - cap
            shed, held = held[:drop], held[drop:]
            rows = sum(int(getattr(o, "size", 0) or getattr(o, "count", 0) or 0)
                       for o in shed)
            self._count("held_outputs_shed", drop)
            self._count("held_output_shed_records", rows)
            if not self._held_shed_logged:
                self._held_shed_logged = True
                _log.error(
                    "feeder %s: on_flush redelivery buffer overflowed — shed %d "
                    "oldest output batches (%d records); downstream has been "
                    "failing past max_held_outputs=%d", self.name, drop, rows, cap,
                )
        return held

    def serve(self, poll_ms: int = 20, on_flush=None) -> None:
        """Background pump loop; `on_flush(outputs)` receives every
        non-empty result. A pump exception is counted (`pump_errors`) and
        the loop restarts with capped exponential backoff; an `on_flush`
        exception is counted (`flush_callback_errors`) and its outputs are
        HELD and re-delivered on the next loop — at-least-once up to
        config.max_held_outputs, beyond which the oldest are shed and
        counted. Stop it with `stop()` before installing a chaos plan:
        its pumps would shift the plan's per-site call indices."""
        if self._thread is not None:
            return
        self._stop.clear()
        idle = poll_ms / 1000.0
        # decorrelated per instance: N feeders recovering from the same
        # device fault must not retry in lockstep
        policy = RetryPolicy(base_delay_s=idle, max_delay_s=5.0, multiplier=2.0, jitter=0.5)
        rng = decorrelated_rng(hash(self.name) & 0xFFFF)

        def run():
            cb_failstreak = 0
            undelivered: list = []
            while not self._stop.is_set():
                try:
                    got = self.pump()
                except Exception:
                    self._count("pump_errors")
                    self._pump_failstreak += 1
                    if self._pump_failstreak == 1:
                        _log.exception("feeder %s: pump failed — restarting loop with "
                                       "backoff", self.name)
                    self._stop.wait(policy.delay(self._pump_failstreak, rng))
                    continue
                if self._pump_failstreak:
                    _log.warning("feeder %s: pump loop recovered after %d failures",
                                 self.name, self._pump_failstreak)
                    self._pump_failstreak = 0
                if on_flush is not None:
                    undelivered = self._hold_for_redelivery(undelivered, got)
                if undelivered and on_flush is not None:
                    batch, undelivered = undelivered, []
                    try:
                        on_flush(batch)
                    except Exception:
                        undelivered = batch
                        cb_failstreak += 1
                        self._count("flush_callback_errors")
                        _log.exception("feeder %s: on_flush failed — holding %d "
                                       "outputs for redelivery", self.name, len(batch))
                        self._stop.wait(policy.delay(cb_failstreak, rng))
                        continue
                    cb_failstreak = 0
                    self._held_shed_logged = False
                if not got:
                    self._stop.wait(idle)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout)
