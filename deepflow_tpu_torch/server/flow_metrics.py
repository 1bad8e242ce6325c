"""flow_metrics ingester — receiver to storage, the server hot path (port
of deepflow_tpu/server/flow_metrics.py).

The re-composition of `server/ingester/flow_metrics/flow_metrics.go:50`
+ `unmarshaller/unmarshaller.go:220`: the receiver fans METRICS frames
into N overwrite queues; each unmarshaller worker drains its queue in
batches, decodes pb Documents columnar (native C++ decoder when built,
Python twin otherwise), runs the whole batch through the device enrichment (enrich/platform.py — the
DocumentExpand analog) in fixed-size chunks, and hands enriched column
batches to the writer.

Per chunk the port packs side0, side1 and keep (u32 lanes) and the drop
count into one tensor and fetches it once (`enrich_fetches` counts the
fetches); the reference fetches every enriched field separately. The
split gives the same arrays.

Workers run on the platform state's device, named explicitly in every
tensor op. An exception in a worker (a CUDA error, say) is recorded and
re-raised as `WorkerError` from `get_counters()` and `stop()`, so it
cannot vanish with its thread.

Like the reference, no re-aggregation happens here — agents
pre-aggregate and docs are written as-is; server-side rollups are the
downsampler's job. `disable_second_write` mirrors unmarshaller.go:246.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..datamodel.code import DocumentFlag
from ..enrich.platform import ENRICH_FIELDS, PlatformState, enrich_docs
from ..ingest.codec import DecodedBatch, DocumentDecoder
from ..ingest.framing import HEADER_LEN, FlowHeader, MessageType, split_message_spans
from ..ingest.queues import new_queue
from ..ingest.receiver import Receiver
from ..ops.u32 import to_i32_bits, to_numpy_u32
from .. import native


class WorkerError(RuntimeError):
    """An ingester worker thread died; `__cause__` is its exception."""


@dataclasses.dataclass
class EnrichedBatch:
    """What the writer receives: decoded docs + device enrichment."""

    header: FlowHeader
    decoded: DecodedBatch
    side0: dict[str, np.ndarray] | None
    side1: dict[str, np.ndarray] | None
    keep: np.ndarray  # [N] bool (False = other-region drop)


def enrich_chunk_host(state: PlatformState, tags: np.ndarray, valid: np.ndarray):
    """One fixed-size chunk through `enrich_docs` and back to the host in
    ONE fetch: ([side0 dict], [side1 dict], keep, drops) as uint32
    arrays (keep bool), the layout of the reference's per-field fetch."""
    s0, s1, keep, drops = enrich_docs(state, tags, valid)
    f = len(ENRICH_FIELDS)
    lanes = [s0[k] for k in ENRICH_FIELDS] + [s1[k] for k in ENRICH_FIELDS] + [keep.long()]
    packed = torch.cat([torch.stack(lanes).reshape(-1), drops.reshape(1)])
    host = to_numpy_u32(to_i32_bits(packed))
    mat = host[:-1].reshape(2 * f + 1, -1)
    side0 = {k: mat[i] for i, k in enumerate(ENRICH_FIELDS)}
    side1 = {k: mat[f + i] for i, k in enumerate(ENRICH_FIELDS)}
    return side0, side1, mat[2 * f].astype(bool), int(host[-1])


def enrich_batch(state: PlatformState, tags: np.ndarray, valid: np.ndarray, chunk: int):
    """A decoded batch through `enrich_chunk_host` in fixed-size chunks,
    the tail padded (one chunk shape for the whole run, as the
    reference) → (side0, side1, keep, drops, chunks)."""
    n = tags.shape[0]
    s0_parts, s1_parts, keep_parts, drops = [], [], [], 0
    for off in range(0, n, chunk):
        m = min(chunk, n - off)
        tags_p = np.zeros((chunk, tags.shape[1]), dtype=np.uint32)
        tags_p[:m] = tags[off : off + m]
        valid_p = np.zeros(chunk, dtype=bool)
        valid_p[:m] = valid[off : off + m]
        c0, c1, ckeep, cdrops = enrich_chunk_host(state, tags_p, valid_p)
        s0_parts.append({k: v[:m] for k, v in c0.items()})
        s1_parts.append({k: v[:m] for k, v in c1.items()})
        keep_parts.append(ckeep[:m])
        drops += cdrops
    s0 = {k: np.concatenate([p[k] for p in s0_parts]) for k in s0_parts[0]}
    s1 = {k: np.concatenate([p[k] for p in s1_parts]) for k in s1_parts[0]}
    return s0, s1, np.concatenate(keep_parts), drops, len(keep_parts)


class FlowMetricsIngester:
    """METRICS pipeline: queues → decode → enrich → writer.put(batch)."""

    def __init__(
        self,
        receiver: Receiver,
        writer,
        *,
        platform_state: PlatformState | None = None,
        n_workers: int = 1,
        queue_capacity: int = 1 << 14,
        batch_size: int = 256,
        disable_second_write: bool = False,
        enrich_chunk: int = 8192,
        prefer_native: bool = True,
    ):
        self.writer = writer
        self.platform_state = platform_state
        self.batch_size = batch_size
        self.enrich_chunk = enrich_chunk
        self.disable_second_write = disable_second_write
        self._use_native = prefer_native and native.native_available()
        self.queues = [new_queue(queue_capacity, prefer_native=prefer_native) for _ in range(n_workers)]
        receiver.register_handler(MessageType.METRICS, self.queues)
        self.counters = {
            "frames_in": 0,
            "docs_in": 0,
            "docs_written": 0,
            "decode_errors": 0,
            "drop_other_region": 0,
            "drop_second_write": 0,
            "enrich_chunks": 0,
            "enrich_fetches": 0,
        }
        self._lock = threading.Lock()
        self._errors: list[tuple[str, BaseException]] = []
        self._running = True
        self._threads = [
            threading.Thread(target=self._worker_guarded, args=(q,), daemon=True,
                             name=f"flow_metrics_worker_{i}")
            for i, q in enumerate(self.queues)
        ]
        for t in self._threads:
            t.start()
        from ..utils.stats import register_countable

        register_countable("flow_metrics_ingester", self)

    def _raise_worker_error(self) -> None:
        with self._lock:
            errors = list(self._errors)
        if errors:
            name, exc = errors[0]
            raise WorkerError(f"{len(errors)} ingester worker(s) died; first: {name}: "
                              f"{type(exc).__name__}: {exc}") from exc

    def get_counters(self):
        """Counters; raises WorkerError if a worker died."""
        self._raise_worker_error()
        with self._lock:
            return dict(self.counters)

    def stop(self, timeout: float = 5.0) -> None:
        """Close the queues, join the workers; raises WorkerError if a
        worker died."""
        self._running = False
        for q in self.queues:
            q.close()
        for t in self._threads:
            t.join(timeout=timeout)
        self._raise_worker_error()

    # -- worker ---------------------------------------------------------
    def _worker_guarded(self, q) -> None:
        try:
            if self.platform_state is not None and self.platform_state.device.type == "cuda":
                torch.cuda.set_device(self.platform_state.device)
            self._worker(q)
        except Exception as exc:  # recorded, re-raised by get_counters/stop
            with self._lock:
                self._errors.append((threading.current_thread().name, exc))

    def _worker(self, q) -> None:
        decoder = native.NativeDocumentDecoder() if self._use_native else DocumentDecoder()
        while self._running:
            frames = q.gets(self.batch_size, timeout_ms=100)
            if not frames:
                continue
            # Coalesce the whole gets batch into per-org message lists
            # before decoding (unmarshaller.go:220 batch semantics): one
            # columnar decode + one enrichment pass per org per drain.
            # Org is the only routing key the writer uses
            # (metrics_tables.py); per-agent identity lives in the tags.
            groups: dict[int, list] = {}  # org → [header, parts, n_msgs]
            n_frames = bad = 0
            for raw in frames:
                try:
                    header = FlowHeader.parse(raw[:HEADER_LEN])
                    body = raw[HEADER_LEN:]
                    spans = split_message_spans(body)
                except ValueError:  # short/garbage frame must not kill the worker
                    bad += 1
                    continue
                n_frames += 1
                g = groups.get(header.organization_id)
                if g is None:
                    groups[header.organization_id] = [header, [(body, spans)], len(spans)]
                else:
                    g[1].append((body, spans))
                    g[2] += len(spans)
            with self._lock:
                self.counters["decode_errors"] += bad
                self.counters["frames_in"] += n_frames
            for header, parts, n_msgs in groups.values():
                self._process_parts(decoder, header, parts, n_msgs)

    def _process_parts(self, decoder, header: FlowHeader, parts, n_msgs: int) -> None:
        errors_before = decoder.decode_errors
        batches = decoder.decode_parts(parts)
        with self._lock:
            self.counters["docs_in"] += n_msgs
            self.counters["decode_errors"] += decoder.decode_errors - errors_before

        for decoded in batches.values():
            valid = np.ones(decoded.tags.shape[0], dtype=bool)
            if self.disable_second_write:
                # 1s-granularity docs carry PER_SECOND_METRICS
                # (unmarshaller.go:246 disableSecondWrite)
                second = (decoded.flags & int(DocumentFlag.PER_SECOND_METRICS)) != 0
                with self._lock:
                    self.counters["drop_second_write"] += int(second.sum())
                valid &= ~second
            if self.platform_state is not None:
                s0, s1, keep, drops, chunks = enrich_batch(
                    self.platform_state, decoded.tags, valid, self.enrich_chunk)
                with self._lock:
                    self.counters["drop_other_region"] += int(drops)
                    self.counters["enrich_chunks"] += chunks
                    self.counters["enrich_fetches"] += chunks  # one per chunk
            else:
                s0 = s1 = None
                keep = valid
            with self._lock:
                self.counters["docs_written"] += int(keep.sum())
            self.writer.put(EnrichedBatch(header=header, decoded=decoded, side0=s0, side1=s1,
                                          keep=keep))


class ListWriter:
    """Test/bring-up writer: collects EnrichedBatches in memory."""

    def __init__(self):
        self.batches: list[EnrichedBatch] = []
        self._lock = threading.Lock()

    def put(self, batch: EnrichedBatch) -> None:
        with self._lock:
            self.batches.append(batch)

    def doc_count(self) -> int:
        with self._lock:
            return sum(int(b.keep.sum()) for b in self.batches)
