"""Host side of the fleet plane: frame assembly + wire sink.

`FleetExporter` turns one collector tick's points plus the host's
summary faces (freshness/span `hist_dump()`, alert rule states, HBM
ledger rows, census scalars) into one `FleetFrame`. Everything it
reads is host-side arithmetic over already-maintained state — no
device fetch, no store access — so attaching the sink cannot move the
ingest fetch budget.

`FleetSink` is the `StatsCollector.add_sink` face: each tick it
encodes one frame and queues it on a `HandoffSender` pointed at the
aggregator — the handoff transport's framed-TCP stance verbatim (bounded overwrite
queue, capped-exponential reconnect with jitter, at-least-once across
reconnects, counted shed when the aggregator stays unreachable, the
`handoff.send` chaos seam for scripted transport faults). A dead
aggregator therefore costs the host one queue slot per tick, never a
blocked tick thread.
"""

from __future__ import annotations

import threading
import time

from ..utils.stats import StatsPoint, register_countable
from .frame import FleetFrame, encode_fleet_frame

#: the single-peer id a sink's sender routes to (the aggregator)
AGGREGATOR_PEER = 0


class FleetExporter:
    """Builds per-tick fleet frames from a host's telemetry faces.

    Every face is optional and guarded: a broken face is skipped and
    counted (`face_errors`), never allowed to kill the tick — the
    collector's own sink guard would otherwise drop the WHOLE frame
    for one bad census pull.
    """

    def __init__(self, host: str, *, group: str = "", epoch: int = 0,
                 collector=None, hist_faces=None, alerts=None,
                 ledger=None, census=None, clock=time.time):
        self.host = str(host)
        self.group = str(group)
        self.epoch = int(epoch)
        self._collector = collector
        #: {face name: object with .hist_dump()} — freshness trackers,
        #: span tracers; merged across hosts bin-for-bin by name.lane
        self._hist_faces = dict(hist_faces or {})
        self._alerts = alerts
        self._ledger = ledger
        self._census = census
        self._clock = clock
        self._lock = threading.Lock()
        self._seq = 0
        self.counters = {
            "frames_built": 0, "frame_bytes": 0, "face_errors": 0,
        }

    def set_epoch(self, epoch: int) -> None:
        """Topology epoch flips stamp subsequent frames (the aggregator
        keys staleness decisions on (host, epoch))."""
        self.epoch = int(epoch)

    def add_hist_face(self, name: str, face) -> None:
        self._hist_faces[str(name)] = face

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            return dict(self.counters)

    # -- frame assembly --------------------------------------------------
    def _guard(self, fn, default):
        try:
            return fn()
        except Exception:
            with self._lock:
                self.counters["face_errors"] += 1
            return default

    def build(self, points=None, now: float | None = None) -> FleetFrame:
        """One frame from `points` (a collector tick's StatsPoints) or,
        when None, a fresh fetch-free `collector.sample()` pull."""
        now = self._clock() if now is None else now
        if points is None:
            collector = self._collector
            if collector is None:
                from ..utils.stats import default_collector as collector
            points = self._guard(lambda: collector.sample(now), [])
        pts = tuple(
            (p.timestamp, p.module, {k: v for k, v in p.tags},
             dict(p.fields))
            for p in points
            if isinstance(p, StatsPoint)
        )
        hists = {}
        for name, face in self._hist_faces.items():
            dump = self._guard(face.hist_dump, None)
            if dump:
                hists[name] = dump
        alerts = ()
        if self._alerts is not None:
            alerts = self._guard(
                lambda: tuple(
                    {
                        "name": r["name"], "state": r["state"],
                        "value": r["value"],
                        "transitions": r["transitions"],
                    }
                    for r in self._alerts.list_rules()
                ),
                (),
            )
        hbm = ()
        if self._ledger is not None:
            hbm = self._guard(lambda: tuple(self._ledger.snapshot()), ())
        census = {}
        if self._census is not None:
            # scalars only (get_counters) — snapshot(analyze=True) may
            # COMPILE and belongs on the profile pull, never per tick
            census = self._guard(lambda: dict(self._census.get_counters()), {})
        with self._lock:
            seq = self._seq
            self._seq += 1
            self.counters["frames_built"] += 1
        return FleetFrame(
            host=self.host, group=self.group, epoch=self.epoch,
            seq=seq, timestamp=float(now), points=pts, hists=hists,
            alerts=alerts, hbm=hbm, census=census,
        )

    def encode(self, points=None, now: float | None = None) -> bytes:
        raw = encode_fleet_frame(self.build(points=points, now=now))
        with self._lock:
            self.counters["frame_bytes"] += len(raw)
        return raw


class FleetSink:
    """`StatsCollector` sink → one fleet frame per tick over the wire.

    Attach with `collector.add_sink(sink)`; detach + drain with
    `close()`. Loss is never silent: an unreachable aggregator sheds
    frames COUNTED on the sender (`tpu_handoff_sender.shed_frames`)
    and on this sink (`send_errors`).
    """

    def __init__(self, endpoint: tuple[str, int], exporter: FleetExporter,
                 *, sender=None, queue_capacity: int = 1 << 10):
        from ..ingest.handoff import HandoffSender

        self.exporter = exporter
        self._sender = sender if sender is not None else HandoffSender(
            {AGGREGATOR_PEER: endpoint}, queue_capacity=queue_capacity
        )
        self._lock = threading.Lock()
        self.counters = {"frames_sent": 0, "bytes_sent": 0, "send_errors": 0}
        self._stats_src = register_countable(
            "tpu_fleet_sink", self, host=exporter.host
        )

    def __call__(self, points) -> None:
        from ..ingest.handoff import HandoffUnreachable

        raw = self.exporter.encode(points=points)
        try:
            self._sender.send(AGGREGATOR_PEER, raw)
        except HandoffUnreachable:
            # the sender already counted the shed; keep a sink-local
            # error lane so the HOST's pane shows its own export health
            with self._lock:
                self.counters["send_errors"] += 1
            return
        with self._lock:
            self.counters["frames_sent"] += 1
            self.counters["bytes_sent"] += len(raw)

    def get_counters(self) -> dict[str, int]:
        with self._lock:
            out = dict(self.counters)
        out.update(
            {f"export_{k}": v for k, v in self.exporter.get_counters().items()}
        )
        return out

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Fence: every queued frame written to the aggregator's socket
        (tests pin merged state only after this returns True)."""
        return self._sender.flush(timeout_s)

    def close(self, drain_timeout_s: float = 5.0) -> None:
        from ..utils.stats import default_collector

        self._sender.close(drain_timeout_s)
        default_collector.deregister(self._stats_src)
