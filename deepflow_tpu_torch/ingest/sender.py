"""UniformSender — the agent-side telemetry transport client.

Port copy of deepflow_tpu/ingest/sender.py.

Re-creates `agent/src/sender/uniform_sender.rs` behavior on the host:
batches encoded pb messages into framed TCP writes (header layout in
framing.py), flushes on size or interval, reconnects with exponential
backoff, and fails over across a server list (uniform_sender.rs:398-560).
Messages that cannot be shipped are shed oldest-first by the bounded
overwrite queue — same backpressure stance as the rest of the pipeline.
"""

from __future__ import annotations

import socket
import threading
import time

from ..utils.stats import register_countable
from .framing import (
    ENCODER_RAW,
    MAX_FRAME_SIZE,
    FlowHeader,
    MessageType,
    best_encoder,
    encode_frame,
)
from .queues import new_queue
from ..utils.retry import RetryPolicy, decorrelated_rng

# reconnect backoff: the shared capped-exponential-with-jitter policy
# (utils/retry.py), so a fleet of senders does not re-dial a
# recovering server in lockstep. attempts is irrelevant here
# — the reconnect loop is unbounded, only .delay() is used.
_RECONNECT = RetryPolicy(base_delay_s=0.05, max_delay_s=2.0, jitter=0.5)
_BACKOFF_CAP_ATTEMPT = 8  # delay saturates at max_delay_s well before this


class UniformSender:
    def __init__(
        self,
        servers: list[tuple[str, int]],
        msg_type: MessageType,
        *,
        agent_id: int = 1,
        team_id: int = 0,
        organization_id: int = 0,
        batch_bytes: int = 1 << 17,
        flush_interval: float = 0.2,
        queue_capacity: int = 1 << 14,
        prefer_native_queue: bool = True,
        compression: int | str = ENCODER_RAW,
    ):
        if not servers:
            raise ValueError("need at least one server")
        self.servers = list(servers)
        self.msg_type = MessageType(msg_type)
        # "auto" = strongest codec available in-process (framing.best_encoder)
        self.compression = best_encoder() if compression == "auto" else int(compression)
        self.agent_id = agent_id
        self.team_id = team_id
        self.organization_id = organization_id
        self.batch_bytes = min(batch_bytes, MAX_FRAME_SIZE // 2)
        self.flush_interval = flush_interval
        self._q = new_queue(queue_capacity, prefer_native=prefer_native_queue)
        self._sock: socket.socket | None = None
        self._server_idx = 0
        self._running = True
        self._reconnect_pending = False  # a loss happened; next connect is a re-connect
        self._retry_rng = decorrelated_rng(0x5E4DE2)
        self.counters = {
            "tx_frames": 0, "tx_bytes": 0, "tx_msgs": 0,
            "reconnects": 0, "reconnect_success": 0, "send_errors": 0,
            "shutdown_shed_msgs": 0,
        }
        # reconnect attempts/successes are queryable in deepflow_system
        # like every other component (weakly held — a dropped sender
        # deregisters itself)
        self._stats_src = register_countable(
            "tpu_sender", self, msg_type=self.msg_type.name
        )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- producer side --------------------------------------------------
    def send(self, msgs: list[bytes]) -> None:
        for m in msgs:
            self._q.put(m)

    @property
    def dropped(self) -> int:
        return self._q.overwritten

    def get_counters(self) -> dict:
        """Countable face (utils/stats.StatsCollector)."""
        out = dict(self.counters)
        out["dropped"] = int(self._q.overwritten)
        out["queue_depth"] = len(self._q)
        out["connected"] = int(self._sock is not None)
        return out

    def close(self, drain_timeout: float = 5.0) -> None:
        deadline = time.time() + drain_timeout
        while len(self._q) and time.time() < deadline:
            time.sleep(0.02)
        self._running = False
        self._q.close()
        self._thread.join(timeout=drain_timeout)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    # -- sender thread ---------------------------------------------------
    def _connect(self) -> bool:
        """Try each server once, starting from the current; True on success."""
        for i in range(len(self.servers)):
            host, port = self.servers[(self._server_idx + i) % len(self.servers)]
            try:
                s = socket.create_connection((host, port), timeout=5)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                self._sock = s
                self._server_idx = (self._server_idx + i) % len(self.servers)
                if self._reconnect_pending:
                    self.counters["reconnect_success"] += 1
                    self._reconnect_pending = False
                return True
            except OSError:
                continue
        return False

    def _frame(self, msgs: list[bytes]) -> bytes:
        header = FlowHeader(
            msg_type=int(self.msg_type),
            agent_id=self.agent_id,
            team_id=self.team_id,
            organization_id=self.organization_id,
        )
        # encode_frame enforces MAX_FRAME_SIZE — a frame that encodes is
        # always accepted by the receiver's reassembler
        return encode_frame(header, msgs, encoder=self.compression)

    def _run(self) -> None:
        attempt = 1  # consecutive connect/send failures (drives backoff)
        pending: list[bytes] = []
        pending_bytes = 0
        last_flush = time.monotonic()
        while self._running or pending or len(self._q):
            if not pending:
                got = self._q.gets(256, timeout_ms=50)
                if not got and not self._running:
                    return
                for m in got:
                    pending.append(m)
                    pending_bytes += len(m) + 4
            elif pending_bytes < self.batch_bytes and self._running:
                # accumulate until flush deadline — wait on the queue for
                # the remaining window instead of spinning
                remaining = self.flush_interval - (time.monotonic() - last_flush)
                if remaining > 0:
                    for m in self._q.gets(256, timeout_ms=max(1, int(remaining * 1000))):
                        pending.append(m)
                        pending_bytes += len(m) + 4
            now = time.monotonic()
            if pending and (pending_bytes >= self.batch_bytes or now - last_flush >= self.flush_interval or not self._running):
                if self._sock is None and not self._connect():
                    self.counters["send_errors"] += 1
                    if not self._running:
                        # shutdown with every server unreachable: shed
                        # the pending buffer (and whatever close() left
                        # in the queue) instead of spinning the thread
                        # forever — counted, like every other shed lane
                        self.counters["shutdown_shed_msgs"] += (
                            len(pending) + len(self._q)
                        )
                        return
                    time.sleep(_RECONNECT.delay(attempt, self._retry_rng))
                    attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)
                    continue
                try:
                    # chunk so no frame exceeds batch_bytes (≤ MAX_FRAME_SIZE/2)
                    while pending:
                        chunk, sz = [], 0
                        while pending and (not chunk or sz + len(pending[0]) + 4 <= self.batch_bytes):
                            m = pending.pop(0)
                            chunk.append(m)
                            sz += len(m) + 4
                        try:
                            frame = self._frame(chunk)
                        except ValueError:
                            # a single message too large for any frame — drop
                            self.counters["send_errors"] += 1
                            continue
                        self._sock.sendall(frame)
                        self.counters["tx_frames"] += 1
                        self.counters["tx_bytes"] += len(frame)
                        self.counters["tx_msgs"] += len(chunk)
                    pending_bytes = 0
                    last_flush = now
                    attempt = 1
                except OSError:
                    # requeue the in-flight chunk: the overwrite queue is
                    # the only place messages may be shed (at-least-once
                    # across reconnects, like the reference's resend of
                    # its current buffer)
                    pending = chunk + pending
                    pending_bytes = sum(len(m) + 4 for m in pending)
                    self.counters["send_errors"] += 1
                    self.counters["reconnects"] += 1
                    self._reconnect_pending = True
                    try:
                        self._sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    self._server_idx = (self._server_idx + 1) % len(self.servers)
                    time.sleep(_RECONNECT.delay(attempt, self._retry_rng))
                    attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)
