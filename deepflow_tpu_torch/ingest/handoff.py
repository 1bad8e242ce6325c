"""Misroute-handoff transport — the real wire behind the receiver's
control-plane forward (port of deepflow_tpu/ingest/handoff.py; plain
Python, no device work).

The receiver's key-hash fan-in counts misrouted frames and hands them
to a callback seam; this module makes that seam a socket. The reference
ships the same move as agent→analyzer reassignment: while the
controller re-routes agents, in-flight traffic for a moved shard group
keeps arriving at the old host, and the old host forwards it to the
owner instead of dropping it. Design:

  * `HandoffSender` — one bounded overwrite queue + one framed-TCP
    writer thread PER PEER, built on the same retry/backoff machinery
    as `UniformSender` (shared `RetryPolicy`, decorrelated jitter,
    capped exponential reconnect). Frames travel VERBATIM: they are
    already framed on the codec lanes with the originating agent's
    identity in the header, so the receiving end's normal parse path
    needs zero new wire format. Loss is never silent: an unreachable
    or unknown peer sheds frames counted (`shed_frames` — the bounded
    queue's oldest-first overwrite plus the shutdown shed), and the
    `handoff.send` chaos seam scripts transport faults per write for
    deterministic CI replay.
  * `HandoffReceiver` — a dedicated listener that feeds reassembled
    frames into an existing `Receiver`'s dispatch (routing, held-frame
    buffering and queue fanout are shared with the agent front door),
    while keeping its own rx counters so handoff traffic is separately
    attributable (`tpu_handoff_*` in deepflow_system).

Peers discover each other out of band (the controller knows every
host's handoff endpoint; tests exchange a port file).
"""

from __future__ import annotations

import socket
import threading
import time

from .. import chaos
from ..utils.retry import RetryPolicy, decorrelated_rng
from ..utils.stats import register_countable
from .framing import FrameReassembler
from .queues import PyOverwriteQueue

# reconnect backoff: the UniformSender stance — shared capped
# exponential with jitter so a fleet of forwarding hosts does not
# re-dial a recovering peer in lockstep
_RECONNECT = RetryPolicy(base_delay_s=0.05, max_delay_s=2.0, jitter=0.5)
_BACKOFF_CAP_ATTEMPT = 8


class HandoffUnreachable(Exception):
    """Raised into the receiver's guarded handoff callback when a frame
    cannot even be queued (unknown peer / sender closed) — the receiver
    counts it (`handoff_errors`), the sender counts the shed."""


class _Peer:
    __slots__ = ("addr", "queue", "thread", "inflight", "sock", "lock")

    def __init__(self, addr, capacity):
        self.addr = addr
        self.queue = PyOverwriteQueue(capacity)
        self.thread = None
        self.inflight = 0  # frames popped but not yet written (≤1)
        self.sock = None
        # guards the (queue, inflight) PAIR: the writer's pop and
        # inflight-mark must be one step against flush()'s drained
        # check, and a producer's put + overwritten-diff must be one
        # step against a concurrent producer (conn + UDP threads can
        # forward into the same peer)
        self.lock = threading.Lock()


class HandoffSender:
    """Forward raw wire frames to owning peers, at-least-once across
    reconnects, counted shed when a peer stays unreachable."""

    def __init__(self, peers: dict[int, tuple[str, int]], *,
                 queue_capacity: int = 1 << 12,
                 connect_timeout_s: float = 5.0):
        self._peers = {
            int(p): _Peer((host, int(port)), queue_capacity)
            for p, (host, port) in peers.items()
        }
        self.connect_timeout_s = connect_timeout_s
        self._running = True
        self._lock = threading.Lock()
        self._rng = decorrelated_rng(0x4F48)  # 'HO'
        self.counters = {
            "tx_frames": 0, "tx_bytes": 0, "send_errors": 0,
            "reconnects": 0, "reconnect_success": 0,
            "shed_frames": 0,
        }
        self._stats_src = register_countable("tpu_handoff_sender", self)
        for peer in self._peers.values():
            peer.thread = threading.Thread(
                target=self._run_peer, args=(peer,), daemon=True
            )
            peer.thread.start()

    # -- producer side ---------------------------------------------------
    def send(self, process_index: int, raw_frame: bytes) -> None:
        """Queue one frame for `process_index`. Raises
        HandoffUnreachable (after counting the shed) when the peer is
        unknown or the sender is closed — the receiver's handoff guard
        turns that into its own counted error lane."""
        peer = self._peers.get(int(process_index))
        if peer is None or not self._running:
            self._count("shed_frames")
            raise HandoffUnreachable(
                f"no handoff peer for process {process_index} "
                f"(known: {sorted(self._peers)}, running={self._running})"
            )
        with peer.lock:
            before = peer.queue.overwritten
            accepted = peer.queue.put(raw_frame)
            dropped = peer.queue.overwritten - before
        if not accepted:
            # put() returns False on a closed queue — a send racing
            # close() past the _running check above. The frame was NOT
            # accepted: count it and surface unreachable, same as the
            # pre-check path (loss is never silent).
            self._count("shed_frames")
            raise HandoffUnreachable(
                f"handoff peer {process_index} closed mid-send"
            )
        if dropped:
            # bounded-queue overwrite: the peer is too far behind —
            # oldest frames shed whole, counted (never silent)
            self._count("shed_frames", dropped)

    def route(self, topology):
        """→ the `Receiver.attach_topology(handoff=...)` callback for
        `topology`: group → owning process → send. Bind a NEW callback
        at every epoch flip so the routing table always matches the
        topology the receiver dispatches under."""
        def forward(group: int, raw_frame: bytes) -> None:
            self.send(topology.group_process(group), raw_frame)
        return forward

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["queue_depth"] = sum(len(p.queue) for p in self._peers.values())
        out["peers"] = len(self._peers)
        out["connected"] = sum(
            1 for p in self._peers.values() if p.sock is not None
        )
        return out

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    @staticmethod
    def _drained(peer: _Peer) -> bool:
        # under peer.lock: pairs with _pop, so a frame can never be
        # invisible to BOTH len(queue) and inflight
        with peer.lock:
            return len(peer.queue) == 0 and peer.inflight == 0

    def flush(self, timeout_s: float = 30.0) -> bool:
        """Block until every queued frame has been WRITTEN to its
        peer's socket (or timeout). Drivers use this as the
        step-boundary fence: after flush, the bytes are in the kernel
        on their way — the receiving dispatch is the peer's business."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if all(self._drained(p) for p in self._peers.values()):
                return True
            time.sleep(0.002)
        return False

    def close(self, drain_timeout_s: float = 5.0) -> None:
        self.flush(drain_timeout_s)
        self._running = False
        for peer in self._peers.values():
            peer.queue.close()
        shed = 0
        for peer in self._peers.values():
            if peer.thread is not None:
                peer.thread.join(timeout=drain_timeout_s)
            # anything the writer thread left behind is a counted shed
            # (it already counted its own in-flight frame on exit)
            shed += len(peer.queue)
            if peer.sock is not None:
                try:
                    peer.sock.close()
                except OSError:
                    pass
        if shed:
            self._count("shed_frames", shed)
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)

    # -- per-peer writer thread ------------------------------------------
    def _connect(self, peer: _Peer) -> bool:
        try:
            s = socket.create_connection(
                peer.addr, timeout=self.connect_timeout_s
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer.sock = s
            return True
        except OSError:
            return False

    @staticmethod
    def _pop(peer: _Peer) -> bytes | None:
        """Pop-and-mark-in-flight as ONE step vs the flush() fence —
        a blocking gets() would empty the queue before inflight rises,
        letting flush observe a drained wire with a frame unsent."""
        with peer.lock:
            got = peer.queue.gets(1, timeout_ms=0)
            if not got:
                return None
            peer.inflight = 1
            return got[0]

    def _run_peer(self, peer: _Peer) -> None:
        attempt = 1
        pending: bytes | None = None
        while self._running or pending is not None or len(peer.queue):
            if pending is None:
                pending = self._pop(peer)
                if pending is None:
                    if not self._running:
                        return
                    time.sleep(0.005)  # idle poll (pop is non-blocking)
                    continue
            if peer.sock is None and not self._connect(peer):
                self._count("send_errors")
                if not self._running:
                    # shutdown with the peer unreachable: the in-flight
                    # frame is a counted shed (close() counts whatever
                    # is still queued), like every other loss lane
                    self._count("shed_frames", 1)
                    peer.inflight = 0
                    return
                time.sleep(_RECONNECT.delay(attempt, self._rng))
                attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)
                continue
            try:
                # THE chaos seam: scripted transport loss —
                # an injected fault here behaves exactly like a broken
                # pipe (reconnect + resend of the in-flight frame)
                chaos.maybe_fail(chaos.SITE_HANDOFF_SEND)
                peer.sock.sendall(pending)
                self._count("tx_frames")
                self._count("tx_bytes", len(pending))
                pending = None
                peer.inflight = 0
                attempt = 1
            except Exception:
                # at-least-once: the in-flight frame stays pending
                # across the reconnect (the bounded queue remains the
                # only shed point)
                self._count("send_errors")
                self._count("reconnects")
                try:
                    if peer.sock is not None:
                        peer.sock.close()
                except OSError:
                    pass
                peer.sock = None
                time.sleep(_RECONNECT.delay(attempt, self._rng))
                attempt = min(attempt + 1, _BACKOFF_CAP_ATTEMPT)


class HandoffReceiver:
    """Dedicated intake for forwarded frames: a TCP listener whose
    reassembled frames flow into an existing `Receiver`'s dispatch —
    same routing, same held-frame buffer, same queues — with separate
    rx accounting so handoff traffic is attributable on its own."""

    def __init__(self, receiver, host: str = "127.0.0.1", port: int = 0):
        self.receiver = receiver
        self.host = host
        self.port = port
        self._sock: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._running = False
        self.counters = {
            "rx_frames": 0, "rx_bytes": 0, "bad_frames": 0, "conns": 0,
        }
        self._stats_src = register_countable("tpu_handoff_receiver", self)

    def get_counters(self) -> dict:
        with self._lock:
            return dict(self.counters)

    def _count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self.counters[key] += n

    def endpoint(self) -> tuple[str, int]:
        """The (host, port) peers dial — advertise it to the fleet."""
        return (self.host, self.port)

    def start(self) -> None:
        self._running = True
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        self.port = s.getsockname()[1]
        s.listen(16)
        s.settimeout(0.5)  # close() does not wake accept() on Linux
        self._sock = s
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        for t in list(self._threads):
            t.join(timeout=2)

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.5)
            self._count("conns")
            with self._lock:
                self._conns.add(conn)
                self._threads = [t for t in self._threads if t.is_alive()]
            t = threading.Thread(
                target=self._conn_loop, args=(conn, addr), daemon=True
            )
            t.start()
            with self._lock:
                self._threads.append(t)

    def _conn_loop(self, conn: socket.socket, addr) -> None:
        asm = FrameReassembler()
        seen_bad = 0
        try:
            while self._running:
                try:
                    chunk = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                if not chunk:
                    return
                for header, body in asm.feed(chunk):
                    raw = header.encode() + body
                    # into the SHARED dispatch: routing (under the
                    # receiver's current epoch), held-frame buffering
                    # and queue fanout are one code path for agent and
                    # handoff traffic alike. Counters move AFTER the
                    # dispatch returns so `rx_frames == N` means N
                    # frames are fully delivered (enqueued/held) — the
                    # fence drivers poll at a step boundary
                    self.receiver._dispatch(header, raw, addr)
                    self._count("rx_frames")
                    self._count("rx_bytes", len(raw))
                if asm.bad_frames != seen_bad:
                    self._count("bad_frames", asm.bad_frames - seen_bad)
                    seen_bad = asm.bad_frames
        except OSError:
            return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
