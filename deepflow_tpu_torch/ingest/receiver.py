"""Telemetry receiver — the server's front door (TCP+UDP :20033 analog).
Port copy of deepflow_tpu/ingest/receiver.py.

Re-creates `server/libs/receiver/receiver.go` semantics the TPU-host way:
one TCP listener + one UDP socket, a per-message-type handler registry
(`register_handler`, receiver.go:444), org/team/agent identity parsed from
the 19-byte flow header (:631-700), per-agent liveness/status tracking,
and hash fanout into the handler's N overwrite queues (:515-585) keyed by
agent id so one agent's stream stays ordered within a queue.

Queue items are the *raw frame* (header + body): self-contained bytes so
the native C++ ring can carry them and any worker can re-parse identity
without shared state.
"""

from __future__ import annotations

import socket
import threading
import time
import zlib

from .framing import (
    ENCODER_RAW,
    HEADER_LEN,
    FlowHeader,
    FrameReassembler,
    MessageType,
    decompress_body,
)


class AgentStatus:
    __slots__ = ("agent_id", "org_id", "team_id", "addr", "first_seen",
                 "last_seen", "frames", "bytes", "route")

    def __init__(self, agent_id, org_id, team_id, addr):
        self.agent_id = agent_id
        self.org_id = org_id
        self.team_id = team_id
        self.addr = addr
        self.first_seen = self.last_seen = time.time()
        self.frames = 0
        self.bytes = 0
        # key-hash routing cache: the (org, agent) → group
        # map is pure, so it is computed once per agent per topology
        # epoch instead of a numpy fingerprint fold per FRAME. ONE
        # (epoch, group) tuple — epoch and group are never split
        # across two stores, so a re-attach race cannot stamp a
        # new-topology group with an old epoch
        self.route: tuple | None = None


class Receiver:
    """Framed TCP/UDP intake with per-msg-type queue fanout."""

    def __init__(self, host: str = "127.0.0.1", tcp_port: int = 0, udp_port: int = 0,
                 *, held_frames_cap: int = 256):
        self.host = host
        self.tcp_port = tcp_port
        self.udp_port = udp_port
        # msg_type → {shard_group_or_None: [queues]} — the None slot is
        # the ungrouped handler every pre-topology caller registers
        self._handlers: dict[int, dict] = {}
        self._threads: list[threading.Thread] = []
        self._conn_threads: list[threading.Thread] = []
        self._stats_lock = threading.Lock()
        self._tcp_sock: socket.socket | None = None
        self._udp_sock: socket.socket | None = None
        self._conns: set[socket.socket] = set()
        self._lock = threading.Lock()
        self._running = False
        self.agents: dict[tuple[int, int], AgentStatus] = {}  # (org, agent) → status
        self.counters = {
            "rx_frames": 0,
            "rx_bytes": 0,
            "bad_frames": 0,
            "no_handler": 0,
            "queue_closed": 0,
            "udp_frames": 0,
            "tcp_conns": 0,
            # key-hash fan-in routing: frames whose shard
            # group another process owns — counted and forwarded
            # through the control-plane handoff, NEVER enqueued into a
            # wrong-group handler (the data path never crosses hosts)
            "frames_misrouted": 0,
            "frames_handoff": 0,
            "handoff_errors": 0,
            # epoch-flip hold buffer: frames for a group
            # this process owns in the NEW epoch but whose handler is
            # still mid-restore are held-and-redelivered, never counted
            # as misroutes against a peer that no longer owns them;
            # overflow sheds the OLDEST held frame, counted
            "frames_held": 0,
            "frames_held_dropped": 0,
            "frames_redelivered": 0,
        }
        # bounded (msg_type, group, raw_frame, addr) hold ring — sized
        # for the re-route window of one rebalance, not a durability
        # buffer (the journal is; this only bridges the flip)
        self._held_cap = int(held_frames_cap)
        self._held: list = []
        # serializes whole redelivery PASSES (the swap is under
        # _stats_lock, but routing the swapped batch happens outside
        # it — two concurrent passes could interleave one agent's
        # frames out of arrival order)
        self._redeliver_mutex = threading.Lock()
        # multi-host fan-in: key-hash topology routing +
        # the control-plane forward for misrouted frames, published as
        # ONE immutable (topology, handoff, epoch) tuple so a dispatch
        # thread racing a re-attach can never pair the new topology
        # with a stale per-agent cached group (the epoch invalidates
        # those caches, and it travels WITH the topology it stamps)
        self._routing: tuple | None = None
        self._route_epoch = 0
        self._queue_stat_sources: list = []
        # misroute/drop visibility in deepflow_system: the receiver is
        # a Countable like the queues it fans into
        from ..utils.stats import register_countable

        self._stats_src = register_countable("tpu_receiver", self)
        # window lineage plane: when a LineageTracker is
        # attached, every frame admitted into a handler queue leaves a
        # wall stamp — the feeder pairs stamps to frames FIFO, so the
        # receiver.admit hop opens a window's trace without any header
        # field on the wire
        self.lineage = None

    def agent_list(self) -> list[AgentStatus]:
        """Snapshot for observers (REST/debug) — .agents mutates under
        _stats_lock on every dispatched frame."""
        with self._stats_lock:
            return list(self.agents.values())

    def get_counters(self) -> dict:
        """Countable face (→ deepflow_system as tpu_receiver_*): frame/
        byte totals, drop classes, and the fan-in routing lanes."""
        with self._stats_lock:
            out = dict(self.counters)
            out["agents_seen"] = len(self.agents)
        return out

    # -- key-hash fan-in routing ------------------------------
    @property
    def routing(self):
        """The published (topology, handoff, epoch) tuple, or None
        before any attach — the rebalance rollback reads the pre-flip
        handoff from here so an aborted move restores forwarding."""
        return self._routing

    def attach_topology(self, topology, handoff=None) -> None:
        """Route agents to shard groups by key-hash (MeshTopology.
        group_for_agent over the packed identity words). Frames of
        locally-owned groups enqueue into that group's handler queues;
        misrouted frames are counted (`frames_misrouted`) and forwarded
        through `handoff(group, raw_frame)` — the control-plane path to
        the owning host (e.g. a UniformSender), guarded and counted.
        With no handoff attached misroutes are counted drops: silently
        feeding a wrong-group pipeline would split one agent's keys
        across two exact stashes.

        Routing applies PER MESSAGE TYPE, and only to types with at
        least one group-registered handler — lanes whose handlers are
        all ungrouped (METRICS, SYSLOG, ...) keep delivering every
        agent's frames locally, sharded-plane topology or not.

        Re-attaching publishes a new epoch (rebalance flip):
        per-agent route caches invalidate, and any held frames re-route
        under the new table — a frame held for a group this process
        just stopped owning forwards instead of rotting in the hold."""
        self._route_epoch += 1
        # single atomic publish: dispatch threads read the tuple once
        self._routing = (topology, handoff, self._route_epoch)
        self._redeliver_held()

    # -- registry (receiver.go:444 RegistHandler) -----------------------
    def register_handler(self, msg_type: MessageType, queues: list,
                         *, shard_group: int | None = None) -> None:
        """Register a handler's queue fanout; `shard_group` pins the
        queues to one key-hash group (one handler per owned group —
        the fan-in shape). Ungrouped registration (None) stays
        the fallback for every group this process owns."""
        if not queues:
            raise ValueError("need at least one queue")
        self._handlers.setdefault(int(msg_type), {})[shard_group] = list(queues)
        # surface each queue's depth/overrun counters on the default
        # stats collector — overwrite drops were previously invisible
        # unless an owner polled .overwritten
        from .queues import register_queue_stats

        tags = {"msg_type": str(int(msg_type))}
        if shard_group is not None:
            tags["group"] = str(shard_group)
        self._queue_stat_sources += register_queue_stats(
            "ingest_queue", queues, **tags
        )
        # epoch-flip hold: frames that arrived for this
        # group while its handler was mid-restore redeliver now, in
        # arrival order, ahead of anything the conn threads enqueue next
        self._redeliver_held()

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._running = True
        self._tcp_sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._tcp_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._tcp_sock.bind((self.host, self.tcp_port))
        self.tcp_port = self._tcp_sock.getsockname()[1]
        self._tcp_sock.listen(64)
        # timeouts on every blocking op: on Linux, close() does NOT wake a
        # thread blocked in accept()/recv(), which would keep the listening
        # socket alive (and the port EADDRINUSE) after stop()
        self._tcp_sock.settimeout(0.5)

        self._udp_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._udp_sock.bind((self.host, self.udp_port))
        self.udp_port = self._udp_sock.getsockname()[1]
        self._udp_sock.settimeout(0.5)

        for target in (self._accept_loop, self._udp_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._running = False
        from ..utils.stats import default_collector

        default_collector.deregister(self._stats_src)
        for s in (self._tcp_sock, self._udp_sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.close()
            except OSError:
                pass
        with self._lock:
            threads = self._threads + self._conn_threads
        for t in threads:
            t.join(timeout=2)

    # -- dispatch -------------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        # dict += is a non-atomic read-modify-write; conn threads + the UDP
        # thread all dispatch concurrently
        with self._stats_lock:
            self.counters[key] += n

    def _dispatch(self, header: FlowHeader, raw_frame: bytes, addr) -> None:
        if header.encoder != ENCODER_RAW:
            # decompress at the front door and re-frame raw, so every
            # downstream consumer keeps its encoder-oblivious parse
            try:
                body = decompress_body(raw_frame[HEADER_LEN:], header.encoder)
            except (ValueError, zlib.error):
                self._count("bad_frames")
                return
            header.encoder = ENCODER_RAW
            header.frame_size = HEADER_LEN + len(body)
            raw_frame = header.encode() + body
        key = (header.organization_id, header.agent_id)
        with self._stats_lock:
            self.counters["rx_frames"] += 1
            self.counters["rx_bytes"] += len(raw_frame)
            st = self.agents.get(key)
            if st is None:
                st = self.agents[key] = AgentStatus(
                    header.agent_id, header.organization_id, header.team_id, addr
                )
            st.last_seen = time.time()
            st.frames += 1
            st.bytes += len(raw_frame)
        self._route_frame(header, raw_frame, addr, st)

    def _route_frame(self, header: FlowHeader, raw_frame: bytes, addr,
                     st: "AgentStatus", *, from_hold: bool = False) -> bool:
        """Route one rx-accounted frame: key-hash topology routing,
        misroute handoff, the epoch-flip hold buffer, queue fanout.
        Shared by live dispatch and held-frame redelivery (which must
        not re-count rx). Returns False only when the frame was
        (re-)held."""
        groups = self._handlers.get(header.msg_type)
        if not groups:
            self._count("no_handler")
            return True
        routing = self._routing  # one read: (topology, handoff, epoch)
        group = None
        if routing is not None and any(k is not None for k in groups):
            topo, handoff, epoch = routing
            # key-hash fan-in: the agent's packed identity
            # words pick the shard group; only locally-owned frames may
            # enqueue — the data path never crosses hosts, so a frame
            # for a remote group forwards via the control-plane handoff.
            # Scope: ONLY message types with group-registered handlers
            # route — a lane whose handlers are all ungrouped serves
            # every agent locally regardless of the sharded topology.
            # The pure (org, agent) → group map is cached per agent
            # (st is this frame's AgentStatus from the stats block) as
            # ONE (epoch, group) tuple; pairing the epoch from the
            # SAME tuple as the topology guarantees the cache is never
            # read or written against a different attach.
            route = st.route
            if route is None or route[0] != epoch:
                route = (epoch, topo.group_for_agent(
                    header.organization_id, header.agent_id
                ))
                st.route = route
            group = route[1]
            if not topo.owns_group(group):
                self._count("frames_misrouted")
                if handoff is not None:
                    try:
                        handoff(group, raw_frame)
                        self._count("frames_handoff")
                    except Exception:
                        # the forward path must never raise into the
                        # conn/UDP loop; the drop is counted
                        self._count("handoff_errors")
                return True
        queues = groups.get(group)
        if queues is None and group is not None:
            queues = groups.get(None)
        if not queues:
            if group is not None:
                # epoch-flip hold: this process owns the
                # group in the CURRENT epoch but its handler is still
                # mid-restore — hold and redeliver at register_handler
                # instead of counting a misroute against a peer that no
                # longer owns the group (or dropping outright)
                self._hold_frame(raw_frame, addr, recount=not from_hold)
                if not from_hold:
                    # close the hold-vs-register race: if the handler
                    # (or a new epoch) landed between our registry read
                    # and the hold append, ITS redelivery pass has
                    # already drained — re-drain so this frame cannot
                    # strand in the hold until some future flip. The
                    # hold append and the registering thread's drain
                    # serialize on _stats_lock, so one of the two
                    # passes always sees the frame.
                    now = self._handlers.get(header.msg_type)
                    if self._routing is not routing or (
                        now is not None and now.get(group) is not None
                    ):
                        self._redeliver_held()
                return False
            self._count("no_handler")
            return True
        q = queues[header.agent_id % len(queues)]
        # a handler shutting down mid-stream closes its queues; frames
        # racing that close are counted and skipped — never raised into
        # the conn/UDP loop (which would tear down the whole connection
        # for every agent sharing it). put() returning False covers the
        # check-then-put race (queues.py); the pre-check stays as the
        # fast path and for queue impls whose put has no return signal.
        if getattr(q, "closed", False):
            self._count("queue_closed")
            return True
        try:
            if q.put(raw_frame) is False:
                self._count("queue_closed")
                return True
        except Exception:
            self._count("queue_closed")
            return True
        lin = self.lineage
        if lin is not None:
            lin.note_admit()
        return True

    # -- epoch-flip hold buffer -------------------------------
    def _hold_frame(self, raw_frame: bytes, addr, *,
                    recount: bool = True) -> None:
        """Bounded hold: overflow sheds the OLDEST held frame, counted
        (`frames_held_dropped`) — freshest-wins, the OverwriteQueue
        stance. Only (frame, addr) is held: redelivery re-parses the
        header and re-routes under the CURRENT table, never the
        held-time msg_type/group."""
        with self._stats_lock:
            self._held.append((raw_frame, addr))
            if recount:
                self.counters["frames_held"] += 1
            if len(self._held) > self._held_cap:
                self._held.pop(0)
                self.counters["frames_held_dropped"] += 1

    def _redeliver_held(self) -> None:
        """Re-route every held frame under the current handler registry
        and epoch (called after register_handler / attach_topology).
        Frames that still have no home re-hold without recounting;
        everything else leaves through its normal counted lane. The
        whole pass serializes on _redeliver_mutex: a second caller
        (conn thread closing the hold-vs-register race) blocks until
        the first batch has fully routed, so one agent's held frames
        always leave in arrival order."""
        with self._redeliver_mutex:
            with self._stats_lock:
                if not self._held:
                    return
                held, self._held = self._held, []
            for raw_frame, addr in held:
                try:
                    header = FlowHeader.parse(raw_frame[:HEADER_LEN])
                except ValueError:
                    self._count("bad_frames")
                    continue
                key = (header.organization_id, header.agent_id)
                with self._stats_lock:
                    st = self.agents.get(key)
                    if st is None:
                        st = self.agents[key] = AgentStatus(
                            header.agent_id, header.organization_id,
                            header.team_id, addr,
                        )
                if self._route_frame(header, raw_frame, addr, st,
                                     from_hold=True):
                    self._count("frames_redelivered")

    # -- TCP ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._tcp_sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(0.5)
            self._count("tcp_conns")
            with self._lock:
                self._conns.add(conn)
                # prune finished handler threads so a long-lived receiver
                # doesn't grow the list unboundedly
                self._conn_threads = [t for t in self._conn_threads if t.is_alive()]
            t = threading.Thread(target=self._conn_loop, args=(conn, addr), daemon=True)
            t.start()
            with self._lock:
                self._conn_threads.append(t)

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
                    self._dispatch(header, header.encode() + body, addr)
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

    # -- UDP (one frame per datagram, receiver.go UDP path) -------------
    def _udp_loop(self) -> None:
        while self._running:
            try:
                data, addr = self._udp_sock.recvfrom(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                return
            self._count("udp_frames")
            if len(data) < HEADER_LEN:
                self._count("bad_frames")
                continue
            try:
                header = FlowHeader.parse(data[:HEADER_LEN])
            except ValueError:
                self._count("bad_frames")
                continue
            if header.frame_size != len(data):
                self._count("bad_frames")
                continue
            self._dispatch(header, data, addr)
