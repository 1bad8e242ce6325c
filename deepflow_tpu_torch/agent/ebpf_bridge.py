"""eBPF socket-data bridge — the ebpf_dispatcher seat.

Port copy of deepflow_tpu/agent/ebpf_bridge.py.

The reference's eBPF plane captures syscall-level socket payloads in
kernel C (socket_trace.bpf.c), and `ebpf_dispatcher.rs` synthesizes
MetaPackets from them so the same FlowMap/L7 machinery processes kernel
events and wire packets alike — with SignalSource::EBPF, which the L4
metric plane skips (quadruple_generator.rs:420-423; our fanout gate).

Kernel eBPF itself cannot exist in this container; this module is the
*userspace half*: it accepts socket-data events (the fields the
reference's tracer emits per syscall: pid, 5-tuple, direction, capture
sequence, payload bytes, µs timestamp) and synthesizes the [N, SNAP]
buffer + PacketBatch the L7Engine consumes — payloads enter protocol
inference/parsing exactly like wire capture, but rows carry no L4
meters and are tagged SignalSource.EBPF downstream.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..datamodel.code import SignalSource
from .packet import PacketBatch


@dataclasses.dataclass
class SocketDataEvent:
    """One eBPF socket read/write capture (socket_trace.bpf.c output)."""

    pid: int
    ip_src: int  # IPv4 u32 (local side)
    ip_dst: int
    port_src: int
    port_dst: int
    protocol: int  # 6 tcp / 17 udp
    direction: int  # 0 egress (write/send), 1 ingress (read/recv)
    payload: bytes
    timestamp_us: int
    cap_seq: int = 0  # tracer capture sequence (ordering)


def events_to_batch(
    events: list[SocketDataEvent], snap: int = 1 << 10
) -> tuple[np.ndarray, PacketBatch]:
    """Socket events → (payload buffer, PacketBatch) for L7Engine.process.

    The synthesized rows look like payload-bearing packets with zero L2/
    L3 headroom: payload_off=0, payload in the buffer row, 5-tuple from
    the socket (ingress events swap src/dst so the tuple is always the
    sender's view, like the reference's MetaPacket synthesis).
    """
    events = sorted(events, key=lambda e: (e.timestamp_us, e.cap_seq))
    n = len(events)
    buf = np.zeros((n, snap), np.uint8)
    z = np.zeros(n, np.uint32)
    ip_src = np.zeros((n, 4), np.uint32)
    ip_dst = np.zeros((n, 4), np.uint32)
    sport = np.zeros(n, np.uint32)
    dport = np.zeros(n, np.uint32)
    proto = np.zeros(n, np.uint32)
    plen = np.zeros(n, np.uint32)
    ts_s = np.zeros(n, np.uint32)
    ts_us = np.zeros(n, np.uint32)
    for i, e in enumerate(events):
        pl = e.payload[:snap]
        buf[i, : len(pl)] = np.frombuffer(pl, np.uint8)
        plen[i] = len(pl)
        src, dst = (e.ip_src, e.ip_dst), (e.port_src, e.port_dst)
        if e.direction == 1:  # ingress: sender is the remote side
            ip_src[i, 3], ip_dst[i, 3] = e.ip_dst, e.ip_src
            sport[i], dport[i] = e.port_dst, e.port_src
        else:
            ip_src[i, 3], ip_dst[i, 3] = e.ip_src, e.ip_dst
            sport[i], dport[i] = e.port_src, e.port_dst
        proto[i] = e.protocol
        ts_s[i] = e.timestamp_us // 1_000_000
        ts_us[i] = e.timestamp_us % 1_000_000
    p = PacketBatch(
        timestamp_s=ts_s,
        timestamp_us=ts_us,
        is_ipv6=z.copy(),
        ip_src=ip_src,
        ip_dst=ip_dst,
        port_src=sport,
        port_dst=dport,
        protocol=proto,
        tcp_flags=z.copy(),
        seq=z.copy(),
        ack=z.copy(),
        payload_len=plen,
        payload_off=z.copy(),
        packet_len=plen.copy(),
        tunnel_type=z.copy(),
        valid=np.ones(n, bool),
    )
    return buf, p


class EbpfDispatcher:
    """Feeds socket events into an L7Engine; emitted rows are re-tagged
    SignalSource.EBPF on both the log ints and the AppMeter tags (the
    fanout gate then keeps them off the L4 metric plane)."""

    def __init__(self, l7_engine):
        self.l7 = l7_engine
        self.counters = {"events_in": 0, "sessions_out": 0}

    def process(self, events: list[SocketDataEvent]):
        from ..flowlog.schema import L7_FLOW_LOG

        self.counters["events_in"] += len(events)
        buf, p = events_to_batch(events)
        log_batch, app_batch = self.l7.process(buf, p)
        sig = int(SignalSource.EBPF)
        if log_batch.size:
            log_batch.ints[:, L7_FLOW_LOG.int_index("signal_source")] = sig
        if app_batch.valid.any():
            app_batch.tags["signal_source"][:] = sig
        self.counters["sessions_out"] += log_batch.size
        return log_batch, app_batch


@dataclasses.dataclass
class PerfStackSample:
    """One perf/on-CPU stack capture (perf_profiler.c ring output):
    raw user-space return addresses, leaf first."""

    pid: int
    stack: list  # of int addresses
    weight: int = 1  # sample count (or off-CPU µs, etc.)


class ContinuousProfiler:
    """The perf_profiler.c userspace loop: raw stack samples →
    symbolized folded aggregation per window → PROFILE frames through
    the given sender (the same wire shape the /api/v1/profile HTTP
    intake ships, so the server's flame plane needs nothing new)."""

    def __init__(self, sender=None, *, app_service: str = "",
                 event_type: str = "cpu", interval_s: float = 10.0):
        from .symbolizer import ProfileAggregator

        self.agg = ProfileAggregator(
            app_service=app_service, event_type=event_type
        )
        self.sender = sender
        self.interval_s = interval_s
        self._last_flush = 0.0
        self.counters = {"frames_sent": 0}

    def observe(self, samples: list[PerfStackSample]) -> None:
        for s in samples:
            self.agg.observe(s.pid, s.stack, s.weight)

    def maybe_flush(self, now: float, timestamp: int | None = None) -> bytes | None:
        """Interval-driven flush for poll loops: emits only when
        `interval_s` elapsed since the last frame."""
        if now - self._last_flush < self.interval_s:
            return None
        self._last_flush = now
        return self.flush(int(timestamp if timestamp is not None else now))

    def flush(self, timestamp: int) -> bytes | None:
        frame = self.agg.flush(timestamp)
        if frame is not None and self.sender is not None:
            self.sender.send(frame)
            self.counters["frames_sent"] += 1
        return frame
