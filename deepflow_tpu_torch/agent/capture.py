"""Live packet capture — the dispatcher's AF_PACKET seat.

Port copy of deepflow_tpu/agent/capture.py.

The reference's recv_engine captures via AF_PACKET/af-xdp ring maps
(agent/src/dispatcher/recv_engine/af_packet). This build keeps the
same seat with a plain AF_PACKET SOCK_RAW socket: frames accumulate
into the fixed [N, snap] u8 batches the vectorized parser consumes and
ship to `Agent.step` on size or time. No ring mmap — the vectorized
batch parse downstream is where this design spends its complexity
budget; the capture loop just moves bytes.

Root/CAP_NET_RAW required (same as the reference's dispatcher).
"""

from __future__ import annotations

import socket
import time

import numpy as np

ETH_P_ALL = 0x0003


class AfPacketCapture:
    def __init__(self, interface: str = "lo", *, snap: int = 192,
                 batch_size: int = 4096, flush_ms: int = 200):
        self.interface = interface
        self.snap = snap
        self.batch_size = batch_size
        self.flush_ms = flush_ms
        self._sock = socket.socket(
            socket.AF_PACKET, socket.SOCK_RAW, socket.htons(ETH_P_ALL)
        )
        self._sock.bind((interface, 0))
        self._sock.settimeout(0.05)
        self.counters = {"frames": 0, "bytes": 0, "truncated": 0}
        self._running = True

    def close(self) -> None:
        self._running = False
        try:
            self._sock.close()
        except OSError:
            pass

    def batches(self, *, duration_s: float | None = None):
        """Yield (buf [N, snap] u8, lengths, ts_s, ts_us) batches until
        closed (or for `duration_s`). Partial batches flush on the
        flush_ms deadline so quiet interfaces still make progress."""
        deadline = None if duration_s is None else time.time() + duration_s
        frames: list[tuple[bytes, int]] = []  # (snap-truncated bytes, wire len)
        stamps: list[float] = []
        flush_at = time.time() + self.flush_ms / 1e3
        while self._running and (deadline is None or time.time() < deadline):
            try:
                data = self._sock.recv(1 << 16)
                now = time.time()
                self.counters["frames"] += 1
                self.counters["bytes"] += len(data)
                if len(data) > self.snap:
                    self.counters["truncated"] += 1
                # keep the ORIGINAL length: packet_len feeds flow byte
                # meters; the snap only bounds parse bytes (to_batch
                # makes the same distinction for replay — not reused
                # here because it needs full frames retained, and a live
                # source must bound buffered bytes at snap per frame)
                if not frames:
                    # arm the deadline from the FIRST frame of a batch,
                    # or an idle gap longer than flush_ms would flush
                    # every subsequent packet as its own 1-frame batch
                    flush_at = now + self.flush_ms / 1e3
                frames.append((data[: self.snap], len(data)))
                stamps.append(now)
            except socket.timeout:
                pass
            except OSError:
                break  # still flush what was captured before the error
            if frames and (len(frames) >= self.batch_size or time.time() >= flush_at):
                yield self._pack(frames, stamps)
                frames, stamps = [], []
        if frames:
            yield self._pack(frames, stamps)

    def _pack(self, frames: list[tuple[bytes, int]], stamps: list[float]):
        return _pack_frames(self.snap, frames, stamps)


def _pack_frames(snap: int, frames: list[tuple[bytes, int]], stamps: list[float]):
    n = len(frames)
    buf = np.zeros((n, snap), np.uint8)
    lengths = np.zeros((n,), np.uint32)
    for i, (fr, wire_len) in enumerate(frames):
        buf[i, : len(fr)] = np.frombuffer(fr, np.uint8)
        lengths[i] = wire_len
    ts = np.asarray(stamps)
    ts_s = ts.astype(np.uint32)
    ts_us = ((ts - ts_s) * 1e6).astype(np.uint32)
    return buf, lengths, ts_s, ts_us


# ---------------------------------------------------------------------------
# TPACKET_V3 ring capture — the reference's af_packet recv_engine
# (dispatcher/recv_engine/af_packet/tpacket.rs): the kernel writes
# frames into an mmap'd block ring and hands whole blocks to userspace,
# amortizing the syscall per BLOCK instead of per packet. Pure
# socket+mmap+struct — no libpcap.

import mmap as _mmap
import select as _select
import struct as _struct

SOL_PACKET = 263
PACKET_RX_RING = 5
PACKET_VERSION = 10
TPACKET_V3 = 2
TP_STATUS_KERNEL = 0
TP_STATUS_USER = 1


class AfPacketRingCapture:
    """Block-ring flavor of AfPacketCapture (same batches() shape).

    Ring geometry follows the reference's defaults scaled down: block
    retirement (`retire_ms`) bounds latency on quiet links the way
    flush_ms does for the plain socket."""

    def __init__(self, interface: str = "lo", *, snap: int = 192,
                 batch_size: int = 4096, block_size: int = 1 << 18,
                 block_count: int = 8, retire_ms: int = 100):
        self.interface = interface
        self.snap = snap
        self.batch_size = batch_size
        self.block_size = block_size
        self.block_count = block_count
        self._sock = socket.socket(
            socket.AF_PACKET, socket.SOCK_RAW, socket.htons(ETH_P_ALL)
        )
        self._sock.setsockopt(SOL_PACKET, PACKET_VERSION, TPACKET_V3)
        # tpacket_req3: block_size, block_nr, frame_size, frame_nr,
        # retire_blk_tov, sizeof_priv, feature_req_word
        frame_size = 1 << 11
        req = _struct.pack(
            "IIIIIII", block_size, block_count, frame_size,
            block_size // frame_size * block_count, retire_ms, 0, 0,
        )
        self._sock.setsockopt(SOL_PACKET, PACKET_RX_RING, req)
        self._sock.bind((interface, 0))
        self._ring = _mmap.mmap(
            self._sock.fileno(), block_size * block_count,
            _mmap.MAP_SHARED, _mmap.PROT_READ | _mmap.PROT_WRITE,
        )
        self._next_block = 0
        self.counters = {"frames": 0, "bytes": 0, "truncated": 0, "blocks": 0}
        self._running = True

    def close(self) -> None:
        self._running = False
        try:
            self._ring.close()
        except (OSError, ValueError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass

    # -- block walk ------------------------------------------------------
    def _drain_block(self, frames: list, stamps: list) -> bool:
        """Consume the next ring block if the kernel released it."""
        base = self._next_block * self.block_size
        ring = self._ring
        # tpacket_block_desc: version, offset_to_priv, then
        # tpacket_hdr_v1 {block_status, num_pkts, offset_to_first_pkt,…}
        status, = _struct.unpack_from("I", ring, base + 8)
        if not status & TP_STATUS_USER:
            return False
        num_pkts, first_off = _struct.unpack_from("II", ring, base + 12)
        off = base + first_off
        for _ in range(num_pkts):
            (next_off, tp_sec, tp_nsec, tp_snaplen, tp_len, _tp_status,
             tp_mac) = _struct.unpack_from("IIIIIIH", ring, off)
            data = bytes(ring[off + tp_mac: off + tp_mac + min(tp_snaplen, self.snap)])
            self.counters["frames"] += 1
            self.counters["bytes"] += tp_len
            if tp_snaplen > self.snap:
                self.counters["truncated"] += 1
            frames.append((data, tp_len))
            stamps.append(tp_sec + tp_nsec / 1e9)
            if not next_off:
                break
            off += next_off
        # release the block back to the kernel
        _struct.pack_into("I", ring, base + 8, TP_STATUS_KERNEL)
        self._next_block = (self._next_block + 1) % self.block_count
        self.counters["blocks"] += 1
        return True

    def batches(self, *, duration_s: float | None = None):
        """Yield (buf [N, snap] u8, lengths, ts_s, ts_us) batches —
        one per retired ring block group (same contract as
        AfPacketCapture.batches)."""
        deadline = None if duration_s is None else time.time() + duration_s
        frames: list[tuple[bytes, int]] = []
        stamps: list[float] = []
        poll = _select.poll()
        poll.register(self._sock.fileno(), _select.POLLIN)
        while self._running and (deadline is None or time.time() < deadline):
            drained = False
            try:
                while self._drain_block(frames, stamps):
                    drained = True
                    if len(frames) >= self.batch_size:
                        break
            except (OSError, ValueError):
                break  # concurrent close(): flush what was drained
            if drained and frames:
                # a block can hold more than batch_size packets — the
                # downstream batch parser has a fixed shape, so yield
                # in batch_size slices
                for i in range(0, len(frames), self.batch_size):
                    yield _pack_frames(
                        self.snap, frames[i:i + self.batch_size],
                        stamps[i:i + self.batch_size],
                    )
                frames, stamps = [], []
                continue
            if not drained:
                try:
                    poll.poll(50)  # retire_blk_tov bounds the wait
                except OSError:
                    break
        # reachable only via the break paths (mid-drain close)
        for i in range(0, len(frames), self.batch_size):
            yield _pack_frames(
                self.snap, frames[i:i + self.batch_size],
                stamps[i:i + self.batch_size],
            )
