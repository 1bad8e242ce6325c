"""Bounded on-disk frame journal — the crash-safety twin of the
window-state checkpoint (port copy of deepflow_tpu/feeder/journal.py;
the file format is the same, so a journal written by either package
replays in the other).

The reference survives ingester restarts because committed telemetry
sits behind a durable queue boundary; our device-resident window state
loses every open window on a crash. The recovery contract is the
classic journal+snapshot pair:

    recovered state = load_window_state(checkpoint)
                    + replay(journal frames admitted since the barrier)

through the NORMAL decode path (the feeder's sink codecs), so replay
exercises zero special-case code.

File layout (little-endian):

    header   'DFJH' u32 | version u32 | epoch u32
    record   'DFJR' u32 | kind u8 | len u32 | crc32(payload) u32 | payload

Record kinds: FRAME (a raw wire frame, exactly as admitted) and MARK
(a pump boundary — replay re-creates the same batch coalescing the
live run produced, which is what makes recovery bit-exact against an
uninterrupted oracle: f32 meter sums are replayed in the identical
fold order).

Crash-safety properties:

  * appends are buffered, MARKs flush (optionally fsync) — a crash
    mid-record leaves a truncated tail that `read_journal` detects via
    magic+crc and cleanly stops at;
  * `rotate()` (called only at a checkpoint barrier, after the
    snapshot landed) atomically replaces the file with a fresh one at
    epoch+1 — replay of a rotated journal applies everything;
  * the checkpoint stores (epoch, offset) of the barrier, so if the
    crash lands BETWEEN snapshot save and rotate, replay skips the
    records the snapshot already covers instead of double-applying
    them (`FeederRuntime.replay_journal`);
  * the journal is BOUNDED: past `max_bytes` appends are dropped and
    counted (`overflow_frames`) — durability degrades loudly rather
    than filling the disk; size it well above the checkpoint cadence.

Journal I/O failures never propagate into the pump loop: they are
counted (`io_errors`) and the pipeline keeps flowing with reduced
durability — the graceful-degradation stance of the feeder.
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from pathlib import Path

from .. import chaos

JOURNAL_MAGIC = 0x484A4644  # 'DFJH' little-endian
RECORD_MAGIC = 0x524A4644  # 'DFJR'
JOURNAL_VERSION = 1
_HDR = struct.Struct("<III")  # magic, version, epoch
_REC = struct.Struct("<IBII")  # magic, kind, len, crc

REC_FRAME = 1
REC_MARK = 2


class FrameJournal:
    def __init__(
        self,
        path: str | Path,
        *,
        max_bytes: int = 64 << 20,
        fsync: bool = False,
    ):
        self.path = Path(path)
        self.max_bytes = max_bytes
        self.fsync = fsync
        self.epoch = 0
        self.counters = {
            "frames": 0,
            "bytes": 0,
            "marks": 0,
            "rotations": 0,
            "overflow_frames": 0,
            "io_errors": 0,
            "reopen_truncations": 0,
        }
        self._lock = threading.Lock()
        self._dirty = False
        self._f = None
        self._open()

    # -- lifecycle -------------------------------------------------------
    def _open(self) -> None:
        try:
            if self.path.exists() and self.path.stat().st_size >= _HDR.size:
                epoch, entries, truncated = read_journal(self.path)
                self.epoch = epoch
                # a crash mid-record leaves a torn tail; appending AFTER
                # it would strand every new record beyond replay's reach
                # (read_journal stops at the first bad record) — truncate
                # back to the last valid record boundary first
                end = (
                    entries[-1][2] + _REC.size + len(entries[-1][1])
                    if entries
                    else _HDR.size
                )
                self._f = open(self.path, "r+b")
                if truncated:
                    self._f.truncate(end)
                    self.counters["reopen_truncations"] += 1
                self._f.seek(end)
            else:
                self._f = open(self.path, "wb")
                self._f.write(_HDR.pack(JOURNAL_MAGIC, JOURNAL_VERSION, self.epoch))
                self._f.flush()
        except OSError:
            self.counters["io_errors"] += 1
            self._f = None

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                    self._f.close()
                except OSError:
                    self.counters["io_errors"] += 1
                self._f = None

    # -- write side ------------------------------------------------------
    def _write_record(self, kind: int, payload: bytes) -> bool:
        if self._f is None:
            self.counters["io_errors"] += 1
            return False
        try:
            chaos.maybe_fail(chaos.SITE_JOURNAL_IO)
            self._f.write(
                _REC.pack(RECORD_MAGIC, kind, len(payload), zlib.crc32(payload))
            )
            if payload:
                self._f.write(payload)
            return True
        except OSError:
            self.counters["io_errors"] += 1
            return False

    def append(self, raw: bytes) -> bool:
        """Append one admitted frame. False = not journaled (bound hit
        or I/O error) — counted, never raised."""
        with self._lock:
            if self._f is not None and self._f.tell() > self.max_bytes:
                self.counters["overflow_frames"] += 1
                return False
            if not self._write_record(REC_FRAME, bytes(raw)):
                return False
            self.counters["frames"] += 1
            self.counters["bytes"] += len(raw)
            self._dirty = True
            return True

    def mark(self) -> None:
        """Pump-boundary marker + flush: bounds loss to one pump. A
        no-op when nothing was appended since the last mark."""
        with self._lock:
            if not self._dirty:
                return
            if self._write_record(REC_MARK, b""):
                self.counters["marks"] += 1
            try:
                if self._f is not None:
                    self._f.flush()
                    if self.fsync:
                        os.fsync(self._f.fileno())
            except OSError:
                self.counters["io_errors"] += 1
            self._dirty = False

    def sync_offset(self) -> tuple[int, int]:
        """Flush and return the (epoch, byte offset) barrier the caller
        embeds in its checkpoint meta — replay skips records before it
        when the crash lands between snapshot save and rotate.

        Error stance: an offset that is too SMALL is the dangerous
        direction (replay double-applies records the snapshot already
        covers), so a flush failure still returns tell() — the snapshot
        covers every admitted frame whether or not its journal record
        reached disk. Only when no offset can be determined at all does
        this raise: the caller's checkpoint then aborts BEFORE the
        snapshot is written, which is the safe side (old checkpoint +
        full journal replay)."""
        with self._lock:
            try:
                if self._f is not None:
                    try:
                        self._f.flush()
                        if self.fsync:
                            os.fsync(self._f.fileno())
                    except OSError:
                        self.counters["io_errors"] += 1
                    return self.epoch, self._f.tell()
                return self.epoch, self.path.stat().st_size
            except OSError as e:
                self.counters["io_errors"] += 1
                raise OSError(
                    f"journal {self.path}: cannot determine a checkpoint "
                    "barrier offset — refusing to let the caller embed a "
                    f"bogus one ({e})"
                ) from e

    def rotate(self) -> bool:
        """Atomically restart the journal at epoch+1. Call ONLY at a
        checkpoint barrier: every journaled frame must already be
        covered by the snapshot. False (counted) on I/O failure — the
        old journal keeps growing, recovery stays correct via the
        (epoch, offset) barrier in the checkpoint meta."""
        with self._lock:
            tmp = self.path.with_name(self.path.name + ".rot")
            try:
                chaos.maybe_fail(chaos.SITE_JOURNAL_IO)
                with open(tmp, "wb") as f:
                    f.write(
                        _HDR.pack(JOURNAL_MAGIC, JOURNAL_VERSION, self.epoch + 1)
                    )
                    f.flush()
                    os.fsync(f.fileno())
                if self._f is not None:
                    self._f.close()
                os.replace(tmp, self.path)
                self.epoch += 1
                self._f = open(self.path, "ab")
                self.counters["rotations"] += 1
                self._dirty = False
                return True
            except OSError:
                self.counters["io_errors"] += 1
                try:
                    if self._f is None or self._f.closed:
                        self._f = open(self.path, "ab")
                except OSError:
                    self._f = None
                return False

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["epoch"] = self.epoch
        return out


def read_journal(path: str | Path):
    """→ (epoch, [(kind, payload, start_offset)], truncated).

    Validates per-record magic + crc; stops cleanly at the first
    truncated or corrupt record (the crash-mid-write tail) with
    truncated=True. Raises ValueError only when the FILE HEADER is
    wrong — a missing/alien file is an operator error, a torn tail is
    an expected crash artifact."""
    data = Path(path).read_bytes()
    if len(data) < _HDR.size:
        raise ValueError(f"{path}: too short for a frame journal header")
    magic, version, epoch = _HDR.unpack_from(data, 0)
    if magic != JOURNAL_MAGIC or version != JOURNAL_VERSION:
        raise ValueError(f"{path}: not a v{JOURNAL_VERSION} frame journal")
    entries = []
    off = _HDR.size
    truncated = False
    n = len(data)
    while off < n:
        start = off
        if off + _REC.size > n:
            truncated = True
            break
        rmagic, kind, ln, crc = _REC.unpack_from(data, off)
        off += _REC.size
        if rmagic != RECORD_MAGIC or kind not in (REC_FRAME, REC_MARK):
            truncated = True
            break
        if off + ln > n:
            truncated = True
            break
        payload = data[off : off + ln]
        off += ln
        if zlib.crc32(payload) != crc:
            truncated = True
            break
        entries.append((kind, payload, start))
    return epoch, entries, truncated
