"""Classic pcap file reader/writer — the replay's capture source.

Port copy of deepflow_tpu/agent/pcap.py.

The reference replays `.pcap` fixtures through its parsers for golden
tests (agent/resources/test/**.pcap, SURVEY §4); this module gives the
TPU build the same replay path: read a capture file into the [N, SNAP]
u8 batch the vectorized parser consumes. Writer included so tests can
author fixtures without external tooling. Supports the classic format
(magic 0xA1B2C3D4, µs resolution; byte-swapped and ns variants read).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

MAGIC_US = 0xA1B2C3D4
MAGIC_NS = 0xA1B23C4D
# "modified" pcap (Alexey Kuznetzov's patched libpcap): classic layout
# with 8 extra per-record bytes (ifindex u32, protocol u16, pkt_type u8,
# pad u8) after the standard 16-byte record header
MAGIC_MODIFIED = 0xA1B2CD34
LINKTYPE_ETHERNET = 1


def write_pcap(path: str | Path, packets: list[tuple[int, int, bytes]]) -> None:
    """packets: (ts_sec, ts_usec, frame_bytes)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", MAGIC_US, 2, 4, 0, 0, 65535, LINKTYPE_ETHERNET))
        for sec, usec, data in packets:
            f.write(struct.pack("<IIII", sec, usec, len(data), len(data)))
            f.write(data)


def read_pcap(path: str | Path) -> list[tuple[int, int, bytes]]:
    data = Path(path).read_bytes()
    if len(data) < 24:
        raise ValueError("truncated pcap: no global header")
    (magic,) = struct.unpack_from("<I", data, 0)
    if magic in (MAGIC_US, MAGIC_NS, MAGIC_MODIFIED):
        endian = "<"
    elif magic in (struct.unpack(">I", struct.pack("<I", m))[0]
                   for m in (MAGIC_US, MAGIC_NS, MAGIC_MODIFIED)):
        endian = ">"
        (magic,) = struct.unpack_from(">I", data, 0)
    else:
        raise ValueError(f"bad pcap magic {magic:#x}")
    ns = magic == MAGIC_NS
    extra = 8 if magic == MAGIC_MODIFIED else 0
    out = []
    off = 24
    while off + 16 + extra <= len(data):
        sec, frac, incl, _orig = struct.unpack_from(f"{endian}IIII", data, off)
        off += 16 + extra
        if off + incl > len(data):
            break  # truncated trailing record
        out.append((sec, frac // 1000 if ns else frac, data[off : off + incl]))
        off += incl
    return out


def pcap_batches(path: str | Path, batch_size: int = 4096, snap: int = 192):
    """Yield (buf, lengths, ts_s, ts_us) parse batches from a capture."""
    from .packet import to_batch

    packets = read_pcap(path)
    for i in range(0, len(packets), batch_size):
        chunk = packets[i : i + batch_size]
        yield to_batch(
            [p[2] for p in chunk],
            [p[0] for p in chunk],
            [p[1] for p in chunk],
            snap=snap,
        )
