"""The benchmark's flow-record generator: one general generator that a
traffic mix file parameterises.

A mix fixes a population of 5-tuples between a pool of pod IPs, how
records draw their tuple (Zipf or uniform), the late records (`late`:
for each lateness in whole seconds, the share of records stamped that
many seconds before their batch's event second), and the meter
distributions of a packet flow (packets, bytes per packet, round-trip
time). Every draw is a
counter-based hash of (seed, stream, index) computed in u32 arithmetic
on int64 tensors, so a seed gives the same records bit for bit on the
CPU and on the card, in any order of generation.

The replay hands the system a pool of `pool_batches` batches in turn;
batch k is pool batch k mod P with its timestamp lane stamped
`start_time + k`, less each late row's lateness. So every batch
advances event time by one second and closes one window.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import schema
from ..u32 import MASK, fmix32

# stream ids of the independent draws (6 is not drawn: pod ids follow the
# client IP; the ids after it keep their values)
(S_POP_IP0, S_POP_IP1, S_POP_PORT, S_POP_PROTO, S_POP_EPC0, S_POP_EPC1, _S_UNUSED,
 S_POP_GPID0, S_POP_GPID1, S_POP_DIR, S_KEY_A, S_KEY_B, S_PKTS, S_BPP, S_RTT,
 S_LATE, S_IP_OFFSET) = range(17)


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def stream_keys(seed: int, stream: int) -> tuple[int, int]:
    """Two 32-bit keys of one (seed, stream) pair (host ints)."""
    h = _splitmix64(_splitmix64(int(seed) & 0xFFFFFFFFFFFFFFFF) ^ (stream + 1))
    return h & MASK, h >> 32


def draw_u32(seed: int, stream: int, idx: torch.Tensor) -> torch.Tensor:
    """Uniform u32 per index (an int64 tensor of values below 2^32)."""
    ka, kb = stream_keys(seed, stream)
    return fmix32(fmix32(idx ^ ka) ^ kb)


def draw_range(seed: int, stream: int, idx: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Uniform integers in [lo, hi)."""
    return lo + ((draw_u32(seed, stream, idx) * (hi - lo)) >> 32)


def draw_unit(seed: int, s_a: int, s_b: int, idx: torch.Tensor) -> torch.Tensor:
    """Uniform float64 in [0, 1) with 53 random bits."""
    a = draw_u32(seed, s_a, idx) >> 5
    b = draw_u32(seed, s_b, idx) >> 6
    return (a * 67108864 + b).double() / float(1 << 53)


def zipf_cdf(n: int, s: float) -> np.ndarray:
    """Cumulative Zipf(s) weights of ranks 1..n (float64, last = 1)."""
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def _i32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 lane → int32 tensor of the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


@dataclasses.dataclass
class HostBatch:
    """One pooled batch on the host, as a decoder leaves it: [F, N]
    uint32 tag lanes (row per flow field), [N, M] float32 meters, and the
    per-row lateness in seconds that the re-stamp subtracts."""

    tags: np.ndarray
    meters: np.ndarray
    valid: np.ndarray
    late: np.ndarray  # [N] uint32 seconds

    def stamp(self, t: int) -> None:
        """Write this batch's timestamp lane for event second t."""
        np.subtract(np.uint32(t), self.late, out=self.tags[0])

    def as_input(self):
        """The batch as the system under test takes it: a FlowBatch over
        these arrays (no copy), so a re-stamp reaches it."""
        from deepflow_tpu_torch.datamodel.batch import FlowBatch

        return FlowBatch(tags={f: self.tags[i] for i, f in enumerate(schema.FLOW_FIELDS)},
                         meters=self.meters, valid=self.valid)


class FlowStream:
    """The records of one traffic mix for one seed."""

    def __init__(self, mix: dict, seed: int, device):
        self.mix = mix
        self.seed = int(seed)
        self.device = torch.device(device)
        self.rows = int(mix["records_per_batch"])
        self.pool = int(mix["pool_batches"])
        self.start_time = int(mix["start_time"])
        self.late = [(int(c["seconds"]), float(c["share"])) for c in mix["late"]]
        if any(s < 1 for s, _ in self.late) or sum(p for _, p in self.late) > 1:
            raise ValueError(f"late classes need seconds >= 1 and shares summing to <= 1: "
                             f"{mix['late']}")
        self.max_late = max((s for s, _ in self.late), default=0)
        self._population()
        if mix["key_draw"] == "zipf":
            self._cdf = torch.from_numpy(zipf_cdf(int(mix["tuples"]), float(mix["zipf_s"]))
                                         ).to(self.device)
        elif mix["key_draw"] != "uniform":
            raise ValueError(f"unknown key_draw {mix['key_draw']!r}")

    def _population(self) -> None:
        mix, seed, dev = self.mix, self.seed, self.device
        n = int(mix["tuples"])
        i = torch.arange(n, dtype=torch.int64, device=dev)

        def pick(stream, values):
            v = torch.tensor(values, dtype=torch.int64, device=dev)
            return v[draw_range(seed, stream, i, 0, len(values))]

        # pod IPs: an odd multiplier is a bijection mod 2^24, so the pool
        # holds `pod_ips` distinct addresses in 10.0.0.0/8
        off = stream_keys(seed, S_IP_OFFSET)[0] & 0xFFFFFF

        def pod_ip(k):
            return 0x0A000000 | ((k * 0x9E3779B1 + off) & 0xFFFFFF)

        # the client's pod: its IP and its pod id (one id per pod IP)
        pod0 = draw_range(seed, S_POP_IP0, i, 0, int(mix["pod_ips"]))
        pod1 = draw_range(seed, S_POP_IP1, i, 0, int(mix["pod_ips"]))

        lo, hi = mix["epc_range"]
        u = draw_u32(seed, S_POP_DIR, i)
        both = int(mix["p_both_dirs"] * 2**32)
        one = int((mix["p_both_dirs"] + mix["p_one_dir"]) * 2**32)
        self.pop = {
            "ip0_w3": pod_ip(pod0), "ip1_w3": pod_ip(pod1),
            "server_port": pick(S_POP_PORT, mix["ports"]),
            "protocol": pick(S_POP_PROTO, mix["protocols"]),
            "l3_epc_id": draw_range(seed, S_POP_EPC0, i, lo, hi),
            "l3_epc_id1": draw_range(seed, S_POP_EPC1, i, lo, hi),
            "pod_id": pod0 + 1,
            "gpid0": draw_range(seed, S_POP_GPID0, i, *mix["gpid_range"]),
            "gpid1": draw_range(seed, S_POP_GPID1, i, *mix["gpid_range"]),
            "direction0": torch.where(u < one, schema.DIR_C2S, schema.DIR_NONE),
            "direction1": torch.where(u < both, schema.DIR_S2C, schema.DIR_NONE),
        }

    def keys(self, b: int) -> torch.Tensor:
        """The tuple index of every record of pool batch b."""
        idx = self._row_index(b)
        if self.mix["key_draw"] == "zipf":
            u = draw_unit(self.seed, S_KEY_A, S_KEY_B, idx)
            r = torch.searchsorted(self._cdf, u, right=True)
            return r.clamp_(max=int(self.mix["tuples"]) - 1)
        return draw_range(self.seed, S_KEY_A, idx, 0, int(self.mix["tuples"]))

    def _row_index(self, b: int) -> torch.Tensor:
        if not 0 <= b < self.pool:
            raise ValueError(f"pool batch {b} outside [0, {self.pool})")
        return b * self.rows + torch.arange(self.rows, dtype=torch.int64, device=self.device)

    def batch(self, b: int, t: int | None = None):
        """Pool batch b on the device: ([F, N] int64 u32 tag lanes, [N, M]
        float32 meters, [N] int64 lateness in seconds). With `t`, the
        timestamp lane holds t less each row's lateness; without it,
        zero."""
        mix, seed = self.mix, self.seed
        idx = self._row_index(b)
        key = self.keys(b)
        pkts = draw_range(seed, S_PKTS, idx, *mix["packets_range"])
        nbytes = pkts * draw_range(seed, S_BPP, idx, *mix["bytes_per_packet_range"])
        rtt = draw_range(seed, S_RTT, idx, *mix["rtt_range"])
        late = self.lateness(idx)
        n, dev = self.rows, self.device
        tags = torch.zeros((len(schema.FLOW_FIELDS), n), dtype=torch.int64, device=dev)
        col = schema.FLOW_FIELDS.index
        if t is not None:
            tags[col("timestamp")] = t - late
        for f, v in self.pop.items():
            tags[col(f)] = v[key]
        for f, v in (("global_thread_id", 1), ("agent_id", 1), ("tap_type", 3),
                     ("tap_port", 1), ("is_active_host0", 1), ("is_active_host1", 1),
                     ("is_active_service", 1), ("signal_source", schema.SIG_PACKET)):
            tags[col(f)] = v
        meters = torch.zeros((n, len(schema.METER_NAMES)), dtype=torch.float32, device=dev)
        m = schema.METER_NAMES.index
        for f, v in (("packet_tx", pkts), ("packet_rx", pkts // 2), ("byte_tx", nbytes),
                     ("byte_rx", nbytes // 2), ("l3_byte_tx", nbytes * 9 // 10),
                     ("l3_byte_rx", nbytes * 9 // 20), ("new_flow", 1), ("rtt_max", rtt),
                     ("rtt_sum", rtt), ("rtt_count", 1), ("syn", 1), ("synack", 1)):
            meters[:, m(f)] = v if isinstance(v, int) else v.float()
        return tags, meters, late

    def host_batch(self, b: int) -> HostBatch:
        """Pool batch b copied to the host (pageable numpy)."""
        tags, meters, late = self.batch(b)
        return HostBatch(
            tags=_i32_bits(tags).cpu().numpy().view(np.uint32),
            meters=meters.cpu().numpy(), valid=np.ones(self.rows, dtype=bool),
            late=late.to(torch.int32).cpu().numpy().view(np.uint32))

    def lateness(self, idx: torch.Tensor) -> torch.Tensor:
        """Seconds late of each record: one uniform draw, cut into the
        late classes' shares in the order the mix lists them."""
        u = draw_u32(self.seed, S_LATE, idx)
        out = torch.zeros_like(idx)
        edge = 0
        for seconds, share in self.late:
            lo, edge = edge, edge + int(share * 2**32)
            out = torch.where((u >= lo) & (u < edge), seconds, out)
        return out

    def pool_of(self, k: int) -> int:
        """The pool batch that replay batch k hands in."""
        return k % self.pool

    def time_of(self, k: int) -> int:
        return self.start_time + k


Stream = FlowStream
