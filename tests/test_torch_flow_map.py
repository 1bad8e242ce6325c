"""The agent's FlowMap on the port against the reference's, on the CPU.

Both maps take the same crafted packets (each package parses the bytes
with its own `parse_packets`) and the same ticks; after every inject and
every tick the flow table (lane for lane, through
`convert.flow_map_state_to_numpy`), the host `seq_tracker` (in its dict
order) and the counters must be equal, and every tick's emission equal
row for row. The sessions cover FIN, client and server RST, opening and
established timeouts, periodic emission of a long-lived flow, UDP,
mid-stream pickup, and retransmissions within and across batches; one
handshake straddles the 2^32 µs wrap of the handshake clock; one tick
hits the reference's close-mask quirk (the compacted rows read through
the uncompacted mask), and both packages release the same wrong keys.
One map shape (64 rows, 64-packet batches) keeps the reference's
compiles to a few.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepflow_tpu.agent import flow_map as ref_fm
from deepflow_tpu.agent import packet as ref_packet
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.agent import flow_map as fm_mod
from deepflow_tpu_torch.agent import packet
from deepflow_tpu_torch.agent.packet import (
    TCP_ACK,
    TCP_FIN,
    TCP_PSH,
    TCP_RST,
    TCP_SYN,
    craft_tcp,
    craft_udp,
)

CAP, BATCH = 64, 64
T0 = 1_700_000_000
CLI, SRV = 0x0A000001, 0x0A000002
TIMEOUTS = dict(opening=5, established=20, closing=10)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


class Pair:
    """A reference FlowMap and a port FlowMap (device="cpu") stepped
    together, compared after every step."""

    def __init__(self, **kw):
        self.ref = ref_fm.FlowMap(capacity=CAP, batch_size=BATCH,
                                  timeouts=ref_fm.FlowTimeouts(**TIMEOUTS), **kw)
        self.port = fm_mod.FlowMap(capacity=CAP, batch_size=BATCH,
                                   timeouts=fm_mod.FlowTimeouts(**TIMEOUTS), device="cpu", **kw)
        self.emitted = []

    def inject(self, pkts, ts, us=None):
        us = us if us is not None else [0] * len(pkts)
        self.ref.inject(ref_packet.parse_packets(*ref_packet.to_batch(pkts, ts, us)))
        before = self.port.host_fetches
        self.port.inject(packet.parse_packets(*packet.to_batch(pkts, ts, us)))
        assert self.port.host_fetches == before  # inject fetches nothing
        self.check()

    def tick(self, now, drain=False):
        want = self.ref.drain(now) if drain else self.ref.tick(now)
        before = self.port.host_fetches
        got = self.port.drain(now) if drain else self.port.tick(now)
        assert self.port.host_fetches - before == (2 if got.size else 1)
        assert got.size == want.size
        np.testing.assert_array_equal(got.ints, want.ints)
        np.testing.assert_array_equal(_bits(got.nums), _bits(want.nums))
        self.emitted.append(got)
        self.check()
        return got

    def check(self):
        got = convert.flow_map_state_to_numpy(self.port)
        for k, v in got["stash"].items():
            want = np.asarray(getattr(self.ref.state, k))
            assert v.dtype == want.dtype, k
            np.testing.assert_array_equal(_bits(v), _bits(want), err_msg=k)
        assert list(got["seq_tracker"].items()) == [
            (k, (a, [tuple(iv) for iv in ivals])) for k, (a, ivals) in self.ref.seq_tracker.items()]
        assert self.port.counters == self.ref.counters


def _session(cli, sport, *, up=3, down=2, end=None, dport=443):
    """A TCP session's packets: handshake, `up` client and `down` server
    data segments, then `end` in (None, "fin", "cli_rst", "srv_rst")."""
    pkts = [
        craft_tcp(cli, SRV, sport, dport, flags=TCP_SYN, seq=1000),
        craft_tcp(SRV, cli, dport, sport, flags=TCP_SYN | TCP_ACK, seq=5000, ack=1001),
        craft_tcp(cli, SRV, sport, dport, flags=TCP_ACK, seq=1001, ack=5001),
    ]
    for i in range(up):
        pkts.append(craft_tcp(cli, SRV, sport, dport, flags=TCP_ACK | TCP_PSH, seq=1001 + 100 * i,
                              payload=b"u" * 100))
    for i in range(down):
        pkts.append(craft_tcp(SRV, cli, dport, sport, flags=TCP_ACK | TCP_PSH, seq=5001 + 200 * i,
                              payload=b"d" * 200))
    seq, dseq = 1001 + 100 * up, 5001 + 200 * down
    if end == "fin":
        pkts += [craft_tcp(cli, SRV, sport, dport, flags=TCP_FIN | TCP_ACK, seq=seq),
                 craft_tcp(SRV, cli, dport, sport, flags=TCP_FIN | TCP_ACK, seq=dseq)]
    elif end == "cli_rst":
        pkts.append(craft_tcp(cli, SRV, sport, dport, flags=TCP_RST, seq=seq))
    elif end == "srv_rst":
        pkts.append(craft_tcp(SRV, cli, dport, sport, flags=TCP_RST, seq=dseq))
    return pkts


def _data(cli, sport, seq, n=100, dport=443):
    return craft_tcp(cli, SRV, sport, dport, flags=TCP_ACK | TCP_PSH, seq=seq, payload=b"r" * n)


def test_packets_to_flow_rows_bit_equal():
    pkts = (_session(CLI, 40000, end="fin") + _session(CLI + 1, 40001, end="srv_rst")
            + [_data(CLI, 40000, 1001), _data(CLI, 40000, 1001),  # in-batch duplicates
               craft_udp(CLI, SRV, 5353, 53, b"q" * 10), b"\x00" * 20])
    ts = [T0 + (i % 3) for i in range(len(pkts))]
    us = [(37 * i) % 1_000_000 for i in range(len(pkts))]
    p_ref = ref_packet.parse_packets(*ref_packet.to_batch(pkts, ts, us))
    p = packet.parse_packets(*packet.to_batch(pkts, ts, us))
    n = len(pkts)
    orient = (np.full(n, 2, np.uint32), np.arange(n) % 2 == 0, np.arange(n) % 3 == 0)
    for tracker, o in ((None, None), ({}, None), ({}, orient)):
        want = ref_fm.packets_to_flow_rows(p_ref, None if tracker is None else {}, o)
        got_tracker = None if tracker is None else {}
        got = fm_mod.packets_to_flow_rows(p, got_tracker, o)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(_bits(g), _bits(w))
    # the seq-list pass flags the duplicate as a retransmission
    assert got[1][:, fm_mod.FLOW_STATE.num_index("retrans_d0")].sum() + \
        got[1][:, fm_mod.FLOW_STATE.num_index("retrans_d1")].sum() >= 1


def test_flow_map_lifecycle_bit_equal():
    pair = Pair()
    c = [CLI + i for i in range(8)]
    first = (_session(c[0], 41000, end="fin") + _session(c[1], 41001, end="srv_rst")
             + _session(c[2], 41002, end="cli_rst") + _session(c[3], 41003)  # long-lived
             + [craft_tcp(c[4], SRV, 41004, 443, flags=TCP_SYN, seq=7)]  # opening only
             + [craft_udp(c[5], SRV, 5353, 53, b"q" * 30)]
             + [_data(c[6], 41006, 900, dport=8080)]  # mid-stream pickup
             + [_data(c[3], 41003, 1001)])  # resend within the batch
    pair.inject(first, [T0] * len(first), [(101 * i) % 999_983 for i in range(len(first))])
    rows = pair.tick(T0 + 1)
    assert rows.size == 7
    # more traffic for the long-lived flow: new data and a resend of a
    # segment sent in the first batch (across batches); more UDP
    more = [_data(c[3], 41003, 1301), _data(c[3], 41003, 1101),
            craft_udp(SRV, c[5], 53, 5353, b"a" * 60)]
    pair.inject(more, [T0 + 1] * len(more))
    pair.tick(T0 + 2)
    assert pair.tick(T0 + 3).size == 0  # idle flows emit nothing
    pair.tick(T0 + 7)  # the opening-only flow times out
    pair.tick(T0 + 25)  # the established flows time out
    pair.inject([_data(c[7], 41007, 10)], [T0 + 25])
    pair.tick(T0 + 30, drain=True)
    closes = np.concatenate([e.col("close_type") for e in pair.emitted])
    assert set(closes.tolist()) >= {fm_mod.CLOSE_FIN, fm_mod.CLOSE_SERVER_RST,
                                    fm_mod.CLOSE_CLIENT_RST, fm_mod.CLOSE_TIMEOUT}
    retrans = sum(e.col("retrans_tx").sum() + e.col("retrans_rx").sum() for e in pair.emitted)
    assert retrans == 2
    assert pair.port.get_counters() == pair.ref.get_counters()


def test_handshake_across_the_2_32_us_wrap():
    """SYN just before the µs clock wraps mod 2^32, SYN-ACK and ACK
    after: the RTT legs are measured across the wrap, as the
    reference's wrapping u32 subtraction does."""
    s = next(s for s in range(T0, T0 + 10_000)
             if (s * 1_000_000) % (1 << 32) > (1 << 32) - 900_000)
    us_syn = (1 << 32) - 100 - (s * 1_000_000) % (1 << 32)
    pkts = [craft_tcp(CLI, SRV, 42000, 443, flags=TCP_SYN, seq=1),
            craft_tcp(SRV, CLI, 443, 42000, flags=TCP_SYN | TCP_ACK, seq=9, ack=2),
            craft_tcp(CLI, SRV, 42000, 443, flags=TCP_ACK, seq=2, ack=10)]
    # a second handshake whose SYN-ACK was stamped before its SYN (a
    # reordered capture): the wrapped leg is huge, fails the bound, and
    # the flow reports no client RTT
    pkts += [craft_tcp(CLI, SRV, 42001, 443, flags=TCP_SYN, seq=1),
             craft_tcp(SRV, CLI, 443, 42001, flags=TCP_SYN | TCP_ACK, seq=9, ack=2)]
    pair = Pair()
    pair.inject(pkts, [s] * 5, [us_syn, us_syn + 300, us_syn + 500, us_syn + 400, us_syn + 100])
    rows = {r["client_port"]: r for r in pair.tick(s + 1).to_rows()}
    assert rows[42000]["rtt_client_max"] == 300 and rows[42000]["rtt_server_max"] == 200
    assert rows[42001]["rtt_client_max"] == 0


def _key_of(cli, sport):
    p = packet.parse_packets(*packet.to_batch([_data(cli, sport, 1)], [T0]))
    ints, _, _ = fm_mod.packets_to_flow_rows(p)
    hi, lo = fm_mod.fingerprint64_np(ints[:, fm_mod.FLOW_STATE.key_cols])
    return int(hi[0]), int(lo[0])


def test_close_mask_quirk_releases_the_same_keys():
    """Table order A < B < C. A idles (open, no delta), B closes with
    FIN, C sends data: the tick emits [B, C], and both packages read the
    first two entries of the uncompacted close mask — [A: open, B:
    closed] — over them, so C's seq_tracker keys are released and B's
    kept. C's later resend of old data then goes unflagged in both."""
    keys = sorted((_key_of(CLI, sp), sp) for sp in range(43000, 43016))
    (ka, a), (kb, b), (kc, c) = keys[0], keys[1], keys[2]
    pair = Pair()
    first = _session(CLI, a, down=0) + _session(CLI, b, down=0) + _session(CLI, c, down=0)
    pair.inject(first, [T0] * len(first))
    pair.tick(T0 + 1)
    fin = [craft_tcp(CLI, SRV, b, 443, flags=TCP_FIN | TCP_ACK, seq=1301),
           craft_tcp(SRV, CLI, 443, b, flags=TCP_FIN | TCP_ACK, seq=5001),
           _data(CLI, c, 1301)]
    pair.inject(fin, [T0 + 1] * 3)
    for m in (pair.ref, pair.port):
        assert {ka + (0,), kb + (0,), kc + (0,)} <= set(m.seq_tracker)
    rows = pair.tick(T0 + 2)
    assert rows.size == 2
    for m in (pair.ref, pair.port):
        assert kb + (0,) in m.seq_tracker  # the closed flow's keys stay
        assert kc + (0,) not in m.seq_tracker  # the open flow's keys went
    pair.inject([_data(CLI, c, 1001)], [T0 + 2])  # a resend of C's first segment
    row = pair.tick(T0 + 3).to_rows()[0]
    assert row["client_port"] == c and row["retrans_tx"] == 0


def test_flow_map_state_crosses_from_the_reference():
    ref = ref_fm.FlowMap(capacity=CAP, batch_size=BATCH)
    pkts = _session(CLI, 44000) + _session(CLI + 1, 44001, end="fin")
    ref.inject(ref_packet.parse_packets(*ref_packet.to_batch(pkts, [T0] * len(pkts))))
    ref.tick(T0 + 1)
    port = convert.flow_map_state_from_numpy(
        fm_mod.FlowMap(capacity=CAP, batch_size=BATCH, device="cpu"),
        {"stash": ref.state, "seq_tracker": ref.seq_tracker})
    more = [_data(CLI, 44000, 1001), _data(CLI, 44000, 2000)]  # a resend, new data
    ref.inject(ref_packet.parse_packets(*ref_packet.to_batch(more, [T0 + 1] * 2)))
    port.inject(packet.parse_packets(*packet.to_batch(more, [T0 + 1] * 2)))
    want, got = ref.tick(T0 + 2), port.tick(T0 + 2)
    np.testing.assert_array_equal(got.ints, want.ints)
    np.testing.assert_array_equal(_bits(got.nums), _bits(want.nums))
    assert got.col("retrans_tx").sum() == 1
    back = convert.flow_map_state_to_numpy(port)
    for k, v in back["stash"].items():
        np.testing.assert_array_equal(_bits(v), _bits(getattr(ref.state, k)), err_msg=k)


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        fm_mod.FlowMap()
