"""The port's eBPF userspace half (deepflow_tpu_torch/agent/
{ebpf_bridge,symbolizer}.py): the cases of tests/test_symbolizer.py on
the port, tests/test_agent_main.py::test_ebpf_bridge_sessions_skip_l4_metrics
and tests/test_geo_plugins.py::test_ebpf_flows_skip_l4_fanout on the
port's fanout (CPU tensors), and the two packages against each other:
the same socket events give equal L7 logs and app rows in both
dispatchers, the eBPF rows give equal L7 documents through each
package's L7Pipeline (and none through the L4 plane), and both profile
aggregators write the same PROFILE frame."""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import subprocess

import numpy as np
import pytest
import torch

from deepflow_tpu_torch.agent.symbolizer import (
    ElfSymbols,
    JavaPerfMap,
    ProcMaps,
    ProfileAggregator,
    Symbolizer,
)
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

torch.set_num_threads(1)

T0 = 1_700_000_000
CLI = 0x0A000001
SRV = 0x0A000002


C_SRC = r"""
int helper_alpha(int x) { return x + 1; }
int helper_beta(int x) { return helper_alpha(x) * 2; }
int main(void) { return helper_beta(20); }
"""


@pytest.fixture(scope="module")
def tiny_elf(tmp_path_factory):
    d = tmp_path_factory.mktemp("elf")
    src = d / "t.c"
    src.write_text(C_SRC)
    out = d / "t.bin"
    r = subprocess.run(["gcc", "-O0", "-o", str(out), str(src)],
                       capture_output=True)
    if r.returncode != 0:
        pytest.skip(f"gcc unavailable: {r.stderr.decode()[:100]}")
    return str(out)


def test_elf_symbols_match_nm(tiny_elf):
    syms = ElfSymbols.load(tiny_elf)
    names = {n for _, _, n in syms.syms}
    assert {"helper_alpha", "helper_beta", "main"} <= names

    nm = subprocess.run(["nm", "--defined-only", tiny_elf],
                        capture_output=True, text=True)
    if nm.returncode == 0:
        want = {}
        for line in nm.stdout.splitlines():
            parts = line.split()
            if len(parts) == 3 and parts[1] in ("T", "t"):
                want[parts[2]] = int(parts[0], 16)
        for fn in ("helper_alpha", "helper_beta", "main"):
            assert syms.resolve(want[fn]) == fn
            assert syms.resolve(want[fn] + 2) == fn  # inside the body


def test_proc_self_maps_and_libc_resolution():
    maps = ProcMaps.read("self")
    assert maps.ranges, "no executable ranges for self"
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    addr = ctypes.cast(libc.printf, ctypes.c_void_p).value
    assert maps.find(addr) is not None

    sym = Symbolizer("self")
    name = sym.resolve(addr)
    # glibc aliases printf; accept any *printf* symbol in a libc module
    assert "printf" in name, name
    assert sym.counters["resolved"] >= 1


def test_symbolizer_fallbacks():
    sym = Symbolizer("self")
    assert sym.resolve(0x10) == "[0x10]"  # unmapped
    r = sym.maps.ranges[0]
    out = sym.resolve(r.start + max(0, r.end - r.start - 1))
    assert out  # mapped but maybe nameless → bracket fallback allowed


def test_java_perf_map(tmp_path):
    pid = 4242
    (tmp_path / f"perf-{pid}.map").write_text(
        "7f0000001000 40 Lcom/shop/Cart;::add\n"
        "7f0000002000 10 Interpreter\n"
        "garbage line\n"
    )
    m = JavaPerfMap.read(pid, str(tmp_path))
    assert m.resolve(0x7F0000001010) == "Lcom/shop/Cart;::add"
    assert m.resolve(0x7F0000001FFF) is None  # past the entry size
    assert m.resolve(0x7F0000002005) == "Interpreter"


def test_profile_aggregator_to_flame_plane(tiny_elf):
    syms = ElfSymbols.load(tiny_elf)
    by_name = {n: a for a, _, n in syms.syms}
    agg = ProfileAggregator(app_service="svc-x", event_type="cpu")
    # stand in a real symbolizer for the fake pid: module-relative ELF
    sym = Symbolizer("self")
    sym.maps = ProcMaps.read("self")
    # feed pre-symbolized + raw-addr stacks into one window
    agg.observe_folded("main;helper_beta;helper_alpha", 90)
    agg.observe_folded("main;helper_beta", 10)
    frame = agg.flush(1_700_000_000)
    assert frame is not None
    head, _, body = frame.decode().partition("\n")
    assert head.split("\x00") == ["svc-x", "cpu", "1700000000"]

    # the frame is exactly what the profile ingest lane accepts
    from deepflow_tpu_torch.integration.formats import parse_folded

    samples, errors = parse_folded(body)
    assert errors == 0
    assert {s.stack: s.value for s in samples} == {
        "main;helper_beta;helper_alpha": 90,
        "main;helper_beta": 10,
    }
    assert agg.flush(0) is None  # window cleared


def test_aggregator_raw_addresses_via_self(tiny_elf):
    """Raw addr stacks through a REAL process symbolizer: use our own
    pid + libc addresses so resolution exercises maps+ELF end-to-end."""
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    printf_addr = ctypes.cast(libc.printf, ctypes.c_void_p).value
    malloc_addr = ctypes.cast(libc.malloc, ctypes.c_void_p).value
    agg = ProfileAggregator(app_service="self-prof")
    agg.observe(os.getpid(), [printf_addr, malloc_addr], weight=3)
    frame = agg.flush(1)
    assert frame is not None
    body = frame.decode().split("\n", 1)[1]
    assert "printf" in body and "malloc" in body and body.endswith(" 3")


def test_continuous_profiler_ships_profile_frames():
    """perf-stack samples → ContinuousProfiler → PROFILE frame → the
    server-side profile ingest shape (flame-plane compatible)."""
    import ctypes
    import ctypes.util

    from deepflow_tpu_torch.agent.ebpf_bridge import ContinuousProfiler, PerfStackSample

    sent = []

    class Sender:
        def send(self, b):
            sent.append(b)

    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    printf_addr = ctypes.cast(libc.printf, ctypes.c_void_p).value
    prof = ContinuousProfiler(Sender(), app_service="svc-prof")
    prof.observe([
        PerfStackSample(os.getpid(), [printf_addr], weight=5),
        PerfStackSample(os.getpid(), [printf_addr], weight=2),
    ])
    frame = prof.flush(1_700_000_000)
    assert frame is not None and sent == [frame]
    head, _, body = frame.decode().partition("\n")
    assert head.startswith("svc-prof\x00cpu\x00")
    assert "printf" in body and body.endswith(" 7")  # merged weights


def test_java_frames_fold_without_separator_corruption(tmp_path):
    """';' in JVM signatures must not split frames in the folded line."""
    from deepflow_tpu_torch.agent.symbolizer import JavaPerfMap, Symbolizer
    from deepflow_tpu_torch.integration.formats import parse_folded

    sym = Symbolizer("self")
    sym.java = JavaPerfMap([(0x1000, 0x100, "Lcom/shop/Cart;::add")])
    folded = sym.fold([0x1010])
    samples, errors = parse_folded(folded + " 4")
    assert errors == 0 and len(samples) == 1
    assert samples[0].stack == "Lcom/shop/Cart:::add"


def test_continuous_profiler_interval_flush():
    from deepflow_tpu_torch.agent.ebpf_bridge import ContinuousProfiler

    prof = ContinuousProfiler(None, interval_s=10.0)
    prof.agg.observe_folded("a;b", 1)
    assert prof.maybe_flush(5.0) is None  # inside the window
    frame = prof.maybe_flush(15.0)
    assert frame is not None
    prof.agg.observe_folded("a;b", 1)
    assert prof.maybe_flush(20.0) is None  # window restarts at 15
    assert prof.maybe_flush(25.0) is not None


# -- the eBPF bridge on the port's fanout ---------------------------------------

def _events(mod, n_sessions=1):
    out = []
    for k in range(n_sessions):
        out.append(mod.SocketDataEvent(
            pid=7, ip_src=CLI, ip_dst=SRV + k % 3, port_src=41000 + k, port_dst=80,
            protocol=6, direction=0,
            payload=f"GET /k{k % 4} HTTP/1.1\r\nHost: h\r\n\r\n".encode(),
            timestamp_us=(T0 + k // 8) * 10**6 + k, cap_seq=2 * k))
        out.append(mod.SocketDataEvent(
            pid=7, ip_src=CLI, ip_dst=SRV + k % 3, port_src=41000 + k, port_dst=80,
            protocol=6, direction=1,
            payload=(b"HTTP/1.1 200 OK\r\n\r\n" if k % 5 != 4 else
                     b"HTTP/1.1 503 Busy\r\n\r\n"),
            timestamp_us=(T0 + k // 8) * 10**6 + k + 900 + 10 * k, cap_seq=2 * k + 1))
    return out


def _tensors(tags):
    return {k: from_numpy_u32(v, "cpu") for k, v in tags.items()}


def test_ebpf_bridge_sessions_skip_l4_metrics():
    """Socket-data events flow through the L7 engine, come out tagged
    SignalSource.EBPF, feed the L7 metric plane but never the L4 one."""
    import deepflow_tpu_torch.agent.ebpf_bridge as bridge
    from deepflow_tpu_torch.agent.l7.engine import L7Engine
    from deepflow_tpu_torch.aggregator.fanout import FanoutConfig, fanout_l4, fanout_l7
    from deepflow_tpu_torch.datamodel.code import SignalSource
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER
    from deepflow_tpu_torch.flowlog.schema import L7_FLOW_LOG

    disp = bridge.EbpfDispatcher(L7Engine())
    log_batch, app_batch = disp.process(_events(bridge))
    assert log_batch.size == 1  # paired session
    ii = L7_FLOW_LOG.int_index
    assert log_batch.ints[0, ii("signal_source")] == int(SignalSource.EBPF)
    assert log_batch.ints[0, ii("response_duration")] == 900  # µs rrt

    tags = _tensors(app_batch.tags)
    valid = torch.from_numpy(np.asarray(app_batch.valid))
    # L4 gate: same tags with FLOW_METER-shaped meters must emit nothing
    l4_meters = torch.zeros((app_batch.meters.shape[0], FLOW_METER.num_fields))
    _t, _m, _ts, l4_valid = fanout_l4(tags, l4_meters, valid, FanoutConfig())
    assert not bool(l4_valid.any())
    _t, _m, _ts, l7_valid = fanout_l7(tags, torch.from_numpy(app_batch.meters), valid,
                                      FanoutConfig())
    assert bool(l7_valid.any())


def test_ebpf_flows_skip_l4_fanout():
    from deepflow_tpu_torch.aggregator.fanout import FanoutConfig, fanout_l4, fanout_l7
    from deepflow_tpu_torch.datamodel.code import SignalSource
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=16, seed=1)
    fb = gen.flow_batch(64, 1000)
    fb.tags["signal_source"][:] = int(SignalSource.EBPF)
    fb.tags["l7_protocol"][:] = 20
    tags = _tensors(fb.tags)
    meters, valid = torch.from_numpy(fb.meters), torch.from_numpy(fb.valid)
    _t, _m, _ts, valid_l4 = fanout_l4(tags, meters, valid, FanoutConfig())
    assert not bool(valid_l4.any())  # no L4 docs from eBPF
    _t, _m, _ts, valid_l7 = fanout_l7(tags, meters, valid, FanoutConfig())
    assert bool(valid_l7.any())  # L7 plane still emits


# -- the two packages against each other ----------------------------------------

def test_dispatchers_equal_across_packages():
    import deepflow_tpu.agent.ebpf_bridge as ref_bridge
    import deepflow_tpu_torch.agent.ebpf_bridge as bridge
    from deepflow_tpu.agent.l7.engine import L7Engine as RefL7Engine
    from deepflow_tpu_torch.agent.l7.engine import L7Engine

    events = _events(bridge, 24)
    ref_events = [ref_bridge.SocketDataEvent(**vars(e)) for e in events]
    buf, p = bridge.events_to_batch(events)
    rbuf, rp = ref_bridge.events_to_batch(ref_events)
    assert np.array_equal(buf, rbuf)
    for k, v in vars(rp).items():
        assert np.array_equal(getattr(p, k), v), k
    got = bridge.EbpfDispatcher(L7Engine()).process(events)
    want = ref_bridge.EbpfDispatcher(RefL7Engine()).process(ref_events)
    assert got[0].size == want[0].size == 24
    assert np.array_equal(got[0].ints, want[0].ints)
    assert got[0].strs == want[0].strs
    assert sorted(got[1].tags) == sorted(want[1].tags)
    for k in want[1].tags:
        assert np.array_equal(got[1].tags[k], want[1].tags[k]), k
    assert np.array_equal(got[1].meters, want[1].meters)
    assert np.array_equal(got[1].valid, want[1].valid)


def test_ebpf_app_rows_through_both_l7_pipelines():
    """The dispatcher's app rows through each package's L7Pipeline: the
    same documents (tags bit-exact, meters bit-exact), every one tagged
    eBPF; the L4 pipelines take the same rows and emit nothing."""
    import deepflow_tpu.aggregator.pipeline as ref_pipeline
    import deepflow_tpu.aggregator.window as ref_window
    import deepflow_tpu_torch.agent.ebpf_bridge as bridge
    import deepflow_tpu_torch.aggregator.pipeline as pipeline
    import deepflow_tpu_torch.aggregator.window as window
    from deepflow_tpu_torch.agent.l7.engine import L7Engine
    from deepflow_tpu_torch.datamodel.code import SignalSource
    from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA

    _, app = bridge.EbpfDispatcher(L7Engine()).process(_events(bridge, 24))
    docs = {}
    for name, pl, win, kw in (("port", pipeline, window, {"device": "cpu"}),
                              ("ref", ref_pipeline, ref_window, {})):
        cfg = pl.PipelineConfig(window=win.WindowConfig(capacity=1 << 10), batch_size=256)
        p7 = pl.L7Pipeline(cfg, **kw)
        out = p7.ingest(app) + p7.drain()
        docs[name] = sorted((int(d.timestamp[i]), d.tags[i].tobytes(), d.meters[i].tobytes())
                            for d in out for i in range(d.size))
    assert docs["port"] == docs["ref"] and len(docs["port"]) > 0
    j = TAG_SCHEMA.index("signal_source")
    assert all(np.frombuffer(t, np.uint32)[j] == int(SignalSource.EBPF)
               for _, t, _ in docs["port"])


def test_profile_frames_equal_across_packages():
    import deepflow_tpu.agent.ebpf_bridge as ref_bridge
    import deepflow_tpu_torch.agent.ebpf_bridge as bridge

    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    addrs = [ctypes.cast(getattr(libc, f), ctypes.c_void_p).value
             for f in ("printf", "malloc", "free")]
    frames = []
    for mod in (bridge, ref_bridge):
        prof = mod.ContinuousProfiler(None, app_service="svc-x", event_type="cpu")
        prof.observe([mod.PerfStackSample(os.getpid(), addrs[:2], weight=3),
                      mod.PerfStackSample(os.getpid(), addrs[1:], weight=2),
                      mod.PerfStackSample(os.getpid(), addrs[:2], weight=1)])
        prof.agg.observe_folded("main;a;b", 5)
        frames.append(prof.flush(T0))
    assert frames[0] is not None and frames[0] == frames[1]
