"""The port's multi-process topology (deepflow_tpu_torch/parallel/
topology.py) and key-hash receiver routing.

`MeshTopology.distributed` runs for real here: two subprocesses join a
gloo process group on localhost, check the rank and world size it
reports, state the pod mesh (`global_mesh`: every process's device
names, gathered) and refuse a caller whose rank or world size the group
contradicts; a lone rank whose peer never comes fails in seconds. A
standalone view of several processes has no global mesh. The receiver
cases of tests/test_mesh_topology.py run on the port's Receiver and the
reference's with the same frames, and their counters must be equal."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from deepflow_tpu.ingest import queues as ref_queues
from deepflow_tpu.ingest import receiver as ref_receiver
from deepflow_tpu.parallel import topology as ref_topology
from deepflow_tpu_torch.ingest import queues, receiver
from deepflow_tpu_torch.ingest.framing import HEADER_LEN, FlowHeader, MessageType
from deepflow_tpu_torch.parallel import topology
from deepflow_tpu_torch.parallel.topology import MeshTopology, free_coordinator_port

REPO = Path(__file__).resolve().parent.parent
T0 = 1_700_000_000

PORT = types.SimpleNamespace(name="port", receiver=receiver, queues=queues, topology=topology)
REF = types.SimpleNamespace(name="ref", receiver=ref_receiver, queues=ref_queues,
                            topology=ref_topology)

# one rank of a two-process bring-up: joins the group, states the pod
# mesh, then asks for topologies the group contradicts
_RANK = r"""
import json, sys, torch
from deepflow_tpu_torch.parallel.hostproc import exit_after_barrier
from deepflow_tpu_torch.parallel.topology import MeshTopology
addr, rank, workdir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
devs = [torch.device("cpu", 2 * rank + i) for i in range(2)]
t = MeshTopology.distributed(addr, 2, rank, n_groups=2, devices=devs)
out = {"rank": t.process_index, "world": t.process_count, "distributed": t.is_distributed,
       "owned": list(t.owned_groups()), "dpg": t.devices_per_group,
       "global": [[str(d) for d in row] for row in t.global_mesh().devices]}
errors = []
for pc, pi in ((2, 1 - rank), (3, rank)):
    try:
        MeshTopology.distributed(addr, pc, pi, initialize=False, devices=devs)
        errors.append(None)
    except ValueError as e:
        errors.append(str(e))
out["errors"] = errors
print(json.dumps(out), flush=True)
exit_after_barrier(workdir, rank, 2)
"""

_LONE = r"""
import sys
from deepflow_tpu_torch.parallel.topology import MeshTopology
import torch
MeshTopology.distributed(sys.argv[1], 2, 0, devices=[torch.device("cpu")], timeout_s=3)
"""


def _env():
    from deepflow_tpu_torch.parallel.hostproc import clean_env

    env = clean_env("cpu")
    env["PYTHONPATH"] = str(REPO)
    return env


def _run_ranks(tmp_path):
    addr = f"127.0.0.1:{free_coordinator_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, addr, str(r), str(tmp_path)],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_distributed_bringup_over_gloo_two_processes(tmp_path):
    try:
        outs = _run_ranks(tmp_path)
    except AssertionError as e:  # the coordinator lost its port: once more
        if "EADDRINUSE" not in str(e) and "address already in use" not in str(e):
            raise
        outs = _run_ranks(tmp_path)
    stated = [["cpu:0", "cpu:1"], ["cpu:2", "cpu:3"]]
    for rank, o in enumerate(outs):
        assert (o["rank"], o["world"], o["distributed"]) == (rank, 2, True)
        assert o["owned"] == [rank] and o["dpg"] == 2
        # the pod-wide statement: both processes' device names, in rank
        # order, identical on every process
        assert o["global"] == stated
        # a caller whose rank or world size the group contradicts raises
        assert all(e is not None and "torch.distributed reports process" in e
                   for e in o["errors"]), o["errors"]
        assert f"{rank}/2" in o["errors"][0] and f"{1 - rank}/2" in o["errors"][0]
        assert f"{rank}/3" in o["errors"][1]


def test_distributed_lone_rank_fails_in_seconds():
    """A peer that never joins fails the bring-up after the topology's
    short timeout, not torch's 30-minute default."""
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", _LONE, f"127.0.0.1:{free_coordinator_port()}"],
                       cwd=REPO, env=_env(), capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert time.monotonic() - t < 60
    assert "Traceback" in p.stderr


def test_distributed_without_a_group_refuses():
    with pytest.raises(ValueError, match="no torch.distributed process group"):
        MeshTopology.distributed("127.0.0.1:1", 2, 0, initialize=False,
                                 devices=[torch.device("cpu")])


def test_standalone_topology_has_no_global_view_and_refuses_remote_groups():
    def run(pkg):
        kw = {"devices": [torch.device("cpu")] * 2} if pkg is PORT else {}
        t = pkg.topology.MeshTopology.standalone(1, 2, devices_per_group=1, **kw)
        assert t.owned_groups() == (1,)
        assert not t.is_distributed
        with pytest.raises(ValueError, match="never crosses hosts") as e1:
            t.group_mesh(0)
        with pytest.raises(ValueError, match="no global device view") as e2:
            t.global_mesh()
        return str(e1.value), str(e2.value).split(" — ")[0]

    port, ref = run(PORT), run(REF)
    assert port[0] == ref[0] and port[1] == ref[1]


def test_single_topology_global_mesh_states_local_devices():
    devs = [torch.device("cpu", i) for i in range(4)]
    t = MeshTopology.single(n_groups=2, devices_per_group=2, devices=devs)
    gm = t.global_mesh()
    assert gm.axis_names == ("host", "chip")
    assert gm.devices.shape == (1, 4) and list(gm.devices.ravel()) == devs
    assert [d.index for d in t.group_mesh(1).flat()] == [2, 3]


def test_key_shard_group_matches_reference():
    agents = np.arange(256, dtype=np.uint32)
    for n in (1, 2, 3, 4, 8):
        for org in (1, 7):
            orgs = np.full(256, org, np.uint32)
            assert np.array_equal(topology.key_shard_group(orgs, agents, n),
                                  ref_topology.key_shard_group(orgs, agents, n))
            assert topology.key_shard_group(org, 5, n) == ref_topology.key_shard_group(org, 5, n)


# ---------------------------------------------------------------------------
# receiver key-hash routing, port and reference on the same frames


def _frames_for_agents(n_agents: int, rows: int = 16):
    from deepflow_tpu_torch.feeder import encode_flowbatch_frames
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=32, seed=3)
    out = []
    for a in range(n_agents):
        fb = gen.flow_batch(rows, T0)
        out += [(a, raw) for raw in encode_flowbatch_frames(fb, agent_id=a, org_id=1)]
    return out


def _ref_frames(n_agents: int, rows: int = 16):
    from deepflow_tpu.feeder import encode_flowbatch_frames
    from deepflow_tpu.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=32, seed=3)
    out = []
    for a in range(n_agents):
        fb = gen.flow_batch(rows, T0)
        out += [(a, raw) for raw in encode_flowbatch_frames(fb, agent_id=a, org_id=1)]
    return out


def _standalone(pkg, pi, pc):
    kw = {"devices": [torch.device("cpu")] * 2} if pkg is PORT else {}
    return pkg.topology.MeshTopology.standalone(pi, pc, devices_per_group=1, **kw)


def _single(pkg, n_groups):
    kw = {"devices": [torch.device("cpu")] * n_groups} if pkg is PORT else {}
    return pkg.topology.MeshTopology.single(n_groups=n_groups, devices_per_group=1, **kw)


def _dispatch(rx, frames):
    for _a, raw in frames:
        rx._dispatch(FlowHeader.parse(raw[:HEADER_LEN]), raw, ("test", 0))


def test_both_packages_frame_the_same_bytes():
    assert _frames_for_agents(12) == _ref_frames(12)


def test_receiver_routes_by_key_hash_and_counts_misroutes():
    def run(pkg):
        topo = _standalone(pkg, 0, 2)
        rx = pkg.receiver.Receiver()
        handed = []
        rx.attach_topology(topo, handoff=lambda g, raw: handed.append(g))
        q_own = pkg.queues.PyOverwriteQueue(256)
        rx.register_handler(MessageType.TAGGEDFLOW, [q_own], shard_group=0)
        # a wrong-group handler that must NEVER see a frame
        q_other = pkg.queues.PyOverwriteQueue(256)
        rx.register_handler(MessageType.TAGGEDFLOW, [q_other], shard_group=1)
        frames = _frames_for_agents(12)
        own = sum(1 for a, _ in frames if topo.owns_group(topo.group_for_agent(1, a)))
        misrouted = len(frames) - own
        _dispatch(rx, frames)
        assert own > 0 and misrouted > 0  # the hash split this agent set
        c = rx.get_counters()
        assert len(q_own) == own
        # the misrouted frames were counted and handed off — NOT enqueued
        # into the wrong-group handler registered on this same receiver
        assert len(q_other) == 0
        assert c["frames_misrouted"] == misrouted
        assert c["frames_handoff"] == misrouted
        assert handed and all(not topo.owns_group(g) for g in handed)
        rx.stop()
        return c, handed, len(q_own)

    assert run(PORT) == run(REF)


def test_receiver_handoff_errors_are_contained_and_counted():
    def run(pkg):
        topo = _standalone(pkg, 0, 2)
        rx = pkg.receiver.Receiver()

        def broken(_g, _raw):
            raise RuntimeError("control-plane link down")

        rx.attach_topology(topo, handoff=broken)
        rx.register_handler(MessageType.TAGGEDFLOW, [pkg.queues.PyOverwriteQueue(64)],
                            shard_group=0)
        _dispatch(rx, _frames_for_agents(12))
        c = rx.get_counters()
        assert c["frames_misrouted"] > 0
        assert c["handoff_errors"] == c["frames_misrouted"]
        assert c["frames_handoff"] == 0
        rx.stop()
        return c

    assert run(PORT) == run(REF)


def test_receiver_misroute_counter_queryable_in_deepflow_system():
    from deepflow_tpu_torch.integration.dfstats import system_metric_name, system_sink
    from deepflow_tpu_torch.querier.engine import QueryEngine
    from deepflow_tpu_torch.storage.store import ColumnarStore
    from deepflow_tpu_torch.utils.stats import StatsCollector

    topo = _standalone(PORT, 0, 2)
    rx = receiver.Receiver()
    rx.attach_topology(topo)  # no handoff: counted drops
    rx.register_handler(MessageType.TAGGEDFLOW, [queues.PyOverwriteQueue(256)],
                        shard_group=0)
    _dispatch(rx, _frames_for_agents(12))
    want = rx.get_counters()["frames_misrouted"]
    assert want > 0

    ref_rx = ref_receiver.Receiver()
    ref_rx.attach_topology(_standalone(REF, 0, 2))
    ref_rx.register_handler(MessageType.TAGGEDFLOW, [ref_queues.PyOverwriteQueue(256)],
                            shard_group=0)
    _dispatch(ref_rx, _ref_frames(12))
    assert ref_rx.get_counters()["frames_misrouted"] == want
    ref_rx.stop()

    store = ColumnarStore()
    col = StatsCollector(interval_s=999)
    col.register("tpu_receiver", rx)
    col.add_sink(system_sink(store))
    col.tick(now=float(T0 + 100))
    res = QueryEngine(store, device="cpu").execute(
        "SELECT value FROM deepflow_system.deepflow_system WHERE metric = "
        f"'{system_metric_name('tpu_receiver', 'frames_misrouted')}'"
    )
    assert res.rows == 1
    assert float(res.values["value"][0]) == float(want)
    rx.stop()


def test_ungrouped_lanes_bypass_routing_even_with_topology_attached():
    """Routing applies ONLY to message types with group-registered
    handlers: an ungrouped lane keeps delivering every agent's frames."""
    def run(pkg):
        topo = _standalone(pkg, 0, 2)
        rx = pkg.receiver.Receiver()
        rx.attach_topology(topo)
        q_flow = pkg.queues.PyOverwriteQueue(256)
        rx.register_handler(MessageType.TAGGEDFLOW, [q_flow], shard_group=0)
        q_metrics = pkg.queues.PyOverwriteQueue(256)
        rx.register_handler(MessageType.METRICS, [q_metrics])  # ungrouped
        frames = _frames_for_agents(12)
        n_own = sum(1 for a, _ in frames if topo.owns_group(topo.group_for_agent(1, a)))
        for _agent, raw in frames:
            rx._dispatch(FlowHeader.parse(raw[:HEADER_LEN]), raw, ("t", 0))
            # the same agent's frame re-framed onto the ungrouped lane
            header = FlowHeader.parse(raw[:HEADER_LEN])
            header.msg_type = int(MessageType.METRICS)
            m_raw = header.encode() + raw[HEADER_LEN:]
            rx._dispatch(FlowHeader.parse(m_raw[:HEADER_LEN]), m_raw, ("t", 0))
        # grouped lane routed; ungrouped lane delivered EVERYTHING
        assert len(q_flow) == n_own
        assert len(q_metrics) == len(frames)
        # misroutes counted only for the grouped lane
        assert rx.get_counters()["frames_misrouted"] == len(frames) - n_own
        rx.stop()
        return rx.get_counters(), len(q_flow), len(q_metrics)

    assert run(PORT) == run(REF)


def test_reattach_invalidates_cached_agent_groups():
    """After a re-attach with a different group count every agent's
    cached group is recomputed under the NEW topology."""
    def run(pkg):
        rx = pkg.receiver.Receiver()
        frames = _frames_for_agents(8)
        t2 = _single(pkg, 2)
        rx.attach_topology(t2)
        q = {g: pkg.queues.PyOverwriteQueue(256) for g in range(4)}
        for g in range(2):
            rx.register_handler(MessageType.TAGGEDFLOW, [q[g]], shard_group=g)
        _dispatch(rx, frames)
        t4 = _single(pkg, 4)
        rx.attach_topology(t4)
        for g in range(2, 4):
            rx.register_handler(MessageType.TAGGEDFLOW, [q[g]], shard_group=g)
        _dispatch(rx, frames)
        routes = {}
        for a in sorted({a for a, _ in frames}):
            epoch, group = rx.agents[(1, a)].route
            assert group == t4.group_for_agent(1, a)
            assert epoch == rx._route_epoch
            routes[a] = (epoch, group)
        assert rx.get_counters()["frames_misrouted"] == 0  # all groups local
        rx.stop()
        return routes, rx.get_counters(), [len(q[g]) for g in range(4)]

    assert run(PORT) == run(REF)


def test_ungrouped_handler_still_works_without_topology():
    def run(pkg):
        rx = pkg.receiver.Receiver()
        q = pkg.queues.PyOverwriteQueue(64)
        rx.register_handler(MessageType.TAGGEDFLOW, [q])
        _dispatch(rx, _frames_for_agents(1)[:1])
        assert len(q) == 1
        assert rx.get_counters()["frames_misrouted"] == 0
        rx.stop()
        return rx.get_counters()

    assert run(PORT) == run(REF)


def test_clean_env_hides_the_card_from_a_cpu_child_only():
    from deepflow_tpu_torch.parallel.hostproc import clean_env

    assert clean_env("cpu")["CUDA_VISIBLE_DEVICES"] == ""
    card = clean_env("cuda")
    assert card.get("CUDA_VISIBLE_DEVICES") == os.environ.get("CUDA_VISIBLE_DEVICES")
