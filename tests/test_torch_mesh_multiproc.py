"""The port's real two-process deployment on the CPU
(tests/torch_mesh_harness.py: two subprocesses joined over gloo by
`MeshTopology.distributed`, one shard group each, key-hash fan-in at
each receiver, per-host feeder + journal + checkpoint), held digest for
digest against the port's single-process oracle AND the reference
harness's in-process `oracle_result()`: flushed rows, merged sketch
blocks, the counter block, injected-clock freshness lags and trace ids.

Twins, on the port, of tests/test_mesh_multiproc.py, the per-host budget
of test_perf_gate.py (`test_mesh_per_host_fetch_budget_and_locality`),
the kill-and-recover case of test_recovery.py
(`test_two_process_kill_one_host_recovers_from_local_journal`) and the
two-process fleet proofs of test_fleet.py. The recipes are memoized in
the harness, so this file spawns each once."""

from __future__ import annotations

import time

import pytest

import mesh_harness as mh
import torch_mesh_harness as th

PINNED = ("stream", "blocks", "counters", "fresh")


@pytest.fixture(scope="module", autouse=True)
def _prewarm():
    """Overlap the two subprocess recipes with the in-process oracles."""
    th.prewarm((th.mesh2_result, th.mesh2_kill_result), (th.oracle_result,))


def _oracles():
    return th.oracle_result(), mh.oracle_result()


def test_port_oracle_equals_reference_oracle():
    port, ref = _oracles()
    assert set(port["groups"]) == set(ref["groups"])
    for g, want in ref["groups"].items():
        for key in PINNED + ("fresh_hist", "trace_id"):
            assert port["groups"][g][key] == want[key], (g, key)
    assert port["receiver"]["frames_misrouted"] == ref["receiver"]["frames_misrouted"] == 0


def test_two_process_mesh_bitexact_vs_both_oracles():
    port, ref = _oracles()
    procs = th.mesh2_result()
    assert len(procs) == 2
    seen = set()
    for res in procs:
        for g, rec in res["groups"].items():
            seen.add(g)
            for key in PINNED:
                assert rec[key] == port["groups"][g][key], (g, key)
                assert rec[key] == ref["groups"][g][key], (g, key)
    # every shard group was served by exactly one process
    assert seen == set(ref["groups"])


def test_two_process_trace_ids_join_one_trace_per_window():
    """Trace ids derive from (service, window, interval): both processes
    and both oracles compute one id with no wire context."""
    port, ref = _oracles()
    ids = {rec["trace_id"] for res in th.mesh2_result() for rec in res["groups"].values()}
    ids |= {rec["trace_id"] for o in (port, ref) for rec in o["groups"].values()}
    assert len(ids) == 1


def test_two_process_misroutes_counted_and_handed_off():
    """Each process receives the FULL agent stream and enqueues only its
    own group's frames; the rest are counted misroutes handed off. The
    counts are the reference's: frames of agents the reference's key
    hash sends elsewhere."""
    from deepflow_tpu.parallel.topology import key_shard_group as ref_key_shard_group

    groups = {a: ref_key_shard_group(th.ORG_ID, a, th.N_GROUPS) for a in range(th.N_AGENTS)}
    assert groups == th.agent_groups()
    for res in th.mesh2_result():
        owned = {int(g) for g in res["groups"]}
        want = sum(th.N_STEPS for a, g in groups.items() if g not in owned)
        c = res["receiver"]
        assert c["frames_misrouted"] == c["frames_handoff"] == res["handoffs"] == want
        assert c["handoff_errors"] == 0 and c["no_handler"] == 0
    assert th.oracle_result()["receiver"]["frames_misrouted"] == 0


def test_two_process_aggregate_covers_the_full_workload():
    port, ref = _oracles()
    got = sum(rec["counters"]["flow_in"] for res in th.mesh2_result()
              for rec in res["groups"].values())
    want = sum(rec["counters"]["flow_in"] for rec in ref["groups"].values())
    assert got == want == th.N_STEPS * th.N_AGENTS * th.ROWS_PER_FRAME


def test_two_process_bringup_states_the_pod_mesh_on_the_asked_device():
    """Each host joined the group (rank = process index), stated the same
    pod mesh, and ran on the device its spec asked for."""
    procs = th.mesh2_result()
    assert [res["process_index"] for res in procs] == [0, 1]
    statements = [res["global_mesh"] for res in procs]
    assert statements[0] == statements[1] == [["cpu", "cpu"], ["cpu", "cpu"]]
    for res in procs:
        assert res["device"] == {"name": "cpu", "stash": ["cpu"]}
        assert res["init_s"] > 0
        # the CPU path runs the kernels' plain versions: nothing launched
        assert set(res["launches"].values()) == {0}


def test_mesh_per_host_fetch_budget_and_locality():
    """The single-host contract per host: ≤ 3 fetches per ingest, no
    fetched tensor off this host's devices, and no new step shape after
    the buckets warm up (the census stands in for the jit cache)."""
    for res in th.mesh2_result():
        f = res["fetch"]
        assert f["n_ingests"] > 0
        assert f["n"] <= 3 * f["n_ingests"], f
        assert f["nonlocal"] == 0, f
        assert f["retraces"] == 0, f
        assert sum(rec["host_fetches"] for rec in res["groups"].values()) == f["n"]


def test_two_process_kill_one_host_recovers_from_local_journal():
    """Process 1 dies after a checkpoint (os._exit) and recovers
    standalone from its own checkpoint and journal: the combined stream
    is both oracles', the survivor untouched."""
    port, ref = _oracles()
    kill = th.mesh2_kill_result()
    for g, rec in kill["p0"]["groups"].items():
        for o in (port, ref):
            assert rec["stream"] == o["groups"][g]["stream"]
            assert rec["counters"] == o["groups"][g]["counters"]
    (g1,) = kill["p1_gen1"]["groups"].keys()
    assert kill["p1_gen1"]["killed_after"] == th.KILL_AFTER
    gen1 = kill["p1_gen1"]["groups"][g1]
    gen2 = kill["p1_gen2"]["groups"][g1]
    assert gen1["ckpt_stream_len"] is not None
    combined = gen1["stream"][: gen1["ckpt_stream_len"]] + gen2["stream"]
    blocks = gen1["blocks"][: gen1["ckpt_blocks_len"]] + gen2["blocks"]
    for o in (port, ref):
        want = o["groups"][g1]
        assert combined == want["stream"]
        assert blocks == want["blocks"]
        for k in ("flow_in", "flushed_doc", "drop_before_window", "window_advances"):
            assert gen2["counters"][k] == want["counters"][k], k


# ---------------------------------------------------------------------------
# the fleet plane over the two-process run: each host's fleet frames
# replayed over real TCP into a FleetAggregator (the port's and the
# reference's), merged bit-exact against the per-host dumps


def _replay_host_frames(fleet_pkg, handoff_pkg, agg, frames_by_host):
    total = sum(len(v) for v in frames_by_host.values())
    for _host, frames in sorted(frames_by_host.items()):
        sender = handoff_pkg.HandoffSender({fleet_pkg.AGGREGATOR_PEER: agg.endpoint()})
        try:
            for hexframe in frames:
                sender.send(fleet_pkg.AGGREGATOR_PEER, bytes.fromhex(hexframe))
            assert sender.flush(30)
        finally:
            sender.close()
    deadline = time.time() + 30
    while agg.counters["frames_rx"] < total and time.time() < deadline:
        time.sleep(0.01)
    assert agg.counters["frames_rx"] == total, agg.counters


def _oracle_from_results(results):
    """Counters summed per group and hist dumps merged, straight from
    `results()` — the same faces the subprocesses froze into frames."""
    from deepflow_tpu_torch.tracing.lineage import merge_hist_dumps

    counters: dict[str, int] = {}
    dumps = []
    for res in results:
        for g, rec in res["groups"].items():
            if rec.get("released"):
                continue
            for k, v in rec["counters"].items():
                key = f"tpu_mesh_swm{{group={g}}}.{k}"
                counters[key] = counters.get(key, 0) + int(v)
            dumps.append({f"g{g}.{lane}": pairs for lane, pairs in rec["fresh_hist"].items()})
    return counters, merge_hist_dumps(*dumps)


def _packages():
    from deepflow_tpu import fleet as ref_fleet
    from deepflow_tpu.ingest import handoff as ref_handoff
    from deepflow_tpu_torch import fleet
    from deepflow_tpu_torch.ingest import handoff

    return {"port": (fleet, handoff), "ref": (ref_fleet, ref_handoff)}


@pytest.mark.parametrize("aggregator", ["port", "ref"])
def test_mesh2_fleet_merge_bitexact_vs_per_host_dump_oracle(aggregator):
    procs = th.mesh2_result()
    fleet_pkg, handoff_pkg = _packages()[aggregator]
    port_fleet, port_handoff = _packages()["port"]
    agg = fleet_pkg.FleetAggregator(expiry_s=3600.0, autoregister=False, clock=time.time)
    agg.start()
    try:
        # the port's sender carries the port's frames into either aggregator
        _replay_host_frames(port_fleet, port_handoff, agg,
                            {f"host{i}": res["fleet_frames"] for i, res in enumerate(procs)})
        want_counters, want_hists = _oracle_from_results(procs)
        assert agg.merged_counters() == want_counters
        assert agg.merged_hists() == want_hists
        assert agg.counters["decode_errors"] == 0
        assert agg.counters["bad_frames"] == 0
        roster = agg.hosts()
        assert sorted(r["host"] for r in roster) == ["host0", "host1"]
        assert len({g for r in roster for g in r["groups"]}) == th.N_GROUPS
    finally:
        agg.stop()


def test_mesh2_kill_fleet_staleness_counted_expiry():
    """The dead host's LAST frames merge while fresh; once expired the
    merged views equal the survivor-only oracle, the expiry is COUNTED
    and the last-seen stamp still serves."""
    from deepflow_tpu_torch.fleet import FleetAggregator, decode_fleet_frame
    from deepflow_tpu_torch.ingest.framing import FrameReassembler

    port_fleet, port_handoff = _packages()["port"]
    kill = th.mesh2_kill_result()
    p0, p1 = kill["p0"], kill["p1_gen1"]
    clock = {"t": 5000.0}
    agg = FleetAggregator(expiry_s=60.0, autoregister=False, clock=lambda: clock["t"])
    agg.start()
    try:
        _replay_host_frames(port_fleet, port_handoff, agg,
                            {"host0": p0["fleet_frames"], "host1": p1["fleet_frames"]})
        want_counters, want_hists = _oracle_from_results([p0, p1])
        assert agg.merged_counters() == want_counters
        assert agg.merged_hists() == want_hists
        # host1 is dead; the clock passes expiry_s while the survivor
        # re-delivers its (cumulative, idempotent) frames
        clock["t"] = 5100.0
        asm = FrameReassembler()
        for hexframe in p0["fleet_frames"]:
            for header, body in asm.feed(bytes.fromhex(hexframe)):
                agg.ingest(decode_fleet_frame(header, body))
        want_counters0, want_hists0 = _oracle_from_results([p0])
        assert agg.merged_counters() == want_counters0
        assert agg.merged_hists() == want_hists0
        c = agg.get_counters()
        assert c["hosts_expired"] == 1
        assert c["stale_drops"] >= 2
        roster = {r["host"]: r for r in agg.hosts()}
        assert roster["host1"]["stale"] is True
        assert roster["host1"]["last_seen"] == 5000.0
        assert roster["host0"]["stale"] is False
        assert agg.health()["stale"] == 1
    finally:
        agg.stop()
