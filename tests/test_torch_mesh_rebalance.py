"""The port's mid-stream shard-group rebalance in the real two-process
harness on the CPU (tests/torch_mesh_harness.py), held digest for
digest against the port's uninterrupted single-topology oracle AND the
reference harness's in-process `rebalance_oracle_result()`: flushed
rows, sketch blocks, counters, freshness lags (histogram bins summed
across both owners) and trace ids — for the moved and the unmoved
group — plus the kill-the-old-owner-mid-handover drill (KillPoint at
the `rebalance.step` seam; gen-2 recovers from the dead host's own
checkpoint + journal and completes the handover). The misroute handoff
travels a real socket (HandoffSender → HandoffReceiver).

Twins, on the port, of tests/test_mesh_rebalance.py and the rebalance
budget of test_perf_gate.py (`test_rebalance_budget`). The recipes are
memoized in the harness, so this file spawns each once."""

from __future__ import annotations

import collections

import pytest

import mesh_harness as mh
import torch_mesh_harness as th

MOVED = str(th.MOVE_GROUP)
STAYED = "0"


@pytest.fixture(scope="module", autouse=True)
def _prewarm():
    """Overlap the two subprocess recipes with the in-process oracle."""
    th.prewarm((th.mesh_rebalance_result, th.mesh_rebalance_kill_result),
               (th.rebalance_oracle_result,))


def _oracles():
    return th.rebalance_oracle_result(), mh.rebalance_oracle_result()


def _merge_hists(*hists):
    out: dict = collections.defaultdict(collections.Counter)
    for h in hists:
        for lane, pairs in h.items():
            for b, c in pairs:
                out[lane][b] += c
    return {lane: sorted(c.items()) for lane, c in out.items()}


def test_port_rebalance_oracle_equals_reference_oracle():
    port, ref = _oracles()
    for g, want in ref["groups"].items():
        for key in ("stream", "blocks", "counters", "fresh", "fresh_hist", "trace_id"):
            assert port["groups"][g][key] == want[key], (g, key)


# ---------------------------------------------------------------------------
# clean rebalance: quiesce → checkpoint → publish → restore → flip


def test_rebalance_moved_group_stream_and_blocks_bit_exact():
    """The moved group's stream and blocks, old owner (through the
    handover barrier) then new owner (restore → finish), are the
    oracles'."""
    r = th.mesh_rebalance_result()
    p1 = r["p1"]["groups"][MOVED]
    p0 = r["p0"]["groups"][MOVED]
    assert p1["released"] is True
    assert p1["handover_stream_len"] == len(p1["stream"])
    for o in _oracles():
        want = o["groups"][MOVED]
        assert p1["stream"] + p0["stream"] == want["stream"]
        assert p1["blocks"] + p0["blocks"] == want["blocks"]


def test_rebalance_unmoved_group_untouched():
    r = th.mesh_rebalance_result()
    for o in _oracles():
        for key in ("stream", "blocks", "counters", "fresh", "fresh_hist"):
            assert r["p0"]["groups"][STAYED][key] == o["groups"][STAYED][key], key


def test_rebalance_counters_continue_across_owners():
    r = th.mesh_rebalance_result()
    got = r["p0"]["groups"][MOVED]["counters"]
    for o in _oracles():
        want = o["groups"][MOVED]["counters"]
        for k in ("flow_in", "flushed_doc", "drop_before_window", "window_advances"):
            assert got[k] == want[k], k


def test_rebalance_freshness_lags_bit_exact_across_owners():
    """Lag histograms add across the two owners to the oracles' bins, and
    the new owner's final per-lane lags equal the oracles'."""
    r = th.mesh_rebalance_result()
    p1 = r["p1"]["groups"][MOVED]
    p0 = r["p0"]["groups"][MOVED]
    for o in _oracles():
        want = o["groups"][MOVED]
        assert _merge_hists(p1["fresh_hist"], p0["fresh_hist"]) \
            == _merge_hists(want["fresh_hist"])
        for k, v in want["fresh"].items():
            if k.endswith("_lag_ms") and not k.endswith("max_ms"):
                assert p0["fresh"][k] == v, k


def test_rebalance_trace_ids_join_one_trace_across_owners():
    r = th.mesh_rebalance_result()
    ids = {o["groups"][MOVED]["trace_id"] for o in _oracles()}
    ids |= {r["p0"]["groups"][MOVED]["trace_id"], r["p1"]["groups"][MOVED]["trace_id"]}
    assert len(ids) == 1


def test_rebalance_no_uncounted_loss_and_real_wire_delivery():
    """Conservation across the transfer: every frame reached a pipeline,
    travelled the wire or was counted; the forwarding window's frames
    went over a real socket and were held-and-redelivered on the new
    owner while its restore was in flight."""
    r = th.mesh_rebalance_result()
    n_move = sum(1 for g in th.agent_groups().values() if g == th.MOVE_GROUP)
    want_fwd = n_move * (th.REROUTE_AT - th.REBALANCE_AT - 1)
    p1c = r["p1"]["receiver"]
    assert p1c["frames_misrouted"] == p1c["frames_handoff"] == want_fwd
    assert p1c["handoff_errors"] == 0
    assert r["p1"]["sender"]["tx_frames"] == want_fwd
    assert r["p1"]["sender"]["shed_frames"] == 0
    assert r["p0"]["handoff_rx"]["rx_frames"] == want_fwd
    assert r["p0"]["handoff_rx"]["bad_frames"] == 0
    assert r["p1"]["sender"]["tx_bytes"] == r["p0"]["handoff_rx"]["rx_bytes"]
    p0c = r["p0"]["receiver"]
    assert p0c["frames_held"] == p0c["frames_redelivered"] == n_move
    assert p0c["frames_held_dropped"] == p0c["frames_misrouted"] == p0c["no_handler"] == 0
    for res in (r["p0"], r["p1"]):
        assert res["rebalance"]["rebalances_completed"] == 1
        assert res["rebalance"]["rebalance_aborts"] == 0
        assert res["rebalance"]["topology_epoch"] == 1
    got = sum(r["p0"]["groups"][g]["counters"]["flow_in"] for g in (MOVED, STAYED))
    for o in _oracles():
        assert got == sum(rec["counters"]["flow_in"] for rec in o["groups"].values()) \
            == th.N_STEPS * th.N_AGENTS * th.ROWS_PER_FRAME


def test_rebalance_budget():
    """The per-host budgets hold across a rebalance on both owners: ≤ 3
    fetches per ingest, none off this host's devices, no new step shape
    after warm-up (census entries, for the moved group on the old owner
    counted at release); misroutes stop once agents re-route and the
    wire drains."""
    r = th.mesh_rebalance_result()
    for res in (r["p0"], r["p1"]):
        f = res["fetch"]
        assert f["n_ingests"] > 0
        assert f["n"] <= 3 * f["n_ingests"], f
        assert f["nonlocal"] == 0, f
        for g, (steady, end) in res["caches"].items():
            assert steady is not None, (res["process_index"], g)
            assert end == steady, (res["process_index"], g, steady, end)
    p1 = r["p1"]
    assert p1["misrouted_after_forwarding"] is not None
    assert p1["receiver"]["frames_misrouted"] == p1["misrouted_after_forwarding"]
    assert p1["sender"]["queue_depth"] == 0
    assert p1["sender"]["shed_frames"] == 0
    assert r["p0"]["receiver"]["frames_misrouted"] == 0
    assert r["p0"]["receiver"]["frames_held_dropped"] == 0
    # the handover pause was measured on both sides
    assert r["p1"]["handover_ms"]["release"] > 0 and r["p0"]["handover_ms"]["adopt"] > 0


# ---------------------------------------------------------------------------
# kill-the-old-owner-mid-handover (KillPoint at the rebalance.step seam)


def test_rebalance_kill_old_owner_mid_handover_recovers_bit_exact():
    """Gen-1 dies after the route flip, before the barrier checkpoint;
    gen-2 restores the dead host's step-3 checkpoint + journal and
    completes the handover; the new owner adopts. Combined stream and
    blocks are the oracles'."""
    k = th.mesh_rebalance_kill_result()
    gen1 = k["p1_gen1"]["groups"][MOVED]
    gen2 = k["p1_gen2"]["groups"][MOVED]
    p0 = k["p0"]["groups"][MOVED]
    assert k["p1_gen1"]["killed_at"] == th.REBALANCE_AT
    combined = gen1["stream"][: gen1["ckpt_stream_len"]] + gen2["stream"] + p0["stream"]
    blocks = gen1["blocks"][: gen1["ckpt_blocks_len"]] + gen2["blocks"] + p0["blocks"]
    for o in _oracles():
        want = o["groups"][MOVED]
        assert combined == want["stream"]
        assert blocks == want["blocks"]
        for key in ("flow_in", "flushed_doc", "drop_before_window", "window_advances"):
            assert p0["counters"][key] == want["counters"][key], key
    n_move = sum(1 for g in th.agent_groups().values() if g == th.MOVE_GROUP)
    p0c = k["p0"]["receiver"]
    assert p0c["frames_held"] == p0c["frames_redelivered"] == n_move
    assert p0c["frames_held_dropped"] == 0


def test_rebalance_kill_surviving_host_untouched():
    k = th.mesh_rebalance_kill_result()
    for o in _oracles():
        for key in ("stream", "blocks", "counters", "fresh"):
            assert k["p0"]["groups"][STAYED][key] == o["groups"][STAYED][key], key
