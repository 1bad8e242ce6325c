"""The port's elastic topology against the reference's: the 22 cases of
tests/test_rebalance.py — topology overrides and epochs, the rebalance
protocol's edge cases (same-owner counted no-op, single-flight guard,
abort rollback), the ownership-transfer manifest validation (refusals
naming both epochs), the receiver's epoch-flip hold buffer and the
controller's ShardGroupPlanner — each run on both packages with the
same script and held equal: placements (device slices by index),
counters, refusal messages (paths aside), totals after a handover and
the planner's moves. Standalone topologies for different process
indices coexist in one test process, so no subprocess is needed.

The port's topologies here hold `torch.device("cpu", i)` devices: the
index keeps the slices of one CPU apart, as the reference's eight
virtual CPU devices are apart."""

from __future__ import annotations

import types

import pytest
import torch

from deepflow_tpu import chaos as ref_chaos
from deepflow_tpu.aggregator import checkpoint as ref_checkpoint
from deepflow_tpu.controller import rebalance as ref_controller
from deepflow_tpu.ingest import queues as ref_queues
from deepflow_tpu.ingest import receiver as ref_receiver
from deepflow_tpu.ops import histogram as ref_histogram
from deepflow_tpu.parallel import rebalance as ref_rebalance
from deepflow_tpu.parallel import sharded as ref_sharded
from deepflow_tpu.parallel import topology as ref_topology
from deepflow_tpu_torch import chaos
from deepflow_tpu_torch.aggregator import checkpoint
from deepflow_tpu_torch.controller import rebalance as controller
from deepflow_tpu_torch.ingest import queues, receiver
from deepflow_tpu_torch.ops import histogram
from deepflow_tpu_torch.parallel import rebalance, sharded, topology

T0 = 1_700_000_000
N_DEVICES = 8  # the reference's virtual CPU devices (tests/conftest.py)

PORT = types.SimpleNamespace(
    name="port", chaos=chaos, ckpt=checkpoint, controller=controller, queues=queues,
    receiver=receiver, hist=histogram, rebalance=rebalance, sharded=sharded,
    topology=topology)
REF = types.SimpleNamespace(
    name="ref", chaos=ref_chaos, ckpt=ref_checkpoint, controller=ref_controller,
    queues=ref_queues, receiver=ref_receiver, hist=ref_histogram, rebalance=ref_rebalance,
    sharded=ref_sharded, topology=ref_topology)


def _standalone(pkg, pi, pc, *, n_groups=None, devices=None):
    """MeshTopology.standalone with one device a group: the port's on
    distinct CPU device indices, the reference's on its local devices."""
    if pkg is PORT and devices is None:
        devices = [torch.device("cpu", i) for i in range(N_DEVICES)]
    return pkg.topology.MeshTopology.standalone(
        pi, pc, n_groups=n_groups, devices_per_group=1, devices=devices)


def _slice(mesh) -> list[int]:
    """A group mesh's device indices (port cpu:i → i, reference id)."""
    if hasattr(mesh, "flat"):
        return [d.index for d in mesh.flat()]
    return [d.id for d in mesh.devices.ravel()]


def _cfg(pkg):
    return pkg.sharded.ShardedConfig(
        capacity_per_device=1 << 9, num_services=8, hll_precision=6,
        cms_depth=2, cms_width=128,
        hist=pkg.hist.LogHistSpec(bins=16, vmin=1.0, gamma=1.5), topk_cols=32,
    )


def _swm(pkg, topo, group):
    return pkg.sharded.ShardedWindowManager(
        pkg.sharded.ShardedPipeline(topo, _cfg(pkg), shard_group=group), delay=2)


def _gen(pkg, *a, **kw):
    if pkg is PORT:
        from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen
    else:
        from deepflow_tpu.ingest.replay import SyntheticFlowGen
    return SyntheticFlowGen(*a, **kw)


def _encode(pkg, *a, **kw):
    if pkg is PORT:
        from deepflow_tpu_torch.feeder import encode_flowbatch_frames
    else:
        from deepflow_tpu.feeder import encode_flowbatch_frames
    return encode_flowbatch_frames(*a, **kw)


def _feeder_config(pkg, **kw):
    if pkg is PORT:
        from deepflow_tpu_torch.feeder import FeederConfig
    else:
        from deepflow_tpu.feeder import FeederConfig
    return FeederConfig(**kw)


def _feed(pkg, swm, t=T0, n=64, seed=3):
    fb = _gen(pkg, num_tuples=32, seed=seed).flow_batch(n, t)
    return swm.ingest(fb.tags, fb.meters, fb.valid)


def _dir(tmp_path, pkg):
    """A journal directory of its own for each package's run."""
    d = tmp_path / pkg.name
    d.mkdir(exist_ok=True)
    return d


def _both(fn):
    """fn(pkg) for the port and the reference; the two results."""
    return fn(PORT), fn(REF)


# ---------------------------------------------------------------------------
# topology overrides + epochs


def test_topology_rebalanced_overrides_and_epoch():
    def run(pkg):
        t0, t1 = _standalone(pkg, 0, 2, n_groups=2), _standalone(pkg, 1, 2, n_groups=2)
        assert t0.owned_groups() == (0,) and t1.owned_groups() == (1,)
        n0, n1 = t0.rebalanced(1, 0), t1.rebalanced(1, 0)
        # pure function: both hosts derive the identical placement + epoch
        assert n0.owned_groups() == (0, 1) and n1.owned_groups() == ()
        assert n0.topology_epoch == n1.topology_epoch == 1
        assert n0.group_process(1) == n1.group_process(1) == 0
        # moving a group back home drops the override but still bumps
        # the epoch (it IS a topology change)
        back = n0.rebalanced(1, 1)
        assert back.group_overrides == () and back.topology_epoch == 2
        assert back.owned_groups() == (0,)
        return [(t.owned_groups(), t.group_overrides, t.topology_epoch)
                for t in (n0, n1, back)]

    port, ref = _both(run)
    assert port == ref


def test_topology_adopted_group_mesh_uses_spare_devices():
    def run(pkg):
        t0 = _standalone(pkg, 0, 2, n_groups=2)
        n0 = t0.rebalanced(1, 0)
        # the block group's devices never move under a flip; the adopted
        # group sits on the spare slice after the block range
        assert _slice(n0.group_mesh(0)) == _slice(t0.group_mesh(0))
        adopted = _slice(n0.group_mesh(1))
        assert adopted and adopted != _slice(n0.group_mesh(0))
        # a destination without spare local devices refuses loudly
        starved = _standalone(pkg, 0, 2, n_groups=2, devices=t0.local_devices[:1])
        with pytest.raises(ValueError, match="local") as ei:
            starved.rebalanced(1, 0)
        return adopted, str(ei.value)

    port, ref = _both(run)
    assert port == ref


def test_topology_later_adoption_never_rehomes_an_earlier_one():
    def run(pkg):
        t0 = _standalone(pkg, 0, 4, n_groups=4)
        one = t0.rebalanced(3, 0)
        devs3 = _slice(one.group_mesh(3))
        two = one.rebalanced(1, 0)
        assert _slice(two.group_mesh(3)) == devs3
        assert _slice(two.group_mesh(1)) != devs3
        assert two.owned_groups() == (0, 3, 1)
        return devs3, _slice(two.group_mesh(1)), two.group_overrides

    port, ref = _both(run)
    assert port == ref


def test_topology_readoption_appends_as_newest_adoption():
    def run(pkg):
        t0 = _standalone(pkg, 0, 4, n_groups=4)
        two = t0.rebalanced(2, 0).rebalanced(3, 0)  # adoption order (2, 3)
        gone = two.rebalanced(2, 1)  # g2 leaves; g3 compacts to slice 0
        devs3 = _slice(gone.group_mesh(3))
        back = gone.rebalanced(2, 0)  # g2 returns
        assert back.owned_groups() == (0, 3, 2)  # appended, not resurrected
        assert _slice(back.group_mesh(3)) == devs3
        assert _slice(back.group_mesh(2)) != devs3
        return devs3, _slice(back.group_mesh(2)), back.group_overrides, back.topology_epoch

    port, ref = _both(run)
    assert port == ref


def test_topology_describe_carries_epoch_and_owner():
    def run(pkg):
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        d = t1.describe()
        assert d["process_index"] == 1 and d["topology_epoch"] == 0
        assert t1.rebalanced(1, 0).describe()["topology_epoch"] == 1
        return d, t1.rebalanced(1, 0).describe()

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# protocol edge cases


def test_rebalance_to_same_owner_is_counted_noop():
    def run(pkg):
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        reb = pkg.rebalance.GroupRebalancer(t1, name=f"noop-test-{pkg.name}")
        assert pkg.rebalance.plan_move(t1, 1, 1) is None
        assert reb.plan(1, 1) is None
        c = reb.get_counters()
        assert c["rebalance_noops"] == 1
        assert c["rebalances_planned"] == 0
        assert c["topology_epoch"] == 0  # nothing published
        return c

    port, ref = _both(run)
    assert port == ref


def test_concurrent_rebalance_same_group_fails_loudly():
    def run(pkg):
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        reb = pkg.rebalance.GroupRebalancer(t1, name="flight-test")
        plan = reb.plan(1, 0)
        assert plan is not None
        with pytest.raises(pkg.chaos.RebalanceAbortError, match="single-flight") as ei:
            reb.plan(1, 0)
        # aborting the first clears the guard
        reb.abort(plan)
        assert reb.plan(1, 0) is not None
        assert reb.get_counters()["rebalance_aborts"] == 1
        return str(ei.value), reb.get_counters(), plan.manifest_meta()

    port, ref = _both(run)
    assert port == ref


def test_claim_fault_counts_abort_and_releases_guard():
    """A scripted fault at the claim step must not strand the group in
    the single-flight guard — the counted abort frees it."""
    def run(pkg):
        ch = pkg.chaos
        t0 = _standalone(pkg, 0, 2, n_groups=2)
        reb = pkg.rebalance.GroupRebalancer(t0, name="claim-test")
        plan = reb.plan(1, 0)
        ch.install(ch.FaultPlan().add(ch.FaultRule(
            site=ch.SITE_REBALANCE_STEP, error=ch.InjectedFault, at=(0,),
        )))
        try:
            with pytest.raises(ch.RebalanceAbortError, match="claim of group 1"):
                reb.claim(plan)
        finally:
            ch.uninstall()
        c = reb.get_counters()
        assert c["rebalance_aborts"] == 1 and c["inflight"] == 0
        # nothing moved; the retry plans and claims cleanly
        assert reb.topology.topology_epoch == 0
        plan2 = reb.plan(1, 0)
        assert reb.claim(plan2).topology_epoch == 1
        return c, reb.get_counters()

    port, ref = _both(run)
    assert port == ref


def test_claim_failure_after_flip_rolls_back_so_retry_replans():
    """A claim that fails AFTER adopting the epoch (the receiver attach
    raising) rolls the topology back, so the retry re-plans."""
    def run(pkg):
        t0 = _standalone(pkg, 0, 2, n_groups=2)
        reb = pkg.rebalance.GroupRebalancer(t0, name="claim-rollback-test")

        class _BoomReceiver:
            routing = None
            calls = 0

            def attach_topology(self, topology, handoff=None):
                self.calls += 1
                if self.calls == 1:
                    raise RuntimeError("boom")

        rx = _BoomReceiver()
        plan = reb.plan(1, 0)
        with pytest.raises(pkg.chaos.RebalanceAbortError, match="claim of group 1") as ei:
            reb.claim(plan, receiver=rx)
        assert reb.topology.topology_epoch == 0  # rolled back
        assert rx.calls == 2  # the rollback re-attached the previous epoch
        plan2 = reb.plan(1, 0)  # the retry RE-PLANS — not a counted no-op
        assert plan2 is not None
        assert reb.claim(plan2, receiver=rx).topology_epoch == 1
        return str(ei.value), reb.get_counters()

    port, ref = _both(run)
    assert port == ref


def test_release_abort_restores_preexisting_handoff(tmp_path):
    """An aborted release rolls the receiver back to its PRE-FLIP
    handoff, not to handoff=None."""
    def run(pkg):
        ch = pkg.chaos
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        rx = pkg.receiver.Receiver()

        def boot_handoff(group, raw):  # the fleet's bring-up forward
            return None

        rx.attach_topology(t1, boot_handoff)
        reb = pkg.rebalance.GroupRebalancer(t1, name="handoff-rollback-test")
        swm = _swm(pkg, t1, 1)
        feeder = swm.make_feeder([pkg.queues.PyOverwriteQueue(64)], (64,),
                                 journal_dir=_dir(tmp_path, pkg))
        plan = reb.plan(1, 0)
        fault = ch.FaultPlan().add(ch.FaultRule(
            site=ch.SITE_REBALANCE_STEP, error=ch.TransientDeviceError,
            at=(1,),  # after the flip, before the quiesce
        ))
        with ch.active(fault):
            with pytest.raises(ch.RebalanceAbortError):
                reb.release(plan, feeder=feeder, save=lambda extra: None,
                            receiver=rx, handoff=lambda group, raw: None)
        topo, handoff, epoch = rx.routing
        assert topo is t1
        assert handoff is boot_handoff  # restored, not None
        swm.close()
        return epoch, reb.get_counters()

    port, ref = _both(run)
    assert port == ref


def test_release_abort_rolls_route_table_back(tmp_path):
    """An injected fault at the rebalance.step seam mid-release aborts
    LOUDLY and re-publishes the previous epoch."""
    def run(pkg):
        ch = pkg.chaos
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        reb = pkg.rebalance.GroupRebalancer(t1, name="abort-test")
        swm = _swm(pkg, t1, 1)
        feeder = swm.make_feeder([pkg.queues.PyOverwriteQueue(64)], (64,),
                                 journal_dir=_dir(tmp_path, pkg))
        plan = reb.plan(1, 0)

        def save(extra):
            return pkg.ckpt.save_sharded_state(swm, tmp_path / f"{pkg.name}.h.ckpt",
                                               extra_meta=extra)

        fault = ch.FaultPlan().add(ch.FaultRule(
            site=ch.SITE_REBALANCE_STEP, error=ch.TransientDeviceError, at=(1,),
        ))
        with ch.active(fault):
            with pytest.raises(ch.RebalanceAbortError) as ei:
                reb.release(plan, feeder=feeder, save=save)
        assert reb.topology is t1  # rolled back
        c = reb.get_counters()
        assert c["rebalance_aborts"] == 1 and c["inflight"] == 0
        # the aborted move leaves the group fully operable here
        plan2 = reb.plan(1, 0)
        assert plan2 is not None and plan2.epoch == 1
        swm.close()
        return c, list(ei.value.outputs)

    port, ref = _both(run)
    assert port == ref


def test_quiesce_drains_large_fenced_backlog(tmp_path):
    """A FENCED backlog larger than any fixed pump allowance drains to
    completion: quiesce keys its abort on backlog PROGRESS."""
    def run(pkg):
        t1 = _standalone(pkg, 1, 2, n_groups=2)
        swm = _swm(pkg, t1, 1)
        q = pkg.queues.PyOverwriteQueue(512)
        feeder = swm.make_feeder(
            [q], (64,), _feeder_config(pkg, frames_per_queue=1, rounds_per_pump=1),
            journal_dir=_dir(tmp_path, pkg))
        gen = _gen(pkg, num_tuples=16, seed=11)
        n_frames = 0
        for i in range(17):
            for fr in _encode(pkg, gen.flow_batch(16, T0 + i), agent_id=7,
                              max_rows_per_frame=4):
                assert q.put(fr)
                n_frames += 1
        assert n_frames > 64  # a fixed 64-pump cap would spuriously abort
        out = feeder.quiesce(lambda meta: None)
        assert len(q) == 0
        assert feeder.get_counters()["records_in"] == 17 * 16
        counters = {k: swm.get_counters()[k] for k in ("flow_in", "flushed_doc",
                                                       "window_advances")}
        swm.close()
        return n_frames, feeder.get_counters()["records_in"], counters, \
            [int(db.size) for db in out]

    port, ref = _both(run)
    assert port == ref


def test_quiesce_unfenced_admission_aborts_loudly(tmp_path):
    """A queue whose backlog never shrinks across a pump (admission NOT
    fenced) aborts loudly instead of pumping forever."""
    def run(pkg):
        (frame,) = _encode(pkg, _gen(pkg, num_tuples=8, seed=12).flow_batch(4, T0),
                           agent_id=7)

        class _RefillingQueue:
            """Every drained frame is immediately replaced."""

            capacity = 0
            closed = False

            def __len__(self):
                return 4

            def gets(self, n, timeout_ms=0):
                return [frame] * max(1, min(n, 4))

        t1 = _standalone(pkg, 1, 2, n_groups=2)
        swm = _swm(pkg, t1, 1)
        feeder = swm.make_feeder([_RefillingQueue()], (64,), _feeder_config(pkg),
                                 journal_dir=_dir(tmp_path, pkg))
        with pytest.raises(pkg.chaos.RebalanceAbortError, match="not fenced") as ei:
            feeder.quiesce(lambda meta: None)
        swm.close()
        return str(ei.value).split(": ", 1)[1]

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# ownership-transfer manifest validation at restore


def _handover_ckpt(pkg, tmp_path, *, manifest=True, epoch_delta=0):
    """Save group 1 under its old owner (standalone p1), optionally with
    a transfer manifest; return (path, new-owner topology)."""
    t1 = _standalone(pkg, 1, 2, n_groups=2)
    old = _swm(pkg, t1, 1)
    _feed(pkg, old)
    path = tmp_path / f"{pkg.name}.hand.ckpt"
    extra = None
    if manifest:
        plan = pkg.rebalance.plan_move(t1, 1, 0)
        extra = dict(plan.manifest_meta())
        if epoch_delta:
            extra["handover"] = dict(extra["handover"])
            extra["handover"]["topology_epoch"] += epoch_delta
    pkg.ckpt.save_sharded_state(old, path, extra_meta=extra)
    old.close()
    return path, _standalone(pkg, 0, 2, n_groups=2).rebalanced(1, 0)


def _refusal(pkg, swm, path) -> str:
    """restore_sharded_state's refusal with the file's path taken out."""
    with pytest.raises(ValueError) as ei:
        pkg.ckpt.restore_sharded_state(swm, path)
    swm.close()
    return str(ei.value).replace(str(path), "<path>")


def test_stale_checkpoint_without_manifest_refused_naming_both_epochs(tmp_path):
    def run(pkg):
        path, t0_new = _handover_ckpt(pkg, tmp_path, manifest=False)
        msg = _refusal(pkg, _swm(pkg, t0_new, 1), path)
        # both epochs named: the checkpoint's (0) and the restorer's (1)
        assert "epoch 0" in msg and "epoch 1" in msg
        assert "pre-handover" in msg
        return msg

    port, ref = _both(run)
    assert port == ref


def test_manifest_with_wrong_epoch_refused_naming_both_epochs(tmp_path):
    def run(pkg):
        path, t0_new = _handover_ckpt(pkg, tmp_path, epoch_delta=5)
        msg = _refusal(pkg, _swm(pkg, t0_new, 1), path)
        assert "epoch 6" in msg and "epoch 1" in msg
        return msg

    port, ref = _both(run)
    assert port == ref


def test_old_owner_restoring_its_own_handover_checkpoint_refused(tmp_path):
    """The host that RELEASED a group must not restore the handover
    barrier it wrote (split-brain over one key-hash range)."""
    def run(pkg):
        path, _ = _handover_ckpt(pkg, tmp_path)
        msg = _refusal(pkg, _swm(pkg, _standalone(pkg, 1, 2, n_groups=2), 1), path)
        assert "transferred group 1 to process 0" in msg
        return msg

    port, ref = _both(run)
    assert port == ref


def test_manifest_handover_restores_and_preserves_totals(tmp_path):
    def run(pkg):
        path, t0_new = _handover_ckpt(pkg, tmp_path)
        fresh = _swm(pkg, t0_new, 1)
        pkg.ckpt.restore_sharded_state(fresh, path)
        totals = [fresh.total_docs_in]  # counters continue across owners
        out = _feed(pkg, fresh, t=T0 + 1, seed=4)
        totals.append(fresh.total_docs_in)
        assert totals == [64, 128]
        c = {k: fresh.get_counters()[k] for k in ("flow_in", "flushed_doc",
                                                  "drop_before_window", "window_advances")}
        fresh.close()
        return totals, c, [int(db.size) for db in out]

    port, ref = _both(run)
    assert port == ref


def test_manifest_to_other_process_refused(tmp_path):
    def run(pkg):
        t1 = _standalone(pkg, 1, 3, n_groups=3)
        old = _swm(pkg, t1, 1)
        _feed(pkg, old)
        path = tmp_path / f"{pkg.name}.h.ckpt"
        pkg.ckpt.save_sharded_state(
            old, path, extra_meta=pkg.rebalance.plan_move(t1, 1, 2).manifest_meta())
        old.close()
        hijacker = _standalone(pkg, 0, 3, n_groups=3).rebalanced(1, 0)
        msg = _refusal(pkg, _swm(pkg, hijacker, 1), path)
        assert "to process 2" in msg
        return msg

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# receiver epoch-flip hold buffer


def _frame(pkg, agent_id: int, org_id: int = 1) -> bytes:
    fb = _gen(pkg, num_tuples=8, seed=9).flow_batch(4, T0)
    (raw,) = _encode(pkg, fb, agent_id=agent_id, org_id=org_id)
    return raw


def test_receiver_holds_and_redelivers_across_epoch_flip():
    from deepflow_tpu_torch.ingest.framing import HEADER_LEN, FlowHeader, MessageType

    def run(pkg):
        rx = pkg.receiver.Receiver(held_frames_cap=2)
        # an agent whose key-hash group is 1 of 2
        agent = next(a for a in range(64) if pkg.topology.key_shard_group(1, a, 2) == 1)
        raw = _frame(pkg, agent)
        header = FlowHeader.parse(raw[:HEADER_LEN])
        topo = _standalone(pkg, 0, 2, n_groups=2)
        q0 = [pkg.queues.PyOverwriteQueue(16)]
        rx.attach_topology(topo, handoff=None)
        rx.register_handler(MessageType.TAGGEDFLOW, q0, shard_group=0)
        # pre-flip: group 1 is remote — counted misroute (no handoff → drop)
        rx._dispatch(header, raw, ("t", 0))
        assert rx.counters["frames_misrouted"] == 1
        # flip: this process now owns group 1, but its handler is still
        # mid-restore — frames HOLD instead of misrouting
        rx.attach_topology(topo.rebalanced(1, 0), handoff=None)
        for _ in range(3):  # cap is 2: the third sheds the oldest, counted
            rx._dispatch(header, raw, ("t", 0))
        assert rx.counters["frames_held"] == 3
        assert rx.counters["frames_held_dropped"] == 1
        assert rx.counters["frames_misrouted"] == 1  # unchanged
        # registration redelivers the held frames, in order, into the queue
        q1 = [pkg.queues.PyOverwriteQueue(16)]
        rx.register_handler(MessageType.TAGGEDFLOW, q1, shard_group=1)
        assert rx.counters["frames_redelivered"] == 2
        assert len(q1[0]) == 2 and len(q0[0]) == 0
        return agent, dict(rx.counters), q1[0].gets(2, timeout_ms=0)

    port, ref = _both(run)
    assert port == ref


def test_receiver_flip_away_forwards_previously_held_frames():
    """A held frame whose group flips AWAY on the next epoch leaves
    through the handoff, not the hold."""
    from deepflow_tpu_torch.ingest.framing import HEADER_LEN, FlowHeader, MessageType

    def run(pkg):
        rx = pkg.receiver.Receiver()
        agent = next(a for a in range(64) if pkg.topology.key_shard_group(1, a, 2) == 1)
        raw = _frame(pkg, agent)
        header = FlowHeader.parse(raw[:HEADER_LEN])
        base = _standalone(pkg, 0, 2, n_groups=2)
        rx.register_handler(MessageType.TAGGEDFLOW, [pkg.queues.PyOverwriteQueue(16)],
                            shard_group=0)
        forwarded = []
        rx.attach_topology(base.rebalanced(1, 0), handoff=forwarded.append)
        rx._dispatch(header, raw, ("t", 0))
        assert rx.counters["frames_held"] == 1
        # the move reverses: group 1 goes home — the held frame follows
        rx.attach_topology(base.rebalanced(1, 0).rebalanced(1, 1),
                           handoff=lambda g, f: forwarded.append((g, len(f))))
        assert rx.counters["frames_redelivered"] == 1
        assert rx.counters["frames_misrouted"] == 1
        assert forwarded == [(1, len(raw))]
        return dict(rx.counters), forwarded

    port, ref = _both(run)
    assert port == ref


# ---------------------------------------------------------------------------
# controller planning


def test_shard_group_planner_moves_dead_hosts_groups():
    def run(pkg):
        pl = pkg.controller.ShardGroupPlanner(dead_after_s=10)
        plans = []
        pl.heartbeat(0, [0], now=0.0)
        pl.heartbeat(1, [1, 2], now=0.0)
        pl.heartbeat(2, [3], now=0.0)
        plans.append(pl.plan_moves(now=1.0))
        assert plans[-1] == []
        # host 1 dies: its two groups spread least-loaded-first
        pl.heartbeat(0, [0], now=20.0)
        pl.heartbeat(2, [3], now=20.0)
        plans.append(pl.plan_moves(now=21.0))
        assert plans[-1] == [(1, 0), (2, 2)]
        assert pl.counters["moves_planned"] == 2
        # level-triggered: until an owner claims them, the same stranded
        # groups keep being planned...
        plans.append(pl.plan_moves(now=21.0))
        assert plans[-1] == [(1, 0), (2, 2)]
        # ...and once live owners heartbeat them, the rescue is DONE
        pl.heartbeat(0, [0, 1], now=22.0)
        pl.heartbeat(2, [3, 2], now=22.0)
        plans.append(pl.plan_moves(now=23.0))
        assert plans[-1] == []
        # maintenance drain of a LIVE host empties it onto the others
        plans.append(pl.plan_drain(2, now=23.0))
        assert plans[-1] == [(2, 0), (3, 0)]
        return plans, dict(pl.counters)

    port, ref = _both(run)
    assert port == ref


def test_shard_group_planner_dedupes_group_listed_by_two_dead_hosts():
    """Owner died, rescuer adopted, then the rescuer died: the group sits
    in TWO dead records and is still planned exactly once."""
    def run(pkg):
        pl = pkg.controller.ShardGroupPlanner(dead_after_s=10)
        pl.heartbeat(0, [0], now=0.0)
        pl.heartbeat(1, [5], now=0.0)     # original owner…
        pl.heartbeat(2, [5], now=5.0)     # …rescuer adopted 5, then
        pl.heartbeat(0, [0], now=30.0)    # both went silent
        moves = pl.plan_moves(now=31.0)
        assert moves == [(5, 0)]
        assert pl.counters["moves_planned"] == 1
        return moves, dict(pl.counters)

    port, ref = _both(run)
    assert port == ref
