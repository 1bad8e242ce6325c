"""Shard-group rebalancing with checkpoint handover (port of
deepflow_tpu/parallel/rebalance.py; plain Python over the port's
feeder, receiver and sharded checkpoint).

A (process → shard group) map frozen at bring-up would make losing or
adding a host a fleet restart. The reference treats
reassignment as routine — the controller re-maps agents to analyzers
and the ingester keeps going — and this module is that move for shard
groups: a controller-driven protocol that transfers ONE group from its
current owner to another process without data loss, built entirely
from machinery the stack already has:

    quiesce    — drain-to-barrier (FeederRuntime.quiesce: the
                 checkpoint barrier, preceded by pump-until-empty)
    checkpoint — save_sharded_state under the OLD owner, with an
                 ownership-transfer manifest in the meta and the
                 journal rotated at the barrier
    publish    — a new topology epoch (MeshTopology.rebalanced): a
                 pure function of (old topology, move), so every host
                 derives the identical table and the epoch number
                 alone is the handshake
    restore    — restore_sharded_state on the NEW owner, through the
                 loud topology validation extended to accept exactly the
                 published manifest (anything else refuses, naming
                 both epochs)
    flip       — the receiver's route table swaps atomically
                 (attach_topology); in-flight frames for the moving
                 group are either HELD-and-redelivered on the new
                 owner (the receiver's epoch-flip hold buffer) or
                 FORWARDED by the old owner over the real handoff
                 transport (ingest/handoff.py) — never dropped
                 uncounted

Failure stance: every protocol step crosses the `rebalance.step` chaos
seam, so CI scripts mid-protocol death (KillPoint pierces — the
kill-the-old-owner-mid-handover drill) and injected step faults
deterministically. A recoverable failure aborts LOUDLY
(chaos.RebalanceAbortError) and rolls the route table back — an
aborted move leaves the group exactly where it was, served by its old
owner, with the pre-abort drain's outputs still delivered
(err.outputs). Two concurrent moves of the same group trip the
single-flight guard; a move to the current owner is a counted no-op.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

from .. import chaos
from ..chaos import RebalanceAbortError
from .topology import MeshTopology

_log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class RebalancePlan:
    """One agreed move: the pre-move topology, the post-move topology
    (epoch bumped), and the manifest the handover checkpoint embeds."""

    group: int
    from_process: int
    to_process: int
    previous: MeshTopology
    topology: MeshTopology  # the published (post-move) epoch

    @property
    def epoch(self) -> int:
        return self.topology.topology_epoch

    def manifest_meta(self) -> dict:
        """The `extra_meta` fragment the barrier checkpoint embeds —
        restore_sharded_state validates it on the new owner."""
        return {"handover": {
            "group": self.group,
            "from_process": self.from_process,
            "to_process": self.to_process,
            "topology_epoch": self.epoch,
        }}


def plan_move(topology: MeshTopology, group: int,
              to_process: int) -> RebalancePlan | None:
    """Pure planning: None when `group` already lives on `to_process`
    (the caller counts the no-op), else the agreed plan. Every host
    computing this from the same topology gets the identical plan —
    the controller only has to broadcast (group, to_process)."""
    if topology.group_process(group) == to_process:
        return None
    return RebalancePlan(
        group=group,
        from_process=topology.group_process(group),
        to_process=to_process,
        previous=topology,
        topology=topology.rebalanced(group, to_process),
    )


class GroupRebalancer:
    """One host's half of the rebalance protocol. Owns the host's
    current topology epoch, the single-flight guard, and the counted
    outcome lanes (queryable in deepflow_system as tpu_rebalance_*)."""

    def __init__(self, topology: MeshTopology, *, name: str = "rebalance"):
        self.topology = topology
        self.name = name
        self._lock = threading.Lock()
        self._inflight: set[int] = set()
        self.counters = {
            "rebalances_planned": 0,
            "rebalances_completed": 0,
            "rebalance_noops": 0,
            "rebalance_aborts": 0,
        }
        from ..utils.stats import register_countable

        self._stats_src = register_countable("tpu_rebalance", self, name=name)

    def get_counters(self) -> dict:
        with self._lock:
            out = dict(self.counters)
        out["inflight"] = len(self._inflight)
        out["topology_epoch"] = self.topology.topology_epoch
        return out

    # -- planning ---------------------------------------------------------
    def plan(self, group: int, to_process: int) -> RebalancePlan | None:
        """Agree a move against the CURRENT epoch. A move to the
        group's current owner is a counted no-op (None). Two in-flight
        plans for the same group fail loudly — the single-flight guard:
        a second controller request must wait for (or abort) the first,
        never interleave two checkpoints of one group."""
        with self._lock:
            p = plan_move(self.topology, group, to_process)
            if p is None:
                self.counters["rebalance_noops"] += 1
                _log.info(
                    "%s: group %d already on process %d — counted no-op",
                    self.name, group, to_process,
                )
                return None
            if group in self._inflight:
                raise RebalanceAbortError(
                    f"{self.name}: a rebalance of group {group} is "
                    "already in flight (single-flight guard) — complete "
                    "or abort it before planning another"
                )
            self._inflight.add(group)
            self.counters["rebalances_planned"] += 1
            return p

    def _finish(self, plan: RebalancePlan, lane: str) -> None:
        with self._lock:
            self._inflight.discard(plan.group)
            self.counters[lane] += 1

    def abort(self, plan: RebalancePlan) -> None:
        self._finish(plan, "rebalance_aborts")

    # -- old-owner half ---------------------------------------------------
    def release(self, plan: RebalancePlan, *, feeder, save,
                receiver=None, handoff=None,
                prev_handoff=None) -> list:
        """Give the group up: flip the route table (frames start
        forwarding through `handoff` — misroutes, counted, over the
        real transport), drain-to-barrier, write the manifest-bearing
        handover checkpoint, rotate the journal. `save` is the
        feeder.checkpoint closure (extra_meta dict → checkpoint write);
        the manifest merges into the barrier meta here so callers keep
        their checkpoint-barrier save closures unchanged.

        Returns the drain's flushed outputs. On a recoverable failure:
        counted abort, route table ROLLED BACK to the previous epoch
        (the group stays served here), RebalanceAbortError raised with
        `.outputs` carrying anything the drain already flushed.
        KillPoint pierces — death mid-release is the chaos drill, and
        recovery is this host's own checkpoint + journal."""
        out: list = []
        if prev_handoff is None and receiver is not None:
            # capture the pre-flip handoff so an abort rollback keeps
            # the host's EXISTING misroute forwarding — rolling back to
            # handoff=None would silently degrade fan-in for every
            # group on this host after one aborted move
            prev = receiver.routing
            if prev is not None:
                prev_handoff = prev[1]
        try:
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: flip
            self.topology = plan.topology
            if receiver is not None:
                receiver.attach_topology(plan.topology, handoff)
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: quiesce
            out = feeder.quiesce(
                lambda barrier: save(
                    {**(barrier or {}), **plan.manifest_meta()}
                )
            )
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: complete
        except chaos.KillPoint:
            raise  # process death: nothing in-process may absorb it
        except Exception as exc:
            out = list(getattr(exc, "outputs", out))
            # roll the route table back: the group did not move
            self.topology = plan.previous
            if receiver is not None:
                receiver.attach_topology(plan.previous, prev_handoff)
            self._finish(plan, "rebalance_aborts")
            _log.warning(
                "%s: release of group %d to process %d aborted (%s) — "
                "route table rolled back to epoch %d",
                self.name, plan.group, plan.to_process, exc,
                plan.previous.topology_epoch,
            )
            if isinstance(exc, RebalanceAbortError):
                exc.outputs = out
                raise
            err = RebalanceAbortError(
                f"{self.name}: release of group {plan.group} failed: "
                f"{exc!r}"
            )
            err.outputs = out
            raise err from exc
        self._finish(plan, "rebalances_completed")
        return out

    # -- new-owner half ---------------------------------------------------
    def claim(self, plan: RebalancePlan, *, receiver=None,
              handoff=None, prev_handoff=None) -> MeshTopology:
        """Adopt the published epoch BEFORE any state arrives: from
        here, frames for the moving group that reach this host are
        HELD by the receiver (no handler yet) instead of misrouting
        back toward the old owner — the no-ping-pong half of the flip.
        A failure here is a counted abort that ROLLS BACK to the
        previous epoch and releases the single-flight guard (the move
        never started on this host), so the controller's retry
        re-plans the move instead of no-opping against a
        half-flipped topology."""
        if prev_handoff is None and receiver is not None:
            prev = receiver.routing
            if prev is not None:
                prev_handoff = prev[1]
        try:
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: claim
            self.topology = plan.topology
            if receiver is not None:
                receiver.attach_topology(plan.topology, handoff)
        except chaos.KillPoint:
            raise
        except Exception as exc:
            # roll back: this host never adopted the group, so its
            # topology must still say so — a retry's plan() would
            # otherwise see the move as already done (counted no-op)
            # and strand the group with no handler anywhere
            self.topology = plan.previous
            if receiver is not None:
                receiver.attach_topology(plan.previous, prev_handoff)
            self._finish(plan, "rebalance_aborts")
            if isinstance(exc, RebalanceAbortError):
                raise
            raise RebalanceAbortError(
                f"{self.name}: claim of group {plan.group} failed: "
                f"{exc!r}"
            ) from exc
        return plan.topology

    def adopt(self, plan: RebalancePlan, *, swm, ckpt_path,
              register=None):
        """Take the group over: restore the handover checkpoint into a
        freshly-built manager for the group (the loud validation
        demands the manifest published for THIS epoch — a stale file
        refuses, naming both epochs), then `register()` the handler —
        which also redelivers every frame the receiver held across the
        flip. Failures are counted aborts; the hold buffer keeps
        absorbing until a retry lands or the controller reverses the
        move."""
        from ..aggregator.checkpoint import restore_sharded_state

        try:
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: restore
            restore_sharded_state(swm, ckpt_path)
            chaos.maybe_fail(chaos.SITE_REBALANCE_STEP)  # step: register
            if register is not None:
                register()
        except chaos.KillPoint:
            raise
        except Exception as exc:
            self._finish(plan, "rebalance_aborts")
            if isinstance(exc, RebalanceAbortError):
                raise
            raise RebalanceAbortError(
                f"{self.name}: adopt of group {plan.group} failed: "
                f"{exc!r}"
            ) from exc
        self._finish(plan, "rebalances_completed")
        return swm
