"""Analyzer assignment & rebalance (port of
deepflow_tpu/controller/rebalance.py; plain Python).

The reference's controller/monitor/analyzer.go watches ingester
(analyzer) liveness and redistributes agents when one dies or load
skews (vtap counts weighted by analyzer capacity); assignments ride to
agents in the trisolaris sync response. Same model: analyzers register
with a capacity weight and heartbeat; `assign()` gives an agent the
least-loaded live analyzer and is sticky; `rebalance()` drains dead
analyzers and narrows the load spread to within one agent of the
weighted ideal.

`ShardGroupPlanner` is the same watch-and-redistribute
model one level down: PROCESSES of the device mesh heartbeat here, and
when one dies (or is drained for maintenance) the planner emits the
(group, to_process) moves that `parallel/rebalance.GroupRebalancer`
executes — the controller decides, the hosts run the quiesce →
checkpoint → publish → restore → flip protocol.
"""

from __future__ import annotations

import threading
import time


class AnalyzerBalancer:
    def __init__(self, *, dead_after_s: float = 60.0):
        self.dead_after_s = dead_after_s
        self._analyzers: dict[str, dict] = {}  # ip → {capacity, last_seen}
        self._assign: dict[int, str] = {}  # agent_id → analyzer ip
        self._lock = threading.Lock()
        self.counters = {"assigns": 0, "moves": 0, "drains": 0}

    # -- analyzer registry ---------------------------------------------
    def register(self, ip: str, *, capacity: int = 1, now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._analyzers[ip] = {"capacity": max(1, capacity), "last_seen": now}

    def heartbeat(self, ip: str, now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            if ip in self._analyzers:
                self._analyzers[ip]["last_seen"] = now

    def _alive(self, now: float) -> list[str]:
        return [
            ip
            for ip, a in self._analyzers.items()
            if now - a["last_seen"] <= self.dead_after_s
        ]

    def _loads(self) -> dict[str, int]:
        loads = {ip: 0 for ip in self._analyzers}
        for ip in self._assign.values():
            if ip in loads:
                loads[ip] += 1
        return loads

    # -- assignment -----------------------------------------------------
    def assign(self, agent_id: int, now: float | None = None) -> str | None:
        """Sticky least-normalized-load placement; None when no live
        analyzer exists (agents then keep their last assignment —
        escape semantics live agent-side)."""
        now = time.time() if now is None else now
        with self._lock:
            alive = set(self._alive(now))
            cur = self._assign.get(agent_id)
            if cur in alive:
                return cur
            if not alive:
                return None
            loads = self._loads()
            ip = min(
                alive,
                key=lambda i: (loads[i] / self._analyzers[i]["capacity"], i),
            )
            self._assign[agent_id] = ip
            self.counters["assigns"] += 1
            return ip

    def rebalance(self, now: float | None = None) -> int:
        """Drain dead analyzers, then move agents from over- to
        under-loaded ones until every analyzer is within one agent of
        its weighted share. Returns number of moves."""
        now = time.time() if now is None else now
        moves = 0
        with self._lock:
            alive = self._alive(now)
            if not alive:
                return 0
            alive_set = set(alive)
            # 1. drain: agents on dead analyzers
            orphans = [a for a, ip in self._assign.items() if ip not in alive_set]
            for a in orphans:
                del self._assign[a]
            self.counters["drains"] += len(orphans)

            total_cap = sum(self._analyzers[ip]["capacity"] for ip in alive)

            def ideal(ip: str, n_agents: int) -> float:
                return n_agents * self._analyzers[ip]["capacity"] / total_cap

            # re-place orphans least-loaded-first
            for a in sorted(orphans):
                loads = self._loads()
                ip = min(
                    alive, key=lambda i: (loads[i] / self._analyzers[i]["capacity"], i)
                )
                self._assign[a] = ip
                moves += 1

            # 2. narrow the spread
            n = len(self._assign)
            for _ in range(n):
                loads = self._loads()
                over = max(alive, key=lambda i: loads[i] - ideal(i, n))
                under = min(alive, key=lambda i: loads[i] - ideal(i, n))
                if loads[over] - ideal(over, n) <= 1.0:
                    break
                movable = [a for a, ip in self._assign.items() if ip == over]
                if not movable:
                    break
                self._assign[min(movable)] = under
                moves += 1
            self.counters["moves"] += moves
        return moves

    def assignments(self) -> dict[int, str]:
        with self._lock:
            return dict(self._assign)


class ShardGroupPlanner:
    """Controller-side planning for shard-group rebalances.

    Mesh processes heartbeat with their owned groups; `plan_moves()`
    emits (group, to_process) moves for every group stranded on a dead
    process, least-loaded-first, and `plan_drain(p)` empties a live
    process for decommission the same way. The planner only DECIDES —
    executing a move is `parallel/rebalance.GroupRebalancer` on the
    hosts (quiesce → checkpoint → publish → restore → flip), so a
    planner crash mid-sequence loses nothing but pending intent."""

    def __init__(self, *, dead_after_s: float = 60.0):
        self.dead_after_s = dead_after_s
        self._procs: dict[int, dict] = {}  # process → {groups, last_seen}
        self._lock = threading.Lock()
        self.counters = {"moves_planned": 0, "drains_planned": 0}

    def heartbeat(self, process: int, groups, *,
                  now: float | None = None) -> None:
        now = time.time() if now is None else now
        with self._lock:
            self._procs[int(process)] = {
                "groups": sorted(int(g) for g in groups),
                "last_seen": now,
            }

    def _alive(self, now: float) -> list[int]:
        return sorted(
            p for p, rec in self._procs.items()
            if now - rec["last_seen"] <= self.dead_after_s
        )

    def _spread(self, groups, targets, loads) -> list[tuple[int, int]]:
        """Stranded groups → least-loaded live targets, deterministic
        (sorted groups, ties broken by process index)."""
        moves = []
        for g in sorted(groups):
            to = min(targets, key=lambda p: (loads[p], p))
            moves.append((g, to))
            loads[to] += 1
        return moves

    def plan_moves(self, *, now: float | None = None) -> list[tuple[int, int]]:
        """Moves for every group whose owner stopped heartbeating:
        [(group, to_process), ...] — empty when the fleet is healthy
        or nothing is live to receive them. Level-triggered: a group a
        LIVE process already heartbeats as owned is never re-planned
        (the rescue landed — planning it again would bounce it between
        hosts forever), while a still-stranded group keeps being
        planned every tick until some owner claims it (a failed
        execution loses only intent, never the group). Dead records
        whose groups are all rescued are pruned."""
        now = time.time() if now is None else now
        with self._lock:
            alive = self._alive(now)
            if not alive:
                return []
            owned_live = {
                g for p in alive for g in self._procs[p]["groups"]
            }
            # dedupe across dead records: two dead processes can both
            # list a group (owner died, rescuer died later) — planning
            # it twice would split one key range across two adopters
            seen = set(owned_live)
            stranded, rescued_dead = [], []
            for p, rec in sorted(self._procs.items()):
                if p in alive:
                    continue
                left = [g for g in rec["groups"] if g not in seen]
                seen.update(left)
                stranded.extend(left)
                if all(g in owned_live for g in rec["groups"]):
                    rescued_dead.append(p)
            for p in rescued_dead:
                del self._procs[p]  # a revived host re-heartbeats
            loads = {p: len(self._procs[p]["groups"]) for p in alive}
            moves = self._spread(stranded, alive, loads)
            self.counters["moves_planned"] += len(moves)
            return moves

    def plan_drain(self, process: int, *,
                   now: float | None = None) -> list[tuple[int, int]]:
        """Decommission plan: move every group off a LIVE process
        (maintenance drain), least-loaded-first across the rest."""
        now = time.time() if now is None else now
        with self._lock:
            alive = [p for p in self._alive(now) if p != int(process)]
            rec = self._procs.get(int(process))
            if rec is None or not alive:
                return []
            loads = {p: len(self._procs[p]["groups"]) for p in alive}
            moves = self._spread(rec["groups"], alive, loads)
            self.counters["drains_planned"] += len(moves)
            return moves
