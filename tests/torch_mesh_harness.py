"""Multi-process mesh harness for deepflow_tpu_torch: one file, three hats.

The twin of tests/mesh_harness.py (same workload constants, same frames,
same pump cadence, same result digests), importing only
deepflow_tpu_torch, numpy and torch, so chip_smoke.py can spawn it on a
card. pytest does not collect it (no `test_` prefix).

1. **Subprocess entry** (`python tests/torch_mesh_harness.py '<spec>'`):
   runs ONE host of a multi-process deployment on `spec["device"]`
   ("cpu" or "cuda"): `MeshTopology.distributed` over gloo (or
   `standalone` for a recovering host), one receiver with key-hash
   routing, one queues → FeederRuntime(journal) → ShardedWindowManager
   lane per owned group, per-host journal and checkpoint names,
   deterministic injected lineage clocks. It writes one JSON result and
   the group's flushed rows and sketch blocks as `.npz` beside it.
2. **Spawn helpers**: `spawn_hosts`, `two_process_specs` and
   `rebalance_specs` launch such processes (a free coordinator port,
   the kill-and-recover and rebalance recipes, one retry when the
   coordinator lost its port to another process).
3. **In-process oracles**: `run_oracle()` / `run_rebalance_oracle()`
   run the identical workload in the calling process over
   `MeshTopology.single`, so every per-group result compares digest for
   digest — and with the reference harness's oracles too.

Where the reference harness leans on JAX, this one substitutes:
  * fetch locality — the `aggregator.window.host_fetch` seam counts a
    fetched tensor as non-local when its device is not one of
    `topology.local_devices`;
  * retraces / jit cache sizes — a per-host step census
    (profiling/census.py) observes each group's ingest by bucket; its
    entry count must not grow once the buckets are warm;
  * `jax.distributed.initialize` — `MeshTopology.distributed` over gloo,
    with `parallel.hostproc.clean_env(device)` as the child's
    environment.
"""

from __future__ import annotations

import atexit as _atexit
import hashlib
import json
import os
import subprocess
import sys
import threading as _threading
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# -- the shared workload (module constants: oracle and every subprocess
#    must build byte-identical frames; the reference harness's values) --
N_GROUPS = 2
DEVICES_PER_GROUP = 1
N_AGENTS = 8
ORG_ID = 1
ROWS_PER_FRAME = 48
N_STEPS = 10
CHECKPOINT_AT = 3  # kill recipe: checkpoint after this step's pumps
KILL_AFTER = 6     # ... and die (os._exit) after this step's pumps
T0 = 1_700_000_000
BUCKETS = (64, 128, 256)
KILL_EXIT = 7

# -- the mid-stream rebalance recipe ----------------------------------------
MOVE_GROUP = 1          # moves from its block owner (p1) to p0
NEW_OWNER = 0
OLD_OWNER = 1
REBALANCE_AT = 5        # handover after this step's pumps
REROUTE_AT = 8          # clean recipe: agents re-route at this step;
#                         steps (REBALANCE_AT, REROUTE_AT) arrive at the
#                         old owner and travel the real handoff wire
RB_HANDOVER_CKPT = "handover.ckpt"
RB_SIDECAR = "rb.manifest.json"

_COUNTER_KEYS = (
    "flow_in", "flushed_doc", "drop_before_window", "window_advances",
    "sketch_blocks_closed",
)
_BLOCK_LANES = ("hll", "cms", "hist", "tk_votes", "tk_hi", "tk_lo", "tk_ida",
                "tk_idb")
SPAWN_TIMEOUT_S = 600


def _sharded_cfg():
    from deepflow_tpu_torch.ops.histogram import LogHistSpec
    from deepflow_tpu_torch.parallel.sharded import ShardedConfig

    return ShardedConfig(
        capacity_per_device=1 << 10, num_services=8, hll_precision=6,
        cms_depth=2, cms_width=256,
        hist=LogHistSpec(bins=32, vmin=1.0, gamma=1.3),
        topk_cols=64, sketch_pending=8,
    )


def host_devices(device) -> list:
    """The devices one host process holds: room for every group (an
    adopting host serves both), all on `device` — several logical shards
    share one CPU or one card (a card named by its index)."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * (N_GROUPS * DEVICES_PER_GROUP)


def step_frames():
    """[step][...] of (agent_id, raw_frame) — deterministic, identical
    in every process (the generator is stateful, so construction order
    IS the contract)."""
    from deepflow_tpu_torch.feeder import encode_flowbatch_frames
    from deepflow_tpu_torch.ingest.replay import SyntheticFlowGen

    gen = SyntheticFlowGen(num_tuples=64, seed=7)
    steps = []
    for i in range(N_STEPS):
        frames = []
        for a in range(N_AGENTS):
            fb = gen.flow_batch(ROWS_PER_FRAME, T0 + i)
            for raw in encode_flowbatch_frames(fb, agent_id=a, org_id=ORG_ID):
                frames.append((a, raw))
        steps.append(frames)
    return steps


class _TickClock:
    """Injected deterministic lineage clock — one per shard group, so
    each group's call sequence (and therefore its freshness lags) is
    identical between the oracle and the process that owns it."""

    def __init__(self, group: int):
        self.t = 1_000.0 * (group + 1)

    def __call__(self) -> float:
        self.t += 0.0005
        return self.t


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()[:24]


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def kernel_launches() -> dict:
    """This process's launch counts of the hand-written kernels."""
    from deepflow_tpu_torch.ops import segreduce, sketch_fused

    return {**segreduce.LAUNCHES, **sketch_fused.LAUNCHES}


def device_report(device, runner) -> dict:
    """What this process really ran on: the card's name (or "cpu") and
    the device type of every group's stash tensors."""
    import torch

    name = torch.cuda.get_device_name() if str(device).startswith("cuda") else "cpu"
    return {"name": name, "stash": sorted({
        s.slot.device.type for st in runner.groups.values() if st["swm"].stash
        for s in st["swm"].stash})}


class HostRunner:
    """One host's stack: receiver (key-hash routed) + one
    queues→feeder(journal)→ShardedWindowManager lane per owned group.
    Groups can also be built AFTER construction (`build_group` +
    `register_group`) — the rebalance recipes adopt a moving group
    mid-run. `cfg`, `buckets`, `feeder_config` and `queue_capacity`
    default to the test-size workload; `journal=False` runs the feeders
    without a frame journal (and then without checkpoint recovery)."""

    def __init__(self, topology, workdir: Path, *, restore: bool = False, cfg=None,
                 buckets=BUCKETS, feeder_config=None, queue_capacity: int = 1 << 12,
                 journal: bool = True):
        from deepflow_tpu_torch.aggregator.checkpoint import (
            read_checkpoint_meta,
            restore_sharded_state,
        )
        from deepflow_tpu_torch.ingest.receiver import Receiver
        from deepflow_tpu_torch.profiling.census import StepCostCensus

        self.topology = topology
        self.workdir = Path(workdir)
        self.cfg = _sharded_cfg() if cfg is None else cfg
        self.buckets = tuple(buckets)
        self.feeder_config = feeder_config
        self.queue_capacity = queue_capacity
        self.journal = journal
        self.census = StepCostCensus()
        self.receiver = Receiver()
        self.handoffs: list[tuple[int, int]] = []  # (group, nbytes)
        self.receiver.attach_topology(
            topology,
            handoff=lambda g, raw: self.handoffs.append((g, len(raw))),
        )
        self.groups: dict[int, dict] = {}
        self.n_ingests = 0
        for g in topology.owned_groups():
            self.build_group(g)
            self.register_group(g)
            st = self.groups[g]
            if restore:
                restore_sharded_state(st["swm"], st["ckpt"])
                meta = read_checkpoint_meta(st["ckpt"])
                barrier = {
                    "journal_epoch": meta["journal_epoch"],
                    "journal_offset": meta["journal_offset"],
                }
                jpath = topology.host_path(
                    self.workdir / "feeder.journal", group=g
                )
                st["out"].extend(
                    st["feeder"].replay_journal(jpath, barrier=barrier)
                )
                st["out"].extend(st["feeder"].pump())

    def build_group(self, g: int, *, clock_t: float | None = None,
                    topology=None) -> dict:
        """queues + pipeline + manager + lineage + feeder(journal) for
        one owned group — NO handler registration (adopters register
        only after restore, so the receiver's hold buffer covers the
        gap). `clock_t` resumes the injected lineage clock mid-value
        (ownership transfer hands the clock over with the state)."""
        from deepflow_tpu_torch.feeder import FeederConfig
        from deepflow_tpu_torch.ingest.queues import PyOverwriteQueue
        from deepflow_tpu_torch.parallel.sharded import (
            ShardedPipeline,
            ShardedWindowManager,
        )
        from deepflow_tpu_torch.tracing.lineage import (
            FreshnessTracker,
            LineageTracker,
        )

        topology = self.topology if topology is None else topology
        queues = [PyOverwriteQueue(self.queue_capacity)]
        pipe = ShardedPipeline(topology, self.cfg, shard_group=g)
        swm = ShardedWindowManager(pipe, delay=2)
        clock = _TickClock(g)
        if clock_t is not None:
            clock.t = clock_t
        tracker = LineageTracker(
            service="mesh.harness", interval=1, clock=clock,
            group=str(g),
            freshness=FreshnessTracker(name=f"g{g}", group=str(g)),
        )
        swm.attach_lineage(tracker)
        feeder = swm.make_feeder(
            queues, self.buckets,
            self.feeder_config or FeederConfig(frames_per_queue=16),
            journal_dir=self.workdir if self.journal else None, lineage=tracker,
        )
        real_ingest = swm.ingest

        def counted(tags, meters, valid, _r=real_ingest, _svc=f"mesh.g{g}"):
            self.n_ingests += 1
            # the census's per-bucket entries stand in for the jit cache
            self.census.observe(_svc, "sharded_step", len(valid), pipe.step, ())
            return _r(tags, meters, valid)

        swm.ingest = counted
        ckpt = topology.host_path(self.workdir / "mesh.ckpt", group=g)
        self.groups[g] = {
            "swm": swm, "feeder": feeder, "tracker": tracker,
            "clock": clock, "queues": queues,
            "ckpt": ckpt, "out": [], "blocks": [],
        }
        return self.groups[g]

    def census_entries(self, g: int) -> int:
        """Distinct ingest buckets group `g` has dispatched in this process."""
        return sum(1 for r in self.census.snapshot() if r["service"] == f"mesh.g{g}")

    def register_group(self, g: int) -> None:
        from deepflow_tpu_torch.ingest.framing import MessageType

        self.receiver.register_handler(
            MessageType.TAGGEDFLOW, self.groups[g]["queues"], shard_group=g
        )

    # -- driving ---------------------------------------------------------
    def dispatch_step(self, frames) -> None:
        from deepflow_tpu_torch.ingest.framing import HEADER_LEN, FlowHeader

        for _agent, raw in frames:
            header = FlowHeader.parse(raw[:HEADER_LEN])
            self.receiver._dispatch(header, raw, ("mesh-harness", 0))

    def pump(self) -> None:
        for g in sorted(self.groups):
            st = self.groups[g]
            if st.get("released"):
                continue  # handed over: the new owner pumps it now
            st["out"].extend(st["feeder"].pump())
            st["blocks"].extend(st["swm"].pop_closed_sketches())

    def checkpoint(self) -> None:
        from deepflow_tpu_torch.aggregator.checkpoint import save_sharded_state

        for g in sorted(self.groups):
            st = self.groups[g]
            if st.get("released"):
                continue

            def save(barrier, _st=st):
                return save_sharded_state(
                    _st["swm"], _st["ckpt"], extra_meta=barrier
                )

            st["out"].extend(st["feeder"].checkpoint(save))
            if not st["feeder"].last_checkpoint_ok:
                raise RuntimeError(f"group {g} checkpoint aborted")
            # outputs after this point are in-flight if the process
            # dies: the journal re-creates them at replay, so the
            # combined kill stream is out[:ckpt_len] + the recovered
            # generation's stream
            st["ckpt_stream_len"] = len(st["out"])
            st["ckpt_blocks_len"] = len(st["blocks"])

    def finish(self) -> None:
        for g in sorted(self.groups):
            st = self.groups[g]
            if st.get("released"):
                # handed over: draining here would re-emit windows the
                # new owner now serves (the checkpoint transferred them)
                continue
            st["out"].extend(st["feeder"].flush())
            st["out"].extend(st["swm"].drain())
            st["blocks"].extend(st["swm"].pop_closed_sketches())

    def close(self) -> None:
        self.receiver.stop()
        for st in self.groups.values():
            st["tracker"].close()
            st["swm"].close()

    # -- result shape ----------------------------------------------------
    def results(self, *, counters: bool = True) -> dict:
        out: dict = {"groups": {}, "receiver": self.receiver.get_counters(),
                     "handoffs": len(self.handoffs)}
        for g in sorted(self.groups):
            st = self.groups[g]
            stream = [
                [int(db.timestamp[0]), int(db.size),
                 _digest(db.tags, db.meters, db.timestamp)]
                for db in st["out"]
            ]
            blocks = [
                [int(b.window),
                 _digest(b.hll, b.cms, b.hist, b.tk_votes, b.tk_hi)]
                for b in st["blocks"]
            ]
            rec: dict = {
                "stream": stream,
                "blocks": blocks,
                "fresh": st["tracker"].freshness.get_counters(),
                "fresh_hist": st["tracker"].freshness.hist_dump(),
                "trace_id": st["tracker"].trace_id_of(T0 + 2),
                "ckpt_stream_len": st.get("ckpt_stream_len"),
                "ckpt_blocks_len": st.get("ckpt_blocks_len"),
                "handover_stream_len": st.get("handover_stream_len"),
                "handover_blocks_len": st.get("handover_blocks_len"),
                "released": bool(st.get("released")),
                "clock_t": st["clock"].t,
            }
            if counters:
                c = st["swm"].get_counters()
                rec["counters"] = {k: c[k] for k in _COUNTER_KEYS}
                rec["host_fetches"] = c["host_fetches"]
            out["groups"][str(g)] = rec
        return out

    def row_arrays(self) -> dict:
        """Every group's flushed rows and closed sketch blocks as named
        numpy arrays (`np.savez` shape), for comparisons under a
        tolerance rather than by digest."""
        import numpy as np

        arrays = {}
        for g in sorted(self.groups):
            st = self.groups[g]
            for i, db in enumerate(st["out"]):
                for k in ("timestamp", "tags", "meters"):
                    arrays[f"g{g}.doc{i}.{k}"] = np.asarray(getattr(db, k))
            for i, b in enumerate(st["blocks"]):
                arrays[f"g{g}.blk{i}.meta"] = np.array([b.window, b.n_updates], np.int64)
                for k in _BLOCK_LANES:
                    arrays[f"g{g}.blk{i}.{k}"] = np.asarray(getattr(b, k))
        return arrays

    def fleet_frames(self, host_label: str | None = None,
                     *, epoch: int = 0) -> list[str]:
        """One ENCODED fleet frame per live (non-released) group, built
        from the same faces `results()` dumps — swm counters as the
        tick's StatsPoint, the freshness tracker as a hist face — and
        hex-packed so they ride the JSON result file to the parent."""
        from deepflow_tpu_torch.fleet import FleetExporter
        from deepflow_tpu_torch.utils.stats import StatsPoint

        host = (host_label if host_label is not None
                else f"host{self.topology.process_index}")
        frames = []
        for g in sorted(self.groups):
            st = self.groups[g]
            if st.get("released"):
                continue
            c = st["swm"].get_counters()
            exp = FleetExporter(
                host, group=str(g), epoch=epoch,
                hist_faces={f"g{g}": st["tracker"].freshness},
                clock=lambda: float(T0),
            )
            pt = StatsPoint(
                float(T0), "tpu_mesh_swm", (("group", str(g)),),
                {k: int(c[k]) for k in _COUNTER_KEYS},
            )
            frames.append(exp.encode(points=[pt]).hex())
        return frames


def load_rows(src) -> dict:
    """{group: {"docs": [...], "blocks": [...]}} from `row_arrays`' dict
    or its `.npz` path; docs carry timestamp / tags / meters, blocks
    window / n_updates and the sketch lanes."""
    import types

    import numpy as np

    if not isinstance(src, dict):
        with np.load(src) as z:
            return load_rows({k: z[k] for k in z.files})
    out: dict = {}
    for key, arr in src.items():
        g, item, field = key.split(".")
        kind = "docs" if item.startswith("doc") else "blocks"
        lst = out.setdefault(int(g[1:]), {"docs": [], "blocks": []})[kind]
        idx = int(item[3:])
        while len(lst) <= idx:
            lst.append(types.SimpleNamespace())
        if field == "meta":
            lst[idx].window, lst[idx].n_updates = (int(x) for x in arr)
        else:
            setattr(lst[idx], field, arr)
    return out


FLOAT_RTOL = 1e-5  # SUM lanes: the order of float32 additions may differ


def check_rows_close(got: list, want: list, what: str) -> int:
    """Hold one group's docs or blocks (`load_rows` shape, or DocBatch /
    WindowSketchBlock lists) to `want`'s: timestamps, tags and every
    integer lane exact; a meter exact where `want` holds an integer below
    2^24 and on MAX lanes, else within rtol 1e-5; a histogram count may
    move to an adjacent bin (the card's logf is not the CPU's), each
    group's total exact. Raises AssertionError; returns the histogram
    counts moved."""
    import numpy as np

    from deepflow_tpu_torch.aggregator.stash import sum_max_cols
    from deepflow_tpu_torch.datamodel.schema import FLOW_METER

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} items, want {len(want)}")
    _, max_cols = sum_max_cols(FLOW_METER)
    moved = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if hasattr(b, "meters"):
            same = (np.array_equal(a.timestamp, b.timestamp) and np.array_equal(a.tags, b.tags)
                    and a.meters.shape == b.meters.shape)
            if same:
                w = np.asarray(b.meters, np.float64)
                x = np.asarray(a.meters, np.float64)
                exact = (w == np.round(w)) & (np.abs(w) < 2 ** 24)
                exact[:, max_cols] = True
                same = (np.array_equal(x[exact], w[exact])
                        and np.allclose(x[~exact], w[~exact], rtol=FLOAT_RTOL, atol=0))
            if not same:
                raise AssertionError(f"{what}: doc batch {i} differs")
            continue
        if (a.window, a.n_updates) != (b.window, b.n_updates) or not all(
                np.array_equal(getattr(a, k), getattr(b, k)) for k in _BLOCK_LANES
                if k != "hist"):
            raise AssertionError(f"{what}: sketch block {i} differs")
        d = np.asarray(a.hist, np.int64) - np.asarray(b.hist, np.int64)
        # a count moved by one bin crosses one bin edge: the prefix sums
        # of the difference then add up to half its L1 norm
        crossings = int(np.abs(np.cumsum(d, axis=1)).sum())
        if d.sum(axis=1).any() or 2 * crossings != int(np.abs(d).sum()):
            raise AssertionError(f"{what}: sketch block {i} histogram differs")
        moved += crossings
    return moved


def write_result(spec: dict, runner, res: dict) -> None:
    import numpy as np

    np.savez(Path(spec["out"]).with_suffix(".npz"), **runner.row_arrays())
    Path(spec["out"]).write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# subprocess body


def fetch_shim(topology) -> dict:
    """Per-host fetch and locality accounting through the
    `aggregator.window.host_fetch` seam: a fetched tensor whose device is
    not one of this host's `local_devices` counts as non-local."""
    import torch

    from deepflow_tpu_torch.aggregator import window as window_mod

    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(d.type) if d.type == "cpu" else d

    fetch = {"n": 0, "nonlocal": 0}
    local = {norm(d) for d in topology.local_devices}
    real_fetch = window_mod.host_fetch

    def counting_fetch(x):
        fetch["n"] += 1
        if norm(x.device) not in local:
            fetch["nonlocal"] += 1
        return real_fetch(x)

    window_mod.host_fetch = counting_fetch
    return fetch


def bring_up(spec: dict):
    """→ (topology, bring-up seconds) for a host spec."""
    from deepflow_tpu_torch.parallel.topology import MeshTopology

    devices = host_devices(spec["device"])
    t = time.perf_counter()
    if spec["mode"] == "distributed":
        topology = MeshTopology.distributed(
            spec["coordinator"], spec["num_processes"], spec["process_id"],
            n_groups=N_GROUPS, devices_per_group=DEVICES_PER_GROUP, devices=devices,
        )
    else:
        topology = MeshTopology.standalone(
            spec["process_id"], spec["num_processes"],
            n_groups=N_GROUPS, devices_per_group=DEVICES_PER_GROUP, devices=devices,
        )
    return topology, time.perf_counter() - t


def run_host(spec: dict) -> None:
    from deepflow_tpu_torch.parallel.hostproc import exit_after_barrier, mark_done

    workdir = Path(spec["workdir"])
    topology, init_s = bring_up(spec)
    statement = None
    if topology.is_distributed:
        # the pod-wide statement: every process's device names
        statement = [[str(d) for d in row] for row in topology.global_mesh().devices]
    fetch = fetch_shim(topology)

    runner = HostRunner(
        topology, workdir, restore=bool(spec.get("restore"))
    )
    steps = step_frames()
    first = int(spec.get("first_step", 0))
    census_steady = None
    for i in range(first, N_STEPS):
        runner.dispatch_step(steps[i])
        runner.pump()
        if i == first + 1:
            # steady state reached (every bucket dispatched): growth of
            # the census after this is a new step shape
            census_steady = len(runner.census.snapshot())
        if i == CHECKPOINT_AT:
            # every run checkpoints at the same step — the barrier
            # flush changes batch cadence, so the oracle and both
            # generations must share it
            runner.checkpoint()
        if spec.get("kill") and i == KILL_AFTER:
            res = runner.results()
            res["killed_after"] = i
            # the dead host's LAST frames — the staleness proof feeds
            # these, then expires the host
            res["fleet_frames"] = runner.fleet_frames()
            res["device"] = device_report(spec["device"], runner)
            res["launches"] = kernel_launches()
            write_result(spec, runner, res)
            # a dying host marks done (peers stop waiting) but does NOT
            # wait — it is the process death under test
            mark_done(spec["workdir"], spec["process_id"])
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(KILL_EXIT)
    runner.finish()
    _sync(spec["device"])
    res = runner.results()
    res["fleet_frames"] = runner.fleet_frames()
    res["fetch"] = {
        **fetch,
        "n_ingests": runner.n_ingests,
        "retraces": len(runner.census.snapshot()) - (census_steady or 0),
    }
    res["process_index"] = topology.process_index
    res["init_s"] = init_s
    res["global_mesh"] = statement
    res["device"] = device_report(spec["device"], runner)
    res["launches"] = kernel_launches()
    write_result(spec, runner, res)
    # results are durable; exit through the done-file barrier
    # (parallel/hostproc.py) so rank 0's store outlives its peers and
    # nobody enters the process group's teardown
    exit_after_barrier(
        spec["workdir"], spec["process_id"],
        spec["num_processes"] if spec["mode"] == "distributed" else 1,
    )


# ---------------------------------------------------------------------------
# rebalance recipes: mid-stream shard-group rebalance with checkpoint
# handover, real-wire misroute forwarding, and the kill-the-old-owner-
# mid-handover drill


def agent_groups() -> dict:
    from deepflow_tpu_torch.parallel.topology import key_shard_group

    return {
        a: key_shard_group(ORG_ID, a, N_GROUPS) for a in range(N_AGENTS)
    }


def _owner_at(group: int, step: int, reroute_at: int) -> int:
    """The harness's agent-routing table: the controller's view of who
    serves each group at each step. MOVE_GROUP's agents keep sending to
    the old owner until they re-route at `reroute_at` — the window in
    which the misroute handoff carries the traffic."""
    if group != MOVE_GROUP:
        return group  # block owner (one group per process)
    return OLD_OWNER if step < reroute_at else NEW_OWNER


def _await(cond, what: str, timeout_s: float = 300.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise RuntimeError(f"timed out waiting for {what}")


def _timed(device, fn):
    """(fn(), its wall milliseconds with the device synchronised)."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t) * 1e3


def run_rebalance_host(spec: dict) -> None:
    """One host of the 2-process rebalance run (subprocess entry).

    Both hosts run MeshTopology.standalone — the protocol is
    control-plane only (workdir rendezvous + the handoff wire), which
    is itself the point: a rebalance must not need the process group.
    p0 (new owner) opens a HandoffReceiver and claims the moving group
    at REBALANCE_AT; p1 (old owner) releases it — flip → quiesce →
    manifest checkpoint → journal rotate — then forwards the
    not-yet-re-routed agents' frames over the real wire until
    REROUTE_AT. With spec["kill"], p1 dies at the `rebalance.step`
    chaos seam mid-handover (after the flip, before the barrier
    checkpoint) and a gen-2 process recovers from p1's OWN step-3
    checkpoint + journal before completing the handover."""
    from deepflow_tpu_torch import chaos as chaos_mod
    from deepflow_tpu_torch.aggregator.checkpoint import save_sharded_state
    from deepflow_tpu_torch.parallel.hostproc import exit_after_barrier, mark_done
    from deepflow_tpu_torch.parallel.rebalance import GroupRebalancer

    device = spec["device"]
    workdir = Path(spec["workdir"])
    pid = int(spec["process_id"])
    reroute_at = int(spec["reroute_at"])
    topology, _ = bring_up({**spec, "mode": "standalone"})
    fetch = fetch_shim(topology)
    hand_ckpt = workdir / RB_HANDOVER_CKPT
    groups_of = agent_groups()
    n_move_frames = sum(1 for g in groups_of.values() if g == MOVE_GROUP)
    handover_ms: dict = {}

    if spec.get("gen2"):
        # -- recovery generation: the dead old owner's stand-in -------
        runner = HostRunner(topology, workdir, restore=True)
        reb = GroupRebalancer(topology)
        plan = reb.plan(MOVE_GROUP, NEW_OWNER)
        st = runner.groups[MOVE_GROUP]

        def save(extra, _st=st):
            return save_sharded_state(_st["swm"], hand_ckpt, extra_meta=extra)

        out, handover_ms["release"] = _timed(device, lambda: reb.release(
            plan, feeder=st["feeder"], save=save,
            receiver=runner.receiver, handoff=None,
        ))
        st["out"].extend(out)
        st["blocks"].extend(st["swm"].pop_closed_sketches())
        st["released"] = True
        st["handover_stream_len"] = len(st["out"])
        st["handover_blocks_len"] = len(st["blocks"])
        (workdir / RB_SIDECAR).write_text(json.dumps({
            "clock_t": st["clock"].t,
            "lineage": st["tracker"].export_open(st["swm"].start_window),
        }))
        (workdir / "rb.ready").write_text("1")
        res = runner.results()
        res["process_index"] = pid
        res["handover_ms"] = handover_ms
        res["device"] = device_report(device, runner)
        res["launches"] = kernel_launches()
        write_result(spec, runner, res)
        exit_after_barrier(workdir, pid, 1)
        return

    runner = HostRunner(topology, workdir)
    reb = GroupRebalancer(topology)
    steps = step_frames()
    handoff_rx = None
    sender = None
    plan = None
    misroute_mark = None
    if pid == NEW_OWNER:
        from deepflow_tpu_torch.ingest.handoff import HandoffReceiver

        handoff_rx = HandoffReceiver(runner.receiver)
        handoff_rx.start()
        (workdir / "handoff.port").write_text(str(handoff_rx.port))
    wire_rx_expect = 0

    for i in range(N_STEPS):
        mine = [
            (a, raw) for (a, raw) in steps[i]
            if _owner_at(groups_of[a], i, reroute_at) == pid
        ]
        if pid == OLD_OWNER and REBALANCE_AT + 1 < i < reroute_at:
            # lockstep during the forwarding window: do not put step
            # i's frames on the wire until the new owner has pumped
            # step i-1 — two steps coalescing into one pump over there
            # would change the batch split the oracle never saw
            _await((workdir / f"pumped.{i-1}").exists, f"pumped.{i-1}")
        if pid == NEW_OWNER and REBALANCE_AT < i < reroute_at:
            # a forwarded step: the old owner fenced the wire before
            # writing the marker; wait for the frames so this step's
            # pump coalesces them exactly like the oracle's (they land
            # in the receiver's hold buffer until adoption completes)
            marker = workdir / f"sent.{i}"
            _await(marker.exists, f"{marker}")
            wire_rx_expect += n_move_frames
            _await(
                lambda: handoff_rx.get_counters()["rx_frames"]
                >= wire_rx_expect,
                f"wire frames for step {i}",
            )
        runner.dispatch_step(mine)
        if pid == NEW_OWNER and i == REBALANCE_AT + 1:
            # adopt: the manifest checkpoint is published and every
            # early frame is in the hold buffer — restore + register
            # (registration redelivers the held frames in order)
            _await((workdir / "rb.ready").exists, "rb.ready")
            side = json.loads((workdir / RB_SIDECAR).read_text())

            def adopt():
                st2 = runner.build_group(
                    MOVE_GROUP, clock_t=side["clock_t"], topology=reb.topology
                )
                # the handover carries the open windows' partial lineage
                st2["tracker"].import_open(side["lineage"])
                return reb.adopt(
                    plan, swm=st2["swm"], ckpt_path=hand_ckpt,
                    register=lambda: runner.register_group(MOVE_GROUP),
                )

            _, handover_ms["adopt"] = _timed(device, adopt)
        runner.pump()
        if pid == NEW_OWNER and REBALANCE_AT < i < reroute_at:
            (workdir / f"pumped.{i}").write_text("1")
        if i == 1:
            for g, st in runner.groups.items():
                st["census_steady"] = runner.census_entries(g)
        if pid == NEW_OWNER and i == REBALANCE_AT + 2:
            # adopted group: every bucket it will ever see dispatched
            # during its first post-adopt step
            runner.groups[MOVE_GROUP]["census_steady"] = runner.census_entries(MOVE_GROUP)
        if i == CHECKPOINT_AT:
            runner.checkpoint()
        if i == REBALANCE_AT:
            if pid == NEW_OWNER:
                plan = reb.plan(MOVE_GROUP, NEW_OWNER)
                reb.claim(
                    plan, receiver=runner.receiver,
                    handoff=lambda g, raw: runner.handoffs.append(
                        (g, len(raw))
                    ),
                )
                runner.topology = reb.topology
                (workdir / "rb.claimed").write_text("1")
            else:
                _await((workdir / "rb.claimed").exists, "rb.claimed")
                _await((workdir / "handoff.port").exists, "handoff.port")
                from deepflow_tpu_torch.ingest.handoff import HandoffSender

                port = int((workdir / "handoff.port").read_text())
                sender = HandoffSender({NEW_OWNER: ("127.0.0.1", port)})
                plan = reb.plan(MOVE_GROUP, NEW_OWNER)
                st = runner.groups[MOVE_GROUP]

                def save(extra, _st=st):
                    return save_sharded_state(
                        _st["swm"], hand_ckpt, extra_meta=extra
                    )

                if spec.get("kill"):
                    # die at the rebalance.step seam AFTER the flip,
                    # BEFORE the barrier checkpoint: the handover state
                    # exists only as this host's step-3 checkpoint +
                    # journal — exactly what gen-2 must recover from
                    chaos_mod.install(chaos_mod.FaultPlan().add(
                        chaos_mod.FaultRule(
                            site=chaos_mod.SITE_REBALANCE_STEP,
                            error=chaos_mod.KillPoint(
                                "old owner dies mid-handover"
                            ),
                            at=(1,),
                        )
                    ))
                try:
                    out, handover_ms["release"] = _timed(device, lambda: reb.release(
                        plan, feeder=st["feeder"], save=save,
                        receiver=runner.receiver,
                        handoff=sender.route(plan.topology),
                    ))
                except chaos_mod.KillPoint:
                    res = runner.results()
                    res["killed_at"] = i
                    res["device"] = device_report(device, runner)
                    res["launches"] = kernel_launches()
                    write_result(spec, runner, res)
                    mark_done(workdir, pid)
                    sys.stdout.flush()
                    sys.stderr.flush()
                    os._exit(KILL_EXIT)
                st["out"].extend(out)
                st["blocks"].extend(st["swm"].pop_closed_sketches())
                st["released"] = True
                st["handover_stream_len"] = len(st["out"])
                st["handover_blocks_len"] = len(st["blocks"])
                st["census_end"] = runner.census_entries(MOVE_GROUP)
                (workdir / RB_SIDECAR).write_text(json.dumps({
                    "clock_t": st["clock"].t,
                    "lineage": st["tracker"].export_open(
                        st["swm"].start_window
                    ),
                }))
                (workdir / "rb.ready").write_text("1")
        if pid == OLD_OWNER and sender is not None \
                and REBALANCE_AT < i < reroute_at:
            # fence the wire, then publish the step marker the new
            # owner's pump waits on
            if not sender.flush(60.0):
                raise RuntimeError(f"handoff wire did not drain at step {i}")
            (workdir / f"sent.{i}").write_text("1")
            if i == reroute_at - 1:
                # last forwarded step: misroutes must stop here —
                # re-routed agents talk to the new owner directly
                misroute_mark = runner.receiver.get_counters()[
                    "frames_misrouted"
                ]
        time.sleep(0)  # cooperative: conn/wire threads get a slice
    runner.finish()
    _sync(device)
    for g, st in runner.groups.items():
        if "census_end" not in st:
            st["census_end"] = runner.census_entries(g)
    res = runner.results()
    res["process_index"] = pid
    res["fetch"] = {**fetch, "n_ingests": runner.n_ingests}
    res["caches"] = {
        str(g): [st.get("census_steady"), st.get("census_end")]
        for g, st in runner.groups.items()
    }
    res["rebalance"] = reb.get_counters()
    res["handover_ms"] = handover_ms
    res["device"] = device_report(device, runner)
    res["launches"] = kernel_launches()
    if sender is not None:
        res["sender"] = sender.get_counters()
        res["misrouted_after_forwarding"] = misroute_mark
    if handoff_rx is not None:
        res["handoff_rx"] = handoff_rx.get_counters()
    write_result(spec, runner, res)
    exit_after_barrier(workdir, pid, int(spec["num_processes"]))


def run_rebalance_oracle(device="cpu", *, with_rows: bool = False) -> dict:
    """The uninterrupted oracle for BOTH rebalance recipes: identical
    workload and pump cadence, with MOVE_GROUP's drain-to-barrier
    quiesce executed in place at REBALANCE_AT (a move to the group's own
    owner is the counted no-op, so the oracle runs the same barrier
    without moving anything). `with_rows` adds `row_arrays()` under
    "rows"."""
    import tempfile

    from deepflow_tpu_torch.aggregator.checkpoint import save_sharded_state
    from deepflow_tpu_torch.parallel.topology import MeshTopology

    with tempfile.TemporaryDirectory(prefix="rb-oracle-") as d:
        topology = MeshTopology.single(
            n_groups=N_GROUPS, devices_per_group=DEVICES_PER_GROUP,
            devices=host_devices(device),
        )
        runner = HostRunner(topology, Path(d))
        try:
            steps = step_frames()
            for i in range(N_STEPS):
                runner.dispatch_step(steps[i])
                runner.pump()
                if i == CHECKPOINT_AT:
                    runner.checkpoint()
                if i == REBALANCE_AT:
                    st = runner.groups[MOVE_GROUP]

                    def save(extra, _st=st, _d=d):
                        return save_sharded_state(
                            _st["swm"], Path(_d) / "oracle.handover.ckpt",
                            extra_meta=extra,
                        )

                    st["out"].extend(st["feeder"].quiesce(save))
                    st["blocks"].extend(st["swm"].pop_closed_sketches())
            runner.finish()
            res = runner.results()
            if with_rows:
                res["rows"] = runner.row_arrays()
            return res
        finally:
            runner.close()


def rebalance_specs(workdir: Path, *, kill: bool = False, device="cpu") -> list[dict]:
    reroute = REBALANCE_AT + 1 if kill else REROUTE_AT
    return [
        {
            "mode": "rebalance", "num_processes": 2, "process_id": pid,
            "workdir": str(workdir), "reroute_at": reroute, "device": device,
            "out": str(Path(workdir) / f"result.p{pid}.json"),
            "kill": kill and pid == OLD_OWNER,
        }
        for pid in range(2)
    ]


def gen2_rebalance_spec(workdir: Path, device="cpu") -> dict:
    return {
        "mode": "rebalance", "gen2": True, "num_processes": 2,
        "process_id": OLD_OWNER, "workdir": str(workdir), "device": device,
        "reroute_at": REBALANCE_AT + 1,
        "out": str(Path(workdir) / "result.p1.gen2.json"),
    }


def run_rebalance_kill(workdir: Path, device="cpu") -> dict:
    """Kill-the-old-owner-mid-handover: gen-1 p1 dies at the
    rebalance.step seam after the flip; gen-2 restores p1's OWN step-3
    checkpoint, replays p1's OWN journal, completes the handover; p0
    adopts from the recovered manifest checkpoint and finishes.
    Returns {"p0", "p1_gen1", "p1_gen2"}."""
    p0_spec, p1_spec = rebalance_specs(workdir, kill=True, device=device)
    procs = [(spec, _launch(spec)) for spec in (p0_spec, p1_spec)]
    try:
        # gen-1 old owner dies first (KILL_EXIT); only then does the
        # recovery generation exist — the parent is the "controller"
        # noticing the death
        _out, err = procs[1][1].communicate(timeout=SPAWN_TIMEOUT_S)
        if procs[1][1].returncode != KILL_EXIT:
            raise RuntimeError(
                f"gen1 rc={procs[1][1].returncode} (wanted {KILL_EXIT}):\n"
                + err[-3000:]
            )
        (p1_gen2,) = spawn_hosts([gen2_rebalance_spec(workdir, device)])
        _out, err = procs[0][1].communicate(timeout=SPAWN_TIMEOUT_S)
        if procs[0][1].returncode != 0:
            raise RuntimeError(f"p0 rc={procs[0][1].returncode}:\n" + err[-3000:])
    finally:
        # ANY failure above must not leave either host alive blocked on
        # a workdir rendezvous
        for _spec, p in procs:
            if p.poll() is None:
                p.kill()
            _reap(p)
    return {
        "p0": json.loads(Path(p0_spec["out"]).read_text()),
        "p1_gen1": json.loads(Path(p1_spec["out"]).read_text()),
        "p1_gen2": p1_gen2,
    }


# ---------------------------------------------------------------------------
# parent-side spawn + oracle


# every harness subprocess registers here; an atexit sweep kills any
# still alive so an interrupted run cannot orphan subprocess fleets
_LIVE_PROCS: set = set()
_LIVE_PROCS_LOCK = _threading.Lock()


def _kill_live_procs() -> None:
    with _LIVE_PROCS_LOCK:
        procs = list(_LIVE_PROCS)
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass


_atexit.register(_kill_live_procs)


def _launch(spec: dict) -> subprocess.Popen:
    from deepflow_tpu_torch.parallel.hostproc import clean_env

    env = clean_env(spec["device"])
    # the child finds the package at the checkout's root, whatever the cwd
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    # spec["argv"]: another entry (a script and its flags) that takes the
    # spec as its last argument — chip_smoke.py's full-width host
    argv = spec.get("argv") or [str(HERE / "torch_mesh_harness.py")]
    p = subprocess.Popen(
        [sys.executable, *argv, json.dumps(spec)],
        cwd=str(REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    with _LIVE_PROCS_LOCK:
        _LIVE_PROCS.add(p)
    return p


def _reap(p: subprocess.Popen) -> None:
    with _LIVE_PROCS_LOCK:
        _LIVE_PROCS.discard(p)


class PortLost(RuntimeError):
    """A host of a distributed run could not bind its coordinator port
    (another process took it between `free_coordinator_port` and the
    bind)."""


def spawn_hosts(specs: list[dict], timeout_s: int = SPAWN_TIMEOUT_S) -> list[dict]:
    """Launch one subprocess per spec concurrently; wait; parse each
    spec's result file. A killed process (spec["kill"]) is EXPECTED to
    exit with KILL_EXIT. ANY failure kills every spawned process —
    a partial fleet must not linger blocked on a done-file barrier."""
    procs = [(spec, _launch(spec)) for spec in specs]
    results = []
    try:
        for spec, p in procs:
            try:
                _out, err = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                p.kill()
                _out, err = p.communicate()
                raise RuntimeError(
                    f"mesh harness process {spec['process_id']} timed out:\n"
                    + err[-2000:]
                )
            want_rc = KILL_EXIT if spec.get("kill") else 0
            if p.returncode != want_rc:
                kind = PortLost if "EADDRINUSE" in err or "address already in use" in err \
                    else RuntimeError
                raise kind(
                    f"mesh harness process {spec['process_id']} rc="
                    f"{p.returncode} (wanted {want_rc}):\n" + err[-3000:]
                )
            results.append(json.loads(Path(spec["out"]).read_text()))
    finally:
        for _spec, p in procs:
            if p.poll() is None:
                p.kill()
            _reap(p)
    return results


def two_process_specs(workdir: Path, *, kill: bool = False, device="cpu") -> list[dict]:
    from deepflow_tpu_torch.parallel.topology import free_coordinator_port

    coord = f"127.0.0.1:{free_coordinator_port()}"
    return [{
        "mode": "distributed", "coordinator": coord,
        "num_processes": 2, "process_id": pid, "device": device,
        "workdir": str(workdir),
        "out": str(Path(workdir) / f"result.p{pid}.json"),
        "kill": kill and pid == 1,
    } for pid in range(2)]


def spawn_distributed(workdir: Path, *, kill: bool = False, device="cpu") -> list[dict]:
    """The two-process distributed run, spawned once more on a fresh
    coordinator port if the first lost its port."""
    try:
        return spawn_hosts(two_process_specs(workdir, kill=kill, device=device))
    except PortLost:
        for f in Path(workdir).iterdir():
            f.unlink()
        return spawn_hosts(two_process_specs(workdir, kill=kill, device=device))


def run_kill(workdir: Path, device="cpu") -> dict:
    """The kill-and-recover 2-process run: gen-1 process 1 checkpoints
    after step CHECKPOINT_AT and dies after KILL_AFTER; gen-2 rejoins
    standalone (no process group), restores, replays its own journal,
    finishes. Returns {"p0", "p1_gen1", "p1_gen2"}."""
    p0, p1_gen1 = spawn_distributed(workdir, kill=True, device=device)
    gen2_spec = {
        "mode": "standalone", "num_processes": 2, "process_id": 1,
        "workdir": str(workdir), "device": device,
        "out": str(Path(workdir) / "result.p1.gen2.json"),
        "restore": True, "first_step": KILL_AFTER + 1,
    }
    (p1_gen2,) = spawn_hosts([gen2_spec])
    return {"p0": p0, "p1_gen1": p1_gen1, "p1_gen2": p1_gen2}


def run_oracle(device="cpu", *, with_rows: bool = False) -> dict:
    """The single-process oracle: identical workload, every shard group
    local (MeshTopology.single), same per-group mesh shape — per-group
    outputs are the digest-for-digest pin for every process's results.
    `with_rows` adds `row_arrays()` under "rows"."""
    import tempfile

    from deepflow_tpu_torch.parallel.topology import MeshTopology

    with tempfile.TemporaryDirectory(prefix="mesh-oracle-") as d:
        topology = MeshTopology.single(
            n_groups=N_GROUPS, devices_per_group=DEVICES_PER_GROUP,
            devices=host_devices(device),
        )
        runner = HostRunner(topology, Path(d))
        try:
            steps = step_frames()
            for i in range(N_STEPS):
                runner.dispatch_step(steps[i])
                runner.pump()
                if i == CHECKPOINT_AT:
                    runner.checkpoint()
            runner.finish()
            res = runner.results()
            if with_rows:
                res["rows"] = runner.row_arrays()
            return res
        finally:
            runner.close()


# memoized sharing across the tests of one file (pytest's --dist loadfile
# keeps a file's tests in one process). Each artifact has a lock so two
# callers build it exactly once.
_CACHE: dict = {}
_MEMO_LOCKS = {
    k: _threading.Lock()
    for k in ("oracle", "mesh2", "mesh2_kill", "rebalance", "rebalance_kill",
              "rb_oracle")
}


def _memo(key: str, build):
    with _MEMO_LOCKS[key]:
        if key not in _CACHE:
            _CACHE[key] = build()
    return _CACHE[key]


def _workdir(prefix: str) -> Path:
    import tempfile

    return Path(tempfile.mkdtemp(prefix=prefix))


def prewarm(*chains) -> None:
    """Build memoized artifacts in background threads, one thread per
    chain of getters (a chain runs in order, so two distributed runs
    never race for a freshly freed port). A failure is swallowed here:
    the cache stays empty, so the test that asks rebuilds and surfaces
    the real error."""
    for chain in chains:
        def run(fns=chain):
            for fn in fns:
                try:
                    fn()
                except Exception:
                    return
        _threading.Thread(target=run, daemon=True).start()


def oracle_result() -> dict:
    return _memo("oracle", run_oracle)


def rebalance_oracle_result() -> dict:
    return _memo("rb_oracle", run_rebalance_oracle)


def mesh2_result() -> list[dict]:
    """The clean 2-process distributed run on the CPU (memoized)."""
    return _memo("mesh2", lambda: spawn_distributed(_workdir("tmesh2-")))


def mesh2_kill_result() -> dict:
    """The kill-and-recover 2-process run on the CPU (memoized)."""
    return _memo("mesh2_kill", lambda: run_kill(_workdir("tmesh2kill-")))


def mesh_rebalance_result() -> dict:
    """The clean mid-stream rebalance run on the CPU (memoized): {"p0", "p1"}."""
    def build():
        p0, p1 = spawn_hosts(rebalance_specs(_workdir("tmeshrb-")))
        return {"p0": p0, "p1": p1}

    return _memo("rebalance", build)


def mesh_rebalance_kill_result() -> dict:
    """Kill-the-old-owner-mid-handover on the CPU (memoized)."""
    return _memo("rebalance_kill", lambda: run_rebalance_kill(_workdir("tmeshrbkill-")))


if __name__ == "__main__":
    _spec = json.loads(sys.argv[1])
    sys.path.insert(0, str(REPO))
    if _spec.get("mode") == "rebalance":
        run_rebalance_host(_spec)
    else:
        run_host(_spec)
