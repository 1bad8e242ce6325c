"""Device memory ledger — per-plane device-memory accounting for every
device-resident buffer the pipeline owns (port of
deepflow_tpu/profiling/ledger.py).

  * **Profilable** — a registration protocol: a component exposes
    `device_planes() -> {plane_name: tree of tensors}` (nested lists,
    tuples, dicts and dataclasses). The window managers, pipelines and
    the feeder sink implement it, enumerating every plane they own:
    stash, accumulator ring, counter ring + gate state, sketch slabs or
    pools, cascade tier stashes/rings, staged uploads, lane vectors,
    the async drain's held flushes.
  * **DeviceMemoryLedger** — holds Profilables WEAKLY (a torn-down
    pipeline leaves the ledger; `close()` deregisters eagerly) and
    snapshots per-plane bytes + high watermarks on demand. ZERO device
    fetches: a tensor's storage size is metadata, so the ledger is safe
    to sample from a ticking collector thread and from a pull path.
  * **Countable face** — the default ledger registers on the default
    StatsCollector as module `tpu_hbm`, so `tpu_hbm_sketch_bytes`,
    `tpu_hbm_stash_bytes`, … dogfood into `deepflow_system`.

Bytes are counted per STORAGE, not per tensor: PyTorch tensors can be
views of one storage (a slice of a buffer, a reshaped lane), which JAX
arrays never are. `plane_bytes` counts each storage once, by
`untyped_storage().data_ptr()` and `.nbytes()`, so a plane holding a
slice of another buffer does not count it twice, and a ledger snapshot
dedups across the planes of one owner. The port carries u32 lanes as
int64 tensors (ops/u32.py), so its byte counts are its own, not the
reference's: the plane NAMES follow the reference for the same
configuration; the bytes are the port's owned storages.

Reconciliation contract (tests/test_torch_profiling.py, chip_smoke
3n): Σ per-plane ledger bytes == the summed sizes of exactly the
distinct storages of the owner's planes, and on the card that sum stays
at or below the growth of `torch.cuda.memory_allocated` across the
owner's construction and ingests.
"""

from __future__ import annotations

import threading
import weakref
from typing import Mapping, Protocol, runtime_checkable

#: canonical plane vocabulary (components may add ad-hoc names; docs
#: and the reconciliation test pin this set)
PLANE_STASH = "stash"
PLANE_ACCUMULATOR = "accumulator"
PLANE_STATS_RING = "stats_ring"
PLANE_SKETCH = "sketch"
# pooled sketch memory: with SketchConfig.pool set, the
# single "sketch" plane splits four ways — compact pool arenas, wide
# pool arenas, the closed-block pending ring, and routing/meta scalars —
# so HBM density (bytes per unit cardinality capacity) is attributable
# per pool, not per slab
PLANE_SKETCH_POOL_HOT = "sketch_pool_hot"
PLANE_SKETCH_POOL_WIDE = "sketch_pool_wide"
PLANE_SKETCH_PENDING = "sketch_pending"
PLANE_SKETCH_META = "sketch_meta"
PLANE_CASCADE = "cascade"
PLANE_LANES = "lanes"  # small CB lane vectors (fold_rows, casc, snap)
PLANE_STAGED = "staged"  # feeder double-buffer upload (StagedBatch)
PLANE_CHECKPOINT = "checkpoint_scratch"  # transient pack buffers (HWM only)


@runtime_checkable
class Profilable(Protocol):
    def device_planes(self) -> Mapping[str, object]: ...


def plane_tensors(tree) -> list:
    """The tensor leaves of one plane: walks tensors, None, lists,
    tuples, dicts and dataclass instances (StashState & co). Metadata
    only — nothing is read from the device."""
    import dataclasses

    import torch

    out: list = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return out


def storage_key(t) -> tuple:
    """(device, storage address): one key per distinct storage."""
    st = t.untyped_storage()
    return (str(t.device), st.data_ptr())


def plane_bytes(tree, seen: set | None = None) -> tuple[int, int]:
    """(bytes, storage_count) for one plane — metadata only, no
    transfer. Each storage counts once (its whole `nbytes()`), and with
    `seen` shared across calls, once across planes too."""
    seen = set() if seen is None else seen
    total = count = 0
    for t in plane_tensors(tree):
        key = storage_key(t)
        if key in seen:
            continue
        seen.add(key)
        total += int(t.untyped_storage().nbytes())
        count += 1
    return total, count


class _Source:
    __slots__ = ("module", "tags", "devices", "_ref")

    def __init__(self, module: str, tags: dict, devices: int, profilable):
        self.module = module
        self.tags = tuple(sorted(tags.items()))
        self.devices = max(1, int(devices))
        self._ref = weakref.ref(profilable)

    def owner(self):
        return self._ref()


class DeviceMemoryLedger:
    """Weakly-held Profilable registry + per-plane byte accounting."""

    def __init__(self, name: str = "hbm"):
        self.name = name
        self._sources: list[_Source] = []
        self._lock = threading.Lock()
        # (module, tags, plane) -> high watermark bytes, surviving the
        # owner (a restarted pipeline's peak stays visible until reset)
        self._hwm: dict[tuple, int] = {}
        # transient planes (checkpoint pack scratch): bytes=0 steady,
        # only the watermark is meaningful
        self._transient_hwm: dict[str, int] = {}
        self.seq = 0  # bumped per snapshot/sample — ProfileSnapshot clock
        self.snapshots = 0

    # -- registry -------------------------------------------------------
    def register(self, module: str, profilable: Profilable, *,
                 devices: int = 1, **tags: str) -> _Source:
        src = _Source(module, tags, devices, profilable)
        with self._lock:
            self._sources = [s for s in self._sources if s.owner() is not None]
            self._sources.append(src)
        return src

    def deregister(self, src: _Source) -> None:
        with self._lock:
            if src in self._sources:
                self._sources.remove(src)

    def note_transient(self, plane: str, nbytes: int) -> None:
        """Record a short-lived scratch allocation (checkpoint pack
        buffers) — steady-state bytes stay 0, the watermark shows the
        peak the plane ever needed."""
        with self._lock:
            if nbytes > self._transient_hwm.get(plane, 0):
                self._transient_hwm[plane] = int(nbytes)

    # -- read faces -----------------------------------------------------
    def snapshot(self) -> list[dict]:
        """One row per (owner, plane): bytes, bytes/device, arrays,
        high watermark. Walks live owners only (dead weakrefs pruned);
        zero device fetches."""
        with self._lock:
            sources = list(self._sources)
        rows: list[dict] = []
        dead: list[_Source] = []
        for src in sources:
            owner = src.owner()
            if owner is None:
                dead.append(src)
                continue
            try:
                planes = owner.device_planes()
            except Exception:  # a torn-down owner must not kill the walk
                continue
            seen: set = set()  # one owner's planes never share a storage twice
            for plane, tree in sorted(planes.items()):
                nbytes, n_arrays = plane_bytes(tree, seen)
                key = (src.module, src.tags, plane)
                with self._lock:
                    hwm = self._hwm[key] = max(self._hwm.get(key, 0), nbytes)
                rows.append({
                    "module": src.module,
                    "tags": dict(src.tags),
                    "plane": plane,
                    "bytes": nbytes,
                    "bytes_per_device": nbytes // src.devices,
                    "devices": src.devices,
                    "arrays": n_arrays,
                    "bytes_hwm": hwm,
                })
        with self._lock:
            if dead:
                self._sources = [s for s in self._sources if s not in dead]
            for plane, hwm in sorted(self._transient_hwm.items()):
                rows.append({
                    "module": "transient", "tags": {}, "plane": plane,
                    "bytes": 0, "bytes_per_device": 0, "devices": 1,
                    "arrays": 0, "bytes_hwm": hwm,
                })
            self.seq += 1
            self.snapshots += 1
        return rows

    def get_counters(self) -> dict[str, int]:
        """Countable face: per-plane byte totals summed across owners —
        `sketch_bytes` under module `tpu_hbm` becomes the
        `tpu_hbm_sketch_bytes` metric in deepflow_system (SQL + PromQL,
        the acceptance pin). Fetch-free like every Countable."""
        rows = self.snapshot()
        out: dict[str, int] = {}
        total = 0
        for r in rows:
            out[f"{r['plane']}_bytes"] = (
                out.get(f"{r['plane']}_bytes", 0) + r["bytes"]
            )
            hk = f"{r['plane']}_bytes_hwm"
            out[hk] = max(out.get(hk, 0), r["bytes_hwm"])
            total += r["bytes"]
        out["total_bytes"] = total
        out["planes"] = len({r["plane"] for r in rows})
        out["sources"] = len(self._sources)
        out["snapshots"] = self.snapshots
        return out


#: process-wide default ledger, mirroring utils/stats.default_collector;
#: registered there as module `tpu_hbm` so the dogfood loop closes with
#: no further wiring (an empty ledger emits no fields → no rows)
default_ledger = DeviceMemoryLedger()

from ..utils.stats import register_countable  # noqa: E402

register_countable("tpu_hbm", default_ledger)


def register_profilable(module: str, profilable: Profilable, *,
                        devices: int = 1, ledger: DeviceMemoryLedger | None = None,
                        **tags: str) -> _Source:
    """Register a component's device planes on the (default) ledger —
    the RegisterCountable twin for HBM accounting."""
    led = default_ledger if ledger is None else ledger
    return led.register(module, profilable, devices=devices, **tags)


def profile_tick_sink(bus, *, ledger: DeviceMemoryLedger | None = None,
                      db: str = "deepflow_system",
                      table: str = "deepflow_system"):
    """→ a StatsCollector sink publishing a `ProfileSnapshot` event on
    `bus` at each collector tick: the moment profiling rows land in
    deepflow_system, standing queries / span-latency alert rules over it
    re-evaluate. Sink-only (never fires on pull-path `sample()` reads,
    so dashboard pulls don't publish); with `bus=None` it does nothing."""
    led = default_ledger if ledger is None else ledger

    def sink(points) -> None:
        if not points or bus is None:
            return
        from ..querier.events import ProfileSnapshot

        with led._lock:
            led.seq += 1
            seq = led.seq
        # the event clock is the tick's own sample timestamp — the time
        # column the rows landed under — so rule evaluations run at data
        # time (deterministic under replay), never the wall
        t = max(int(p.timestamp) for p in points)
        bus.publish(ProfileSnapshot(db, table, seq, t))

    return sink
