"""Device profiling plane (port of deepflow_tpu/profiling/) — always-on,
zero new device fetches. Two layers:

  * `ledger` — DeviceMemoryLedger: per-plane device bytes over
    weakly-registered Profilables (`tpu_hbm_*` in deepflow_system);
  * `census` — StepCostCensus: per step × bucket shapes, first-dispatch
    wall time, logical sorts and the bytes bound;
  * span latency distributions live in `utils/spans` (per-stage
    log-histograms → p50/p95/p99 lanes), not here.
"""

from .census import StepCostCensus, default_census
from .ledger import (
    PLANE_ACCUMULATOR,
    PLANE_CASCADE,
    PLANE_CHECKPOINT,
    PLANE_LANES,
    PLANE_SKETCH,
    PLANE_STAGED,
    PLANE_STASH,
    PLANE_STATS_RING,
    DeviceMemoryLedger,
    Profilable,
    default_ledger,
    plane_bytes,
    profile_tick_sink,
    register_profilable,
)

__all__ = [
    "DeviceMemoryLedger",
    "Profilable",
    "StepCostCensus",
    "default_census",
    "default_ledger",
    "plane_bytes",
    "profile_tick_sink",
    "register_profilable",
    "PLANE_STASH",
    "PLANE_ACCUMULATOR",
    "PLANE_STATS_RING",
    "PLANE_SKETCH",
    "PLANE_CASCADE",
    "PLANE_LANES",
    "PLANE_STAGED",
    "PLANE_CHECKPOINT",
]
