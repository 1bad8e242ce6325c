"""Carry stash, accumulator, sketch-plane and rollup-cascade state
between the JAX package and the port.

The rollup's state is its "weights": with these, a stream can be split
midway between the two packages and both go on computing the same
thing. The numpy form is the reference's `StashState` / `AccumState` /
`SketchState` with `np.asarray` applied to each field (uint32 lanes,
column-major [T, S] tags and [M, S] f32 meters, bool valid, int32
counters and registers, int8 compact HLL registers in pool mode).
Both sketch-plane modes cross; the pool fields are zero-size in slab
mode, on both sides. The cascade's device state is the reference
`TierCascade`'s per-tier stashes, rings (None before a tier's first
advance) and int32 fill cursors, its u32 [rows, shed] lanes and its host
watermarks.

The sharded path's state is [D]-leading on the reference's side (one
array per field with a leading shard axis) and a list of per-shard
states on the port's: `sharded_from_numpy` / `sharded_to_numpy` carry
any of the above across, shard k onto the k-th device.

The enrichment's platform state (`enrich.platform.PlatformState`)
crosses the same way: its info and gprocess matrices, the six hash
tables' lanes with their measured `max_probes`, and the region id. Its
numpy form is a dict; `platform_state_from_numpy` also takes the
reference's PlatformState itself, reading each field with `np.asarray`.

The flow-log stash (`flowlog.aggr.LogStashState`: the minute merge's
state, and the agent FlowMap's flow table) crosses as the reference's
LogStashState fields (uint32 slot/key/int lanes, f32 nums, bool valid,
int32 dropped_overflow); `log_stash_from_numpy` also takes the
reference's state itself. A FlowMap's state is its stash plus its
host-side `seq_tracker` (the per-flow seq interval lists, in their dict
order, which the tracker's eviction reads): `flow_map_state_to_numpy` /
`flow_map_state_from_numpy` carry both, so a test can start the two
packages' maps from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from .aggregator.cascade import TierCascade
from .aggregator.sketchplane import SENTINEL_WIN, SketchState
from .aggregator.stash import AccumState, StashState
from .device import resolve_device
from .enrich.platform import TABLES, PlatformState
from .flowlog.aggr import LogStashState
from .ops.hashtable import table_from_lanes
from .ops.u32 import from_numpy_u32, to_numpy_u32

_LANES = ("slot", "key_hi", "key_lo", "tags")


def _common_from_numpy(d: dict, dev) -> dict:
    out = {k: from_numpy_u32(d[k], dev) for k in _LANES}
    # a copy: the port writes its lanes in place, the source may be read-only
    out["meters"] = torch.from_numpy(np.array(d["meters"], np.float32)).to(dev)
    return out


def _common_to_numpy(state) -> dict:
    out = {k: to_numpy_u32(getattr(state, k)) for k in _LANES}
    out["meters"] = state.meters.detach().cpu().numpy()
    return out


def stash_from_numpy(d: dict, device=None) -> StashState:
    dev = resolve_device(device)
    return StashState(
        **_common_from_numpy(d, dev),
        valid=torch.from_numpy(np.asarray(d["valid"], bool).copy()).to(dev),
        dropped_overflow=torch.tensor(int(d["dropped_overflow"]), dtype=torch.int64,
                                      device=dev),
    )


def accum_from_numpy(d: dict, device=None) -> AccumState:
    return AccumState(**_common_from_numpy(d, resolve_device(device)))


def stash_to_numpy(state: StashState) -> dict:
    out = _common_to_numpy(state)
    out["valid"] = state.valid.detach().cpu().numpy()
    out["dropped_overflow"] = np.int32(int(state.dropped_overflow))
    return out


def accum_to_numpy(acc: AccumState) -> dict:
    return _common_to_numpy(acc)


_I32_PLANES = ("hll", "cms", "hist", "tk_votes", "p_cms", "p_hist", "p_tkv")
_U32_PLANES = ("tk_hi", "tk_lo", "tk_ida", "tk_idb", "p_tkh", "p_tkl", "p_tia", "p_tib")
_U32_LANES = ("win", "count", "wide_close", "wide_count")
_SCALARS = ("rows", "shed", "pool_spill", "pool_promos")


def sketch_from_numpy(d: dict, device=None) -> SketchState:
    """A reference `SketchState` (fields as numpy; slab or pool mode) →
    the port's plane on `device`; the pending buffer gains its scratch
    row."""
    slot_of, pc, pw = np.asarray(d["slot_of"]), len(d["p_hll"]), len(d["wide_close"])
    if slot_of.size not in (0, len(d["win"])) or ((slot_of < -1) | (slot_of >= pc + pw)).any():
        raise ValueError(f"sketch state's pool slot map {slot_of.tolist()} does not fit its "
                         f"ring of {len(d['win'])} and {pc} compact + {pw} wide arena slots")
    dev = resolve_device(device)

    def i32(x):
        return torch.from_numpy(np.array(x, dtype=np.int32)).to(dev)

    def bits(x):
        return torch.from_numpy(np.array(x, dtype=np.uint32).view(np.int32)).to(dev)

    def scalar(x):
        return torch.tensor(int(x), dtype=torch.int64, device=dev)

    pend = np.asarray(d["pend"], np.uint32)
    pend_win = np.asarray(d["pend_win"], np.uint32)
    return SketchState(
        **{k: from_numpy_u32(d[k], dev) for k in _U32_LANES},
        **{k: i32(d[k]) for k in _I32_PLANES}, **{k: bits(d[k]) for k in _U32_PLANES},
        **{k: scalar(d[k]) for k in _SCALARS},
        pend=bits(np.concatenate([pend, np.zeros((1, pend.shape[1]), np.uint32)])),
        pend_win=from_numpy_u32(np.append(pend_win, np.uint32(SENTINEL_WIN)), dev),
        pend_n=scalar(d["pend_n"]),
        slot_of=torch.from_numpy(np.array(d["slot_of"], dtype=np.int64)).to(dev),
        p_hll=torch.from_numpy(np.array(d["p_hll"], dtype=np.int8)).to(dev),
        promote_fill=torch.tensor(float(d["promote_fill"]), dtype=torch.float32, device=dev),
    )


def sketch_to_numpy(sk: SketchState) -> dict:
    """The port's plane → the reference's fields as numpy, with the
    reference's dtypes (scratch row dropped)."""
    p = sk.pending
    out = {k: to_numpy_u32(getattr(sk, k)) for k in _U32_LANES + _U32_PLANES}
    out.update({k: getattr(sk, k).detach().cpu().numpy() for k in _I32_PLANES})
    out.update({k: np.uint32(int(getattr(sk, k))) for k in _SCALARS})
    out["pend"] = to_numpy_u32(sk.pend[:p])
    out["pend_win"] = to_numpy_u32(sk.pend_win[:p])
    out["pend_n"] = np.int32(int(sk.pend_n))
    out["slot_of"] = sk.slot_of.detach().cpu().numpy().astype(np.int32)
    out["p_hll"] = sk.p_hll.detach().cpu().numpy()
    out["promote_fill"] = np.float32(float(sk.promote_fill))
    return out


def cascade_to_numpy(casc: TierCascade) -> dict:
    """The port's tier state → {"tiers", "accs", "fills", "lanes",
    "watermarks"} in the reference's numpy form."""
    return {
        "tiers": [stash_to_numpy(t) for t in casc.tiers],
        "accs": [None if a is None else accum_to_numpy(a) for a in casc.accs],
        "fills": [np.int32(int(f)) for f in casc.fills],
        "lanes": to_numpy_u32(casc.lanes_dev),
        "watermarks": [int(w) for w in casc.watermarks],
    }


def cascade_from_numpy(casc: TierCascade, d: dict) -> TierCascade:
    """Load tier state in the numpy form of `cascade_to_numpy` into a
    port TierCascade of the same tier count (on its device)."""
    n = len(casc.tiers)
    if any(len(d[k]) != n for k in ("tiers", "accs", "fills", "watermarks")):
        raise ValueError(f"cascade state of {len(d['tiers'])} tiers does not fit {n}")
    dev = casc.device
    casc.tiers = [stash_from_numpy(t, dev) for t in d["tiers"]]
    casc.accs = [None if a is None else accum_from_numpy(a, dev) for a in d["accs"]]
    casc.fills = [torch.tensor(int(f), dtype=torch.int64, device=dev) for f in d["fills"]]
    casc.lanes_dev = from_numpy_u32(d["lanes"], dev)
    casc.watermarks = [int(w) for w in d["watermarks"]]
    return casc


def sharded_from_numpy(d: dict, devices, from_numpy=stash_from_numpy) -> list:
    """A reference [D]-leading state (`np.asarray` of each field of a
    sharded StashState / AccumState / SketchState) → one port state per
    shard, shard k built by `from_numpy` on devices[k]."""
    return [from_numpy({k: v[i] for k, v in d.items()}, dev) for i, dev in enumerate(devices)]


def sharded_to_numpy(states: list, to_numpy=stash_to_numpy) -> dict:
    """Per-shard port states → the reference's [D]-leading numpy fields."""
    per = [to_numpy(s) for s in states]
    return {k: np.stack([p[k] for p in per]) for k in per[0]}


_TABLE_LANES = ("key_hi", "key_lo", "value", "filled")


def _field(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def platform_state_from_numpy(src, device=None) -> PlatformState:
    """A platform state in numpy form — or the reference's PlatformState
    — → the port's PlatformState on `device`, bit for bit."""
    dev = resolve_device(device)
    tables = {}
    for name in TABLES:
        t = _field(src, name)
        tables[name] = table_from_lanes(
            *(np.asarray(_field(t, k)) for k in _TABLE_LANES),
            max_probes=int(_field(t, "max_probes")), device=dev)
    return PlatformState(
        infos=from_numpy_u32(np.asarray(_field(src, "infos")), dev),
        gproc_rows=from_numpy_u32(np.asarray(_field(src, "gproc_rows")), dev),
        my_region_id=int(np.asarray(_field(src, "my_region_id"))),
        **tables,
    )


def platform_state_to_numpy(state: PlatformState) -> dict:
    """The port's PlatformState → numpy form (uint32 lanes, bool fill)."""
    out = {"infos": to_numpy_u32(state.infos),
           "gproc_rows": to_numpy_u32(state.gproc_rows),
           "my_region_id": np.uint32(state.my_region_id)}
    for name in TABLES:
        t = getattr(state, name)
        out[name] = {"key_hi": to_numpy_u32(t.key_hi), "key_lo": to_numpy_u32(t.key_lo),
                     "value": to_numpy_u32(t.value),
                     "filled": t.filled.detach().cpu().numpy(),
                     "max_probes": int(t.max_probes)}
    return out


_LOG_LANES = ("slot", "key_hi", "key_lo", "ints")


def log_stash_from_numpy(src, device=None) -> LogStashState:
    """A flow-log stash in numpy form — or the reference's LogStashState
    — → the port's LogStashState on `device`, bit for bit."""
    dev = resolve_device(device)
    return LogStashState(
        **{k: from_numpy_u32(np.asarray(_field(src, k)), dev) for k in _LOG_LANES},
        nums=torch.from_numpy(np.array(_field(src, "nums"), np.float32)).to(dev),
        valid=torch.from_numpy(np.array(_field(src, "valid"), bool)).to(dev),
        dropped_overflow=torch.tensor(int(np.asarray(_field(src, "dropped_overflow"))),
                                      dtype=torch.int64, device=dev),
    )


def log_stash_to_numpy(state: LogStashState) -> dict:
    """The port's LogStashState → the reference's arrays (uint32 lanes,
    f32 nums, bool valid, int32 dropped_overflow)."""
    out = {k: to_numpy_u32(getattr(state, k)) for k in _LOG_LANES}
    out["nums"] = state.nums.detach().cpu().numpy()
    out["valid"] = state.valid.detach().cpu().numpy()
    out["dropped_overflow"] = np.int32(int(state.dropped_overflow))
    return out


def _copy_tracker(tracker: dict) -> dict:
    """A seq_tracker copy in the same dict order, intervals as tuples."""
    return {k: (a, [tuple(iv) for iv in ivals]) for k, (a, ivals) in tracker.items()}


def flow_map_state_to_numpy(fm) -> dict:
    """A port FlowMap's state → {"stash": numpy stash, "seq_tracker":
    copy}."""
    return {"stash": log_stash_to_numpy(fm.state), "seq_tracker": _copy_tracker(fm.seq_tracker)}


def flow_map_state_from_numpy(fm, src):
    """Load a FlowMap state ({"stash": numpy stash or the reference's
    LogStashState, "seq_tracker": dict}) into the port FlowMap `fm`, on
    its device. Returns `fm`."""
    fm.state = log_stash_from_numpy(src["stash"], fm.device)
    fm.seq_tracker = _copy_tracker(src["seq_tracker"])
    return fm
