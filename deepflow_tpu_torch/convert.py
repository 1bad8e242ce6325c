"""Carry stash and accumulator state between the JAX package and the port.

The rollup's state is its "weights": with these, a stream can be split
midway between the two packages and both go on computing the same
thing. The numpy form is the reference's `StashState` / `AccumState`
with `np.asarray` applied to each field (uint32 lanes, column-major
[T, S] tags and [M, S] f32 meters, bool valid, int32 dropped_overflow).
"""

from __future__ import annotations

import numpy as np
import torch

from .aggregator.stash import AccumState, StashState
from .device import resolve_device
from .ops.u32 import from_numpy_u32, to_numpy_u32

_LANES = ("slot", "key_hi", "key_lo", "tags")


def _common_from_numpy(d: dict, dev) -> dict:
    out = {k: from_numpy_u32(d[k], dev) for k in _LANES}
    out["meters"] = torch.from_numpy(np.ascontiguousarray(d["meters"], np.float32)).to(dev)
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
