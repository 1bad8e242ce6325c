"""Count-min row hashing (port of deepflow_tpu/ops/cms.py).

`[depth, width]` int32 counter planes; row d's column comes from the
64-bit key by the Kirsch–Mitzenmacher mix h_d = hi + d·lo followed by
one avalanche round. `row_slots` is the device form over u32 lanes
(int64 tensors — every multiply through `u32.mul`, ops/u32.py);
`row_slots_np` and `cms_query_np` are the host forms over fetched
blocks. The CUDA sketch kernel (kernels/sketch_fused.cu) recomputes the
same columns with native uint32 arithmetic. `cms_expand` up-tiles a
pooled compact plane (aggregator/sketchplane.py, pool mode).

The standalone functions `cms_init`, `cms_update` (in place, int32
adds that wrap like XLA's; the state is returned), `cms_query` (min over
rows) and `cms_merge` are plain tensor functions on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .histogram import saturate_i32
from .u32 import MASK, mul

CMS_MIX = 0x2C1B3C6D


def cms_init(depth: int = 4, width: int = 1 << 16, *, device=None) -> torch.Tensor:
    """[depth, width] int32 zero counters on `device` (width a power of 2)."""
    assert width & (width - 1) == 0, "width must be a power of two"
    return torch.zeros((depth, width), dtype=torch.int32, device=resolve_device(device))


def row_slots(hash_hi: torch.Tensor, hash_lo: torch.Tensor, depth: int,
              width: int) -> torch.Tensor:
    """[depth, N] int64 flattened slot indices d·width + col_d."""
    cols = []
    for d in range(depth):
        h = (hash_hi + mul(hash_lo, d)) & MASK
        h = h ^ (h >> 15)
        h = mul(h, CMS_MIX)
        h = h ^ (h >> 12)
        cols.append((h & (width - 1)) + d * width)
    return torch.stack(cols)


def as_i32(weight: torch.Tensor) -> torch.Tensor:
    """A weight lane as int32 the way XLA casts it: floats saturate
    (`saturate_i32`), integers keep their low 32 bits."""
    return saturate_i32(weight) if weight.is_floating_point() else weight.to(torch.int32)


def cms_update(state: torch.Tensor, hash_hi, hash_lo, weight, valid) -> torch.Tensor:
    """Add `weight` (cast to int32) for each valid row, in place; the
    state is returned."""
    depth, width = state.shape
    slots = row_slots(hash_hi, hash_lo, depth, width)  # [depth, N]
    w = torch.where(valid, as_i32(weight), 0)
    state.view(-1).index_add_(0, slots.reshape(-1), w[None, :].expand(depth, -1).reshape(-1))
    return state


def cms_query(state: torch.Tensor, hash_hi, hash_lo) -> torch.Tensor:
    """[N] frequency estimates: the min over rows."""
    depth, width = state.shape
    slots = row_slots(hash_hi, hash_lo, depth, width)
    return state.reshape(-1)[slots.reshape(-1)].reshape(depth, -1).min(dim=0).values


def cms_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


def row_slots_np(hash_hi, hash_lo, depth: int, width: int) -> np.ndarray:
    """Host twin of `row_slots` on numpy uint32 (wrapping) arithmetic."""
    d = np.arange(depth, dtype=np.uint32)[:, None]
    h = (np.asarray(hash_hi, dtype=np.uint32)[None, :]
         + d * np.asarray(hash_lo, dtype=np.uint32)[None, :])
    h = h ^ (h >> np.uint32(15))
    h = h * np.uint32(CMS_MIX)
    h = h ^ (h >> np.uint32(12))
    col = (h & np.uint32(width - 1)).astype(np.int32)
    return (np.arange(depth, dtype=np.int32) * width)[:, None] + col


def cms_query_np(state, hash_hi, hash_lo) -> np.ndarray:
    """[N] point estimates (min over rows) over a fetched [D, W] plane."""
    state = np.asarray(state)
    depth, width = state.shape
    slots = row_slots_np(hash_hi, hash_lo, depth, width)
    vals = state.reshape(-1)[slots.reshape(-1)].reshape(depth, -1)
    return vals.min(axis=0)


def cms_expand(compact, width: int, xp=torch):
    """Up-tile a pooled compact [depth, Wc] plane to [depth, width]
    (`xp` torch for a tensor, np for a fetched block). The column hash is
    width-independent, so for Wc | width (both powers of two) a key's
    compact column is its wide column mod Wc: tiling puts every compact
    counter at each wide column that folds onto it, and point queries
    read the same estimate from either plane."""
    wc = compact.shape[-1]
    assert width % wc == 0 and width & (width - 1) == 0, (wc, width)
    return xp.tile(compact, (1, width // wc))
