"""HyperLogLog register math (port of deepflow_tpu/ops/hll.py).

A dense [G, m] int32 register plane per sketch (m = 2^precision); an
update is a scatter-max of rho = clz32(hash_hi) + 1 at register
hash_lo & (m-1), a merge the register-wise max. The standalone
functions (`hll_init`, `hll_update`, `hll_estimate`, `hll_merge`) are
plain tensor functions on the caller's device: `hll_update` writes the
state in place and returns it (the reference donates its input), and
`hll_estimate` computes in float32 as the reference's 32-bit JAX does.
`clz32` runs over u32 lanes (int64 tensors, ops/u32.py); the
sketch plane's estimate and the packed-register inverse are host numpy
over fetched blocks, as in the reference, and the packing runs on both
sides.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .u32 import MASK


def hll_init(num_groups: int, precision: int = 14, *, device=None) -> torch.Tensor:
    """[num_groups, 2^precision] int32 zero registers on `device`."""
    return torch.zeros((num_groups, 1 << precision), dtype=torch.int32,
                       device=resolve_device(device))


def clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of a u32 lane exactly (int64 result in
    0..32), by the reference's branchless binary search: a float log2
    would round up near powers of two and bias rho low."""
    x = x & MASK
    zero_in = x == 0
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        has_s_zeros = x < (1 << (32 - s))
        n = torch.where(has_s_zeros, n + s, n)
        x = torch.where(has_s_zeros, (x << s) & MASK, x)
    return torch.where(zero_in, 32, n)


def hll_update(state: torch.Tensor, group_ids, hash_hi, hash_lo, valid) -> torch.Tensor:
    """Scatter-max one batch of observations into `state` (in place; the
    state is returned). group_ids [N] int (rows of state); hash_hi/lo
    [N] u32 lanes (int64) of the distinct-counted entity; valid [N]
    bool. Rows that are invalid or whose group lies outside the plane
    are dropped."""
    g, m = state.shape
    reg = hash_lo & (m - 1)
    rho = (clz32(hash_hi) + 1).to(torch.int32)  # 1..33
    gid = group_ids.to(torch.int64)
    ok = valid & (gid >= 0) & (gid < g)
    # dropped rows max a 0 into cell 0: registers are never negative
    state.view(-1).scatter_reduce_(0, torch.where(ok, gid * m + reg, 0),
                                   torch.where(ok, rho, 0), "amax")
    return state


def hll_estimate(state: torch.Tensor) -> torch.Tensor:
    """[num_groups] float32 cardinality estimates (classic HLL with the
    small-range linear-counting correction), in float32 as the
    reference computes them."""
    m = state.shape[1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    regs = state.to(torch.float32)
    raw = alpha * m * m / torch.exp2(-regs).sum(dim=1)
    zeros = (state == 0).to(torch.float32).sum(dim=1)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


def hll_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Register-wise max: associative and commutative."""
    return torch.maximum(a, b)


def hll_estimate_np(state) -> np.ndarray:
    """[num_groups] cardinality estimates over a fetched [G, m] register
    plane: classic HLL with the small-range linear-counting correction."""
    state = np.asarray(state)
    m = state.shape[1]
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / np.sum(np.exp2(-state.astype(np.float64)), axis=1)
    zeros = np.sum(state == 0, axis=1).astype(np.float64)
    with np.errstate(divide="ignore"):
        linear = m * np.log(m / np.maximum(zeros, 1.0))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return np.where(use_linear, linear, raw)


def hll_pack_registers(regs):
    """[..., m] registers → [..., m//4] u32 words, 4 per word, byte 0 =
    register 0 (the pooled block's wire form; m divisible by 4). A tensor
    (the int8 compact registers on the device) gives an int64 u32 lane,
    an array a uint32 array."""
    if isinstance(regs, torch.Tensor):
        r = regs.to(torch.int64) & 0xFF
    else:
        r = np.asarray(regs).astype(np.uint32) & np.uint32(0xFF)
    b = r.reshape(r.shape[:-1] + (r.shape[-1] // 4, 4))
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def hll_unpack_registers_np(words, m: int) -> np.ndarray:
    """Inverse of `hll_pack_registers`: [..., m//4] u32 → [..., m] i32."""
    w = np.asarray(words, dtype=np.uint32)
    out = np.empty(w.shape[:-1] + (m,), dtype=np.int32)
    b = out.reshape(w.shape[:-1] + (m // 4, 4))
    for k in range(4):
        b[..., k] = (w >> np.uint32(8 * k)) & np.uint32(0xFF)
    return out
