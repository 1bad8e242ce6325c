"""The port's u32 lane rule.

The JAX package computes on uint32 lanes with wrapping arithmetic.
PyTorch on the CPU implements neither add, shifts, `<`, `maximum` nor
`searchsorted` for `torch.uint32`, so the port carries every u32 lane as
an int64 tensor holding a value in [0, 2^32) and masks with
`& 0xFFFFFFFF` wherever an operation could leave that range:

  * xor / and / or of two lanes stay in range;
  * a right shift of a non-negative int64 is the logical u32 shift;
  * a left shift by r < 32 stays below 2^63, and is masked back;
  * a u32 × u32 product can reach 2^64 and overflow int64, so `mul`
    splits the constant into 16-bit halves: no intermediate passes 2^49.

Comparisons and sorts of lanes order like the unsigned values. Lanes
cross the host boundary as uint32 numpy arrays (`from_numpy_u32`,
`to_numpy_u32`); packed matrices bound for the host travel as int32 bit
patterns (`to_i32_bits`), which the host views as uint32.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
U32_MAX = 0xFFFFFFFF


def shl(x: torch.Tensor, r: int) -> torch.Tensor:
    """(x << r) mod 2^32 for a u32 lane and 0 ≤ r < 32."""
    return (x << r) & MASK if r else x


def rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left by 0 < r < 32."""
    return ((x << r) & MASK) | (x >> (32 - r))


def mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for a u32 lane x and a u32 constant c, with every
    intermediate below 2^49 (int64-safe)."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK


def add(x: torch.Tensor, y) -> torch.Tensor:
    """(x + y) mod 2^32."""
    return (x + y) & MASK


def from_numpy_u32(arr: np.ndarray, device) -> torch.Tensor:
    """uint32 (or any integer) numpy array → int64 u32 lane on `device`.
    Uploads 4 bytes per value (as int32 bits) and widens on the device."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a.view(np.int32)).to(device)
    return t.to(torch.int64) & MASK


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """u32 lane → int32 tensor with the same 32 bits (exact, no reliance
    on wrapping casts)."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """u32 lane (int64) or int32 bit patterns → host uint32 array."""
    a = x.detach().cpu().numpy()
    if a.dtype == np.int32:
        return a.view(np.uint32)
    return a.astype(np.uint32)
