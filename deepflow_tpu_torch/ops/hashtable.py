"""Device-resident static hash tables: vectorized u64-key → u32-value
lookup (port of deepflow_tpu/ops/hashtable.py).

The host builds a fixed-capacity open-addressing table (linear probing)
as flat u32 lanes, ships it to the device once per refresh, and the
device probes it for a whole batch at once: `max_probes` is measured at
build time and bounds an unrolled loop, so a lookup is `max_probes`
gathers + compares with no data-dependent control flow.

Keys are (hi, lo) u32 lane pairs, values u32; multi-field values are a
row index into a caller-side matrix, gathered after lookup. Lanes follow
the port's u32 rule (ops/u32.py): int64 tensors holding u32 values; the
bucket hash's u32 × u32 multiply goes through `u32.mul`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hashing import fmix32, fmix32_np
from .u32 import from_numpy_u32, mul

NOT_FOUND = np.uint32(0xFFFFFFFF)
# Multiplicative mixing constant (2^32 / golden ratio) used to combine the
# two key lanes before the finalizer.
_PHI = 0x9E3779B9


def _bucket_hash_np(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    h = np.asarray(hi, np.uint32) * np.uint32(_PHI) ^ np.asarray(lo, np.uint32)
    return fmix32_np(h)


def _bucket_hash(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return fmix32(mul(hi, _PHI) ^ lo)


@dataclasses.dataclass
class DeviceHashTable:
    """Flat open-addressing table on one device. `filled` marks occupied
    buckets; `max_probes` is the longest probe chain the build measured."""

    key_hi: torch.Tensor  # [C] u32 lane
    key_lo: torch.Tensor  # [C] u32 lane
    value: torch.Tensor  # [C] u32 lane
    filled: torch.Tensor  # [C] bool
    max_probes: int = 1

    @property
    def capacity(self) -> int:
        return self.key_hi.shape[0]

    @property
    def device(self) -> torch.device:
        return self.key_hi.device

    def lookup(self, hi: torch.Tensor, lo: torch.Tensor):
        """Batched probe: [N] u32 lanes → ([N] u32 values, [N] bool found).

        Misses return NOT_FOUND with found=False. The probe loop is an
        unroll of `max_probes` gather+compare steps."""
        mask = self.capacity - 1
        idx = _bucket_hash(hi, lo) & mask
        value = torch.full_like(hi, int(NOT_FOUND))
        found = torch.zeros(hi.shape, dtype=torch.bool, device=hi.device)
        for p in range(self.max_probes):
            slot = (idx + p) & mask
            hit = (self.filled[slot] & (self.key_hi[slot] == hi)
                   & (self.key_lo[slot] == lo) & ~found)
            value = torch.where(hit, self.value[slot], value)
            found = found | hit
        return value, found


def build_table_np(keys_hi, keys_lo, values, min_capacity: int = 8):
    """Host-side construction with numpy linear probing → (key_hi, key_lo,
    value, filled, max_probes) numpy lanes.

    Capacity is the next power of two ≥ 2×n (load factor ≤ 0.5), so
    probe chains stay short; the realized worst chain becomes
    `max_probes`. Duplicate keys: last insert wins (refresh overwrite
    semantics)."""
    keys_hi = np.asarray(keys_hi, dtype=np.uint32)
    keys_lo = np.asarray(keys_lo, dtype=np.uint32)
    values = np.asarray(values, dtype=np.uint32)
    n = keys_hi.shape[0]
    cap = int(min_capacity)
    while cap < max(2 * n, min_capacity):
        cap *= 2

    t_hi = np.zeros(cap, dtype=np.uint32)
    t_lo = np.zeros(cap, dtype=np.uint32)
    t_val = np.zeros(cap, dtype=np.uint32)
    t_fill = np.zeros(cap, dtype=bool)
    max_probes = 1
    mask = cap - 1
    start = _bucket_hash_np(keys_hi, keys_lo)
    for i in range(n):
        idx = int(start[i]) & mask
        for p in range(cap):
            slot = (idx + p) & mask
            if not t_fill[slot]:
                t_hi[slot], t_lo[slot], t_val[slot] = keys_hi[i], keys_lo[i], values[i]
                t_fill[slot] = True
                max_probes = max(max_probes, p + 1)
                break
            if t_hi[slot] == keys_hi[i] and t_lo[slot] == keys_lo[i]:
                t_val[slot] = values[i]  # overwrite duplicate
                break
    return t_hi, t_lo, t_val, t_fill, max_probes


def table_from_lanes(key_hi, key_lo, value, filled, max_probes: int,
                     device) -> DeviceHashTable:
    """Numpy table lanes (the build's, or a reference table's) → a
    DeviceHashTable on `device`."""
    return DeviceHashTable(
        key_hi=from_numpy_u32(key_hi, device),
        key_lo=from_numpy_u32(key_lo, device),
        value=from_numpy_u32(value, device),
        filled=torch.from_numpy(np.array(filled, dtype=bool)).to(device),
        max_probes=int(max_probes),
    )


def build_table(keys_hi, keys_lo, values, min_capacity: int = 8, *,
                device) -> DeviceHashTable:
    """`build_table_np` shipped to `device` (the reference's
    `build_table`, with the device explicit)."""
    return table_from_lanes(*build_table_np(keys_hi, keys_lo, values, min_capacity),
                            device=device)


def empty_table(device) -> DeviceHashTable:
    """A valid table with no entries (all lookups miss)."""
    z = np.zeros(0, np.uint32)
    return build_table(z, z, z, device=device)

