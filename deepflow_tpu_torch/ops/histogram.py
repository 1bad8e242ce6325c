"""Log-binned latency histograms (port of deepflow_tpu/ops/histogram.py).

Per-group [G, bins] int32 planes with geometric bin edges:
bin(v) = floor(log_gamma(v / vmin)), clipped to [0, bins). `loghist_bin`
computes in float32 as the reference does; the float→int32 step
saturates like XLA's cast (NaN → 0, ±inf → the int32 limits) before the
clip, so out-of-range values land in the same edge bins on both sides.

Pooled compact slots (aggregator/sketchplane.py, pool mode) keep
bins // factor bins: the compact bin is the wide bin divided by the
factor (`loghist_coarsen_bin`, exact), and `loghist_expand` puts each
compact bin's mass at the central wide bin it covers.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class LogHistSpec:
    bins: int = 1024
    vmin: float = 1.0  # values at/below vmin land in bin 0
    gamma: float = 1.02


def saturate_i32(x: torch.Tensor) -> torch.Tensor:
    """float → int32 with XLA's CPU semantics: truncate toward zero,
    saturate at the int32 limits, NaN → 0. A bare `.to(torch.int32)`
    gives INT_MIN for every out-of-range value on the CPU."""
    y = torch.nan_to_num(x.double(), nan=0.0)
    return y.clamp(-(2 ** 31), 2 ** 31 - 1).to(torch.int32)


def loghist_bin(values: torch.Tensor, spec: LogHistSpec) -> torch.Tensor:
    """[N] f32 values → [N] int32 bin ids."""
    v = torch.maximum(values.float(), torch.tensor(spec.vmin, dtype=torch.float32))
    b = torch.floor(torch.log(v / spec.vmin) / math.log(spec.gamma))
    return saturate_i32(b).clamp(0, spec.bins - 1)


def loghist_coarsen_bin(wide_bin, factor: int):
    """[N] wide bin ids → compact bin ids (`factor` wide bins each)."""
    return wide_bin // factor


def loghist_expand(compact, bins: int, xp=torch):
    """[..., bins // factor] compact counts → [..., bins] (`xp` torch for
    a tensor, np for a fetched block), each compact bin's mass at the
    central wide bin it covers."""
    bc = compact.shape[-1]
    factor = bins // bc
    assert factor * bc == bins, (bc, bins)
    if xp is torch:
        out = torch.zeros(compact.shape[:-1] + (bins,), dtype=compact.dtype,
                          device=compact.device)
    else:
        out = xp.zeros(compact.shape[:-1] + (bins,), dtype=compact.dtype)
    out[..., factor // 2::factor] = compact
    return out
