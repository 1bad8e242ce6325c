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

The standalone functions `loghist_init`, `loghist_update` (in place; the
state is returned), `loghist_quantiles` and `loghist_merge` are plain
tensor functions on the caller's device. `loghist_quantiles` is the
reference's float32 cumsum + rank-threshold walk: the bin of quantile q
is the number of bins whose cumulative count lies strictly below
q · total (searchsorted side="left"), read at its geometric centre.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class LogHistSpec:
    bins: int = 1024
    vmin: float = 1.0  # values at/below vmin land in bin 0
    gamma: float = 1.02


def loghist_init(num_groups: int, spec: LogHistSpec, *, device=None) -> torch.Tensor:
    """[num_groups, bins] int32 zero counts on `device`."""
    return torch.zeros((num_groups, spec.bins), dtype=torch.int32,
                       device=resolve_device(device))


def loghist_update(state: torch.Tensor, group_ids, values, valid,
                   spec: LogHistSpec) -> torch.Tensor:
    """Count each valid value into its group's bin, in place; the state
    is returned. Rows whose group lies outside the plane are dropped."""
    g, bins = state.shape
    b = loghist_bin(values, spec).to(torch.int64)
    gid = group_ids.to(torch.int64)
    ok = valid & (gid >= 0) & (gid < g)
    state.view(-1).index_add_(0, torch.where(ok, gid * bins + b, 0), ok.to(torch.int32))
    return state


def loghist_centers(spec: LogHistSpec, device=None) -> torch.Tensor:
    """[bins] float32 geometric bin centres vmin · gamma^(i + 0.5)."""
    i = torch.arange(spec.bins, dtype=torch.float32, device=device)
    return spec.vmin * torch.pow(torch.tensor(spec.gamma, dtype=torch.float32,
                                              device=device), i + 0.5)


def loghist_quantiles(state: torch.Tensor, spec: LogHistSpec,
                      qs: tuple[float, ...]) -> torch.Tensor:
    """[num_groups, len(qs)] float32 quantile estimates (bin centres); 0
    for an empty group."""
    cum = torch.cumsum(state.to(torch.float32), dim=1)
    total = cum[:, -1:]
    centers = loghist_centers(spec, state.device)
    out = []
    for q in qs:
        idx = (cum < q * total).sum(dim=1).clamp(0, spec.bins - 1)
        out.append(torch.where(total[:, 0] > 0, centers[idx], 0.0))
    return torch.stack(out, dim=1)


def loghist_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b


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
