"""t-digest centroids from a log-binned histogram (port of
deepflow_tpu/ops/tdigest.py).

A histogram is compressed into C centroids whose mass follows the
arcsine scale k(q) = 1/2 + asin(2q−1)/π (fine at the tails, coarse
mid-distribution); merge = concatenate + re-compress. Everything runs
in float32 like the reference; sums may differ from XLA's in the last
bits.

Every function runs where its tensors live (leading dims batch, as the
reference vmaps over groups); a fetched sketch block's host arrays go in
through `torch.from_numpy` (WindowSketchBlock.tdigest / .quantile).
"""

from __future__ import annotations

import math

import torch

from .histogram import LogHistSpec, loghist_centers


def _compress_t(means: torch.Tensor, weights: torch.Tensor, c: int):
    """Tensor compress over the last dim (leading dims batch)."""
    means = means.to(torch.float32).expand_as(weights)
    w = weights.to(torch.float32).clamp(min=0.0)
    key = torch.where(w > 0, means, math.inf)
    order = torch.sort(key, dim=-1, stable=True).indices
    m_s, w_s = means.gather(-1, order), w.gather(-1, order)
    total = w_s.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(w_s, dim=-1)
    q_mid = (cum - 0.5 * w_s) / total.clamp(min=1.0)
    k = 0.5 + torch.asin(2.0 * q_mid.clamp(0.0, 1.0) - 1.0) / math.pi
    bucket = torch.floor(k * c).to(torch.int64).clamp(0, c - 1)
    bucket = torch.where(w_s > 0, bucket, c)
    shape = w_s.shape[:-1] + (c + 1,)
    out_w = torch.zeros(shape, dtype=torch.float32, device=w.device)
    out_wm = torch.zeros(shape, dtype=torch.float32, device=w.device)
    out_w.scatter_add_(-1, bucket, w_s)
    out_wm.scatter_add_(-1, bucket, w_s * m_s)
    out_w, out_wm = out_w[..., :c], out_wm[..., :c]
    out_m = torch.where(out_w > 0, out_wm / out_w.clamp(min=1e-30), 0.0)
    return out_m, out_w


def tdigest_compress(means, weights, compression: int = 64):
    """(means [..., n], weights [..., n]) → (means [..., C], weights
    [..., C]) float32 on the inputs' device. Zero-weight inputs are
    ignored; output centroids are mean-sorted with zero-weight padding
    at unused tail positions."""
    return _compress_t(torch.as_tensor(means), torch.as_tensor(weights), compression)


def tdigest_from_loghist(hist: torch.Tensor, spec: LogHistSpec, compression: int = 64):
    """[G, B] histogram plane → ([G, C] means, [G, C] weights) float32,
    each group compressed from its bins at their geometric centres."""
    centers = loghist_centers(spec, hist.device)
    return _compress_t(centers, hist.to(torch.float32), compression)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """jnp.interp over ascending `xp` (the same formula: right-side
    search, clamped ends, a zero-width step takes the left value)."""
    n = xp.shape[0]
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = dx.abs() <= torch.finfo(torch.float32).eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def tdigest_quantile(means, weights, qs):
    """Interpolated quantiles [Q] from one digest ([C] means/weights),
    on the inputs' device."""
    means = torch.as_tensor(means).to(torch.float32)
    weights = torch.as_tensor(weights, device=means.device).to(torch.float32)
    qs = torch.as_tensor(qs, device=means.device).to(torch.float32)
    total = weights.sum()
    cum = torch.cumsum(weights, 0) - 0.5 * weights
    q_cent = cum / total.clamp(min=1e-30)
    # zero-weight padding parks past q=1 with the largest real mean
    real = weights > 0
    max_mean = torch.where(real, means, -math.inf).max()
    q_cent = torch.where(real, q_cent, 2.0)
    means_r = torch.where(real, means, max_mean)
    order = torch.sort(q_cent, stable=True).indices
    out = _interp(qs, q_cent[order], means_r[order])
    return torch.where(total > 0, out, 0.0)


def tdigest_merge(m1, w1, m2, w2, compression: int = 64):
    """Merge two digests (concatenate + re-compress)."""
    return tdigest_compress(torch.cat([m1, m2], dim=-1), torch.cat([w1, w2], dim=-1),
                            compression)
