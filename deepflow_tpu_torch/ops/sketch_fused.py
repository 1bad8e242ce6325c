"""Fused sketch update over the shared-sorted batch — the port of
deepflow_tpu/ops/sketch_pallas.py.

`sketch_update_fused` computes what the reference launcher computes:
HLL register max, count-min run-head adds and the per-hash-row top-K
challenger scan, over one sketch-plane phase's rows in the plane's
shared (window, key_hi, key_lo) order, returning (hll, cms,
challengers) with `challengers` the `ops.topk._apply_challengers` input.
`hll` [R, G, m] and `cms` [R, D, W] int32 are updated IN PLACE. The
per-row lanes (gid, reg, rho, mask, id_a, id_b) arrive in batch order
and are read through the shared sort's `s_pos`; the slot (s_win mod R)
and the run-head weight (head ? rw : 0) are derived from the sorted
lanes, so the caller writes no sorted copies.

On a CUDA tensor it launches the hand-written kernel of
kernels/sketch_fused.cu (one cooperative launch); on a CPU tensor it
runs `sketch_update_fused_plain` beside it — the gathers through
`s_pos`, then the reference's XLA shared-sort branch
(sketchplane.py:922-948), which is also the kernel's parity reference
on the card. Nothing falls back: a CUDA call launches the kernel or
raises. The port has no DEEPFLOW_FUSED_SKETCH switch and no shape
guard: the TPU guard bounded SMEM/VMEM, which have no counterpart here;
a shape the kernel cannot index raises.

The kernel takes a zeroed [d·R·C + 1] scratch (the challenger table and
its grid-barrier word) and zeroes the previous call's, so the wrapper
keeps two per (device, shape), alternates them and never clears either,
beside an [N] id scratch the kernel writes before it reads; calls that
share them must run on one stream, as the plane's do.

The two versions agree bit for bit on hll, cms and every challenger
lane, with one exception that no caller can see: for a bucket no live
row hashed to, the plain version's key/id lanes hold row N-1's values
(got is False there, so `_apply_challengers` ignores them), the
kernel's hold 0.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import check_launch, load
from .cms import row_slots
from .topk import topk_challengers_presorted

#: kernel launches since the last reset (one per call on a CUDA tensor)
LAUNCHES = {"sketch_fused": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def hll_cms_scatter(hll, cms, slot, gid, reg, rho, mask, key_hi, key_lo, weight) -> None:
    """In place: hll[slot, gid, reg] = max(., rho) for rows in `mask`,
    and cms[slot, d, col_d(key)] += weight (int32, wrapping) for every
    row. Masked rows max a 0 into a valid register (registers are ≥ 0);
    callers give them weight 0, so no scratch cell is needed."""
    _, g, m = hll.shape
    d_cms, w_cms = cms.shape[1], cms.shape[2]
    cell = (slot * g + gid) * m + reg
    hll.view(-1).scatter_reduce_(0, torch.where(mask, cell, 0),
                                 torch.where(mask, rho, 0).to(torch.int32), "amax")
    flat = slot[None, :] * (d_cms * w_cms) + row_slots(key_hi, key_lo, d_cms, w_cms)
    cms.view(-1).index_add_(0, flat.reshape(-1), weight[None, :].expand(d_cms, -1).reshape(-1))


def sketch_update_fused_plain(hll, cms, *, tk_shape, gid, reg, rho, mask, id_a, id_b,
                              s_pos, s_win, head, rw, s_hi, s_lo):
    """Plain PyTorch version: the gathers through `s_pos`, then a masked
    HLL scatter-max, a count-min scatter-add of the run-head weights (0
    off the heads), and `topk_challengers_presorted`."""
    d_tk, c_tk = tk_shape
    s_slot, s_mask = s_win % hll.shape[0], mask[s_pos]
    hll_cms_scatter(hll, cms, s_slot, gid[s_pos], reg[s_pos], rho[s_pos], s_mask, s_hi,
                    s_lo, torch.where(head, rw, 0))
    challengers = (topk_challengers_presorted(s_slot, s_hi, s_lo, id_a[s_pos], id_b[s_pos],
                                              rw, s_mask, hll.shape[0], d_tk, c_tk)
                   if d_tk else [])
    return hll, cms, challengers


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LIB = None
#: (device index, buckets) → [the kernel's two scratch tables
#: [2, buckets + 1] int64, the index of the zeroed one, the id scratch]
_TABLES: dict = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("sketch_fused")
        lib.sketch_fused_launch.argtypes = [_PTR] * 19 + [_INT] * 8 + [_PTR]
        lib.sketch_fused_launch.restype = _INT
        _LIB = lib
    return _LIB


def _require(t: torch.Tensor, name: str, dtype, device: int, shape) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on CUDA
    device index `device` (get_device() is -1 on the CPU)."""
    if (t.dtype is not dtype or t.get_device() != device or not t.is_contiguous()
            or t.shape != shape):
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor of shape {tuple(shape)} "
            f"on cuda:{device}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


def _scratch(dev: torch.device, buckets: int, n: int) -> list:
    """[tables [2, buckets + 1] int64, index of the zeroed one, id
    scratch of at least n int64]."""
    key = (dev.index, buckets)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = [torch.zeros((2, buckets + 1), dtype=torch.int64, device=dev), 0,
                            None]
    if t[2] is None or t[2].numel() < n:
        t[2] = torch.empty((max(n, 1),), dtype=torch.int64, device=dev)
    return t


_I64, _I32, _BOOL = torch.int64, torch.int32, torch.bool


def sketch_update_fused(hll, cms, *, tk_shape, gid, reg, rho, mask, id_a, id_b,
                        s_pos, s_win, head, rw, s_hi, s_lo):
    """hll [R, G, m] / cms [R, D, W] int32 updated in place over one
    phase. Batch-order lanes [N_rows]: gid/reg/rho and the u32 lanes
    id_a/id_b int64, mask bool. Sorted lanes [N]: s_pos int64 (sorted
    position → batch row), the u32 lanes s_win/s_hi/s_lo int64, head
    bool (run heads), rw int32 (each row's run weight under `mask`).
    `tk_shape` is (topk_rows, topk_cols). Returns (hll, cms,
    challengers).

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if hll.device.type == "cpu":
        return sketch_update_fused_plain(
            hll, cms, tk_shape=tk_shape, gid=gid, reg=reg, rho=rho, mask=mask, id_a=id_a,
            id_b=id_b, s_pos=s_pos, s_win=s_win, head=head, rw=rw, s_hi=s_hi, s_lo=s_lo)
    if hll.device.type != "cuda":
        raise ValueError(f"no sketch kernel for device {hll.device}")
    dev = hll.device
    idx = hll.get_device()
    ring, g, m = hll.shape
    _, d_cms, w_cms = cms.shape
    d_tk, c_tk = tk_shape
    n_rows, n = gid.shape[0], s_pos.shape[0]
    if d_tk < 1:
        raise ValueError("the fused sketch update needs the top-K lane (topk_rows ≥ 1)")
    buckets = d_tk * ring * c_tk
    if max(n, n_rows, hll.numel(), cms.numel(), 5 * buckets) >= 2 ** 31:
        raise ValueError("sketch plane sizes exceed the kernel's int32 indexing")
    _require(hll, "hll", _I32, idx, (ring, g, m))
    _require(cms, "cms", _I32, idx, (ring, d_cms, w_cms))
    rows, srt = (n_rows,), (n,)
    for t, name, dtype, shape in (
            (gid, "gid", _I64, rows), (reg, "reg", _I64, rows), (rho, "rho", _I64, rows),
            (mask, "mask", _BOOL, rows), (id_a, "id_a", _I64, rows),
            (id_b, "id_b", _I64, rows), (s_pos, "s_pos", _I64, srt),
            (s_win, "s_win", _I64, srt), (head, "head", _BOOL, srt), (rw, "rw", _I32, srt),
            (s_hi, "s_hi", _I64, srt), (s_lo, "s_lo", _I64, srt)):
        _require(t, name, dtype, idx, shape)

    # one buffer: got (bool, padded to 16 bytes), then [d, 5, R·C] int32
    # lanes (hi, lo, ia, ib, hw per hash row)
    got_bytes = (buckets + 15) & ~15
    out = torch.empty((got_bytes + 20 * buckets,), dtype=torch.uint8, device=dev)
    got, lanes = out[:buckets].view(_BOOL), out[got_bytes:].view(_I32)
    lib = _lib()
    scratch = _scratch(dev, buckets, n)
    tables, zeroed, ids = scratch
    base = tables.data_ptr()
    code = lib.sketch_fused_launch(
        gid.data_ptr(), reg.data_ptr(), rho.data_ptr(), mask.data_ptr(), id_a.data_ptr(),
        id_b.data_ptr(), s_pos.data_ptr(), s_win.data_ptr(), head.data_ptr(),
        rw.data_ptr(), s_hi.data_ptr(), s_lo.data_ptr(), hll.data_ptr(), cms.data_ptr(),
        base + 8 * (buckets + 1) * zeroed, base + 8 * (buckets + 1) * (1 - zeroed),
        ids.data_ptr(), got.data_ptr(),
        lanes.data_ptr(), n, ring, g, m, d_cms, w_cms, d_tk, c_tk,
        torch._C._cuda_getCurrentRawStream(idx),  # the current stream's handle
    )
    check_launch(lib, code, "sketch_fused")
    scratch[1] = 1 - zeroed
    LAUNCHES["sketch_fused"] += 1
    gots = got.view(d_tk, -1).unbind(0)
    per_row = lanes.view(5 * d_tk, -1).unbind(0)
    challengers = [(gots[r], *per_row[5 * r:5 * r + 5]) for r in range(d_tk)]
    return hll, cms, challengers
