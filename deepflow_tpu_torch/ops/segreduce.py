"""Sorted segmented SUM + MAX — the port of deepflow_tpu/ops/segreduce_pallas.py.

`sorted_segment_sum_max` keeps the reference's contract: per-segment sum
and max of `rows` (or of `rows[perm]`), grouped by an ascending
`seg_id`, with `first_pos` the searchsorted-left head of every output
segment. On a CUDA tensor it launches the hand-written kernel of
kernels/segreduce.cu; on a CPU tensor it runs the plain PyTorch version
beside it (`sorted_segment_sum_max_plain`), which is also the kernel's
parity reference on the card. Nothing falls back: a CUDA call either
launches the kernel or raises.

The fused-gather launcher reads rows through `perm`; the pre-gathered
launcher (selected upstream by DEEPFLOW_FUSED_GATHER=0, ops/segment.py)
takes rows already in sorted order. `LAUNCHES` counts every kernel
launch per launcher.

CONTRACT (as in the reference): rows of ABSENT segments hold garbage —
callers mask them by their live-segment prefix; m > 128 raises.
"""

from __future__ import annotations

import ctypes

import torch

LANES = 128  # widest meter row the kernel takes (one thread per column)

#: kernel launches per launcher since the last reset
LAUNCHES = {"segreduce_gather": 0, "segreduce_sorted": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_width(m: int) -> None:
    if m > LANES:
        raise ValueError(
            f"meter payload has {m} lanes but the segmented-reduce kernel "
            f"takes at most {LANES} columns (one thread per lane); widen "
            f"the kernel before growing a meter schema past {LANES} columns"
        )


def sorted_segment_sum_max_plain(rows, seg_id, num_segments: int, first_pos=None,
                                 *, perm=None):
    """Plain PyTorch version: index_add_ for the sums, scatter_reduce
    ("amax", include_self=False) for the maxs. Rows with seg_id ≥
    num_segments land in a scratch row that is dropped. `first_pos` is
    accepted for signature parity and unused."""
    n, m = rows.shape
    _check_width(m)
    cap = int(num_segments)
    x = rows if perm is None else rows.index_select(0, perm.long())
    ids = seg_id.long().clamp(max=cap)
    sums = torch.zeros((cap + 1, m), dtype=rows.dtype, device=rows.device)
    sums.index_add_(0, ids, x)
    maxs = torch.full((cap + 1, m), float("-inf"), dtype=rows.dtype,
                      device=rows.device)
    maxs.scatter_reduce_(0, ids[:, None].expand(-1, m), x, "amax",
                         include_self=False)
    return sums[:cap], maxs[:cap]


_I32 = torch.int32
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    from ..kernels.build import load

    lib = load("segreduce")
    if not getattr(lib, "_df_bound", False):
        lib.segreduce_gather_launch.argtypes = [_PTR] * 6 + [_INT] * 3 + [_PTR]
        lib.segreduce_gather_launch.restype = _INT
        lib.segreduce_sorted_launch.argtypes = [_PTR] * 5 + [_INT] * 3 + [_PTR]
        lib.segreduce_sorted_launch.restype = _INT
        lib._df_bound = True
    return lib


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def sorted_segment_sum_max(rows, seg_id, num_segments: int, first_pos, *,
                           perm=None):
    """Segment sum AND max of `rows` [N_rows, M] f32 grouped by the
    ascending int32 `seg_id` [N] (dead rows carry an id ≥ num_segments
    or sort last). `first_pos` [num_segments] int32 are the
    searchsorted-left heads. With int32 `perm` [N], row i of the
    reduction is rows[perm[i]] (rows in original order); without it,
    rows are already sorted (N_rows == N). Returns (sums, maxs), both
    [num_segments, M] f32 — absent segments hold garbage.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (row-contiguous rows required: pass `.t().contiguous()` for a
    column-major meter plane, never a transposed view)."""
    n_rows, m = rows.shape
    _check_width(m)
    if rows.device.type == "cpu":
        return sorted_segment_sum_max_plain(rows, seg_id, num_segments,
                                            first_pos, perm=perm)
    if rows.device.type != "cuda":
        raise ValueError(f"no segmented-reduce kernel for device {rows.device}")
    dev = rows.device
    cap = int(num_segments)
    n = int(seg_id.shape[0])
    _require(rows, "rows", torch.float32, dev)
    _require(seg_id, "seg_id", _I32, dev)
    _require(first_pos, "first_pos", _I32, dev)
    if first_pos.shape[0] != cap:
        raise ValueError(f"first_pos has {first_pos.shape[0]} entries, want {cap}")
    if perm is None and n_rows != n:
        raise ValueError(f"sorted rows ({n_rows}) and seg_id ({n}) differ in length")
    if max(n, n_rows, cap) >= 2**31:
        raise ValueError("segmented reduce sizes exceed the kernel's int32 indexing")
    sums = torch.empty((cap, m), dtype=torch.float32, device=dev)
    maxs = torch.empty((cap, m), dtype=torch.float32, device=dev)
    if cap == 0 or m == 0:
        return sums, maxs
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if perm is None:
        code = lib.segreduce_sorted_launch(
            rows.data_ptr(), seg_id.data_ptr(), first_pos.data_ptr(),
            sums.data_ptr(), maxs.data_ptr(), n, m, cap, stream,
        )
        name = "segreduce_sorted"
    else:
        _require(perm, "perm", _I32, dev)
        if perm.shape[0] != n:
            raise ValueError(f"perm has {perm.shape[0]} entries, seg_id {n}")
        code = lib.segreduce_gather_launch(
            rows.data_ptr(), perm.data_ptr(), seg_id.data_ptr(),
            first_pos.data_ptr(), sums.data_ptr(), maxs.data_ptr(),
            n, m, cap, stream,
        )
        name = "segreduce_gather"
    from ..kernels.build import check_launch

    check_launch(lib, code, name)
    LAUNCHES[name] += 1
    return sums, maxs
