"""The yardstick's fixed numbers: the card's published peaks and the
logical work of each kernel operation, counted from a call's shapes and
the live rows its inputs hold.

Bytes are counted as the operation needs them — each input byte read
once, each output byte written once — whatever an implementation reads
again; where the work depends on the data, the count is of the rows and
segments these inputs hold, not of the padded shapes.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def segreduce_bytes(n_live: int, m: int, cap: int, live_segments: int,
                    gather: bool = True) -> int:
    """A sorted segment sum + max over `n_live` live rows of `m` float32
    meters into `cap` segments, `live_segments` of them live: each live
    row read once with its segment id (and its permutation entry when
    the rows are read through the sort's permutation), the segment heads
    once, and each live segment's sums and maxima written once."""
    return n_live * (4 * m + 4 + (4 if gather else 0)) + 4 * cap + 2 * 4 * live_segments * m


def segreduce_flops(n_live: int, m: int) -> int:
    """One add and one max per live row and meter."""
    return 2 * n_live * m


def sketch_fused_bytes(live_rows: int, ring: int, topk_rows: int, topk_cols: int,
                       hll_cells: int, cms_cells: int) -> int:
    """The fused sketch update of one phase: each live row's lanes read
    once (sort position, window, group, register, rho, run weight, key hi
    and lo at 4 bytes; mask and head flags at 1), each HLL register and
    count-min counter the live rows touch read and written once, and the
    per-bucket challenger tables (a flag and five int32 lanes) written
    once."""
    return (live_rows * (4 * 8 + 2) + 8 * (hll_cells + cms_cells)
            + topk_rows * ring * topk_cols * (1 + 5 * 4))


def least_seconds(nbytes: int, flops: int = 0) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)
