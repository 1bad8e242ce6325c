"""Per-window sketch plane, slab mode (port of
deepflow_tpu/aggregator/sketchplane.py).

For every open window the plane keeps a fixed-size approximate summary
on the device — HLL registers (distinct clients per service group), a
count-min plane (per-flow bytes), a log-binned latency histogram and an
invertible top-K sketch — updated in the same step as the exact append,
so a stash that sheds loses detail, never coverage.

Ring semantics. Open windows span at most R = delay//interval + 2
consecutive indices, so an [R]-slot ring indexed by `window % R` holds
them without aliasing. One step folds the batch's closing-span rows,
closes every slot with win < close_w into a flat PENDING buffer of
packed block rows, then folds the new-span rows into the freed slots.
The host drains pending at each window advance inside the flush drain's
two fetches. Rows of a batch that spans more than R windows below its
close bound cannot each get a slot: they are counted in `shed`
(CB_SKETCH_SHED), never merged into a neighbour.

Differences from the reference, none visible in any output:
  * the planes update IN PLACE; `sketch_drain` hands out clones of the
    pending buffers, so a later close never overwrites rows the host has
    not fetched;
  * the close runs on masks (no `lax.cond`, no host sync): the pending
    buffer carries one scratch row at index P where non-closing and
    overflowing ring slots land;
  * lane dtypes: hll/cms/hist/tk_votes int32, the tk key/id lanes and
    `pend` int32 bit patterns of u32 values, win/count/pend_win and the
    rows/shed/pend_n scalars int64 u32 lanes (ops/u32.py);
  * top-K always rides the one shared (window, key_hi, key_lo) sort; the
    HLL + count-min + challenger scan of that path is
    ops/sketch_fused.sketch_update_fused (the CUDA kernel on the card).
    With top-K off there is no sort and no kernel: per-row scatters.

Not ported: pool mode (PoolConfig, the compact/wide arenas, promotion),
open-window snapshots, the cascade's tier merges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cms import cms_query_np
from ..ops.histogram import LogHistSpec, loghist_bin, saturate_i32
from ..ops.hll import clz32, hll_estimate_np
from ..ops.segment import sort_perm
from ..ops.sketch_fused import hll_cms_scatter, sketch_update_fused
from ..ops.tdigest import tdigest_compress, tdigest_quantile
from ..ops.topk import _apply_challengers, topk_select
from ..ops.u32 import MASK, U32_MAX, to_i32_bits

SENTINEL_WIN = U32_MAX


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Shapes of the per-window plane (the reference's fields and
    defaults). `pool` is the reference's pooled sketch memory, not
    ported: setting it raises."""

    num_groups: int = 16  # service rows (HLL + histogram group axis)
    hll_precision: int = 12
    cms_depth: int = 4
    cms_width: int = 1 << 12
    hist: LogHistSpec = LogHistSpec(bins=256, vmin=1.0, gamma=1.04)
    topk_rows: int = 2  # 0 disables the top-K lane
    topk_cols: int = 1 << 9
    pending: int = 16  # closed-block rows buffered between host drains
    pool: object | None = None

    def __post_init__(self):
        if self.cms_width & (self.cms_width - 1):
            raise ValueError("cms_width must be a power of two")
        if self.topk_rows and self.topk_cols & (self.topk_cols - 1):
            raise ValueError("topk_cols must be a power of two")
        if self.pool is not None:
            raise NotImplementedError(
                "SketchConfig(pool=...) — pooled sketch memory is not ported "
                "to deepflow_tpu_torch yet; use the slab plane (pool=None)"
            )

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_precision

    @property
    def block_width(self) -> int:
        """u32 words per packed closed-window block row: the n_updates
        word, then hll / cms / hist / 5 top-K lanes, flattened in that
        order (the reference's layout contract)."""
        g = self.num_groups
        return (1 + g * self.hll_m + self.cms_depth * self.cms_width
                + g * self.hist.bins + 5 * self.topk_rows * self.topk_cols)


@dataclasses.dataclass
class SketchState:
    """Device-resident plane: the open ring win[R] (SENTINEL_WIN =
    empty) with per-slot planes, then the pending buffer of packed closed
    blocks ([P + 1] rows, the last a scratch row) and the cumulative
    counter-block lanes."""

    win: torch.Tensor  # [R] u32 lane
    count: torch.Tensor  # [R] u32 rows folded per open slot
    hll: torch.Tensor  # [R, G, m] int32
    cms: torch.Tensor  # [R, D, W] int32
    hist: torch.Tensor  # [R, G, B] int32
    tk_votes: torch.Tensor  # [R, d, C] int32
    tk_hi: torch.Tensor  # [R, d, C] int32 bits of u32
    tk_lo: torch.Tensor
    tk_ida: torch.Tensor
    tk_idb: torch.Tensor
    pend: torch.Tensor  # [P + 1, WIDE] int32 bits of the packed block rows
    pend_win: torch.Tensor  # [P + 1] u32 lane
    pend_n: torch.Tensor  # 0-dim int64
    rows: torch.Tensor  # 0-dim u32 — CB_SKETCH_ROWS source
    shed: torch.Tensor  # 0-dim u32 — CB_SKETCH_SHED source

    @property
    def ring(self) -> int:
        return self.win.shape[0]

    @property
    def pending(self) -> int:
        return self.pend.shape[0] - 1


TOPK_LANES = ("tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb")
PLANES = ("hll", "cms", "hist") + TOPK_LANES


def sketch_init(cfg: SketchConfig, ring: int, *, device=None) -> SketchState:
    dev = resolve_device(device)
    g, m = cfg.num_groups, cfg.hll_m
    tk = (ring, cfg.topk_rows, cfg.topk_cols)

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    i64 = torch.int64
    return SketchState(
        win=torch.full((ring,), SENTINEL_WIN, dtype=i64, device=dev),
        count=z((ring,), i64),
        hll=z((ring, g, m)),
        cms=z((ring, cfg.cms_depth, cfg.cms_width)),
        hist=z((ring, g, cfg.hist.bins)),
        tk_votes=z(tk), tk_hi=z(tk), tk_lo=z(tk), tk_ida=z(tk), tk_idb=z(tk),
        pend=z((cfg.pending + 1, cfg.block_width)),
        pend_win=torch.full((cfg.pending + 1,), SENTINEL_WIN, dtype=i64, device=dev),
        pend_n=z((), i64), rows=z((), i64), shed=z((), i64),
    )


def _flatten_open(sk: SketchState) -> torch.Tensor:
    """[R, WIDE] int32 packed block rows of the open ring (layout per
    SketchConfig.block_width)."""
    r = sk.ring
    return torch.cat([to_i32_bits(sk.count)[:, None]]
                     + [getattr(sk, k).reshape(r, -1) for k in PLANES], dim=1)


def sketch_close(sk: SketchState, close_w) -> SketchState:
    """Move every open slot with win < close_w into the pending buffer
    and reset it (in place). Pending overflow drops the block and counts
    its rows into `shed`. Masks only: slots that do not close are copied
    to the scratch row P."""
    r, p = sk.ring, sk.pending
    close = (sk.win != SENTINEL_WIN) & (sk.win < close_w)
    closing = close.long()
    pos = sk.pend_n + torch.cumsum(closing, 0) - 1
    pos = torch.where(close, pos, p)
    overflow = close & (pos >= p)
    pos = pos.clamp(max=p)
    sk.pend.index_copy_(0, pos, _flatten_open(sk))
    sk.pend_win.index_copy_(0, pos, sk.win)
    sk.shed = (sk.shed + torch.where(overflow, sk.count, 0).sum()) & MASK
    sk.pend_n = torch.clamp(sk.pend_n + closing.sum(), max=p)
    sk.win.masked_fill_(close, SENTINEL_WIN)
    sk.count.masked_fill_(close, 0)
    for k in PLANES:
        getattr(sk, k).masked_fill_(close.view(r, 1, 1), 0)
    return sk


def shared_sort(window, key_hi, key_lo):
    """THE batch sort: stable over (window, key_hi, key_lo) with the row
    position as payload; phase masks ride through it. Returns (s_win,
    s_hi, s_lo, s_pos, head, run_id) — run = one (window, key)."""
    s_pos = sort_perm(window, key_hi, key_lo)
    s_win, s_hi, s_lo = window[s_pos], key_hi[s_pos], key_lo[s_pos]
    head = torch.ones(s_pos.shape, dtype=torch.bool, device=s_pos.device)
    head[1:] = ((s_win[1:] != s_win[:-1]) | (s_hi[1:] != s_hi[:-1])
                | (s_lo[1:] != s_lo[:-1]))
    return s_win, s_hi, s_lo, s_pos, head, torch.cumsum(head, 0) - 1


def _row_lanes(sk: SketchState, mask, window, group, client_hi, client_lo, weight):
    """Per-row (slot, gid, HLL register, rho, masked int32 weight)."""
    m = sk.hll.shape[2]
    w = torch.where(mask, saturate_i32(weight), 0)
    return window % sk.ring, group % sk.hll.shape[1], client_lo & (m - 1), \
        clz32(client_hi) + 1, w


def _sorted_operands(sk, mask, gid, reg, rho, w, id_a, id_b, presorted) -> dict:
    """`sketch_update_fused` keywords for one phase over the shared sort:
    the batch-order lanes, read through `s_pos` by the callee, and the
    sorted lanes. Each row's run weight sums its (window, key) run under
    THIS phase's mask with int32 adds that wrap like XLA's segment_sum;
    the sums are complete before the callee's first atomic."""
    s_win, s_hi, s_lo, s_pos, head, run_id = presorted
    run_w = torch.zeros(s_pos.shape[0], dtype=torch.int32, device=w.device)
    run_w.index_add_(0, run_id, w[s_pos])
    return dict(
        tk_shape=tuple(sk.tk_votes.shape[1:]), gid=gid, reg=reg, rho=rho, mask=mask,
        id_a=id_a, id_b=id_b, s_pos=s_pos, s_win=s_win, head=head, rw=run_w[run_id],
        s_hi=s_hi, s_lo=s_lo,
    )


def fused_operands(sk: SketchState, mask, *, window, group, client_hi, client_lo,
                   weight, id_a, id_b, presorted, **_) -> dict:
    """The `sketch_update_fused` keywords one phase of `sketch_plane_step`
    passes for `mask` (extra plane-input keywords are ignored)."""
    _, gid, reg, rho, w = _row_lanes(sk, mask, window, group, client_hi, client_lo,
                                     weight)
    return _sorted_operands(sk, mask, gid, reg, rho, w, id_a, id_b, presorted)


def _scatter_rows(sk: SketchState, spec: LogHistSpec, mask, window, group,
                  client_hi, client_lo, key_hi, key_lo, weight, rtt, rtt_valid,
                  id_a, id_b, presorted=None) -> SketchState:
    """Fold one phase's rows into their ring slots (claiming empties),
    in place. The phase's window span is < R wide, so slots never
    collide. With `presorted` (the batch's shared sort), count-min and
    top-K consume run weights in sorted order through
    `sketch_update_fused`; HLL rides the same call (max is order-free).
    Masked rows fold a no-op value into a valid cell instead of an
    out-of-range index."""
    g, bins = sk.hist.shape[1], sk.hist.shape[2]
    slot, gid, reg, rho, w = _row_lanes(sk, mask, window, group, client_hi, client_lo,
                                        weight)
    sk.win.scatter_reduce_(0, slot, torch.where(mask, window, SENTINEL_WIN), "amin")
    sk.count = (sk.count.index_add(0, slot, mask.long())) & MASK
    b = loghist_bin(rtt, spec).long()
    sk.hist.view(-1).index_add_(0, (slot * g + gid) * bins + b,
                                (mask & rtt_valid).to(torch.int32))

    if presorted is None:
        # top-K off: per-row HLL max and count-min adds, no sort, no kernel
        hll_cms_scatter(sk.hll, sk.cms, slot, gid, reg, rho, mask, key_hi, key_lo, w)
        return sk

    _, _, challengers = sketch_update_fused(
        sk.hll, sk.cms, **_sorted_operands(sk, mask, gid, reg, rho, w, id_a, id_b,
                                           presorted))
    lanes = _apply_challengers(tuple(getattr(sk, k) for k in TOPK_LANES), challengers)
    for k, v in zip(TOPK_LANES, lanes):
        setattr(sk, k, v)
    return sk


def scalar_tensor(x) -> torch.Tensor:
    """A host int as a 0-dim int64 CPU tensor (operand of device ops
    without an upload); a tensor passes through."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(int(x), dtype=torch.int64)


def phase_masks(sk: SketchState, *, window, valid, base_w, close_w):
    """(in_a, in_c, shed): the closing-span rows, the new-span rows and
    the mid-gap rows a batch cannot seat — see `sketch_plane_step`."""
    base_w, close_w = scalar_tensor(base_w), scalar_tensor(close_w)
    anchor = torch.minimum(sk.win.min(), base_w)
    past = (anchor + sk.ring) & MASK
    in_a = valid & (window >= base_w) & (window < torch.minimum(close_w, past))
    in_c = valid & (window >= torch.maximum(close_w, base_w))
    shed = valid & (window >= torch.maximum(past, base_w)) & (window < close_w)
    return in_a, in_c, shed


def sketch_plane_step(sk: SketchState, spec: LogHistSpec, *, window, valid, base_w,
                      close_w, group, client_hi, client_lo, key_hi, key_lo, weight,
                      rtt, rtt_valid, id_a, id_b) -> SketchState:
    """One batch through the plane, in window order (in place):

      1. closing-span rows (base_w ≤ window < close_w, inside the live
         ring span) fold into their still-open slots;
      2. every slot with win < close_w closes into the pending buffer;
      3. new-span rows (window ≥ close_w) claim the freed slots.

    `base_w`/`close_w` are the pre-/post-batch open-span starts (0-dim
    tensors or host ints). The closing phase's alias-free span is
    anchored at the oldest live ring slot; rows in the mid-gap
    [anchor + R, close_w) are counted into `shed`. u32 lanes are int64
    tensors; `weight`/`rtt` are float32."""
    in_a, in_c, shed = phase_masks(sk, window=window, valid=valid, base_w=base_w,
                                   close_w=close_w)
    presorted = shared_sort(window, key_hi, key_lo) if sk.tk_votes.shape[1] else None

    args = (group, client_hi, client_lo, key_hi, key_lo, weight, rtt, rtt_valid,
            id_a, id_b)
    sk = _scatter_rows(sk, spec, in_a, window, *args, presorted=presorted)
    sk = sketch_close(sk, close_w)
    sk = _scatter_rows(sk, spec, in_c, window, *args, presorted=presorted)
    sk.rows = (sk.rows + in_a.sum() + in_c.sum()) & MASK
    sk.shed = (sk.shed + shed.sum()) & MASK
    return sk


def sketch_drain(sk: SketchState, close_w):
    """Close every slot with win < close_w, then hand out the pending
    buffer: returns (sk, pend [P + 1, WIDE] int32, pend_win [P + 1],
    pend_n 0-dim) with the two buffers CLONED — the plane keeps writing
    its own on later closes — and the pending cursor reset."""
    sk = sketch_close(sk, close_w)
    pend, pend_win, n = sk.pend.clone(), sk.pend_win.clone(), sk.pend_n
    sk.pend_n = torch.zeros_like(n)
    return sk, pend, pend_win, n


# ---------------------------------------------------------------------------
# host side


@dataclasses.dataclass
class WindowSketchBlock:
    """One closed window's fetched sketch summary (host numpy): the
    reference's fields, queries and cross-shard merge. Top-K lanes are
    flat candidate arrays (bucket layout is irrelevant once closed)."""

    window: int
    config: SketchConfig
    n_updates: int
    hll: np.ndarray  # [G, m] i32
    cms: np.ndarray  # [D, W] i64 (i64: shard merges must not wrap)
    hist: np.ndarray  # [G, B] i64
    tk_hi: np.ndarray  # [n_cand] u32
    tk_lo: np.ndarray
    tk_ida: np.ndarray
    tk_idb: np.ndarray
    tk_votes: np.ndarray  # [n_cand] i64

    @classmethod
    def from_row(cls, row: np.ndarray, window: int, cfg: SketchConfig):
        """Unpack one [WIDE] u32 packed block row."""
        g, m = cfg.num_groups, cfg.hll_m
        d, w = cfg.cms_depth, cfg.cms_width
        tk = cfg.topk_rows * cfg.topk_cols
        o = 0

        def take(n):
            nonlocal o
            out = row[o:o + n]
            o += n
            return out

        n_updates = int(take(1)[0])
        hll = take(g * m).astype(np.int32).reshape(g, m)
        cms = take(d * w).astype(np.int64).reshape(d, w)
        hist = take(g * cfg.hist.bins).astype(np.int64).reshape(g, cfg.hist.bins)
        votes = take(tk).astype(np.int32).astype(np.int64)
        hi, lo, ida, idb = (take(tk) for _ in range(4))
        keep = votes > 0
        return cls(
            window=int(window), config=cfg, n_updates=n_updates, hll=hll, cms=cms,
            hist=hist, tk_hi=hi[keep].astype(np.uint32), tk_lo=lo[keep].astype(np.uint32),
            tk_ida=ida[keep].astype(np.uint32), tk_idb=idb[keep].astype(np.uint32),
            tk_votes=votes[keep],
        )

    def merge(self, other: "WindowSketchBlock") -> "WindowSketchBlock":
        """Combine two blocks of the same window: register max, counter
        add, candidate union."""
        if other.window != self.window:
            raise ValueError(f"merging window {other.window} into {self.window}")

        def cat(lane):
            return np.concatenate([getattr(self, lane), getattr(other, lane)])

        return WindowSketchBlock(
            window=self.window, config=self.config,
            n_updates=self.n_updates + other.n_updates,
            hll=np.maximum(self.hll, other.hll), cms=self.cms + other.cms,
            hist=self.hist + other.hist, tk_hi=cat("tk_hi"), tk_lo=cat("tk_lo"),
            tk_ida=cat("tk_ida"), tk_idb=cat("tk_idb"), tk_votes=cat("tk_votes"),
        )

    def distinct(self, group: int | None = None) -> float:
        """HLL distinct-client estimate of one group, or of the whole
        window (register-max union over groups)."""
        if group is None:
            return float(hll_estimate_np(self.hll.max(axis=0, keepdims=True))[0])
        return float(hll_estimate_np(self.hll[group:group + 1])[0])

    def distinct_per_group(self) -> np.ndarray:
        return hll_estimate_np(self.hll)

    def estimate(self, key_hi, key_lo) -> np.ndarray:
        """Count-min point estimates (overestimate-only) for flow keys."""
        return cms_query_np(self.cms, key_hi, key_lo)

    def tdigest(self, group: int | None = None, compression: int = 64):
        """(means, weights) centroid export of the latency histogram."""
        hist = self.hist.sum(axis=0) if group is None else self.hist[group]
        spec = self.config.hist
        centers = spec.vmin * np.power(spec.gamma, np.arange(spec.bins, dtype=np.float64) + 0.5)
        return tdigest_compress(centers.astype(np.float32), hist.astype(np.float32),
                                compression=compression)

    def quantile(self, q: float, group: int | None = None) -> float:
        """Latency quantile through the t-digest export path."""
        m, w = self.tdigest(group)
        return float(tdigest_quantile(m, w, np.asarray([q], np.float32))[0])

    def topk(self, k: int) -> list[dict]:
        """Invert the heavy-hitter sketch: candidates from the bucket
        lanes, ranked by the same window's count-min estimate."""
        if len(self.tk_hi) == 0:
            return []
        est = self.estimate(self.tk_hi, self.tk_lo)
        hi, lo, ida, idb, est_k = topk_select(self.tk_hi, self.tk_lo, self.tk_ida,
                                              self.tk_idb, est, k)
        return [{"key_hi": int(hi[i]), "key_lo": int(lo[i]), "id_a": int(ida[i]),
                 "id_b": int(idb[i]), "estimate": int(est_k[i])}
                for i in range(len(hi))]


def hold_blocks(held: list, new_blocks, cap: int) -> int:
    """Closed-block retention: append, then drop the oldest beyond `cap`.
    Returns the number dropped (callers count it)."""
    held.extend(new_blocks)
    overflow = len(held) - cap
    if overflow > 0:
        del held[:overflow]
        return overflow
    return 0


def unpack_drained(rows: np.ndarray, wins: np.ndarray, cfg: SketchConfig):
    """Fetched [n, WIDE] u32 block rows + [n] window ids →
    WindowSketchBlocks; blocks that never saw a row are dropped."""
    out = []
    for i in range(rows.shape[0]):
        blk = WindowSketchBlock.from_row(rows[i], int(wins[i]), cfg)
        if blk.n_updates or len(blk.tk_hi):
            out.append(blk)
    return out
