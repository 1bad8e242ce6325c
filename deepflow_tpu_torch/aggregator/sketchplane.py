"""Per-window sketch plane (port of deepflow_tpu/aggregator/sketchplane.py).

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

Pool mode (`SketchConfig(pool=PoolConfig(...))`). In place of one
full-width slab per ring slot, the plane draws from a shared arena:
`compact_slots` narrow slots (int8 HLL registers, count-min, histogram
and top-K at widths divided by the pool's factors) and `wide_slots`
full-width ones. A window opens compact (`_pool_alloc`); once the fill
of count-min row 0 of its slot reaches `promote_fill`, the step
promotes it to a free wide slot (`_maybe_promote`). A closing compact
slot packs a narrow block row into the pending buffer; a closing wide
slot is only marked and drains in place. Windows the pool cannot seat
lose sketch coverage, counted in `pool_spill`. As in the reference, the
pooled arenas take plain scatters: pool mode launches no fused kernel.

Differences from the reference, none visible in any output:
  * the planes update IN PLACE; `sketch_drain` hands out clones of the
    pending buffers, so a later close never overwrites rows the host has
    not fetched;
  * the close and the promotion run on masks (no `lax.cond`, no host
    sync): the pending buffer carries one scratch row at index P where
    non-closing and overflowing ring slots land, and a promotion writes
    its one slot with `torch.where(do, new, old)`;
  * lane dtypes: hll/cms/hist/tk_votes int32, the tk key/id lanes and
    `pend` int32 bit patterns of u32 values, win/count/pend_win and the
    rows/shed/pend_n scalars int64 u32 lanes (ops/u32.py); in pool mode
    `slot_of` is int64, `p_hll` int8 (folded in int32 and narrowed), the
    compact top-K key/id lanes int32 bits, wide_close/wide_count and the
    pool_spill/pool_promos scalars int64 u32 lanes;
  * with top-K on, the plane takes the one shared (window, key_hi,
    key_lo) sort by default; the HLL + count-min + challenger scan of
    that path is ops/sketch_fused.sketch_update_fused (the CUDA kernel
    on the card). DEEPFLOW_SHARED_SORT=0 (read at every step) selects
    the reference's multi-sort oracle instead: per-row HLL and count-min
    scatters and `ops/topk.topk_update` — one fresh sort per top-K hash
    row and phase, no fused kernel — with the same blocks. With top-K
    off there is no sort and no kernel: per-row scatters.

The live read plane reads the open slots without closing them
(`_flatten_open_snapshot`): slab mode packs the ring like a close, pool
mode packs each ring slot's compact part ‖ wide part, and the part with
a nonzero count word is the live one (`unpack_drained`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cms import cms_expand, cms_query_np, row_slots
from ..ops.histogram import (
    LogHistSpec,
    loghist_bin,
    loghist_coarsen_bin,
    loghist_expand,
    saturate_i32,
)
from ..ops.hll import clz32, hll_estimate_np, hll_pack_registers, hll_unpack_registers_np
from ..ops.segment import _use_shared_sort, active_sort_tally, sort_perm
from ..ops.sketch_fused import hll_cms_scatter, sketch_update_fused
from ..ops.tdigest import tdigest_compress, tdigest_quantile
from ..ops.topk import (
    _apply_challengers,
    topk_challengers_presorted,
    topk_select,
    topk_tile,
    topk_update,
)
from ..ops.u32 import MASK, U32_MAX, to_i32_bits

SENTINEL_WIN = U32_MAX


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Pooled sketch memory: `compact_slots` narrow slots (full-m int8
    HLL registers; count-min width / `cms_factor`, top-K cols /
    `topk_factor`, histogram bins / `hist_factor`) plus `wide_slots`
    full-width ones; a window promotes compact → wide when the fill of
    its count-min row 0 reaches `promote_fill` (the reference's fields
    and defaults)."""

    compact_slots: int = 3
    wide_slots: int = 1
    cms_factor: int = 8
    topk_factor: int = 4
    hist_factor: int = 8
    promote_fill: float = 0.5

    def meta(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, m: dict) -> "PoolConfig":
        return cls(**m)


def _check_pool(cfg: "SketchConfig") -> None:
    """Every pool geometry that could not hold, or promote into, the
    wide lanes raises here, naming the lane (the reference's checks)."""
    p = cfg.pool
    if p.compact_slots < 1:
        raise ValueError(f"pool compact_slots must be ≥ 1, got {p.compact_slots}")
    if p.wide_slots < 1:
        raise ValueError(f"pool wide_slots={p.wide_slots}: the promotion target arena is "
                         "empty — a saturated compact slot would have no wide slot")
    if cfg.cms_depth < 1:
        raise ValueError("pooled sketch memory requires cms_depth ≥ 1: the promotion "
                         f"reads the fill of CMS row 0 (got cms_depth={cfg.cms_depth})")
    if cfg.hll_m % 4:
        raise ValueError(f"pooled HLL packs 4 int8 registers per u32 word; hll_m="
                         f"{cfg.hll_m} (precision {cfg.hll_precision}) is not divisible by 4")
    if not 0.0 < p.promote_fill <= 1.0:
        raise ValueError(f"pool promote_fill must be in (0, 1], got {p.promote_fill}")
    lanes = [("cms", p.cms_factor, cfg.cms_width), ("hist", p.hist_factor, cfg.hist.bins)]
    if cfg.topk_rows:
        lanes.append(("topk", p.topk_factor, cfg.topk_cols))
    for lane, factor, width in lanes:
        if factor < 1 or factor & (factor - 1):
            raise ValueError(f"pool {lane}_factor must be a power of two ≥ 1, got {factor}")
        if width % factor or width // factor < 1:
            raise ValueError(
                f"pool geometry cannot promote the {lane} lane: factor {factor} does not "
                f"divide the wide width {width} into a non-empty compact lane (compact "
                f"width would be {width // factor})")


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """Shapes of the per-window plane (the reference's fields and
    defaults); `pool` None is the slab plane."""

    num_groups: int = 16  # service rows (HLL + histogram group axis)
    hll_precision: int = 12
    cms_depth: int = 4
    cms_width: int = 1 << 12
    hist: LogHistSpec = LogHistSpec(bins=256, vmin=1.0, gamma=1.04)
    topk_rows: int = 2  # 0 disables the top-K lane
    topk_cols: int = 1 << 9
    pending: int = 16  # closed-block rows buffered between host drains
    pool: PoolConfig | None = None

    def __post_init__(self):
        if self.cms_width & (self.cms_width - 1):
            raise ValueError("cms_width must be a power of two")
        if self.topk_rows and self.topk_cols & (self.topk_cols - 1):
            raise ValueError("topk_cols must be a power of two")
        if self.pool is not None:
            if not isinstance(self.pool, PoolConfig):
                raise TypeError(f"SketchConfig.pool takes a PoolConfig, got "
                                f"{type(self.pool).__name__}")
            _check_pool(self)

    @property
    def hll_m(self) -> int:
        return 1 << self.hll_precision

    # pooled compact lane widths (pool mode only)
    @property
    def pool_cms_width(self) -> int:
        return self.cms_width // self.pool.cms_factor

    @property
    def pool_hist_bins(self) -> int:
        return self.hist.bins // self.pool.hist_factor

    @property
    def pool_topk_cols(self) -> int:
        return self.topk_cols // self.pool.topk_factor if self.topk_rows else 0

    @property
    def block_width(self) -> int:
        """u32 words per packed closed-window block row: the n_updates
        word, then hll / cms / hist / 5 top-K lanes, flattened in that
        order (the reference's layout contract)."""
        g = self.num_groups
        return (1 + g * self.hll_m + self.cms_depth * self.cms_width
                + g * self.hist.bins + 5 * self.topk_rows * self.topk_cols)

    @property
    def compact_block_width(self) -> int:
        """u32 words per packed COMPACT block row (pool mode): the same
        lane order at the pooled widths, HLL packed 4 registers a word —
        always narrower than `block_width`, so `unpack_drained` can
        dispatch on the width."""
        g = self.num_groups
        return (1 + g * self.hll_m // 4 + self.cms_depth * self.pool_cms_width
                + g * self.pool_hist_bins + 5 * self.topk_rows * self.pool_topk_cols)

    def meta(self) -> dict:
        """The reference's JSON-able checkpoint form ("pool" since v6)."""
        return {
            "num_groups": self.num_groups, "hll_precision": self.hll_precision,
            "cms_depth": self.cms_depth, "cms_width": self.cms_width,
            "hist_bins": self.hist.bins, "hist_vmin": self.hist.vmin,
            "hist_gamma": self.hist.gamma, "topk_rows": self.topk_rows,
            "topk_cols": self.topk_cols, "pending": self.pending,
            "pool": None if self.pool is None else self.pool.meta(),
        }

    @classmethod
    def from_meta(cls, m: dict) -> "SketchConfig":
        """Inverse of `meta`; meta without a "pool" key is the slab plane."""
        return cls(
            num_groups=m["num_groups"], hll_precision=m["hll_precision"],
            cms_depth=m["cms_depth"], cms_width=m["cms_width"],
            hist=LogHistSpec(bins=m["hist_bins"], vmin=m["hist_vmin"], gamma=m["hist_gamma"]),
            topk_rows=m["topk_rows"], topk_cols=m["topk_cols"], pending=m["pending"],
            pool=PoolConfig.from_meta(m["pool"]) if m.get("pool") else None,
        )


@dataclasses.dataclass
class SketchState:
    """Device-resident plane: the open ring win[R] (SENTINEL_WIN =
    empty) with per-slot planes, then the pending buffer of packed closed
    blocks ([P + 1] rows, the last a scratch row) and the cumulative
    counter-block lanes. The pool fields are zero-size in slab mode; in
    pool mode the hll … tk_idb planes are the WIDE arena ([Pw, …])."""

    win: torch.Tensor  # [R] u32 lane
    count: torch.Tensor  # [R] u32 rows folded per open slot
    hll: torch.Tensor  # [R, G, m] int32 (pool mode: [Pw, G, m])
    cms: torch.Tensor  # [R, D, W] int32
    hist: torch.Tensor  # [R, G, B] int32
    tk_votes: torch.Tensor  # [R, d, C] int32
    tk_hi: torch.Tensor  # [R, d, C] int32 bits of u32
    tk_lo: torch.Tensor
    tk_ida: torch.Tensor
    tk_idb: torch.Tensor
    pend: torch.Tensor  # [P + 1, WIDE] int32 bits ([P + 1, CW] pooled)
    pend_win: torch.Tensor  # [P + 1] u32 lane
    pend_n: torch.Tensor  # 0-dim int64
    rows: torch.Tensor  # 0-dim u32 — CB_SKETCH_ROWS source
    shed: torch.Tensor  # 0-dim u32 — CB_SKETCH_SHED source
    # pooled sketch memory (zero-size in slab mode)
    slot_of: torch.Tensor  # [R] int64 pool slot per ring slot: -1 none,
    #                        0..Pc-1 compact, Pc + j wide slot j
    p_hll: torch.Tensor  # [Pc, G, m] int8
    p_cms: torch.Tensor  # [Pc, D, Wc] int32
    p_hist: torch.Tensor  # [Pc, G, Bc] int32
    p_tkv: torch.Tensor  # [Pc, d, Cc] int32
    p_tkh: torch.Tensor  # [Pc, d, Cc] int32 bits of u32
    p_tkl: torch.Tensor
    p_tia: torch.Tensor
    p_tib: torch.Tensor
    wide_close: torch.Tensor  # [Pw] u32 lane: closed-awaiting-drain window
    wide_count: torch.Tensor  # [Pw] u32 lane: row count at close
    pool_spill: torch.Tensor  # 0-dim u32 — CB_SKETCH_POOL_SPILL source
    pool_promos: torch.Tensor  # 0-dim u32 — CB_SKETCH_PROMOTIONS source
    promote_fill: torch.Tensor  # 0-dim float32 (0 in slab mode)

    @property
    def ring(self) -> int:
        return self.win.shape[0]

    @property
    def pending(self) -> int:
        return self.pend.shape[0] - 1


TOPK_LANES = ("tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb")
PLANES = ("hll", "cms", "hist") + TOPK_LANES
POOL_TOPK_LANES = ("p_tkv", "p_tkh", "p_tkl", "p_tia", "p_tib")
POOL_PLANES = ("p_hll", "p_cms", "p_hist") + POOL_TOPK_LANES


def sketch_init(cfg: SketchConfig, ring: int, *, device=None) -> SketchState:
    dev = resolve_device(device)
    g, m = cfg.num_groups, cfg.hll_m
    pool = cfg.pool
    if pool is None:  # the pool fields keep the reference's zero-size shapes
        pc = pw = 0
        wc, bc, cc = cfg.cms_width, cfg.hist.bins, cfg.topk_cols
        slot_r, arena, pend_w, fill = 0, ring, cfg.block_width, 0.0
    else:
        pc, pw = pool.compact_slots, pool.wide_slots
        wc, bc, cc = cfg.pool_cms_width, cfg.pool_hist_bins, cfg.pool_topk_cols
        slot_r, arena, pend_w, fill = ring, pw, cfg.compact_block_width, pool.promote_fill
    tk = (arena, cfg.topk_rows, cfg.topk_cols)
    ptk = (pc, cfg.topk_rows, cc)

    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def sentinel(n):
        return torch.full((n,), SENTINEL_WIN, dtype=torch.int64, device=dev)

    i64 = torch.int64
    return SketchState(
        win=sentinel(ring), count=z((ring,), i64),
        hll=z((arena, g, m)), cms=z((arena, cfg.cms_depth, cfg.cms_width)),
        hist=z((arena, g, cfg.hist.bins)),
        tk_votes=z(tk), tk_hi=z(tk), tk_lo=z(tk), tk_ida=z(tk), tk_idb=z(tk),
        pend=z((cfg.pending + 1, pend_w)), pend_win=sentinel(cfg.pending + 1),
        pend_n=z((), i64), rows=z((), i64), shed=z((), i64),
        slot_of=torch.full((slot_r,), -1, dtype=i64, device=dev),
        p_hll=z((pc, g, m), torch.int8), p_cms=z((pc, cfg.cms_depth, wc)),
        p_hist=z((pc, g, bc)),
        p_tkv=z(ptk), p_tkh=z(ptk), p_tkl=z(ptk), p_tia=z(ptk), p_tib=z(ptk),
        wide_close=sentinel(pw), wide_count=z((pw,), i64),
        pool_spill=z((), i64), pool_promos=z((), i64),
        promote_fill=torch.tensor(fill, dtype=torch.float32, device=dev),
    )


def _pool_mode(sk: SketchState) -> bool:
    """The pool fields are zero-size iff the plane has no PoolConfig."""
    return sk.slot_of.shape[0] > 0


def _flatten_open(sk: SketchState, counts=None) -> torch.Tensor:
    """[K, WIDE] int32 packed block rows of the full-width planes (layout
    per SketchConfig.block_width): in slab mode the open ring (K = R,
    each slot's count word), in pool mode the wide arena itself (row j =
    wide slot j, with the given `counts` word)."""
    counts = sk.count if counts is None else counts
    k = counts.shape[0]
    return torch.cat([to_i32_bits(counts)[:, None]]
                     + [getattr(sk, p).reshape(k, -1) for p in PLANES], dim=1)


def _flatten_compact(sk: SketchState) -> torch.Tensor:
    """Pool mode: [R, CW] int32 packed compact block rows, layout per
    SketchConfig.compact_block_width: each ring slot gathers its compact
    arena slot through `slot_of`; slots without one come back all-zero."""
    r, pc = sk.ring, sk.p_hll.shape[0]
    isc = (sk.slot_of >= 0) & (sk.slot_of < pc)
    cp = sk.slot_of.clamp(0, pc - 1)
    row = torch.cat(
        [to_i32_bits(torch.where(isc, sk.count, 0))[:, None],
         to_i32_bits(hll_pack_registers(sk.p_hll[cp])).reshape(r, -1)]
        + [getattr(sk, k)[cp].reshape(r, -1) for k in POOL_PLANES[1:]], dim=1)
    return torch.where(isc[:, None], row, 0)


def _flatten_wide_open(sk: SketchState) -> torch.Tensor:
    """Pool mode: [R, WIDE] int32 — each ring slot's wide-arena row
    (all-zero unless the slot was promoted), with the slot's count word."""
    pc, pw = sk.p_hll.shape[0], sk.hll.shape[0]
    isw = sk.slot_of >= pc
    wp = (sk.slot_of - pc).clamp(0, pw - 1)
    rows = _flatten_open(sk, sk.count.new_zeros(pw))[wp]
    rows[:, 0] = to_i32_bits(torch.where(isw, sk.count, 0))
    return torch.where(isw[:, None], rows, 0)


def _flatten_open_snapshot(sk: SketchState) -> torch.Tensor:
    """The live read's packed rows of the open ring, one per slot: slab
    mode [R, WIDE] (`_flatten_open`); pool mode [R, CW + WIDE], compact
    part ‖ wide part, where a live slot's count word (always ≥ 1) is
    nonzero on exactly one side. Nothing is closed or written."""
    if _pool_mode(sk):
        return torch.cat([_flatten_compact(sk), _flatten_wide_open(sk)], dim=1)
    return _flatten_open(sk)


def _to_pending(sk: SketchState, close, blocks) -> None:
    """Append the `close`d ring slots' packed `blocks` to the pending
    buffer (in place; other slots land on the scratch row P). A full
    buffer drops the block and counts its rows into `shed`."""
    p = sk.pending
    pos = sk.pend_n + torch.cumsum(close.long(), 0) - 1
    pos = torch.where(close, pos, p)
    overflow = close & (pos >= p)
    pos = pos.clamp(max=p)
    sk.pend.index_copy_(0, pos, blocks)
    sk.pend_win.index_copy_(0, pos, sk.win)
    sk.shed = (sk.shed + torch.where(overflow, sk.count, 0).sum()) & MASK
    sk.pend_n = torch.clamp(sk.pend_n + close.sum(), max=p)


def _scatter_set(dst: torch.Tensor, index, values) -> torch.Tensor:
    """dst with dst[index[i]] = values[i], where index == len(dst) drops
    the value (a scratch cell, as JAX's mode="drop")."""
    return torch.cat([dst, dst[:1]]).scatter_(0, index, values)[:-1]


def _any_at(index, size: int) -> torch.Tensor:
    """[size] bool: which of 0..size-1 `index` holds (values == size are
    dropped)."""
    hit = torch.zeros(size + 1, dtype=torch.bool, device=index.device)
    return hit.index_fill_(0, index, True)[:size]


def sketch_close(sk: SketchState, close_w) -> SketchState:
    """Move every open slot with win < close_w out of the ring and reset
    it (in place). Slab mode: the slot's planes pack into the pending
    buffer. Pool mode: a closing compact slot packs its narrow block into
    the pending buffer and frees its arena slot (zeroed); a closing wide
    slot is only marked (`wide_close`, `wide_count`) and drains in place
    at the next `sketch_drain`. Pending overflow drops the block and
    counts its rows into `shed`. Masks only, no host sync: with nothing
    closing, the state comes out unchanged but for the scratch row."""
    r = sk.ring
    close = (sk.win != SENTINEL_WIN) & (sk.win < close_w)
    if _pool_mode(sk):
        pc, pw = sk.p_hll.shape[0], sk.hll.shape[0]
        c_close = close & (sk.slot_of >= 0) & (sk.slot_of < pc)
        w_close = close & (sk.slot_of >= pc)
        _to_pending(sk, c_close, _flatten_compact(sk))
        wix = torch.where(w_close, sk.slot_of - pc, pw)
        sk.wide_close = _scatter_set(sk.wide_close, wix, sk.win)
        sk.wide_count = _scatter_set(sk.wide_count, wix, sk.count)
        freed = _any_at(torch.where(c_close, sk.slot_of, pc), pc)
        for k in POOL_PLANES:
            getattr(sk, k).masked_fill_(freed.view(pc, 1, 1), 0)
        sk.slot_of.masked_fill_(close, -1)
    else:
        _to_pending(sk, close, _flatten_open(sk))
        for k in PLANES:
            getattr(sk, k).masked_fill_(close.view(r, 1, 1), 0)
    sk.win.masked_fill_(close, SENTINEL_WIN)
    sk.count.masked_fill_(close, 0)
    return sk


def batch_sort(window, key_hi, key_lo):
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


def _pool_alloc(sk: SketchState, mask, slot) -> torch.Tensor:
    """Seat this phase's unallocated ring slots in free COMPACT arena
    slots (in place): the i-th needy ring slot, in ring order, takes the
    i-th free compact slot; needs past the free count stay unseated and
    their rows spill. Returns alloc_ok [R]."""
    r, pc = sk.ring, sk.p_hll.shape[0]
    need = _any_at(torch.where(mask, slot, r), r) & (sk.slot_of < 0)
    free = ~_any_at(torch.where((sk.slot_of >= 0) & (sk.slot_of < pc), sk.slot_of, pc), pc)
    free_rank = torch.cumsum(free.long(), 0) - 1
    # rank → compact slot id (at most R ring slots can take one)
    table = _scatter_set(torch.zeros(r, dtype=torch.int64, device=slot.device),
                         torch.where(free & (free_rank < r), free_rank, r),
                         torch.arange(pc, device=slot.device))
    need_rank = torch.cumsum(need.long(), 0) - 1
    got = need & (need_rank < free.sum())
    sk.slot_of = torch.where(got, table[need_rank.clamp(0, r - 1)], sk.slot_of)
    return sk.slot_of >= 0


def _arena_hll(arena, ix, on, gid, reg, rho) -> None:
    """In place: arena[ix, gid, reg] = max(., rho) for rows `on`; other
    rows max a 0 into cell 0 (registers are ≥ 0). An int8 compact arena
    folds in int32 and narrows (rho ≤ 33, so exactly)."""
    _, g, m = arena.shape
    flat = arena.view(-1)
    regs = flat.to(torch.int32)
    regs.scatter_reduce_(0, torch.where(on, (ix * g + gid) * m + reg, 0),
                         torch.where(on, rho, 0).to(torch.int32), "amax")
    if regs is not flat:
        flat.copy_(regs)


def _arena_cms(cms, ix, on, key_hi, key_lo, w) -> None:
    """In place: cms[ix, d, col_d(key)] += w for rows `on` (int32 adds
    that wrap); other rows add 0 to slot 0."""
    d, width = cms.shape[1], cms.shape[2]
    flat = torch.where(on, ix, 0)[None, :] * (d * width) + row_slots(key_hi, key_lo, d,
                                                                     width)
    cms.view(-1).index_add_(0, flat.reshape(-1),
                            torch.where(on, w, 0)[None, :].expand(d, -1).reshape(-1))


def _arena_hist(hist, ix, on, gid, b) -> None:
    """In place: hist[ix, gid, b] += 1 for rows `on`."""
    _, g, bins = hist.shape
    hist.view(-1).index_add_(0, (torch.where(on, ix, 0) * g + gid) * bins + b,
                             on.to(torch.int32))


def _arena_topk(sk: SketchState, lane_names, ix, on, rw, s_hi, s_lo, s_ia, s_ib) -> None:
    """The top-K challengers of one arena over the shared sort (`ix`,
    `on` in sorted order), applied to its lanes."""
    lanes = tuple(getattr(sk, k) for k in lane_names)
    votes = lanes[0]
    ch = topk_challengers_presorted(torch.where(on, ix, 0), s_hi, s_lo, s_ia, s_ib, rw, on,
                                    votes.shape[0], votes.shape[1], votes.shape[2])
    for k, v in zip(lane_names, _apply_challengers(lanes, ch)):
        setattr(sk, k, v)


def _scatter_rows_pool(sk: SketchState, mask, slot, gid, reg, rho, w, b, rtt_valid,
                       key_hi, key_lo, id_a, id_b, presorted) -> SketchState:
    """Pool mode: fold one phase's (seated) rows into the arena each
    window lives in, in place. Every lane folds twice, once per arena,
    with the other arena's rows masked out. Within a phase a pool slot
    holds one window, so the slab plane's exactness arguments carry over
    at the pooled widths; count-min and top-K route each (window, key)
    run by its HEAD row, as the reference does."""
    pc, pw = sk.p_hll.shape[0], sk.hll.shape[0]
    pslot = sk.slot_of[slot]
    is_c = mask & (pslot >= 0) & (pslot < pc)
    is_w = mask & (pslot >= pc)
    # HLL: the compact arena keeps all m registers, so it folds exactly
    # as the wide one does
    _arena_hll(sk.hll, pslot - pc, is_w, gid, reg, rho)
    _arena_hll(sk.p_hll, pslot, is_c, gid, reg, rho)
    # histogram: the compact bin is the wide bin coarsened exactly
    _arena_hist(sk.hist, pslot - pc, is_w & rtt_valid, gid, b)
    _arena_hist(sk.p_hist, pslot, is_c & rtt_valid, gid,
                loghist_coarsen_bin(b, sk.hist.shape[2] // sk.p_hist.shape[2]))
    if presorted is None:  # per-row count-min adds
        _arena_cms(sk.cms, pslot - pc, is_w, key_hi, key_lo, w)
        _arena_cms(sk.p_cms, pslot, is_c, key_hi, key_lo, w)
        if sk.tk_votes.shape[1]:  # the multi-sort oracle's top-K
            for names, ix, on in ((TOPK_LANES, pslot - pc, is_w),
                                  (POOL_TOPK_LANES, pslot, is_c)):
                lanes = topk_update(tuple(getattr(sk, k) for k in names),
                                    torch.where(on, ix, -1), key_hi, key_lo, id_a, id_b,
                                    w, on)
                for k, v in zip(names, lanes):
                    setattr(sk, k, v)
        return sk
    s_win, s_hi, s_lo, s_pos, head, run_id = presorted
    run_w = torch.zeros(s_pos.shape[0], dtype=torch.int32, device=w.device)
    run_w.index_add_(0, run_id, w[s_pos])
    rw = run_w[run_id]
    w_head = torch.where(head, rw, 0)
    s_pslot = sk.slot_of[s_win % sk.ring]
    s_mask = mask[s_pos]
    s_isc = s_mask & (s_pslot >= 0) & (s_pslot < pc)
    s_isw = s_mask & (s_pslot >= pc)
    _arena_cms(sk.cms, s_pslot - pc, s_isw, s_hi, s_lo, w_head)
    _arena_cms(sk.p_cms, s_pslot, s_isc, s_hi, s_lo, w_head)
    s_ia, s_ib = id_a[s_pos], id_b[s_pos]
    _arena_topk(sk, TOPK_LANES, s_pslot - pc, s_isw, rw, s_hi, s_lo, s_ia, s_ib)
    _arena_topk(sk, POOL_TOPK_LANES, s_pslot, s_isc, rw, s_hi, s_lo, s_ia, s_ib)
    return sk


def _scatter_rows(sk: SketchState, spec: LogHistSpec, mask, window, group,
                  client_hi, client_lo, key_hi, key_lo, weight, rtt, rtt_valid,
                  id_a, id_b, presorted=None) -> SketchState:
    """Fold one phase's rows into their ring slots (claiming empties),
    in place. The phase's window span is < R wide, so slots never
    collide. With `presorted` (the batch's shared sort), count-min and
    top-K consume run weights in sorted order through
    `sketch_update_fused`; HLL rides the same call (max is order-free).
    Masked rows fold a no-op value into a valid cell instead of an
    out-of-range index. Pool mode first seats the phase's new windows
    (`_pool_alloc`); rows of windows it cannot seat are masked out — they
    claim no win or count — and counted once into `pool_spill`."""
    pool = _pool_mode(sk)
    if pool:
        slot = window % sk.ring
        row_ok = mask & _pool_alloc(sk, mask, slot)[slot]
        sk.pool_spill = (sk.pool_spill + (mask & ~row_ok).sum()) & MASK
        mask = row_ok
    g, bins = sk.hist.shape[1], sk.hist.shape[2]
    slot, gid, reg, rho, w = _row_lanes(sk, mask, window, group, client_hi, client_lo,
                                        weight)
    sk.win.scatter_reduce_(0, slot, torch.where(mask, window, SENTINEL_WIN), "amin")
    sk.count = (sk.count.index_add(0, slot, mask.long())) & MASK
    b = loghist_bin(rtt, spec).long()
    if pool:
        return _scatter_rows_pool(sk, mask, slot, gid, reg, rho, w, b, rtt_valid, key_hi,
                                  key_lo, id_a, id_b, presorted)
    sk.hist.view(-1).index_add_(0, (slot * g + gid) * bins + b,
                                (mask & rtt_valid).to(torch.int32))

    if presorted is None:
        # per-row HLL max and count-min adds, no kernel; with top-K on
        # (the multi-sort oracle) a fresh sort per hash row
        hll_cms_scatter(sk.hll, sk.cms, slot, gid, reg, rho, mask, key_hi, key_lo, w)
        if sk.tk_votes.shape[1]:
            lanes = topk_update(tuple(getattr(sk, k) for k in TOPK_LANES), slot, key_hi,
                                key_lo, id_a, id_b, w, mask)
            for k, v in zip(TOPK_LANES, lanes):
                setattr(sk, k, v)
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
                      rtt, rtt_valid, id_a, id_b, shared_sort: bool | None = None
                      ) -> SketchState:
    """One batch through the plane, in window order (in place):

      1. closing-span rows (base_w ≤ window < close_w, inside the live
         ring span) fold into their still-open slots;
      2. every slot with win < close_w closes into the pending buffer;
      3. new-span rows (window ≥ close_w) claim the freed slots.

    `base_w`/`close_w` are the pre-/post-batch open-span starts (0-dim
    tensors or host ints). The closing phase's alias-free span is
    anchored at the oldest live ring slot; rows in the mid-gap
    [anchor + R, close_w) are counted into `shed`. u32 lanes are int64
    tensors; `weight`/`rtt` are float32.

    With top-K on, `shared_sort` (default: the DEEPFLOW_SHARED_SORT knob,
    on) sorts the batch once for both phases; off, each phase runs the
    multi-sort oracle (2 phases × topk_rows sorts). An open sort tally
    (ops/segment.sort_census) gets this step's sorts as `plane_sorts`."""
    tally = active_sort_tally()
    sorts0 = tally["sorts"] if tally is not None else 0
    if shared_sort is None:
        shared_sort = _use_shared_sort()
    in_a, in_c, shed = phase_masks(sk, window=window, valid=valid, base_w=base_w,
                                   close_w=close_w)
    presorted = (batch_sort(window, key_hi, key_lo)
                 if shared_sort and sk.tk_votes.shape[1] else None)

    args = (group, client_hi, client_lo, key_hi, key_lo, weight, rtt, rtt_valid,
            id_a, id_b)
    sk = _scatter_rows(sk, spec, in_a, window, *args, presorted=presorted)
    sk = sketch_close(sk, close_w)
    sk = _scatter_rows(sk, spec, in_c, window, *args, presorted=presorted)
    if _pool_mode(sk):
        sk = _maybe_promote(sk)
    sk.rows = (sk.rows + in_a.sum() + in_c.sum()) & MASK
    sk.shed = (sk.shed + shed.sum()) & MASK
    if tally is not None:
        tally["plane_sorts"] += tally["sorts"] - sorts0
    return sk


def _put(dst: torch.Tensor, i1, do, new) -> None:
    """In place: dst[i1] = new if `do` else unchanged (i1 a 1-element
    index tensor, `do` a 0-dim bool — neither leaves the device)."""
    dst.index_copy_(0, i1, torch.where(do, new, dst.index_select(0, i1)))


def _maybe_promote(sk: SketchState) -> SketchState:
    """End-of-step promotion (pool mode), in place: if the most
    saturated occupied compact slot — by the fill of its count-min row 0
    — has reached `promote_fill` and a wide slot is free, move it there.
    A promotion is a merge into an all-zero wide slot: HLL widens from
    int8 exactly, count-min and top-K tile (`cms_expand`, `topk_tile`),
    the histogram re-centres (`loghist_expand`). At most one per step.
    The condition never leaves the device: each write of the one slot is
    `torch.where(do, new, old)`, so with `do` false the state is
    unchanged bit for bit."""
    pc, pw = sk.p_hll.shape[0], sk.hll.shape[0]
    occ = _any_at(torch.where((sk.slot_of >= 0) & (sk.slot_of < pc), sk.slot_of, pc), pc)
    fill = (sk.p_cms[:, 0, :] != 0).float().mean(-1)
    cand = occ & (fill >= sk.promote_fill)
    # a closed wide slot awaiting its drain is not free
    w_free = (~_any_at(torch.where(sk.slot_of >= pc, sk.slot_of - pc, pw), pw)
              & (sk.wide_close == SENTINEL_WIN))
    do = cand.any() & w_free.any()
    pidx = torch.argmax(torch.where(cand, fill, -1.0)).view(1)
    widx = torch.argmax(w_free.long()).view(1)
    rstar = torch.argmax((sk.slot_of == pidx).long()).view(1)
    compact = {k: getattr(sk, k).index_select(0, pidx)[0] for k in POOL_PLANES}
    _put(sk.hll, widx, do, compact["p_hll"].to(torch.int32)[None])
    _put(sk.cms, widx, do, cms_expand(compact["p_cms"], sk.cms.shape[2])[None])
    _put(sk.hist, widx, do, loghist_expand(compact["p_hist"], sk.hist.shape[2])[None])
    if sk.tk_votes.shape[1]:
        tiled = topk_tile(tuple(compact[k] for k in POOL_TOPK_LANES), sk.tk_votes.shape[2])
        for k, v in zip(TOPK_LANES, tiled):
            _put(getattr(sk, k), widx, do, v[None])
    _put(sk.slot_of, rstar, do, pc + widx)
    for k in POOL_PLANES:
        plane = getattr(sk, k)
        _put(plane, pidx, do, torch.zeros_like(plane[:1]))
    sk.pool_promos = (sk.pool_promos + do.long()) & MASK
    return sk


def sketch_drain(sk: SketchState, close_w):
    """Close every slot with win < close_w, then hand out the pending
    buffer: returns (sk, pend [P + 1, W] int32, pend_win [P + 1], pend_n
    0-dim, wide_rows, wide_wins) with the two buffers CLONED — the plane
    keeps writing its own on later closes — and the pending cursor reset.
    Pool mode drains the closed wide slots in place: wide_rows [Pw, WIDE]
    int32 are their packed rows (zero for open or free slots, whose
    wide_wins are SENTINEL_WIN), and those slots come back zeroed and
    free. Slab mode: wide_rows and wide_wins are None."""
    sk = sketch_close(sk, close_w)
    pend, pend_win, n = sk.pend.clone(), sk.pend_win.clone(), sk.pend_n
    sk.pend_n = torch.zeros_like(n)
    if not _pool_mode(sk):
        return sk, pend, pend_win, n, None, None
    pw = sk.hll.shape[0]
    wmask = sk.wide_close != SENTINEL_WIN
    wide_rows = torch.where(wmask[:, None], _flatten_open(sk, sk.wide_count), 0)
    wide_wins = sk.wide_close.clone()
    for k in PLANES:
        getattr(sk, k).masked_fill_(wmask.view(pw, 1, 1), 0)
    sk.wide_close = torch.full_like(wide_wins, SENTINEL_WIN)
    sk.wide_count = torch.where(wmask, 0, sk.wide_count)
    return sk, pend, pend_win, n, wide_rows, wide_wins


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

    @classmethod
    def from_compact_row(cls, row: np.ndarray, window: int, cfg: SketchConfig):
        """Unpack one [CW] u32 compact block row (pool mode) into the full
        block form: HLL unpacks exactly, count-min and histogram expand by
        the device promotion's math, top-K candidates read straight from
        the compact lanes."""
        g, m, d = cfg.num_groups, cfg.hll_m, cfg.cms_depth
        wc, bc = cfg.pool_cms_width, cfg.pool_hist_bins
        tk = cfg.topk_rows * cfg.pool_topk_cols
        o = 0

        def take(n):
            nonlocal o
            out = row[o:o + n]
            o += n
            return out

        n_updates = int(take(1)[0])
        hll = hll_unpack_registers_np(take(g * m // 4).reshape(g, m // 4), m)
        cms = cms_expand(take(d * wc).astype(np.int64).reshape(d, wc), cfg.cms_width, xp=np)
        hist = loghist_expand(take(g * bc).astype(np.int64).reshape(g, bc), cfg.hist.bins,
                              xp=np)
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
        m, w = tdigest_compress(torch.from_numpy(centers.astype(np.float32)),
                                torch.from_numpy(hist.astype(np.float32)),
                                compression=compression)
        return m.numpy(), w.numpy()

    def quantile(self, q: float, group: int | None = None) -> float:
        """Latency quantile through the t-digest export path."""
        m, w = self.tdigest(group)
        return float(tdigest_quantile(torch.from_numpy(m), torch.from_numpy(w),
                                      torch.tensor([q], dtype=torch.float32))[0])

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
    """Fetched [n, width] u32 block rows + [n] window ids →
    WindowSketchBlocks, dispatching on the width: `block_width` (wide
    rows), `compact_block_width` (pool mode's pending rows) or their sum
    (the live read's compact ‖ wide rows: the side whose count word is
    nonzero is the live one). Blocks that never saw a row are dropped."""
    cw = cfg.compact_block_width if cfg.pool is not None else None
    out = []
    for i in range(rows.shape[0]):
        row, window = rows[i], int(wins[i])
        if cw is not None and row.shape[0] == cw + cfg.block_width:
            if int(row[0]):
                blk = WindowSketchBlock.from_compact_row(row[:cw], window, cfg)
            else:
                blk = WindowSketchBlock.from_row(row[cw:], window, cfg)
        elif cw is not None and row.shape[0] == cw:
            blk = WindowSketchBlock.from_compact_row(row, window, cfg)
        else:
            blk = WindowSketchBlock.from_row(row, window, cfg)
        if blk.n_updates or len(blk.tk_hi):
            out.append(blk)
    return out
