"""Window-state checkpoint/resume (port of the single-chip part of
deepflow_tpu/aggregator/checkpoint.py, format v6).

A WindowManager's state lives on the device: the stash, the
accumulator ring, the host window span, the sketch plane and the rollup
cascade's tier stashes with their partly merged parent sketch blocks.
`save_window_state` writes all of it to one .npz that the reference
reads, and `load_window_state` reads a file either package wrote, so a
worker resumes mid-window, and a port worker can take over from a JAX
one.

The file is the reference's, array for array: every array has its
name, dtype, shape and bytes (u32 packs `[4+T+M, S]` with a valid row,
the reference's `SketchState` dtypes through `convert.sketch_to_numpy`),
so a port file and a reference file of the same state carry the same
sha256 digest. The writer is atomic (temp file, fsync, `os.replace`,
directory fsync) and fires `chaos.SITE_CHECKPOINT_IO` before it opens
the file; the reader fails loudly (a ValueError naming the file) on
truncation or a digest mismatch. v2–v6 files load — a pre-v4 file
re-initializes the sketch plane with a loud log, a pre-v5 file the
cascade tiers, a file of another pool geometry the pooled plane — and
v1 files are refused. The plane's `promote_fill` is never written: it
re-derives from the manager's PoolConfig (whose meta the file carries).

The feeder's journal barrier rides `extra_meta` (FeederRuntime.
checkpoint): recovered state = `load_window_state(checkpoint)` +
`FeederRuntime.replay_journal` of the frames admitted since.

The save's device→host copies are plain copies, not the manager's
`_fetch` seam: the reference's save bypasses it too, so a fault plan's
fetch indices stay the same in both packages.

Not ported: the sharded save and restore (`save_sharded_state` /
`restore_sharded_state`, with the sharded managers), the save's tracer
span (`checkpoint.save`) and its note of the transient device scratch on
the HBM ledger (`note_transient`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import logging
import os
from pathlib import Path

import numpy as np
import torch

from .. import chaos
from ..convert import sketch_from_numpy, sketch_to_numpy
from ..datamodel.schema import MeterSchema, TagSchema
from ..device import resolve_device
from ..ops.u32 import MASK
from .cascade import CascadeConfig, pending_block_arrays, restore_pending_blocks
from .sketchplane import SketchConfig, SketchState, sketch_init
from .stash import AccumState, StashState, pack_u32_columns, stash_canonicalize
from .window import WindowConfig, WindowManager

_VERSION = 6
_MIN_READ_VERSION = 2  # v2 = pre-digest layout, still loadable

_log = logging.getLogger(__name__)

# sketch-plane lanes (v4), one array each
_SKETCH_LANES = (
    "win", "count", "hll", "cms", "hist",
    "tk_votes", "tk_hi", "tk_lo", "tk_ida", "tk_idb",
    "pend", "pend_win",
)

# pooled sketch-memory lanes (v6): zero-size in slab mode, so they
# serialize (and hash into the digest) at no cost either way
_POOL_LANES = (
    "slot_of", "p_hll", "p_cms", "p_hist", "p_tkv", "p_tkh", "p_tkl",
    "p_tia", "p_tib", "wide_close", "wide_count",
)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _sketch_arrays(sk: SketchState) -> dict:
    """The plane's lanes in the reference's dtypes (pending scratch row
    dropped)."""
    d = sketch_to_numpy(sk)
    return {"sk_" + name: np.asarray(d[name]) for name in _SKETCH_LANES + _POOL_LANES}


def _sketch_meta(sk: SketchState, cfg: SketchConfig) -> dict:
    return {
        "sketch": cfg.meta(),
        "sketch_pend_n": int(sk.pend_n),
        "sketch_rows": int(sk.rows),
        "sketch_shed": int(sk.shed),
        "sketch_pool_spill": int(sk.pool_spill),
        "sketch_pool_promos": int(sk.pool_promos),
    }


def _restore_sketch(meta: dict, arrays: dict, cfg: SketchConfig, ring: int, path,
                    device) -> SketchState:
    """→ the plane from a v4+ file, or a LOUDLY logged fresh plane when
    the file predates the sketch tier (v2/v3), was saved with sketches
    off, or holds pooled arenas of another geometry."""
    if "sk_win" not in arrays:
        _log.warning(
            "checkpoint %s (version %s) carries no sketch planes — "
            "re-initializing the per-window sketch tier empty; open "
            "windows' approximate answers restart from this point",
            path, meta.get("version"),
        )
        return sketch_init(cfg, ring, device=device)
    saved_cfg = SketchConfig.from_meta(meta["sketch"])
    if saved_cfg != cfg:
        if dataclasses.replace(saved_cfg, pool=None) == dataclasses.replace(cfg, pool=None):
            # same wide-plane shapes, other pool geometry (v5 meta has no
            # "pool"): pooled arenas cannot be re-seated, so this is the
            # loud re-init, not the config-mismatch error
            _log.warning(
                "checkpoint %s sketch pool geometry %s != manager pool "
                "geometry %s — pooled arenas cannot be re-seated; "
                "re-initializing the sketch tier empty (open windows' "
                "approximate answers restart from this point)",
                path, saved_cfg.pool, cfg.pool,
            )
            return sketch_init(cfg, ring, device=device)
        raise ValueError(
            f"checkpoint {path} sketch config {saved_cfg} != manager "
            f"sketch config {cfg} — plane shapes/error knobs disagree"
        )
    # pooled lanes are absent from pre-v6 files — by the gate above only
    # with pool=None, where they are zero-size: a fresh plane supplies
    # them, and promote_fill (never serialized) re-derives from cfg
    fresh = sketch_to_numpy(sketch_init(cfg, ring, device="cpu"))
    d = {name: arrays.get("sk_" + name, fresh[name]) for name in _SKETCH_LANES + _POOL_LANES}
    d.update(pend_n=meta["sketch_pend_n"], rows=meta["sketch_rows"],
             shed=meta["sketch_shed"], pool_spill=meta.get("sketch_pool_spill", 0),
             pool_promos=meta.get("sketch_pool_promos", 0),
             promote_fill=fresh["promote_fill"])
    return sketch_from_numpy(d, device)


def _pack_stash(state: StashState) -> np.ndarray:
    """[4+T+M, S] u32: slot, key_hi, key_lo, valid, tags…, meters…"""
    return _host(pack_u32_columns(state.slot, state.key_hi, state.key_lo, state.tags,
                                  state.meters, valid=state.valid)).view(np.uint32)


def _pack_acc(acc: AccumState) -> np.ndarray:
    """[3+T+M, A] u32: slot, key_hi, key_lo, tags…, meters…"""
    return _host(pack_u32_columns(acc.slot, acc.key_hi, acc.key_lo, acc.tags,
                                  acc.meters)).view(np.uint32)


def _upload_packed(mat: np.ndarray, k: int, device):
    """One upload of a packed u32 matrix, split on the device into its
    first k rows as u32 lanes (int64) and the rest as f32 meters."""
    t = torch.from_numpy(np.ascontiguousarray(mat, np.uint32).view(np.int32)).to(device)
    return t[:k].to(torch.int64) & MASK, t[k:].view(torch.float32)


def _unpack_stash(mat: np.ndarray, dropped: int, *, num_tags: int, device) -> StashState:
    lanes, meters = _upload_packed(mat, 4 + num_tags, device)
    return StashState(slot=lanes[0], key_hi=lanes[1], key_lo=lanes[2], valid=lanes[3] != 0,
                      tags=lanes[4:], meters=meters,
                      dropped_overflow=torch.tensor(int(dropped), dtype=torch.int64,
                                                    device=device))


def _unpack_acc(mat: np.ndarray, *, num_tags: int, device) -> AccumState:
    lanes, meters = _upload_packed(mat, 3 + num_tags, device)
    return AccumState(slot=lanes[0], key_hi=lanes[1], key_lo=lanes[2], tags=lanes[3:],
                      meters=meters)


def _cascade_save(casc, config: CascadeConfig) -> tuple[dict, dict]:
    """(meta, arrays) for the cascade's tier state (v5): per-tier packed
    stash planes, host watermarks, the device counter lanes and the open
    parents' partially merged sketch blocks."""
    arrays = {f"casc_t{i}_packed": _pack_stash(t) for i, t in enumerate(casc.tiers)}
    pend_meta, pend_arrays = pending_block_arrays(casc.pending_blocks)
    arrays.update(pend_arrays)
    meta = {
        "cascade": config.meta(),
        "cascade_watermarks": [int(w) for w in casc.watermarks],
        "cascade_lanes": [int(v) for v in _host(casc.lanes_dev)],
        "cascade_pending": pend_meta,
        "cascade_tier_windows": int(casc.tier_windows_flushed),
        "cascade_dropped": [int(t.dropped_overflow) for t in casc.tiers],
    }
    return meta, arrays


def _restore_cascade_tiers(meta: dict, arrays: dict, config: CascadeConfig, num_tags: int,
                           path, *, sketch_config, device):
    """→ (tier stashes, watermarks, lanes, pending blocks) from a v5+
    file, or None (with a LOUD log) when the file predates the cascade:
    the caller keeps its fresh tiers."""
    if "casc_t0_packed" not in arrays:
        _log.warning(
            "checkpoint %s (version %s) carries no cascade tier state — "
            "re-initializing the 1m/1h rollup tiers empty; open tier "
            "windows' partial aggregates restart from this point",
            path, meta.get("version"),
        )
        return None
    saved = CascadeConfig.from_meta(meta["cascade"])
    if saved != config:
        raise ValueError(
            f"checkpoint {path} cascade config {saved} != manager cascade "
            f"config {config} — tier shapes/intervals disagree"
        )
    # one restore-time sort per tier: pre-v6 files hold tier stashes with
    # mid-prefix holes, and the tier ring fold rank-merges against the
    # canonical order
    tiers = [stash_canonicalize(_unpack_stash(arrays[f"casc_t{i}_packed"],
                                              meta["cascade_dropped"][i],
                                              num_tags=num_tags, device=device))
             for i in range(len(config.intervals))]
    lanes = torch.tensor(meta["cascade_lanes"], dtype=torch.int64, device=device) & MASK
    pending: list[dict] = [{} for _ in config.intervals]
    if meta.get("cascade_pending"):
        if sketch_config is None:
            raise ValueError(
                f"checkpoint {path} holds pending cascade sketch blocks but the "
                "manager has no sketch config to type them"
            )
        restore_pending_blocks(pending, meta["cascade_pending"], arrays, sketch_config)
    return tiers, list(meta["cascade_watermarks"]), lanes, pending


# ---------------------------------------------------------------------------
# crash-safe file layer


def _digest(arrays: dict[str, np.ndarray]) -> str:
    """sha256 over every array's (name, dtype, shape, bytes) — the
    content digest the loader verifies."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _write_checkpoint(path: str | Path, meta: dict, arrays: dict) -> None:
    """Serialize + ATOMICALLY replace: a kill at any point leaves either
    the previous checkpoint or the new one, never a torn file."""
    meta = dict(meta)
    meta["digest"] = _digest(arrays)
    buf = io.BytesIO()
    np.savez_compressed(buf, meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
                        **arrays)
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    chaos.maybe_fail(chaos.SITE_CHECKPOINT_IO)
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        # without the fsync a power loss after the rename can still
        # surface a renamed-but-empty file
        os.fsync(f.fileno())
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass  # directory fsync is best-effort (not supported everywhere)


def _read_checkpoint(path: str | Path) -> tuple[dict, dict]:
    """→ (meta, arrays). Truncation, corruption or a digest mismatch
    raise a ValueError naming the file and the failure; a missing file
    stays FileNotFoundError (an operator error, not corruption)."""
    raw = Path(path).read_bytes()
    try:
        with np.load(io.BytesIO(raw)) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            arrays = {k: np.asarray(z[k]) for k in z.files if k != "meta"}
    except Exception as e:
        raise ValueError(
            f"checkpoint {path} is truncated or corrupt ({type(e).__name__}: "
            f"{e}); restore from the previous checkpoint — the atomic "
            "writer never produces such a file, so this one was torn by "
            "an outside force (partial copy, disk fault)"
        ) from e
    want = meta.get("digest")
    if want is not None and want != _digest(arrays):
        raise ValueError(
            f"checkpoint {path} content digest mismatch — arrays were "
            "modified or corrupted after the save; refusing to resume from it"
        )
    return meta, arrays


def read_checkpoint_meta(path: str | Path) -> dict:
    """Meta only — no array decompression and no digest pass (the state
    load verifies the digest): recovery reads the journal barrier
    (journal_epoch / journal_offset) here before deciding what to replay."""
    try:
        with np.load(Path(path)) as z:
            return json.loads(bytes(z["meta"]).decode())
    except FileNotFoundError:
        raise  # missing file = cold start / operator error, not corruption
    except Exception as e:
        raise ValueError(
            f"checkpoint {path} is truncated or corrupt ({type(e).__name__}: "
            f"{e}); restore from the previous checkpoint"
        ) from e


def _check_version(meta: dict, path) -> None:
    v = meta.get("version")
    if v == 1:
        # a v1 stash predates the packed-word key fingerprint and could
        # never merge with freshly hashed rows
        raise ValueError(
            "checkpoint format v1 is unsupported (v1 load support was "
            "removed after v2 writers shipped); re-save the window "
            "state with a current writer"
        )
    if not (_MIN_READ_VERSION <= (v or 0) <= _VERSION):
        raise ValueError(f"checkpoint {path} version {v} not in "
                         f"[{_MIN_READ_VERSION}, {_VERSION}]")


# ---------------------------------------------------------------------------
# single-chip WindowManager


def _window_payload(wm: WindowManager) -> tuple[list, dict, dict]:
    """Settle `wm` and copy its state to the host: → (in-flight windows,
    meta, arrays), the arrays in the reference's names and dtypes."""
    in_flight = wm.settle()
    arrays = {"stash_packed": _pack_stash(wm.state)}
    if wm.acc is not None:
        arrays["acc_packed"] = _pack_acc(wm.acc)
    cfg = wm.config
    meta = {
        "version": _VERSION,
        "kind": "window",
        "num_tags": wm.tag_schema.num_fields,
        "dropped_overflow": int(wm.state.dropped_overflow),
        "fill": wm.fill,
        "start_window": wm.start_window,
        "drop_before_window": wm.drop_before_window,
        "total_docs_in": wm.total_docs_in,
        "total_flushed": wm.total_flushed,
        "n_advances": wm.n_advances,
        "aux_count": wm.aux_count,
        "excess_word_hits": wm.excess_word_hits,
        "feeder_shed": wm.feeder_shed,
        "interval": cfg.interval,
        "delay": cfg.delay,
        "capacity": cfg.capacity,
        "accum_batches": cfg.accum_batches,
        "async_drain": cfg.async_drain,
        "stats_ring": cfg.stats_ring,
        # a merge-mode stash is canonical and must resume merge-mode; a
        # full-mode stash may hold flush holes and must not
        "fold_mode": cfg.fold_mode,
    }
    if wm.sk is not None:
        # settle() drained the pending buffer and married every held block
        # to its flush: a block still held belongs to a window that never
        # flushed, and would vanish across the resume
        if wm._sketch_blocks:
            raise RuntimeError(
                f"sketch blocks for windows {sorted(wm._sketch_blocks)} are still "
                "held after settle(); checkpointing would lose them"
            )
        arrays.update(_sketch_arrays(wm.sk))
        meta.update(_sketch_meta(wm.sk, cfg.sketch))
    if wm.cascade is not None:
        # closed tier windows still held (the settle itself may close one)
        # left the tier stash: they ride the in-flight return. The tier
        # rings fold into their stashes first, so they never serialize.
        in_flight = in_flight + wm.pop_tier_windows()
        wm.cascade.settle_rings()
        c_meta, c_arrays = _cascade_save(wm.cascade, cfg.cascade)
        meta.update(c_meta)
        arrays.update(c_arrays)
    return in_flight, meta, arrays


def save_window_state(wm: WindowManager, path: str | Path, *, extra_meta=None) -> list:
    """Snapshot `wm` to one .npz (atomic + digested, format v6). Returns
    the FlushedWindows that were still in flight (deferred counter blocks
    and dispatched flushes under async_drain or a counter ring, and the
    cascade's held tier windows) — their rows have already left the
    state, so the CALLER must emit them before treating the checkpoint as
    the resume point. `extra_meta` (e.g. the feeder's journal barrier)
    merges into meta and comes back from `read_checkpoint_meta`."""
    in_flight, meta, arrays = _window_payload(wm)
    if extra_meta:
        meta.update(extra_meta)
    _write_checkpoint(path, meta, arrays)
    return in_flight


def _restore_window(meta: dict, arrays: dict, path, tag_schema: TagSchema,
                    meter_schema: MeterSchema, *, sketch_config, cascade_config,
                    device) -> WindowManager:
    _check_version(meta, path)
    if meta.get("kind", "window") != "window":
        raise ValueError(
            f"checkpoint {path} is kind={meta.get('kind')!r}, not a single-chip "
            "window checkpoint"
        )
    if sketch_config is None and "sketch" in meta:
        sketch_config = SketchConfig.from_meta(meta["sketch"])
    if cascade_config is None and "cascade" in meta:
        cascade_config = CascadeConfig.from_meta(meta["cascade"])
    cfg = WindowConfig(
        interval=meta["interval"], delay=meta["delay"], capacity=meta["capacity"],
        accum_batches=meta["accum_batches"], async_drain=meta.get("async_drain", False),
        stats_ring=meta.get("stats_ring", 1), fold_mode=meta.get("fold_mode", "full"),
        sketch=sketch_config, cascade=cascade_config,
    )
    t = tag_schema.num_fields
    if meta["num_tags"] != t:
        # the packed split is shape-valid for ANY num_tags — a mismatch
        # would bit-cast misaligned words into meters silently
        raise ValueError(
            f"checkpoint tag schema width {meta['num_tags']} != {t} "
            f"({tag_schema.__class__.__name__}); cannot unpack"
        )
    wm = WindowManager(cfg, tag_schema, meter_schema, device=device)
    dev = wm.device
    wm.state = _unpack_stash(arrays["stash_packed"], meta["dropped_overflow"], num_tags=t,
                             device=dev)
    if "acc_packed" in arrays:
        wm.acc = _unpack_acc(arrays["acc_packed"], num_tags=t, device=dev)
    wm.fill = meta["fill"]
    wm.start_window = meta["start_window"]
    wm.drop_before_window = meta["drop_before_window"]
    wm.total_docs_in = meta["total_docs_in"]
    wm.total_flushed = meta["total_flushed"]
    # telemetry counters landed after v2 writers; absent = 0
    wm.n_advances = meta.get("n_advances", 0)
    wm.aux_count = meta.get("aux_count", 0)
    wm.excess_word_hits = meta.get("excess_word_hits", 0)
    wm.feeder_shed = meta.get("feeder_shed", 0)
    if cfg.sketch is not None:
        wm.sk = _restore_sketch(meta, arrays, cfg.sketch, cfg.ring, path, dev)
        wm.sketch_rows = int(meta.get("sketch_rows", 0))
        wm.sketch_shed = int(meta.get("sketch_shed", 0))
    if cfg.cascade is not None:
        got = _restore_cascade_tiers(meta, arrays, cfg.cascade, t, path,
                                     sketch_config=cfg.sketch, device=dev)
        if got is not None:
            casc = wm.cascade
            casc.tiers, casc.watermarks, casc.lanes_dev, casc.pending_blocks = got
            casc.tier_windows_flushed = int(meta.get("cascade_tier_windows", 0))
            wm.cascade_rows = int(meta["cascade_lanes"][0])
            wm.cascade_shed = int(meta["cascade_lanes"][1])
    # the save settled (ring drained), so the restored host span IS the
    # device gate state — mirror it back onto the device
    wm._sync_device_sw()
    return wm


def load_window_state(path: str | Path, tag_schema: TagSchema, meter_schema: MeterSchema,
                      *, sketch_config: SketchConfig | None = None,
                      cascade_config: CascadeConfig | None = None,
                      device=None) -> WindowManager:
    """Rebuild a WindowManager on `device` (default CUDA; raises without
    it) from a checkpoint either package wrote. The sketch plane restores
    from v4+ files automatically; `sketch_config` asks for the plane when
    resuming a pre-v4 file into a sketch-enabled deployment
    (re-initialized with a loud log). `cascade_config` does the same for
    the cascade tiers of a pre-v5 file."""
    device = resolve_device(device)
    meta, arrays = _read_checkpoint(path)
    return _restore_window(meta, arrays, path, tag_schema, meter_schema,
                           sketch_config=sketch_config, cascade_config=cascade_config,
                           device=device)
