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

`save_sharded_state` / `restore_sharded_state` are the
parallel/sharded.ShardedWindowManager twins (kind="sharded"): every
array gains a leading shard axis ([D, 4+T+M, S] stash packs, [D]
`dropped`, [D, …] sketch lanes and tier stashes), the per-shard scalars
become [D] lists in meta, and the mesh topology's `describe()` rides
along. As for one chip, a port file and a reference file of one state
carry one digest; a restore uploads each shard's slice to its device.

Each save runs inside the manager's `checkpoint.save` tracer span and
notes the pack buffers' bytes on the device-memory ledger's transient
`checkpoint_scratch` plane (a high watermark; steady bytes stay 0).
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
from ..convert import sharded_to_numpy, sketch_from_numpy, sketch_to_numpy
from ..datamodel.schema import TAG_SCHEMA, MeterSchema, TagSchema
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


def _sketch_arrays(sk) -> dict:
    """The plane's lanes in the reference's dtypes (pending scratch row
    dropped); a list of per-shard planes gives [D]-leading arrays."""
    d = sharded_to_numpy(sk, sketch_to_numpy) if isinstance(sk, list) else sketch_to_numpy(sk)
    return {"sk_" + name: np.asarray(d[name]) for name in _SKETCH_LANES + _POOL_LANES}


def _sketch_meta(sk, cfg: SketchConfig) -> dict:
    """The plane's scalars for meta; a list of per-shard planes gives [D]
    lists."""
    sks = sk if isinstance(sk, list) else [sk]
    vals = {key: [int(getattr(x, f)) for x in sks] for key, f in (
        ("sketch_pend_n", "pend_n"), ("sketch_rows", "rows"), ("sketch_shed", "shed"),
        ("sketch_pool_spill", "pool_spill"), ("sketch_pool_promos", "pool_promos"))}
    if not isinstance(sk, list):
        vals = {k: v[0] for k, v in vals.items()}
    return {"sketch": cfg.meta(), **vals}


def _restore_sketch(meta: dict, arrays: dict, cfg: SketchConfig, ring: int, path,
                    device, shard: int | None = None) -> SketchState:
    """→ the plane from a v4+ file, or a LOUDLY logged fresh plane when
    the file predates the sketch tier (v2/v3), was saved with sketches
    off, or holds pooled arenas of another geometry. `shard` picks one
    shard's slice of a sharded file."""
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
    def pick(x):
        return x if shard is None else x[shard]

    def scalar(key):  # the pool scalars landed in v6
        return 0 if key not in meta else pick(meta[key])

    d = {name: pick(arrays["sk_" + name]) if "sk_" + name in arrays else fresh[name]
         for name in _SKETCH_LANES + _POOL_LANES}
    d.update(pend_n=scalar("sketch_pend_n"), rows=scalar("sketch_rows"),
             shed=scalar("sketch_shed"), pool_spill=scalar("sketch_pool_spill"),
             pool_promos=scalar("sketch_pool_promos"), promote_fill=fresh["promote_fill"])
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


def _cascade_save(config: CascadeConfig, tiers: list, watermarks: list, lanes, pending: list,
                  tier_windows: int, *, sharded: bool = False) -> tuple[dict, dict]:
    """(meta, arrays) for the cascade's tier state (v5): per-tier packed
    stash planes, host watermarks, the device counter lanes and the open
    parents' partially merged sketch blocks. `sharded`: each tier is a
    list of per-shard stashes and `lanes` a list of per-shard lanes, so
    the arrays gain a leading shard axis (and [D] `casc_t<i>_dropped`)."""
    if sharded:
        arrays = {f"casc_t{i}_packed": np.stack([_pack_stash(x) for x in t])
                  for i, t in enumerate(tiers)}
        for i, t in enumerate(tiers):
            arrays[f"casc_t{i}_dropped"] = np.array([int(x.dropped_overflow) for x in t],
                                                    np.int32)
        lanes_meta = [[int(v) for v in _host(x)] for x in lanes]
    else:
        arrays = {f"casc_t{i}_packed": _pack_stash(t) for i, t in enumerate(tiers)}
        lanes_meta = [int(v) for v in _host(lanes)]
    pend_meta, pend_arrays = pending_block_arrays(pending)
    arrays.update(pend_arrays)
    meta = {
        "cascade": config.meta(),
        "cascade_watermarks": [int(w) for w in watermarks],
        "cascade_lanes": lanes_meta,
        "cascade_pending": pend_meta,
        "cascade_tier_windows": int(tier_windows),
    }
    if not sharded:
        meta["cascade_dropped"] = [int(t.dropped_overflow) for t in tiers]
    return meta, arrays


def _restore_cascade_tiers(meta: dict, arrays: dict, config: CascadeConfig, num_tags: int,
                           path, *, sketch_config, device, shards: list | None = None):
    """→ (tier stashes, watermarks, lanes, pending blocks) from a v5+
    file, or None (with a LOUD log) when the file predates the cascade:
    the caller keeps its fresh tiers. With `shards` (one device per shard)
    each tier is a list of per-shard stashes and the lanes a list."""
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
    def tier(mat, dropped, dev):
        return stash_canonicalize(_unpack_stash(mat, dropped, num_tags=num_tags, device=dev))

    def lane(v, dev):
        return torch.tensor(v, dtype=torch.int64, device=dev) & MASK

    n = len(config.intervals)
    if shards is None:
        tiers = [tier(arrays[f"casc_t{i}_packed"], meta["cascade_dropped"][i], device)
                 for i in range(n)]
        lanes = lane(meta["cascade_lanes"], device)
    else:
        tiers = [[tier(arrays[f"casc_t{i}_packed"][k], arrays[f"casc_t{i}_dropped"][k], dev)
                  for k, dev in enumerate(shards)] for i in range(n)]
        lanes = [lane(meta["cascade_lanes"][k], dev) for k, dev in enumerate(shards)]
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
        casc = wm.cascade
        c_meta, c_arrays = _cascade_save(cfg.cascade, casc.tiers, casc.watermarks,
                                         casc.lanes_dev, casc.pending_blocks,
                                         casc.tier_windows_flushed)
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
    from ..utils.spans import SPAN_CHECKPOINT_SAVE

    with wm.tracer.span(SPAN_CHECKPOINT_SAVE):
        in_flight, meta, arrays = _window_payload(wm)
        if extra_meta:
            meta.update(extra_meta)
        _note_scratch(arrays)
        _write_checkpoint(path, meta, arrays)
    return in_flight


def _note_scratch(arrays: dict) -> None:
    """The pack buffers were materialized on the device at exactly these
    byte sizes before their host copies: record the peak on the ledger's
    transient checkpoint_scratch plane."""
    from ..profiling.ledger import PLANE_CHECKPOINT, default_ledger

    default_ledger.note_transient(PLANE_CHECKPOINT,
                                  sum(a.nbytes for a in arrays.values()))


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


# ---------------------------------------------------------------------------
# sharded ShardedWindowManager


def _validate_ownership_transfer(meta: dict, topo, shard_group: int, path) -> None:
    """Elastic-topology restore contract: a same-process restore needs
    nothing (unless the file is a handover barrier that gave the group
    AWAY); a cross-process restore is legal only through a handover
    manifest naming this process, this group and this topology epoch.
    Every refusal names both epochs."""
    saved_pi = meta.get("process_index")
    if saved_pi is None:
        return  # pre-topology file: the normal restore
    saved_epoch = meta.get("topology_epoch", 0)
    hand = meta.get("handover")
    here = f"process {topo.process_index} at topology epoch {topo.topology_epoch}"
    if int(saved_pi) == topo.process_index:
        # the old owner restoring its own handover barrier would serve the
        # group on two hosts at once
        if hand is not None and int(hand.get("to_process", -1)) != topo.process_index:
            raise ValueError(
                f"checkpoint {path} is the handover barrier that transferred group "
                f"{hand.get('group')} to process {hand.get('to_process')} (epoch "
                f"{hand.get('topology_epoch')}); {here} released it — restoring it "
                "here would serve the group on two hosts at once"
            )
        return
    if hand is None:
        raise ValueError(
            f"checkpoint {path} was saved by process {saved_pi} at topology epoch "
            f"{saved_epoch} with NO ownership-transfer manifest, but {here} is "
            "restoring it — a stale (pre-handover) checkpoint cannot change hosts; "
            "re-run the handover so the owner publishes a manifest-bearing barrier "
            "checkpoint"
        )
    if int(hand.get("to_process", -1)) != topo.process_index:
        raise ValueError(
            f"checkpoint {path} transfers group {hand.get('group')} to process "
            f"{hand.get('to_process')} (epoch {hand.get('topology_epoch')}), but {here} "
            "is restoring it"
        )
    if int(hand.get("group", -1)) != int(shard_group):
        raise ValueError(
            f"checkpoint {path} ownership-transfer manifest names group "
            f"{hand.get('group')} but this manager serves group {shard_group}"
        )
    if int(hand.get("topology_epoch", -1)) != topo.topology_epoch:
        raise ValueError(
            f"checkpoint {path} was handed over under topology epoch "
            f"{hand.get('topology_epoch')} but {here} — the checkpoint is stale "
            "relative to this rebalance (or this process never applied the move); "
            "publish a fresh handover barrier"
        )


def _sharded_payload(swm) -> tuple[list, dict, dict]:
    """Fold `swm`'s rings and copy its per-shard state to the host: →
    (held tier windows, meta, arrays), arrays [D]-leading in the
    reference's names and dtypes."""
    swm._fold()  # ring rows must reach the stash before the snapshot
    arrays = {
        "stash_packed": np.stack([_pack_stash(s) for s in swm.stash]),
        "dropped": np.array([int(s.dropped_overflow) for s in swm.stash], np.int32),
    }
    arrays.update(_sketch_arrays(swm.sketches))
    c = swm.pipe.config
    meta = {
        "version": _VERSION,
        "kind": "sharded",
        "num_tags": int(arrays["stash_packed"].shape[1]) - 4 - int(swm.stash[0].meters.shape[0]),
        "n_devices": swm.pipe.n_devices,
        "capacity_per_device": c.capacity_per_device,
        "interval": swm.interval,
        "delay": swm.delay,
        "fold_mode": c.fold_mode,
        "start_window": swm.start_window,
        "drop_before_window": swm.drop_before_window,
        "total_docs_in": swm.total_docs_in,
        "total_flushed": swm.total_flushed,
        "n_advances": swm.n_advances,
    }
    # the mesh topology this group was saved under, so a restore onto the
    # wrong host or topology fails at load
    topo = swm.pipe.topology
    if topo is not None:
        meta.update(topo.describe())
        meta["shard_group"] = swm.pipe.shard_group
    meta.update(_sketch_meta(swm.sketches, c.sketch_config()))
    meta["sketch_ring"] = c.sketch_ring
    in_flight: list = []
    if swm._tier_ratios:
        # held tier windows left the tier stashes: the caller emits them
        in_flight = swm.pop_tier_docbatches()
        swm.settle_tier_rings()
        c_meta, c_arrays = _cascade_save(
            CascadeConfig(intervals=swm._cascade_intervals, capacity=c.cascade_capacity),
            swm.tier_stashes, swm.tier_watermarks, swm.cascade_lanes,
            swm._tier_pending_blocks, swm.tier_windows_flushed, sharded=True)
        meta.update(c_meta)
        arrays.update(c_arrays)
    return in_flight, meta, arrays


def save_sharded_state(swm, path: str | Path, *, extra_meta=None) -> list:
    """Snapshot a ShardedWindowManager (kind="sharded", atomic +
    digested). Folds the accumulator rings first (sharded flushes are
    synchronous, so nothing else is deferred). Returns the held closed
    tier windows ((interval, DocBatch) pairs — not in the snapshot; the
    CALLER must emit them), [] without a cascade."""
    from ..utils.spans import SPAN_CHECKPOINT_SAVE

    with swm.tracer.span(SPAN_CHECKPOINT_SAVE):
        in_flight, meta, arrays = _sharded_payload(swm)
        if extra_meta:
            meta.update(extra_meta)
        _note_scratch(arrays)
        _write_checkpoint(path, meta, arrays)
    return in_flight


def _check_sharded_meta(meta: dict, swm, path) -> None:
    """Every loud refusal of a sharded restore: kind, shard count, mesh
    topology and group ownership, schema width, fold mode, capacity,
    window timing and sketch ring."""
    if meta.get("kind") != "sharded":
        raise ValueError(
            f"checkpoint {path} is kind={meta.get('kind')!r}, not a sharded checkpoint "
            "(load_window_state loads single-chip ones)"
        )
    if meta["n_devices"] != swm.pipe.n_devices:
        raise ValueError(
            f"checkpoint {path} was saved on {meta['n_devices']} devices; this mesh has "
            f"{swm.pipe.n_devices} — per-device stashes cannot be re-split"
        )
    topo = swm.pipe.topology
    ck_pc = meta.get("process_count")
    if topo is not None:
        topo.validate_restore(meta, path)
        ck_group = meta.get("shard_group")
        if ck_group is not None and int(ck_group) != swm.pipe.shard_group:
            raise ValueError(
                f"checkpoint {path} holds shard group {ck_group} but this manager serves "
                f"group {swm.pipe.shard_group} — restoring it here would serve another "
                "group's key-hash range"
            )
        _validate_ownership_transfer(meta, topo, swm.pipe.shard_group, path)
    elif ck_pc is not None and (int(ck_pc) > 1 or int(meta.get("n_groups", 1)) > 1):
        # one shard group's slice of a partitioned key space: a bare
        # manager would serve the FULL key range with that slice alone
        raise ValueError(
            f"checkpoint {path} was saved under a sharded mesh topology ({ck_pc} "
            f"process(es), {meta.get('n_groups')} shard groups); restoring into a "
            "topology-less manager would collapse the key-hash placement — build the "
            "pipeline from a MeshTopology (parallel/topology.py)"
        )
    t = TAG_SCHEMA.num_fields
    if meta["num_tags"] != t:
        raise ValueError(f"checkpoint tag schema width {meta['num_tags']} != {t}; "
                         "cannot unpack")
    if meta.get("fold_mode", "full") != swm.pipe.config.fold_mode:
        raise ValueError(
            f"checkpoint fold_mode={meta.get('fold_mode')!r} != pipeline "
            f"fold_mode={swm.pipe.config.fold_mode!r} — the stash layout contract "
            "differs between modes (canonical prefix vs holes)"
        )
    if meta["capacity_per_device"] != swm.pipe.config.capacity_per_device:
        raise ValueError(
            f"checkpoint capacity_per_device={meta['capacity_per_device']} != pipeline "
            f"{swm.pipe.config.capacity_per_device} — stash shape disagrees with the "
            "compiled config"
        )
    if meta["interval"] != swm.interval or meta["delay"] != swm.delay:
        raise ValueError(
            f"checkpoint window timing (interval={meta['interval']}, "
            f"delay={meta['delay']}) != manager (interval={swm.interval}, "
            f"delay={swm.delay}) — start_window/drop_before_window are window indices "
            "in units of interval and would be silently reinterpreted"
        )
    if "sketch_ring" in meta and meta["sketch_ring"] != swm.pipe.config.sketch_ring:
        raise ValueError(
            f"checkpoint sketch_ring={meta['sketch_ring']} != pipeline "
            f"sketch_ring={swm.pipe.config.sketch_ring} — per-window slot layout disagrees"
        )


def restore_sharded_state(swm, path: str | Path):
    """Load a sharded checkpoint (either package's) INTO a freshly built
    ShardedWindowManager — the caller builds the mesh. Every refusal of
    `_check_sharded_meta` is loud; each shard's slice is uploaded to its
    shard's device."""
    meta, arrays = _read_checkpoint(path)
    _check_version(meta, path)
    _check_sharded_meta(meta, swm, path)
    t = TAG_SCHEMA.num_fields
    devs = swm.pipe.devices
    c = swm.pipe.config
    swm.stash = [_unpack_stash(arrays["stash_packed"][k], arrays["dropped"][k], num_tags=t,
                               device=dev) for k, dev in enumerate(devs)]
    # a v2/v3 file carries no per-window planes: re-initialized, loudly
    swm.sketches = [_restore_sketch(meta, arrays, c.sketch_config(), c.sketch_ring, path, dev,
                                    shard=k) for k, dev in enumerate(devs)]
    if swm._tier_ratios:
        got = _restore_cascade_tiers(
            meta, arrays, CascadeConfig(intervals=swm._cascade_intervals,
                                        capacity=c.cascade_capacity),
            t, path, sketch_config=swm._sk_cfg, device=None, shards=devs)
        if got is not None:
            swm.tier_stashes, swm.tier_watermarks, swm.cascade_lanes, \
                swm._tier_pending_blocks = got
            # the rings settled at save: they restart empty (lazy re-init)
            swm.tier_accs = [None] * len(swm.tier_stashes)
            swm.tier_fills = [None] * len(swm.tier_stashes)
            swm.tier_windows_flushed = int(meta.get("cascade_tier_windows", 0))
            lanes = np.asarray(meta["cascade_lanes"], np.int64)
            swm.cascade_rows = int(lanes[:, 0].sum())
            swm.cascade_shed = int(lanes[:, 1].sum())
    swm.acc = None  # re-sized on the first batch after the restore
    swm.fill = 0
    swm._fold_rows_dev = None
    swm.start_window = meta["start_window"]
    swm.drop_before_window = meta["drop_before_window"]
    swm.total_docs_in = meta["total_docs_in"]
    swm.total_flushed = meta["total_flushed"]
    swm.n_advances = meta.get("n_advances", 0)
    return swm
