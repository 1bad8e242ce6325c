"""Port parity for the incremental merge fold (fold_mode="merge").

The same seeded numpy inputs go through the JAX package (CPU backend)
and the port on the CPU, and must come out bit-equal:

  * the rank-merge ops — `lex_searchsorted` (ties, both sides, no key),
    `merge_ranks` and `merge_order` (the reference's sort and scatter
    forms, DEEPFLOW_MERGE_SCATTER=0/1);
  * `_merge_fold_impl`, full and span-bounded, every stash lane (dead
    tail included) and the ring it leaves, also against the port's own
    full fold; `stash_canonicalize`; the compacting range flush;
  * `WindowManager(fold_mode="merge")`: flushed windows and counter
    blocks equal to the reference's merge mode, windows equal to the
    port's full mode; `make_ingest_step(fold_mode="merge")` cycles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator import pipeline as ref_pipeline
from deepflow_tpu.aggregator import stash as ref_stash
from deepflow_tpu.aggregator import window as ref_window
from deepflow_tpu.aggregator.fanout import FANOUT_LANES
from deepflow_tpu.aggregator.fanout import FanoutConfig as RefFanoutConfig
from deepflow_tpu.datamodel import schema as ref_schema
from deepflow_tpu.ingest.replay import SyntheticFlowGen as RefFlowGen
from deepflow_tpu.ops import segment as ref_segment
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.aggregator import pipeline, stash, window
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
from deepflow_tpu_torch.datamodel import schema
from deepflow_tpu_torch.ops import segment
from deepflow_tpu_torch.ops.u32 import from_numpy_u32

torch.set_num_threads(1)

SENT = np.uint32(0xFFFFFFFF)
T0 = 1_700_000_000


def _tiny(mod):
    """The reference merge-fold tests' 2-tag / 3-meter schemas, built
    from `mod` (the reference's schema module or the port's)."""
    meters = mod.MeterSchema("tiny", (mod.MeterField("a", mod.MergeOp.SUM),
                                      mod.MeterField("b", mod.MergeOp.SUM),
                                      mod.MeterField("mx", mod.MergeOp.MAX)))
    return mod.TagSchema((mod.TagField("k1"), mod.TagField("k2"))), meters


REF_TAGS, REF_METER = _tiny(ref_schema)
TAGS, METER = _tiny(schema)


def _u32(x):
    return from_numpy_u32(x, "cpu")


# ---------------------------------------------------------------------------
# rank-merge ops


def _sorted_triples(rng, n, span):
    """n lexicographically sorted (slot, hi, lo) u32 triples with ties."""
    t = rng.integers(0, span, (n, 3)).astype(np.uint32)
    t[:, 1] *= np.uint32(0x9E3779B1)  # values past 2^31
    t = t[np.lexsort((t[:, 2], t[:, 1], t[:, 0]))]
    return tuple(t[:, i].copy() for i in range(3))


@pytest.mark.parametrize("n,q", [(0, 7), (1, 5), (37, 64), (256, 3)])
@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_searchsorted_bit_equal(n, q, side):
    rng = np.random.default_rng(n + q)
    keys = _sorted_triples(rng, n, 4)
    queries = tuple(rng.integers(0, 4, q).astype(np.uint32) * m
                    for m in (1, np.uint32(0x9E3779B1), 1))
    if n:  # exact ties with keys
        for lane, k in zip(queries, keys):
            lane[: min(q, n)] = k[: min(q, n)]
    want = np.asarray(ref_segment.lex_searchsorted(
        tuple(map(jnp.asarray, keys)), tuple(map(jnp.asarray, queries)), side=side))
    got = segment.lex_searchsorted(tuple(map(_u32, keys)), tuple(map(_u32, queries)),
                                   side=side)
    np.testing.assert_array_equal(want, got.numpy())
    with pytest.raises(ValueError, match="side"):
        segment.lex_searchsorted(tuple(map(_u32, keys)), tuple(map(_u32, queries)),
                                 side="middle")


@pytest.mark.parametrize("scatter", ["0", "1"])
@pytest.mark.parametrize("nf,ns", [(40, 25), (0, 9), (9, 0)])
def test_merge_ranks_and_order_bit_equal(monkeypatch, scatter, nf, ns):
    """The port's one-scatter order equals the reference's order in
    both of its forms (a single-key sort, or the scatter)."""
    monkeypatch.setenv("DEEPFLOW_MERGE_SCATTER", scatter)
    rng = np.random.default_rng(nf * 7 + ns)
    first, second = _sorted_triples(rng, nf, 5), _sorted_triples(rng, ns, 5)
    r_f, r_s = ref_segment.merge_ranks(tuple(map(jnp.asarray, first)),
                                       tuple(map(jnp.asarray, second)))
    p_f, p_s = segment.merge_ranks(tuple(map(_u32, first)), tuple(map(_u32, second)))
    np.testing.assert_array_equal(np.asarray(r_f), p_f.numpy())
    np.testing.assert_array_equal(np.asarray(r_s), p_s.numpy())
    assert sorted(np.concatenate([p_f.numpy(), p_s.numpy()]).tolist()) == list(range(nf + ns))
    pay_f = np.arange(nf, dtype=np.int32)
    pay_s = rng.permutation(ns).astype(np.int32) + nf
    want = ref_segment.merge_order(r_f, r_s, jnp.asarray(pay_f), jnp.asarray(pay_s))
    got = segment.merge_order(p_f, p_s, torch.from_numpy(pay_f), torch.from_numpy(pay_s))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# stash level (the generators of tests/test_merge_fold.py)


def _rand_acc(rng, cap, fill, n_windows=5, n_keys=8) -> dict:
    """A ring of `fill` rows as numpy: random (window, key) pairs,
    non-trivial float bits, ~20% sentinel-invalid rows."""
    slot = np.full(cap, SENT, np.uint32)
    hi, lo = np.zeros(cap, np.uint32), np.zeros(cap, np.uint32)
    tags = np.zeros((2, cap), np.uint32)
    met = np.zeros((3, cap), np.float32)
    if fill:
        k = rng.integers(0, n_keys, fill).astype(np.uint32)
        slot[:fill] = rng.integers(1, 1 + n_windows, fill).astype(np.uint32)
        hi[:fill], lo[:fill] = k, k * 7 + 1
        tags[:, :fill] = np.stack([k, k + 13])
        met[:, :fill] = rng.normal(size=(3, fill)).astype(np.float32)
        slot[:fill][rng.random(fill) < 0.2] = SENT
    return dict(slot=slot, key_hi=hi, key_lo=lo, tags=tags, meters=met)


def _ref_acc(d):
    return ref_stash.AccumState(**{k: jnp.asarray(v) for k, v in d.items()})


def _np_state(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _assert_stash_equal(ref_state, port_state, msg=""):
    got = (convert.stash_to_numpy if isinstance(port_state, stash.StashState)
           else convert.accum_to_numpy)(port_state)
    for k, v in _np_state(ref_state).items():
        if v.dtype == np.float32:
            v, got[k] = v.view(np.uint32), got[k].view(np.uint32)
        np.testing.assert_array_equal(v, got[k], err_msg=f"{msg} {k}")


def _canonical_pair(rng, scap, acap, fill):
    """A canonical stash (one random ring folded in) on both sides."""
    r_state, _ = ref_stash.stash_fold(ref_stash.stash_init(scap, REF_TAGS, REF_METER),
                                      _ref_acc(_rand_acc(rng, acap, fill)), REF_METER)
    return r_state, convert.stash_from_numpy(_np_state(r_state), device="cpu")


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("span", [False, True], ids=["full", "span"])
def test_merge_fold_bit_equal(seed, span):
    """`_merge_fold_impl` equals the reference's (stash lanes with the
    dead tail, the ring it leaves, fold_rows) and the port's full fold of
    the in-span rows; small stashes overflow on some seeds."""
    rng = np.random.default_rng(100 + seed)
    scap, acap = (12, 32) if seed % 2 else (40, 24)  # two shapes: one compile each
    r_state, state = _canonical_pair(rng, scap, acap, int(rng.integers(0, acap + 1)))
    d = _rand_acc(rng, acap, int(rng.integers(0, acap + 1)))
    hi = int(rng.integers(1, 7)) if span else None
    before = _np_state(r_state)  # the reference donates its stash
    r_new, r_acc, r_rows = ref_stash.stash_merge_fold(r_state, _ref_acc(d), REF_METER,
                                                      hi_window=hi)
    acc = convert.accum_from_numpy(d, device="cpu")
    new, acc, rows = stash.stash_merge_fold(state, acc, METER, hi_window=hi)
    _assert_stash_equal(r_new, new, "merge fold")
    _assert_stash_equal(r_acc, acc, "ring after")
    assert int(r_rows) == int(rows)
    # the port's own full fold over the in-span rows gives the same stash
    sl = d["slot"] if hi is None else np.where(d["slot"] < hi, d["slot"], SENT)
    full, _, _ = stash.stash_fold_counted(
        convert.stash_from_numpy(before, device="cpu"),
        convert.accum_from_numpy({**d, "slot": sl.astype(np.uint32)}, device="cpu"), METER)
    _assert_stash_equal(r_new, full, "port full fold")


def test_stash_canonicalize_and_compact_flush_bit_equal():
    """Canonicalize a stash with holes punched mid-prefix, then a
    compacting range flush of it: both bit-equal to the reference, the
    flushed rows equal to the plain flush's, live rows a sorted prefix,
    and a merge fold on top still equal to the reference."""
    rng = np.random.default_rng(3)
    r_state, _ = _canonical_pair(rng, 64, 64, 56)
    d = {k: v.copy() for k, v in _np_state(r_state).items()}
    holes = np.flatnonzero(d["valid"])[1:6]
    d["slot"][holes], d["valid"][holes] = SENT, False
    r_fixed = ref_stash.stash_canonicalize(
        ref_stash.StashState(**{k: jnp.asarray(v) for k, v in d.items()}))
    fixed = stash.stash_canonicalize(convert.stash_from_numpy(d, device="cpu"))
    _assert_stash_equal(r_fixed, fixed, "canonicalize")
    hi_w = 3
    r_c, r_packed, r_total = ref_stash.stash_flush_range(
        r_fixed, np.uint32(0), np.uint32(hi_w), compact=True)
    c, packed, total = stash._flush_range_impl(fixed, 0, hi_w, compact=True)
    _, plain_packed, plain_total = stash._flush_range_impl(fixed, 0, hi_w)
    _assert_stash_equal(r_c, c, "compact flush")
    assert int(r_total) == int(total) == int(plain_total) > 0
    np.testing.assert_array_equal(np.asarray(r_packed)[: int(total)].view(np.int32),
                                  packed[: int(total)].numpy())
    assert torch.equal(packed[: int(total)], plain_packed[: int(total)])
    v = c.valid.numpy()
    live = int(v.sum())
    assert v[:live].all() and not v[live:].any()
    keys = list(zip(*(getattr(c, k)[:live].tolist() for k in ("slot", "key_hi", "key_lo"))))
    assert keys == sorted(keys)
    acc = _rand_acc(rng, 40, 33)
    r_new, _, _ = ref_stash.stash_merge_fold(r_c, _ref_acc(acc), REF_METER)
    new, _, _ = stash.stash_merge_fold(c, convert.accum_from_numpy(acc, device="cpu"), METER)
    _assert_stash_equal(r_new, new, "merge after compact")


# ---------------------------------------------------------------------------
# WindowManager and make_ingest_step


def _mgr_batch(ts, keys):
    hi = np.asarray(keys, np.uint32)
    n = len(hi)
    tags = np.stack([hi, hi + 1]).astype(np.uint32)
    meters = np.arange(3 * n, dtype=np.float32).reshape(3, n) * 0.25 + hi[None, :]
    return (np.asarray(ts, np.uint32), hi, hi * np.uint32(3) + np.uint32(1), tags, meters,
            np.ones(n, bool))


def _record_blocks(wm) -> list:
    blocks, process = [], wm._process_block

    def record(vec):
        blocks.append([int(v) for v in vec])
        process(vec)

    wm._process_block = record
    return blocks


def _flushed_key(flushed):
    return [(f.window_idx, f.count, np.asarray(f.key_hi).tolist(),
             np.asarray(f.key_lo).tolist(), np.asarray(f.tags).tolist(),
             np.asarray(f.meters).view(np.uint32).tolist()) for f in flushed]


# lanes whose values depend on the fold mode: occupancy and ring fill at
# dispatch (merge mode keeps open windows' rows in the ring), fold_rows
MODE_LANES = (window.CB_STASH_OCCUPANCY, window.CB_RING_FILL, window.CB_FOLD_ROWS)


@pytest.mark.parametrize("seed", range(2))
def test_window_manager_merge_mode_bit_equal(seed):
    """The stream of the reference's merge-vs-full fuzz (late rows,
    multi-window batches, a batch larger than the ring forcing a
    re-init): the port's merge mode gives the reference merge mode's
    windows and counter blocks, and its own full mode's windows."""
    rng = np.random.default_rng(19 + seed)
    cfg = dict(interval=1, delay=2, capacity=256, accum_batches=4)
    ref = ref_window.WindowManager(ref_window.WindowConfig(fold_mode="merge", **cfg),
                                   REF_TAGS, REF_METER)
    ports = {m: window.WindowManager(window.WindowConfig(fold_mode=m, **cfg), TAGS, METER,
                                     device="cpu") for m in ("merge", "full")}
    r_blocks = _record_blocks(ref)
    p_blocks = {m: _record_blocks(wm) for m, wm in ports.items()}
    got = {m: [] for m in ("ref", "merge", "full")}
    t = 100 + seed
    for step in range(12):
        t += int(rng.integers(0, 3))
        n = 40 if step == 7 else int(rng.integers(1, 14))
        ts = np.maximum(t + rng.integers(-3, 2, n), 0)
        b = _mgr_batch(ts, rng.integers(0, 10, n))
        got["ref"] += ref.ingest(*(jnp.asarray(x) for x in b))
        for m, wm in ports.items():
            got[m] += wm.ingest(*(_u32(x) for x in b[:4]), torch.from_numpy(b[4]),
                                torch.from_numpy(b[5]))
    got["ref"] += ref.flush_all()
    for m, wm in ports.items():
        got[m] += wm.flush_all()
    assert got["ref"]
    assert _flushed_key(got["merge"]) == _flushed_key(got["ref"]) == _flushed_key(got["full"])
    assert p_blocks["merge"] == r_blocks
    strip = lambda bl: [[v for i, v in enumerate(b) if i not in MODE_LANES] for b in bl]
    assert strip(p_blocks["full"]) == strip(p_blocks["merge"])
    for key in ("doc_in", "flushed_doc", "drop_before_window", "fold_rows",
                "window_advances"):
        assert ref.get_counters()[key] == ports["merge"].get_counters()[key], key
    for wm in ports.values():
        assert wm.counters["occupancy"] == 0


def test_window_manager_merge_mode_span_fold_leaves_open_rows():
    """An advance in merge mode folds only the closing span: the ring
    keeps the open windows' rows (fill not reset) and the fold_rows lane
    counts the closing span's rows only — as in the reference."""
    cfg = dict(interval=1, delay=3, capacity=512)
    ref = ref_window.WindowManager(ref_window.WindowConfig(fold_mode="merge", **cfg),
                                   REF_TAGS, REF_METER)
    port = window.WindowManager(window.WindowConfig(fold_mode="merge", **cfg), TAGS, METER,
                                device="cpu")
    batches = [_mgr_batch([1000 + i] * 20, range(20 * i, 20 * i + 20)) for i in range(4)]
    batches += [_mgr_batch([1006], [999]), _mgr_batch([1006], [998])]
    for b in batches:
        ref.ingest(*(jnp.asarray(x) for x in b))
        port.ingest(*(_u32(x) for x in b[:4]), torch.from_numpy(b[4]), torch.from_numpy(b[5]))
    assert port.fill == ref.fill > 0
    assert port.get_counters()["fold_rows"] == ref.get_counters()["fold_rows"] == 60
    _assert_stash_equal(ref.state, port.state, "stash")
    _assert_stash_equal(ref.acc, port.acc, "ring")


def test_ingest_step_merge_cycles_bit_equal():
    """bench.py-style (append ×2, fold) cycles through
    make_ingest_step(fold_mode="merge"), overflowing a small stash."""
    batch, accum, cap_u, capacity = 512, 2, 384, 1024
    stride = FANOUT_LANES * cap_u
    r_append, r_fold = ref_pipeline.make_ingest_step(
        RefFanoutConfig(), interval=1, batch_unique_cap=cap_u, fold_mode="merge")
    r_append, r_fold = jax.jit(r_append), jax.jit(r_fold)
    append, fold = pipeline.make_ingest_step(FanoutConfig(), interval=1,
                                             batch_unique_cap=cap_u, fold_mode="merge",
                                             device="cpu")
    _, full_fold = pipeline.make_ingest_step(FanoutConfig(), interval=1,
                                             batch_unique_cap=cap_u, device="cpu")
    r_state = ref_stash.stash_init(capacity, ref_schema.TAG_SCHEMA, ref_schema.FLOW_METER)
    r_acc = ref_stash.accum_init(accum * stride, ref_schema.TAG_SCHEMA, ref_schema.FLOW_METER)
    state = stash.stash_init(capacity, schema.TAG_SCHEMA, schema.FLOW_METER, device="cpu")
    acc = stash.accum_init(accum * stride, schema.TAG_SCHEMA, schema.FLOW_METER, device="cpu")
    gen = RefFlowGen(num_tuples=300, seed=5)
    for cycle in range(2):
        for k in range(accum):
            fb = gen.flow_batch(batch, T0 + cycle)
            r_state, r_acc = r_append(r_state, r_acc, jnp.int32(k * stride),
                                      {n: jnp.asarray(v) for n, v in fb.tags.items()},
                                      jnp.asarray(fb.meters), jnp.asarray(fb.valid))
            state, acc = append(state, acc, k * stride, fb.tags, fb.meters, fb.valid)
        full, _ = full_fold(convert.stash_from_numpy(_np_state(r_state), device="cpu"),
                            convert.accum_from_numpy(_np_state(r_acc), device="cpu"))
        r_state, r_acc = r_fold(r_state, r_acc)
        state, acc = fold(state, acc)
        _assert_stash_equal(r_state, state, f"cycle {cycle}")
        _assert_stash_equal(r_acc, acc, f"cycle {cycle} ring")
        _assert_stash_equal(r_state, full, f"cycle {cycle} port full fold")
    assert int(state.dropped_overflow) > 0
    with pytest.raises(ValueError, match="fold_mode"):
        pipeline.make_ingest_step(FanoutConfig(), fold_mode="ring", device="cpu")
