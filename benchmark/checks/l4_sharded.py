"""The comparison that decides a run's `correct` for the sharded rollup
(`deepflow_tpu_torch.parallel.sharded.ShardedL4Pipeline`) over a mix of
the `card_flows` generator, whose cards hold disjoint flows and clients
but share servers.

The same numbers as `l4_rollup`, by its comparisons, with the
configuration's reading of "what one card would give on all records"
(its `four_cards_as_one` guarantee, DeepFlow's querier over several
ingesters' rows):

  * documents: each card gives the exact rollup of its own records, so
    a server-side key on several cards is one row a card. The window's
    rows, summed per key (SUM meters added, MAX meters maxed), are held
    to the reference over all the cards' records, which is the cards'
    references (`reference.rollup` of each card's records, computed a
    card at a time) summed per key: keys, maxima and whole-number sums
    are the same in any grouping. `nonkey_mismatch` counts the rows
    whose tags, key and non-key columns together, have no partner among
    the cards' reference rows: each row carries its own card's first
    document's non-key tags, and a key has one row on each card that
    saw it;
  * sketch blocks: HLL registers merged by max, count-min counters and
    histogram bins by sum over the cards' own references (equal to the
    reference over all records, since no client and no flow key spans
    two cards), and the top-K candidates against the union of the
    cards' reference candidates, the configuration's merge rule;
  * counters: summed over the cards, each card's pre-reduce held to its
    own `batch_unique_cap`; the stash and the late gate shed nothing.
"""

from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import reference as R
from .. import sketch_ref
from .. import work as W
from ..u32 import MASK
from . import l4_rollup as base

settings = base.settings


def collect(run) -> None:
    """`l4_rollup.collect` (the closed windows' sketch blocks), and each
    card's peak device memory so far: after the drain it is the run's,
    read before the reference takes card 0's memory."""
    base.collect(run)
    if run.cuda:
        run.card_peaks = [torch.cuda.max_memory_allocated(d) for d in run.pipe.devices]


def cards_of(run) -> list:
    """Each card's slice of the run's records as a stream of its own: on
    a run over CUDA cards, each on its own card (the pipeline is freed
    by then), so the cards' references run side by side; else the run's
    stream's slices."""
    if getattr(run, "_cards", None) is None:
        stream = run.stream
        n = stream.cards
        if run.cuda and torch.cuda.device_count() >= n:
            run._cards = [type(stream)(stream.mix, stream.seed, torch.device("cuda", c)).card(c)
                          for c in range(n)]
        else:
            run._cards = [stream.card(c) for c in range(n)]
    return run._cards


def per_card(cards: list, fn) -> list:
    """fn(card) for every card, in card order: one thread a card where
    the cards are on distinct devices, one after another otherwise."""
    if len({str(c.device) for c in cards}) < len(cards):
        return [fn(c) for c in cards]
    with ThreadPoolExecutor(len(cards)) as ex:
        return list(ex.map(fn, cards))


def batch_facts(run) -> list[dict]:
    """Per pool batch: valid document rows after each card's pre-reduce
    (summed), distinct raw records on each card, and the largest
    lateness of its records."""
    if getattr(run, "_facts", None) is None:
        pool = run.stream.pool

        def facts_of(card):
            return [(*R.docs_of_batch(card, b), int(card.batch(b)[2].max())) for b in range(pool)]

        per = per_card(cards_of(run), facts_of)
        run._facts = [{"docs": sum(p[b][0] for p in per), "raw": [p[b][1] for p in per],
                       "late": max(p[b][2] for p in per)} for b in range(pool)]
    return run._facts


def expected_counters(run, window_docs) -> dict:
    """The counter values the replayed records imply, summed over cards
    (None where the reference cannot state one)."""
    stream = run.stream
    pipe, window, sketch = settings(run.spec.config)
    facts = batch_facts(run)
    per = [facts[stream.pool_of(k)] for k in range(run.k)]
    interval, delay = window["interval"], window["delay"]
    bounds = [(stream.time_of(k) - f["late"], stream.time_of(k)) for k, f in enumerate(per)]
    late_free = all(b[0] // interval >= s["gate"]
                    for b, s in zip(bounds, R.window_schedule(bounds, delay, interval)))
    cap_u = int(pipe["batch_unique_cap"])
    out = {
        "doc_in": sum(f["docs"] for f in per),
        "flushed_doc": sum(window_docs.values()),
        "drop_before_window": 0 if late_free else None,
        "prereduce_dropped": sum(max(0, r - cap_u) for f in per for r in f["raw"]),
        # the configuration's guarantee: no card's stash sheds a row
        "drop_overflow": 0,
        "stash_evictions": 0,
    }
    if sketch:
        out["sketch_rows"] = sum(sum(f["raw"]) for f in per)
        out["sketch_shed"] = 0
    return out


def traced_work(run) -> dict:
    """Least device seconds of each traced kernel call, per operation,
    as `l4_rollup.traced_work` counts them, on every card: per call,
    each card's pre-reduce of its slice, then each card's fold, and with
    the sketch plane each card's two fused sketch updates (the closing
    phase, with no rows in this replay, then its slice's rows). The
    manager reports a fold's rows and the stashes' occupancy summed over
    the cards, and it reads them at the call's own drain (no lag of one
    call); so the four folds' work is counted as one sum and split
    evenly over their launches. The roofline reads only the sum, which
    is exact while every card's fold is bound by memory bandwidth (its
    bytes over the card's bandwidth exceed its flops over the card's
    peak, by far at 61 meters)."""
    if getattr(run, "_work", None) is not None:
        return run._work
    facts = batch_facts(run)
    pipe, window, sketch = settings(run.spec.config)
    ctx, stream = run.ctx, run.stream
    n_cards, m = stream.cards, len(R.S.METER_NAMES)
    cap_u, cap = int(pipe["batch_unique_cap"]), int(window["capacity"])
    ring = window["delay"] // window["interval"] + 2
    sk_cells = None
    if sketch:
        sk_cells = per_card(cards_of(run), lambda card: [
            sketch_ref.touched_cells(card, b, sketch) for b in range(stream.pool)])
    seg, skf = [], []
    for i, call in enumerate(ctx.traced):
        b = call["pool_batch"]
        for raw in facts[b]["raw"]:
            seg.append(W.least_seconds(W.segreduce_bytes(stream.card_rows, m, cap_u, raw),
                                       W.segreduce_flops(stream.card_rows, m)))
        if i + 1 < len(ctx.occupancy):
            n_live = ctx.fold_rows[i]
            live = ctx.occupancy[i + 1] + call["flushed"]
            nbytes = (W.segreduce_bytes(n_live, m, cap, live)
                      + (n_cards - 1) * W.segreduce_bytes(0, m, cap, 0))
            least = W.least_seconds(nbytes, W.segreduce_flops(n_live, m))
            seg += [least / n_cards] * n_cards
        else:
            seg += [None] * n_cards
        if sk_cells is not None:
            for c in range(n_cards):
                hll, cms = sk_cells[c][b]
                skf.append(W.least_seconds(W.sketch_fused_bytes(
                    0, ring, sketch["topk_rows"], sketch["topk_cols"], 0, 0)))
                skf.append(W.least_seconds(W.sketch_fused_bytes(
                    facts[b]["raw"][c], ring, sketch["topk_rows"], sketch["topk_cols"], hll,
                    cms)))
    run._work = {"segreduce": seg, "sketch_fused": skf if sk_cells is not None else None}
    return run._work


def card_window(card, w: int, last: int, cfg: dict | None):
    """One card's reference of window w: its documents, and its sketch
    block (None without a sketch configuration)."""
    parts = R.window_parts(card, w, last)
    if not parts:
        return None, None
    return R.rollup(parts), (sketch_ref.window_sketch(parts, cfg) if cfg else None)


def per_key(tags: torch.Tensor, meters: torch.Tensor) -> R.WindowDocs:
    """Rows summed per document key as the querier reads them: SUM
    meters added and MAX meters maxed in float64, the tags of the key's
    first row."""
    keys, inv = torch.unique(tags[:, list(R.S.DOC_KEY_INDEX)], dim=0, return_inverse=True)
    g, n, dev = keys.shape[0], tags.shape[0], tags.device
    meters = meters.to(torch.float64)
    first = torch.full((g,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, inv, torch.arange(n, device=dev), "amin")
    out = torch.zeros((g, meters.shape[1]), dtype=torch.float64, device=dev)
    sums = list(R.S.METER_SUM)
    out[:, sums] = out[:, sums].index_add(0, inv, meters[:, sums])
    for c in R.S.METER_MAX:
        out[:, c] = out[:, c].scatter_reduce(0, inv, meters[:, c], "amax", include_self=False)
    return R.WindowDocs(tags=tags[first], meters=out)


def unpartnered_rows(a: torch.Tensor, b: torch.Tensor) -> int:
    """Rows of [n, D] `a` and [m, D] `b` left over when each row of one
    is paired with an equal row of the other."""
    rows, inv = torch.unique(torch.cat([a, b]), dim=0, return_inverse=True)
    na = torch.bincount(inv[:a.shape[0]], minlength=rows.shape[0])
    nb = torch.bincount(inv[a.shape[0]:], minlength=rows.shape[0])
    return int((na - nb).abs().sum())


def compare_window(tags: torch.Tensor, meters: torch.Tensor, refs: list) -> tuple[dict, int]:
    """One window's rows ([n, D] int64 tags, [n, M] meters) against the
    cards' reference documents `refs` (None for a card without records
    in the window): `compare_docs`'s numbers of the rows summed per key
    against the references summed per key, with `nonkey_mismatch` the
    rows without a partner among the references' rows. Also returns the
    number of document keys on more than one card."""
    refs = [r for r in refs if r is not None]
    if not refs:
        return {"docs_unmatched": tags.shape[0], "nonkey_mismatch": tags.shape[0],
                "max_mismatch": 0, "sum_exact_mismatch": 0, "sum_rel_gap": 0.0}, 0
    dev = refs[0].tags.device
    r_tags = torch.cat([r.tags.to(dev) for r in refs])
    r_meters = torch.cat([r.meters.to(dev) for r in refs])
    whole = per_key(r_tags, r_meters)
    tags = tags.to(dev, torch.int64)
    mine = per_key(tags, meters.to(dev))
    out = R.compare_docs(mine.tags, mine.meters, whole)
    out["nonkey_mismatch"] = unpartnered_rows(tags, r_tags)
    return out, r_tags.shape[0] - whole.tags.shape[0]


def merged_sketch(refs: list) -> dict:
    """The cards' reference blocks of one window merged by the
    configuration's rule: registers by max, counters and bins by sum,
    the top-K candidates (hi, lo, votes) as the union."""
    refs = [r for r in refs if r is not None]
    cands = []
    for r in refs:
        live = r["votes"] > 0
        cands += zip(r["tk"][0][live].tolist(), r["tk"][1][live].tolist(),
                     r["votes"][live].tolist())
    return {
        "n_updates": sum(r["n_updates"] for r in refs),
        "hll": np.maximum.reduce([r["hll"].cpu().numpy() for r in refs]),
        "cms": sum(r["cms"].cpu().numpy() for r in refs),
        "hist": sum(r["hist"].cpu().numpy() for r in refs),
        "candidates": sorted(cands),
        # clients never span cards (card_flows), so the exact counts add
        "distinct_exact": sum(r["distinct_exact"] for r in refs),
    }


def compare_block(block, ref: dict) -> dict:
    """`sketch_ref.compare_block`'s numbers of one window's merged block
    against the merged reference; a missing block fails every number."""
    if block is None:
        return {"sk_updates_gap": ref["n_updates"], "hll_mismatch": ref["hll"].size,
                "cms_rel_gap": 1.0, "hist_moved_gap": 1.0, "topk_keys_unmatched": 1,
                "topk_vote_gap": 1.0, "distinct_rel_gap": 1.0}
    cms, hst = ref["cms"], ref["hist"]
    diff = (np.asarray(block.cms, dtype=np.int64) - cms) & MASK
    diff = np.where(diff >= 2**31, diff - 2**32, diff)
    r_keys = ref["candidates"]
    p_keys = sorted(zip(np.asarray(block.tk_hi, np.int64).tolist(),
                        np.asarray(block.tk_lo, np.int64).tolist(),
                        np.asarray(block.tk_votes, np.int64).tolist()))
    rk = [(a, b) for a, b, _ in r_keys]
    pk = [(a, b) for a, b, _ in p_keys]
    unmatched = sum(1 for k in set(rk) | set(pk) if rk.count(k) != pk.count(k))
    vmax = max([v for _, _, v in r_keys] + [1])
    vote_gap = (max(abs(a[2] - b[2]) for a, b in zip(r_keys, p_keys)) / vmax
                if not unmatched and r_keys else (0.0 if not unmatched else 1.0))
    exact = max(ref["distinct_exact"], 1)
    return {
        "sk_updates_gap": abs(int(block.n_updates) - ref["n_updates"]),
        "hll_mismatch": int((np.asarray(block.hll) != ref["hll"]).sum()),
        "cms_rel_gap": float((np.abs(diff) / np.maximum(cms, 1)).max()),
        "hist_moved_gap": float(np.abs(np.asarray(block.hist) - hst).sum())
        / max(2.0 * hst.sum(), 1.0),
        "topk_keys_unmatched": unmatched,
        "topk_vote_gap": float(vote_gap),
        "distinct_rel_gap": abs(block.distinct() - exact) / exact,
    }


def all_window_docs(run, counted: dict) -> dict:
    """`l4_rollup.all_window_docs` with the reference a card at a time:
    the document count of every window the replay filled."""
    stream = run.stream
    t0, last = stream.start_time, run.k - 1
    out = {}
    for w in range(t0 - stream.max_late, t0 + last + 1):
        key = base._window_key(stream, w, last)
        if key not in counted:
            counted[key] = sum(per_card(cards_of(run), lambda card: sum(
                R.rollup(parts).tags.shape[0] for parts in [R.window_parts(card, w, last)]
                if parts)))
        out[w] = counted[key]
    return out


def check_run(run) -> dict:
    """Compare the run's output with the reference; returns {"correct",
    "checks": {name: {"value", "limit"}}, "windows": compared ids}."""
    stream = run.stream
    last = run.k - 1
    t0 = stream.start_time
    _, window, sketch = settings(run.spec.config)
    interval = window["interval"]
    numbers = {"docs_unmatched": 0, "nonkey_mismatch": 0, "max_mismatch": 0,
               "sum_exact_mismatch": 0, "sum_rel_gap": 0.0}
    shared = 0
    counted = {}
    drained = {ts // interval: db for ts, db in run.drained}
    compared = [(ts // interval, db) for ts, db in run.sample]
    # every window open at the end must come out of drain()
    for w in range(max(t0 - stream.max_late, t0 + last - window["delay"]), t0 + last + 1):
        compared.append((w, drained.pop(w, None)))
    numbers["docs_unmatched"] += sum(db.size for db in drained.values())
    cards = cards_of(run)
    for w, db in compared:
        refs = per_card(cards, lambda card: card_window(card, w, last, sketch))
        docs = [d for d, _ in refs]
        counted[base._window_key(stream, w, last)] = sum(
            d.tags.shape[0] for d in docs if d is not None)
        if db is None:
            numbers["docs_unmatched"] += counted[base._window_key(stream, w, last)]
        else:
            got, on_several = compare_window(torch.from_numpy(db.tags.astype(np.int64)),
                                             torch.from_numpy(np.ascontiguousarray(db.meters)),
                                             docs)
            base._merge(numbers, got)
            shared += on_several
        if sketch:
            base._merge(numbers, compare_block(run.blocks.get(w),
                                               merged_sketch([k for _, k in refs])))
        del docs, refs
    print(f"document keys on more than one card, over the compared windows: {shared}",
          file=sys.stderr)
    numbers["windows_missing"] = abs(run.ctx.calls - len(run.ctx.close_ms))
    window_docs = all_window_docs(run, counted)
    for name, want in expected_counters(run, window_docs).items():
        got = run.counters.get(name)
        numbers[f"{name}_gap"] = (abs(int(got) - int(want))
                                  if want is not None and got is not None else -1)
    limits = run.spec.config.get("limits", {})
    checks = {}
    correct = True
    for name, value in numbers.items():
        limit = limits.get(name, 0)
        ok = 0 <= value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    return {"correct": correct, "checks": checks, "windows": [w for w, _ in compared]}
