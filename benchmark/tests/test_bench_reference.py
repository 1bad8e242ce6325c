"""The benchmark's reference against the system under test, on the CPU
at a tiny size: every closed window, document for document, and every
sketch block."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import reference as R
from benchmark import sketch_ref
from benchmark.generators.flows import FlowStream
from benchmark.harness import build

from .conftest import tiny_spec


def _replay(spec, seed: int, batches: int):
    stream = FlowStream(spec.mix, seed, "cpu")
    pipe = build(spec.config["pipeline"], device="cpu")
    pool = [stream.host_batch(b) for b in range(stream.pool)]
    docs, blocks = {}, {}
    for k in range(batches):
        hb = pool[stream.pool_of(k)]
        hb.stamp(stream.time_of(k))
        for db in pipe.ingest_staged(pipe.stage(hb.as_input())):
            docs[int(db.timestamp[0])] = db
    for db in pipe.drain():
        docs[int(db.timestamp[0])] = db
    for blk in pipe.pop_closed_sketches():
        blocks[blk.window] = blk
    return stream, pipe, docs, blocks


LATE2 = [{"seconds": 1, "share": 0.1}, {"seconds": 2, "share": 0.1}]


@pytest.mark.parametrize("traffic,late", [("hicard", None), ("lowcard", None),
                                          ("hicard", LATE2)])
def test_every_window_equals_the_reference(traffic, late):
    mix = {"tuples": 3000 if traffic == "hicard" else 300}
    if late:
        mix["late"] = late
    spec = tiny_spec(f"exact.{traffic}", **mix)
    stream, pipe, docs, _ = _replay(spec, 2**31 + 7, 7)
    assert sorted(docs) == list(range(stream.start_time - stream.max_late,
                                      stream.start_time + 7))
    for w, db in docs.items():
        ref = R.rollup(R.window_parts(stream, w, 6))
        nums = R.compare_docs(torch.from_numpy(db.tags.astype(np.int64)),
                              torch.from_numpy(db.meters), ref)
        assert nums["docs_unmatched"] == 0 and nums["nonkey_mismatch"] == 0
        assert nums["max_mismatch"] == nums["sum_exact_mismatch"] == 0, nums
        assert nums["sum_rel_gap"] < 1e-6, nums
    c = pipe.counters
    assert c["prereduce_dropped"] == c["drop_overflow"] == c["drop_before_window"] == 0


def test_sketch_blocks_equal_the_reference():
    spec = tiny_spec("sketch.hicard")
    stream, _, docs, blocks = _replay(spec, 123456789012, 6)
    assert sorted(blocks) == sorted(docs)
    for w, blk in blocks.items():
        sketch = spec.config["pipeline"]["config"]["window"]["sketch"]
        nums = sketch_ref.compare_block(blk, sketch, R.window_parts(stream, w, 5))
        assert nums["hll_mismatch"] == nums["sk_updates_gap"] == 0, nums
        assert nums["topk_keys_unmatched"] == 0, nums
        assert nums["cms_rel_gap"] < 1e-6 and nums["topk_vote_gap"] < 1e-6, nums
        assert nums["hist_moved_gap"] == 0.0, nums


def test_compare_docs_sees_a_missing_extra_and_altered_document():
    spec = tiny_spec("exact.hicard")
    stream = FlowStream(spec.mix, 5, "cpu")
    w = stream.start_time + 1
    ref = R.rollup(R.window_parts(stream, w, 4))
    tags, meters = ref.tags.clone(), ref.meters.float().clone()
    assert R.compare_docs(tags, meters, ref)["docs_unmatched"] == 0
    assert R.compare_docs(tags[1:], meters[1:], ref)["docs_unmatched"] == 1
    assert R.compare_docs(torch.cat([tags, tags[:1]]), torch.cat([meters, meters[:1]]),
                          ref)["docs_unmatched"] == 1
    meters[3, 0] += 1
    assert R.compare_docs(tags, meters, ref)["sum_exact_mismatch"] == 1


def test_window_schedule_closes_one_window_per_second():
    sched = R.window_schedule([(99, 100), (100, 101), (101, 102), (102, 103)], delay=2)
    assert [s["closes"] for s in sched] == [None, (98, 99), (99, 100), (100, 101)]
    assert [s["gate"] for s in sched] == [0, 98, 99, 100]
