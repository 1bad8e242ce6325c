"""The comparison comes out false when the timed path is broken
underneath, and for the control: a whole run of a tiny cell on the CPU
(the harness's look for a card skipped), once per fault the cells can
have. A fault of the exchange between cards does not apply: every cell
runs on one card."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import control, harness as H
from benchmark.generators.flows import FlowStream

from .conftest import tiny_spec


def _run(workload="exact.hicard", **mix):
    return H.run_cell(tiny_spec(workload, **mix), 2**31 + 5, 0.3, False, "cpu")


@pytest.mark.parametrize("late", [None, [{"seconds": 1, "share": 0.1},
                                         {"seconds": 2, "share": 0.1}]])
def test_a_sound_run_is_correct(late):
    res = _run(**({"late": late} if late else {}))
    assert res["correct"] is True, res["checks"]


def test_an_open_loop_run_keeps_its_arrivals_and_is_correct():
    res = H.run_cell(tiny_spec("exact.lowcard", tuples=300, arrival_interval_s=0.05),
                     2**31 + 6, 0.3, False, "cpu")
    assert res["correct"] is True, res["checks"]
    line = res["window_line"]
    assert line["window_s"] >= 0.05 * (line["calls"] - 1)


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from deepflow_tpu_torch.aggregator import pipeline

    monkeypatch.setattr(pipeline, "_append_impl", lambda acc, *a, **k: acc)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["windows_missing"]["value"] > 0


def test_half_of_each_batch_left_out(monkeypatch):
    from deepflow_tpu_torch.aggregator import pipeline

    upload = pipeline.upload_flow_batch

    def half(batch, device):
        tags, meters, valid = upload(batch, device)
        valid = valid.clone()
        valid[valid.shape[0] // 2:] = False
        return tags, meters, valid

    monkeypatch.setattr(pipeline, "upload_flow_batch", half)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["doc_in_gap"]["value"] > 0


@pytest.mark.parametrize("lane", ["meter", "tag"])
def test_an_answer_altered_where_it_is_produced(monkeypatch, lane):
    from deepflow_tpu_torch.aggregator.pipeline import RollupPipeline

    to_doc = RollupPipeline._to_docbatch

    def altered(self, f):
        db = to_doc(self, f)
        if lane == "meter":
            db.meters[db.size // 2, 2] += 1.0
        else:
            db.tags[db.size // 2, 33] ^= 1
        return db

    monkeypatch.setattr(RollupPipeline, "_to_docbatch", altered)
    res = _run()
    assert res["correct"] is False
    name = "sum_exact_mismatch" if lane == "meter" else "nonkey_mismatch"
    assert res["checks"][name]["value"] > res["checks"][name]["limit"]


def test_a_sketch_block_altered_where_it_is_produced(monkeypatch):
    from deepflow_tpu_torch.aggregator import window

    drained = window.unpack_drained

    def altered(*a, **k):
        blocks = drained(*a, **k)
        return [dataclasses.replace(b, hll=b.hll + (b.hll == b.hll.max())) for b in blocks]

    monkeypatch.setattr(window, "unpack_drained", altered)
    res = _run("sketch.hicard")
    assert res["correct"] is False
    assert res["checks"]["hll_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", ["exact.hicard", "sketch.hicard"])
def test_the_control_fails_the_comparison(workload):
    spec = tiny_spec(workload)
    stream = FlowStream(spec.mix, 2**31 + 5, "cpu")
    sketch = spec.config["pipeline"]["config"]["window"].get("sketch")
    nums = control.control_numbers(stream, stream.start_time + 4, 8, sketch)
    limits = spec.config["limits"]
    failed = [k for k, v in nums.items() if v > limits.get(k, 0)]
    # below 2^24 every sum is exact: the control's bfloat16 misses there
    assert {"sum_exact_mismatch", "max_mismatch"} <= set(failed), nums
    if workload.startswith("sketch"):
        assert "cms_rel_gap" in failed, nums


def test_run_py_refuses_without_a_card(monkeypatch, capsys):
    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "exact.lowcard", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    res = H.run_cell(tiny_spec("sketch.hicard", records_per_batch=1 << 16, tuples=50_000,
                               batch_unique_cap=1 << 16, capacity=1 << 18),
                     2**31 + 9, 1.0, True, "cuda:0")
    assert res["correct"] is True, res["checks"]
    assert res["device"]["busy_s"] > 0
