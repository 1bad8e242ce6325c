"""The sharded cell's pieces: the `card_flows` generator (disjoint card
slices and clients, servers shared, the same bits on the CPU and the
card), the five readers of the sharded layers (each reads its span or
the check's peaks, and nothing from a program without them), the
check's per-key comparison and its per-card kernel work, and a whole
tiny run on four CPU shards, sound and with one shard's rows left out
of the drain's gather."""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness as H
from benchmark import schema
from benchmark.generators.card_flows import CardFlowStream

from .conftest import ROOT, TINY_MIX, tiny_spec

CELL = "sharded4.hicard4x"
READERS = ("shard_upload_gbps", "shard_step_device_ms", "shard_gather_gbps",
           "shard_merge_device_ms", "shard_peak_gib_max")


def _mix(**kw) -> dict:
    mix = json.loads((ROOT / "benchmark" / "traffic" / "hicard4x.json").read_text())
    mix.update(TINY_MIX, **kw)
    return mix


def test_card_slices_draw_from_disjoint_flows_and_clients():
    st = CardFlowStream(_mix(), 2**31 + 3, "cpu")
    tags, _, _ = st.batch(1, st.time_of(4))
    card = torch.arange(st.rows) // st.card_rows
    assert torch.equal(st.card_of_tuple(st.keys(1)), card)
    col = schema.FLOW_FIELDS.index

    def pods(field):
        return [set(tags[col(field)][card == c].tolist()) for c in range(st.cards)]

    pairs = [(a, b) for a in range(st.cards) for b in range(a + 1, st.cards)]
    clients, servers = pods("ip0_w3"), pods("ip1_w3")
    assert all(not clients[a] & clients[b] for a, b in pairs)
    # a server is drawn from every pod, so the cards share servers
    assert all(servers[a] & servers[b] for a, b in pairs)
    # a card's slice is its rows of the same batch
    sl = st.card(2).batch(1, st.time_of(4))
    assert torch.equal(sl[0], tags[:, 2 * st.card_rows:3 * st.card_rows])


def test_same_seed_same_records():
    a = CardFlowStream(_mix(), 2**31 + 9, "cpu").batch(0, 1_700_000_003)
    b = CardFlowStream(_mix(), 2**31 + 9, "cpu").batch(0, 1_700_000_003)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
def test_the_card_draws_the_cpu_s_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = CardFlowStream(_mix(), 2**31 + 9, "cpu").batch(2, 1_700_000_003)
    card = CardFlowStream(_mix(), 2**31 + 9, "cuda").batch(2, 1_700_000_003)
    assert all(torch.equal(x, y.cpu()) for x, y in zip(cpu, card))


def _run_of(before: dict, after: dict, **kw):
    return SimpleNamespace(ctx=H.Context(spec=None, device="cpu", spans_before=before,
                                         spans_after=after), **kw)


def test_each_reader_reads_its_span():
    before = {"shard.upload": {"count": 4, "total_us": 100, "bytes": 400_000},
              "shard.step": {"count": 4, "total_us": 9, "device_us": 400.0, "device_count": 4},
              "shard.gather": {"count": 1, "total_us": 5, "bytes": 1_000_000,
                               "device_us": 100.0, "device_count": 1},
              "shard.merge": {"count": 2, "total_us": 7, "device_us": 50.0, "device_count": 1}}
    after = {"shard.upload": {"count": 12, "total_us": 300, "bytes": 1_200_000},
             "shard.step": {"count": 12, "total_us": 27, "device_us": 2000.0,
                            "device_count": 12},
             "shard.gather": {"count": 3, "total_us": 15, "bytes": 5_000_000,
                              "device_us": 300.0, "device_count": 3},
             "shard.merge": {"count": 6, "total_us": 21, "device_us": 110.0, "device_count": 3}}
    run = _run_of(before, after, card_peaks=[2**30, 3 * 2**30, 2**31])
    got = {n: importlib.import_module(f"benchmark.metrics.{n}").read(run) for n in READERS}
    assert got == pytest.approx({"shard_upload_gbps": 4.0, "shard_step_device_ms": 0.2,
                                 "shard_gather_gbps": 20.0, "shard_merge_device_ms": 0.03,
                                 "shard_peak_gib_max": 3.0})


def test_each_reader_reads_nothing_from_a_program_without_it():
    older = {"ingest.dispatch": {"count": 9, "total_us": 900},
             "flush.drain": {"count": 9, "total_us": 9000}}
    # a CPU run: spans without device time, no card peaks
    cpu = {"shard.step": {"count": 4, "total_us": 9}, "shard.merge": {"count": 2, "total_us": 9},
           "shard.gather": {"count": 1, "total_us": 9, "bytes": 0}}
    for spans in (older, cpu):
        run = _run_of(spans, spans)
        for name in READERS:
            assert importlib.import_module(f"benchmark.metrics.{name}").read(run) is None, name


def test_the_readers_are_declared_for_the_cell_alone():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == [CELL], name
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 4 and sum(w["chips"] == 4 for w in bench["workloads"]) == 1


# one VPC, one process id and one port a side: most servers' documents
# are on several cards
NARROW = dict(epc_range=[1, 2], gpid_range=[0, 1], ports=[80])


def _tiny():
    return tiny_spec(CELL, batch_unique_cap=1024, capacity=1 << 13, tuples=2000, pod_ips=400,
                     **NARROW)


def test_a_sound_run_on_four_cpu_shards_is_correct(capsys):
    res = H.run_cell(_tiny(), 2**31 + 5, 0.3, True, "cpu")
    assert res["correct"] is True, res["checks"]
    said = capsys.readouterr().err
    shared = int(said.split("document keys on more than one card")[1].split(":")[1].split()[0])
    assert shared > 0
    assert res["metrics"]["shard_upload_gbps"]["value"] > 0
    # a CPU run: no device time, nothing crosses between devices, no peaks
    assert not {"shard_step_device_ms", "shard_gather_gbps", "shard_merge_device_ms",
                "shard_peak_gib_max"} & set(res["metrics"])


def test_one_shard_left_out_of_the_gather(monkeypatch):
    from deepflow_tpu_torch.parallel.sharded import ShardedWindowManager

    real = ShardedWindowManager._window_major

    def without_the_last(self, rows, totals):
        totals = totals.copy()
        totals[-1] = 0
        return real(self, rows, totals)

    monkeypatch.setattr(ShardedWindowManager, "_window_major", without_the_last)
    res = H.run_cell(_tiny(), 2**31 + 5, 0.3, False, "cpu")
    assert res["correct"] is False
    assert res["checks"]["docs_unmatched"]["value"] > 0


def _window_of_cards(seed: int = 2**31 + 21):
    """One full window of a narrow tiny stream: each card's reference
    documents, the shared keys' row positions in their concatenation."""
    from benchmark.checks import l4_sharded as C

    st = CardFlowStream(_mix(**NARROW), seed, "cpu")
    w, last = st.start_time + 1, 3
    refs = [C.card_window(st.card(c), w, last, None)[0] for c in range(st.cards)]
    tags = torch.cat([r.tags for r in refs])
    meters = torch.cat([r.meters for r in refs]).float()
    keys = tags[:, list(schema.DOC_KEY_INDEX)]
    _, inv, cnt = torch.unique(keys, dim=0, return_inverse=True, return_counts=True)
    shared = torch.nonzero(cnt[inv] > 1).flatten()
    return refs, tags, meters, shared, inv


@pytest.mark.parametrize("fault", ["none", "rows_merged", "row_left_out", "nonkey_swapped",
                                   "meter_moved"])
def test_the_per_key_comparison(fault):
    """The cards' own rows pass; a key's rows merged into one row, one
    card's row of a shared key left out, two cards' non-key tags swapped,
    or meter mass moved between keys, each fails a number."""
    from benchmark.checks import l4_sharded as C

    refs, tags, meters, shared, inv = _window_of_cards()
    assert shared.numel() > 0
    a = int(shared[0])
    b = int(torch.nonzero((inv == inv[a]) & (torch.arange(inv.shape[0]) != a))[0])
    keep = torch.ones(tags.shape[0], dtype=torch.bool)
    pod = schema.DOC_FIELDS.index("pod_id")
    sums = list(schema.METER_SUM)
    if fault == "rows_merged":
        meters[a, sums] += meters[b, sums]
        keep[b] = False
    elif fault == "row_left_out":
        keep[b] = False
    elif fault == "nonkey_swapped":
        tags[a, pod], tags[b, pod] = tags[b, pod].clone(), tags[a, pod].clone()
        tags[a, pod] += 1  # a pod no card's row of the key has
    elif fault == "meter_moved":
        other = int(torch.nonzero(inv != inv[a])[0])
        meters[other, sums[0]] += 1
        meters[a, sums[0]] -= 1
    got, on_several = C.compare_window(tags[keep], meters[keep], refs)
    assert on_several > 0
    exact = {k: v for k, v in got.items() if k != "sum_rel_gap"}
    if fault == "none":
        assert exact == dict.fromkeys(exact, 0) and got["sum_rel_gap"] == 0.0
    elif fault in ("rows_merged", "nonkey_swapped"):
        assert got["nonkey_mismatch"] > 0 and got["docs_unmatched"] == 0
    else:
        assert got["sum_exact_mismatch"] > 0


def test_traced_work_counts_every_card_s_launches():
    """Per traced call: each card's pre-reduce and fold (segreduce) and
    each card's two fused sketch updates, in the count the launch
    counters would show."""
    from benchmark.checks import l4_sharded as C

    run = H.Run(_tiny(), 2**31 + 7, 0.3, True, "cpu")
    run.setup()
    run.window()
    run.finish()
    work = C.traced_work(run)
    calls, cards = len(run.ctx.traced), run.stream.cards
    assert calls >= 2
    assert len(work["segreduce"]) == len(work["sketch_fused"]) == 2 * cards * calls
    assert all(x is not None and x > 0 for x in work["segreduce"] + work["sketch_fused"])


SHARED_LAYERS = ("stage_ms", "dispatch_ms", "launches_per_batch", "advance_ms", "drain_ms",
                 "fold_rows", "segreduce_roofline", "sketch_fused_roofline", "device_idle_pct",
                 "kernel_idle_pct", "pack_ms", "prereduce_device_ms", "fanout_device_ms",
                 "drain_wait_ms", "drain_copy_gbps", "drain_split_ms", "pinned_fetch_pct")


def test_the_single_card_layers_read_on_the_cell_are_declared_for_it():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        assert (CELL in m["workloads"]) == (m["name"] in SHARED_LAYERS + READERS), m["name"]
