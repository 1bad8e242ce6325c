"""The port's rollup oracle (deepflow_tpu_torch/oracle/numpy_oracle.py)
against the reference's, and the port's pipelines against the port's
oracle — the cases of tests/test_pipeline_conformance.py and the L7
conformance of tests/test_l7_pipeline.py on the port (CPU tensors):
identical per-window key sets, and meters exact (the streams' meters are
integers below 2^24, so float32 holds them exactly)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepflow_tpu.oracle import numpy_oracle as ref_oracle
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, L7Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.datamodel.batch import FlowBatch
from deepflow_tpu_torch.datamodel.code import Direction, SignalSource
from deepflow_tpu_torch.datamodel.schema import APP_METER, FLOW_METER, TAG_SCHEMA
from deepflow_tpu_torch.ingest.replay import SyntheticAppGen, SyntheticFlowGen
from deepflow_tpu_torch.oracle import OracleDoc, oracle_l4_rollup, oracle_l7_rollup

torch.set_num_threads(1)

KEY_FIELDS = [f.name for f in TAG_SCHEMA.fields if f.key]
KEY_IDX = [TAG_SCHEMA.index(n) for n in KEY_FIELDS]
T0 = 1_700_000_000


def _ref_config(cfg: FanoutConfig):
    from deepflow_tpu.aggregator.fanout import FanoutConfig as RefFanoutConfig

    return RefFanoutConfig(**{k: getattr(cfg, k) for k in cfg.__dataclass_fields__})


def _emitted(doc_batches, schema):
    """{(window start s, key tuple): meter row as int64}"""
    out = {}
    for db in doc_batches:
        for i in range(db.size):
            if not db.valid[i]:
                continue
            key = (int(db.timestamp[i]),) + tuple(int(db.tags[i, j]) for j in KEY_IDX)
            assert key not in out, f"duplicate key emitted: {key}"
            row = np.asarray(db.meters[i], np.float64)
            assert np.all(row == np.round(row)) and np.all(np.abs(row) < 2 ** 24)
            out[key] = row.astype(np.int64)
    assert all(len(r) == schema.num_fields for r in out.values())
    return out


def _oracle_keys(oracle: dict, interval: int):
    return {(d.window * interval,) + tuple(d.tag[k] for k in KEY_FIELDS): d
            for d in oracle.values()}


def _compare(emitted, oracle_keys, schema):
    assert set(emitted) == set(oracle_keys), (
        f"only-device={len(set(emitted) - set(oracle_keys))} "
        f"only-oracle={len(set(oracle_keys) - set(emitted))}")
    for key, row in emitted.items():
        want = oracle_keys[key].meter
        for i, f in enumerate(schema.fields):
            assert row[i] == want[f.name], (f.name, key)


def _run_l4(gen_kwargs, batches, config=FanoutConfig(), interval=1):
    gen = SyntheticFlowGen(**gen_kwargs)
    pipe = L4Pipeline(PipelineConfig(fanout=config,
                                     window=WindowConfig(interval=interval, delay=2,
                                                         capacity=1 << 12),
                                     batch_size=512), device="cpu")
    records, out = [], []
    for t, size in batches:
        recs = gen.records(size, t)
        records += recs
        out += pipe.ingest(FlowBatch.from_records(recs))
    out += pipe.drain()
    return records, _emitted(out, FLOW_METER)


def _assert_oracles_equal(got: dict, want: dict):
    """The port's oracle equals the reference's, doc for doc."""
    assert list(got) == list(want)
    for k in want:
        g, w = got[k], want[k]
        assert isinstance(g, OracleDoc)
        assert (g.window, g.tag, g.meter) == (w.window, w.tag, w.meter), k


L4_CASES = {
    "single_window": ({"num_tuples": 50, "seed": 1}, [(1000, 100), (1000, 100), (1004, 1)],
                      FanoutConfig(), 1),
    "multi_window": ({"num_tuples": 300, "seed": 2},
                     [(t, 200) for t in range(2000, 2006)] + [(2010, 1)], FanoutConfig(), 1),
    "direction_mix": ({"num_tuples": 80, "seed": 3, "p_both_dirs": 0.4, "p_one_dir": 0.3},
                      [(3000, 300), (3003, 1)], FanoutConfig(), 1),
    "inactive_ip": ({"num_tuples": 60, "seed": 4}, [(4000, 200), (4003, 1)],
                    FanoutConfig(inactive_ip_aggregation=True), 1),
    "minute": ({"num_tuples": 40, "seed": 5}, [(t, 100) for t in (5000, 5030, 5059, 5061, 5125)],
               FanoutConfig(), 60),
}


@pytest.mark.parametrize("case", sorted(L4_CASES))
def test_port_l4_pipeline_matches_port_oracle_and_oracles_agree(case):
    gen_kwargs, batches, cfg, interval = L4_CASES[case]
    records, emitted = _run_l4(gen_kwargs, batches, cfg, interval)
    oracle = oracle_l4_rollup(records, cfg, interval=interval)
    assert len(oracle) > 0
    _compare(emitted, _oracle_keys(oracle, interval), FLOW_METER)
    _assert_oracles_equal(oracle, ref_oracle.oracle_l4_rollup(records, _ref_config(cfg),
                                                              interval=interval))
    if case == "multi_window":
        assert len({k[0] for k in emitted}) >= 6


def test_l4_both_inactive_record_dropped():
    cfg = FanoutConfig(inactive_ip_aggregation=True)
    rec = {"timestamp": T0, "signal_source": int(SignalSource.PACKET), "ip0_w3": 1,
           "ip1_w3": 2, "protocol": 6, "server_port": 80,
           "direction0": int(Direction.CLIENT_TO_SERVER),
           "direction1": int(Direction.SERVER_TO_CLIENT), "is_active_host0": 0,
           "is_active_host1": 0, "is_active_service": 1, "meter": {"packet_tx": 7}}
    pipe = L4Pipeline(PipelineConfig(fanout=cfg, window=WindowConfig(interval=1, delay=2,
                                                                      capacity=256),
                                     batch_size=64), device="cpu")
    out = pipe.ingest(FlowBatch.from_records([rec])) + pipe.drain()
    assert all(db.size == 0 for db in out)
    assert oracle_l4_rollup([rec], cfg) == {} == ref_oracle.oracle_l4_rollup([rec], _ref_config(cfg))


@pytest.mark.parametrize("inactive_ip", [False, True], ids=["plain", "inactive_ip"])
def test_port_l7_pipeline_matches_port_oracle_and_oracles_agree(inactive_ip):
    cfg = FanoutConfig(inactive_ip_aggregation=inactive_ip)
    gen = SyntheticAppGen(num_services=16, endpoints_per_service=4, seed=3)
    per_t = [(t, gen.records(200, t)) for t in range(T0, T0 + 5)]
    pipe = L7Pipeline(PipelineConfig(fanout=cfg, window=WindowConfig(interval=1, delay=2,
                                                                     capacity=1 << 14),
                                     batch_size=512), device="cpu")
    out = []
    for _t, recs in per_t:
        out += pipe.ingest(FlowBatch.from_records(recs, APP_METER))
    out += pipe.drain()
    records = [r for _, recs in per_t for r in recs]
    oracle = oracle_l7_rollup(records, cfg)
    assert len(oracle) > 0
    _compare(_emitted(out, APP_METER), _oracle_keys(oracle, 1), APP_METER)
    _assert_oracles_equal(oracle, ref_oracle.oracle_l7_rollup(records, _ref_config(cfg)))


def test_generators_equal_across_packages():
    """The port's copies of the replay generators give the reference's
    records and arrays for one seed."""
    from deepflow_tpu.ingest import replay as ref_replay
    from deepflow_tpu_torch.ingest import replay

    a, b = replay.SyntheticAppGen(seed=3), ref_replay.SyntheticAppGen(seed=3)
    assert a.records(50, T0) == b.records(50, T0)
    x, y = a.app_batch(40, T0 + 1), b.app_batch(40, T0 + 1)
    assert sorted(x.tags) == sorted(y.tags)
    assert all(np.array_equal(x.tags[k], y.tags[k]) for k in y.tags)
    assert np.array_equal(x.meters, y.meters) and np.array_equal(x.valid, y.valid)
    t = replay.SyntheticTaggedFlowGen(seed=1).batches_for_second(T0, 5)
    u = ref_replay.SyntheticTaggedFlowGen(seed=1).batches_for_second(T0, 5)
    assert np.array_equal(t.ints, u.ints) and np.array_equal(t.nums, u.nums) and t.ints.size
    g, h = replay.SyntheticL7LogGen(seed=2).batch(30, T0), ref_replay.SyntheticL7LogGen(seed=2).batch(30, T0)
    assert np.array_equal(g.ints, h.ints) and np.array_equal(g.nums, h.nums) and g.strs == h.strs
