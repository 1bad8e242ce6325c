"""The flow-log plane on the port — the minute merge (`log_stash_merge`,
`_log_flush`, `MinuteAggr`), `ThrottlingQueue` and the row codec —
against the reference's, on the CPU.

Every stream starts both packages from one state and compares the whole
stash lane for lane after every step (`convert.log_stash_to_numpy`): the
sentinel segment and the empty segments' identities included, floats by
their bits. One stash shape (64 rows, 48-row batches) and one
MinuteAggr shape keep the reference's compiles to a few.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from deepflow_tpu.flowlog import aggr as ref_aggr
from deepflow_tpu.flowlog import codec as ref_codec
from deepflow_tpu.flowlog import schema as ref_schema
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.flowlog import aggr, codec, oracle
from deepflow_tpu_torch.flowlog.schema import L4_FLOW_LOG, L7_FLOW_LOG

S, B = 64, 48  # stash rows, batch rows
MA_CAP, MA_BATCH = 128, 64
T0 = 1_700_000_000
_FIELDS = ("slot", "key_hi", "key_lo", "ints", "nums", "valid", "dropped_overflow")


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_state(ref, port) -> None:
    got = convert.log_stash_to_numpy(port)
    for k in _FIELDS:
        want = np.asarray(getattr(ref, k))
        assert got[k].dtype == want.dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want), err_msg=k)


def _rows(rng, *, slots, keys, valid_p, ints_hi=1 << 32, integer=False):
    """One batch of merge rows: u32 lanes drawn from few (slot, key)
    pairs so segments span stash and batch; random u32 ints (OR lanes
    with bits above 15 included); f32 nums."""
    slot = rng.integers(0, slots, B).astype(np.uint32)
    k = rng.integers(0, keys, B)
    hi = (k * 2654435761 % (1 << 32)).astype(np.uint32)
    lo = (k % 5).astype(np.uint32)
    ints = rng.integers(0, ints_hi, (B, len(L4_FLOW_LOG.ints)), dtype=np.uint64).astype(np.uint32)
    nums = rng.random((B, len(L4_FLOW_LOG.nums))) * 1e4
    nums = (np.floor(nums) if integer else nums).astype(np.float32)
    valid = rng.random(B) < valid_p
    return slot, hi, lo, ints, nums, valid


CASES = {
    # FIRST/LAST ties across stash and batch: few keys, every row valid
    "ties": dict(slots=2, keys=6, valid_p=1.0),
    # more live segments than the stash holds: dropped_overflow moves
    "overflow": dict(slots=4, keys=40, valid_p=0.9),
    # invalid rows fall into the sentinel segment
    "invalid_rows": dict(slots=3, keys=12, valid_p=0.5),
    # integer-valued meters and small ints
    "integer": dict(slots=3, keys=20, valid_p=0.8, ints_hi=1 << 20, integer=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_stash_merge_bit_equal(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    ref = ref_aggr.log_stash_init(S, ref_schema.L4_FLOW_LOG)
    port = aggr.log_stash_init(S, L4_FLOW_LOG, device="cpu")
    for _ in range(5):
        slot, hi, lo, ints, nums, valid = _rows(rng, **CASES[case])
        ref = ref_aggr.log_stash_merge(
            ref, *(jnp.asarray(a) for a in (slot, hi, lo, ints, nums, valid)),
            ref_schema.L4_FLOW_LOG)
        port = aggr.log_stash_merge(
            port, *aggr.upload_rows(slot, hi, lo, ints, nums, valid, "cpu"), L4_FLOW_LOG)
        assert_same_state(ref, port)
    if case == "overflow":
        assert int(port.dropped_overflow) > 0
    if case == "ties":
        # the OR lanes dropped their high bits, as the reference's
        or_cols = L4_FLOW_LOG.int_cols_with(aggr.LogOp.OR)
        assert int(port.ints[:, or_cols].max()) < (1 << 16)


def test_log_flush_bit_equal():
    rng = np.random.default_rng(7)
    ref = ref_aggr.log_stash_init(S, ref_schema.L4_FLOW_LOG)
    port = aggr.log_stash_init(S, L4_FLOW_LOG, device="cpu")
    for _ in range(2):
        rows = _rows(rng, slots=3, keys=15, valid_p=0.9)
        ref = ref_aggr.log_stash_merge(ref, *(jnp.asarray(a) for a in rows),
                                       ref_schema.L4_FLOW_LOG)
        port = aggr.log_stash_merge(port, *aggr.upload_rows(*rows, "cpu"), L4_FLOW_LOG)
    for minute in (1, 0, 2, 9):
        ref, r_out = ref_aggr._log_flush(ref, np.uint32(minute))
        port, p_out = aggr._log_flush(port, minute)
        n = int(r_out["count"])
        assert int(p_out["count"]) == n
        np.testing.assert_array_equal(convert.to_numpy_u32(p_out["ints"]), np.asarray(r_out["ints"]))
        np.testing.assert_array_equal(_bits(p_out["nums"].numpy()), _bits(r_out["nums"]))
        # the packed fetch carries the same rows
        ints, nums = aggr.unpack_rows(aggr.pack_rows(p_out["ints"][:n], p_out["nums"][:n]).numpy(),
                                      len(L4_FLOW_LOG.ints))
        np.testing.assert_array_equal(ints, np.asarray(r_out["ints"][:n]))
        np.testing.assert_array_equal(_bits(nums), _bits(r_out["nums"][:n]))
        assert_same_state(ref, port)


def _log_batches(schema, rng, n_batches=7, late_p=0.1, ints_hi=1 << 18):
    """L4 rows over ~3 minutes, 16 flows, end_time ascending batch to
    batch, with a share `late_p` of rows late by 90 s."""
    out = []
    for b in range(n_batches):
        n = int(rng.integers(20, MA_BATCH + 1))
        ints = np.zeros((n, len(schema.ints)), np.uint32)
        flow = rng.integers(0, 16, n)
        ints[:, schema.int_index("flow_id_hi")] = flow * 7919
        ints[:, schema.int_index("flow_id_lo")] = flow
        ints[:, schema.int_index("agent_id")] = 1
        end = T0 + 25 * b + rng.integers(0, 10, n)
        late = rng.random(n) < late_p
        end = np.where(late, end - 90, end)
        ints[:, schema.int_index("end_time")] = end
        ints[:, schema.int_index("start_time")] = end - rng.integers(0, 30, n)
        for f in schema.ints:
            if f.name not in schema.key and f.name not in ("end_time", "start_time"):
                ints[:, schema.int_index(f.name)] = rng.integers(0, ints_hi, n)
        nums = np.floor(rng.random((n, len(schema.nums))) * 1000).astype(np.float32)
        out.append((ints, nums))
    return out


def test_minute_aggr_stream_with_late_rows_and_drain():
    rng = np.random.default_rng(3)
    ref = ref_aggr.MinuteAggr(capacity=MA_CAP, batch_size=MA_BATCH)
    port = aggr.MinuteAggr(capacity=MA_CAP, batch_size=MA_BATCH, device="cpu")
    for ints, nums in _log_batches(L4_FLOW_LOG, rng):
        want = ref.ingest(ref_aggr.FlowLogBatch(ref_schema.L4_FLOW_LOG, ints.copy(), nums.copy(),
                                                np.ones(len(ints), bool)))
        got = port.ingest(aggr.FlowLogBatch(L4_FLOW_LOG, ints, nums, np.ones(len(ints), bool)))
        assert [b.size for b in got] == [b.size for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.ints, w.ints)
            np.testing.assert_array_equal(_bits(g.nums), _bits(w.nums))
        assert_same_state(ref.state, port.state)
        assert port.counters == ref.counters
    want, got = ref.drain(), port.drain()
    assert [b.size for b in got] == [b.size for b in want] and got
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ints, w.ints)
        np.testing.assert_array_equal(_bits(g.nums), _bits(w.nums))
    assert_same_state(ref.state, port.state)
    assert port.get_counters() == ref.get_counters()
    assert port.counters["drop_before_window"] > 0  # the late rows were counted


def test_minute_aggr_fetch_budget_and_oracle():
    """Each flush fetches one block of live minutes and one block per
    closing minute; a stream without late rows equals the dict oracle."""
    rng = np.random.default_rng(11)
    port = aggr.MinuteAggr(capacity=MA_CAP, batch_size=MA_BATCH, device="cpu")
    batches, out = [], []
    # no late rows; OR lanes within 16 bits, as the oracle ORs whole words
    for ints, nums in _log_batches(L4_FLOW_LOG, rng, late_p=0.0, ints_hi=1 << 16):
        b = aggr.FlowLogBatch(L4_FLOW_LOG, ints, nums, np.ones(len(ints), bool))
        before = port.host_fetches
        got = port.ingest(b)
        assert port.host_fetches - before in (0, 1 + len(got))
        batches.append(b)
        out += got
    before = port.host_fetches
    drained = port.drain()
    assert port.host_fetches - before == 1 + len(drained)
    out += drained
    assert port.counters["drop_before_window"] == 0
    want = oracle.minute_merge_oracle(L4_FLOW_LOG, batches)
    got = oracle.batches_to_dict(L4_FLOW_LOG, out)
    assert got.keys() == want.keys()
    for key, cols in want.items():
        for name, v in cols.items():
            assert got[key][name] == v, (key, name)


def test_throttling_queue_same_sample():
    rng = np.random.default_rng(5)
    ref, port = ref_aggr.ThrottlingQueue(7, seed=3), aggr.ThrottlingQueue(7, seed=3)
    for ints, nums in _log_batches(L4_FLOW_LOG, rng, n_batches=5):
        ref.put(ref_aggr.FlowLogBatch(ref_schema.L4_FLOW_LOG, ints, nums, np.ones(len(ints), bool)))
        port.put(aggr.FlowLogBatch(L4_FLOW_LOG, ints, nums, np.ones(len(ints), bool)))
        up_to = int(ints[:, L4_FLOW_LOG.int_index("end_time")].max())
        for g, w in zip(port.drain(up_to), ref.drain(up_to), strict=True):
            np.testing.assert_array_equal(g.ints, w.ints)
            np.testing.assert_array_equal(_bits(g.nums), _bits(w.nums))
    for g, w in zip(port.drain(), ref.drain(), strict=True):
        np.testing.assert_array_equal(g.ints, w.ints)
    assert port.counters == ref.counters and port.counters["dropped"] > 0


@pytest.mark.parametrize("name", ["l4", "l7"])
def test_codec_bytes_equal(name):
    rng = np.random.default_rng(2)
    schema, rschema = ((L4_FLOW_LOG, ref_schema.L4_FLOW_LOG) if name == "l4"
                       else (L7_FLOW_LOG, ref_schema.L7_FLOW_LOG))
    n = 9
    ints = rng.integers(0, 1 << 32, (n, len(schema.ints)), dtype=np.uint64).astype(np.uint32)
    nums = (rng.random((n, len(schema.nums))) * 1e3).astype(np.float32)
    strs = {f.name: [f"{f.name}-{i}-ü" * (i % 3) for i in range(n)] for f in schema.strs} or None
    valid = np.ones(n, bool)
    valid[4] = False
    msgs = codec.encode_rows(aggr.FlowLogBatch(schema, ints, nums, valid, strs))
    assert msgs == ref_codec.encode_rows(ref_aggr.FlowLogBatch(rschema, ints, nums, valid, strs))
    got, errors = codec.decode_rows(schema, msgs + [b"\xff\xff"])
    want, ref_errors = ref_codec.decode_rows(rschema, msgs + [b"\xff\xff"])
    assert errors == ref_errors == 1
    np.testing.assert_array_equal(got.ints, want.ints)
    np.testing.assert_array_equal(_bits(got.nums), _bits(want.nums))
    np.testing.assert_array_equal(got.valid, want.valid)
    assert got.strs == want.strs


def test_log_stash_crosses_both_ways():
    rng = np.random.default_rng(9)
    ref = ref_aggr.log_stash_init(S, ref_schema.L4_FLOW_LOG)
    rows = _rows(rng, slots=3, keys=20, valid_p=0.8)
    ref = ref_aggr.log_stash_merge(ref, *(jnp.asarray(a) for a in rows), ref_schema.L4_FLOW_LOG)
    port = convert.log_stash_from_numpy(ref, "cpu")  # the reference's state itself
    assert_same_state(ref, port)
    again = convert.log_stash_from_numpy(convert.log_stash_to_numpy(port), "cpu")
    assert_same_state(ref, again)
    # both continue from the shared state to the same next state
    rows = _rows(rng, slots=3, keys=20, valid_p=0.8)
    ref = ref_aggr.log_stash_merge(ref, *(jnp.asarray(a) for a in rows), ref_schema.L4_FLOW_LOG)
    port = aggr.log_stash_merge(port, *aggr.upload_rows(*rows, "cpu"), L4_FLOW_LOG)
    assert_same_state(ref, port)


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        aggr.log_stash_init(S, L4_FLOW_LOG)
    with pytest.raises(RuntimeError, match="CUDA"):
        aggr.MinuteAggr()
