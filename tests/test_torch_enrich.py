"""The port's hash tables and device enrichment (ops/hashtable.py,
enrich/platform.py, convert.platform_state_*) against the reference's,
on the CPU.

  * `build_table` + `lookup` on 500 random keys and 64 misses
    (tests/test_enrich.py:43): the same table lanes, values and found
    flags bit for bit;
  * `enrich_docs` on the platform fixture of tests/test_enrich.py — its
    hand-made rows — and on a seeded 4096-row batch drawn over the
    fixture's keys, which covers every fallback branch, the multicast
    peer fill, OTel, IPv6 and the other-region filter (my_region_id 3,
    and 0): side0, side1, keep and drops bit-equal;
  * the reference's built PlatformState carried across by
    `convert.platform_state_from_numpy`: the port's lookups and
    enrichment over it equal the reference's, and the port's own build
    gives the same state.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deepflow_tpu.enrich import platform as ref_platform
from deepflow_tpu.ops import hashtable as ref_hashtable
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.datamodel.code import CodeId, SignalSource
from deepflow_tpu_torch.datamodel.schema import TAG_SCHEMA
from deepflow_tpu_torch.enrich import platform
from deepflow_tpu_torch.ops import hashtable
from deepflow_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

_T = TAG_SCHEMA
CPU = torch.device("cpu")
MY_REGION = 3


def _make_platform(mod, my_region=MY_REGION):
    """The platform fixture of tests/test_enrich.py::make_platform, built
    with either package's PlatformInfoTable."""
    pt = mod.PlatformInfoTable(my_region_id=my_region)
    pt.add_info(epc_id=10, pod_id=101, ips=["10.0.0.1"], region_id=MY_REGION, host_id=1,
                l3_device_id=11, l3_device_type=1, subnet_id=21, pod_node_id=31,
                pod_ns_id=41, az_id=51, pod_group_id=61, pod_group_type=101,
                pod_cluster_id=71)
    pt.add_info(epc_id=10, mac=0x0050_5600_0001, region_id=MY_REGION, host_id=2,
                l3_device_id=12, l3_device_type=1, subnet_id=22, az_id=52)
    pt.add_info(epc_id=10, ips=["10.0.0.9"], region_id=MY_REGION + 1, host_id=3,
                l3_device_id=13, l3_device_type=2, subnet_id=23, az_id=53)
    pt.add_info(epc_id=12, ips=["fd00::42"], region_id=MY_REGION, host_id=4,
                l3_device_id=14, l3_device_type=1, subnet_id=24, az_id=54)
    pt.add_info(epc_id=10, pod_id=202, region_id=MY_REGION, host_id=5,
                l3_device_id=15, l3_device_type=1, subnet_id=25, pod_node_id=35,
                az_id=55, pod_group_id=65, pod_group_type=102, pod_cluster_id=75)
    # a pod-service-typed interface (DEVICE_TYPE_POD_SERVICE gate)
    pt.add_info(epc_id=10, ips=["10.0.0.77"], region_id=MY_REGION, l3_device_id=16,
                l3_device_type=platform.DEVICE_TYPE_POD_SERVICE, subnet_id=26,
                pod_group_id=61)
    pt.add_gprocess(gpid=9001, agent_id=1, pod_id=202)
    pt.add_gprocess(gpid=9002, agent_id=77, pod_id=202)  # wrong agent → no fill
    pt.add_pod_service(501, pod_group_id=61, protocol=6, server_port=80)
    pt.add_pod_service(502, pod_group_id=65)  # wildcard any-port
    pt.add_pod_service(503, pod_node_id=31)
    pt.add_custom_service(601, epc_id=10, ip="10.0.0.50", server_port=443)
    pt.add_custom_service(602, epc_id=10, ip="10.0.0.50")  # any port
    return pt


def _row(**cols) -> np.ndarray:
    row = np.zeros(_T.num_fields, dtype=np.uint32)
    for k, v in cols.items():
        row[_T.index(k)] = np.uint32(v & 0xFFFFFFFF)
    return row


def _set_ip(cols: dict, side: int, ip):
    is_v6, words = platform._ip_words(ip)
    if is_v6:
        cols["is_ipv6"] = 1
    for w in range(4):
        cols[f"ip{side}_w{w}"] = words[w]


def _fixture_rows() -> np.ndarray:
    """The hand-made rows of tests/test_enrich.py::doc_rows."""
    E = platform.EPC_INTERNET
    specs = [
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, pod_id=101, server_port=80,
              protocol=6, agent_id=1, tap_side=2, direction=2), "10.0.0.1", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, pod_id=101, server_port=0,
              protocol=6, agent_id=1, tap_side=1, direction=1), "10.0.0.1", None),
        (dict(code_id=CodeId.SINGLE_MAC_IP_PORT, l3_epc_id=10, mac0_hi=0x0050,
              mac0_lo=0x56000001, agent_id=1, tap_side=1, direction=1), "10.9.9.9", None),
        (dict(code_id=CodeId.SINGLE_MAC_IP_PORT, l3_epc_id=10, mac0_hi=0xBEEF, mac0_lo=0x1,
              agent_id=1, tap_side=1, direction=1), "10.0.0.1", None),
        (dict(code_id=CodeId.SINGLE_MAC_IP_PORT, l3_epc_id=10, pod_id=555, mac0_hi=0x0050,
              mac0_lo=0x56000001, agent_id=1, tap_side=1, direction=1), "10.9.9.7", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, pod_id=556, agent_id=1,
              tap_side=1, direction=1), "10.251.0.9", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, gpid0=9001, agent_id=1,
              tap_side=1, direction=1), "10.250.0.1", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, gpid0=9002, agent_id=1,
              tap_side=1, direction=1), "10.250.0.2", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=E, agent_id=1, tap_side=1,
              direction=1), "8.8.8.8", None),
        (dict(code_id=CodeId.SINGLE_IP_PORT_APP, l3_epc_id=E, agent_id=1, tap_side=1,
              direction=1, signal_source=SignalSource.OTEL), "8.8.4.4", None),
        (dict(code_id=CodeId.EDGE_IP_PORT, l3_epc_id=10, l3_epc_id1=10, server_port=443,
              protocol=6, agent_id=1, tap_side=1, direction=1), "10.0.0.1", "10.0.0.50"),
        (dict(code_id=CodeId.EDGE_IP_PORT, l3_epc_id=10, l3_epc_id1=10, agent_id=1,
              tap_side=2, direction=2), "239.1.1.1", "10.0.0.1"),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=10, agent_id=1, tap_side=1,
              direction=1), "10.0.0.9", None),
        (dict(code_id=CodeId.EDGE_IP_PORT, l3_epc_id=10, l3_epc_id1=10, agent_id=1,
              tap_side=2, direction=2), "10.0.0.1", "10.0.0.9"),
        (dict(code_id=CodeId.EDGE_IP_PORT, l3_epc_id=10, l3_epc_id1=10, agent_id=1,
              tap_side=1, direction=1), "10.0.0.1", "10.0.0.9"),
        (dict(code_id=CodeId.SINGLE_IP_PORT, l3_epc_id=12, agent_id=1, tap_side=1,
              direction=1), "fd00::42", None),
        (dict(code_id=CodeId.EDGE_IP_PORT, l3_epc_id=10, l3_epc_id1=10, server_port=9999,
              protocol=17, agent_id=1, tap_side=1, direction=1), "10.9.9.8", "10.0.0.1"),
    ]
    rows = []
    for cols, ip0, ip1 in specs:
        cols = dict(cols)
        _set_ip(cols, 0, ip0)
        if ip1 is not None:
            _set_ip(cols, 1, ip1)
        rows.append(_row(**cols))
    return np.stack(rows)


def _seeded_rows(n: int, seed: int) -> np.ndarray:
    """A seeded batch over the fixture's keys, misses and sentinels:
    every column is drawn from a pool that hits each branch of the
    fallback chain, both sides, both address families, multicast peers,
    both observation sides and the OTel fixup."""
    rng = np.random.default_rng(seed)
    v4 = ["10.0.0.1", "10.0.0.9", "10.0.0.50", "10.0.0.77", "10.250.0.1", "10.9.9.9",
          "239.1.1.1", "224.0.0.5", "8.8.8.8"]
    v6 = ["fd00::42", "fd00::43", "ff02::1", "2001:db8::1"]
    tags = np.zeros((n, _T.num_fields), np.uint32)

    def put(name, vals):
        tags[:, _T.index(name)] = np.asarray(vals, np.uint64).astype(np.uint32)

    put("code_id", rng.choice([int(c) for c in CodeId if 1 <= c <= 8], n))
    put("agent_id", rng.choice([1, 77, 5], n))
    is_v6 = rng.random(n) < 0.2
    put("is_ipv6", is_v6)
    for side in (0, 1):
        words = np.zeros((n, 4), np.uint32)
        for i in range(n):
            ip = rng.choice(v6) if is_v6[i] else rng.choice(v4)
            words[i] = platform._ip_words(str(ip))[1]
        for w in range(4):
            put(f"ip{side}_w{w}", words[:, w])
    put("l3_epc_id", rng.choice([10, 12, platform.EPC_INTERNET, 0], n, p=[.6, .2, .1, .1]))
    put("l3_epc_id1", rng.choice([10, 12, platform.EPC_INTERNET], n, p=[.7, .2, .1]))
    for side in (0, 1):
        mac = rng.choice([0, 0x0050_5600_0001, 0xBEEF_0000_0001], n, p=[.6, .3, .1])
        put(f"mac{side}_hi", mac >> 32)
        put(f"mac{side}_lo", mac & 0xFFFFFFFF)
    put("pod_id", rng.choice([0, 101, 202, 555], n, p=[.5, .2, .2, .1]))
    put("gpid0", rng.choice([0, 9001, 9002, 31337], n, p=[.5, .3, .1, .1]))
    put("gpid1", rng.choice([0, 9001, 9002], n, p=[.6, .3, .1]))
    put("server_port", rng.choice([0, 80, 443, 9999], n))
    put("protocol", rng.choice([0, 6, 17], n))
    put("tap_side", rng.choice([0, 1, 2, 9], n))
    put("signal_source", rng.choice([0, 3, int(SignalSource.OTEL)], n))
    return tags


def _ref_enrich(state, tags, valid):
    s0, s1, keep, drops = ref_platform.enrich_docs(state, tags, valid)
    return ({k: np.asarray(v) for k, v in s0.items()},
            {k: np.asarray(v) for k, v in s1.items()}, np.asarray(keep), int(drops))


def _port_enrich(state, tags, valid):
    s0, s1, keep, drops = platform.enrich_docs(state, tags, valid)
    return ({k: to_numpy_u32(v) for k, v in s0.items()},
            {k: to_numpy_u32(v) for k, v in s1.items()}, keep.numpy(), int(drops))


def _assert_enrich_equal(got, want):
    for side in (0, 1):
        assert sorted(got[side]) == sorted(want[side]) == sorted(platform.ENRICH_FIELDS)
        for f in platform.ENRICH_FIELDS:
            assert got[side][f].dtype == want[side][f].dtype == np.uint32
            assert np.array_equal(got[side][f], want[side][f]), (side, f)
    assert np.array_equal(got[2], want[2])
    assert got[3] == want[3]


def test_hashtable_build_and_lookup_match_reference():
    rng = np.random.default_rng(7)
    n = 500
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    _, uniq = np.unique(hi.astype(np.uint64) << 32 | lo, return_index=True)
    hi, lo = hi[uniq], lo[uniq]
    vals = np.arange(len(hi), dtype=np.uint32)
    ref = ref_hashtable.build_table(hi, lo, vals)
    port = hashtable.build_table(hi, lo, vals, device=CPU)
    assert port.max_probes == ref.max_probes and port.capacity == ref.capacity
    for k in ("key_hi", "key_lo", "value"):
        assert np.array_equal(to_numpy_u32(getattr(port, k)), np.asarray(getattr(ref, k)))
    assert np.array_equal(port.filled.numpy(), np.asarray(ref.filled))

    miss_hi = rng.integers(0, 2**32, 64, dtype=np.uint32)
    miss_lo = np.full(64, 0xDEADBEEF, np.uint32)
    q_hi, q_lo = np.concatenate([hi, miss_hi]), np.concatenate([lo, miss_lo])
    want_v, want_f = ref.lookup(q_hi, q_lo)
    got_v, got_f = port.lookup(from_numpy_u32(q_hi, CPU), from_numpy_u32(q_lo, CPU))
    assert np.array_equal(to_numpy_u32(got_v), np.asarray(want_v))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f[:len(hi)].all() and np.array_equal(to_numpy_u32(got_v)[:len(hi)], vals)


def test_hashtable_duplicates_last_insert_wins_and_empty_table():
    hi = np.array([1, 2, 1, 3], np.uint32)
    lo = np.array([5, 6, 5, 7], np.uint32)
    vals = np.array([10, 20, 30, 40], np.uint32)
    port = hashtable.build_table(hi, lo, vals, device=CPU)
    ref = ref_hashtable.build_table(hi, lo, vals)
    v, f = port.lookup(from_numpy_u32(hi, CPU), from_numpy_u32(lo, CPU))
    rv, rf = ref.lookup(hi, lo)
    assert to_numpy_u32(v).tolist() == np.asarray(rv).tolist() == [30, 20, 30, 40]
    assert f.all() and np.asarray(rf).all()
    empty = hashtable.empty_table(CPU)
    v, f = empty.lookup(from_numpy_u32(hi, CPU), from_numpy_u32(lo, CPU))
    assert not f.any() and (to_numpy_u32(v) == hashtable.NOT_FOUND).all()
    assert empty.capacity == ref_hashtable.empty_table().capacity


@pytest.fixture(scope="module")
def states():
    out = {}
    for region in (MY_REGION, 0):
        ref = _make_platform(ref_platform, region).build()
        port = _make_platform(platform, region).build(device=CPU)
        out[region] = (ref, port)
    return out


def test_port_build_equals_reference_build(states):
    for ref, port in states.values():
        want = convert.platform_state_to_numpy(convert.platform_state_from_numpy(ref, CPU))
        got = convert.platform_state_to_numpy(port)
        assert sorted(got) == sorted(want)
        for k in ("infos", "gproc_rows", "my_region_id"):
            assert np.array_equal(got[k], want[k]), k
        for t in platform.TABLES:
            for lane in ("key_hi", "key_lo", "value", "filled", "max_probes"):
                assert np.array_equal(got[t][lane], want[t][lane]), (t, lane)
            assert np.array_equal(want[t]["key_hi"], np.asarray(getattr(ref, t).key_hi))


@pytest.mark.parametrize("region", [MY_REGION, 0])
def test_enrich_fixture_rows_match_reference(states, region):
    ref, port = states[region]
    rows = _fixture_rows()
    valid = np.ones(rows.shape[0], bool)
    valid[3] = False
    want = _ref_enrich(ref, rows, valid)
    got = _port_enrich(port, rows, valid)
    _assert_enrich_equal(got, want)
    if region:
        assert want[3] >= 2  # the region-filter rows drop


@pytest.mark.parametrize("region", [MY_REGION, 0])
def test_enrich_seeded_batch_matches_reference(states, region):
    ref, port = states[region]
    rows = np.concatenate([_fixture_rows(), _seeded_rows(4096 - 17, seed=11)])
    valid = np.random.default_rng(3).random(rows.shape[0]) < 0.95
    want = _ref_enrich(ref, rows, valid)
    got = _port_enrich(port, rows, valid)
    _assert_enrich_equal(got, want)
    # the batch reaches every branch it is meant to
    ts0 = got[0]["tag_source"]
    for bit in (platform.TS_GPID, platform.TS_POD_ID, platform.TS_MAC, platform.TS_EPC_IP,
                platform.TS_PEER):
        assert (ts0 & bit).any() or (got[1]["tag_source"] & bit).any(), bit
    assert (got[0]["service_id"] != 0).any() and (got[1]["service_id"] != 0).any()
    types = set(got[0]["auto_service_type"].tolist()) | set(got[1]["auto_service_type"].tolist())
    assert {platform.TYPE_CUSTOM_SERVICE, platform.TYPE_POD_SERVICE, platform.TYPE_IP,
            platform.TYPE_INTERNET_IP} <= types
    if region:
        assert 0 < got[3] < int(valid.sum())
    else:
        assert got[3] == 0 and np.array_equal(got[2], valid)


def test_enrich_on_carried_reference_state(states):
    """The reference's built state carried into the port: lookups and
    enrichment over it equal the reference's."""
    ref, _ = states[MY_REGION]
    carried = convert.platform_state_from_numpy(ref, CPU)
    keys = np.array([101, 202, 555, 0], np.uint32)
    want_v, want_f = ref.pod_t.lookup(np.zeros(4, np.uint32), keys)
    got_v, got_f = carried.pod_t.lookup(from_numpy_u32(np.zeros(4, np.uint32), CPU),
                                        from_numpy_u32(keys, CPU))
    assert np.array_equal(to_numpy_u32(got_v), np.asarray(want_v))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    rows = _seeded_rows(512, seed=5)
    valid = np.ones(512, bool)
    _assert_enrich_equal(_port_enrich(carried, rows, valid), _ref_enrich(ref, rows, valid))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _make_platform(platform).build()
