"""Port parity: `fanout_l4` / `fanout_l7` give bit-equal doc lanes.

Seeded streams draw every direction (pure, sided, local, none), every
signal source (Packet, XFlow, eBPF, OTel), TCP/UDP/other protocols,
Internet and negative EPCs, vip/active flags and L7 protocols known or
not, so every emission gate of the four lanes fires; each config knob
runs on and off."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepflow_tpu.aggregator.fanout import FanoutConfig as RefFanoutConfig
from deepflow_tpu.aggregator.fanout import fanout_l4 as ref_fanout_l4
from deepflow_tpu.aggregator.fanout import fanout_l7 as ref_fanout_l7
from deepflow_tpu.datamodel.batch import FLOW_RECORD_TAG_FIELDS
from deepflow_tpu.datamodel.code import Direction, SignalSource
from deepflow_tpu_torch.aggregator.fanout import FanoutConfig, fanout_l4, fanout_l7
from deepflow_tpu_torch.datamodel.schema import APP_METER, FLOW_METER
from deepflow_tpu_torch.ops.u32 import from_numpy_u32, to_numpy_u32

# Each xdist worker imports every test module: one torch thread per
# worker keeps torch's CPU pool from oversubscribing the parallel suite
# (its timing-bound perf-gate tests share the cores).
torch.set_num_threads(1)

DIRECTIONS = np.array([int(d) for d in Direction], np.uint32)
SOURCES = np.array([int(s) for s in SignalSource], np.uint32)


def _stream(seed: int, n: int, num_meters: int):
    rng = np.random.default_rng(seed)

    def pick(values):
        return rng.choice(np.asarray(values, np.uint32), n)

    tags = {f: rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
            for f in FLOW_RECORD_TAG_FIELDS}
    tags.update(
        direction0=pick(DIRECTIONS), direction1=pick(DIRECTIONS),
        signal_source=pick(SOURCES), protocol=pick([6, 17, 1]),
        l3_epc_id=pick([0, 5, 0xFFFE, 0x8001, 0xFFFFFFFE]),
        l3_epc_id1=pick([0, 9, 0xFFFE, 0xFFFF]),
        is_active_host0=pick([0, 1]), is_active_host1=pick([0, 1]),
        is_vip0=pick([0, 1]), is_vip1=pick([0, 1]),
        is_active_service=pick([0, 1]), l7_protocol=pick([0, 20, 41]),
        server_port=pick([0, 80, 443]), is_ipv6=pick([0, 1]),
    )
    meters = rng.integers(0, 5000, (n, num_meters)).astype(np.float32)
    valid = rng.random(n) < 0.9
    return tags, meters, valid


@pytest.mark.parametrize("app", [False, True], ids=["l4", "l7"])
@pytest.mark.parametrize("inactive_ip", [False, True], ids=["ip_kept", "ip_aggr"])
@pytest.mark.parametrize("inactive_port", [False, True], ids=["port_kept", "port_aggr"])
def test_fanout_bit_equal(app, inactive_ip, inactive_port):
    schema = APP_METER if app else FLOW_METER
    tags, meters, valid = _stream(seed=21 + 2 * app + inactive_ip, n=600,
                                  num_meters=schema.num_fields)
    kw = dict(inactive_ip_aggregation=inactive_ip,
              inactive_server_port_aggregation=inactive_port,
              agent_id=3, global_thread_id=2)
    ref_fn = ref_fanout_l7 if app else ref_fanout_l4
    fn = fanout_l7 if app else fanout_l4
    ref = ref_fn({k: jnp.asarray(v) for k, v in tags.items()}, jnp.asarray(meters),
                 jnp.asarray(valid), RefFanoutConfig(**kw))
    got = fn({k: from_numpy_u32(v, "cpu") for k, v in tags.items()},
             torch.from_numpy(meters), torch.from_numpy(valid), FanoutConfig(**kw))
    r_tags, r_meters, r_ts, r_valid = (np.asarray(x) for x in ref)
    g_tags, g_meters, g_ts, g_valid = got
    np.testing.assert_array_equal(r_tags, to_numpy_u32(g_tags))
    np.testing.assert_array_equal(r_meters.view(np.uint32),
                                  g_meters.numpy().view(np.uint32))
    np.testing.assert_array_equal(r_ts, to_numpy_u32(g_ts))
    np.testing.assert_array_equal(r_valid, g_valid.numpy())
    # the stream really exercises the gates: some lanes drop, some emit
    assert 0 < r_valid.sum() < r_valid.size
