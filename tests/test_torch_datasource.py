"""The port's Downsampler (server/datasource.py) against the reference's,
on the CPU, over one seeded store (the shape of tests/test_datasource.py:
every column of network_1s, a few keyed tag columns, a string column,
integer-valued f32 meters):

  * 1s → 1h for both unsummable choices (avg and max): the derived
    tables are equal column for column — tags and integer-valued sums
    bit-equal, averages within rtol 1e-5 — with equal counters;
  * the chained 1h → 1d rollup over 25 hours, in dependency order;
  * the watermark across a restart: a store directory the port rolled is
    not re-rolled by a restarted port Downsampler, nor by the
    reference's over the same directory;
  * `register_cascade_tiers` / `list_cascade_tiers`, and the port's
    cascade pipeline listing its 1 m / 1 h tiers as the reference's does,
    weakly held.

The minute tier cannot be a datasource: `network_1m` is a natively
ingested table, which both packages' `Downsampler.add` refuses.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from deepflow_tpu.aggregator.cascade import CascadeConfig as RefCascadeConfig
from deepflow_tpu.aggregator.pipeline import L4Pipeline as RefL4Pipeline
from deepflow_tpu.aggregator.pipeline import PipelineConfig as RefPipelineConfig
from deepflow_tpu.aggregator.window import WindowConfig as RefWindowConfig
from deepflow_tpu.server import datasource as ref_ds
from deepflow_tpu.storage.store import ColumnarStore as RefStore
from deepflow_tpu_torch.aggregator.cascade import CascadeConfig
from deepflow_tpu_torch.aggregator.pipeline import L4Pipeline, PipelineConfig
from deepflow_tpu_torch.aggregator.window import WindowConfig
from deepflow_tpu_torch.server import datasource
from deepflow_tpu_torch.server.metrics_tables import MetricsTableID, table_schema
from deepflow_tpu_torch.storage.store import ColumnarStore

CPU = torch.device("cpu")
T0 = 1_700_000_000 - (1_700_000_000 % 3600)
DB = "flow_metrics"
# the tag columns that vary (the rest hold one value an hour), so groups
# take several rows and the avg choice matters
_KEYED = ("tap_side", "protocol", "region_id_0", "auto_service_id_1")


def _fill(stores, *, hours: int, rows_per_hour: int, seed: int):
    """The same seeded network_1s rows into every store."""
    rng = np.random.default_rng(seed)
    schema = table_schema(MetricsTableID.NETWORK_1S)
    for s in stores:
        s.create_table(DB, schema)
    for h in range(hours):
        n = rows_per_hour
        cols = {}
        for c in schema.columns:
            if c.name == "time":
                cols["time"] = (T0 + h * 3600 + rng.integers(0, 3600, n)).astype(np.uint32)
            elif c.name == "app_service":
                cols[c.name] = np.array([f"svc-{i}" for i in rng.integers(0, 3, n)],
                                        dtype=c.dtype)
            elif c.dtype.startswith("U"):
                cols[c.name] = np.full(n, "", dtype=c.dtype)
            elif c.dtype == "f4":
                cols[c.name] = rng.integers(0, 100, n).astype(np.float32)
            elif c.name in _KEYED:
                cols[c.name] = rng.integers(0, 4, n).astype(np.uint32)
            else:
                cols[c.name] = np.full(n, h % 3, np.uint32)
        for s in stores:
            s.insert(DB, "network_1s", cols)


def _canonical(cols: dict) -> dict:
    names = sorted(cols)
    keys = [np.unique(cols[k], return_inverse=True)[1] for k in names]
    order = np.lexsort(keys[::-1])
    return {k: np.asarray(cols[k])[order] for k in names}


def _assert_tables_equal(port_store, ref_store, table):
    got = _canonical(port_store.scan(DB, table))
    want = _canonical(ref_store.scan(DB, table))
    assert sorted(got) == sorted(want)
    assert len(want["time"]) > 0
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype, k
        if w.dtype.kind == "f" and not np.array_equal(w, np.round(w)):
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("aggr", ["avg", "max"])
def test_rollup_1s_to_1h_matches_reference(aggr):
    port_store, ref_store = ColumnarStore(), RefStore()
    _fill([port_store, ref_store], hours=2, rows_per_hour=500, seed=7)
    port = datasource.Downsampler(port_store, delay_s=0, device=CPU)
    ref = ref_ds.Downsampler(ref_store, delay_s=0)
    port.add(datasource.DataSource(base_table="network_1s", interval="1h",
                                   aggr_unsummable=aggr))
    ref.add(ref_ds.DataSource(base_table="network_1s", interval="1h", aggr_unsummable=aggr))
    now = T0 + 2 * 3600 + 100
    written = port.process(now)
    assert written == ref.process(now) > 0
    assert port.get_counters() == ref.get_counters()
    _assert_tables_equal(port_store, ref_store, "network_1h")
    meters = port_store.scan(DB, "network_1h", columns=["rtt_max", "packet_tx"])
    if aggr == "avg":  # unsummable means are fractional somewhere
        assert not np.array_equal(meters["rtt_max"], np.round(meters["rtt_max"]))
    assert meters["packet_tx"].sum() == port_store.scan(DB, "network_1s")["packet_tx"].sum()


def test_chained_1h_to_1d_matches_reference():
    port_store, ref_store = ColumnarStore(), RefStore()
    _fill([port_store, ref_store], hours=25, rows_per_hour=40, seed=3)
    port = datasource.Downsampler(port_store, delay_s=0, device=CPU)
    ref = ref_ds.Downsampler(ref_store, delay_s=0)
    for mod, dsm in ((datasource, port), (ref_ds, ref)):
        # the coarse source first: processing must still run fine → coarse
        dsm.add(mod.DataSource(base_table="network_1s", interval="1h"))
        dsm.add(mod.DataSource(base_table="network_1h", interval="1d"))
        dsm.delete("network_1h")
        dsm.add(mod.DataSource(base_table="network_1s", interval="1h"))
    assert [d.name for d in port.list()] == [d.name for d in ref.list()] == [
        "network_1d", "network_1h"]
    now = T0 + 25 * 3600 + 100
    assert port.process(now) == ref.process(now)
    for table in ("network_1h", "network_1d"):
        _assert_tables_equal(port_store, ref_store, table)
    assert port.get_counters() == ref.get_counters()


def test_watermark_survives_restart_across_packages(tmp_path):
    store = ColumnarStore(tmp_path)
    _fill([store], hours=1, rows_per_hour=20, seed=5)
    dsm = datasource.Downsampler(store, delay_s=0, device=CPU)
    dsm.add(datasource.DataSource(base_table="network_1s", interval="1h"))
    rolled = dsm.process(T0 + 3700)
    assert rolled > 0
    # a restarted port Downsampler over the same root re-adds the
    # datasource and must not re-roll the processed chunk
    store2 = ColumnarStore(tmp_path)
    dsm2 = datasource.Downsampler(store2, delay_s=0, device=CPU)
    dsm2.add(datasource.DataSource(base_table="network_1s", interval="1h"))
    assert dsm2.process(T0 + 3800) == 0
    assert store2.row_count(DB, "network_1h") == rolled
    # nor does the reference's, reading the port's watermark table
    ref_store = RefStore(tmp_path)
    ref = ref_ds.Downsampler(ref_store, delay_s=0)
    ds = ref.add(ref_ds.DataSource(base_table="network_1s", interval="1h"))
    assert ds.watermark == T0 // 3600
    assert ref.process(T0 + 3800) == 0
    assert ref_store.row_count(DB, "network_1h") == rolled


def test_registry_validation_matches_reference():
    for mod, store in ((datasource, ColumnarStore()), (ref_ds, RefStore())):
        _fill([store], hours=1, rows_per_hour=10, seed=1)
        dsm = (mod.Downsampler(store, device=CPU) if mod is datasource
               else mod.Downsampler(store))
        with pytest.raises(ValueError, match="natively-ingested"):
            dsm.add(mod.DataSource(base_table="network_1s", interval="1m"))
        with pytest.raises(ValueError):
            mod.DataSource(base_table="network_1s", interval="5m")


def test_cascade_tiers_listed_as_the_reference_lists_them():
    casc = dict(intervals=(60, 3600), capacity=1 << 12)
    win = dict(capacity=1 << 12)
    port_pipe = L4Pipeline(PipelineConfig(window=WindowConfig(
        cascade=CascadeConfig(**casc), **win), batch_size=512), device=CPU)
    ref_pipe = RefL4Pipeline(RefPipelineConfig(window=RefWindowConfig(
        cascade=RefCascadeConfig(**casc), **win), batch_size=512))
    got = datasource.list_cascade_tiers()
    want = ref_ds.list_cascade_tiers()
    names = {"network_1m", "network_1h", "network_map_1m", "network_map_1h"}
    assert names <= {r["name"] for r in got}
    for row in got:
        assert row in want
        assert row["served_by"] == "cascade" and row["base_table"].endswith("_1s")
    # weakly held: a tier only this pipeline serves leaves with it (other
    # modules' pipelines may still serve the 1 m / 1 h tiers)
    odd = L4Pipeline(PipelineConfig(window=WindowConfig(
        cascade=CascadeConfig(intervals=(60, 7200), capacity=1 << 12), **win),
        batch_size=512), device=CPU)
    assert "network_7200s" in {r["name"] for r in datasource.list_cascade_tiers()}
    del port_pipe, ref_pipe, odd
    gc.collect()
    assert "network_7200s" not in {r["name"] for r in datasource.list_cascade_tiers()}


def test_register_cascade_tiers_weak_and_permanent():
    class Owner:
        pass

    owner = Owner()
    datasource.register_cascade_tiers("usage", (86400,), owner=owner)
    ref_ds.register_cascade_tiers("usage", (86400,), owner=owner)
    row = {"name": "traffic_policy_1d", "base_table": "traffic_policy_1s",
           "interval": "1d", "served_by": "cascade"}
    assert row in datasource.list_cascade_tiers() and row in ref_ds.list_cascade_tiers()
    del owner
    gc.collect()
    assert row not in datasource.list_cascade_tiers()
    assert row not in ref_ds.list_cascade_tiers()
