"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of deepflow_tpu_torch,
chip_smoke.py, tests/torch_mesh_harness.py and tests/torch_wire_host.py
with every module those helpers import (the harness imports them inside
its functions, so they are found by walking their source), then lists
sys.modules. Names are checked exactly: the
port's own package name starts with "deepflow_tpu", so a prefix test
on that string would match the port itself."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, json, pkgutil, sys
import deepflow_tpu_torch
names = [m.name for m in pkgutil.walk_packages(deepflow_tpu_torch.__path__, "deepflow_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import ast
sys.path.insert(0, "tests")
import torch_mesh_harness, torch_wire_host
harness = set()
for helper in (torch_mesh_harness, torch_wire_host):
    tree = ast.parse(open(helper.__file__).read())
    harness |= {n.module if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names}
harness = sorted(harness)
for name in harness:
    importlib.import_module(name)
print(json.dumps({"imported": names, "harness": harness, "modules": sorted(sys.modules)}))
"""


def _is_forbidden(name: str) -> bool:
    return (name in ("jax", "deepflow_tpu")
            or name.startswith("jax.") or name.startswith("deepflow_tpu."))


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300, check=True,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # every package of the slice was walked and imported
    for mod in ("datamodel.code", "ingest.replay", "ops.u32", "ops.hashing",
                "ops.segreduce", "ops.segment", "aggregator.fanout",
                "aggregator.stash", "aggregator.window", "aggregator.pipeline",
                "convert", "kernels.build", "ops.hll", "ops.cms", "ops.histogram",
                "ops.tdigest", "ops.topk", "ops.sketch_fused", "aggregator.sketchplane",
                "aggregator.checkpoint", "chaos", "chaos.plan", "feeder", "feeder.flowframe",
                "feeder.journal", "feeder.runtime", "ingest.framing", "ingest.queues",
                "utils", "utils.retry", "utils.spans", "parallel", "parallel.mesh",
                "parallel.topology", "parallel.sharded", "utils.stats", "ops.hashtable",
                "enrich", "enrich.platform", "ingest.codec", "ingest.receiver", "server",
                "server.flow_metrics", "server.metrics_tables", "server.datasource",
                "storage", "storage.store", "storage.writer", "storage.flow_tag", "querier",
                "querier.engine", "querier.live", "querier.sqlparse", "querier.translation",
                "querier.metrics", "flowlog", "flowlog.schema", "flowlog.aggr",
                "flowlog.codec", "flowlog.oracle", "flowlog.server", "agent", "agent.packet",
                "agent.pcap", "agent.dispatcher", "agent.possible", "agent.flow_map",
                "agent.bridge", "agent.policy", "agent.capture", "agent.main", "agent.l7",
                "agent.l7.engine", "agent.l7.http2", "agent.l7.parsers", "agent.l7.parsers_ext",
                "agent.l7.parsers_mq", "agent.l7.parsers_rpc", "agent.l7.parsers_w4",
                "agent.l7.plugins", "ingest.sender", "profiling", "profiling.ledger",
                "profiling.census", "integration", "integration.formats",
                "integration.dfstats", "utils.provenance", "tracing", "tracing.tree",
                "tracing.builder", "tracing.query", "tracing.lineage", "querier.events",
                "querier.promql", "querier.subscribe", "querier.alerts",
                "parallel.hostproc", "parallel.rebalance", "ingest.handoff", "controller",
                "controller.rebalance", "fleet", "fleet.frame", "fleet.sink",
                "fleet.aggregator", "utils.config", "utils.agent_config",
                "integration.trace_imports", "integration.collector", "storage.issu",
                "storage.monitor", "controller.resources", "controller.recorder",
                "controller.genesis", "controller.election", "controller.cloud",
                "controller.tagrecorder", "controller.prom_labels", "controller.trisolaris",
                "controller.rest", "querier.profile", "server.events", "server.exporters",
                "server.kafka_exporter", "server.integration", "server.debug", "server.mcp",
                "server.main", "cli", "device", "native", "wire", "wire.frame", "wire.hub",
                "wire.publisher", "wire.router", "oracle", "oracle.numpy_oracle",
                "agent.ebpf_bridge", "agent.symbolizer", "controller.cloud_adapters",
                "controller.trident_grpc", "utils.geo", "utils.segmenttree"):
        assert f"deepflow_tpu_torch.{mod}" in result["imported"]
    # the helpers chip_smoke spawns reach the port's multi-process modules
    for mod in ("parallel.topology", "parallel.hostproc", "parallel.rebalance",
                "ingest.handoff", "fleet", "wire.publisher"):
        assert f"deepflow_tpu_torch.{mod}" in result["harness"]
    assert not [m for m in result["harness"] if _is_forbidden(m)]
    forbidden = [m for m in result["modules"] if _is_forbidden(m)]
    assert forbidden == []
    assert "deepflow_tpu_torch" in result["modules"]


def test_forbidden_name_check_is_exact():
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert _is_forbidden("deepflow_tpu") and _is_forbidden("deepflow_tpu.ops.segment")
    assert not _is_forbidden("deepflow_tpu_torch")
    assert not _is_forbidden("deepflow_tpu_torch.ops.segment")
    assert not _is_forbidden("jaxlib")


# the Pallas kernel files, ported by their wrappers' modules
PALLAS_PORTS = {"ops/segreduce_pallas.py": "ops/segreduce.py",
                "ops/sketch_pallas.py": "ops/sketch_fused.py"}


def test_every_reference_module_has_a_port():
    """Every .py of deepflow_tpu/ has a counterpart at the same relative
    path in deepflow_tpu_torch/ (the Pallas files at their wrappers')."""
    ref, port = REPO / "deepflow_tpu", REPO / "deepflow_tpu_torch"
    rels = sorted(str(p.relative_to(ref)) for p in ref.rglob("*.py"))
    assert len(rels) > 140
    missing = [r for r in rels if not (port / PALLAS_PORTS.get(r, r)).is_file()]
    assert missing == []
    assert all((ref / r).is_file() for r in PALLAS_PORTS)
