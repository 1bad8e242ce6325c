"""Shared fixtures of the benchmark's own tests: the cells of
BENCHMARK.json cut to a size the CPU runs in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MIX = dict(records_per_batch=4096, tuples=3000, pod_ips=500, pool_batches=3)
TINY_SIZES = dict(batch_unique_cap=4096, capacity=1 << 15)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips elsewhere (run with `pytest -m cuda "
        "benchmark/tests` on the card)")


def tiny_spec(workload: str, *, batch_unique_cap=None, capacity=None, **mix):
    """The cell's spec with its traffic cut to TINY_MIX and its tables to
    TINY_SIZES (widths, shapes and the configuration's other settings
    unchanged)."""
    from benchmark import harness as H

    spec = H.load_spec(workload)
    spec.mix.update(TINY_MIX, **mix)
    pipe = spec.config["pipeline"]["config"]
    pipe["batch_size"] = spec.mix["records_per_batch"]
    pipe["batch_unique_cap"] = batch_unique_cap or TINY_SIZES["batch_unique_cap"]
    pipe["window"]["capacity"] = capacity or TINY_SIZES["capacity"]
    return spec


@pytest.fixture
def tiny():
    return tiny_spec
