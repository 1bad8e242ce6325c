"""The port imports neither JAX nor the JAX package.

A fresh interpreter imports every module of deepflow_tpu_torch and
chip_smoke.py, then lists sys.modules. Names are checked exactly: the
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
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
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
                "convert", "kernels.build"):
        assert f"deepflow_tpu_torch.{mod}" in result["imported"]
    forbidden = [m for m in result["modules"] if _is_forbidden(m)]
    assert forbidden == []
    assert "deepflow_tpu_torch" in result["modules"]


def test_forbidden_name_check_is_exact():
    assert _is_forbidden("jax") and _is_forbidden("jax.numpy")
    assert _is_forbidden("deepflow_tpu") and _is_forbidden("deepflow_tpu.ops.segment")
    assert not _is_forbidden("deepflow_tpu_torch")
    assert not _is_forbidden("deepflow_tpu_torch.ops.segment")
    assert not _is_forbidden("jaxlib")
