"""The import guard: nothing the harness loads is JAX or the JAX
package (top-level names compared whole — the port's own name starts
with the JAX package's), and the reference loads nothing of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import harness as H

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
REFERENCE_SIDE = ("benchmark.reference", "benchmark.sketch_ref", "benchmark.generators.flows",
                  "benchmark.u32", "benchmark.schema", "benchmark.work", "benchmark.control",
                  "benchmark.checks.l4_rollup", "benchmark.size_mixes")


def _top_names(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        bad = _top_names(path) & set(H.FORBIDDEN_MODULES)
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_forbidden_loaded_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deepflow_tpu_torch_lookalike", sys)
    assert "deepflow_tpu" not in H.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "deepflow_tpu.ops", sys)
    assert H.forbidden_loaded() == ["deepflow_tpu"]


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_reference_side_loads_nothing_of_the_port():
    code = ("import json, sys\n"
            + "".join(f"import {m}\n" for m in REFERENCE_SIDE)
            + "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    loaded = set(_run(code))
    assert not loaded & {"deepflow_tpu_torch", "deepflow_tpu", "jax", "jaxlib", "flax"}


def test_a_whole_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        "from benchmark.tests.conftest import tiny_spec\n"
        "from benchmark import harness as H\n"
        "res = H.run_cell(tiny_spec('exact.lowcard', tuples=300), 77, 0.2, False, 'cpu')\n"
        "print(json.dumps({'bad': H.forbidden_loaded(), 'correct': res['correct'],\n"
        "                  'port': 'deepflow_tpu_torch' in sys.modules}))\n")
    got = _run(code)
    assert got == {"bad": [], "correct": True, "port": True}
