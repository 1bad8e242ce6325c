"""Bench provenance stamp (port of deepflow_tpu/utils/provenance.py).

Every bench or card record embeds the exact config it measured: git SHA
(+dirty flag), platform identity, and a snapshot of the `DEEPFLOW_*` env
knobs — so a PERF.md column is attributable to a commit and a knob set.
In place of the reference's jax / jaxlib versions the port stamps
torch's version, its CUDA version (`torch.version.cuda`) and the
GPU driver's, and the GPU's name and power limit as `nvidia-smi
--query-gpu=name,power.limit,driver_version --format=csv,noheader` gives
them; without `nvidia-smi` (a CPU host) those keys are left out.
"""

from __future__ import annotations


def bench_provenance() -> dict:
    import os
    import platform
    import subprocess
    import time

    sha = None
    dirty = None
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=10, cwd=here,
        ).stdout.strip() or None
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, timeout=10, cwd=here,
        ).stdout.strip())
    except Exception:
        pass  # benches must run from an exported tree too
    out = {
        "git_sha": sha,
        "git_dirty": dirty,
        "time": int(time.time()),
        "platform": {
            "python": platform.python_version(),
            "system": platform.system(),
            "release": platform.release(),
            "machine": platform.machine(),
            "cpus": os.cpu_count(),
        },
        # the knob snapshot: every DEEPFLOW_* flag (shared sort, fused
        # gather, …) — the flip decisions PERF.md tracks hinge on these
        "env": {
            k: v for k, v in sorted(os.environ.items()) if k.startswith("DEEPFLOW_")
        },
    }
    try:
        import torch

        out["platform"]["torch"] = torch.__version__
        out["platform"]["cuda"] = torch.version.cuda
    except Exception:
        pass
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=10,
        )
        line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
        name, power, driver = (x.strip() for x in line.split(","))
        out["platform"].update(gpu=name, power_limit=power, driver_version=driver)
    except Exception:
        pass  # no nvidia-smi (or no card): the GPU keys are left out
    return out
