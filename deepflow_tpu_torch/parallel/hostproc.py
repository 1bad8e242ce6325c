"""Process-lifecycle helpers for multi-process runs (port of
deepflow_tpu/parallel/hostproc.py).

Shared by the programs that spawn a real N-process deployment
(tests/torch_mesh_harness.py and chip_smoke.py's phase 3p). Both need
the same two pieces, and a fix to either must land once:

* **clean_env** — the child's environment for the device it was asked
  to run on: a CPU child sees no CUDA device at all
  (`CUDA_VISIBLE_DEVICES=""`), so it cannot quietly touch a card; a
  card child keeps the card it inherits, and fails loudly when it has
  none.
* **the done-file exit barrier** — rank 0 hosts the process group's
  `TCPStore`, so it must outlive every peer's use of it, while no
  process may enter `destroy_process_group` once a peer has died (it
  wedges on the missing peer). Each host therefore writes its results
  durably, marks done, waits for its peers' marks, and `os._exit`s —
  skipping atexit entirely.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def clean_env(device="cuda") -> dict:
    """Subprocess environment for a child that runs on `device`: "cpu"
    hides every CUDA device; a CUDA device leaves the environment as it
    is (the child then raises if the card is not visible)."""
    env = dict(os.environ)
    if str(device).split(":")[0] == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def mark_done(workdir, process_id: int) -> None:
    """Durably mark this host's work complete (a dying host marks
    BEFORE os._exit so peers stop waiting on it)."""
    (Path(workdir) / f"done.p{process_id}").write_text("1")


def await_peers(workdir, process_id: int, num_processes: int,
                timeout_s: float = 120.0) -> bool:
    """Block until every peer has marked done (or timeout). Returns
    True when all marks were seen."""
    others = [
        Path(workdir) / f"done.p{q}"
        for q in range(num_processes) if q != process_id
    ]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if all(o.exists() for o in others):
            return True
        time.sleep(0.05)
    return False


def exit_after_barrier(workdir, process_id: int, num_processes: int,
                       *, rc: int = 0, timeout_s: float = 120.0) -> None:
    """mark done → wait for peers → os._exit(rc), skipping the process
    group's teardown (see module docstring)."""
    mark_done(workdir, process_id)
    if num_processes > 1:
        await_peers(workdir, process_id, num_processes,
                    timeout_s=timeout_s)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
