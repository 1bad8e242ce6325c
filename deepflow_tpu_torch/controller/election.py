"""Leader election — controller HA.

The reference elects a leader through a K8s Lease
(controller/election/election.go:207). Without K8s the equivalent
primitive is a lease *file*: candidates CAS a (holder, expiry) record
with O_EXCL tmp-file + atomic rename, renewing before expiry; a stale
lease (holder stopped renewing) is taken over after `lease_s`. Same
observable semantics: exactly one leader per lease file, automatic
failover on leader death, `is_leader()` for gating singleton work
(tagrecorder sync, downsampler ticks, retention).

Port copy of deepflow_tpu/controller/election.py.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path


class LeaderElection:
    def __init__(self, lease_path: str | Path, holder: str, *, lease_s: float = 5.0):
        self.path = Path(lease_path)
        self.holder = holder
        self.lease_s = lease_s
        self._leader = False
        self._expiry = 0.0  # expiry of OUR last successfully written lease
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.counters = {"acquires": 0, "renewals": 0, "losses": 0}

    # -- one CAS round --------------------------------------------------
    def try_acquire(self, now: float | None = None) -> bool:
        """One campaign round. The read-check-write is made atomic with
        an flock on a sidecar lock file — rename alone is not a CAS and
        two candidates racing an expired lease could both win."""
        now = time.time() if now is None else now
        with self._mutex():
            current = self._read()
            if current is not None:
                holder, expiry = current
                if holder != self.holder and expiry > now:
                    if self._leader:
                        self._leader = False
                        self.counters["losses"] += 1
                    return False
            took = self._write(now)
        if not took:
            # renewal failed (disk trouble): leadership cannot outlive the
            # last successfully-written lease — another node will take the
            # stale lease at expiry, so we must step down by then too
            if self._leader and now >= self._expiry:
                self._leader = False
                self.counters["losses"] += 1
            return self._leader
        self._expiry = now + self.lease_s
        if not self._leader:
            self._leader = True
            self.counters["acquires"] += 1
        else:
            self.counters["renewals"] += 1
        return True

    def _mutex(self):
        import contextlib
        import fcntl

        @contextlib.contextmanager
        def held():
            lockfile = self.path.with_suffix(".lock")
            with open(lockfile, "a+") as f:
                fcntl.lockf(f, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.lockf(f, fcntl.LOCK_UN)

        return held()

    def _read(self) -> tuple[str, float] | None:
        try:
            d = json.loads(self.path.read_text())
            return d["holder"], float(d["expiry"])
        except (OSError, ValueError, KeyError):
            return None

    def _write(self, now: float) -> bool:
        """Callers hold the flock mutex."""
        tmp = self.path.with_suffix(f".{self.holder}.{os.getpid()}.tmp")
        try:
            tmp.write_text(
                json.dumps({"holder": self.holder, "expiry": now + self.lease_s})
            )
            os.replace(tmp, self.path)  # atomic on POSIX
            return True
        except OSError:
            return False
        finally:
            tmp.unlink(missing_ok=True)

    def is_leader(self) -> bool:
        return self._leader

    # -- background campaign --------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        interval = self.lease_s / 3
        while not self._stop.wait(interval):
            self.try_acquire()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.lease_s)
            self._thread = None
        # release: let another candidate take over immediately; the
        # read-then-unlink runs under the same mutex as acquisition so a
        # freshly-acquired foreign lease is never deleted
        if self._leader:
            try:
                with self._mutex():
                    cur = self._read()
                    if cur and cur[0] == self.holder:
                        self.path.unlink(missing_ok=True)
            except OSError:
                pass
            self._leader = False
