"""Deterministic fault injection for the feeder→device→flush path (port
copy of deepflow_tpu/chaos/plan.py; same sites, rules and fault
taxonomy).

  * a `FaultPlan` holds `FaultRule`s keyed by **site** — the named seams
    the production code has (device dispatch, host fetch, feeder decode,
    journal/checkpoint I/O);
  * production seams call `chaos.maybe_fail(site)`, a no-op (one global
    read) unless a plan is installed;
  * rules fire on exact per-site call indices (`at=(3, 7)`), windows
    (`start/count/every`), or a seeded probability (`p=`), so every
    scenario reproduces bit for bit;
  * `KillPoint` derives from BaseException: it models *process death*
    and pierces every containment layer (retry loops and quarantine
    guards catch Exception only), so recovery tests can kill a pipeline
    mid-flush and rebuild from journal + checkpoint.

The plan is process-global: install it for one scenario and uninstall
it in a `finally` (tests: an autouse fixture), and start no thread that
crosses a seam while a plan is installed — the thread's calls would
shift the per-site indices the rules count.

The seams of the port (a `chaos.maybe_fail(site)` call each):

    site              fires in                          covers
    ----------------  --------------------------------  -----------------------------
    device.dispatch   aggregator/window.py              the append step's dispatch
                      (WindowManager.ingest_step)       (before the step runs)
    host.fetch        aggregator/window.py              every device→host fetch of
                      (WindowManager._fetch)            the window protocol
    feeder.decode     feeder/runtime.py                 sink codec decode (poisoned-
                      (FrameCodecBase.decode_frame)     frame quarantine boundary)
    checkpoint.io     aggregator/checkpoint.py          window-state snapshot write
    journal.io        feeder/journal.py                 frame-journal append/rotate

`sink.write`, `handoff.send`, `rebalance.step` and `wire.send` keep their
names so plans written for the reference load here, but no port module
fires them yet (storage, the handoff transport, rebalancing and the wire
plane are not ported).
"""

from __future__ import annotations

import dataclasses
import random
import threading
from contextlib import contextmanager

from ..utils.retry import TransientError

# ---------------------------------------------------------------------------
# fault sites — the seams production code exposes to the plan

SITE_DISPATCH = "device.dispatch"  # append-step dispatch (WindowManager)
SITE_FETCH = "host.fetch"  # device→host fetch (WindowManager._fetch seam)
SITE_DECODE = "feeder.decode"  # sink codec decode (quarantine boundary)
SITE_SINK_WRITE = "sink.write"  # storage TableWriter → store.insert
SITE_CHECKPOINT_IO = "checkpoint.io"  # window-state snapshot write
SITE_JOURNAL_IO = "journal.io"  # frame-journal append/rotate
SITE_HANDOFF_SEND = "handoff.send"  # misroute-handoff transport write
SITE_REBALANCE_STEP = "rebalance.step"  # shard-group handover protocol step
SITE_WIRE_SEND = "wire.send"  # DFPUSH publisher result/alert upload write

FAULT_SITES = (
    SITE_DISPATCH,
    SITE_FETCH,
    SITE_DECODE,
    SITE_SINK_WRITE,
    SITE_CHECKPOINT_IO,
    SITE_JOURNAL_IO,
    SITE_HANDOFF_SEND,
    SITE_WIRE_SEND,
    SITE_REBALANCE_STEP,
)


# ---------------------------------------------------------------------------
# fault taxonomy

class InjectedFault(Exception):
    """Base marker for every chaos-raised failure."""


class TransientDeviceError(TransientError, InjectedFault):
    """RESOURCE_EXHAUSTED-style admission failure: the dispatch never
    started; the retry policy may re-issue it."""


class FetchTimeout(TransientError, InjectedFault):
    """host_fetch deadline blown; retryable — the device tensor is
    still valid."""


class DeviceLost(InjectedFault):
    """Non-transient device failure: retrying is unsound (the step may
    have written its in-place buffers); containment must degrade
    instead."""


class SinkWriteError(InjectedFault, OSError):
    """Storage/sink write failure (an OSError)."""


class CheckpointIOError(InjectedFault, OSError):
    """Checkpoint snapshot I/O failure (disk full, volume gone)."""


class KillPoint(BaseException):
    """Simulated process death. BaseException on purpose: retry and
    quarantine guards catch Exception, so a KillPoint rips straight
    through to the code running the scenario, as SIGKILL would — nothing
    in-process may 'handle' its own death."""


class RebalanceAbortError(Exception):
    """An ownership handover could not complete: `FeederRuntime.quiesce`
    never drained, or its barrier checkpoint aborted. The old owner keeps
    serving, nothing has moved."""


# ---------------------------------------------------------------------------
# rules + plan


@dataclasses.dataclass
class FaultRule:
    """Fires `error` at matching per-site call indices (0-based).

    `at`: explicit index tuple (wins over start/count/every).
    `start/count/every`: fire `count` times, at indices start,
    start+every, … . `p`: instead of index matching, fire with
    probability p per call (seeded by the plan — deterministic),
    still bounded by `count`.
    """

    site: str
    error: type | BaseException = TransientDeviceError
    at: tuple[int, ...] | None = None
    start: int = 0
    count: int = 1
    every: int = 1
    p: float | None = None

    def _matches(self, n: int, fired: int, rng: random.Random) -> bool:
        if fired >= self.count and self.at is None:
            return False
        if self.at is not None:
            return n in self.at
        if self.p is not None:
            return n >= self.start and rng.random() < self.p
        return n >= self.start and (n - self.start) % max(1, self.every) == 0

    def _make(self) -> BaseException:
        if isinstance(self.error, BaseException):
            return self.error
        return self.error(f"injected fault at {self.site}")


class FaultPlan:
    """A seeded, scriptable fault schedule over the named sites.

    Thread-safe (the feeder pump, writer flusher and collector tick all
    cross seams concurrently). Per-site call counts and injection
    counts are exposed for test assertions; `calls`/`injected` survive
    uninstall so a finished scenario can still be audited.
    """

    def __init__(self, seed: int = 0, rules: list[FaultRule] | None = None):
        self.seed = seed
        self.rules = list(rules or ())
        self.calls: dict[str, int] = {}
        self.injected: dict[str, int] = {}
        self._rng = random.Random(seed)
        self._fired: dict[int, int] = {}  # id(rule) → times fired
        self._lock = threading.Lock()

    def add(self, *rules: FaultRule) -> "FaultPlan":
        self.rules.extend(rules)
        return self

    def fire(self, site: str) -> None:
        """Count one call at `site`; raise if a rule matches."""
        with self._lock:
            n = self.calls.get(site, 0)
            self.calls[site] = n + 1
            for rule in self.rules:
                if rule.site != site:
                    continue
                fired = self._fired.get(id(rule), 0)
                if rule._matches(n, fired, self._rng):
                    self._fired[id(rule)] = fired + 1
                    self.injected[site] = self.injected.get(site, 0) + 1
                    raise rule._make()


# ---------------------------------------------------------------------------
# the global hook production seams consult

_active: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    global _active
    _active = plan
    return plan


def uninstall() -> None:
    global _active
    _active = None


@contextmanager
def active(plan: FaultPlan):
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def maybe_fail(site: str) -> None:
    """THE seam: free when no plan is installed."""
    plan = _active
    if plan is not None:
        plan.fire(site)


# ---------------------------------------------------------------------------
# byte-level corruption (the decode fault class arrives as data)


def truncate_frame(raw: bytes, rng: random.Random) -> bytes:
    """Cut a frame at a random interior point (1 ≤ cut < len)."""
    if len(raw) < 2:
        return raw[:0]
    return raw[: rng.randrange(1, len(raw))]


def bitflip_frame(raw: bytes, rng: random.Random, flips: int = 4) -> bytes:
    """Flip `flips` random bits anywhere in the frame."""
    buf = bytearray(raw)
    if not buf:
        return bytes(buf)
    for _ in range(flips):
        i = rng.randrange(len(buf))
        buf[i] ^= 1 << rng.randrange(8)
    return bytes(buf)
