"""Bounded retry with exponential backoff + jitter (port copy of
deepflow_tpu/utils/retry.py) — the transient-failure policy of the
WindowManager's dispatch and fetch seams.

One function: classify, back off exponentially with jitter (decorrelated
retries — N managers must not re-dial a recovering device in lockstep),
give up after a bounded number of attempts.

What counts as transient differs from the reference. Its markers are
XLA status strings (RESOURCE_EXHAUSTED, DEADLINE_EXCEEDED, UNAVAILABLE,
ABORTED) read from runtime error text. Eager PyTorch reports none of
them, and a CUDA error is sticky: once a kernel faults, the context is
gone and every later call on it fails, so re-issuing the call can only
hide the first error. The port therefore classifies by the
`TransientError` taxonomy alone — the chaos module's injected admission
faults, which fire at the seam BEFORE the step or the copy runs, so a
retried injected fault never meets a half-applied eager step (the step
writes the accumulator ring in place). `torch.cuda` errors are never
retried; they surface to the feeder's containment (degraded mode).
`is_transient` (fetch) and `is_dispatch_transient` (dispatch) keep both
names and the reference's call sites, and classify alike.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import random
import time

_rng_seq = itertools.count()


def decorrelated_rng(tag: int) -> random.Random:
    """Jitter rng for one retrying instance: seeded from a caller tag,
    the pid and a process-wide instance counter, so N managers (or N
    processes) backing off against one recovering device never share a
    jitter stream."""
    return random.Random((tag << 40) ^ (os.getpid() << 20) ^ next(_rng_seq))


class TransientError(Exception):
    """Failures that are retryable by construction (admission-time:
    the operation never started). The chaos module's transient fault
    classes subclass this."""


def is_transient(exc: BaseException) -> bool:
    """The retry classification: the TransientError taxonomy only (a
    CUDA error is sticky; see the module docstring)."""
    return isinstance(exc, TransientError)


# the dispatch path's classifier: the same taxonomy — the chaos seam fires
# before the step, so nothing of the step has run when an injected fault
# is retried
is_dispatch_transient = is_transient


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts = TOTAL tries (1 = no retry). Delay for retry k
    (k=1..attempts-1) is min(base * multiplier**(k-1), max) scaled by a
    uniform jitter in [1-jitter, 1]."""

    attempts: int = 4
    base_delay_s: float = 0.005
    max_delay_s: float = 0.5
    multiplier: float = 2.0
    jitter: float = 0.5

    def delay(self, attempt: int, rng: random.Random) -> float:
        # the exponent is clamped before exponentiating: callers feed
        # unbounded failstreaks in here (serve()'s crash-loop guard), and
        # float ** raises OverflowError past ~2.0**1024
        d = min(self.base_delay_s * self.multiplier ** min(attempt - 1, 64),
                self.max_delay_s)
        return d * (1.0 - self.jitter * rng.random())


def retry_call(fn, policy: RetryPolicy = RetryPolicy(), *, classify=is_transient,
               on_retry=None, rng: random.Random | None = None, sleep=time.sleep):
    """Call `fn()`; on a transient failure, back off and retry up to
    policy.attempts total tries. Non-transient errors (and BaseException
    kill-points from the chaos harness) propagate immediately —
    containment above this layer decides what survives. `on_retry(k,
    exc)` fires before each retry so owners can count them."""
    rng = rng if rng is not None else random
    last = None
    for attempt in range(1, max(1, policy.attempts) + 1):
        try:
            return fn()
        except Exception as exc:
            if attempt > policy.attempts - 1 or not classify(exc):
                raise
            last = exc
            if on_retry is not None:
                on_retry(attempt, exc)
            sleep(policy.delay(attempt, rng))
    raise last  # pragma: no cover - loop always returns or raises
