"""Exponential backoff + jitter: the one retry schedule the framework uses.

The port's copy of ``cfk_tpu/resilience/retry.py`` (host only).

Replaces ad-hoc fixed-interval polls (the broker-spawn wait loop's
``time.sleep(0.05)``) and gives the TCP client's connect/read paths a
bounded, jittered schedule instead of hammering a recovering broker at a
fixed frequency (thundering-herd on restart is exactly how a half-healthy
broker stays half-healthy).
"""

from __future__ import annotations

import random
import time
from typing import Iterator


def backoff_delays(
    base: float = 0.05,
    factor: float = 2.0,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rng: random.Random | None = None,
) -> Iterator[float]:
    """Infinite stream of sleep intervals: ``base·factor^n`` capped at
    ``max_delay``, each scaled by a uniform jitter in
    ``[1-jitter, 1+jitter]``.  Pass a seeded ``rng`` for deterministic
    schedules (the fault-injection tests do)."""
    if base <= 0:
        raise ValueError(f"base must be > 0, got {base}")
    if not 0 <= jitter < 1:
        raise ValueError(f"jitter must be in [0, 1), got {jitter}")
    rng = rng or random
    delay = base
    while True:
        yield delay * (1.0 + jitter * (2.0 * rng.random() - 1.0))
        delay = min(delay * factor, max_delay)


def retry_call(
    fn,
    *,
    retries: int = 3,
    retry_on: tuple = (OSError,),
    base: float = 0.05,
    max_delay: float = 2.0,
    jitter: float = 0.5,
    rng: random.Random | None = None,
    sleep=time.sleep,
    describe: str = "operation",
):
    """Call ``fn()`` with up to ``retries`` backed-off retries on
    ``retry_on`` exceptions; the final failure re-raises the last error.
    ``sleep`` is injectable so tests assert the schedule without waiting.
    """
    delays = backoff_delays(
        base=base, max_delay=max_delay, jitter=jitter, rng=rng
    )
    last: BaseException | None = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except retry_on as e:
            last = e
            # Flight-record each retried failure: a flaky broker's
            # drop/backoff timeline is the forensic trail chaos_lab's
            # flaky_broker scenario asserts on.
            from cfk_tpu_torch.telemetry.recorder import record_event

            record_event("retry", "retryable_failure", op=describe,
                         attempt=attempt + 1,
                         error=f"{type(e).__name__}: {e}")
            if attempt == retries:
                break
            sleep(next(delays))
    msg = f"{describe} failed after {retries + 1} attempts: {last}"
    # Wrap with the attempts context while keeping the original type AND
    # its errno (callers branch on e.errno); exception classes whose
    # constructors cannot take one message re-raise the original rather
    # than masking it with a TypeError.
    if isinstance(last, OSError) and last.errno is not None:
        wrapped = type(last)(last.errno, msg)
    else:
        try:
            wrapped = type(last)(msg)
        except TypeError:
            raise last
    raise wrapped from last
