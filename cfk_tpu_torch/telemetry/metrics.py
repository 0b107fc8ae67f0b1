"""Thread-safe metrics: counters, gauges, phase timers and histograms.

The port's copy of what the request server and the load generator use from
``cfk_tpu/telemetry/metrics.py``.  A ``Histogram`` keeps count/sum/min/max
exactly and its quantiles from a bounded uniform reservoir (Vitter's
algorithm R, seeded per name), so quantiles are exact while the count stays
within the reservoir and memory stays O(reservoir) beyond it.  Spans, the
flight recorder and the ``/metrics`` endpoint wait for the profiling seam.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import zlib
from collections import defaultdict

DEFAULT_RESERVOIR = 1024


class Histogram:
    """Bounded-reservoir distribution with exact count/sum/min/max."""

    __slots__ = ("name", "count", "sum", "min", "max", "_res", "_cap",
                 "_rng", "_lock")

    def __init__(self, name: str, reservoir: int = DEFAULT_RESERVOIR) -> None:
        if reservoir < 1:
            raise ValueError(f"reservoir must be >= 1, got {reservoir}")
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._res: list[float] = []
        self._cap = int(reservoir)
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            if len(self._res) < self._cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._res[j] = v

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the reservoir (the estimator of
        ``np.percentile(..., q * 100)``)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            vals = sorted(self._res)
        if not vals:
            return float("nan")
        pos = q * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def summary(self) -> dict:
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "p50": self.quantile(0.5),
                "p99": self.quantile(0.99)}


class Metrics:
    """Counters, gauges, phase timers and histograms behind one lock."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.phases: dict[str, float] = defaultdict(float)
        self.histograms: dict[str, Histogram] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        """The named histogram, created on first use."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(name, reservoir)
            return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Accumulate wall seconds spent inside the block under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            with self._lock:
                self.phases[name] += time.perf_counter() - t0

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "phase_seconds": dict(self.phases),
                "histograms": {k: h.summary()
                               for k, h in self.histograms.items()},
            }
