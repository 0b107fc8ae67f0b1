"""Thread-safe typed metrics registry: counters, gauges, phases, notes,
histograms, and the periodic JSONL emitter.

The port's copy of ``cfk_tpu/telemetry/metrics.py`` (pure Python, no JAX):
what the request server and the load generator record, what ``train
--metrics-jsonl`` streams (``MetricsEmitter``), what ``train --metrics``
prints at exit (``json_line`` / ``logfmt``) and what ``serve
--metrics-port`` exports (``telemetry.export``).  Every mutating method and
every snapshot takes one registry ``RLock``, so worker threads (the serve
endpoint, the emitter) read consistent views; a ``Histogram`` keeps
count/sum/min/max exactly and its quantiles from a bounded uniform
reservoir (Vitter's algorithm R, seeded per name), so quantiles are exact
while the count stays within the reservoir and memory stays O(reservoir)
beyond it.  Spans live in ``telemetry.trace``, the fault flight recorder in
``telemetry.recorder``.
"""

from __future__ import annotations

import contextlib
import json
import random
import threading
import time
import zlib
from collections import defaultdict

DEFAULT_RESERVOIR = 1024


class Histogram:
    """Bounded-reservoir distribution: exact count/sum/min/max, quantiles
    approximated from a uniform sample of at most ``reservoir`` values
    (exact while ``count <= reservoir``).  Reservoir sampling (Vitter's
    algorithm R) with a per-name-seeded RNG, so two runs observing the
    same sequence produce the same quantiles."""

    __slots__ = ("name", "count", "sum", "min", "max", "_res", "_cap",
                 "_rng", "_lock")

    def __init__(self, name: str,
                 reservoir: int = DEFAULT_RESERVOIR) -> None:
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
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            if len(self._res) < self._cap:
                self._res.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._res[j] = v

    def reservoir(self) -> list[float]:
        with self._lock:
            return list(self._res)

    @staticmethod
    def _quantile_of(vals: list[float], q: float) -> float:
        """Linear-interpolated quantile of a SORTED list — the same
        estimator as ``np.percentile(..., q*100)``."""
        if not vals:
            return float("nan")
        pos = q * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    def quantile(self, q: float) -> float:
        """Linear-interpolated quantile over the reservoir — the same
        estimator as ``np.percentile(..., q*100)``, so the loadgen's
        quantile contract is unchanged while its memory is O(1)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            vals = sorted(self._res)
        return self._quantile_of(vals, q)

    def snapshot(self) -> dict:
        """One CONSISTENT locked snapshot: the scalar fields and the
        quantiles all describe the same instant (a concurrent scrape can
        never see a count whose sum/reservoir haven't landed)."""
        with self._lock:
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
            vals = sorted(self._res)
        return {
            "count": count, "sum": total, "min": mn, "max": mx,
            "p50": self._quantile_of(vals, 0.5),
            "p90": self._quantile_of(vals, 0.9),
            "p99": self._quantile_of(vals, 0.99),
        }

    def summary(self) -> dict:
        snap = self.snapshot()
        if snap["count"] == 0:
            return {"count": 0}
        return {
            "count": snap["count"],
            **{k: round(snap[k], 6)
               for k in ("sum", "min", "max", "p50", "p90", "p99")},
        }


class Metrics:
    """Thread-safe metrics registry: counters, gauges, phase timers,
    notes, and bounded-reservoir histograms."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.phases: dict[str, float] = defaultdict(float)
        self.notes: dict[str, str] = {}
        self.histograms: dict[str, Histogram] = {}

    def incr(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = value

    def note(self, name: str, text: str) -> None:
        """Free-text diagnostic (trip reasons, escalation decisions,
        degradation notices) — the report channel a recovery
        loop writes so a degraded run's output says *why*."""
        with self._lock:
            self.notes[name] = text

    def histogram(self, name: str,
                  reservoir: int = DEFAULT_RESERVOIR) -> Histogram:
        """The named histogram, created on first use (the instrument's
        own lock serializes observes, so hot paths never hold the
        registry lock while recording)."""
        with self._lock:
            h = self.histograms.get(name)
            if h is None:
                h = self.histograms[name] = Histogram(
                    name, reservoir=reservoir
                )
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
            dt = time.perf_counter() - t0
            with self._lock:
                self.phases[name] += dt

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "phase_seconds": {
                    k: round(v, 6) for k, v in self.phases.items()
                },
            }
            if self.notes:
                d["notes"] = dict(self.notes)
            hists = {k: h.summary() for k, h in self.histograms.items()}
        if hists:
            d["histograms"] = hists
        return d

    def json_line(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def logfmt(self) -> str:
        with self._lock:
            counters = sorted(self.counters.items())
            gauges = sorted(self.gauges.items())
            phases = sorted(self.phases.items())
            notes = sorted(self.notes.items())
            hists = sorted(self.histograms.items())
        parts = []
        for k, v in counters:
            parts.append(f"ctr.{k}={v:g}")
        for k, v in gauges:
            parts.append(f"g.{k}={v:g}")
        for k, v in phases:
            parts.append(f"t.{k}={v:.3f}s")
        for k, h in hists:
            if h.count:
                parts.append(
                    f"h.{k}=p50:{h.quantile(0.5):g}/p99:"
                    f"{h.quantile(0.99):g}/n:{h.count}"
                )
        for k, v in notes:
            parts.append(f"n.{k}={v!r}")
        return " ".join(parts)


# The registry IS the class — alias for call sites that want the typed
# name rather than the legacy one.
MetricsRegistry = Metrics


class MetricsEmitter:
    """Periodic JSONL metrics emitter for training: one snapshot line per
    interval on a daemon thread, plus a final line at ``stop()`` — the
    live counterpart of the end-of-run ``json_line()`` print, so a
    dashboard (or a tail -f) can watch a multi-hour run converge instead
    of learning everything at exit."""

    def __init__(self, metrics: Metrics, path: str,
                 interval_s: float = 10.0) -> None:
        import os

        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        # Create the target directory up front: failing HERE surfaces a
        # path typo at command start, instead of the writer thread dying
        # silently and stop() raising out of the CLI's exit finally.
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self.metrics = metrics
        self.path = path
        self.interval_s = float(interval_s)
        self.lines_written = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _write_line(self, f) -> None:
        line = {"ts": round(time.time(), 3), **self.metrics.to_dict()}
        f.write(json.dumps(line, sort_keys=True) + "\n")
        f.flush()
        self.lines_written += 1

    def _run(self) -> None:
        with open(self.path, "a") as f:
            while not self._stop.wait(self.interval_s):
                self._write_line(f)

    def start(self) -> "MetricsEmitter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="cfk-metrics-emitter", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread and append one final snapshot line."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with open(self.path, "a") as f:
            self._write_line(f)

    def __enter__(self) -> "MetricsEmitter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
