"""Fault flight recorder: a bounded ring of recent events, dumped on faults.

The port's copy of ``cfk_tpu/telemetry/recorder.py`` (pure Python, no
JAX).  A bounded in-memory ring buffer of recent telemetry events (deque
append — effectively free at the per-loop / per-batch granularity the
instrumentation uses: ``fused_loop_done``, the serve ``batch`` and
``two_stage_fault`` events, ``checkpoint_committed`` and
``corrupt_checkpoint_skipped``), dumped ATOMICALLY to disk the moment
something goes wrong — a two-stage retrieval fault, a corrupt checkpoint
skipped on resume and, via ``install_crash_hooks``, any uncaught exception
— so the dump is the forensic timeline of the events before the fault.

Disk policy: dumps are written only when a dump directory is configured
(``FlightRecorder.configure(dump_dir=...)``, the ``CFK_FLIGHT_DIR`` env
var, or the CLI's ``--trace-dir``/checkpoint-dir wiring) — recording
itself is always on, so the buffer is warm whenever a dump trigger fires,
but an unconfigured library user never finds surprise files in their cwd.
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time

DEFAULT_CAPACITY = 512

_ENV_DIR = "CFK_FLIGHT_DIR"

# configure()'s "argument not passed" sentinel: None is a meaningful
# dump_dir value (disable disk dumps), so absence needs its own marker.
_UNSET = object()


class FlightRecorder:
    """Bounded ring buffer of telemetry events + atomic fault dumps."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 dump_dir: str | None = None) -> None:
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        self._dump_n = 0
        self.dump_dir = dump_dir
        self.dumps: list[str] = []

    def configure(self, *, dump_dir=_UNSET,
                  capacity: int | None = None) -> "FlightRecorder":
        """Reconfigure in place.  ``dump_dir`` is only touched when the
        argument is PASSED (None explicitly disables disk dumps) — a
        capacity-only reconfigure must not silently turn fault dumps
        off."""
        with self._lock:
            if dump_dir is not _UNSET:
                self.dump_dir = dump_dir
            if capacity is not None and capacity != self._buf.maxlen:
                self._buf = collections.deque(self._buf, maxlen=capacity)
        return self

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def record(self, kind: str, name: str, **fields) -> None:
        """Append one event.  ``kind`` is the coarse class ("train",
        "stream", "serve", "fault", "signal", "checkpoint", ...); ``name``
        the specific event; fields are free-form JSON-able values."""
        evt = {
            "t": round(time.time(), 6),
            "thread": threading.current_thread().name,
            "kind": kind,
            "name": name,
        }
        if fields:
            evt.update(fields)
        with self._lock:
            evt["seq"] = self._seq
            self._seq += 1
            self._buf.append(evt)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.dumps = []
            self._dump_n = 0

    def _resolve_dir(self) -> str | None:
        return self.dump_dir or os.environ.get(_ENV_DIR) or None

    def dump(self, reason: str, path: str | None = None) -> str | None:
        """Atomically dump the ring to disk; returns the path, or None
        when no dump directory is configured (events stay in memory).
        Never raises — the recorder must not turn a survivable fault into
        a crash (I/O errors are swallowed, best-effort by contract)."""
        with self._lock:
            events = list(self._buf)
            self._dump_n += 1
            n = self._dump_n
        payload = {
            "reason": reason,
            "pid": os.getpid(),
            "dumped_at_unix": round(time.time(), 6),
            "num_events": len(events),
            "events": events,
        }
        tmp = None
        try:
            if path is None:
                d = self._resolve_dir()
                if d is None:
                    return None
                os.makedirs(d, exist_ok=True)
                slug = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:64]
                path = os.path.join(
                    d, f"cfk_flight_{os.getpid()}_{n:03d}_{slug}.json"
                )
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                # default=repr: record() accepts free-form fields, and a
                # numpy scalar slipping in must degrade to its repr, not
                # raise TypeError out of a fault handler.
                json.dump(payload, f, default=repr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except Exception:
            # "never raises" is the contract: a dump failure must not
            # turn a survivable fault into a crash of the recovery path.
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            return None
        with self._lock:
            self.dumps.append(path)
        return path


# The process singleton: always recording (appends are near-free), dumps
# only where configured.
_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record_event(kind: str, name: str, **fields) -> None:
    _RECORDER.record(kind, name, **fields)


def dump_flight(reason: str) -> str | None:
    return _RECORDER.dump(reason)


_HOOKS_INSTALLED = [False]


def install_crash_hooks() -> None:
    """Chain ``sys.excepthook`` so an uncaught exception dumps the ring
    (reason ``crash:<ExcType>``) before the interpreter's default
    handling.  Idempotent; the CLI installs it whenever a dump directory
    is wired."""
    if _HOOKS_INSTALLED[0]:
        return
    _HOOKS_INSTALLED[0] = True
    import sys

    prev = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            _RECORDER.record("fault", "uncaught_exception",
                             error=f"{exc_type.__name__}: {exc}")
            _RECORDER.dump(f"crash:{exc_type.__name__}")
        except Exception:
            pass
        prev(exc_type, exc, tb)

    sys.excepthook = _hook
