"""Preemption tolerance: eviction signals and dead-collective watchdogs.

The port's copy of ``cfk_tpu/resilience/preempt.py`` (host only; the
watchdog never touches the device runtime, which may be wedged).

The dominant failure of a long training run is infrastructure, not math:
a preempted machine (SIGTERM with a short grace window), a killed worker
(SIGKILL — no warning at all), and checkpoint writes that stall the loop.
Two small host-side tools make the stepped training loop survive them:

- ``PreemptionGuard`` — a context manager that installs SIGTERM/SIGINT
  handlers setting a flag the resilient loops poll between iterations.  On
  eviction the loop drains the async checkpoint writer, commits one final
  checkpoint (skipped if the state just failed its health probe — a bad
  state is never committed, even under eviction), notes the preemption in
  the metrics, and returns resumable.  Handlers are restored on exit, and a
  second delivery of the same signal chains to the previous handler so a
  double Ctrl-C still kills a stuck process.

- ``StallWatchdog`` — a monitor thread armed around the training loop and
  ticked once per completed iteration.  A SIGKILL'd peer leaves the
  survivors blocked inside a collective (C++ with the GIL released, so this
  thread still runs); when no tick arrives within ``timeout_s`` the watchdog
  drains the checkpoint writer (best-effort, bounded) and ``os._exit``s with
  ``STALL_EXIT_CODE`` — the checkpoint store stays intact by construction
  (atomic per-step renames), so a supervisor restarts the fleet and training
  resumes from the last committed step.  Signal-safety rule: the watchdog
  never touches the device runtime (it may be wedged); it only reads host
  state and the filesystem.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time

# The survivor's "I detected a dead collective and left an intact
# checkpoint behind" exit status — distinct from crash codes so supervisors
# and chaos drills can tell a clean stall exit from a wreck.
STALL_EXIT_CODE = 17


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers that request a graceful save+exit.

    Usage::

        with PreemptionGuard() as guard:
            train_als(ds, cfg, checkpoint_manager=mgr,
                      preemption_guard=guard)
        if guard.triggered:
            ...  # exited resumable; re-launch to continue

    The handler only sets a flag (async-signal-safe by construction: no
    allocation, no locks, no device work); the stepped loops poll ``triggered``
    between iterations.  ``trigger()`` lets tests and chaos scenarios fire
    the guard without delivering a real signal.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self.signum: int | None = None
        self._previous: dict[int, object] = {}
        self._installed = False

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def signal_name(self) -> str:
        if self.signum is None:
            return "manual"
        try:
            return signal.Signals(self.signum).name
        except ValueError:  # pragma: no cover - unknown signum
            return str(self.signum)

    def trigger(self, signum: int | None = None) -> None:
        """Request a graceful stop as if the signal had been delivered."""
        self.signum = signum if signum is not None else self.signum
        self._event.set()
        # Flight-record the request (trigger() is the test/chaos entry —
        # the real signal handler stays flag-only by the async-signal-
        # safety rule; the resilient loops record the delivery when they
        # poll the flag at the next boundary).
        from cfk_tpu_torch.telemetry.recorder import record_event

        record_event("signal", "preemption_requested",
                     signal=self.signal_name)

    def _handler(self, signum, frame):
        if self._event.is_set():
            # Second delivery: the operator (or the platform) is insisting.
            # Chain to the pre-guard behavior so a wedged loop can still be
            # killed the ordinary way.
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
            elif prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)
            return
        self.signum = signum
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                "PreemptionGuard must be entered from the main thread "
                "(signal handlers can only be installed there)"
            )
        for s in self.signals:
            self._previous[s] = signal.getsignal(s)
            signal.signal(s, self._handler)
        self._installed = True
        return self

    def __exit__(self, *exc) -> None:
        if not self._installed:
            return
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except (ValueError, TypeError):  # pragma: no cover
                pass
        self._previous.clear()
        self._installed = False


class StallWatchdog:
    """Exit with an intact checkpoint when iterations stop completing.

    Armed by the resilient loop around its stepped body and ticked once per
    completed iteration.  ``timeout_s`` bounds how long a collective may
    block before the process gives up on its peers: on expiry the watchdog
    runs ``on_stall`` (if any), drains the checkpoint manager's async
    writer with a bounded wait, prints one diagnostic line, and
    ``os._exit(exit_code)`` — ``sys.exit`` would merely raise in this
    thread while the main thread stays wedged in the dead collective.

    ``manager`` is drained, never written: the last committed step is the
    resume point (a mid-stall save of sharded device state would itself
    need the dead collective).  ``tick`` may be overridden/wrapped by
    callers that want per-iteration progress reporting.

    The first iteration (kernel builds, a CUDA graph capture) produces no
    tick but is not a stall: the window is widened to ``compile_grace_s``
    from ``arm()`` until the first tick, and again whenever the loop
    rebuilds its step (``extend_grace()`` — an escalation rung may build
    other kernels); a tick restores the normal ``timeout_s`` window.
    """

    def __init__(
        self,
        timeout_s: float,
        *,
        manager=None,
        on_stall=None,
        exit_code: int = STALL_EXIT_CODE,
        drain_timeout_s: float = 30.0,
        compile_grace_s: float | None = None,
    ) -> None:
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be > 0, got {timeout_s}")
        self.timeout_s = float(timeout_s)
        self.compile_grace_s = (
            max(float(timeout_s), 60.0)
            if compile_grace_s is None else float(compile_grace_s)
        )
        self.manager = manager
        self.on_stall = on_stall
        self.exit_code = exit_code
        self.drain_timeout_s = drain_timeout_s
        self.last_tick: float | None = None
        self.last_done: int | None = None
        self.stalled = False
        self._window = self.compile_grace_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def __getstate__(self) -> dict:
        """A disarmed copy (a sharded run hands the watchdog to its ranks,
        each of which arms its own)."""
        state = dict(self.__dict__)
        state["_stop"], state["_thread"] = None, None
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._stop = threading.Event()

    def arm(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._window = self.compile_grace_s  # first step includes compile
        self.last_tick = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, name="cfk-stall-watchdog", daemon=True
        )
        self._thread.start()

    def tick(self, done: int | None = None) -> None:
        self._window = self.timeout_s
        self.last_tick = time.monotonic()
        if done is not None:
            self.last_done = done

    def extend_grace(self) -> None:
        """Widen the window for a step rebuild (escalation re-trace)."""
        self._window = self.compile_grace_s
        self.last_tick = time.monotonic()

    def disarm(self) -> None:
        """Stop the watch and join its thread (bounded), so no watchdog
        thread outlives the loop it guarded."""
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)

    def __enter__(self) -> "StallWatchdog":
        self.arm()
        return self

    def __exit__(self, *exc) -> None:
        self.disarm()

    def _watch(self) -> None:
        while not self._stop.wait(min(self.timeout_s / 4.0, 1.0)):
            last = self.last_tick
            if last is None:
                continue
            if time.monotonic() - last > self._window:
                self.stalled = True
                self._stall_exit()
                return

    def _stall_exit(self) -> None:  # pragma: no cover - exercised via drills
        try:
            # Flight-record the stall before exiting: the dump's tail is
            # the last iterations this process completed before its peer
            # died (host-only work — the rule about never touching the
            # wedged device runtime holds).
            from cfk_tpu_torch.telemetry.recorder import dump_flight, record_event

            record_event("fault", "stall_watchdog", last_done=self.last_done,
                         timeout_s=self.timeout_s)
            dump_flight("stall_watchdog")
        except Exception:
            pass
        try:
            if self.on_stall is not None:
                self.on_stall(self)
        except Exception:
            pass
        try:
            if self.manager is not None and hasattr(self.manager,
                                                    "wait_pending"):
                self.manager.wait_pending(timeout=self.drain_timeout_s)
        except Exception:
            pass
        try:
            print(
                f"STALL_WATCHDOG no iteration completed in "
                f"{self.timeout_s:.1f}s (last completed iteration: "
                f"{self.last_done}); assuming a dead collective peer — "
                f"exiting {self.exit_code} with the checkpoint store "
                "intact",
                file=sys.stderr,
                flush=True,
            )
        except Exception:
            pass
        os._exit(self.exit_code)
