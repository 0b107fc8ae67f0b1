"""Concurrent host staging engine of the out-of-core tier.

The port of ``cfk_tpu/offload/staging.py``.  ``WindowStager`` serves
staged windows to the per-shard half-steps in the EXACT consumption order
each schedule commits — the trainer flattens (shard, window) tasks
shard-major, each shard's windows in its own visit order — while staging
ahead of consumption on a bounded thread pool:

- ``mode="pool"``: up to ``depth`` tasks are in flight beyond the window
  being consumed (``depth + 1`` windows live on the device — the staging
  arena ``offload.budget`` charges), executed by up to ``workers`` threads.
  Shard d+1's windows stage while shard d's compute runs, and a straggling
  fetch on one shard blocks only its own future.
- ``mode="serial"``: the task runs on the caller's thread inside
  ``take()`` — the one-thread double buffer, kept as the A/B baseline.

A staging task gathers the window's rows into page-locked host buffers and
copies them to the card with ``non_blocking=True`` on a side stream
(``put_window``; ``ops.pipeline.fetch_stream``'s pattern), recording an
event.  The consumer's ``StagedWindow.ready()`` makes the current stream
wait for that event and ``record_stream``s every staged tensor on it, so
the caching allocator cannot hand a window's memory to a later staging
while a kernel of the current stream still reads it.  On the CPU the host
tensors are the window.

Ordering contract: staging is a pure read of the host store (written only
after a half-iteration completes) and every window is consumed in its
schedule position, so pooled and serial staging give the same bits.
Failure contract: a worker exception propagates out of ``take()`` as the
staging error — never a hang — and ``close()`` cancels the not-yet-started
tasks and drains the running ones, so a rollback never races a worker.

Accounting: ``stage_busy_s`` (seconds inside staging tasks),
``stage_stall_s`` (seconds the consumer waited in ``take()``),
``pool_peak_inflight`` / ``pool_worker_stagings``, and ``h2d_bytes`` /
``h2d_s`` (bytes the side-stream copies moved and their summed device
seconds, read from the events — the staging copies' host-to-device rate).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from cfk_tpu_torch.telemetry import dump_flight, record_event, span

# Staged-ahead windows beyond the one being consumed.  The trainer clamps
# this by the window budget (depth + 1 windows must fit the staging
# share) and by the task count; 4 keeps four shards' first windows in
# flight at the default sharded shapes.
DEFAULT_POOL_DEPTH = 4
# Worker threads are capped at the depth (more could never run) and at a
# small constant — staging is memory-bound host work, and past a few
# threads the copies contend for the same bandwidth the compute uses.
MAX_POOL_WORKERS = 4

STAGING_MODES = ("pool", "serial")


class StagingStats(dict):
    """A stats dict with a lock: pooled staging increments shared
    counters from worker threads, and an unguarded read-modify-write
    would lose counts (``stats_add``/``stats_max`` take the lock)."""

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.lock = threading.Lock()


def stats_add(stats, key: str, val) -> None:
    """``stats[key] += val`` — under the lock when ``stats`` carries one
    (``StagingStats``); plain dicts (single-threaded callers, tests) are
    updated directly."""
    if stats is None:
        return
    lock = getattr(stats, "lock", None)
    if lock is not None:
        with lock:
            stats[key] = stats.get(key, 0) + val
    else:
        stats[key] = stats.get(key, 0) + val


def stats_max(stats, key: str, val) -> None:
    """``stats[key] = max(stats[key], val)`` with the same locking rule."""
    if stats is None:
        return
    lock = getattr(stats, "lock", None)
    if lock is not None:
        with lock:
            stats[key] = max(stats.get(key, 0), val)
    else:
        stats[key] = max(stats.get(key, 0), val)


def resolve_staging(staging: str | None) -> str:
    """The staging mode a trainer runs: an explicit pin wins, ``None``/
    ``"auto"`` resolves to the pool (the concurrency is the default
    execution mode at ANY shard count — even one shard's windows stage
    ahead across windows — like the chunk pipeline's overlap; serial is the A/B
    baseline)."""
    if staging in (None, "auto"):
        return "pool"
    if staging not in STAGING_MODES:
        raise ValueError(
            f"staging must be one of {STAGING_MODES} (or 'auto'), "
            f"got {staging!r}"
        )
    return staging


def pool_workers_for(depth: int, workers: int | None = None) -> int:
    """Worker-thread count for a pool of ``depth``: never more threads
    than windows that can be in flight, never more than the cap."""
    if workers is not None:
        return max(1, min(int(workers), max(int(depth), 1)))
    return max(1, min(int(depth), MAX_POOL_WORKERS))


class WindowStager:
    """Stage (shard, window) tasks ahead of consumption, in order.

    ``tasks`` is the flattened consumption order — the trainer lists every
    shard's schedule shard-major, each shard's windows in the exact visit
    order its half-step will request them — and ``stage_fn(shard, key)``
    performs one staging (gather + quantize + verify + ``put_window``).
    ``take()`` returns the next task's staged result; the caller calls it
    exactly ``len(tasks)`` times, in order, which is what lets the pooled
    and serial modes share one consumption seam.
    """

    def __init__(self, tasks, stage_fn, *, mode: str = "pool",
                 depth: int = DEFAULT_POOL_DEPTH, workers: int | None = None,
                 stats=None, span_attrs=None) -> None:
        if mode not in STAGING_MODES:
            raise ValueError(
                f"staging mode must be one of {STAGING_MODES}, got {mode!r}"
            )
        self._tasks = list(tasks)
        self._fn = stage_fn
        self.mode = mode
        self._stats = stats
        # Optional (shard, key) -> dict of extra window_stage span attrs
        #.
        self._span_attrs = span_attrs
        self._next_submit = 0
        self._next_take = 0
        self._closed = False
        self._pool = None
        self._futures: dict[int, object] = {}
        self._inflight = 0
        self._lock = threading.Lock()
        if mode == "pool" and self._tasks:
            self.depth = max(int(depth), 1)
            self.workers = pool_workers_for(self.depth, workers)
            self._pool = ThreadPoolExecutor(
                max_workers=self.workers, thread_name_prefix="cfk-stage",
            )
            for _ in range(min(self.depth, len(self._tasks))):
                self._submit_next()
        else:
            self.depth = 0
            self.workers = 0

    # -- internals -----------------------------------------------------------

    def _run(self, idx: int):
        shard, key = self._tasks[idx]
        with self._lock:
            self._inflight += 1
            peak = self._inflight
        stats_max(self._stats, "pool_peak_inflight", peak)
        t0 = time.perf_counter()
        try:
            # The worker span carries thread (implicit) + (shard, window)
            # ids, so pool overlap against the consuming compute spans is
            # VISIBLE in the trace; its duration is exactly the interval
            # stage_busy_s meters, which is what lets the trace-recomputed
            # overlap fraction agree with the trainer's gauge.  Extra attrs
            # (rows_staged / rows_delta_skipped) come from the trainer's
            # provider so the trace shows the hot/delta reuse per window.
            extra = (self._span_attrs(shard, key)
                     if self._span_attrs is not None else {})
            with span("train/iter/half_step/window_stage",
                      shard=shard, window=key, mode=self.mode, **extra):
                out = self._fn(shard, key)
        finally:
            with self._lock:
                self._inflight -= 1
        stats_add(self._stats, "stage_busy_s",
                  time.perf_counter() - t0)
        if threading.current_thread().name.startswith("cfk-stage"):
            stats_add(self._stats, "pool_worker_stagings", 1)
        return out

    def _submit_next(self) -> None:
        i = self._next_submit
        if i < len(self._tasks):
            self._futures[i] = self._pool.submit(self._run, i)
            self._next_submit += 1

    # -- the consumption seam ------------------------------------------------

    @property
    def remaining(self) -> int:
        return len(self._tasks) - self._next_take

    def take(self):
        """The next task's staged result, in task order.

        Serial mode runs the staging HERE, on the consuming thread — the
        exact schedule position of the double buffer (the caller
        dispatches window w's compute before asking for window w+1).
        Pool mode waits on the pre-submitted future; a worker exception
        re-raises here as the staging error (after cancelling the rest),
        and the wait time is metered as the exposed staging stall."""
        i = self._next_take
        if i >= len(self._tasks):
            raise IndexError("WindowStager exhausted: every task taken")
        self._next_take += 1
        shard, key = self._tasks[i]
        if self._pool is None:
            # Serial: the whole staging occupies the consuming thread —
            # stall == busy by construction, which is what makes the
            # overlap_hidden_fraction column read 0 for the baseline arm.
            t0 = time.perf_counter()
            try:
                with span("train/iter/half_step/window_wait",
                          shard=shard, window=key, mode=self.mode):
                    out = self._run(i)
            except BaseException as e:
                record_event("fault", "staging_error", shard=shard,
                             window=key, error=f"{type(e).__name__}: {e}")
                dump_flight("staging_error")
                raise
            stats_add(self._stats, "stage_stall_s",
                      time.perf_counter() - t0)
            return out
        fut = self._futures.pop(i)
        t0 = time.perf_counter()
        try:
            with span("train/iter/half_step/window_wait",
                      shard=shard, window=key, mode=self.mode):
                out = fut.result()
        except BaseException as e:
            # Propagate as the staging error — never leave workers
            # running against a store the caller is about to roll back.
            # Flight-record first: a staging-worker death is exactly the
            # incident the ring buffer exists to explain.
            record_event("fault", "staging_error", shard=shard, window=key,
                         error=f"{type(e).__name__}: {e}")
            dump_flight("staging_error")
            self.close()
            raise
        stats_add(self._stats, "stage_stall_s",
                  time.perf_counter() - t0)
        self._submit_next()
        return out

    def close(self) -> None:
        """Cancel not-yet-started tasks and drain running ones.
        Idempotent; the trainer calls it in a ``finally`` around each
        half-iteration (rollback must not race a staging worker)."""
        if self._closed:
            return
        self._closed = True
        if self._pool is not None:
            for f in self._futures.values():
                f.cancel()
            self._pool.shutdown(wait=True)
            self._futures.clear()
            self._pool = None

    def __enter__(self) -> "WindowStager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StagedWindow:
    """One staged window on its device: ``arrays`` (tensors, or None
    leaves) and the side stream's ``event`` after their copies (None on the
    CPU).  ``ready()`` returns the arrays once the current stream may read
    them."""

    __slots__ = ("arrays", "event", "start", "nbytes", "_ready")

    def __init__(self, arrays, event=None, start=None, nbytes=0):
        self.arrays = arrays
        self.event = event
        self.start = start
        self.nbytes = nbytes
        self._ready = event is None

    def ready(self) -> tuple:
        if not self._ready:
            cur = torch.cuda.current_stream(self.event.device)
            cur.wait_event(self.event)
            for a in self.arrays:
                if a is not None:
                    # The tensors were allocated on the side stream: tie
                    # their memory to the reading stream too.
                    a.record_stream(cur)
            self._ready = True
        return self.arrays

    def copy_seconds(self) -> float:
        """Device seconds of this window's host-to-device copies (0 on the
        CPU); call after ``ready()``'s consumer has synchronized."""
        if self.start is None:
            return 0.0
        return self.start.elapsed_time(self.event) / 1e3


def pinned_like(t: torch.Tensor) -> torch.Tensor:
    """A page-locked copy of a CPU tensor (the staging buffer of one
    array)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t)


def put_window(host: tuple, device: torch.device,
               stream=None) -> StagedWindow:
    """Move one window's host arrays to ``device``: on a card each array is
    copied into page-locked memory (already-pinned ones are used as they
    are) and then to the card with ``non_blocking=True`` on ``stream`` (a
    side stream: ``staging_stream``), between two timing events; on the
    CPU the host arrays are the window."""
    nbytes = sum(a.numel() * a.element_size() for a in host
                 if a is not None)
    if device.type != "cuda":
        return StagedWindow(host, nbytes=nbytes)
    stream = stream if stream is not None else staging_stream(device)
    with torch.cuda.stream(stream):
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = tuple(
            None if a is None else
            (a if a.is_pinned() else pinned_like(a)).to(device,
                                                         non_blocking=True)
            for a in host)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
    return StagedWindow(out, event, start, nbytes)


_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def staging_stream(device: torch.device):
    """The side stream the calling thread stages on (one per thread name
    and device — pool workers' names repeat from pool to pool — so their
    copies run concurrently with each other and with the compute
    stream)."""
    key = (threading.current_thread().name, torch.device(device).index)
    with _STREAMS_LOCK:
        s = _STREAMS.get(key)
        if s is None:
            s = _STREAMS[key] = torch.cuda.Stream(device=device)
        return s
