"""Factor checkpoints: a directory of atomically committed steps.

The port's copy of the synchronous half of ``cfk_tpu/transport/checkpoint.py``
with the same on-disk layout, so a step written by either package restores
in the other — the way trained factors cross between them:

    <dir>/step_0000007/{manifest.json, user.npy, movie.npy}

A step is written to a temporary directory, fsync'd and renamed into place,
so a crash never leaves half a step; the manifest records each payload's
crc32, and ``verify``/``restore`` refuse a payload that no longer matches.
Factors are stored as float32 (or float64); bfloat16 factors are stored as
float32 with ``"dtype": "bfloat16"`` in the manifest and restored as torch
bfloat16 tensors (numpy has no bfloat16).

``save_async`` hands the serialize + fsync + rename to one background
writer thread, so the training loop never waits on the disk: the snapshot
it takes first is, for a CUDA tensor, a ``non_blocking`` copy into pinned
host memory queued on the current stream — ahead of any later in-place
update of the tensor on that stream (the captured route writes the factors
in place), so the snapshot holds the values at the call — and the writer
waits for the copy's event before it serializes.  ``pin`` and
``keep_last_n`` are the retention the resilient loop relies on
(``cfk_tpu_torch.resilience.loop``); ``resume_state`` and
``checkpointed_train_loop`` are the shared resume validation and stepped
loop of every trainer.  The journal store belongs to the streaming slice.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import shutil
import tempfile
import threading
import time
import warnings
import weakref
import zlib
from collections import deque

import numpy as np
import torch

from cfk_tpu_torch.telemetry.recorder import dump_flight, record_event

_MANIFEST = "manifest.json"
_STEP_PREFIX = "step_"
_PAYLOADS = ("user.npy", "movie.npy")
_RESERVED = ("iteration", "user_shape", "movie_shape", "dtype", "crc32")


# Managers with a live background writer, drained at interpreter exit so a
# process that finishes (or is SIGTERM'd into a clean shutdown) never leaves
# an enqueued checkpoint unwritten.  Weak references: the hook must not keep
# dead managers alive.
_LIVE_MANAGERS: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


def _drain_writers_at_exit() -> None:  # pragma: no cover - exit path
    for mgr in list(_LIVE_MANAGERS):
        try:
            mgr.wait_pending()
        except Exception as e:
            # Exit-time best effort: a failed background write must not
            # turn a clean shutdown into a crash loop; the warning names it.
            warnings.warn(f"checkpoint write pending at exit failed: {e}")


atexit.register(_drain_writers_at_exit)


class CheckpointCorruptError(ValueError):
    """A step failed integrity verification."""


@dataclasses.dataclass(frozen=True)
class CheckpointState:
    iteration: int  # iterations fully completed
    user_factors: np.ndarray | torch.Tensor
    movie_factors: np.ndarray | torch.Tensor
    meta: dict


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _fsync(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - fsync on directories unsupported
        pass
    finally:
        os.close(fd)


def _host(x) -> tuple[np.ndarray, str]:
    """(host array as stored, the dtype name the manifest records)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.to(torch.float32).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        return x.astype(np.float32), str(x.dtype)
    return x, str(x.dtype)


class _Snapshot:
    """A factor table's host copy as ``save_async`` takes it: a pinned
    buffer a ``non_blocking`` device-to-host copy fills (``event`` marks its
    end), or an owned host copy."""

    __slots__ = ("host", "event")

    def __init__(self, host, event=None):
        self.host, self.event = host, event

    def value(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host


def _snapshot(x) -> _Snapshot:
    """The host copy ``save_async`` enqueues: a CUDA tensor's
    ``non_blocking`` copy into pinned memory on the current stream (PyTorch's
    caching host allocator reuses the buffers across saves), with an event;
    else an owned copy."""
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x.detach(), non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(x.device))
        return _Snapshot(buf, event)
    if isinstance(x, torch.Tensor):
        return _Snapshot(x.detach().clone())
    return _Snapshot(np.array(x, copy=True))


def resume_state_synced(manager: "CheckpointManager | None", *, group=None,
                        **kw) -> CheckpointState | None:
    """``resume_state`` with rank 0's decision broadcast to every rank of
    ``group`` (``cfk_tpu/transport/checkpoint.py:179``): only rank 0's store
    is read, so ranks without a shared filesystem (or a store at all)
    resume at the same iteration with the same factors; a checkpoint rank 0
    refuses raises on every rank, so none is left waiting in a collective.
    Without a group of more than one rank this is ``resume_state``."""
    if group is None or group.size == 1:
        return resume_state(manager, **kw)
    state, err = None, None
    if group.rank == 0:
        try:
            state = resume_state(manager, **kw)
        except Exception as e:  # raised below, after the broadcast
            err = e
    msg = group.broadcast_object(
        ("err", f"{type(err).__name__}: {err}") if err is not None else
        ("ok", None if state is None else (
            state.iteration, _host_copy(state.user_factors),
            _host_copy(state.movie_factors), state.meta)))
    if err is not None:
        raise err
    kind, value = msg
    if kind == "err":
        raise ValueError(f"rank 0 refused the checkpoint: {value}")
    if value is None:
        return None
    it, u, m, meta = value
    return CheckpointState(iteration=it, user_factors=u, movie_factors=m,
                           meta=meta)


def _host_copy(x):
    return x.detach().cpu() if isinstance(x, torch.Tensor) else np.asarray(x)


def should_save(done: int, every: int, total: int) -> bool:
    """Save cadence: every ``every`` completed iterations, and always at the
    end."""
    if every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {every}")
    return done % every == 0 or done == total


def _check_shapes(state: CheckpointState, u_shape, m_shape) -> None:
    got = (tuple(state.user_factors.shape), tuple(state.movie_factors.shape))
    if got != (tuple(u_shape), tuple(m_shape)):
        raise ValueError(
            f"checkpoint at iteration {state.iteration} has factor shapes "
            f"user={got[0]} movie={got[1]}, but this run needs "
            f"user={tuple(u_shape)} movie={tuple(m_shape)} (padded entity "
            "counts depend on pad_multiple/num_shards); use a fresh "
            "checkpoint directory"
        )


def resume_state(
    manager: "CheckpointManager | None",
    *,
    rank: int,
    model: str,
    num_iterations: int,
    u_shape: tuple[int, int] | None = None,
    m_shape: tuple[int, int] | None = None,
    num_shards: int | None = None,
) -> CheckpointState | None:
    """Shared resume validation for every trainer (``cfk_tpu/transport/
    checkpoint.py::resume_state``, its messages).

    Returns the newest intact state, or None when there is nothing to
    resume (no step, or every step torn — with a warning).  Refuses a
    checkpoint of another rank or model family, one past
    ``num_iterations``, one written with another ``num_shards``, and, when
    ``u_shape``/``m_shape`` are given, one whose padded row counts differ.
    """
    if manager is None or manager.latest_iteration() is None:
        return None
    try:
        state = manager.restore()
    except FileNotFoundError as e:
        warnings.warn(f"no intact checkpoint to resume from ({e}); "
                      "starting from scratch")
        return None
    if state.user_factors.shape[-1] != rank:
        raise ValueError(
            f"checkpoint at iteration {state.iteration} has rank "
            f"{state.user_factors.shape[-1]}, config rank={rank}; "
            "use a fresh checkpoint directory to change rank"
        )
    saved_model = state.meta.get("model", "als")
    if saved_model != model:
        raise ValueError(
            f"checkpoint was written by model family {saved_model!r}, "
            f"resuming as {model!r}; use a fresh checkpoint directory"
        )
    saved_shards = state.meta.get("num_shards")
    if (num_shards is not None and saved_shards is not None
            and int(saved_shards) != int(num_shards)):
        raise ValueError(
            f"checkpoint at iteration {state.iteration} was written by a "
            f"num_shards={int(saved_shards)} run, but this config has "
            f"num_shards={int(num_shards)}; shard-count padding and "
            "shard-local indices are not portable — use a fresh checkpoint "
            "directory (or restore() and re-shard the factors by hand)"
        )
    if state.iteration > num_iterations:
        raise ValueError(
            f"checkpoint is at iteration {state.iteration}, past the "
            f"requested num_iterations={num_iterations}; restore() an "
            "earlier step explicitly or use a fresh checkpoint directory"
        )
    if u_shape is not None:
        _check_shapes(state, u_shape, m_shape)
    return state


def checkpointed_train_loop(manager, *, model: str, rank: int,
                            num_iterations: int, u_shape, m_shape, dtype,
                            init_fn, step_fn, metrics,
                            checkpoint_every: int = 1,
                            preemption_guard=None, watchdog=None):
    """The single-process checkpointed loop: resume from the manager's
    newest committed state (``resume_state``) or ``init_fn() -> (u, m)``,
    step ``step_fn(u, m) -> (u, m)``, save every ``checkpoint_every``
    iterations.  The health-off case of ``cfk_tpu_torch.resilience.loop.
    resilient_train_loop``, which it delegates to, so there is one stepped
    loop."""
    from cfk_tpu_torch.resilience.loop import resilient_train_loop

    return resilient_train_loop(
        manager, model=model, rank=rank, num_iterations=num_iterations,
        u_shape=u_shape, m_shape=m_shape, dtype=dtype, init_fn=init_fn,
        step_fn=step_fn, metrics=metrics, checkpoint_every=checkpoint_every,
        preemption_guard=preemption_guard, watchdog=watchdog)


class CheckpointManager:
    """Directory-of-steps checkpoint store with atomic per-step commits.

    ``save_async`` hands the write to ONE lazily started background writer
    thread; ``wait_pending()`` is the barrier (the resilient loop drains
    before any rollback read and at loop exit, so readers only ever see
    committed steps).  While ``max_pending`` saves are queued or in flight,
    ``save_async`` blocks (a slow disk throttles the producer instead of
    growing the snapshot queue).  A writer error is sticky: it re-raises at
    the next ``save_async``/``wait_pending``.  ``async_write=False`` makes
    ``save_async`` the synchronous ``save`` (the A/B baseline).

    ``keep_last_n`` removes old steps after each commit, always keeping the
    newest N and the ``pin()``ned step — the resilient loop's last
    verified-good rollback anchor.
    """

    def __init__(self, directory: str, *, keep_last_n: int | None = None,
                 async_write: bool = True, max_pending: int = 2) -> None:
        if keep_last_n is not None and keep_last_n < 1:
            raise ValueError(
                f"keep_last_n must be >= 1 (checkpoints retained after each "
                f"save), got {keep_last_n}; use keep_last_n=None to retain "
                "every step"
            )
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.directory = directory
        self.keep_last_n = keep_last_n
        self.async_write = async_write
        self.max_pending = max_pending
        self._pinned: int | None = None
        self._lock = threading.Lock()
        self._queue_nonfull = threading.Condition(self._lock)
        self._queue_empty = threading.Condition(self._lock)
        self._jobs: deque = deque()
        self._inflight = 0
        self._writer_thread: threading.Thread | None = None
        self._retired: list[threading.Thread] = []  # parked, not yet joined
        self._writer_error: BaseException | None = None
        os.makedirs(directory, exist_ok=True)

    def __getstate__(self) -> dict:
        """A store pickles as its directory and settings (a sharded run
        hands it to its ranks); the writer's queue and thread stay here."""
        with self._lock:
            if self._jobs or self._inflight:
                raise RuntimeError("cannot pickle a checkpoint store with "
                                   "saves pending; wait_pending() first")
        state = dict(self.__dict__)
        for key in ("_lock", "_queue_nonfull", "_queue_empty", "_jobs",
                    "_writer_thread", "_retired", "_writer_error"):
            state.pop(key)
        return state

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)
        self._lock = threading.Lock()
        self._queue_nonfull = threading.Condition(self._lock)
        self._queue_empty = threading.Condition(self._lock)
        self._jobs = deque()
        self._writer_thread = None
        self._retired = []
        self._writer_error = None

    def _step_dir(self, iteration: int) -> str:
        return os.path.join(self.directory, f"{_STEP_PREFIX}{iteration:07d}")

    # --- background writer -------------------------------------------------

    @property
    def pending_count(self) -> int:
        """Queued + in-flight async saves not yet committed to disk."""
        with self._lock:
            return len(self._jobs) + self._inflight

    def pin(self, iteration: int | None) -> None:
        """Protect one step from ``keep_last_n`` collection (the resilient
        loop pins its last verified-good rollback anchor)."""
        with self._lock:
            self._pinned = iteration

    def save_async(self, iteration: int, user_factors, movie_factors,
                   meta: dict | None = None) -> None:
        """Snapshot the factors and enqueue the disk write.

        The snapshot is taken here (``_snapshot``), so the caller may
        update its tensors in place at once; only the wait for the copy,
        the serialize, fsync and rename run on the writer thread.  Blocks
        while ``max_pending`` saves are pending and re-raises an earlier
        writer failure.  With ``async_write=False`` this is ``save``."""
        if not self.async_write:
            self.save(iteration, user_factors, movie_factors, meta=meta)
            return
        job = (iteration, _snapshot(user_factors), _snapshot(movie_factors),
               dict(meta or {}))
        _LIVE_MANAGERS.add(self)
        with self._lock:
            self._raise_writer_error_locked()
            while len(self._jobs) + self._inflight >= self.max_pending:
                self._queue_nonfull.wait()
                self._raise_writer_error_locked()
            self._jobs.append(job)
            if self._writer_thread is None or \
                    not self._writer_thread.is_alive():
                self._writer_thread = threading.Thread(
                    target=self._writer_loop, name="cfk-checkpoint-writer",
                    daemon=True)
                self._writer_thread.start()

    def wait_pending(self, timeout: float | None = None) -> bool:
        """Barrier: block until every queued async save is committed and
        the writer thread has ended (joined: no thread of this manager is
        left running PyTorch code, which would abort the process if the
        interpreter finalized under it).  Returns True when drained (False
        on timeout) and re-raises the first writer error.  Safe to call
        with no writer running."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._jobs or self._inflight or \
                    self._writer_thread is not None:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._queue_empty.wait(remaining)
            retired, self._retired = self._retired, []
            self._raise_writer_error_locked()
        for t in retired:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                return False
        return True

    def _raise_writer_error_locked(self) -> None:
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def _writer_loop(self) -> None:
        while True:
            with self._lock:
                if not self._jobs:
                    # Park: the thread ends when idle (``wait_pending``
                    # joins it) and the next save_async starts another.
                    self._writer_thread = None
                    self._retired.append(threading.current_thread())
                    self._queue_empty.notify_all()
                    return
                job = self._jobs.popleft()
                self._inflight += 1
            try:
                iteration, su, sm, meta = job
                self.save(iteration, su.value(), sm.value(), meta=meta)
            except BaseException as e:
                with self._lock:
                    if self._writer_error is None:
                        self._writer_error = e
            finally:
                # The job's snapshots are released while it still counts
                # as in flight: freeing a tensor is PyTorch code, and none
                # may run on this thread once a barrier has returned.
                job = su = sm = None
                with self._lock:
                    self._inflight -= 1
                    self._queue_nonfull.notify_all()
                    if not self._jobs and not self._inflight:
                        self._queue_empty.notify_all()

    def _retain(self, just_saved: int) -> None:
        """The ``keep_last_n`` retention after a commit."""
        if self.keep_last_n is None:
            return
        steps = self.iterations()
        keep = set(steps[-self.keep_last_n:])
        keep.add(just_saved)
        with self._lock:
            if self._pinned is not None:
                keep.add(self._pinned)
        for it in steps:
            if it not in keep:
                shutil.rmtree(self._step_dir(it), ignore_errors=True)

    def save(self, iteration: int, user_factors, movie_factors,
             meta: dict | None = None) -> str:
        """Write one step (numpy arrays or torch tensors); returns its path."""
        u, stored_dtype = _host(user_factors)
        m, _ = _host(movie_factors)
        if u.dtype != m.dtype:
            m = m.astype(u.dtype)
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
        try:
            np.save(os.path.join(tmp, "user.npy"), u)
            np.save(os.path.join(tmp, "movie.npy"), m)
            manifest = {
                "iteration": iteration,
                "user_shape": list(u.shape),
                "movie_shape": list(m.shape),
                "dtype": stored_dtype,
                "crc32": {name: _crc32_file(os.path.join(tmp, name))
                          for name in _PAYLOADS},
                **(meta or {}),
            }
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            for name in _PAYLOADS:
                _fsync(os.path.join(tmp, name))
            _fsync(tmp)
            final = self._step_dir(iteration)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _fsync(self.directory)
            self._retain(iteration)
            # Flight-record the commit after the rename: the event means
            # "this step is durably on disk".
            record_event("checkpoint", "checkpoint_committed",
                         iteration=iteration)
            return final
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def iterations(self) -> list[int]:
        """Committed steps, ascending (a step without a manifest is not one)."""
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_PREFIX) and os.path.exists(
                    os.path.join(self.directory, name, _MANIFEST)):
                steps.append(int(name[len(_STEP_PREFIX):]))
        return sorted(steps)

    def latest_iteration(self) -> int | None:
        steps = self.iterations()
        return steps[-1] if steps else None

    def _manifest(self, iteration: int) -> dict:
        step = self._step_dir(iteration)
        try:
            with open(os.path.join(step, _MANIFEST)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise CheckpointCorruptError(
                f"checkpoint step {iteration} in {self.directory} has an "
                f"unreadable manifest ({e}); the write was torn — delete "
                f"{step} or restore an earlier step"
            ) from None

    def verify(self, iteration: int) -> None:
        """Raise ``CheckpointCorruptError`` unless the manifest parses and
        every payload matches its recorded crc32."""
        step = self._step_dir(iteration)
        for name, want in (self._manifest(iteration).get("crc32") or {}).items():
            try:
                got = _crc32_file(os.path.join(step, name))
            except OSError as e:
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} is missing payload "
                    f"{name!r} ({e})"
                ) from None
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} payload {name!r} fails its "
                    f"manifest checksum (crc32 {got:#010x} != recorded "
                    f"{want:#010x}); delete {step} or restore an earlier step"
                )

    def latest_valid_iteration(self) -> int | None:
        """Newest step that verifies; corrupt steps are skipped with a
        warning."""
        for it in reversed(self.iterations()):
            try:
                self.verify(it)
            except CheckpointCorruptError as e:
                warnings.warn(f"skipping corrupt checkpoint: {e}")
                # Falling back past a corrupt step leaves a forensic trail.
                record_event("checkpoint", "corrupt_checkpoint_skipped",
                             iteration=it, error=str(e))
                dump_flight("corrupt_checkpoint")
                continue
            return it
        return None

    def manifest_meta(self, iteration: int) -> dict:
        """The caller's ``meta`` of one verified step, without the payloads."""
        self.verify(iteration)
        return {k: v for k, v in self._manifest(iteration).items()
                if k not in _RESERVED}

    def restore(self, iteration: int | None = None) -> CheckpointState:
        """The given step (verified), or the newest valid one."""
        if iteration is None:
            iteration = self.latest_valid_iteration()
            if iteration is None:
                raise FileNotFoundError(
                    f"no intact checkpoints in {self.directory}"
                )
        else:
            self.verify(iteration)
        step = self._step_dir(iteration)
        manifest = self._manifest(iteration)
        u = np.load(os.path.join(step, "user.npy"))
        m = np.load(os.path.join(step, "movie.npy"))
        want = manifest.get("dtype", "float32")
        if str(u.dtype) != want:
            if want != "bfloat16":
                raise CheckpointCorruptError(
                    f"checkpoint step {iteration} stores {u.dtype} for "
                    f"dtype {want!r}; the port restores float32, float64 "
                    "and bfloat16 factors"
                )
            u = torch.from_numpy(u).to(torch.bfloat16)
            m = torch.from_numpy(m).to(torch.bfloat16)
        return CheckpointState(
            iteration=manifest["iteration"], user_factors=u, movie_factors=m,
            meta={k: v for k, v in manifest.items() if k not in _RESERVED},
        )
