"""Deterministic fault injection: prove recovery works, don't assume it.

The port's copy of the single-process injectors of
``cfk_tpu/resilience/faults.py``, with the reference's names, fields and
seeded row choices, so the same fault plan corrupts the same rows in both
packages.  Every fault is seeded and replayable; ``tests/
test_torch_resilience.py`` and ``cfk_tpu_torch.scripts.chaos_lab`` assert
that each one is detected, rolled back and recovered:

- ``FactorCorruption`` — NaN/Inf written into seeded rows of a factor
  table just before iteration ``k`` (an HBM bit-flip or a bad copy);
- ``SingularChunk`` — zero the fixed side's rows feeding some entities'
  normal equations, so with λ = 0 their Grams are exactly singular (the
  policy's λ bump is the designed fix);
- ``TornCheckpointManager`` / ``SlowDiskCheckpointManager`` — a torn step
  write (caught by the crc32 manifest) and a slow disk (absorbed by the
  async writer);
- ``PreemptAt`` — SIGTERM to this process before an iteration;
- ``FlakyTransport`` (with its ``FlakyPlan``) — record-level duplicate,
  reorder and drop faults between a durable log and its reader (the
  streaming consumer must heal all three);
- ``FlakyBrokerProxy`` — a localhost TCP proxy in front of the broker that
  drops the first connections and delays frames (the TCP client's connect
  and read retries must win);
- ``DeltaStreamTamper`` — a frame of the serving fleet's factor-delta
  topic hidden for good (or truncated): the replica's gap detector and its
  snapshot resync must fire.

- ``HostWindowCorruption``, ``HotCacheCorruption``, ``SlowHostFetch``,
  ``StagingCrash``, ``StoreBitRot`` behind one ``WindowFaultInjector`` —
  the out-of-core tier's faults (``offload.windowed``): a torn or
  poisoned staged window, a poisoned hot-row partition on the card, a
  slow host fetch, a crash inside a staging worker, and bit-rot in a host
  master store.

The others (the elastic offload fleet's membership faults, the backend
outage) belong to the slices that port what they break.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import threading
import time

import numpy as np
import torch

from cfk_tpu_torch.transport.checkpoint import (
    CheckpointManager as _BaseCheckpointManager,
)
from cfk_tpu_torch.transport.checkpoint import _crc32_file

# --- factor-table faults ---------------------------------------------------


def _with_rows(target, rows, value):
    """A copy of ``target`` with ``rows`` (a slice or host indices) set to
    ``value`` — the caller's tensor is left as it was."""
    out = target.clone()
    out[rows] = value
    return out


@dataclasses.dataclass
class FactorCorruption:
    """Write ``value`` into ``num_rows`` seeded rows of one side's factors
    before iteration ``iteration`` (0-based).  ``persistent`` re-fires on
    every pass through that iteration (a rollback replays into the same
    fault — the escalation path must fix the math); one-shot faults model
    transients that a plain rollback+retry clears.  ``rows=(lo, hi)``
    corrupts that contiguous slice instead of seeded random rows.  In a
    sharded run the rows are the rank's own, and ``only_process`` corrupts
    that rank's alone (a local fault every rank must agree on)."""

    iteration: int
    side: str = "u"  # "u" | "m"
    value: float = float("nan")
    num_rows: int = 4
    seed: int = 0
    persistent: bool = False
    rows: tuple[int, int] | None = None
    fired: int = 0
    only_process: int | None = None

    def apply(self, i: int, u, m):
        if i != self.iteration or (self.fired and not self.persistent):
            return u, m
        if self.only_process is not None and _rank() != self.only_process:
            return u, m
        self.fired += 1
        target = u if self.side == "u" else m
        if self.rows is not None:
            rows = slice(*self.rows)
        else:
            rows = np.random.default_rng(self.seed).choice(
                target.shape[0], size=min(self.num_rows, target.shape[0]),
                replace=False)
            rows = [int(r) for r in rows]
        target = _with_rows(target, rows, self.value)
        return (target, m) if self.side == "u" else (u, target)


@dataclasses.dataclass
class SingularChunk:
    """Zero a contiguous slice of the fixed side's factor rows before
    iteration ``iteration``, so the entities whose neighbors all lie in it
    assemble an exactly singular A = Σ f·fᵀ (run with λ = 0 to remove the
    SPD repair; the ladder's λ bump is then the recovery).  ``rows=None``
    zeroes the whole side."""

    iteration: int
    side: str = "u"
    rows: tuple[int, int] | None = None
    persistent: bool = True
    fired: int = 0

    def apply(self, i: int, u, m):
        if i != self.iteration or (self.fired and not self.persistent):
            return u, m
        self.fired += 1
        target = u if self.side == "u" else m
        lo, hi = self.rows if self.rows is not None else (0, target.shape[0])
        target = _with_rows(target, slice(lo, hi), 0.0)
        return (target, m) if self.side == "u" else (u, target)


class FaultInjector:
    """The hook the resilient loop calls: a seeded plan of factor faults.

    ``before_step(i, u, m)`` applies every armed fault due at iteration
    ``i`` and returns the (possibly corrupted) pair.  Passing an injector
    to a trainer sends it to the eager stepped loop, where faults fire at
    iteration boundaries.
    """

    def __init__(self, *faults):
        self.faults = list(faults)

    def before_step(self, i: int, u, m):
        for f in self.faults:
            u, m = f.apply(i, u, m)
        return u, m

    @property
    def fired(self) -> int:
        return sum(f.fired for f in self.faults)


# --- host-window faults (the out-of-core tier) -----------------------------


@dataclasses.dataclass
class HostWindowCorruption:
    """Corrupt ONE staged host window in flight before it reaches the
    device (``cfk_tpu/resilience/faults.py:178``).  Fires when the windowed
    trainer stages ``(iteration, side, window)``; the host store stays
    intact, so a rollback + replay (the fault is one-shot) recovers to the
    fault-free bits.  ``kind="nan"`` poisons ``num_rows`` seeded rows;
    ``kind="torn"`` zeroes the window's second half (finite and wrong —
    caught by the staging checksum).  ``shard`` restricts the fault to one
    shard's staging (None: any); ``fired_in`` names the threads it fired
    on (a pool worker in pooled staging)."""

    iteration: int
    side: str = "m"
    window: int = 0
    kind: str = "nan"  # "nan" | "torn"
    num_rows: int = 4
    seed: int = 0
    persistent: bool = False
    shard: int | None = None
    fired: int = 0
    fired_in: list = dataclasses.field(default_factory=list)

    def apply_window(self, i: int, side: str, w: int, tbl,
                     shard: int = 0):
        if (i != self.iteration or side != self.side or w != self.window
                or (self.shard is not None and shard != self.shard)
                or (self.fired and not self.persistent)):
            return tbl
        self.fired += 1
        self.fired_in.append(threading.current_thread().name)
        tbl = tbl.clone()  # never mutate the store's rows
        if self.kind == "torn":
            tbl[tbl.shape[0] // 2:] = 0.0
            return tbl
        rows = np.random.default_rng(self.seed).choice(
            tbl.shape[0], size=min(self.num_rows, tbl.shape[0]),
            replace=False)
        tbl[rows] = float("nan")
        return tbl


@dataclasses.dataclass
class HotCacheCorruption:
    """Poison the DEVICE-resident hot-row partition
    (``cfk_tpu/resilience/faults.py:231``): when the windowed trainer is
    about to read the ``(iteration, side)`` half's fixed partition it NaNs
    ``num_rows`` seeded positions (an int8 partition: the scale).  The host
    master is untouched, so the sentinel's rollback and the partition
    rebuild recover the fault-free bits."""

    iteration: int
    side: str = "m"
    num_rows: int = 4
    seed: int = 0
    persistent: bool = False
    fired: int = 0

    def apply_hot(self, i: int, side: str, partition_rows: int = 0):
        if (i != self.iteration or side != self.side or partition_rows < 1
                or (self.fired and not self.persistent)):
            return None
        self.fired += 1
        return np.random.default_rng(self.seed).choice(
            partition_rows, size=min(self.num_rows, partition_rows),
            replace=False)


@dataclasses.dataclass
class SlowHostFetch:
    """Sleep ``delay_s`` before every ``every``-th window staging (a
    contended host; ``cfk_tpu/resilience/faults.py:264``) — a timing fault
    the staging engine must absorb without touching a bit.  ``fired``
    counts delays actually injected, under a lock (pool workers stage
    concurrently); ``only_shard`` slows one shard's staging only."""

    delay_s: float = 0.01
    every: int = 1
    only_shard: int | None = None
    fired: int = 0
    calls: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def delay(self, i: int, side: str, w: int, shard: int = 0) -> None:
        if self.every < 1:
            return
        if self.only_shard is not None and shard != self.only_shard:
            return
        with self._lock:
            self.calls += 1
            due = self.calls % self.every == 0
            if due:
                self.fired += 1
        if due:
            time.sleep(self.delay_s)


@dataclasses.dataclass
class StagingCrash:
    """Raise from INSIDE one window's staging
    (``cfk_tpu/resilience/faults.py:302``): the staging engine must hand
    the error to the consumer (``WindowStager.take`` re-raises and cancels
    the rest) — never a hang, never a half-staged window reaching a
    kernel."""

    iteration: int
    side: str = "m"
    window: int = 0
    shard: int | None = None
    message: str = "injected staging crash"
    fired: int = 0
    fired_in: list = dataclasses.field(default_factory=list)

    def apply_window(self, i: int, side: str, w: int, tbl,
                     shard: int = 0):
        if (i != self.iteration or side != self.side or w != self.window
                or (self.shard is not None and shard != self.shard)
                or self.fired):
            return tbl
        self.fired += 1
        self.fired_in.append(threading.current_thread().name)
        raise RuntimeError(self.message)


@dataclasses.dataclass
class StoreBitRot:
    """Flip one byte of a ``HostFactorStore`` shard after iteration
    ``iteration`` commits (``cfk_tpu/resilience/faults.py:333``): silent
    bit-rot in a MASTER table.  The per-shard seals must detect it
    (``StoreIntegrityError``) and the trainer repair from the last committed
    checkpoint."""

    iteration: int
    side: str = "u"
    shard: int = 0
    byte: int = 0
    fired: int = 0

    def apply_store(self, i: int, side: str, store) -> None:
        if i != self.iteration or side != self.side or self.fired:
            return
        self.fired += 1
        buf = store.shard(self.shard).view(-1).view(torch.uint8)
        buf[self.byte % buf.numel()] ^= 0xFF


class WindowFaultInjector:
    """The hook ``offload.windowed`` calls while staging
    (``cfk_tpu/resilience/faults.py:396``): applies every armed window
    corruption, delay plan, hot-partition poison and store bit-rot."""

    def __init__(self, *faults):
        self.faults = list(faults)

    def apply_window(self, i: int, side: str, w: int, tbl, shard: int = 0):
        for f in self.faults:
            if hasattr(f, "apply_window"):
                tbl = f.apply_window(i, side, w, tbl, shard=shard)
        return tbl

    def delay(self, i: int, side: str, w: int, shard: int = 0) -> None:
        for f in self.faults:
            if hasattr(f, "delay"):
                f.delay(i, side, w, shard=shard)

    def apply_hot(self, i: int, side: str, partition_rows: int = 0):
        for f in self.faults:
            if hasattr(f, "apply_hot"):
                rows = f.apply_hot(i, side, partition_rows)
                if rows is not None:
                    return rows
        return None

    def apply_store(self, i: int, side: str, store) -> None:
        for f in self.faults:
            if hasattr(f, "apply_store"):
                f.apply_store(i, side, store)

    @property
    def fired(self) -> int:
        return sum(f.fired for f in self.faults)


# --- checkpoint faults -----------------------------------------------------


class TornCheckpointManager:
    """Wrap a ``CheckpointManager`` so the save at ``tear_at`` is torn.

    ``mode="truncate"`` halves one npy payload after the step directory is
    committed (a torn write that raced the rename); ``mode="scramble"``
    flips bytes in place (silent media corruption); ``mode="manifest"``
    truncates ``manifest.json`` itself.  The crc32 manifest verification
    catches all three on restore and falls back to the previous step.
    """

    def __init__(self, inner, tear_at: int, mode: str = "truncate",
                 victim: str = "user.npy"):
        if mode not in ("truncate", "scramble", "manifest"):
            raise ValueError(f"unknown tear mode {mode!r}")
        self.inner = inner
        self.tear_at = tear_at
        self.mode = mode
        self.victim = victim
        self.torn: list[str] = []

    def __getattr__(self, name):  # delegate everything else
        return getattr(self.inner, name)

    def save_async(self, iteration, user_factors, movie_factors, meta=None):
        # The sync path: the inner writer thread would call inner.save and
        # route around the tear, which must land before training moves on.
        self.save(iteration, user_factors, movie_factors, meta=meta)

    def save(self, iteration, user_factors, movie_factors, meta=None):
        path = self.inner.save(iteration, user_factors, movie_factors,
                               meta=meta)
        if iteration == self.tear_at:
            victim = os.path.join(
                path, "manifest.json" if self.mode == "manifest"
                else self.victim)
            with open(victim, "rb") as f:
                data = f.read()
            if self.mode == "scramble":
                torn = bytes(b ^ 0xFF for b in data[: len(data) // 2])
                torn += data[len(data) // 2:]
            else:
                torn = data[: max(1, len(data) // 2)]
            with open(victim, "wb") as f:
                f.write(torn)
            self.torn.append(victim)
        return path


class SlowDiskCheckpointManager(_BaseCheckpointManager):
    """Checkpoint store on a pathologically slow disk: every step write
    sleeps ``delay_s`` before touching the filesystem.  A subclass, so the
    inherited ``save_async`` hands this slow ``save`` to the writer thread;
    ``writes``/``max_pending_seen`` record that the fault fired."""

    def __init__(self, directory, *, delay_s=0.05, **kw):
        super().__init__(directory, **kw)
        self.delay_s = delay_s
        self.writes = 0
        self.max_pending_seen = 0

    def save(self, iteration, user_factors, movie_factors, meta=None):
        self.max_pending_seen = max(self.max_pending_seen,
                                    self.pending_count)
        time.sleep(self.delay_s)
        self.writes += 1
        return super().save(iteration, user_factors, movie_factors,
                            meta=meta)


def _rank() -> int:
    """This process's rank in its sharded run (0 outside one)."""
    from cfk_tpu_torch.parallel.mesh import current_group

    group = current_group()
    return 0 if group is None else group.rank


@dataclasses.dataclass
class PreemptAt:
    """Deliver ``signum`` (default SIGTERM) to this very process before
    iteration ``iteration`` — the eviction notice a preempted machine gets.
    A ``PreemptionGuard`` must be armed: its handler turns the signal into
    the graceful save-and-exit the loop polls for.  ``only_process`` fires
    on that rank of a sharded run only (``parallel.mesh.current_group``;
    one process is rank 0) — with SIGKILL, the hard loss of one worker."""

    iteration: int
    signum: int = 15  # signal.SIGTERM
    fired: int = 0
    only_process: int | None = None

    def apply(self, i: int, u, m):
        if i != self.iteration or self.fired:
            return u, m
        if self.only_process is not None and _rank() != self.only_process:
            return u, m
        self.fired += 1
        os.kill(os.getpid(), self.signum)
        return u, m


# --- transport delivery faults ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlakyPlan:
    """Deterministic misbehavior schedule for the broker fault proxies.

    Byte-level faults (``FlakyBrokerProxy``):

    ``drop_first_connects`` — accept then immediately close that many
    connections (a broker still binding its listener / a dying LB
    backend); the client's connect/request retry must back off and win.
    ``delay_frames`` — hold each forwarded chunk of the first surviving
    connection for ``frame_delay`` seconds (congestion); the client's
    read timeout must be patient enough or retry.

    Record-level delivery faults (``FlakyTransport``, a ``Transport``
    proxy — the at-least-once semantics a Kafka consumer actually faces,
    which raw TCP byte faults cannot express without corrupting framing):

    ``duplicate`` — re-deliver every ``duplicate``-th consumed record a
    second time (at-least-once redelivery); the streaming consumer must
    drop the copy by offset.
    ``reorder`` — shuffle delivery order within seeded windows of this
    many records (interleaved fetches / a racy poll); the consumer must
    heal order by offset sort.
    ``drop`` — omit every ``drop``-th record from a delivery pass, at
    most ``drop_passes`` times per record (a lost fetch; the transport
    still HAS the record — re-polling must recover it).
    ``seed`` — the reorder shuffle's PRNG seed.
    """

    drop_first_connects: int = 0
    delay_frames: int = 0
    frame_delay: float = 0.05
    duplicate: int = 0
    reorder: int = 0
    drop: int = 0
    drop_passes: int = 1
    seed: int = 0


class FlakyBrokerProxy:
    """A localhost TCP proxy in front of a real broker, misbehaving to plan.

    Forwards bytes both ways once a connection survives the plan; every
    drop/delay is counted so tests assert the fault actually happened
    (a chaos test that passes without injecting anything proves nothing).

    This proxy owns the BYTE-level faults of a ``FlakyPlan`` (connection
    drops, frame delays).  The plan's RECORD-level delivery faults —
    ``duplicate``/``reorder``/``drop`` — are applied by ``FlakyTransport``
    instead: duplicating raw TCP bytes would corrupt the length-prefixed
    framing into garbage, whereas real at-least-once brokers duplicate and
    reorder *records* with intact payloads, which is the failure mode the
    streaming consumer's exactly-once assembly must survive.
    """

    def __init__(self, upstream_port: int, plan: FlakyPlan):
        self.upstream_port = upstream_port
        self.plan = plan
        self.dropped = 0
        self.delayed = 0
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(8)
        self.port = self._lsock.getsockname()[1]
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._accepted = 0
        t = threading.Thread(target=self._accept_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._lsock.accept()
            except OSError:
                return
            self._accepted += 1
            if self._accepted <= self.plan.drop_first_connects:
                self.dropped += 1
                conn.close()
                continue
            up = socket.create_connection(("127.0.0.1", self.upstream_port))
            for src, dst, slow in ((conn, up, False), (up, conn, True)):
                t = threading.Thread(
                    target=self._pump, args=(src, dst, slow), daemon=True
                )
                t.start()
                self._threads.append(t)

    def _pump(self, src, dst, slow):
        frames = 0
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                if slow and frames < self.plan.delay_frames:
                    frames += 1
                    self.delayed += 1
                    time.sleep(self.plan.frame_delay)
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s in (src, dst):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def close(self):
        self._stop.set()
        self._lsock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class FlakyTransport:
    """A ``Transport`` proxy that misdelivers records per a ``FlakyPlan``.

    Produce/admin calls pass through untouched — the faults live purely in
    ``consume``, i.e. between the durable log and the reader, which is
    exactly where Kafka's at-least-once semantics misbehave: records may
    arrive duplicated (``plan.duplicate``), out of order within a window
    (``plan.reorder``), or missing from a pass (``plan.drop``, recovered
    on a later poll — the transport never loses the record, only a
    delivery of it).  Each fault is counted (``duplicated``/``reordered``/
    ``dropped``) so chaos tests can assert the fault actually fired.
    Deterministic: the reorder shuffle is seeded per (partition, pass) and
    the duplicate/drop cadences are positional.
    """

    def __init__(self, inner, plan: FlakyPlan):
        self.inner = inner
        self.plan = plan
        self.duplicated = 0
        self.reordered = 0
        self.dropped = 0
        self._passes = 0
        self._drop_seen: dict[tuple[str, int, int], int] = {}

    def __getattr__(self, name):  # produce/create_topic/end_offset/... pass through
        return getattr(self.inner, name)

    def consume(self, topic, partition, start_offset=0):
        records = list(self.inner.consume(topic, partition, start_offset))
        self._passes += 1
        plan = self.plan
        out = []
        for i, rec in enumerate(records):
            if plan.drop:
                key = (topic, partition, rec.offset)
                if (i + 1) % plan.drop == 0 and \
                        self._drop_seen.get(key, 0) < plan.drop_passes:
                    self._drop_seen[key] = self._drop_seen.get(key, 0) + 1
                    self.dropped += 1
                    continue
            out.append(rec)
            if plan.duplicate and (i + 1) % plan.duplicate == 0:
                out.append(rec)
                self.duplicated += 1
        if plan.reorder and len(out) > 1:
            rng = np.random.default_rng(
                (plan.seed, partition, self._passes)
            )
            w = max(2, plan.reorder)
            for lo in range(0, len(out), w):
                window = out[lo:lo + w]
                perm = rng.permutation(len(window))
                if not np.array_equal(perm, np.arange(len(window))):
                    self.reordered += len(window)
                out[lo:lo + w] = [window[j] for j in perm]
        yield from out


class DeltaStreamTamper:
    """A ``Transport`` proxy that PERMANENTLY hides chosen frames of one
    topic from consumers — the factor-delta gap fault of the serving fleet.

    ``FlakyTransport.drop`` models a missed *delivery*: the record comes
    back on a later pass, which seq-ordered apply absorbs silently.  This
    wrapper models the loss the delta protocol must detect LOUDLY — a
    frame that never arrives (compacted away, crossed a retention
    boundary, or corrupted at rest): offsets in ``hide`` (per ``topic``)
    vanish from every consume pass, so the replica's next frame skips a
    seq and the gap→snapshot-resync path has to fire.  ``mode="truncate"``
    instead delivers the frame with its payload cut in half — the
    undecodable-frame spelling of the same gap.  ``hidden``/``truncated``
    count firings so the chaos test can assert the fault actually
    happened."""

    def __init__(self, inner, *, topic: str, hide=(), mode: str = "hide"):
        if mode not in ("hide", "truncate"):
            raise ValueError(f"mode must be hide|truncate, got {mode!r}")
        self.inner = inner
        self.topic = topic
        self.hide = set(int(o) for o in hide)
        self.mode = mode
        self.hidden = 0
        self.truncated = 0

    def __getattr__(self, name):  # produce/create_topic/... pass through
        return getattr(self.inner, name)

    def consume(self, topic, partition, start_offset=0):
        for rec in self.inner.consume(topic, partition, start_offset):
            if topic == self.topic and rec.offset in self.hide:
                if self.mode == "hide":
                    self.hidden += 1
                    continue
                import dataclasses

                self.truncated += 1
                rec = dataclasses.replace(
                    rec, value=rec.value[: max(1, len(rec.value) // 2)]
                )
            yield rec


# --- fixtures ----------------------------------------------------------------


def blockstructured_coo(num_users: int = 24, num_movies: int = 16,
                        isolated_movies: int = 4, isolated_users: int = 8,
                        seed: int = 0):
    """Small dense-ish COO where the first ``isolated_movies`` movies are
    rated ONLY by the first ``isolated_users`` users (who also rate the
    shared movies).  Zeroing those users' rows (``SingularChunk``) makes
    exactly the isolated movies' normal equations singular under λ = 0,
    while every entity has enough neighbors that the fault-free λ = 0 run
    is non-singular.  The reference's fixture, the same arrays."""
    from cfk_tpu_torch.data.blocks import RatingsCOO

    rng = np.random.default_rng(seed)
    movies, users = [], []
    for mv in range(num_movies):
        raters = (range(isolated_users) if mv < isolated_movies
                  else range(num_users))
        for us in raters:
            movies.append(mv)
            users.append(us)
    movies = np.asarray(movies, np.int64)
    users = np.asarray(users, np.int64)
    ratings = rng.integers(1, 6, size=movies.shape[0]).astype(np.float32)
    return RatingsCOO(movie_raw=movies, user_raw=users, rating=ratings)


def crc32_file(path: str) -> int:
    """crc32 of a file's bytes — the checkpoint manifest's payload
    checksum (one implementation, ``transport.checkpoint``)."""
    return _crc32_file(path)
