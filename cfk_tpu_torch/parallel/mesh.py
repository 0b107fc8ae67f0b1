"""Rank groups and their collectives: the port of ``cfk_tpu/parallel/mesh.py``.

The JAX package's fabric is a 1-D ``jax.sharding.Mesh`` over the
``"shard"`` axis driven by one controller.  Here the same axis is S
processes joined by ``torch.distributed``; each one holds its own rows of
every factor table and block array (entity rows block-sharded, rank r owns
rows [r·L, (r+1)·L)) and runs its own kernel launches.

- ``ShardGroup`` is one rank's view: ``rank``, ``size``, ``device`` and the
  collectives the half-steps use (``all_gather``, ``all_reduce``,
  ``shift`` — the ring's send/recv pair).
- ``make_mesh(S)`` starts S ranks (``spawn``, never ``fork``: a forked child
  of a process that has touched CUDA breaks) that rendezvous through a
  ``file://`` store in a fresh temporary directory, and returns the
  controller's handle, ``Mesh``: ``Mesh.run(fn, ...)`` runs ``fn(group,
  ...)`` on every rank and returns their results; an exception in any rank
  raises in the caller with that rank's traceback.
- ``initialize_distributed`` joins a torchrun-style launch (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and
  ``make_multihost_mesh`` returns that process's ``ShardGroup``.

The backend is chosen once, at init, from the topology, and printed:
``nccl`` when every rank has a card of its own, ``gloo`` on the CPU, and
``gloo`` with the exchanges staged through pinned host memory (device →
pinned host on a side stream, an event, the collective on the host copy,
host → device with the compute stream waiting on the copy's event) when
ranks share a card — NCCL refuses two ranks on one device.  Ranks are placed
round-robin over the visible cards.  Nothing switches backend or device
after an error, and every wait is bounded by the process group's timeout.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import io
import os
import pickle
import shutil
import sys
import tempfile
import threading
import traceback
import weakref

import numpy as np
import torch
import torch.distributed as dist

AXIS = "shard"

# Exit status of the init-timeout watchdog: "the group never assembled within
# the bound", distinct from crash codes (``cfk_tpu/parallel/mesh.py:33``).
INIT_TIMEOUT_EXIT_CODE = 18

DEFAULT_TIMEOUT_S = 300.0


def _looks_like_init_timeout(e: BaseException) -> bool:
    msg = str(e).lower()
    return "timed out" in msg or "timeout" in msg and "store" in msg


def _init_timeout_message(coordinator_address, num_processes, process_id,
                          timeout_s) -> str:
    missing = (
        sorted(set(range(num_processes)) - {process_id})
        if num_processes is not None and process_id is not None
        else "unknown"
    )
    return (
        f"initialize_distributed timed out after {timeout_s}s: process "
        f"{process_id} waited at coordinator {coordinator_address} but the "
        f"runtime never assembled all {num_processes} processes — the "
        f"missing peer(s) are among process ids {missing}; check that every "
        "process was launched, is still alive, and can reach the "
        "coordinator"
    )


def placement(rank: int, size: int, device: str | None) -> tuple[str, str, bool]:
    """(device, backend, staged) of ``rank`` of ``size``: ranks round-robin
    over the visible cards; ``nccl`` when every rank has its own card,
    ``gloo`` staged through pinned host memory when ranks share one,
    ``gloo`` on the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        return "cpu", "gloo", False
    if kind != "cuda":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError(
            f"device={device!r} was requested but no CUDA device is visible; "
            "pass device='cpu' for ranks on the CPU")
    if n >= size:
        return f"cuda:{rank}", "nccl", False
    return f"cuda:{rank % n}", "gloo", True


def describe(size: int, device: str | None) -> str:
    """The one placement line a group prints at init."""
    rows = [placement(r, size, device) for r in range(size)]
    _, backend, staged = rows[0]
    where = ", ".join(f"rank {r} on {d}" for r, (d, _, _) in enumerate(rows))
    how = (" with the exchanges staged through pinned host memory (ranks "
           "share a card)" if staged else "")
    return f"{size} ranks, backend {backend}{how}: {where}"


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A tensor as the collectives move it: bf16 as its bytes (uint8, the
    last axis doubled): the gathers and the ring move bytes, and gloo
    handles no bfloat16."""
    return x.view(torch.uint8) if x.dtype == torch.bfloat16 else x


def _unwire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(dtype) if dtype == torch.bfloat16 else x


@dataclasses.dataclass
class _Pending:
    """An in-flight ``shift``: ``wait()`` returns the received tensors on
    the group's device."""

    group: "ShardGroup"
    reqs: list
    bufs: tuple
    like: tuple

    def wait(self) -> tuple:
        for r in self.reqs:
            r.wait()
        return tuple(
            self.group._arrive(_unwire(b, t.dtype), t)
            for b, t in zip(self.bufs, self.like))


class ShardGroup:
    """One rank's view of a 1-D group of ranks on the ``"shard"`` axis.

    ``size == 1`` (no process group) makes every collective the identity,
    so the sharded code paths run unchanged in one process.  ``device``
    defaults to the rank's card by ``placement`` (pass "cpu" for a rank on
    the CPU).  ``staged`` routes every exchange of device tensors through pinned host memory
    (gloo with ranks sharing a card); ``staged_bytes`` counts the bytes
    this rank moved device → host for its exchanges (a per-process
    counter, read and zeroed by callers)."""

    AXIS = AXIS

    def __init__(self, rank: int = 0, size: int = 1, device=None,
                 backend: str = "gloo", staged: bool = False,
                 group=None, timeout_s: float = DEFAULT_TIMEOUT_S):
        self.rank, self.size = rank, size
        if device is None:
            device = placement(rank, size, None)[0]
        self.device = torch.device(device)
        self.backend, self.staged = backend, staged
        self.group = group
        self.timeout_s = timeout_s
        self.staged_bytes = 0
        self._copy_stream = None

    def __repr__(self) -> str:
        return (f"ShardGroup(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r}, "
                f"staged={self.staged})")

    # -- staging ---------------------------------------------------------

    def _stream(self):
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    def _depart(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor the collective reads: a staged device tensor's pinned
        host copy (copied on the side stream after the compute stream's
        work on it, the host waiting on the copy's event), else ``x``."""
        x = x.contiguous()
        if not (self.staged and x.device.type == "cuda"):
            return x
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        side = self._stream()
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            buf.copy_(x, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        x.record_stream(side)
        done.synchronize()
        self.staged_bytes += x.numel() * x.element_size()
        return buf

    def _arrive(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received host tensor back on the device of ``like`` (the
        departing tensor): the host → device copy runs on the side stream
        and the compute stream waits on its event (no host sync)."""
        if not self.staged or like.device.type != "cuda" or \
                x.device.type == "cuda":
            return x
        side = self._stream()
        with torch.cuda.stream(side):
            out = x.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(done)
        out.record_stream(cur)
        return out

    def _empty_like_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A receive buffer for ``x``'s wire form (pinned host memory when
        staged)."""
        w = _wire(x)
        if self.staged and x.device.type == "cuda":
            return torch.empty(w.shape, dtype=w.dtype, pin_memory=True)
        return torch.empty(w.shape, dtype=w.dtype, device=x.device)

    # -- collectives -----------------------------------------------------

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along rows, in rank order (the
        ``lax.all_gather(..., tiled=True)`` of the JAX package)."""
        if self.size == 1:
            return x
        send = _wire(self._depart(x))
        parts = [self._empty_like_wire(x) for _ in range(self.size)]
        dist.all_gather(parts, send, group=self.group)
        if not parts[0].dim():
            return self._arrive(torch.stack(parts), x)
        out = torch.empty((self.size * parts[0].shape[0],)
                          + tuple(parts[0].shape[1:]), dtype=parts[0].dtype,
                          device=parts[0].device,
                          pin_memory=parts[0].is_pinned())
        torch.cat(parts, out=out)
        return self._arrive(_unwire(out, x.dtype), x)

    def all_gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's [B, K] ``x`` side by side: [B, size·K]."""
        if self.size == 1:
            return x
        g = self.all_gather(x.T.contiguous())  # [size·K, B]
        return g.T.contiguous()

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The elementwise ``op`` ("sum" or "max") over ranks, as a new
        tensor (``lax.psum`` / ``pmax``)."""
        if self.size == 1:
            return x.clone()
        buf = self._depart(x)
        buf = buf.clone() if buf is x else buf
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self.group)
        return self._arrive(buf, x)

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is true on any (a host-side
        agreement, always through a CPU tensor)."""
        if self.size == 1:
            return bool(flag)
        t = torch.tensor([1 if flag else 0], dtype=torch.int32)
        if self.backend == "nccl":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(int(t.item()))

    def agree_or(self, word: int) -> int:
        """The bitwise OR of every rank's ``word`` (the health probe's
        reason bits), on every rank."""
        if self.size == 1:
            return int(word)
        words = [0] * self.size
        dist.all_gather_object(words, int(word), group=self.group)
        out = 0
        for w in words:
            out |= int(w)
        return out

    def broadcast_object(self, obj, src: int = 0):
        if self.size == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def shift(self, tensors: tuple, perm) -> _Pending:
        """Start the ring step of ``perm`` (a list of (src, dst) rank pairs,
        a full permutation): send each of ``tensors`` to this rank's
        destination and receive the same shapes from its source, all in one
        ``batch_isend_irecv``; ``wait()`` on the result returns the received
        tensors.  A fixed point of ``perm`` keeps its own tensors."""
        dst = dict(perm)[self.rank]
        src = {d: s for s, d in perm}[self.rank]
        if dst == self.rank:
            return _Pending(self, [], tuple(_wire(t) for t in tensors),
                            tuple(tensors))
        ops, bufs = [], []
        for t in tensors:
            send = _wire(self._depart(t))
            buf = self._empty_like_wire(t)
            ops.append(dist.P2POp(dist.isend, send, dst, group=self.group))
            ops.append(dist.P2POp(dist.irecv, buf, src, group=self.group))
            bufs.append(buf)
        return _Pending(self, dist.batch_isend_irecv(ops), tuple(bufs),
                        tuple(tensors))

    def barrier(self) -> None:
        if self.size > 1:
            self.any(False)


_CURRENT: ShardGroup | None = None


def current_group() -> ShardGroup | None:
    """This process's group: the rank's inside ``make_mesh``'s workers or
    after ``make_multihost_mesh``, else None."""
    return _CURRENT


def _join(rank: int, size: int, init_method: str, device,
          timeout_s: float) -> ShardGroup:
    global _CURRENT
    dev, backend, staged = placement(rank, size, device)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout_s))
    _CURRENT = ShardGroup(rank, size, dev, backend, staged,
                          group=dist.group.WORLD, timeout_s=timeout_s)
    return _CURRENT


# -- the spawned rank pool ----------------------------------------------------


def _tensor_from_bytes(data, dtype, shape) -> torch.Tensor:
    return torch.from_numpy(np.asarray(data)).view(dtype).reshape(shape)


class _Pickler(pickle.Pickler):
    """Pickles tensors as their bytes (a numpy array, so pickle protocol 5
    can carry them out of band) instead of torch's in-band storage."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu().contiguous().reshape(-1)
            return _tensor_from_bytes, (t.view(torch.uint8).numpy(), obj.dtype,
                                        tuple(obj.shape))
        return NotImplemented


def _dump(obj, path: str) -> tuple:
    """A message for ``_load``: ``obj`` pickled with its arrays and tensors
    written, out of band, to the file ``path``.  Only the small in-band
    pickle crosses the pipe: a pipe moves bulk data slowly, a file at the
    speed of memory."""
    buffers = []
    f = io.BytesIO()
    _Pickler(f, protocol=5, buffer_callback=buffers.append).dump(obj)
    sizes = []
    if buffers:
        with open(path, "wb") as out:
            for b in buffers:
                raw = b.raw()
                sizes.append(raw.nbytes)
                out.write(raw)
    return f.getvalue(), (path if buffers else None), sizes


def _load(msg):
    data, path, sizes = msg
    buffers = []
    if path is not None:
        with open(path, "rb") as f:
            for n in sizes:
                b = bytearray(n)
                f.readinto(b)
                buffers.append(b)
        os.unlink(path)
    return pickle.loads(data, buffers=buffers)


def _rank_main(rank, size, init_method, device, timeout_s, threads, conn,
               evict, workdir):
    """A ``make_mesh`` worker: join the group, report its placement, then run
    jobs until told to stop.  Each job's result (or its traceback) goes back
    through ``conn``, its bulk through a file in ``workdir``."""
    try:
        torch.set_num_threads(threads)
        group = _join(rank, size, init_method, device, timeout_s)
        group.evict = evict
        conn.send(("ready", (str(group.device), group.backend,
                             group.staged)))
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    jobs = 0
    while True:
        try:
            job = conn.recv()
        except EOFError:
            break
        if job is None:
            break
        jobs += 1
        try:
            fn, args, kwargs = _load(job)
            out = fn(group, *args, **kwargs)
            conn.send(("ok", _dump(out, os.path.join(
                workdir, f"result-{rank}-{jobs}"))))
        except BaseException:
            conn.send(("err", traceback.format_exc()))
    try:
        dist.destroy_process_group()
    except Exception:  # pragma: no cover - teardown best effort
        pass


class RankError(RuntimeError):
    """A rank of a ``Mesh`` failed; the message holds its traceback."""


class _EvictFlag:
    """The preemption guard a ``Mesh`` rank polls: set by the controller
    when its own guard triggers (``Mesh.run(..., guard=)``)."""

    signal_name = "controller signalled"

    def __init__(self, event):
        self._event = event

    @property
    def triggered(self) -> bool:
        return self._event.is_set()


_LIVE_MESHES: "weakref.WeakSet[Mesh]" = weakref.WeakSet()


@atexit.register
def _close_meshes() -> None:  # pragma: no cover - exit path
    for mesh in list(_LIVE_MESHES):
        mesh.close()


class Mesh:
    """The controller's handle on S spawned ranks (``make_mesh``).

    ``run(fn, *args, per_rank=None, **kwargs)`` calls ``fn(group, *args,
    *per_rank[r], **kwargs)`` on rank r and returns the results in rank
    order; ``fn`` must be importable by name (spawned workers unpickle it).
    A rank's exception (or death) raises ``RankError`` here with its
    traceback and closes the mesh: its peers may be blocked in a collective
    it will never join.  ``close()`` (also at exit) stops every rank."""

    def __init__(self, num_shards: int, device: str | None = None, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 threads: int | None = None, quiet: bool = False):
        import multiprocessing as mp

        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        ctx = mp.get_context("spawn")
        self.size = num_shards
        self.device = device
        self.timeout_s = timeout_s
        placement(0, num_shards, device)  # refuse a missing card here
        self._dir = tempfile.mkdtemp(prefix="cfk_mesh_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        if threads is None:
            threads = 1 if placement(0, 1, device)[0] == "cpu" else max(
                1, (os.cpu_count() or 2) // num_shards)
        self._evict = ctx.Event()
        self._jobs = 0
        self._conns, self._procs = [], []
        self._lock = threading.Lock()
        self.closed = False
        _LIVE_MESHES.add(self)
        for r in range(num_shards):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_rank_main, name=f"cfk-rank-{r}",
                            args=(r, num_shards, init, device, timeout_s,
                                  threads, child, self._evict, self._dir),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)
        self.placement = [tuple(x) for x in self._collect(timeout_s)]
        self.backend = self.placement[0][1]
        self.staged = self.placement[0][2]
        self.description = describe(num_shards, device)
        if not quiet:
            print(f"# mesh: {self.description}", file=sys.stderr, flush=True)

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _collect(self, timeout_s: float | None, guard=None) -> list:
        from multiprocessing.connection import wait

        out: list = [None] * self.size
        pending = dict(enumerate(self._conns))
        deadline = None if timeout_s is None else (
            datetime.datetime.now().timestamp() + timeout_s)
        while pending:
            if guard is not None and guard.triggered:
                self._evict.set()
            ready = wait(list(pending.values()), timeout=0.2)
            for r, c in list(pending.items()):
                if c not in ready:
                    if not self._procs[r].is_alive() and not c.poll():
                        self.close()
                        raise RankError(
                            f"rank {r} died (exit code "
                            f"{self._procs[r].exitcode}) without a result")
                    continue
                try:
                    kind, value = c.recv()
                except EOFError:
                    self.close()
                    raise RankError(f"rank {r} closed its pipe") from None
                if kind == "err":
                    self.close()
                    raise RankError(f"rank {r} failed:\n{value}")
                out[r] = _load(value) if kind == "ok" else value
                del pending[r]
            if deadline is not None and pending and \
                    datetime.datetime.now().timestamp() > deadline:
                self.close()
                raise RankError(f"ranks {sorted(pending)} gave no result "
                                f"within {timeout_s} s")
        return out

    def run(self, fn, *args, per_rank=None, guard=None, **kwargs) -> list:
        """Run ``fn`` on every rank (see the class doc); ``guard`` (a
        ``PreemptionGuard``) is polled while waiting and, once triggered,
        sets the flag every rank's ``group.evict`` reads."""
        with self._lock:
            if self.closed:
                raise RankError("this mesh is closed")
            self._evict.clear()
            self._jobs += 1
            for r, c in enumerate(self._conns):
                extra = tuple(per_rank[r]) if per_rank is not None else ()
                c.send(_dump((fn, args + extra, kwargs), os.path.join(
                    self._dir, f"job-{r}-{self._jobs}")))
            return self._collect(None, guard=guard)

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        for c in self._conns:
            try:
                c.send(None)
            except (OSError, BrokenPipeError):
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        for c in self._conns:
            c.close()
        shutil.rmtree(self._dir, ignore_errors=True)


def make_mesh(num_shards: int, device: str | None = None, **kw) -> Mesh:
    """S ranks on ``device`` ("cuda", the default, or "cpu") joined in one
    group (``Mesh``; see the module doc for placement and backend)."""
    return Mesh(num_shards, device, **kw)


def evict_guard(group: ShardGroup):
    """The preemption guard a ``Mesh`` rank polls (set through the
    controller's ``Mesh.run(..., guard=)``), or None outside one."""
    ev = getattr(group, "evict", None)
    return None if ev is None else _EvictFlag(ev)


# -- torchrun-style launches ------------------------------------------------


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_timeout_s: float | None = None,
    *,
    device: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> int:
    """Join a multi-process launch; returns the number of processes.

    The arguments default to torchrun's environment (``MASTER_ADDR:
    MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with no coordinator there
    either, this is the single-process no-op and returns 1.  A second call
    after a successful init returns the group's size; asking then for a
    different size raises.  ``init_timeout_s`` bounds the wait for peers: a
    watchdog thread prints which process waited for which peers at which
    coordinator and exits ``INIT_TIMEOUT_EXIT_CODE``
    (``cfk_tpu/parallel/mesh.py:65-155``); a rendezvous error that names a
    timeout raises ``TimeoutError`` with the same diagnosis."""
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if dist.is_initialized():
        world = dist.get_world_size()
        if num_processes is not None and world != num_processes:
            raise RuntimeError(
                f"the process group already has {world} processes; "
                f"initialize_distributed asked for {num_processes}")
        return world
    if coordinator_address is None:
        return 1
    if num_processes is None or process_id is None:
        raise ValueError("num_processes and process_id are required with a "
                         "coordinator address (or set WORLD_SIZE and RANK)")
    done = threading.Event()
    if init_timeout_s is not None:
        def watch():
            if done.wait(init_timeout_s):
                return
            print(_init_timeout_message(coordinator_address, num_processes,
                                        process_id, init_timeout_s),
                  file=sys.stderr, flush=True)
            os._exit(INIT_TIMEOUT_EXIT_CODE)

        threading.Thread(target=watch, name="cfk-init-timeout",
                         daemon=True).start()
    init_s = timeout_s if init_timeout_s is None else init_timeout_s + 15
    try:
        group = _join(process_id, num_processes,
                      f"tcp://{coordinator_address}", device, timeout_s)
    except RuntimeError as e:
        if _looks_like_init_timeout(e):
            raise TimeoutError(_init_timeout_message(
                coordinator_address, num_processes, process_id,
                init_timeout_s if init_timeout_s is not None else init_s),
            ) from e
        raise
    finally:
        done.set()
    print(f"# mesh: {describe(group.size, device)} (this is rank "
          f"{group.rank})", file=sys.stderr, flush=True)
    return group.size


def shutdown_distributed(group: ShardGroup | None = None) -> None:
    """The end of a torchrun-style process's group: a barrier (every rank
    done with its collectives), then the process group destroyed, so no
    backend thread is left to the interpreter's exit (where one still
    running aborts the process).  A no-op without a group."""
    global _CURRENT
    if not dist.is_initialized():
        return
    if (group or _CURRENT) is not None:
        (group or _CURRENT).barrier()
    dist.destroy_process_group()
    _CURRENT = None


def make_multihost_mesh(num_shards: int | None = None,
                        device: str | None = None) -> ShardGroup:
    """This process's ``ShardGroup`` after ``initialize_distributed`` (a
    group of one without a launch); ``num_shards`` must equal the number of
    processes, each of which holds one entity shard."""
    if dist.is_initialized():
        group = _CURRENT
        size = group.size
    else:
        group, size = None, 1
    if num_shards is not None and num_shards != size:
        raise ValueError(
            f"num_shards={num_shards} must equal the process count {size} "
            "for a multihost mesh (every process hosts one entity shard); "
            "build the Dataset with this num_shards")
    if group is None:
        dev, _, _ = placement(0, 1, device)
        group = ShardGroup(0, 1, dev)
    return group


def ring_order(ranks):
    """Order rank placements so contiguous ranges share a host: sorted by
    (host, device index) — ``(process_index, id)`` in the JAX package — so
    neighbours on the ring and contiguous gather ranges stay on one host
    wherever possible.  Works on any objects with ``process_index`` and
    ``id``."""
    return sorted(ranks, key=lambda d: (d.process_index, d.id))


def _rows_of(group: ShardGroup, x):
    n = np.shape(x)[0]
    if n % group.size:
        raise ValueError(f"{n} rows do not divide into {group.size} shards")
    step = n // group.size
    return x[group.rank * step:(group.rank + 1) * step]


def shard_rows(group: ShardGroup, tree):
    """This rank's rows of every array of ``tree`` (axis 0 block-sharded:
    rank r owns rows [r·n/S, (r+1)·n/S)), as tensors on its device."""
    from cfk_tpu_torch.models.als import as_tensor

    return _tree_map(lambda x: as_tensor(np.ascontiguousarray(
        _rows_of(group, x)) if isinstance(x, np.ndarray) else
        _rows_of(group, x), group.device), tree)


def shard_rows_global(group: ShardGroup, tree):
    """``shard_rows`` from a tree every process holds whole (each process
    materializes only its own rows) — the same call here: a rank never
    addresses another's device."""
    return shard_rows(group, tree)


def to_host(group: ShardGroup, x: torch.Tensor) -> np.ndarray:
    """The whole row-sharded table on every rank, as float32 host numpy
    (bf16 rows are exact in float32)."""
    full = group.all_gather(x)
    return full.detach().float().cpu().numpy()


def replicated(group: ShardGroup, tree):
    """Every array of ``tree`` whole on this rank's device."""
    from cfk_tpu_torch.models.als import as_tensor

    return _tree_map(lambda x: as_tensor(x, group.device), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)
