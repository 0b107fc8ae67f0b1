"""Multi-process launches of the sharded trainer, torchrun style.

``spawn_workers`` starts ``nprocs`` copies of this module's worker, each a
rank of one process group (``initialize_distributed`` with the
coordinator ``127.0.0.1:PORT``), and ``communicate_all`` waits for them
with a bound and kills leftovers — the port's own copy of the launch
harness of ``tests/multihost_worker.py:69-106``, which the chaos lab's
``worker_kill`` and the tests share.  The worker::

    python -m cfk_tpu_torch.parallel.launch PID NPROCS PORT [CKDIR] --drill D

(on the card unless ``--device cpu``) runs one drill over a small
synthetic dataset (64 × 32 × 900 ratings, seed
0, padded layout, rank 4, 8 iterations, the sentinel every iteration):

- ``agree`` — every rank prints its view of the group (``DRILL_AGREE``:
  rank, size, backend and the all-gathered rank ids);
- ``kill`` — rank 1 SIGKILLs itself before ``--kill-iteration``; the
  survivor's next collective fails (or its ``StallWatchdog`` expires) and
  it exits ``STALL_EXIT_CODE`` with the checkpoint store intact;
- ``resume`` — train from CKDIR to the end; rank 0 prints
  ``DRILL_RESUME mse=... crc=...`` (a fresh CKDIR is the uninterrupted
  run);
- ``init-timeout`` — a lone rank of a declared group: the bounded init
  exits ``INIT_TIMEOUT_EXIT_CODE`` naming the missing peers.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import zlib

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def free_port() -> int:
    """A TCP port nothing listens on now (for a coordinator address)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_workers(port: int, nprocs: int = 2, ckdir: str | None = None,
                  *extra: str, pids=None) -> list:
    """Start the worker processes (one per rank in ``pids``, default all):
    the one launch harness of the tests and the chaos lab, so the
    environment, argv and pipes cannot diverge.  Each worker pins one
    PyTorch thread."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    procs = []
    for pid in (range(nprocs) if pids is None else pids):
        argv = [sys.executable, "-m", "cfk_tpu_torch.parallel.launch",
                str(pid), str(nprocs), str(port)]
        if ckdir is not None:
            argv.append(ckdir)
        procs.append(subprocess.Popen(
            argv + list(extra), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=_ROOT))
    return procs


def communicate_all(procs, timeout: float = 240.0) -> list[str]:
    """Every worker's combined output, waiting at most ``timeout`` seconds
    each; leftovers are killed so a wedged drill fails instead of hanging."""
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode())
    finally:
        for p in procs:
            p.kill()
    return outs


def _crc(model) -> str:
    u, m = model.host_factors()
    crc = zlib.crc32(u.tobytes())
    return f"{zlib.crc32(m.tobytes(), crc):08x}"


def _drill_dataset(n: int):
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    return Dataset.from_coo(synthetic_netflix_coo(64, 32, 900, seed=0),
                            num_shards=n)


def _config(n: int):
    from cfk_tpu_torch.config import ALSConfig

    return ALSConfig(rank=4, lam=0.05, num_iterations=8, seed=0,
                     num_shards=n, health_check_every=1)


def drill_kill(group, ckdir: str, kill_iteration: int,
               stall_timeout: float, resume: bool) -> None:
    import warnings

    from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
    from cfk_tpu_torch.parallel.spmd import train_als_sharded
    from cfk_tpu_torch.resilience.faults import FaultInjector, PreemptAt
    from cfk_tpu_torch.resilience.preempt import (
        STALL_EXIT_CODE,
        StallWatchdog,
    )
    from cfk_tpu_torch.telemetry.metrics import Metrics
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    ds = _drill_dataset(group.size)
    cfg = _config(group.size)
    manager = CheckpointManager(ckdir)
    if resume:
        metrics = Metrics()
        model = train_als_sharded(ds, cfg, group, checkpoint_manager=manager,
                                  metrics=metrics)
        mse, rmse = mse_rmse_from_model(model, ds)
        if group.rank == 0:
            print(f"DRILL_RESUME mse={mse:.6f} rmse={rmse:.6f} "
                  f"crc={_crc(model)} "
                  f"trained={int(metrics.counters.get('iterations', 0))}",
                  flush=True)
        return

    class ReportingWatchdog(StallWatchdog):
        def tick(self, done=None):
            super().tick(done)
            print(f"DRILL_ITER pid={group.rank} done={done}", flush=True)

    wd = ReportingWatchdog(stall_timeout, manager=manager)
    inj = FaultInjector(PreemptAt(iteration=kill_iteration,
                                  signum=signal.SIGKILL, only_process=1))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            train_als_sharded(ds, cfg, group, checkpoint_manager=manager,
                              fault_injector=inj, watchdog=wd)
    except Exception as e:
        wd.disarm()
        try:
            manager.wait_pending(timeout=30.0)
        except Exception:
            pass
        print(f"DRILL_COLLECTIVE_ERROR pid={group.rank} "
              f"error={type(e).__name__}", flush=True)
        sys.stdout.flush()
        # os._exit: the peer is dead, so a process-group teardown at exit
        # would wait on it; the writer is drained above.
        os._exit(STALL_EXIT_CODE)
    print(f"DRILL_KILL_COMPLETED pid={group.rank}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pid", type=int)
    p.add_argument("nprocs", type=int)
    p.add_argument("port", type=int)
    p.add_argument("ckdir", nargs="?", default=None)
    p.add_argument("--drill", default="agree",
                   choices=["agree", "kill", "resume", "init-timeout"])
    p.add_argument("--kill-iteration", type=int, default=4)
    p.add_argument("--stall-timeout", type=float, default=60.0)
    p.add_argument("--group-timeout", type=float, default=30.0,
                   help="the process group's bound on one collective: "
                   "under the stall timeout, so a dead peer surfaces as a "
                   "collective error first (gloo reports a closed peer at "
                   "once; the bound covers a peer that hangs), and long "
                   "enough for a slow live peer on a loaded host")
    p.add_argument("--init-timeout", type=float, default=60.0)
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="the ranks' device (ranks sharing a card stage "
                   "their exchanges through host memory; cpu: gloo on the "
                   "CPU)")
    args = p.parse_args(argv)
    import torch

    from cfk_tpu_torch.parallel.mesh import (
        initialize_distributed,
        make_multihost_mesh,
        shutdown_distributed,
    )

    torch.set_num_threads(1)
    got = initialize_distributed(
        f"127.0.0.1:{args.port}", num_processes=args.nprocs,
        process_id=args.pid, init_timeout_s=args.init_timeout,
        device=args.device, timeout_s=args.group_timeout)
    assert got == args.nprocs, (got, args.nprocs)
    group = make_multihost_mesh(args.nprocs, device=args.device)
    if args.drill in ("agree", "init-timeout"):
        ids = group.all_gather(torch.tensor([group.rank],
                                            device=group.device))
        print(f"DRILL_AGREE rank={group.rank} size={group.size} "
              f"backend={group.backend} ids={ids.tolist()}", flush=True)
    else:
        drill_kill(group, args.ckdir, args.kill_iteration,
                   args.stall_timeout, resume=args.drill == "resume")
    shutdown_distributed(group)
    return 0


if __name__ == "__main__":
    sys.exit(main())
