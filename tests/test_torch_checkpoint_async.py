"""The port's checkpoint store (``cfk_tpu_torch.transport.checkpoint``)
against ``cfk_tpu.transport.checkpoint``: the async writer, retention,
torn-step fallback and resume validation, on the CPU.

``save_async`` must commit the bytes ``save`` commits (and the reference's
``save``), take its snapshot at the call (the caller's arrays and tensors
may change at once), block at ``max_pending``, keep a writer error sticky,
drain at interpreter exit and under SIGTERM with a ``PreemptionGuard``
(subprocesses); ``keep_last_n`` keeps the newest N and the ``pin``ned
step; a torn or corrupt step is skipped on resume; and steps written by
either package restore in the other.  The CUDA snapshot (a pinned
``non_blocking`` copy) is held on the card by
``tests/test_torch_gpu.py::test_save_async_snapshot_isolated_from_in_place_updates``.
"""

import os
import signal
import subprocess
import sys
import time
import warnings

import numpy as np
import pytest
import torch

from cfk_tpu.transport import checkpoint as jck
from cfk_tpu_torch.resilience import faults as tf
from cfk_tpu_torch.transport import checkpoint as tck
from cfk_tpu_torch.transport.checkpoint import CheckpointManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _factors(seed, nu=40, nm=12, k=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nu, k)).astype(np.float32),
            rng.standard_normal((nm, k)).astype(np.float32))


def _payloads(directory, it):
    step = os.path.join(directory, f"step_{it:07d}")
    return {name: open(os.path.join(step, name), "rb").read()
            for name in ("user.npy", "movie.npy")}


@pytest.mark.parametrize("kind", ["numpy", "torch", "bf16"])
def test_save_async_bytes_equal_save_and_the_reference(tmp_path, kind):
    """One step through ``save_async`` (then drained), ``save`` and the
    reference's ``save``: the same payload bytes and manifest fields."""
    import json

    u, m = _factors(0)
    if kind == "numpy":
        args = (u, m)
    else:
        args = (torch.from_numpy(u), torch.from_numpy(m))
        if kind == "bf16":
            args = tuple(x.to(torch.bfloat16) for x in args)
    a, b, r = (str(tmp_path / x) for x in "abr")
    mgr = CheckpointManager(a)
    mgr.save_async(3, *args, meta={"rank": 6, "model": "als"})
    assert mgr.wait_pending() and mgr.pending_count == 0
    CheckpointManager(b).save(3, *args, meta={"rank": 6, "model": "als"})
    if kind == "bf16":
        import ml_dtypes

        ref_args = tuple(x.float().numpy().astype(ml_dtypes.bfloat16)
                         for x in args)
    else:
        ref_args = (u, m)
    jck.CheckpointManager(r).save(3, *ref_args,
                                  meta={"rank": 6, "model": "als"})
    assert _payloads(a, 3) == _payloads(b, 3) == _payloads(r, 3)
    man = [json.load(open(os.path.join(d, "step_0000003", "manifest.json")))
           for d in (a, b, r)]
    assert man[0] == man[1] == man[2]


def test_save_async_snapshots_at_the_call(tmp_path):
    """numpy arrays and CPU tensors changed right after ``save_async``:
    every committed step holds the values at its call."""
    mgr = CheckpointManager(str(tmp_path), max_pending=3)
    u, m = _factors(1)
    tu = torch.from_numpy(u.copy())
    want = []
    for it in range(1, 5):
        want.append((tu.numpy().copy(), m.copy()))
        mgr.save_async(it, tu, m)
        tu.mul_(2.0).add_(1.0)
        m += 3.0
    mgr.wait_pending()
    for it, (wu, wm) in enumerate(want, start=1):
        st = mgr.restore(it)
        np.testing.assert_array_equal(st.user_factors, wu)
        np.testing.assert_array_equal(st.movie_factors, wm)


def test_back_pressure_bounds_pending_saves(tmp_path):
    """A slow disk: ``save_async`` blocks while ``max_pending`` saves are
    queued or in flight, so pending never exceeds it, and every step lands
    intact."""
    mgr = tf.SlowDiskCheckpointManager(str(tmp_path), delay_s=0.05,
                                       max_pending=2)
    u, m = _factors(2)
    seen, t0 = [], time.perf_counter()
    for it in range(1, 7):
        mgr.save_async(it, u, m)
        seen.append(mgr.pending_count)
    enqueue_s = time.perf_counter() - t0
    mgr.wait_pending()
    assert max(seen) <= 2 and mgr.max_pending_seen <= 2
    assert enqueue_s >= 0.05 * 3  # the producer waited on the disk
    assert mgr.iterations() == list(range(1, 7))
    for it in mgr.iterations():
        mgr.verify(it)
    with pytest.raises(ValueError, match="max_pending must be >= 1"):
        CheckpointManager(str(tmp_path), max_pending=0)
    with pytest.raises(ValueError, match="keep_last_n must be >= 1"):
        CheckpointManager(str(tmp_path), keep_last_n=0)


class _FailOnce(CheckpointManager):
    def __init__(self, directory, fail_at):
        super().__init__(directory)
        self.fail_at = fail_at

    def save(self, iteration, user_factors, movie_factors, meta=None):
        if iteration == self.fail_at:
            raise OSError(28, "No space left on device")
        return super().save(iteration, user_factors, movie_factors, meta)


def test_writer_error_is_sticky(tmp_path):
    """A failed background write re-raises at the next barrier (once), and
    the store keeps working after it; no half step is left behind."""
    mgr = _FailOnce(str(tmp_path), fail_at=2)
    u, m = _factors(3)
    mgr.save_async(1, u, m)
    mgr.save_async(2, u, m)
    with pytest.raises(OSError, match="No space left"):
        mgr.wait_pending()
    assert mgr.wait_pending()  # raised once, then cleared
    mgr.save_async(3, u, m)
    mgr.wait_pending()
    assert mgr.iterations() == [1, 3]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]
    mgr = _FailOnce(str(tmp_path / "b"), fail_at=1)
    mgr.save_async(1, u, m)
    while mgr.pending_count:
        time.sleep(0.01)
    with pytest.raises(OSError):
        mgr.save_async(2, u, m)  # the next enqueue re-raises it


def test_atexit_drains_pending_saves(tmp_path):
    """A process that enqueues slow saves and returns at once: the exit
    hook commits them all."""
    code = (
        "import numpy as np\n"
        "from cfk_tpu_torch.resilience.faults import "
        "SlowDiskCheckpointManager\n"
        f"mgr = SlowDiskCheckpointManager({str(tmp_path)!r}, delay_s=0.2,"
        " max_pending=8)\n"
        "for it in range(1, 5):\n"
        "    mgr.save_async(it, np.full((5, 3), it, np.float32),"
        " np.zeros((2, 3), np.float32))\n"
        "print('pending', mgr.pending_count)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 2  # still pending at return
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.iterations() == [1, 2, 3, 4]
    for it in mgr.iterations():
        mgr.verify(it)
        assert mgr.restore(it).user_factors[0, 0] == it


def test_sigterm_during_pending_save_commits_and_resumes(tmp_path):
    """SIGTERM from outside while the async writer has saves pending on a
    slow disk: the guard-armed loop commits a final step, drains the
    writer and exits 0 resumable; every step verifies, and resuming ends
    bit-equal to an uninterrupted run."""
    code = (
        "import sys, torch, numpy as np\n"
        "torch.set_num_threads(1)\n"
        "from cfk_tpu_torch import ALSConfig, Dataset, train_als\n"
        "from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo\n"
        "from cfk_tpu_torch.resilience.faults import "
        "SlowDiskCheckpointManager\n"
        "from cfk_tpu_torch.resilience.preempt import PreemptionGuard\n"
        "from cfk_tpu_torch.telemetry import Metrics\n"
        "ds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))\n"
        f"mgr = SlowDiskCheckpointManager({str(tmp_path)!r}, delay_s=0.4)\n"
        "m = Metrics()\n"
        "class Ready:\n"
        "    def before_step(self, i, u, m):\n"
        "        if i == 1:\n"
        "            print('ready', flush=True)\n"
        "        return u, m\n"
        "with PreemptionGuard() as g:\n"
        "    train_als(ds, ALSConfig(rank=4, num_iterations=200), "
        "device='cpu', checkpoint_manager=mgr, metrics=m, "
        "fault_injector=Ready(), preemption_guard=g)\n"
        "print(g.signal_name, m.gauges.get('trained_iterations'), "
        "mgr.pending_count, flush=True)\n"
    )
    p = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
    assert p.stdout.readline().strip() == "ready"
    time.sleep(0.3)
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    name, trained, pending = out.split()
    assert name == "SIGTERM" and pending == "0" and int(trained) < 200
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_valid_iteration() == int(trained)
    for it in mgr.iterations():
        mgr.verify(it)
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    ds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))
    cfg = ALSConfig(rank=4, num_iterations=int(trained) + 2)
    resumed = train_als(ds, cfg, device="cpu",
                        checkpoint_manager=CheckpointManager(str(tmp_path)))
    whole = train_als(ds, cfg, device="cpu")
    assert torch.equal(resumed.user_factors, whole.user_factors)
    assert torch.equal(resumed.movie_factors, whole.movie_factors)


def test_keep_last_n_keeps_the_pinned_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last_n=2)
    u, m = _factors(4)
    mgr.pin(3)
    for it in range(1, 7):
        mgr.save_async(it, u, m)
    mgr.wait_pending()
    assert mgr.iterations() == [3, 5, 6]
    mgr.pin(None)
    mgr.save(7, u, m)
    assert mgr.iterations() == [6, 7]


@pytest.mark.parametrize("mode", ["truncate", "scramble", "manifest"])
def test_torn_step_is_skipped_on_resume(tmp_path, mode):
    """A torn newest step (payload truncated, bytes scrambled, manifest
    cut): ``resume_state`` falls back to the previous step with the
    reference's warning, as the reference's does on the same directory."""
    u, m = _factors(5)
    torn = tf.TornCheckpointManager(CheckpointManager(str(tmp_path)),
                                    tear_at=3, mode=mode)
    for it in (1, 2, 3):
        torn.save_async(it, u + it, m, meta={"rank": 6, "model": "als"})
    assert len(torn.torn) == 1
    kw = dict(rank=6, model="als", num_iterations=5)
    with pytest.warns(UserWarning, match="skipping corrupt checkpoint"):
        got = tck.resume_state(CheckpointManager(str(tmp_path)), **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jck.resume_state(jck.CheckpointManager(str(tmp_path)), **kw)
    assert got.iteration == want.iteration == 2
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    with pytest.raises(tck.CheckpointCorruptError):
        CheckpointManager(str(tmp_path)).restore(3)


def test_async_steps_restore_across_packages(tmp_path):
    """The port's async steps restore in the reference, and the
    reference's async steps in the port, bit for bit."""
    u, m = _factors(6)
    a, b = str(tmp_path / "port"), str(tmp_path / "ref")
    mgr = CheckpointManager(a)
    mgr.save_async(2, torch.from_numpy(u), m, meta={"model": "ials"})
    mgr.wait_pending()
    st = jck.CheckpointManager(a).restore()
    assert st.iteration == 2 and st.meta["model"] == "ials"
    np.testing.assert_array_equal(st.user_factors, u)
    ref = jck.CheckpointManager(b)
    ref.save_async(5, u, m, meta={"model": "als", "rank": 6})
    ref.wait_pending()
    st = CheckpointManager(b).restore()
    assert st.iteration == 5 and st.meta == {"model": "als", "rank": 6}
    np.testing.assert_array_equal(st.user_factors, u)
    np.testing.assert_array_equal(st.movie_factors, m)


@pytest.mark.parametrize("case", ["rank", "model", "shards", "past",
                                  "shape"])
def test_resume_validation_matches_reference(tmp_path, case):
    u, m = _factors(7)
    CheckpointManager(str(tmp_path)).save(
        4, u, m, meta={"rank": 6, "model": "als", "num_shards": 1})
    kw = dict(rank=6, model="als", num_iterations=8, u_shape=u.shape,
              m_shape=m.shape, num_shards=1)
    kw.update({"rank": dict(rank=5), "model": dict(model="ials"),
               "shards": dict(num_shards=2), "past": dict(num_iterations=3),
               "shape": dict(u_shape=(41, 6))}[case])
    with pytest.raises(ValueError) as want:
        jck.resume_state(jck.CheckpointManager(str(tmp_path)), **kw)
    with pytest.raises(ValueError) as got:
        tck.resume_state(CheckpointManager(str(tmp_path)), **kw)
    assert str(got.value) == str(want.value)


def test_should_save_and_checkpointed_loop(tmp_path):
    """``should_save`` equals the reference's; ``checkpointed_train_loop``
    saves on its cadence and resumes where it stopped."""
    for done, every, total in [(1, 1, 5), (2, 3, 5), (3, 3, 5), (5, 3, 5)]:
        assert tck.should_save(done, every, total) == \
            jck.should_save(done, every, total)
    from cfk_tpu_torch.telemetry import Metrics

    calls = []

    def step(u, m):
        calls.append(1)
        return u + 1, m - 1

    kw = dict(model="als", rank=3, u_shape=(4, 3), m_shape=(2, 3),
              dtype=torch.float32,
              init_fn=lambda: (torch.zeros(4, 3), torch.zeros(2, 3)),
              step_fn=step, checkpoint_every=2)
    mgr = CheckpointManager(str(tmp_path))
    u, m = tck.checkpointed_train_loop(mgr, num_iterations=3,
                                       metrics=Metrics(), **kw)
    assert mgr.iterations() == [2, 3] and float(u[0, 0]) == 3
    u, m = tck.checkpointed_train_loop(mgr, num_iterations=5,
                                       metrics=Metrics(), **kw)
    assert len(calls) == 5 and float(u[0, 0]) == 5
    assert mgr.iterations() == [2, 3, 4, 5]


def test_writer_thread_is_lazy_and_parks(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr._writer_thread is None  # started by the first save_async
    u, m = _factors(8)
    mgr.save_async(1, u, m)
    mgr.wait_pending()
    deadline = time.time() + 5
    while mgr._writer_thread is not None and time.time() < deadline:
        time.sleep(0.01)
    assert mgr._writer_thread is None  # parked once idle
    sync = CheckpointManager(str(tmp_path / "s"), async_write=False)
    sync.save_async(1, u, m)  # the synchronous A/B baseline
    assert sync.iterations() == [1] and sync._writer_thread is None
