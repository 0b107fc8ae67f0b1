"""The port's staging engine, the out-of-core fault injectors and the chaos
lab's out-of-core scenarios, on the CPU.

- ``WindowStager`` serves tasks in order in both modes (as
  ``cfk_tpu.offload.staging``), stages ahead on worker threads in pool
  mode, hands a worker's exception to the consumer and drains on close;
  ``resolve_staging`` / ``pool_workers_for`` equal the reference's.
- the six injectors (``HostWindowCorruption`` nan and torn,
  ``HotCacheCorruption``, ``SlowHostFetch``, ``StagingCrash``,
  ``StoreBitRot``) fire on the windowed trainer, and every recovery ends
  crc-equal to the clean windowed run (a staging crash surfaces as the
  run's error).
- the chaos lab's ``offload_window``, ``offload_window_sharded``,
  ``hot_cache``, ``offload_ials`` and ``staging_pool`` scenarios pass.
"""

import json
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from cfk_tpu.offload import staging as jstaging
from cfk_tpu_torch import ALSConfig, Dataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.offload import staging
from cfk_tpu_torch.offload.windowed import train_als_host_window
from cfk_tpu_torch.resilience.faults import (
    HostWindowCorruption,
    HotCacheCorruption,
    SlowHostFetch,
    StagingCrash,
    StoreBitRot,
    WindowFaultInjector,
)
from cfk_tpu_torch.scripts import chaos_lab
from cfk_tpu_torch.telemetry import Metrics
from cfk_tpu_torch.transport import CheckpointManager


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", [None, "auto", "pool", "serial"])
def test_resolve_staging_matches_reference(mode):
    assert staging.resolve_staging(mode) == jstaging.resolve_staging(mode)
    for depth in (1, 2, 4, 9):
        for workers in (None, 1, 3, 16):
            assert staging.pool_workers_for(depth, workers) == \
                jstaging.pool_workers_for(depth, workers)
    with pytest.raises(ValueError, match="staging must be one of"):
        staging.resolve_staging("fast")


@pytest.mark.parametrize("mode", ["pool", "serial"])
def test_stager_serves_tasks_in_order(mode):
    tasks = [(d, w) for d in range(3) for w in (2, 0, 1)]
    seen = []
    started = threading.Event()

    def stage(d, w):
        if (d, w) == (0, 2):
            # A straggler must not reorder consumption; in the pool it
            # waits until a later task has started beside it.
            time.sleep(0.02)
            if mode == "pool":
                assert started.wait(10)
        else:
            started.set()
        seen.append(threading.current_thread().name)
        return (d, w)

    stats = staging.StagingStats()
    with staging.WindowStager(tasks, stage, mode=mode, depth=3,
                              stats=stats) as st:
        got = [st.take() for _ in tasks]
        with pytest.raises(IndexError):
            st.take()
    assert got == tasks
    # The straggler's sleep is staging work, whichever thread ran it.
    assert stats["stage_busy_s"] >= 0.02 and stats["stage_stall_s"] >= 0.0
    if mode == "pool":
        assert all(n.startswith("cfk-stage") for n in seen)
        assert stats["pool_peak_inflight"] >= 2
        assert stats["pool_worker_stagings"] == len(tasks)
    else:
        assert "pool_worker_stagings" not in stats


@pytest.mark.parametrize("mode", ["pool", "serial"])
def test_stager_propagates_a_worker_error(mode):
    def stage(d, w):
        if w == 2:
            raise RuntimeError("boom")
        return w

    st = staging.WindowStager([(0, w) for w in range(5)], stage, mode=mode,
                              depth=2)
    assert st.take() == 0 and st.take() == 1
    with pytest.raises(RuntimeError, match="boom"):
        st.take()
    st.close()
    st.close()  # idempotent


def test_put_window_on_the_cpu_is_the_host_window():
    a, b = torch.arange(6.0), None
    staged = staging.put_window((a, b), torch.device("cpu"))
    assert staged.ready()[0] is a and staged.ready()[1] is None
    assert staged.nbytes == 24 and staged.copy_seconds() == 0.0


# -- the injectors on the windowed trainer ------------------------------------


@pytest.fixture(scope="module")
def ds():
    return Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0),
                            layout="tiled", chunk_elems=512, tile_rows=16,
                            accum_max_entities=0)


CFG = ALSConfig(rank=4, num_iterations=4, layout="tiled",
                health_check_every=1)


def _crc(model) -> int:
    u, m = model.host_factors()
    return zlib.crc32(u.tobytes() + m.tobytes())


@pytest.fixture(scope="module")
def clean(ds):
    return _crc(train_als_host_window(ds, CFG, device="cpu",
                                      chunks_per_window=2, hot_rows=20))


@pytest.mark.parametrize("name", ["nan", "torn", "hot", "slow", "bitrot"])
def test_injector_recovers_crc_equal(ds, clean, tmp_path, name):
    faults = {
        "nan": (HostWindowCorruption(iteration=1, side="m", window=0,
                                     kind="nan"), dict(verify_windows=False)),
        "torn": (HostWindowCorruption(iteration=2, side="u", window=0,
                                      kind="torn"), {}),
        "hot": (HotCacheCorruption(iteration=1, side="u"),
                dict(verify_windows=False)),
        "slow": (SlowHostFetch(delay_s=0.001, every=2), {}),
        "bitrot": (StoreBitRot(iteration=1, side="u", byte=9),
                   dict(checkpoint_manager=CheckpointManager(
                       str(tmp_path)))),
    }
    fault, kw = faults[name]
    inj = WindowFaultInjector(fault)
    m = Metrics()
    rec = train_als_host_window(ds, CFG, device="cpu", chunks_per_window=2,
                                hot_rows=20, window_faults=inj, metrics=m,
                                **kw)
    assert inj.fired >= 1
    assert _crc(rec) == clean
    if name in ("nan", "torn", "hot"):
        assert m.counters["health_trips"] >= 1
        assert m.counters["rollbacks"] >= 1
    if name == "bitrot":
        assert m.counters["store_integrity_detected"] == 1
        assert m.counters["store_repairs"] == 1


@pytest.mark.parametrize("staging_mode", ["pool", "serial"])
def test_staging_crash_surfaces(ds, staging_mode):
    crash = StagingCrash(iteration=1, side="u", window=0,
                         message="crash drill")
    with pytest.raises(RuntimeError, match="crash drill"):
        train_als_host_window(ds, CFG, device="cpu", chunks_per_window=2,
                              staging=staging_mode,
                              window_faults=WindowFaultInjector(crash))
    assert crash.fired == 1
    assert (crash.fired_in[0].startswith("cfk-stage")
            == (staging_mode == "pool"))


def test_degrade_after_exhausted_recoveries(ds):
    """A persistent NaN window exhausts the ladder: the run degrades to the
    last-good snapshot (``on_unrecoverable="degrade"``) or raises."""
    import dataclasses

    from cfk_tpu_torch.resilience.policy import TrainingDivergedError

    fault = HostWindowCorruption(iteration=2, side="m", window=0,
                                 kind="nan", persistent=True)
    cfg = dataclasses.replace(CFG, max_recoveries=2)
    m = Metrics()
    rec = train_als_host_window(ds, cfg, device="cpu", chunks_per_window=2,
                                window_faults=WindowFaultInjector(fault),
                                verify_windows=False, metrics=m)
    assert m.gauges["iterations_completed"] == 2
    assert "degraded" in m.notes
    assert np.isfinite(rec.host_factors()[0]).all()
    with pytest.raises(TrainingDivergedError):
        train_als_host_window(
            ds, dataclasses.replace(cfg, on_unrecoverable="raise"),
            device="cpu", chunks_per_window=2, verify_windows=False,
            window_faults=WindowFaultInjector(dataclasses.replace(
                fault, fired=0)))


# -- the chaos lab -----------------------------------------------------------


@pytest.mark.parametrize("scenario", ["offload_window",
                                      "offload_window_sharded", "hot_cache",
                                      "offload_ials", "staging_pool"])
def test_chaos_lab_offload_scenarios_on_cpu(scenario, capsys):
    """Each out-of-core scenario through ``run_scenario``: fired, detected,
    recovered crc-equal, and the flight recorder's dump names the fault."""
    assert chaos_lab.main(["--device", "cpu", "--scenario", scenario]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row = json.loads(lines[-2])
    assert row["scenario"] == scenario
    assert row["ok"] and row["crc_equal"] and row["flight_recorder"]["ok"]
