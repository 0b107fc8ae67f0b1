"""The port's resilience slice (``cfk_tpu_torch.resilience``) against
``cfk_tpu.resilience``, on the CPU.

The same inputs, made from a seed with numpy, go through both packages:

- the probe word and its reasons, bit for bit, on healthy, NaN, Inf and
  over-norm factors; the escalation ladder's ``Overrides`` sequence and
  the backoff schedule, exactly;
- whole recoveries — NaN and Inf rows (transient), a singular chunk under
  λ = 0, a persistent NaN that degrades and one that raises, and iALS with
  NaN rows — from the same u0 and the same fault plan: the recovered
  factors within 1e-4 of the largest |factor| of the reference's (float32
  sums in another order through the chained solves; the trainer tolerance
  of ``test_torch_als.py`` is 1e-3 of the predictions), the same
  ``Metrics.notes`` (keys and texts, the reference's planner note aside)
  and the same counters; and, for the transient faults, bit-equal to the
  port's own fault-free run;
- the sentinel on against off, bit-equal; the natural λ = 0 trip of the
  uncaptured route replayed through the stepped loop, as the reference's
  fused-loop trip is; preemption and resume; the stall watchdog; the CLI
  flags; the chaos lab's seven single-process scenarios.

One PyTorch thread (small products); each reference run is shared through
module-scoped fixtures.
"""

import dataclasses
import os
import random
import signal
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo as j_coo
from cfk_tpu.models.als import _blocks_to_device as j_blocks_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import IALSConfig as JIALSConfig
from cfk_tpu.models.ials import train_ials as j_train_ials
from cfk_tpu.ops.solve import init_factors as j_init_factors
from cfk_tpu.resilience import faults as jf
from cfk_tpu.resilience import policy as jpolicy
from cfk_tpu.resilience import retry as jretry
from cfk_tpu.resilience import sentinel as jsentinel
from cfk_tpu.resilience.policy import TrainingDivergedError as JDiverged
from cfk_tpu.utils.metrics import Metrics as JMetrics
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.resilience import faults as tf
from cfk_tpu_torch.resilience import policy as tpolicy
from cfk_tpu_torch.resilience import retry as tretry
from cfk_tpu_torch.resilience import sentinel as tsentinel
from cfk_tpu_torch.resilience.policy import TrainingDivergedError
from cfk_tpu_torch.telemetry import Metrics
from cfk_tpu_torch.transport.checkpoint import CheckpointManager

K, ITERS = 4, 6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


# -- the sentinel, the ladder, the backoff --------------------------------------

def _factors(case):
    rng = np.random.default_rng(7)
    u = rng.standard_normal((37, 6)).astype(np.float32)
    m = rng.standard_normal((11, 6)).astype(np.float32)
    if "nan_u" in case:
        u[3, 2] = np.nan
    if "inf_m" in case:
        m[5, 0] = np.inf
    if "ninf_u" in case:
        u[0, 5] = -np.inf
    if "big_u" in case:
        u[9] *= 1e4
    if "big_m" in case:
        m[2, 1] = 3e3
    return u, m


@pytest.mark.parametrize("limit", [1e6, 50.0])
@pytest.mark.parametrize("case", [
    "healthy", "nan_u", "inf_m", "ninf_u", "big_u", "big_m",
    "nan_u+inf_m", "nan_u+big_m", "inf_m+big_u"])
def test_probe_word_matches_reference(case, limit):
    """The int32 word, its reasons and the row-norm stats, against the
    reference's on the same factors (a NaN row trips only its non-finite
    bit, an Inf row its non-finite and its norm bits)."""
    u, m = _factors(case)
    want = int(jsentinel.probe_word(jnp.asarray(u), jnp.asarray(m), limit))
    got = tsentinel.probe_word(torch.as_tensor(u), torch.as_tensor(m), limit)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    assert tsentinel.describe_word(want) == jsentinel.describe_word(want)
    assert (case == "healthy") == (want == 0) or case.startswith("big")
    if want:
        jr = jsentinel.report_from_carry(np.array([2, want], np.int32),
                                         jnp.asarray(u), jnp.asarray(m))
        tr = tsentinel.report_from_carry(torch.tensor([2, want]),
                                         torch.as_tensor(u),
                                         torch.as_tensor(m))
        assert tr.summary() == jr.summary()
        for key, v in jr.stats.items():
            np.testing.assert_allclose(tr.stats[key], v, rtol=1e-6)


def test_fold_probe_keeps_the_first_bad_iteration():
    """The captured word: clean iterations and off-cadence ones leave it,
    the first tripped iteration is kept — ``fold_probe``'s contract."""
    u, m = _factors("healthy")
    bad, _ = _factors("nan_u")
    hw = tsentinel.carry_init("cpu")
    yes, no = torch.tensor(True), torch.tensor(False)
    for i, (x, due) in enumerate([(u, yes), (bad, no), (bad, yes),
                                  (u, yes), (bad, yes)]):
        tsentinel.fold_probe(hw, torch.tensor(i, dtype=torch.int32),
                             torch.as_tensor(x), torch.as_tensor(m), due=due,
                             norm_limit=1e6)
    assert hw.tolist() == [2, tsentinel.NONFINITE_U]


def test_probed_step_always_probes_the_final_iteration():
    """The captured word's cadence (``loop.make_probed_step``): every
    ``every`` completed iterations and always at the last, so the returned
    state never dodges the sentinel — a NaN only in iteration 5's output
    (of 5, cadence 4) is caught there; one in iteration 3's, off the
    cadence and healed after, is not (the reference's
    ``test_fold_probe_always_probes_final_iteration``)."""
    from cfk_tpu_torch.resilience.loop import make_probed_step, probed_state

    def run(bad_at):
        def step(state, out):
            u, m = state
            calls.append(1)
            m = torch.full_like(m, float("nan") if len(calls) == bad_at
                                else 1.0)
            return u + 1, m

        calls = []
        probed = make_probed_step(step, tsentinel.HealthConfig(every=4), 5)
        state = probed_state(torch.ones(3, 2), torch.ones(2, 2))
        for _ in range(5):
            state = probed(state, None)
        return state[2].tolist()

    assert run(5) == [4, tsentinel.NONFINITE_M]
    assert run(3) == [-1, 0]
    assert run(4) == [3, tsentinel.NONFINITE_M]


@pytest.mark.parametrize("every,iters", [(1, 4), (2, 5), (3, 7)])
def test_probe_cadence_matches_reference(explicit, every, iters):
    """With no checkpoint store the stepped loop probes on the health
    cadence plus the final iteration — the reference's count."""
    jd, td, u0, m0 = explicit
    kw = dict(rank=K, num_iterations=iters, health_check_every=every)
    jm, tm = JMetrics(), Metrics()
    _quiet(j_train_als, jd, JConfig(**kw), metrics=jm, warm_start=(u0, m0),
           fault_injector=jf.FaultInjector())
    _quiet(train_als, td, ALSConfig(**kw), device="cpu", metrics=tm,
           warm_start=(u0, m0), fault_injector=tf.FaultInjector())
    assert tm.counters["health_checks"] == jm.counters["health_checks"] == \
        len({*range(every, iters + 1, every), iters})


@pytest.mark.parametrize("lam,fused", [(0.05, None), (0.0, None),
                                       (0.05, False), (0.1, True)])
def test_escalation_ladder_matches_reference(lam, fused):
    """The ``Overrides`` each trip count climbs to, cumulatively, equal to
    ``RecoveryPolicy.escalate``'s (λ×factor, the 1e-4 floor from λ = 0,
    the split epilogue, the "gj" route)."""
    jp = jpolicy.RecoveryPolicy(lam_factor=4.0)
    tp = tpolicy.RecoveryPolicy(lam_factor=4.0)
    jo = jpolicy.Overrides(lam=lam, fused_epilogue=fused)
    to = tpolicy.Overrides(lam=lam, fused_epilogue=fused)
    for level in range(1, 8):
        jo, to = jp.escalate(jo, level), tp.escalate(to, level)
        assert dataclasses.asdict(to) == dataclasses.asdict(jo)
    cfg = ALSConfig(max_recoveries=2, lam_escalation=3.0,
                    on_unrecoverable="raise")
    assert dataclasses.asdict(tpolicy.policy_from_config(cfg)) == \
        dataclasses.asdict(jpolicy.policy_from_config(JConfig(
            max_recoveries=2, lam_escalation=3.0, on_unrecoverable="raise")))


@pytest.mark.parametrize("kw", [dict(max_recoveries=-1),
                                dict(lam_factor=1.0),
                                dict(on_unrecoverable="crash")])
def test_policy_validation_matches_reference(kw):
    with pytest.raises(ValueError) as want:
        jpolicy.RecoveryPolicy(**kw)
    with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(")
                       .replace(")", r"\)")):
        tpolicy.RecoveryPolicy(**kw)


@pytest.mark.parametrize("kw", [dict(health_check_every=0),
                                dict(health_norm_limit=0.0),
                                dict(max_recoveries=-1),
                                dict(lam_escalation=1.0),
                                dict(on_unrecoverable="crash")])
def test_config_validation_messages_match_reference(kw):
    with pytest.raises(ValueError) as want:
        JConfig(**kw)
    with pytest.raises(ValueError) as got:
        ALSConfig(**kw)
    assert str(got.value) == str(want.value)


def test_backoff_and_retry_match_reference():
    """``backoff_delays`` from a seeded rng, and ``retry_call``'s sleeps
    and final error, equal to the reference's."""
    kw = dict(base=0.05, factor=2.0, max_delay=0.5, jitter=0.3)
    jd = jretry.backoff_delays(rng=random.Random(3), **kw)
    td = tretry.backoff_delays(rng=random.Random(3), **kw)
    assert [next(td) for _ in range(12)] == [next(jd) for _ in range(12)]

    def run(mod):
        slept, calls = [], []

        def flaky():
            calls.append(1)
            raise ConnectionResetError(104, "reset")

        with pytest.raises(ConnectionResetError) as e:
            mod.retry_call(flaky, retries=3, rng=random.Random(5),
                           sleep=slept.append, describe="connect")
        return slept, len(calls), e.value.errno, str(e.value)

    assert run(tretry) == run(jretry)
    with pytest.raises(ValueError, match="base must be > 0"):
        next(tretry.backoff_delays(base=0))


# -- whole recoveries against the reference -------------------------------------

@pytest.fixture(scope="module")
def explicit():
    """The reference's chaos fixture (60 × 30 × 900 ratings, seed 0) in both
    packages, and one u0."""
    jd = JDataset.from_coo(j_coo(60, 30, 900, seed=0))
    td = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))
    u0 = np.random.default_rng(0).random(
        (td.user_blocks.padded_entities, K)).astype(np.float32)
    m0 = np.zeros((td.movie_blocks.padded_entities, K), np.float32)
    return jd, td, u0, m0


@pytest.fixture(scope="module")
def singular():
    jd = JDataset.from_coo(jf.blockstructured_coo(seed=0))
    td = Dataset.from_coo(tf.blockstructured_coo(seed=0))
    u0 = np.random.default_rng(1).random(
        (td.user_blocks.padded_entities, K)).astype(np.float32)
    m0 = np.zeros((td.movie_blocks.padded_entities, K), np.float32)
    return jd, td, u0, m0


def _plan(mod, name):
    """The fault plan and config overrides of one scenario, built from one
    package's faults module."""
    return {
        "nan": ([mod.FactorCorruption(iteration=2, side="u")], {}),
        "inf": ([mod.FactorCorruption(iteration=3, side="u",
                                      value=float("inf"))], {}),
        "nan_movies": ([mod.FactorCorruption(iteration=1, side="m",
                                             num_rows=3, seed=5)], {}),
        "singular": ([mod.SingularChunk(iteration=2, side="u", rows=(0, 8),
                                        persistent=True)], dict(lam=0.0)),
        "degrade": ([mod.FactorCorruption(iteration=2, persistent=True)],
                    dict(max_recoveries=2)),
        "raise": ([mod.FactorCorruption(iteration=2, persistent=True)],
                  dict(max_recoveries=2, on_unrecoverable="raise")),
    }[name]


SCENARIOS = ("nan", "inf", "nan_movies", "singular", "degrade", "raise")


def _run_both(data, name):
    jd, td, u0, m0 = data
    jfaults, over = _plan(jf, name)
    tfaults, _ = _plan(tf, name)
    base = dict(rank=K, num_iterations=ITERS, health_check_every=1, **over)
    out = {}
    for who, train, ds, cfg, faults, metrics, err in (
            ("ref", j_train_als, jd, JConfig(**base), jfaults, JMetrics(),
             JDiverged),
            ("port", train_als, td, ALSConfig(**base), tfaults, Metrics(),
             TrainingDivergedError)):
        inj = (jf if who == "ref" else tf).FaultInjector(*faults)
        kw = dict(metrics=metrics, fault_injector=inj, warm_start=(u0, m0))
        if who == "port":
            kw["device"] = "cpu"
        try:
            model = _quiet(train, ds, cfg, **kw)
            u, m = (np.asarray(x, np.float32) for x in model.host_factors())
            out[who] = dict(u=u, m=m, metrics=metrics, fired=inj.fired)
        except err as e:
            out[who] = dict(error=str(e), metrics=metrics, fired=inj.fired,
                            reasons=[r.reasons for r in e.reports])
    return out


@pytest.fixture(scope="module")
def recoveries(explicit, singular):
    return {name: _run_both(singular if name == "singular" else explicit,
                            name) for name in SCENARIOS}


def _notes(metrics) -> dict:
    return {k: v for k, v in metrics.notes.items() if k != "plan"}


@pytest.mark.parametrize("name", SCENARIOS)
def test_recovery_matches_reference(recoveries, name):
    """The same fault plan from the same u0 in both packages: the same
    trips, rollbacks, rungs and notes, and recovered factors within 1e-4
    of the largest |factor| (or the same ``TrainingDivergedError``)."""
    ref, port = recoveries[name]["ref"], recoveries[name]["port"]
    assert port["fired"] == ref["fired"] >= 1
    assert _notes(port["metrics"]) == _notes(ref["metrics"])
    for key in ("health_trips", "rollbacks", "iterations", "health_checks"):
        assert port["metrics"].counters.get(key) == \
            ref["metrics"].counters.get(key), key
    for key in ("escalation_level", "degraded", "trained_iterations"):
        assert port["metrics"].gauges.get(key) == \
            ref["metrics"].gauges.get(key), key
    if name == "raise":
        assert port["error"] == ref["error"]
        assert port["reasons"] == ref["reasons"]
        return
    assert np.isfinite(port["u"]).all() and np.isfinite(port["m"]).all()
    assert _rel(port["u"], ref["u"]) <= 1e-4
    assert _rel(port["m"], ref["m"]) <= 1e-4


@pytest.fixture(scope="module")
def fault_free(explicit):
    _, td, u0, m0 = explicit
    return train_als(td, ALSConfig(rank=K, num_iterations=ITERS), device="cpu",
                     warm_start=(u0, m0))


@pytest.mark.parametrize("name", ["nan", "inf", "nan_movies"])
def test_transient_fault_ends_bit_equal(recoveries, fault_free, name):
    """A one-shot fault rolled back and replayed at rung 1 (no knob moved)
    ends bit-equal to the port's fault-free run (one the math overwrites
    before reading it ends there with no rollback)."""
    port = recoveries[name]["port"]
    # NaN movie rows before an iteration are overwritten by its first half
    # before anything reads them: nothing trips.
    assert port["metrics"].counters.get("rollbacks", 0) == (
        0 if name == "nan_movies" else 1)
    u, m = fault_free.host_factors()
    np.testing.assert_array_equal(port["u"], u)
    np.testing.assert_array_equal(port["m"], m)


def test_ials_nan_recovery_matches_reference():
    """iALS with NaN rows before iteration 2: the reference's stepped loop
    from its own (threefry) init, the port from that init; the same notes
    and counters, factors within 1e-4, and the port bit-equal to its
    fault-free run."""
    coo = j_coo(80, 40, 1500, seed=3)
    jd = JDataset.from_coo(coo)
    td = Dataset.from_coo(synthetic_netflix_coo(80, 40, 1500, seed=3))
    kw = dict(rank=K, num_iterations=4, lam=0.1, alpha=2.0,
              health_check_every=1)
    jcfg, tcfg = JIALSConfig(**kw), IALSConfig(**kw)
    blk = j_blocks_to_device(jd.user_blocks)
    u0 = np.asarray(j_init_factors(jax.random.PRNGKey(jcfg.seed),
                                   blk["rating"], blk["mask"], blk["count"],
                                   K))
    m0 = np.zeros((td.movie_blocks.padded_entities, K), np.float32)
    jm, tm = JMetrics(), Metrics()
    want = _quiet(j_train_ials, jd, jcfg, metrics=jm,
                  fault_injector=jf.FaultInjector(jf.FactorCorruption(2)))
    got = _quiet(train_ials, td, tcfg, device="cpu", warm_start=(u0, m0),
                 metrics=tm,
                 fault_injector=tf.FaultInjector(tf.FactorCorruption(2)))
    free = train_ials(td, dataclasses.replace(tcfg, health_check_every=None),
                      device="cpu", warm_start=(u0, m0))
    assert _notes(tm) == _notes(jm) and tm.notes
    assert dict(tm.counters) == {k: v for k, v in jm.counters.items()}
    gu, gm = got.host_factors()
    wu, wm = want.host_factors()
    assert _rel(gu, wu) <= 1e-4 and _rel(gm, wm) <= 1e-4
    fu, fm = free.host_factors()
    np.testing.assert_array_equal(gu, fu)
    np.testing.assert_array_equal(gm, fm)


def test_uncaptured_trip_replays_like_the_fused_loop():
    """A trip with no injector: the max-row-norm watchdog at 3.0 trips at
    λ = 0.05 until the ladder's λ bumps (×10 a rung) hold every row below
    it (a well-conditioned end, unlike λ = 0's 1e-4 floor).  The route that folds the probe into a device word
    trips, discards the run and replays it through the stepped loop from
    u0 — the reference's fused-loop trip: notes (``fused_loop_trip``
    included) and counters equal, factors within 1e-4 — and bit-equal to
    the port's stepped run of the same plan."""
    jd = JDataset.from_coo(j_coo(60, 30, 900, seed=0))
    td = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0))
    kw = dict(rank=5, num_iterations=4, lam=0.05, health_check_every=1,
              health_norm_limit=3.0)
    jcfg, tcfg = JConfig(**kw), ALSConfig(**kw)
    blk = j_blocks_to_device(jd.user_blocks)
    u0 = np.asarray(j_init_factors(jax.random.PRNGKey(jcfg.seed),
                                   blk["rating"], blk["mask"], blk["count"],
                                   5))
    m0 = np.zeros((td.movie_blocks.padded_entities, 5), np.float32)
    jm, tm, sm = JMetrics(), Metrics(), Metrics()
    with pytest.warns(UserWarning, match="fused training loop"):
        want = j_train_als(jd, jcfg, metrics=jm)
    with pytest.warns(UserWarning, match="prefetched training loop"):
        got = train_als(td, tcfg, device="cpu", warm_start=(u0, m0),
                        metrics=tm)
    stepped = _quiet(train_als, td, tcfg, device="cpu", warm_start=(u0, m0),
                     metrics=sm, fault_injector=tf.FaultInjector())
    assert tm.gauges["escalation_level"] == jm.gauges["escalation_level"] >= 2
    assert tm.notes["fused_loop_trip"] == jm.notes["fused_loop_trip"]
    assert _notes(tm) == _notes(jm)
    assert dict(tm.counters) == dict(jm.counters)
    assert got.pipeline["route"] == "stepped"
    assert "health trip" in got.pipeline["reason"]
    gu, gm = got.host_factors()
    wu, wm = want.host_factors()
    assert _rel(gu, wu) <= 1e-4 and _rel(gm, wm) <= 1e-4
    su, smf = stepped.host_factors()
    np.testing.assert_array_equal(gu, su)
    np.testing.assert_array_equal(gm, smf)
    assert "fused_loop_trip" not in sm.notes


@pytest.mark.parametrize("layout", ["padded", "tiled", "bucketed", "segment"])
def test_health_on_matches_health_off_bitexact(explicit, layout, tmp_path):
    """The sentinel observes only: health off, health every 2 iterations
    (the device word) and the stepped loop with a checkpoint store, every
    iteration probed, give the same bits on every layout."""
    _, td, u0, m0 = explicit
    ds = td if layout == "padded" else Dataset.from_coo(
        synthetic_netflix_coo(60, 30, 900, seed=0), layout=layout,
        chunk_elems=256, dense_stream=layout == "tiled")
    cfg = ALSConfig(rank=K, num_iterations=4, layout=layout)
    runs = [train_als(ds, cfg, device="cpu"),
            train_als(ds, dataclasses.replace(cfg, health_check_every=2),
                      device="cpu"),
            train_als(ds, dataclasses.replace(cfg, health_check_every=1),
                      device="cpu",
                      checkpoint_manager=CheckpointManager(str(tmp_path)))]
    assert runs[1].pipeline["health"] == "healthy"
    assert runs[2].pipeline["route"] == "stepped"
    for other in runs[1:]:
        assert torch.equal(other.user_factors, runs[0].user_factors)
        assert torch.equal(other.movie_factors, runs[0].movie_factors)


def test_norm_watchdog_raises_with_reports(explicit):
    _, td, _, _ = explicit
    cfg = ALSConfig(rank=3, num_iterations=3, health_check_every=1,
                    health_norm_limit=1e-3, max_recoveries=0,
                    on_unrecoverable="raise")
    with pytest.raises(TrainingDivergedError) as e:
        _quiet(train_als, td, cfg, device="cpu",
               fault_injector=tf.FaultInjector())
    assert "user_norm_watchdog" in e.value.reports[0].reasons


def test_validate_cadence_matches_reference():
    from cfk_tpu.resilience.loop import validate_cadence as jv

    from cfk_tpu_torch.resilience.loop import validate_cadence as tv

    for args in ((0,), (1, tsentinel.HealthConfig(every=0))):
        with pytest.raises(ValueError) as want:
            jv(*args[:1], *(jsentinel.HealthConfig(every=0),)
               if len(args) > 1 else ())
        with pytest.raises(ValueError) as got:
            tv(*args)
        assert str(got.value) == str(want.value)


# -- preemption, the watchdog ---------------------------------------------------

def test_preemption_commits_and_resumes_bit_equal(explicit, fault_free,
                                                  tmp_path):
    """SIGTERM before iteration 3 under a ``PreemptionGuard``: step 4 is
    committed (crc-verified), the loop returns resumable with the
    reference's note, and the restart ends bit-equal to the uninterrupted
    run."""
    from cfk_tpu_torch.resilience.preempt import PreemptionGuard

    _, td, u0, m0 = explicit
    cfg = ALSConfig(rank=K, num_iterations=ITERS, health_check_every=1)
    metrics = Metrics()
    inj = tf.FaultInjector(tf.PreemptAt(iteration=3))
    with PreemptionGuard() as guard:
        _quiet(train_als, td, cfg, device="cpu", warm_start=(u0, m0),
               checkpoint_manager=CheckpointManager(str(tmp_path)),
               metrics=metrics, fault_injector=inj, preemption_guard=guard)
    assert guard.triggered and guard.signal_name == "SIGTERM"
    assert metrics.notes["preempted"].startswith("SIGTERM at iteration 4/6")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_valid_iteration() == 4
    for it in mgr.iterations():
        mgr.verify(it)
    again = train_als(td, cfg, device="cpu", warm_start=(u0, m0),
                      checkpoint_manager=CheckpointManager(str(tmp_path)))
    assert again.pipeline["route"] == "stepped"
    assert torch.equal(again.user_factors, fault_free.user_factors)
    assert torch.equal(again.movie_factors, fault_free.movie_factors)


def test_guard_second_signal_chains_to_previous_handler():
    from cfk_tpu_torch.resilience.preempt import PreemptionGuard

    seen = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
            os.kill(os.getpid(), signal.SIGUSR1)
            assert guard.triggered and not seen
            os.kill(os.getpid(), signal.SIGUSR1)
            assert seen == [signal.SIGUSR1]
        assert signal.getsignal(signal.SIGUSR1) is not guard._handler
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_stall_watchdog_exits_17_with_the_store_intact(tmp_path):
    """A loop that stops ticking: the watchdog drains the writer and exits
    17 (in a subprocess), leaving every committed step verifiable."""
    code = (
        "import time, numpy as np\n"
        "from cfk_tpu_torch.resilience.preempt import StallWatchdog\n"
        "from cfk_tpu_torch.transport.checkpoint import CheckpointManager\n"
        f"mgr = CheckpointManager({str(tmp_path)!r})\n"
        "wd = StallWatchdog(0.5, manager=mgr, compile_grace_s=0.5)\n"
        "wd.arm()\n"
        "for i in range(1, 3):\n"
        "    mgr.save_async(i, np.ones((4, 2), np.float32) * i,\n"
        "                   np.zeros((3, 2), np.float32))\n"
        "    wd.tick(i)\n"
        "time.sleep(30)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 17, r.stderr
    assert "STALL_WATCHDOG" in r.stderr
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.iterations() == [1, 2]
    for it in mgr.iterations():
        mgr.verify(it)


# -- the segment layout's Gram, the CLI, the chaos lab --------------------------

def test_segment_gram_calls_k2_once_a_chunk(monkeypatch):
    """Every segment chunk's Gram is one ``gram_gather`` call (one-row
    tiles, the chunk's staged plan, the carry folded in), never an
    ``index_add_`` of outer products."""
    from cfk_tpu_torch.models.als import _segment_to_device
    from cfk_tpu_torch.ops import solve as t_solve
    from cfk_tpu_torch.ops.kernels import gram_kernel

    ds = Dataset.from_coo(synthetic_netflix_coo(60, 30, 900, seed=0),
                          layout="segment", chunk_elems=256)
    mb = ds.movie_blocks
    calls = []
    real = gram_kernel.gram_gather

    def spy(*a, **kw):
        calls.append((kw["tile_rows"], kw["units"] is not None,
                      kw["carry"] is not None))
        return real(*a, **kw)

    monkeypatch.setattr(gram_kernel, "gram_gather", spy)
    fixed = torch.rand((ds.user_blocks.padded_entities, K),
                       generator=torch.Generator().manual_seed(0))
    blk = _segment_to_device(mb, "cpu")
    t_solve.als_half_step_segment(fixed, blk, mb.statics,
                                  mb.padded_entities, 0.05)
    t_solve.ials_half_step_segment(fixed, blk, mb.statics,
                                   mb.padded_entities, 0.1, 2.0)
    assert mb.num_chunks > 2
    assert calls == [(1, True, True)] * (2 * mb.num_chunks)


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    coo = synthetic_netflix_coo(60, 30, 900, seed=0)
    path = tmp_path_factory.mktemp("cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-01-01\n")
    return str(path)


def test_cli_checkpoints_on_cadence_with_retention(ratings_file, tmp_path,
                                                   capsys):
    from cfk_tpu_torch.cli import main

    ck = tmp_path / "ck"
    argv = ["train", "--data", ratings_file, "--rank", "4", "--iterations",
            "5", "--device", "cpu", "--output", "none", "--checkpoint-dir",
            str(ck), "--checkpoint-every", "2", "--keep-last-n", "1",
            "--health-check-every", "1"]
    assert main(argv) == 0
    out = capsys.readouterr()
    mgr = CheckpointManager(str(ck))
    # Saves at 2, 4 and 5 (the end); the newest is kept, and the pinned
    # last-good step is the newest too.
    assert mgr.iterations() == [5]
    assert "# pipeline: stepped" in out.err
    assert main(argv) == 0  # resumes at the end: nothing left to train
    assert mgr.iterations() == [5]


class _CommitsAtOnce(CheckpointManager):
    """An async store whose writer commits each step, retention included,
    before ``save_async`` returns: the interleaving a loaded machine can
    give the writer thread."""

    def save_async(self, *a, **kw):
        super().save_async(*a, **kw)
        self.wait_pending()


def test_retention_sees_the_new_pin_when_the_writer_commits_first(
        explicit, tmp_path):
    """The loop pins a validated step before it enqueues the write, so a
    writer that commits at once collects the old anchor with the rest."""
    _, td, _, _ = explicit
    mgr = _CommitsAtOnce(str(tmp_path), keep_last_n=1)
    cfg = ALSConfig(rank=K, num_iterations=5, health_check_every=1)
    train_als(td, cfg, device="cpu", checkpoint_manager=mgr,
              checkpoint_every=2)
    assert mgr.iterations() == [5]
    assert mgr._pinned == 5


def test_cli_unrecoverable_raise_exits_1(ratings_file, capsys):
    from cfk_tpu_torch.cli import main

    rc = main(["train", "--data", ratings_file, "--rank", "4",
               "--iterations", "3", "--device", "cpu", "--output", "none",
               "--health-check-every", "1", "--health-norm-limit", "1e-3",
               "--max-recoveries", "1", "--on-unrecoverable", "raise"])
    assert rc == 1
    assert "health sentinel tripped 2 times" in capsys.readouterr().err
    assert main(["train", "--data", ratings_file, "--device", "cpu",
                 "--output", "none", "--checkpoint-every", "0"]) == 1


def test_cli_degrade_reports_in_metrics(ratings_file, capsys):
    import json

    from cfk_tpu_torch.cli import main

    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "3", "--device", "cpu", "--output", "none",
                 "--health-check-every", "1", "--health-norm-limit", "1e-3",
                 "--max-recoveries", "1", "--lam-escalation", "2",
                 "--metrics", "json"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["gauges"]["degraded"] == 1
    assert "fused_loop_trip" in row["notes"]
    assert row["notes"]["pipeline_route"].startswith("stepped")


@pytest.mark.parametrize("scenario", [
    "nan", "inf", "singular_chunk", "torn_checkpoint", "preemption",
    "slow_disk", "telemetry_overhead"])
def test_chaos_lab_scenario_on_cpu(scenario, capsys):
    """Each single-process scenario of the port's chaos lab: fired,
    detected, recovered — crc-equal to the fault-free run (the singular
    one: to the same rungs applied from the rollback point) — and the
    flight recorder names the fault."""
    import json

    from cfk_tpu_torch.scripts import chaos_lab

    assert chaos_lab.main(["--device", "cpu", "--scenario", scenario]) == 0
    rows = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert rows[0]["ok"] and rows[0]["crc_equal"]
    assert rows[-1]["chaos_lab"] == "pass"
