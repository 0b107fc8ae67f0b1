"""The resilient stepped training loop every trainer shares.

The port's copy of ``cfk_tpu/resilience/loop.py`` at one process: step
from Python, save factors on the checkpoint cadence, evaluate the health
sentinel on its cadence, and on a trip roll back to the last good state
and climb the escalation ladder (``resilience.policy``) before retrying —
bounded, then degrading to the last-good factors with a diagnostic report
instead of crashing.  The notes, counters and gauges it writes to
``metrics`` are the reference's vocabulary (``health_trip_N``,
``escalation_level``, ``escalation_N``, ``plan_transition_N``,
``degraded``, ``preempted``, ...).

The loop is eager: each iteration's kernels are issued from Python, and
the host waits on the device only where it reads something — the probe
word on the health cadence (``sentinel.probe_word``, one int32), and the
end of the run.  The last-good anchor is a device copy of the factors
taken at a validated point (a committed save, or a healthy probe when no
checkpoint store is set); a trip before the first one rolls back to the
resumed checkpoint or to ``init_fn()``.  With ``health=None``, no policy
and no injector this is exactly the checkpointed loop
(``transport.checkpoint.checkpointed_train_loop`` delegates here).
"""

from __future__ import annotations

import warnings

import torch

from cfk_tpu_torch.resilience import sentinel as _sentinel
from cfk_tpu_torch.resilience.policy import (
    Overrides,
    RecoveryPolicy,
    TrainingDivergedError,
)
from cfk_tpu_torch.telemetry import record_event, span
from cfk_tpu_torch.telemetry.recorder import dump_flight


def validate_cadence(checkpoint_every: int, health=None) -> None:
    """Actionable validation of the loop cadences (the reference's
    messages)."""
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1 (iterations between factor "
            f"saves), got {checkpoint_every}; use checkpoint_every=1 for "
            "per-iteration journaling or a larger value to save less often"
        )
    if health is not None and health.every < 1:
        raise ValueError(
            f"health_check_every must be >= 1 (iterations between sentinel "
            f"probes), got {health.every}; use health_check_every=None to "
            "disable the sentinel entirely"
        )


def save_checkpoint(manager, done, u, m, *, meta=None):
    """One save-point write: ``save_async`` when the manager has it (the
    snapshot is taken at the call, the disk write runs on its writer
    thread), else a blocking ``save``."""
    if hasattr(manager, "save_async"):
        manager.save_async(done, u, m, meta=meta)
    else:
        manager.save(done, u, m, meta=meta)


def drain_checkpoints(manager) -> None:
    """Barrier on the async checkpoint writer (a no-op for sync stores):
    called before every rollback read and at every loop exit, so readers
    only ever observe committed steps."""
    if manager is not None and hasattr(manager, "wait_pending"):
        manager.wait_pending()


def _device_copy(u, m):
    return u.clone(), m.clone()


def resilient_train_loop(
    manager,
    *,
    model: str,
    rank: int,
    num_iterations: int,
    u_shape,
    m_shape,
    dtype,
    init_fn,
    metrics,
    step_fn=None,
    make_step=None,
    base_overrides: Overrides | None = None,
    checkpoint_every: int = 1,
    health: "_sentinel.HealthConfig | None" = None,
    policy: RecoveryPolicy | None = None,
    fault_injector=None,
    device=None,
    preemption_guard=None,
    watchdog=None,
    num_shards: int = 1,
    resume_fn=None,
    restore_fn=None,
    save_fn=None,
    probe_fn=None,
    evict_sync_fn=None,
):
    """Run the stepped loop; returns the final ``(u, m)`` factors.

    Exactly one of ``step_fn`` (a fixed ``(u, m) -> (u, m)`` step — plain
    rollback+retry only) or ``make_step`` (``make_step(Overrides) -> step``
    — the full ladder) must be given.  ``init_fn() -> (u, m)`` gives the
    initial factors (tensors on the run's device, ``dtype``); a resumed
    checkpoint's factors go to ``device`` (default: the initial factors').
    ``preemption_guard`` (``resilience.preempt.PreemptionGuard``) is polled
    between iterations: once triggered, the loop commits a final
    checkpoint (unless the state just failed its probe), drains the writer
    and returns resumable.  ``watchdog`` (``StallWatchdog``) is armed
    around the loop and ticked per completed iteration.

    The sharded trainers (``parallel.spmd``) bind the loop to a rank
    group through the seams of ``cfk_tpu/resilience/loop.py:95-224``:
    ``resume_fn()`` (rank 0 reads the store and broadcasts),
    ``restore_fn(hu, hm)`` (whole host tables → this rank's rows),
    ``save_fn(done, u, m)`` (every rank gathers, rank 0 writes),
    ``probe_fn(u, m)`` (the probe word agreed by every rank) and
    ``evict_sync_fn(local) -> bool`` (the eviction agreed at the same
    boundary: a collective, called every iteration when set); a step may
    return ``(u, m, ring_bad)``, the ring exchange's corruption flag, which
    sets ``RING_EXCHANGE`` in the next probe's word.
    """
    from cfk_tpu_torch.models.als import as_tensor
    from cfk_tpu_torch.transport.checkpoint import resume_state

    validate_cadence(checkpoint_every, health)
    if (step_fn is None) == (make_step is None):
        raise ValueError("pass exactly one of step_fn / make_step")
    policy = policy or RecoveryPolicy()
    if resume_fn is None:
        state = resume_state(manager, rank=rank, model=model,
                             num_iterations=num_iterations, u_shape=u_shape,
                             m_shape=m_shape, num_shards=num_shards)
    else:
        state = resume_fn()
    if state is not None:
        start_iter = state.iteration
        if restore_fn is None:
            if device is None:
                device = init_fn()[0].device

            def restore_fn(hu, hm):
                return (as_tensor(hu, device).to(dtype),
                        as_tensor(hm, device).to(dtype))

        u, m = restore_fn(state.user_factors, state.movie_factors)
        resumed = _device_copy(u, m)
    else:
        start_iter, resumed = 0, None
        u, m = init_fn()

    if save_fn is None:
        def save_fn(done, u, m):
            save_checkpoint(manager, done, u, m,
                            meta={"rank": rank, "model": model,
                                  "num_shards": num_shards})
    if probe_fn is None and health is not None:
        def probe_fn(u, m):
            return _sentinel.probe_word(u, m, health.norm_limit)

    overrides = base_overrides or Overrides(lam=0.0)
    step = step_fn if make_step is None else make_step(overrides)
    if watchdog is not None:
        watchdog.arm()
    try:
        return _run_loop_body(
            manager=manager, num_iterations=num_iterations,
            start_iter=start_iter, u=u, m=m, step=step, make_step=make_step,
            overrides=overrides, policy=policy, health=health,
            metrics=metrics, checkpoint_every=checkpoint_every,
            fault_injector=fault_injector, save_fn=save_fn, resumed=resumed,
            init_fn=init_fn, guard=preemption_guard, watchdog=watchdog,
            probe_fn=probe_fn, evict_sync_fn=evict_sync_fn)
    finally:
        if watchdog is not None:
            watchdog.disarm()
        # Every return path (completion, degrade, preemption, an exception
        # unwinding) leaves only committed steps behind.
        drain_checkpoints(manager)


def _run_loop_body(*, manager, num_iterations, start_iter, u, m, step,
                   make_step, overrides, policy, health, metrics,
                   checkpoint_every, fault_injector, save_fn, resumed,
                   init_fn, guard=None, watchdog=None, probe_fn=None,
                   evict_sync_fn=None):
    from cfk_tpu_torch.transport.checkpoint import should_save

    # Last-good rollback anchor: (iteration, device copies), updated only
    # at validated points, so a committed checkpoint and the anchor never
    # disagree about what "good" means.
    good: tuple[int, tuple] | None = None
    trips = 0
    reports: list[_sentinel.HealthReport] = []

    def rollback():
        if good is not None:
            it, pair = good
            return it, _device_copy(*pair)
        if resumed is not None:
            return start_iter, _device_copy(*resumed)
        return start_iter, init_fn()

    i = start_iter
    ring_pending = False  # ring-exchange flags seen since the last probe
    while i < num_iterations:
        if fault_injector is not None:
            u, m = fault_injector.before_step(i, u, m)
        with metrics.phase("train"), span("train/iter", i=i):
            out = step(u, m)
            u, m, ring_bad = out if len(out) == 3 else (*out, None)
        record_event("train", "iter", i=i)
        ring_pending = ring_pending or bool(ring_bad)
        metrics.incr("iterations")
        done = i + 1
        if watchdog is not None:
            watchdog.tick(done)
        evicting = guard is not None and guard.triggered
        if evict_sync_fn is not None:
            evicting = bool(evict_sync_fn(evicting))
        # With no checkpoint store the save cadence must not drive probes
        # or snapshots — the health cadence alone does.
        saving = manager is not None and (
            should_save(done, checkpoint_every, num_iterations) or evicting)
        probing = health is not None and (
            done % health.every == 0 or done == num_iterations or saving)
        word = 0
        if probing:
            # Save points force a probe so a bad state is never committed.
            with metrics.phase("health_check"), \
                    span("train/health_probe", i=done):
                word = int(probe_fn(u, m))
                if ring_pending:
                    word |= _sentinel.RING_EXCHANGE
            ring_pending = False
            metrics.incr("health_checks")
        evict_reason = (guard.signal_name if guard is not None
                        and guard.triggered else "peer process signalled")
        if word and evicting:
            # Evicted at an unhealthy iteration: no time to climb the
            # ladder, and a bad state is never committed — return the
            # last-good factors; the store's newest step is the resume point.
            probe_summary = _sentinel.HealthReport(done, word, {}).summary()
            record_event("fault", "evicted_unhealthy", iteration=done,
                         reason=evict_reason, probe=probe_summary)
            dump_flight("evicted_unhealthy")
            anchor, (u, m) = rollback()
            metrics.gauge("preempted", 1)
            metrics.gauge("trained_iterations", anchor)
            metrics.note(
                "preempted",
                f"{evict_reason} at iteration {done} with a tripped "
                f"health probe ({probe_summary}); "
                f"returning last-good factors from iteration {anchor}",
            )
            return u, m
        if word:
            trips += 1
            report = _sentinel.HealthReport(iteration=done, word=word,
                                            stats={})
            reports.append(report)
            metrics.incr("health_trips")
            metrics.note(f"health_trip_{trips}", report.summary())
            record_event("fault", "health_trip", iteration=done,
                         trip=trips, reason=report.summary())
            dump_flight(f"health_trip_{trips}")
            if trips > policy.max_recoveries:
                msg = (
                    f"health sentinel tripped {trips} times "
                    f"(> max_recoveries={policy.max_recoveries}); last: "
                    f"{report.summary()}"
                )
                if policy.on_unrecoverable == "raise":
                    record_event("fault", "unrecoverable", detail=msg)
                    dump_flight("unrecoverable")
                    raise TrainingDivergedError(msg, reports)
                anchor, (u, m) = rollback()
                record_event("fault", "degraded", detail=msg)
                dump_flight("degraded")
                metrics.gauge("degraded", 1)
                metrics.gauge("trained_iterations", anchor)
                metrics.note(
                    "degraded",
                    f"{msg}; returning last-good factors from iteration "
                    f"{anchor}",
                )
                warnings.warn(
                    f"training degraded: {msg}; returning last-good "
                    f"factors from iteration {anchor}"
                )
                return u, m
            # Write-order barrier: the replay re-saves the same step
            # numbers, and an older write still in flight must not commit
            # over a newer one.
            drain_checkpoints(manager)
            i, (u, m) = rollback()
            metrics.incr("rollbacks")
            new_overrides = policy.escalate(overrides, trips)
            if new_overrides != overrides:
                detail = (
                    f"lam={new_overrides.lam:g} fused="
                    f"{new_overrides.fused_epilogue} "
                    f"algo={new_overrides.reg_solve_algo}"
                )
                record_event("fault", "escalation", rung=trips,
                             detail=detail)
                overrides = new_overrides
                metrics.gauge("escalation_level", trips)
                metrics.note(f"escalation_{trips}", detail)
                metrics.note(f"plan_transition_{trips}", detail)
                if make_step is not None:
                    step = make_step(overrides)
                    if watchdog is not None:
                        # The rebuilt step may build other kernels first.
                        watchdog.extend_grace()
                else:
                    warnings.warn(
                        "escalation requested but this loop was built with "
                        "a fixed step_fn; retrying with unchanged settings"
                    )
            continue
        if health is not None and saving and hasattr(manager, "pin"):
            # keep_last_n must never collect the step the ladder would roll
            # back to.  The pin moves before the enqueue: the async writer
            # may commit this step and run its retention before
            # save_async returns, and must then already see it pinned.
            manager.pin(done)
        if saving:
            with metrics.phase("checkpoint"), \
                    span("train/checkpoint", i=done):
                save_fn(done, u, m)
            metrics.incr("checkpoints")
        if health is not None and (saving or (manager is None and probing)):
            # Rollback anchor: mirrors every validated commit; with no
            # checkpoint store it follows the health cadence (only ever at
            # a probed-healthy iteration).
            good = (done, _device_copy(u, m))
        if evicting:
            # The final checkpoint rode the forced save point above; drain
            # the writer so it is on disk before the process exits.
            drain_checkpoints(manager)
            record_event("signal", "preempted", iteration=done,
                         reason=evict_reason, committed=bool(saving))
            dump_flight("preemption")
            metrics.gauge("preempted", 1)
            metrics.gauge("trained_iterations", done)
            metrics.note(
                "preempted",
                f"{evict_reason} at iteration {done}/"
                f"{num_iterations}; final checkpoint "
                f"{'committed' if saving else 'skipped (no manager)'} — "
                "resume from the same checkpoint directory to continue",
            )
            warnings.warn(
                f"training preempted ({evict_reason}) at iteration "
                f"{done}/{num_iterations}; exiting resumable"
            )
            return u, m
        i = done
    return u, m


def make_probed_step(step, health, total: int):
    """``step(state, out)`` of ``models.als.iteration_step`` widened to
    carry the captured health word: state = (u, m, hw, it) with hw the
    ``[first_bad_iter, reasons]`` word and ``it`` the 0-d int32 index of the
    next iteration, both on the device.  After each iteration the probe is
    folded in on the cadence (every ``health.every`` completed iterations
    and at the last, ``total``) with no host sync, so the step can be
    captured into a CUDA graph; ``out`` (the captured form) is written in
    place."""
    def run(state, out):
        u, m = step(state[:2], None if out is None else out[:2])
        if out is None:
            hw, it = state[2].clone(), state[3].clone()
        else:
            hw, it = out[2], out[3]
        done = it + 1
        due = (done % health.every == 0) | (done == total)
        _sentinel.fold_probe(hw, it, u, m, due=due,
                             norm_limit=health.norm_limit)
        it.add_(1)
        return u, m, hw, it

    return run


def probed_state(u, m):
    """The initial (u, m, hw, it) of ``make_probed_step``."""
    return (u, m, _sentinel.carry_init(u.device),
            torch.zeros((), dtype=torch.int32, device=u.device))


__all__ = [
    "drain_checkpoints",
    "make_probed_step",
    "probed_state",
    "resilient_train_loop",
    "save_checkpoint",
    "validate_cadence",
]

