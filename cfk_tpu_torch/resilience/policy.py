"""Recovery policy: the rollback/escalation ladder for tripped probes.

The port's copy of ``cfk_tpu/resilience/policy.py`` (pure Python).

On a sentinel trip the resilient loop rolls back to the last good state
(last committed checkpoint, or the in-memory snapshot mirror when no
checkpoint store is configured) and climbs one rung of the escalation
ladder before retrying:

  1. **retry** — rollback only, no config change.  Transient corruption
     (a one-shot bit flip, an injected NaN) replays cleanly because the
     iteration math is deterministic.
  2. **bump λ** — multiply the regularizer by ``lam_factor`` (from
     ``lam_floor`` when λ was 0).  Fixes genuinely singular or
     near-singular normal equations — ALS-WR's λ·n·I is exactly the SPD
     repair knob.
  3. **split epilogue** — pin ``fused_epilogue=False``: the fused
     Gram+solve kernels (K3, K6) step aside for the split Gram → device
     memory → solve schedule, and λ stays bumped.
  4. **GJ route** — ``reg_solve_algo="gj"``, which the port routes as the
     reference does (``ops.solve.fused_rank_cap``: 64 < k <= 128 takes
     the split schedule's blocked Schur solve).  It is a step-build
     parameter, so ``make_step(Overrides)`` rebuilds the step with it and
     no process state is left behind.  λ is bumped again: the extra ridge
     is the SPD repair.

Rungs are cumulative, and settings stay escalated for the rest of the run
(a run that needed λ·10 to stay SPD will need it again).  After
``max_recoveries`` total trips the loop stops retrying and degrades
gracefully: return the last-good factors with a diagnostic report instead
of crashing (``on_unrecoverable="raise"`` opts into the crash).
"""

from __future__ import annotations

import dataclasses


class TrainingDivergedError(RuntimeError):
    """Raised when recovery is exhausted and ``on_unrecoverable="raise"``."""

    def __init__(self, message: str, reports=()):  # reports: [HealthReport]
        super().__init__(message)
        self.reports = list(reports)


@dataclasses.dataclass(frozen=True)
class Overrides:
    """The step-build knobs one escalation rung may change.

    All three are step-build parameters: ``make_step(Overrides)`` rebuilds
    the step with them, so every rung takes its override.
    """

    lam: float
    fused_epilogue: bool | None = None
    reg_solve_algo: str | None = None  # None = leave the config/process default


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Bounds and factors of the escalation ladder (see module docstring)."""

    max_recoveries: int = 4
    lam_factor: float = 10.0
    lam_floor: float = 1e-4  # the bump target when λ was exactly 0
    on_unrecoverable: str = "degrade"  # or "raise"

    def __post_init__(self) -> None:
        if self.max_recoveries < 0:
            raise ValueError(
                f"max_recoveries must be >= 0, got {self.max_recoveries}"
            )
        if self.lam_factor <= 1.0:
            raise ValueError(
                f"lam_factor must be > 1 (it escalates λ), got "
                f"{self.lam_factor}"
            )
        if self.on_unrecoverable not in ("degrade", "raise"):
            raise ValueError(
                "on_unrecoverable must be 'degrade' or 'raise', got "
                f"{self.on_unrecoverable!r}"
            )

    def _bump(self, lam: float) -> float:
        return lam * self.lam_factor if lam > 0 else self.lam_floor

    def escalate(self, current: Overrides, level: int) -> Overrides:
        """Overrides for escalation rung ``level`` (1-based trip count).

        Level 1 keeps ``current`` (plain rollback+retry); each later level
        applies its rung cumulatively on top of the previous overrides.
        Levels past the ladder keep escalating λ — by then the run is
        either recovering or burning through its bounded retries.
        """
        if level <= 1:
            return current
        if level == 2:
            return dataclasses.replace(current, lam=self._bump(current.lam))
        if level == 3 and current.fused_epilogue is not False:
            return dataclasses.replace(current, fused_epilogue=False)
        # Rung 4 — also taken at level 3 when the split epilogue is
        # already pinned (a no-op rung would burn one of the bounded
        # retries on an identical, guaranteed-to-re-trip replay).
        return dataclasses.replace(
            current, lam=self._bump(current.lam), reg_solve_algo="gj"
        )


def policy_from_config(config) -> RecoveryPolicy:
    """The recovery policy an ``ALSConfig`` selects."""
    return RecoveryPolicy(
        max_recoveries=config.max_recoveries,
        lam_factor=config.lam_escalation,
        on_unrecoverable=config.on_unrecoverable,
    )
