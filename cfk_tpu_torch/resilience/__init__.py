"""Self-healing training: health sentinel, recovery policy, fault
injection, preemption — the port's copy of ``cfk_tpu/resilience`` at one
process.

- ``sentinel`` — device probes over the factor state (non-finite values,
  max row norm), one int32 word of reason bits.
- ``policy`` — the rollback/escalation ladder: retry, λ×``lam_escalation``,
  the split epilogue, the "gj" route; bounded, then degrade or raise.
- ``loop`` — the resilient stepped loop the trainers share (checkpoint
  cadence, probes, rollback, ladder, preemption).
- ``faults`` — seeded fault injectors (NaN/Inf rows, singular Grams, torn
  and slow checkpoint stores, a preemption signal).
- ``preempt`` — ``PreemptionGuard`` and ``StallWatchdog``.
- ``retry`` — exponential backoff with jitter.
"""

from cfk_tpu_torch.resilience.policy import (
    Overrides,
    RecoveryPolicy,
    TrainingDivergedError,
)
from cfk_tpu_torch.resilience.preempt import (
    STALL_EXIT_CODE,
    PreemptionGuard,
    StallWatchdog,
)
from cfk_tpu_torch.resilience.sentinel import (
    HealthConfig,
    HealthReport,
    describe_word,
    health_from_config,
)

__all__ = [
    "HealthConfig",
    "HealthReport",
    "Overrides",
    "PreemptionGuard",
    "RecoveryPolicy",
    "STALL_EXIT_CODE",
    "StallWatchdog",
    "TrainingDivergedError",
    "describe_word",
    "health_from_config",
]
