"""Numerical-health sentinel: cheap device probes over the factor state.

The port's copy of ``cfk_tpu/resilience/sentinel.py``.  One NaN in a factor
row poisons every Gram that row touches on the next half-iteration, so the
probe runs two reductions a side — all finite, and the largest squared row
norm against a watchdog limit — O(E·k) against the iteration's
O(nnz·k + E·k²).  The probe word is an int32 of composable reason bits,
the reference's values, so one word carries every tripped condition.

Two consumption modes, one probe:

- **stepped** (``probe_word``): the resilient loop computes the word on the
  device and fetches it (one sync) only on the ``health_check_every``
  cadence, at every save point and at the final iteration;
- **captured** (``fold_probe``): inside a captured iteration the probe
  folds into a static device word ``[first_bad_iter, reasons]`` that keeps
  the first bad iteration — the reference's in-carry word — read once
  after the replays.

``RING_EXCHANGE`` is set by the sharded trainers' ring half-steps
(``parallel.spmd``): a ring-rotated factor block that went non-finite in
flight, folded into the next probe's word by the resilient loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Reason bits of the probe word (compose with |).
NONFINITE_U = 1  # NaN/Inf in the user factors
NONFINITE_M = 2  # NaN/Inf in the movie factors
NORM_U = 4  # a user factor row's 2-norm exceeded the watchdog limit
NORM_M = 8  # a movie factor row's 2-norm exceeded the watchdog limit
RING_EXCHANGE = 16  # a ring-rotated factor block went non-finite in flight

_REASONS = {
    NONFINITE_U: "nonfinite_user_factors",
    NONFINITE_M: "nonfinite_movie_factors",
    NORM_U: "user_norm_watchdog",
    NORM_M: "movie_norm_watchdog",
    RING_EXCHANGE: "ring_exchange_corruption",
}


def describe_word(word: int) -> list[str]:
    """Human-readable reasons for a tripped probe word."""
    return [name for bit, name in _REASONS.items() if word & bit]


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Sentinel knobs resolved from ``ALSConfig`` (``health_from_config``)."""

    every: int = 1  # evaluate the probe every N completed iterations
    norm_limit: float = 1e6  # max factor-row 2-norm before the watchdog trips


@dataclasses.dataclass(frozen=True)
class HealthReport:
    """Host-side diagnostic for one sentinel trip (or a clean run)."""

    iteration: int  # first iteration whose probe tripped; -1 = healthy
    word: int  # reason bitmask (0 = healthy)
    stats: dict  # max row norms etc. at detection time (may be empty)

    @property
    def healthy(self) -> bool:
        return self.word == 0

    @property
    def reasons(self) -> list[str]:
        return describe_word(self.word)

    def summary(self) -> str:
        if self.healthy:
            return "healthy"
        return f"iteration {self.iteration}: {','.join(self.reasons)}"


def health_from_config(config) -> HealthConfig | None:
    """The sentinel config an ``ALSConfig`` selects, or None when off."""
    every = getattr(config, "health_check_every", None)
    if every is None:
        return None
    return HealthConfig(every=every, norm_limit=config.health_norm_limit)


def _side(x: torch.Tensor, limit_sq: float, nonfinite_bit: int,
          norm_bit: int) -> torch.Tensor:
    xf = x.float()
    finite = torch.isfinite(xf).all()
    norm_sq = xf.square().sum(-1).amax() if xf.shape[0] else \
        xf.new_zeros(())
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    w = torch.where(finite, zero, zero + nonfinite_bit)
    return w | torch.where(norm_sq > limit_sq, zero + norm_bit, zero)


def probe_word(u: torch.Tensor, m: torch.Tensor,
               norm_limit: float) -> torch.Tensor:
    """int32 0-d device tensor: the reason bitmask over the factor pair
    (0 = healthy), computed without a host sync or a host-to-device copy
    (so a captured iteration can hold it).  Squared row norms are compared
    against the squared limit, rounded to float32 as the reference rounds
    it, so no sqrt is paid; an Inf row trips both its non-finite and its
    norm bit, and a NaN row only its non-finite bit."""
    limit_sq = float(np.float32(norm_limit) ** 2)
    return (_side(u, limit_sq, NONFINITE_U, NORM_U)
            | _side(m, limit_sq, NONFINITE_M, NORM_M))


def health_stats(u: torch.Tensor, m: torch.Tensor) -> tuple[float, float]:
    """(max row norm of u, of m): the detail a tripped report carries."""
    def row_norm(x):
        xf = x.float()
        return float(xf.square().sum(-1).amax().sqrt()) if xf.shape[0] \
            else 0.0

    return row_norm(u), row_norm(m)


def carry_init(device) -> torch.Tensor:
    """A fresh captured health word: ``[first_bad_iter=-1, reasons=0]``."""
    return torch.tensor([-1, 0], dtype=torch.int32, device=device)


def fold_probe(hw: torch.Tensor, i: torch.Tensor, u: torch.Tensor,
               m: torch.Tensor, *, due: torch.Tensor,
               norm_limit: float) -> None:
    """Fold one iteration's probe into the health word ``hw`` in place
    (no host sync, so a captured iteration can hold it): where ``due``
    (a 0-d bool device tensor — the cadence, decided by the caller) and the
    word is still clean, a tripped probe writes ``[i, reasons]``; the first
    bad iteration is kept.  ``i`` is the 0-based iteration index as a 0-d
    int32 device tensor."""
    w = probe_word(u, m, norm_limit)
    take = due & (hw[0] < 0) & (w > 0)
    hw.copy_(torch.where(take, torch.stack([i, w]), hw))


def report_from_carry(hw, u=None, m=None) -> HealthReport:
    """Host-side report from a fetched captured word (with the factors' row
    norms when the caller still holds them)."""
    it, word = (int(x) for x in torch.as_tensor(hw).tolist())
    stats = {}
    if word and u is not None and m is not None:
        nu, nm = health_stats(u, m)
        stats = {"max_row_norm_u": nu, "max_row_norm_m": nm}
    return HealthReport(iteration=it if word else -1, word=word, stats=stats)
