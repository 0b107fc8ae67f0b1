"""Batched ALS-WR normal-equation solves on the padded layout.

The port of ``cfk_tpu/ops/solve.py``'s padded path: per entity

    A = Σ f fᵀ,  b = Σ r·f,  A += λ·n_ratings·I,  x = A⁻¹ b

(``processors/MFeatureCalculator.java:85-99``), for every entity of a side at
once: one gather of neighbor factors into [E, P, k], two float32 einsums for
all Grams and right-hand sides (left to PyTorch, as the JAX package left
them to XLA), then the ridge + solve of kernel K1 (``ops.kernels.
solve_kernel.reg_solve``).

``solver`` picks the route of every solve and Gram kernel: ``"auto"`` calls
the kernel wrappers (the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors); ``"cholesky"`` names the plain PyTorch versions
(``torch.linalg.cholesky``) and is accepted for CPU tensors only — a CUDA
tensor always goes through the kernels, so ``"cholesky"`` there raises.  The
counterpart of the JAX package's ``_resolve_solver``
(``cfk_tpu/ops/solve.py:392-395``).
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve, reg_solve_plain

SOLVERS = ("auto", "cholesky")


def use_kernels(solver: str, device: torch.device) -> bool:
    """True = the kernel wrappers (``"auto"``), False = the plain versions
    (``"cholesky"``, CPU only: on CUDA it raises rather than route a card's
    work around the kernels)."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    if solver == "cholesky" and torch.device(device).type == "cuda":
        raise ValueError(
            "solver='cholesky' is the plain PyTorch route and runs on CPU "
            "tensors only; on CUDA use solver='auto' (the kernels)"
        )
    return solver == "auto"


def gather_gram(
    fixed_factors: torch.Tensor,  # [F, k]
    neighbor_idx: torch.Tensor,  # [E, P] int32
    rating: torch.Tensor,  # [E, P] float32 (0 at padding)
    mask: torch.Tensor,  # [E, P] float32 (1 = real)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram matrices A = Σ f fᵀ and RHS b = Σ r·f for every entity:
    (A [E, k, k], b [E, k]); padding contributes zero via the mask."""
    gm = fixed_factors[neighbor_idx.long()] * mask[..., None]
    a = torch.einsum("epk,epl->ekl", gm, gm)
    b = torch.einsum("epk,ep->ek", gm, rating)
    return a, b


def regularized_solve(a: torch.Tensor, b: torch.Tensor, count: torch.Tensor,
                      lam: float, solver: str = "auto") -> torch.Tensor:
    """Apply ALS-WR regularization λ·max(n, 1)·I and solve (K1)."""
    solve = reg_solve if use_kernels(solver, a.device) else reg_solve_plain
    return solve(a, b, count, lam=lam, reg_mode="diag")


def pad_rows_to_multiple(tensors, multiple: int):
    """Zero-pad every tensor's leading (entity) axis to a multiple of
    ``multiple``; padded rows have zero mask/count, so their solves are inert.
    Returns (tensors, pad)."""
    e = tensors[0].shape[0]
    pad = (-e) % multiple
    if pad:
        tensors = tuple(
            torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            for x in tensors
        )
    return tensors, pad


def _solve_chunk(fixed_factors, lam, neighbor_idx, rating, mask, count,
                 solver="auto"):
    a, b = gather_gram(fixed_factors, neighbor_idx, rating, mask)
    return regularized_solve(a, b, count, lam, solver)


def als_half_step(
    fixed_factors: torch.Tensor,  # [F, k]
    neighbor_idx: torch.Tensor,  # [E, P]
    rating: torch.Tensor,  # [E, P]
    mask: torch.Tensor,  # [E, P]
    count: torch.Tensor,  # [E]
    lam: float,
    *,
    solve_chunk: int | None = None,
    solver: str = "auto",
) -> torch.Tensor:
    """One ALS half-iteration on the padded layout: solve all [E] entities
    against the fixed factors.  ``solve_chunk`` bounds the [chunk, P, k]
    gather held at once by walking entity chunks (an indivisible E is padded
    with inert rows that are sliced off)."""
    e = neighbor_idx.shape[0]
    if solve_chunk is None or solve_chunk >= e:
        return _solve_chunk(fixed_factors, lam, neighbor_idx, rating, mask,
                            count, solver)
    (neighbor_idx, rating, mask, count), _ = pad_rows_to_multiple(
        (neighbor_idx, rating, mask, count), solve_chunk)
    out = [
        _solve_chunk(fixed_factors, lam, neighbor_idx[lo:lo + solve_chunk],
                     rating[lo:lo + solve_chunk], mask[lo:lo + solve_chunk],
                     count[lo:lo + solve_chunk], solver)
        for lo in range(0, neighbor_idx.shape[0], solve_chunk)
    ]
    return torch.cat(out)[:e]


def init_factors_stats(
    generator: torch.Generator,
    rating_sum: torch.Tensor,  # [E] per-entity rating sum
    count: torch.Tensor,  # [E]
    rank: int,
) -> torch.Tensor:
    """Zhou et al. initialization, matching
    ``processors/UFeatureInitializer.java:50-56``: f[0] = the entity's
    average rating, f[1:] ~ U(0, 1); count-0 rows are zero.  The uniform
    draw comes from ``generator`` (on the CPU, so a seed gives the same
    factors on every device); it cannot reproduce ``jax.random``'s bits —
    parity runs inject the JAX package's init through ``warm_start``."""
    e = rating_sum.shape[0]
    cnt = count.to(torch.float32)
    avg = rating_sum.to(torch.float32) / cnt.clamp_min(1.0)
    rest = torch.rand((e, rank - 1), generator=generator,
                      dtype=torch.float32).to(rating_sum.device)
    f = torch.cat([avg[:, None], rest], dim=1)
    return f * (cnt > 0).to(torch.float32)[:, None]


def init_factors(generator, rating, mask, count, rank):
    """``init_factors_stats`` from a padded rectangle's ratings."""
    return init_factors_stats(generator, (rating * mask).sum(1), count, rank)
