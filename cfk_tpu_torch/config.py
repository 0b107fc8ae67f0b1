"""Run configuration: the subset of ``cfk_tpu.config.ALSConfig`` the port
trains with, with the same defaults and the same validation messages."""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Hyper-parameters + execution layout for an ALS-WR run.

    Mirrors the reference CLI surface (``apps/ALSAppRunner.java:16-28``):
    NUM_FEATURES → ``rank``, LAMBDA → ``lam``, NUM_ITERATIONS →
    ``num_iterations``; entity counts come from the data.
    """

    rank: int = 5
    lam: float = 0.05
    num_iterations: int = 7
    seed: int = 42
    # InBlock layout: "padded" (one rectangle per side), "tiled" (accum +
    # dense stream), "auto" (padded below 2M ratings, tiled above — resolved
    # by whoever builds the Dataset; the trainer follows the blocks).
    layout: Literal["auto", "padded", "tiled"] = "padded"
    # "auto": the CUDA kernels on a GPU, their plain PyTorch versions on
    # the CPU.  "cholesky": the plain PyTorch route (torch.linalg.cholesky
    # solves, einsum Grams), CPU only — train_als raises for it on CUDA.
    solver: Literal["auto", "cholesky"] = "auto"
    # Gather-cell budget (rows × width ≈ ratings per chunk).  padded:
    # entities per solve chunk = hbm_chunk_elems // rectangle width; tiled:
    # consumed at build time (Dataset.from_coo(chunk_elems=...)).
    hbm_chunk_elems: int | None = None
    # Validated like cfk_tpu's; the port's solve kernels eliminate by
    # Cholesky, so only "auto" is accepted ("lu"/"gj" raise).
    reg_solve_algo: Literal["auto", "lu", "gj"] = "auto"

    def chunk_cells(self) -> int:
        """The build-time gather-cell budget (1M cells when unset)."""
        return 1 << 20 if self.hbm_chunk_elems is None else self.hbm_chunk_elems

    def padded_solve_chunk(self, width: int) -> int | None:
        """Entities per padded-layout solve chunk under the cell budget;
        None = solve the whole side at once."""
        if self.hbm_chunk_elems is None:
            return None
        return max(1, self.hbm_chunk_elems // max(width, 1))

    def __post_init__(self) -> None:
        if self.reg_solve_algo not in ("auto", "lu", "gj"):
            raise ValueError(
                f"reg_solve_algo must be 'auto', 'lu' or 'gj', got "
                f"{self.reg_solve_algo!r}"
            )
        if self.reg_solve_algo != "auto":
            raise NotImplementedError(
                f"reg_solve_algo={self.reg_solve_algo!r}: the port's solve "
                "kernels eliminate by Cholesky only; use 'auto'"
            )
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        if self.num_iterations < 1:
            raise ValueError(f"num_iterations must be >= 1, got {self.num_iterations}")
        if self.lam < 0:
            raise ValueError(f"lam must be >= 0, got {self.lam}")
        if self.solver not in ("auto", "cholesky"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.layout not in ("auto", "padded", "tiled"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.hbm_chunk_elems is not None and self.hbm_chunk_elems < 1:
            raise ValueError(
                f"hbm_chunk_elems must be >= 1, got {self.hbm_chunk_elems}"
            )
