"""The bucketed layout's width classes through kernel K6.

The port of ``cfk_tpu/ops/bucketed.py`` on its default route (gather fused,
epilogue fused).  A width bucket is a [rows, width] rectangle; flattened with
``tile_rows = width`` it is one tile per entity — ``seg = arange(rows)``, no
carry — so ``gram_solve_gather`` (K6) gathers, sums, regularizes and solves
the whole class in one launch, and neither the gathered stream nor the
[rows, k, k] Gram batch reaches device memory.

Every width class runs through K6 on CUDA.  The JAX route's legacy fallback
for widths below 16 (a Mosaic sublane constraint) and its ``_sub_rows``
scalar-prefetch budget have no counterpart: K6 reads its indices from device
memory, its grid takes any row count and its shared memory does not depend
on the width (see ``csrc/gram_solve_gather.cu``), so no class is split.
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gram_solve_gather,
    gram_solve_gather_plain,
)
from cfk_tpu_torch.ops.solve import use_kernels

# The tiled reparameterization's clamp: an α·r = 0 entry's A-term becomes
# ε·f fᵀ (far below the λ ridge) while b stays exact — (c/√ε)·(√ε·f) = c·f.
_SQRT_WEIGHT_EPS = 1e-12


def ials_reparam(rt: torch.Tensor, mk: torch.Tensor, alpha: float):
    """The sqrt reparameterization of the implicit Gram: one weighted stream
    gs = √(α·r)·f (so Σ gs gsᵀ = Σ α·r·f fᵀ exactly) with the b-coefficient
    rescaled to c/√(α·r); the 0/1 mask is re-applied so padding survives the
    ε clamp.  Returns (wt, rt_scaled)."""
    aw = torch.sqrt(torch.clamp_min(alpha * rt, _SQRT_WEIGHT_EPS))
    return aw * mk, (1.0 + alpha * rt) * mk / aw


def bucket_gram_solve(
    table: torch.Tensor,  # [F, k] gather table
    nb: torch.Tensor,  # [rows, width] int32 neighbor indices (< F)
    wt: torch.Tensor,  # [rows, width] premultiply (mask / √aw·mask)
    rt: torch.Tensor,  # [rows, width] b-side coefficients (0 at padding)
    reg: torch.Tensor,  # [rows] counts (diag) or [k, k] shared matrix (iALS)
    *,
    lam: float,
    reg_mode: str,
    solver: str = "auto",
) -> torch.Tensor:
    """One width-class piece: flatten to one tile per entity and solve every
    row with K6 (its plain version on the CPU) — [rows, k]."""
    rows, width = nb.shape
    fused = (gram_solve_gather if use_kernels(solver, table.device)
             else gram_solve_gather_plain)
    seg = torch.arange(rows, dtype=torch.int32, device=nb.device)
    x, _, _ = fused(table, nb.reshape(-1), wt.reshape(-1).contiguous(),
                    rt.reshape(-1).contiguous(), seg, reg, rows - 1,
                    num_segments=rows, tile_rows=width, lam=lam,
                    reg_mode=reg_mode)
    return x
