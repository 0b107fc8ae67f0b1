"""The bucketed layout's width classes through kernel K6, or through K5 and
``gram_solve_tiles`` on the materialized-stream schedule; with the split
epilogue, through K2 (or K5 and ``gram_tiles``) and K1.

The port of ``cfk_tpu/ops/bucketed.py``.  A width bucket is
a [rows, width] rectangle; flattened with ``tile_rows = width`` it is one
tile per entity — ``seg = arange(rows)``, no carry — so ``gram_solve_gather``
(K6) gathers, sums, regularizes and solves the whole class in one launch,
and neither the gathered stream nor the [rows, k, k] Gram batch reaches
device memory.  With ``in_kernel_gather=False`` K5 writes the class's stream
g = table[nb]·wt [rows·width, k] and ``gram_solve_tiles`` (row 6 of the TPU
kernel table, ``gram_solve_tiles_pallas``) solves it — the JAX route's
``gather="xla"`` pieces (``cfk_tpu/ops/bucketed.py:134-230``), one piece per
class as for K6.  The split epilogue (``fused=False``,
``cfk_tpu/ops/bucketed.py:208-222``) writes each class's (A, b) to device
memory — K2 ``gram_gather``, or K5 and ``gram_tiles`` with the gather off —
and solves it with K1's one pass (diag mode for ALS, matrix mode for iALS),
as the JAX route pins ``fused=True`` on that solve: the knob toggles only
the Gram's round trip through memory, not the solve.  The [rows, k, k]
Gram batch of a class then exists at once (64 KB a row at k = 128).

A quantized table (``ops.quant``: bf16, or int8 codes with their per-row
scale) is read as the kernels take it; the int8 scale is folded into the
piece's weights first (``fold_scale``, ``cfk_tpu/ops/bucketed.py:177``).
With the gather off a class is walked in the blocks' ``chunk_rows``
pieces (``ops.solve.bucket_chunks``), so no K5 stream exceeds
chunk·width·k elements; each piece's entities are whole segments, so the
pieces' rows are the whole class's bits.

The JAX route's legacy fallback for widths below 16 (a Mosaic sublane
constraint) and its ``_sub_rows`` scalar-prefetch budget have no
counterpart: K6 reads its indices from device memory, its grid takes any row
count and its shared memory does not depend on the width (see
``csrc/gram_solve_gather.cu``), so no class is split for the kernel's sake.
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gather_rows,
    gather_rows_plain,
    gram_gather,
    gram_gather_plain,
    gram_solve_gather,
    gram_solve_gather_plain,
    gram_solve_tiles,
    gram_solve_tiles_plain,
    gram_tiles,
    gram_tiles_plain,
)
from cfk_tpu_torch.ops.quant import fold_scale
from cfk_tpu_torch.ops.solve import (
    regularized_solve,
    regularized_solve_matrix,
    use_kernels,
)

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
    table: torch.Tensor,  # [F, k] gather table (f32 / bf16 / int8 codes)
    nb: torch.Tensor,  # [rows, width] int32 neighbor indices (< F)
    wt: torch.Tensor,  # [rows, width] premultiply (mask / √aw·mask)
    rt: torch.Tensor,  # [rows, width] b-side coefficients (0 at padding)
    reg: torch.Tensor,  # [rows] counts (diag) or [k, k] shared matrix (iALS)
    *,
    lam: float,
    reg_mode: str,
    solver: str = "auto",
    gather: str = "fused",
    fused: bool = True,
    units=None,  # the piece's Gram work-unit plan (None: derived on device)
    scale: torch.Tensor | None = None,  # [F] int8 per-row dequant scales
    algo: str | None = None,  # reg_solve_algo of the split route's K1 pass
) -> torch.Tensor:
    """One width-class piece: flatten to one tile per entity and solve every
    row — [rows, k].  ``gather="fused"``: K6 reads the table by index;
    ``"xla"`` (``ops.tiled.resolve_gather_mode``): K5 writes the piece's
    stream and ``gram_solve_tiles`` solves it.  ``fused=False``: K2 (or K5
    and ``gram_tiles``) writes (A, b) and K1 solves it (the split dispatch
    past ``algo``'s cap).  Plain versions on the CPU."""
    rows, width = nb.shape
    kernels = use_kernels(solver, table.device)
    seg = torch.arange(rows, dtype=torch.int32, device=nb.device)
    wt = fold_scale(wt, scale, nb)
    nb, wt = nb.reshape(-1), wt.reshape(-1).contiguous()
    kw = dict(rt=rt.reshape(-1).contiguous(), seg=seg, num_segments=rows,
              tile_rows=width, units=units)
    g = None
    if gather == "xla":
        g = (gather_rows if kernels else gather_rows_plain)(table, nb, wt)
    if not fused:
        if g is not None:
            a, b = (gram_tiles if kernels else gram_tiles_plain)(g, **kw)
        else:
            a, b = (gram_gather if kernels else gram_gather_plain)(
                table, nb=nb, wt=wt, **kw)
        del g
        if reg_mode == "diag":
            return regularized_solve(a, b, reg, lam, solver, fused=True,
                                     algo=algo)
        return regularized_solve_matrix(a, b, reg, solver, fused=True,
                                        algo=algo)
    kw.update(reg=reg, lseg=rows - 1, lam=lam, reg_mode=reg_mode)
    if g is not None:
        x, _, _ = (gram_solve_tiles if kernels else gram_solve_tiles_plain)(
            g, **kw)
    else:
        x, _, _ = (gram_solve_gather if kernels else gram_solve_gather_plain)(
            table, nb=nb, wt=wt, **kw)
    return x
