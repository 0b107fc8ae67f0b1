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

The classes the JAX route's gate refuses (``bucket_port_supported``: widths
below 16 or not a multiple of 16 — a Mosaic sublane limit — and widths whose
one-row piece overflows its scalar-prefetch SMEM budget) run its legacy
schedule there, and so they do here: a gather, an einsum and the ridge +
solve (``ops.solve``), which rounds a bf16 table's weighted products where
the reference's legacy schedule rounds them.  The gate depends on the shape
alone, so the CPU and the card take the same classes.  K6 itself has no such
limit (it reads its indices from device memory, its grid takes any row count
and its shared memory does not depend on the width, see
``csrc/gram_solve_gather.cu``), so the JAX route's ``_sub_rows`` budget has
no counterpart and no class is split for the kernel's sake.
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

# The JAX route's scalar-prefetch SMEM budget of its gather kernels
# (``cfk_tpu/ops/pallas/gram_kernel.py:1083``): a width class whose one-row
# piece (width indices, 3 meta words and lseg, 4 bytes each) exceeds it
# keeps the legacy schedule.
_GATHER_SMEM_BYTES_CAP = 512 << 10

# The tiled reparameterization's clamp: an α·r = 0 entry's A-term becomes
# ε·f fᵀ (far below the λ ridge) while b stays exact — (c/√ε)·(√ε·f) = c·f.
_SQRT_WEIGHT_EPS = 1e-12


def bucket_port_supported(rows: int, width: int, k: int) -> bool:
    """Whether a width class runs the tiled-kernel route (K6, or K2 + K1)
    — the JAX package's gate (``cfk_tpu/ops/bucketed.py:60-73``): a width
    of at least 16 and a multiple of 16, and one row's scalar prefetch
    within the SMEM budget (``in_kernel_gather_supported(width, 3,
    width)``).  Refused classes take the legacy schedule (``ops.solve``).
    ``rows`` and ``k`` do not enter the gate, as in the reference."""
    if width < 16 or width % 16:
        return False
    return (width + 3 + 1) * 4 <= _GATHER_SMEM_BYTES_CAP


def ials_reparam(rt: torch.Tensor, mk: torch.Tensor, alpha: float):
    """The sqrt reparameterization of the implicit Gram: one weighted stream
    gs = √(α·r)·f (so Σ gs gsᵀ = Σ α·r·f fᵀ exactly) with the b-coefficient
    rescaled to c/√(α·r); the 0/1 mask is re-applied so padding survives the
    ε clamp.  Returns (wt, rt_scaled)."""
    aw = torch.sqrt(torch.clamp_min(alpha * rt, _SQRT_WEIGHT_EPS))
    return aw * mk, (1.0 + alpha * rt) * mk / aw


def bucket_stream(table, nb, wt, scale, out=None, *, solver="auto"):
    """A width-class piece's materialized stream g = table[nb]·wt
    [rows·width, k] (K5 on CUDA), an int8 table's scale folded into ``wt``
    first — the fetch of the gather-off walk (``ops.solve.walk_buckets``),
    written into ``out`` when given."""
    wt = fold_scale(wt, scale, nb).reshape(-1).contiguous()
    if use_kernels(solver, table.device):
        return gather_rows(table, nb.reshape(-1), wt, None, out)
    g = gather_rows_plain(table, nb.reshape(-1), wt)
    return g if out is None else out.copy_(g)


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
    g: torch.Tensor | None = None,  # the piece's stream, fetched by the walk
) -> torch.Tensor:
    """One width-class piece: flatten to one tile per entity and solve every
    row — [rows, k].  ``gather="fused"``: K6 reads the table by index;
    ``"xla"`` (``ops.tiled.resolve_gather_mode``): K5 writes the piece's
    stream (``bucket_stream``, unless the walk has fetched it as ``g``) and
    ``gram_solve_tiles`` solves it.  ``fused=False``: K2 (or K5 and
    ``gram_tiles``) writes (A, b) and K1 solves it (the split dispatch past
    ``algo``'s cap).  Plain versions on the CPU.  The carry-out row is the
    last segment, taken on the device (``seg[-1:]``): a captured piece
    copies nothing from the host."""
    rows, width = nb.shape
    kernels = use_kernels(solver, table.device)
    seg = torch.arange(rows, dtype=torch.int32, device=nb.device)
    kw = dict(rt=rt.reshape(-1).contiguous(), seg=seg, num_segments=rows,
              tile_rows=width, units=units)
    if gather == "xla" and g is None:
        g = bucket_stream(table, nb, wt, scale, solver=solver)
    if g is None:
        wt = fold_scale(wt, scale, nb)
        nb, wt = nb.reshape(-1), wt.reshape(-1).contiguous()
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
    kw.update(reg=reg, lseg=seg[-1:], lam=lam, reg_mode=reg_mode)
    if g is not None:
        x, _, _ = (gram_solve_tiles if kernels else gram_solve_tiles_plain)(
            g, **kw)
    else:
        x, _, _ = (gram_solve_gather if kernels else gram_solve_gather_plain)(
            table, nb=nb, wt=wt, **kw)
    return x
