"""Subspace optimization — block coordinate descent for both ALS families.

The port of ``cfk_tpu/ops/subspace.py`` (Rendle et al., "iALS++: Speeding up
Matrix Factorization with Subspace Optimization", and its explicit ALS-WR
analog ALS++): instead of solving the full k×k normal equations per entity,
sweep over coordinate blocks of size b and solve a b×b subsystem per entity
per block.

Implicit (c = 1 + α·r, preferences 1, unobserved weight 1):

    A_u = G + Σ_obs (c−1)·f fᵀ + λI,   b_u = Σ_obs c·f,   G = YᵀY

Explicit (ALS-WR): A_u = Σ f fᵀ + λ·n·I, b_u = Σ r·f, no global Gram.
Block update for coordinate block B with current iterate x:

    A_u[B,B] δ = −g_u[B],   g_u = A_u x − b_u,   x[B] += δ

with the per-interaction scores s = fᵀx computed once per sweep and
rank-b updated after each block.  With block_size = k one sweep from any
x0 gives the full solve A⁻¹b.

The sweep's gathered rectangle [E, P, k] is the one place the fixed rows
enter (kernel K5 ``gather_rows`` on CUDA): its Gram blocks, b-side and score
stream all read it, and the score stream is rank-updated across blocks, so
the rectangle has to exist in device memory.  ``in_kernel_gather`` therefore
changes nothing here: the JAX package's sweep swaps ``gather_rows_pallas``
for the identical XLA gather when it is off (``cfk_tpu/ops/subspace.py:
50-79``), and the port writes the same rectangle with K5 on either setting.
The einsums stay PyTorch (float32, TF32 off), as the JAX package left them
to XLA; the b×b solves run through K1 (``regularized_solve_matrix`` /
``regularized_solve``) at k = b, or, with ``fused_epilogue=False``, through
the ridge add and the split dispatch (``ops.solve.dispatch_spd_solve``:
``gauss_solve`` at b ≤ 64), as the JAX sweep passes ``fused=`` on
(``cfk_tpu/ops/subspace.py:158-175``).

``table_dtype`` quantizes the gather table (``ops.quant``): K5 reads the
bf16 rows or int8 codes, with the int8 per-row scale folded into the mask
weight first, and writes the float32 rectangle (the JAX sweep asks
``out_dtype=float32``), so the Gram blocks, the b-side and the score stream
all read the dequantized values; YᵀY sums the same values.
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops import quant
from cfk_tpu_torch.ops.kernels.gram_kernel import gather_rows, gather_rows_plain
from cfk_tpu_torch.ops.solve import (
    global_gram,
    global_gram_blocked,
    regularized_solve,
    regularized_solve_matrix,
    use_kernels,
    walk_buckets,
)


def _sweep_gather(fixed, scale, neighbor_idx, maskf, solver):
    """The gathered rectangle ``fixed[nb]·mask`` [E, P, k] in float32 (K5 on
    CUDA), an int8 table's scale folded into the mask first
    (``cfk_tpu/ops/subspace.py:50-75``)."""
    e, p = neighbor_idx.shape
    gather = (gather_rows if use_kernels(solver, fixed.device)
              else gather_rows_plain)
    wt = quant.fold_scale(maskf, scale, neighbor_idx)
    g = gather(fixed, neighbor_idx.reshape(-1), wt.reshape(-1).contiguous(),
               torch.float32)
    return g.view(e, p, fixed.shape[-1])


def _sweep_rect(
    fixed: torch.Tensor,  # [F, k] fixed-side table
    x: torch.Tensor,  # [E, k] current own-side iterate
    neighbor_idx: torch.Tensor,  # [E, P]
    rating: torch.Tensor,  # [E, P] raw interaction strengths / ratings
    mask: torch.Tensor,  # [E, P] 1 = real
    lam: float,
    alpha: float,
    gram: torch.Tensor | None,  # [k, k] YᵀY over the full fixed side (implicit)
    block_size: int,
    solver: str = "auto",
    count: torch.Tensor | None = None,  # [E] rating counts (explicit: λ·n·I)
    fused_epilogue: bool | None = None,
    scale: torch.Tensor | None = None,  # [F] int8 per-row dequant scales
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """One sweep over all k/block_size coordinate blocks of a rectangle:
    implicit mode when ``gram`` is given, explicit (ALS-WR) when ``count``
    is.  Returns the updated iterate (a new tensor)."""
    implicit = gram is not None
    if implicit == (count is not None):
        raise ValueError("exactly one of gram (implicit) / count (explicit)")
    k = x.shape[-1]
    if k % block_size != 0:
        raise ValueError(f"rank {k} not divisible by block_size {block_size}")
    x = x.to(torch.float32, copy=True)
    maskf = mask.to(torch.float32)
    gathered = _sweep_gather(fixed, scale, neighbor_idx, maskf, solver)
    if implicit:
        conf_m1 = alpha * rating.to(torch.float32) * maskf  # c−1 obs, 0 pad
        c_obs = conf_m1 + maskf  # c at observed, 0 at pad
        eye_b = torch.eye(block_size, dtype=torch.float32, device=x.device)
    else:
        # ALS-WR weighted ridge λ·n, floored at λ·1 for all-padding rows.
        reg_n = lam * count.to(torch.float32).clamp_min(1.0)
    s = torch.einsum("epk,ek->ep", gathered, x)  # scores, once per sweep
    for j in range(k // block_size):
        cols = slice(j * block_size, (j + 1) * block_size)
        f_b = gathered[:, :, cols]  # [E, P, b]
        if implicit:
            w = conf_m1 * s - c_obs  # [E, P]; exactly 0 at padding
            g_b = (x @ gram[:, cols] + lam * x[:, cols]
                   + torch.einsum("epb,ep->eb", f_b, w))
            a_obs = torch.einsum("epb,epc->ebc", f_b * conf_m1[..., None], f_b)
            delta = regularized_solve_matrix(
                a_obs, -g_b, gram[cols, cols] + lam * eye_b, solver,
                fused=fused_epilogue, algo=reg_solve_algo)
        else:
            w = (s - rating.to(torch.float32)) * maskf  # residual at observed
            g_b = (reg_n[:, None] * x[:, cols]
                   + torch.einsum("epb,ep->eb", f_b, w))
            a_obs = torch.einsum("epb,epc->ebc", f_b, f_b)
            delta = regularized_solve(a_obs, -g_b, count, lam, solver,
                                      fused=fused_epilogue,
                                      algo=reg_solve_algo)
        x[:, cols] += delta
        s = s + torch.einsum("epb,eb->ep", f_b, delta)
    return x


def als_pp_half_step(fixed, x_prev, neighbor_idx, rating, mask, count, lam,
                     *, block_size=32, sweeps=1, solver="auto",
                     fused_epilogue=None, reg_solve_algo=None,
                     table_dtype=None):
    """Explicit ALS-WR half-iteration by subspace sweeps (padded layout)."""
    data, scale = quant.quantize_table(fixed, table_dtype)
    for _ in range(sweeps):
        x_prev = _sweep_rect(data, x_prev, neighbor_idx, rating, mask, lam,
                             0.0, None, block_size, solver, count=count,
                             fused_epilogue=fused_epilogue, scale=scale,
                             reg_solve_algo=reg_solve_algo)
    return x_prev


def _warm_bucket_walk(k, x_prev, buckets, chunk_rows, local_entities,
                      bucket_keys, sweep_piece):
    """Warm-started bucket scatter shared by both families' bucketed sweeps:
    the output (plus the trash row) starts from ``x_prev``, every bucket's
    current rows and ``bucket_keys`` arrays go through ``sweep_piece`` (in
    ``chunk_rows`` pieces: the gathered rectangle is materialized, so the
    blocks' cell budget bounds it), and the result is scattered back —
    one pipelined walk over the pieces (``ops.solve.walk_buckets``; the
    sweeps gather inside each piece, so the walk has no side stream).
    Entities in no bucket keep their previous value."""
    out = x_prev.new_zeros((local_entities + 1, k), dtype=torch.float32)
    n = min(x_prev.shape[0], local_entities)
    out[:n] = x_prev[:n].to(torch.float32)
    out = walk_buckets(
        buckets, chunk_rows,
        lambda blk, cur: (cur[blk["entity_local"].long()],)
        + tuple(blk[key] for key in bucket_keys),
        sweep_piece, out)
    return out[:local_entities]


def als_pp_half_step_bucketed(fixed, x_prev, buckets, chunk_rows,
                              local_entities, lam, *, block_size=32,
                              sweeps=1, solver="auto", fused_epilogue=None,
                              reg_solve_algo=None, table_dtype=None):
    """Explicit ALS-WR half-iteration by subspace sweeps over width buckets."""
    data, scale = quant.quantize_table(fixed, table_dtype)

    def sweep_piece(xb, ni, rt, mk, cnt):
        for _ in range(sweeps):
            xb = _sweep_rect(data, xb, ni, rt, mk, lam, 0.0, None,
                             block_size, solver, count=cnt,
                             fused_epilogue=fused_epilogue, scale=scale,
                             reg_solve_algo=reg_solve_algo)
        return xb

    return _warm_bucket_walk(fixed.shape[-1], x_prev, buckets, chunk_rows,
                             local_entities,
                             ("neighbor", "rating", "mask", "count"),
                             sweep_piece)


def ials_pp_half_step(fixed, x_prev, neighbor_idx, rating, mask, lam, alpha,
                      *, gram=None, block_size=32, sweeps=1, solver="auto",
                      fused_epilogue=None, reg_solve_algo=None,
                      table_dtype=None):
    """iALS++ half-iteration over the padded rectangle layout."""
    data, scale = quant.quantize_table(fixed, table_dtype)
    if gram is None:
        gram = global_gram(quant.dequantize_table(data, scale))
    for _ in range(sweeps):
        x_prev = _sweep_rect(data, x_prev, neighbor_idx, rating, mask, lam,
                             alpha, gram, block_size, solver,
                             fused_epilogue=fused_epilogue, scale=scale,
                             reg_solve_algo=reg_solve_algo)
    return x_prev


def ials_pp_half_step_bucketed(fixed, x_prev, buckets, chunk_rows,
                               local_entities, lam, alpha, *, gram=None,
                               block_size=32, sweeps=1, solver="auto",
                               fused_epilogue=None, reg_solve_algo=None,
                               table_dtype=None):
    """iALS++ half-iteration over width-bucketed InBlocks: each rated entity
    lives in exactly one bucket, so the sweep runs per bucket rectangle and
    scatters back."""
    data, scale = quant.quantize_table(fixed, table_dtype)
    if gram is None:
        gram = global_gram_blocked(quant.dequantize_table(data, scale))

    def sweep_piece(xb, ni, rt, mk):
        for _ in range(sweeps):
            xb = _sweep_rect(data, xb, ni, rt, mk, lam, alpha, gram,
                             block_size, solver,
                             fused_epilogue=fused_epilogue, scale=scale,
                             reg_solve_algo=reg_solve_algo)
        return xb

    return _warm_bucket_walk(fixed.shape[-1], x_prev, buckets, chunk_rows,
                             local_entities, ("neighbor", "rating", "mask"),
                             sweep_piece)
