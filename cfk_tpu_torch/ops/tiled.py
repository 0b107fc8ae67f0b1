"""Tiled-layout half-steps: the accum and dense-stream modes.

The port of ``cfk_tpu/ops/tiled.py`` on its production route (in-kernel
gather, fused epilogue).  Both modes compute the same per-entity normal
equations as ``ops.solve`` (``processors/MFeatureCalculator.java:85-99``):

- ``accum`` (the few-entities side; the movie half at Netflix shape):
  every chunk's per-entity Grams come from kernel K2 (``gram_gather``) with
  ABSOLUTE table indices (the device setup rebases the builder's
  slice-local ones once), are summed into one [E+1, k, k] accumulator by
  ``index_add_``, and the accumulator is solved once at the end by K1.
  The TPU route's window stack (a workaround for XLA's operand-size gather
  cliff, ``ops/tiled.py:1075-1141``) has no counterpart: the kernel reads
  table rows by index.
- ``dstream`` (the many-entities side): chunk by chunk, kernel K3
  (``gram_solve_dense``) gathers, accumulates, folds the previous chunk's
  carried partial into segment 0, returns the raw (A, b) of the chunk's
  last segment as the next carry, and solves — the Gram never reaches
  device memory.  Finalized rows are scattered by ``chunk_entity`` once,
  after the loop.

Implicit feedback (``ials_tiled_half_step``) runs both modes with the
shared YᵀY + λI ridge in matrix mode (``implicit_reg``) and the sqrt
reparameterization of the confidence weights: one weighted stream
gs = √(α·r)·f — K2's ``wt`` in accum mode, K3's stream-aligned ``wt`` in
dense mode — with the b-coefficients rescaled to c/√(α·r).

The chunk scans are plain Python loops (``lax.scan``/``prefetch_scan`` on
the TPU route).  The padded ``stream`` mode is a later slice.
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops.bucketed import _SQRT_WEIGHT_EPS, ials_reparam
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gram_gather,
    gram_gather_plain,
    gram_solve_dense,
    gram_solve_dense_plain,
)
from cfk_tpu_torch.ops.solve import (
    global_gram,
    implicit_reg as implicit_ridge,
    regularized_solve,
    regularized_solve_matrix,
    use_kernels,
)


def chunk_reg(chunk_count: torch.Tensor, num_chunks: int) -> torch.Tensor:
    """The fused epilogue's per-chunk regularizer counts [NC, Ec+1]: the
    finalized rows' rating counts and the trash row floored at 1 — the
    ``_chunk_reg`` of ``cfk_tpu/ops/tiled.py:296-305`` for every chunk."""
    cnt = chunk_count.view(num_chunks, -1).to(torch.float32)
    return torch.cat([cnt, cnt.new_ones(num_chunks, 1)], dim=1)


def accum_chunk(blk, statics, c: int) -> dict:
    """Kernel K2's per-chunk operands of accum chunk ``c`` (views)."""
    _nc, cap, t, _h, e_c = statics
    nt = cap // t
    rows = slice(c * cap, (c + 1) * cap)
    return dict(nb=blk["neighbor_idx"][rows], wt=blk["weight"][rows],
                rt=blk["rating"][rows], seg=blk["tile_seg"][c * nt:(c + 1) * nt],
                num_segments=e_c + 1, tile_rows=t)


def dense_chunk(blk, statics, c: int) -> dict:
    """Kernel K3's per-chunk operands of dense-stream chunk ``c`` (views;
    the carry pair comes from the previous chunk's call)."""
    _nc, cap, e_c, t, nt, ng, bg = statics
    mw = ng + 4 * nt
    return dict(nb=blk["neighbor_idx"][c * cap:(c + 1) * cap], wt=None,
                rt=blk["rating"][c * nt * t:(c + 1) * nt * t],
                meta=blk["tile_meta"][c * mw:(c + 1) * mw],
                reg=blk["chunk_reg"][c], lseg=blk["last_seg"][c:c + 1],
                cin=blk["carry_in"][c:c + 1], num_segments=e_c + 1,
                tile_rows=t, num_tiles=nt, num_groups=ng, block_rows=bg)


def tiled_half_step(fixed_factors, blk, chunks, local_entities, lam, *,
                    solver="auto", implicit_reg=None):
    """Mode dispatch: ``chunks`` is the static tuple ``("tiled", mode,
    *statics)`` and ``blk`` the device dict of ``models.als._tiled_to_device``.
    ``implicit_reg`` = the iALS [k,k] ridge YᵀY + λI (matrix mode; ``blk``
    then carries the reparameterized weights), None = ALS-WR's λ·n."""
    mode = chunks[1]
    st = tuple(chunks[2:])
    kw = dict(statics=st, solver=solver, implicit_reg=implicit_reg)
    if mode == "accum":
        return als_half_step_tiled_accum(fixed_factors, blk, local_entities,
                                         lam, **kw)
    if mode == "dstream":
        return als_half_step_tiled_dense(fixed_factors, blk, local_entities,
                                         lam, **kw)
    raise NotImplementedError(
        f"tiled mode {mode!r} is not ported yet: the padded tiled stream "
        "mode (and its gram_solve_tiles_gather kernel) is a later slice"
    )


def accum_grams(
    fixed_factors: torch.Tensor,  # [F, k] full fixed side
    blk: dict,  # neighbor_idx (ABSOLUTE rows, F = zero row), rating, weight,
    # tile_seg (chunk-dense rank, trash = Ec), chunk_entity (trash = E)
    local_entities: int,
    *,
    statics: tuple[int, int, int, int, int],  # (NC, C, T, H, Ec)
    solver: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """The accum side's summed normal equations (A [E, k, k], b [E, k]):
    K2 per chunk, folded into one accumulator by ``index_add_``."""
    nc, _cap, _t, _h, e_c = statics
    k = fixed_factors.shape[-1]
    gram = (gram_gather if use_kernels(solver, fixed_factors.device)
            else gram_gather_plain)
    acc_a = fixed_factors.new_zeros(local_entities + 1, k, k)
    acc_b = fixed_factors.new_zeros(local_entities + 1, k)
    ent = blk["chunk_entity"].long().view(nc, e_c)
    for c in range(nc):
        a, b = gram(fixed_factors, **accum_chunk(blk, statics, c))
        # Ranks owning no tile are zero rows routed to the trash row E by
        # chunk_entity; the trash segment a[e_c] is dropped.
        acc_a.index_add_(0, ent[c], a[:e_c])
        acc_b.index_add_(0, ent[c], b[:e_c])
    return acc_a[:local_entities], acc_b[:local_entities]


def als_half_step_tiled_accum(
    fixed_factors: torch.Tensor,  # [F, k] full fixed side
    blk: dict,  # accum_grams' operands and count
    local_entities: int,
    lam: float,
    *,
    statics: tuple[int, int, int, int, int],  # (NC, C, T, H, Ec)
    solver: str = "auto",
    implicit_reg: torch.Tensor | None = None,  # [k,k] YᵀY + λI (iALS)
) -> torch.Tensor:
    """Accumulator-mode half-iteration: K2 per chunk, one K1 solve (λ·n
    diag, or the shared ``implicit_reg`` in matrix mode)."""
    a, b = accum_grams(fixed_factors, blk, local_entities, statics=statics,
                       solver=solver)
    if implicit_reg is None:
        return regularized_solve(a, b, blk["count"], lam, solver)
    return regularized_solve_matrix(a, b, implicit_reg, solver)


def als_half_step_tiled_dense(
    fixed_factors: torch.Tensor,  # [F, k] full fixed side
    blk: dict,  # neighbor_idx (dense stream, pad → F), rating (TILE-aligned),
    # tile_meta, chunk_entity (trash = E), chunk_reg, carry_in, last_seg
    local_entities: int,
    lam: float,
    *,
    statics: tuple[int, int, int, int, int, int, int],  # (NC,C,Ec,T,NT,NG,BG)
    solver: str = "auto",
    implicit_reg: torch.Tensor | None = None,  # [k,k] YᵀY + λI (iALS)
) -> torch.Tensor:
    """Dense-stream half-iteration: K3 per chunk, carry threaded across.
    With ``implicit_reg`` (iALS) each chunk gathers the weighted stream
    ``aweight_dense`` and solves against the shared ridge (matrix mode) —
    ``_chunk_reg`` of ``cfk_tpu/ops/tiled.py:296``."""
    nc, cap, e_c = statics[:3]
    k = fixed_factors.shape[-1]
    if implicit_reg is not None and "aweight_dense" not in blk:
        raise ValueError(
            "weighted dense-stream half-step needs aweight_dense (the "
            "per-entry A-weights aligned with the gather stream)"
        )
    fused = (gram_solve_dense if use_kernels(solver, fixed_factors.device)
             else gram_solve_dense_plain)
    a0 = fixed_factors.new_zeros(k, k)
    b0 = fixed_factors.new_zeros(k)
    xs = fixed_factors.new_empty(nc, e_c, k)
    reg_mode = "diag" if implicit_reg is None else "matrix"
    for c in range(nc):
        args = dense_chunk(blk, statics, c)
        cin = args.pop("cin")
        if implicit_reg is not None:
            args["wt"] = blk["aweight_dense"][c * cap:(c + 1) * cap]
            args["reg"] = implicit_reg
        x, a0, b0 = fused(fixed_factors, **args, lam=lam, reg_mode=reg_mode,
                          carry=(a0, b0, cin))
        xs[c] = x[:e_c]
    # Non-finalized positions all route to the trash row E (dropped).
    out = fixed_factors.new_zeros(local_entities + 1, k)
    out[blk["chunk_entity"].long()] = xs.view(nc * e_c, k)
    return out[:local_entities]


def ials_tiled_weights(blk: dict, mode: str, alpha: float) -> dict:
    """The sqrt reparameterization of ``cfk_tpu/ops/tiled.py:445`` on a
    tiled half's device dict (a new dict; ``blk`` is not modified).

    The kernels then gather ONE weighted stream gs = √(α·r)·f, so
    Σ gs gsᵀ = Σ α·r·f fᵀ, and the b-coefficient becomes c/√(α·r)
    (ε-clamped: exact in b at α·r = 0).  Accum mode: the tile-aligned
    ``weight`` becomes √(α·r)·mask (the mask survives the clamp); dense
    mode: the stream-aligned ``aweight_dense`` = √(α·r) from
    ``rating_dense``."""
    blk = dict(blk)
    if mode == "dstream" and ("rating_dense" not in blk
                              or "weight" not in blk):
        raise ValueError(
            "iALS on dense-stream blocks needs the weighted channels "
            "(rating_dense + tile-aligned weight); this dataset was "
            "staged without them — use the iALS device setup "
            "(weighted=True) or rebuild"
        )
    wt, blk["rating"] = ials_reparam(blk["rating"], blk["weight"], alpha)
    if mode == "dstream":
        blk["aweight_dense"] = torch.sqrt(torch.clamp_min(
            alpha * blk["rating_dense"], _SQRT_WEIGHT_EPS))
    else:
        blk["weight"] = wt
    return blk


def ials_tiled_half_step(fixed_factors, blk, chunks, local_entities, lam,
                         alpha, *, gram=None, solver="auto"):
    """Implicit-feedback (Hu et al. 2008) half-iteration on tiled blocks:
    per entity A = YᵀY + Σ_obs (c−1)·f fᵀ + λI, b = Σ_obs c·f, c = 1 + α·r,
    through the reparameterized weights of ``ials_tiled_weights`` and the
    shared ridge in matrix mode.  Negative strengths are refused by the
    trainer (``models.ials``)."""
    if gram is None:
        gram = global_gram(fixed_factors)
    return tiled_half_step(fixed_factors,
                           ials_tiled_weights(blk, chunks[1], alpha), chunks,
                           local_entities, lam, solver=solver,
                           implicit_reg=implicit_ridge(gram, lam))
