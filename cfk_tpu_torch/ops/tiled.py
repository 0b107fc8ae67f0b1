"""Tiled-layout half-steps: the accum, stream and dense-stream modes.

The port of ``cfk_tpu/ops/tiled.py`` on its in-kernel-gather route, with
the fused epilogue (the default) or the split one (``fused_epilogue=
False``).  All modes compute the same per-entity normal equations as
``ops.solve`` (``processors/MFeatureCalculator.java:85-99``):

- ``accum`` (the few-entities side; the movie half at Netflix shape):
  every chunk's per-entity Grams come from kernel K2 (``gram_gather``) with
  ABSOLUTE table indices (the device setup rebases the builder's
  slice-local ones once), are summed into one [E+1, k, k] accumulator by
  ``index_add_``, and the accumulator is solved once at the end: by K1, or,
  split, by the ridge add + Gauss-Jordan dispatch
  (``ops.solve.dispatch_spd_solve``).
  The TPU route's window stack (a workaround for XLA's operand-size gather
  cliff, ``ops/tiled.py:1075-1141``) has no counterpart: the kernel reads
  table rows by index.
- ``dstream`` (the many-entities side): chunk by chunk, kernel K3
  (``gram_solve_dense``) gathers, accumulates, folds the previous chunk's
  carried partial into segment 0, returns the raw (A, b) of the chunk's
  last segment as the next carry, and solves — the Gram never reaches
  device memory.  Split: ``gram_tiles_dense_gather`` writes the chunk's
  (A, b), K1 solves it, and the carry row is taken by index on the device.
  Finalized rows are scattered by ``chunk_entity`` once, after the loop.
- ``stream`` (the many-entities side, entity runs padded to whole tiles):
  the same chunk scan through K6 (``gram_solve_gather``), or, split, K2
  then K1.

Implicit feedback (``ials_tiled_half_step``) runs both modes with the
shared YᵀY + λI ridge in matrix mode (``implicit_reg``) and the sqrt
reparameterization of the confidence weights: one weighted stream
gs = √(α·r)·f — the tile-aligned ``wt`` of K2/K6 in accum and stream mode,
K3's stream-aligned ``wt`` in dense mode — with the b-coefficients
rescaled to c/√(α·r).

The chunk scans are plain Python loops (``lax.scan``/``prefetch_scan`` on
the TPU route).
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops.bucketed import _SQRT_WEIGHT_EPS, ials_reparam
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gram_gather,
    gram_gather_plain,
    gram_solve_dense,
    gram_solve_dense_plain,
    gram_solve_gather,
    gram_solve_gather_plain,
    gram_tiles_dense_gather,
    gram_tiles_dense_gather_plain,
)
from cfk_tpu_torch.ops.solve import (
    global_gram,
    implicit_reg as implicit_ridge,
    regularized_solve,
    regularized_solve_matrix,
    resolve_fused_chunk,
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


def stream_chunk(blk, statics, c: int) -> dict:
    """Kernel K6's per-chunk operands of stream chunk ``c`` (views; the
    carry pair comes from the previous chunk's call)."""
    _nc, cap, e_c, t = statics
    nt = cap // t
    rows = slice(c * cap, (c + 1) * cap)
    return dict(nb=blk["neighbor_idx"][rows], wt=blk["weight"][rows],
                rt=blk["rating"][rows], seg=blk["tile_seg"][c * nt:(c + 1) * nt],
                reg=blk["chunk_reg"][c], lseg=blk["last_seg"][c:c + 1],
                cin=blk["carry_in"][c:c + 1], num_segments=e_c + 1,
                tile_rows=t)


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
                    solver="auto", implicit_reg=None, fused_epilogue=None):
    """Mode dispatch: ``chunks`` is the static tuple ``("tiled", mode,
    *statics)`` and ``blk`` the device dict of ``models.als._tiled_to_device``.
    ``implicit_reg`` = the iALS [k,k] ridge YᵀY + λI (matrix mode; ``blk``
    then carries the reparameterized weights), None = ALS-WR's λ·n.
    ``fused_epilogue`` = the fused (None/True) or split (False) schedule."""
    half = {"accum": als_half_step_tiled_accum,
            "stream": als_half_step_tiled,
            "dstream": als_half_step_tiled_dense}.get(chunks[1])
    if half is None:
        raise ValueError(f"unknown tiled mode {chunks[1]!r}")
    return half(fixed_factors, blk, local_entities, lam,
                statics=tuple(chunks[2:]), solver=solver,
                implicit_reg=implicit_reg, fused_epilogue=fused_epilogue)


def _chunk_scan(fixed_factors, blk, local_entities, lam, nc, e_c, chunk,
                solve_gram, gram, *, solver, implicit_reg, fused_epilogue):
    """The stream and dense-stream chunk scans: ``chunk(c)`` gives chunk
    c's operands (with its ridge counts ``reg``, carry-out row ``lseg``
    and carry flag ``cin``); per chunk the fused kernel ``solve_gram``
    returns (x, carry pair), or, split, the Gram kernel ``gram`` writes
    (A, b), K1 solves them in one pass (``fused=True``: the epilogue knob
    toggles only the Gram's round trip through device memory,
    ``cfk_tpu/ops/tiled.py:640-652``) and the carry row is taken by index
    on the device, without a host sync.  Finalized rows [NC, Ec, k] are
    scattered by ``chunk_entity`` once, after the loop; non-finalized
    positions all route to the trash row E (dropped)."""
    k = fixed_factors.shape[-1]
    fused = resolve_fused_chunk(fused_epilogue, k)
    reg_mode = "diag" if implicit_reg is None else "matrix"
    a0 = fixed_factors.new_zeros(k, k)
    b0 = fixed_factors.new_zeros(k)
    xs = fixed_factors.new_empty(nc, e_c, k)
    for c in range(nc):
        args = chunk(c)
        cin, lseg, reg = args.pop("cin"), args.pop("lseg"), args.pop("reg")
        if implicit_reg is not None:
            reg = implicit_reg
        if fused:
            x, a0, b0 = solve_gram(fixed_factors, **args, reg=reg, lseg=lseg,
                                   lam=lam, reg_mode=reg_mode,
                                   carry=(a0, b0, cin))
        else:
            a, b = gram(fixed_factors, **args, carry=(a0, b0, cin))
            if implicit_reg is None:
                x = regularized_solve(a, b, reg, lam, solver, fused=True)
            else:
                x = regularized_solve_matrix(a, b, reg, solver, fused=True)
            ls = lseg.long()
            a0, b0 = a.index_select(0, ls)[0], b.index_select(0, ls)[0]
        xs[c] = x[:e_c]
    out = fixed_factors.new_zeros(local_entities + 1, k)
    out[blk["chunk_entity"].long()] = xs.view(nc * e_c, k)
    return out[:local_entities]


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
    fused_epilogue: bool | None = None,
) -> torch.Tensor:
    """Accumulator-mode half-iteration: K2 per chunk, then one solve of the
    accumulator (λ·n diag, or the shared ``implicit_reg`` in matrix mode):
    K1 fused; split, the ridge added in place and the Gauss-Jordan
    dispatch (``cfk_tpu/ops/tiled.py:1250-1266``)."""
    a, b = accum_grams(fixed_factors, blk, local_entities, statics=statics,
                       solver=solver)
    if implicit_reg is None:
        return regularized_solve(a, b, blk["count"], lam, solver,
                                 fused=fused_epilogue)
    return regularized_solve_matrix(a, b, implicit_reg, solver,
                                    fused=fused_epilogue)


def als_half_step_tiled(
    fixed_factors: torch.Tensor,  # [F, k] full fixed side
    blk: dict,  # neighbor_idx (ABSOLUTE rows, F = zero row), rating, weight,
    # tile_seg (chunk-relative, trash = Ec), chunk_entity (trash = E),
    # chunk_reg, carry_in, last_seg
    local_entities: int,
    lam: float,
    *,
    statics: tuple[int, int, int, int],  # (NC, C, Ec, T)
    solver: str = "auto",
    implicit_reg: torch.Tensor | None = None,  # [k,k] YᵀY + λI (iALS)
    fused_epilogue: bool | None = None,
) -> torch.Tensor:
    """Stream-mode half-iteration (``cfk_tpu/ops/tiled.py:529``): per
    chunk K6 (fused) or K2 then K1 (split), the carry threaded across
    chunks; one scatter by ``chunk_entity`` after the loop."""
    kernels = use_kernels(solver, fixed_factors.device)
    return _chunk_scan(
        fixed_factors, blk, local_entities, lam, statics[0], statics[2],
        lambda c: stream_chunk(blk, statics, c),
        gram_solve_gather if kernels else gram_solve_gather_plain,
        gram_gather if kernels else gram_gather_plain,
        solver=solver, implicit_reg=implicit_reg,
        fused_epilogue=fused_epilogue)


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
    fused_epilogue: bool | None = None,
) -> torch.Tensor:
    """Dense-stream half-iteration: K3 per chunk (fused), or
    ``gram_tiles_dense_gather`` then K1 (split), carry threaded across.
    With ``implicit_reg`` (iALS) each chunk gathers the weighted stream
    ``aweight_dense`` and solves against the shared ridge (matrix mode) —
    ``_chunk_reg`` of ``cfk_tpu/ops/tiled.py:296``."""
    nc, cap, e_c = statics[:3]
    if implicit_reg is not None and "aweight_dense" not in blk:
        raise ValueError(
            "weighted dense-stream half-step needs aweight_dense (the "
            "per-entry A-weights aligned with the gather stream)"
        )
    kernels = use_kernels(solver, fixed_factors.device)

    def chunk(c):
        args = dense_chunk(blk, statics, c)
        if implicit_reg is not None:
            args["wt"] = blk["aweight_dense"][c * cap:(c + 1) * cap]
        return args

    return _chunk_scan(
        fixed_factors, blk, local_entities, lam, nc, e_c, chunk,
        gram_solve_dense if kernels else gram_solve_dense_plain,
        gram_tiles_dense_gather if kernels else gram_tiles_dense_gather_plain,
        solver=solver, implicit_reg=implicit_reg,
        fused_epilogue=fused_epilogue)


def ials_tiled_weights(blk: dict, mode: str, alpha: float) -> dict:
    """The sqrt reparameterization of ``cfk_tpu/ops/tiled.py:445`` on a
    tiled half's device dict (a new dict; ``blk`` is not modified).

    The kernels then gather ONE weighted stream gs = √(α·r)·f, so
    Σ gs gsᵀ = Σ α·r·f fᵀ, and the b-coefficient becomes c/√(α·r)
    (ε-clamped: exact in b at α·r = 0).  Accum and stream mode: the
    tile-aligned ``weight`` becomes √(α·r)·mask (the mask survives the
    clamp); dense mode: the stream-aligned ``aweight_dense`` = √(α·r) from
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
                         alpha, *, gram=None, solver="auto",
                         fused_epilogue=None):
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
                           implicit_reg=implicit_ridge(gram, lam),
                           fused_epilogue=fused_epilogue)
