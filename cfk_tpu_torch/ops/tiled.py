"""Tiled-layout half-steps: the accum, stream and dense-stream modes.

The port of ``cfk_tpu/ops/tiled.py``, with the fused epilogue (the default)
or the split one (``fused_epilogue=False``), and with the neighbor gather
inside the Gram kernels (the default) or materialized first
(``in_kernel_gather=False``, ``resolve_gather_mode``: K5 ``gather_rows``
writes each chunk's stream g = table[nb]·wt, and the stream twins of the
kernels named below read it — ``gram_tiles`` for K2, ``gram_solve_tiles``
for K6, ``gram_solve_tiles_dense`` for K3, ``gram_tiles_dense`` for
``gram_tiles_dense_gather``).  All modes compute the same per-entity normal
equations as ``ops.solve`` (``processors/MFeatureCalculator.java:85-99``):

- ``accum`` (the few-entities side; the movie half at Netflix shape):
  every chunk's per-entity Grams come from kernel K2 (``gram_gather``) with
  ABSOLUTE table indices (the device setup rebases the builder's
  slice-local ones once), are summed into one [E+1, k, k] accumulator by
  ``index_add_``, and the accumulator is solved once at the end: by K1, or,
  split, by the ridge add + the split solve dispatch
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

A quantized gather table (``table_dtype``, ``quantize_tiled_operand``) is
read by every kernel of both schedules as it is stored — bf16 rows, or int8
codes whose per-row scale is folded into the mode's weight stream — with
float32 sums; K5 writes a bf16 stream for a bf16 table, f32 for int8.

The chunk scans are ``ops.pipeline.prefetch_scan``s, as on the TPU route
(``overlap``, on by default): with the gather off each chunk's K5 stream is
the fetch, written on a side stream into one of two buffers while the
previous chunk's Gram runs; with the gather inside the kernels the fetch is
the chunk's slices.  ``overlap=False`` keeps the K5 fetch on the current
stream: the serial schedule, the same calls in the same order on one
stream, the same bits.
"""

from __future__ import annotations

import torch

from cfk_tpu_torch.ops import quant
from cfk_tpu_torch.ops.bucketed import _SQRT_WEIGHT_EPS, ials_reparam
from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gather_rows,
    gather_rows_plain,
    gram_gather,
    gram_gather_plain,
    gram_solve_dense,
    gram_solve_dense_plain,
    gram_solve_gather,
    gram_solve_gather_plain,
    gram_solve_tiles,
    gram_solve_tiles_dense,
    gram_solve_tiles_dense_plain,
    gram_solve_tiles_plain,
    gram_tiles,
    gram_tiles_dense,
    gram_tiles_dense_gather,
    gram_tiles_dense_gather_plain,
    gram_tiles_dense_plain,
    gram_tiles_plain,
    stream_dtype,
)
from cfk_tpu_torch.ops.pipeline import fetch_stream, prefetch_scan
from cfk_tpu_torch.ops.solve import (
    global_gram,
    implicit_reg as implicit_ridge,
    regularized_solve,
    regularized_solve_matrix,
    resolve_fused_chunk,
    use_kernels,
)


def resolve_gather_mode(in_kernel_gather: bool | None) -> str:
    """Who fetches a chunk's neighbor rows: ``"fused"`` (None/True, the
    default — the Gram kernels read the table by index) or ``"xla"``
    (False — the materialized-stream schedule: K5 writes the [C, k] stream,
    the stream twins read it); the knob half of
    ``cfk_tpu/plan/registry.py:291-320``.

    The TPU gates that route a refused shape to the stream there — the
    resident-output VMEM cap, the kernels' SMEM/alignment gate, the
    ``mosaic_tpu`` backend's availability, the probe stages — have no
    counterpart: both routes' kernels take every rank their schedule runs
    at, on either setting — the fused Gram + solve kernels up to 128, the
    split Gram kernels any rank (past 128 every chunk takes the split
    schedule, ``resolve_fused_chunk``)."""
    return "fused" if in_kernel_gather is None or in_kernel_gather else "xla"


# (mode, gather) → ((fused Gram + solve, its plain version),
#                   (split Gram, its plain version)) of a chunk scan.
_SCAN_KERNELS = {
    ("stream", "fused"): ((gram_solve_gather, gram_solve_gather_plain),
                          (gram_gather, gram_gather_plain)),
    ("stream", "xla"): ((gram_solve_tiles, gram_solve_tiles_plain),
                        (gram_tiles, gram_tiles_plain)),
    ("dstream", "fused"): ((gram_solve_dense, gram_solve_dense_plain),
                           (gram_tiles_dense_gather,
                            gram_tiles_dense_gather_plain)),
    ("dstream", "xla"): ((gram_solve_tiles_dense,
                          gram_solve_tiles_dense_plain),
                         (gram_tiles_dense, gram_tiles_dense_plain)),
}


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


def quantize_tiled_operand(fixed_factors, blk, chunks, table_dtype):
    """(table, blk): the gather table of a tiled half-step in
    ``table_dtype`` (the f32 identity, the bf16 cast, int8 codes) and the
    device dict with the int8 per-row scale folded into the mode's weight
    stream — ``quant.fold_scale`` first, then the one g = data[nb]·wt
    multiply, the order every gather route shares
    (``cfk_tpu/ops/tiled.py:323-370``).  Accum and stream: the tile-aligned
    ``weight`` (the 0/1 mask, or √aw·mask for iALS); the indices are
    already absolute rows with F as the zero row (the device setup rebased
    them), so the fold indexes them directly.  Dense stream: the
    stream-aligned ``aweight_dense``, synthesized as ones for explicit ALS,
    which has no weight channel (dense padding indexes the zero row, whose
    appended scale is 0)."""
    data, scale = quant.quantize_table(fixed_factors, table_dtype)
    if scale is None:
        return data, blk
    blk = dict(blk)
    nb = blk["neighbor_idx"]
    if chunks[1] == "dstream":
        wt = blk.get("aweight_dense")
        if wt is None:
            wt = torch.ones(nb.shape, dtype=torch.float32, device=nb.device)
        blk["aweight_dense"] = quant.fold_scale(wt, scale, nb)
    else:
        blk["weight"] = quant.fold_scale(blk["weight"], scale, nb)
    return data, blk


def tiled_half_step(fixed_factors, blk, chunks, local_entities, lam, *,
                    solver="auto", implicit_reg=None, fused_epilogue=None,
                    in_kernel_gather=None, reg_solve_algo=None,
                    table_dtype=None, overlap=None):
    """Mode dispatch: ``chunks`` is the static tuple ``("tiled", mode,
    *statics)`` and ``blk`` the device dict of ``models.als._tiled_to_device``.
    ``implicit_reg`` = the iALS [k,k] ridge YᵀY + λI (matrix mode; ``blk``
    then carries the reparameterized weights), None = ALS-WR's λ·n.
    ``fused_epilogue`` = the fused (None/True) or split (False) schedule;
    ``in_kernel_gather`` = the gather inside the kernels (None/True) or the
    materialized stream (False, ``resolve_gather_mode``);
    ``reg_solve_algo`` = the fused route's rank cap (``ops.solve.
    fused_rank_cap``); ``table_dtype`` = the gather table's dtype
    (``quantize_tiled_operand``; the solved rows are float32); ``overlap``
    = the pipelined chunk scan (None/True) or the serial one (False)."""
    half = {"accum": als_half_step_tiled_accum,
            "stream": als_half_step_tiled,
            "dstream": als_half_step_tiled_dense}.get(chunks[1])
    if half is None:
        raise ValueError(f"unknown tiled mode {chunks[1]!r}")
    table, blk = quantize_tiled_operand(fixed_factors, blk, chunks,
                                        table_dtype)
    return half(table, blk, local_entities, lam,
                statics=tuple(chunks[2:]), solver=solver,
                implicit_reg=implicit_reg, fused_epilogue=fused_epilogue,
                in_kernel_gather=in_kernel_gather,
                reg_solve_algo=reg_solve_algo, overlap=overlap)


def _chunk_fetch(fixed_factors, operands, gather_fn, overlap):
    """A chunk scan's fetch and the stream it runs on.  ``operands(c)`` is
    chunk c's dict of views (``nb``, ``wt``, …).  Without ``gather_fn``
    (the gather inside the kernels) the fetch is those views, on the
    current stream.  With it (the materialized-stream schedule) the fetch
    also runs K5 (``gather_fn``), writing the chunk's [C, k] stream into
    buffer ``c % 2`` of a double buffer allocated here, on the current
    stream, before the scan, and runs on a side stream
    (``ops.pipeline.prefetch_scan``'s contract).  Returns ``(fetch,
    stream)``; ``fetch(c) -> (g or None, operands)``."""
    if gather_fn is None:
        return (lambda c: (None, operands(c))), None
    cap = operands(0)["nb"].shape[0]
    bufs = [fixed_factors.new_empty((cap, fixed_factors.shape[-1]),
                                    dtype=stream_dtype(fixed_factors))
            for _ in range(2)]

    def fetch(c):
        args = operands(c)
        return gather_fn(fixed_factors, args["nb"], args["wt"],
                         out=bufs[c % 2]), args

    return fetch, fetch_stream(fixed_factors.device, overlap)


def _chunk_scan(fixed_factors, blk, local_entities, lam, nc, e_c, chunk,
                mode, *, solver, implicit_reg, fused_epilogue,
                in_kernel_gather, reg_solve_algo=None, overlap=None,
                return_chunk_rows=False):
    """The stream and dense-stream chunk scans: ``chunk(c)`` gives chunk
    c's operands (with its ridge counts ``reg``, carry-out row ``lseg``
    and carry flag ``cin``); per chunk the fused kernel returns (x, carry
    pair), or, split, the Gram kernel writes (A, b), K1 solves them in one
    pass (``fused=True``: the epilogue knob toggles only the Gram's round
    trip through device memory, ``cfk_tpu/ops/tiled.py:640-652``) and the
    carry row is taken by index on the device, without a host sync.  On
    the materialized-stream schedule each chunk's (nb, wt) first become
    its stream g = table[nb]·wt (K5, the scan's fetch), which the stream
    twins read (``_SCAN_KERNELS``).  Finalized rows [NC, Ec, k] are
    scattered by ``chunk_entity`` once, after the loop; non-finalized
    positions all route to the trash row E (dropped).  ``return_chunk_rows``
    returns the unscattered [NC·Ec, k] rows instead (the out-of-core
    windows scatter them into the host store themselves)."""
    k = fixed_factors.shape[-1]
    fused = resolve_fused_chunk(fused_epilogue, k, reg_solve_algo)
    gather = resolve_gather_mode(in_kernel_gather)
    pick = 0 if use_kernels(solver, fixed_factors.device) else 1
    solve_gram, gram = (fns[pick] for fns in _SCAN_KERNELS[mode, gather])
    reg_mode = "diag" if implicit_reg is None else "matrix"
    f32 = dict(dtype=torch.float32)
    xs = fixed_factors.new_empty((nc, e_c, k), **f32)
    fetch, stream = _chunk_fetch(
        fixed_factors, chunk,
        (gather_rows, gather_rows_plain)[pick] if gather == "xla" else None,
        overlap)

    def compute(carry, buf, _x, c):
        a0, b0 = carry
        g, args = buf
        args = dict(args, units=chunk_plan(blk, c))
        cin, lseg, reg = args.pop("cin"), args.pop("lseg"), args.pop("reg")
        if implicit_reg is not None:
            reg = implicit_reg
        rows = fixed_factors
        if g is not None:
            del args["nb"], args["wt"]
            rows = g
        if fused:
            x, a0, b0 = solve_gram(rows, **args, reg=reg, lseg=lseg, lam=lam,
                                   reg_mode=reg_mode, carry=(a0, b0, cin))
        else:
            a, b = gram(rows, **args, carry=(a0, b0, cin))
            # The raw carry row first: above k = 128 the solve adds the
            # ridge into ``a`` in place.
            ls = lseg.long()
            a0, b0 = a.index_select(0, ls)[0], b.index_select(0, ls)[0]
            if implicit_reg is None:
                x = regularized_solve(a, b, reg, lam, solver, fused=True,
                                      algo=reg_solve_algo)
            else:
                x = regularized_solve_matrix(a, b, reg, solver, fused=True,
                                             algo=reg_solve_algo)
        xs[c] = x[:e_c]
        return (a0, b0), None

    init = (fixed_factors.new_zeros((k, k), **f32),
            fixed_factors.new_zeros((k,), **f32))
    prefetch_scan(fetch, compute, nc, init, stream=stream)
    if return_chunk_rows:
        return xs.view(nc * e_c, k)
    out = fixed_factors.new_zeros((local_entities + 1, k), **f32)
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
    in_kernel_gather: bool | None = None,
    overlap: bool | None = None,
    chunk_range: tuple[int, int] | None = None,
    acc: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The accum side's summed normal equations (A [E, k, k], b [E, k]):
    K2 per chunk (materialized stream: K5, the scan's fetch, then
    ``gram_tiles``), folded into one accumulator by ``index_add_``.  The
    table indices are absolute, so the stream is K5 over the whole table:
    the TPU route's per-slice gather windows (``ops/tiled.py:1083-1140``)
    have no counterpart on either schedule.

    ``chunk_range=(lo, hi)`` walks chunks lo..hi-1 only, into ``acc`` (the
    caller's [E+1, k, k] and [E+1, k] accumulators, the trash row last):
    one slice of a ring visit (``parallel.spmd``), whose indices are local
    to the rotated block ``fixed_factors`` (its height = the zero row)."""
    nc, _cap, _t, _h, e_c = statics
    lo, hi = (0, nc) if chunk_range is None else chunk_range
    k = fixed_factors.shape[-1]
    kernels = use_kernels(solver, fixed_factors.device)
    xla = resolve_gather_mode(in_kernel_gather) == "xla"
    if acc is None:
        acc = (fixed_factors.new_zeros((local_entities + 1, k, k),
                                       dtype=torch.float32),
               fixed_factors.new_zeros((local_entities + 1, k),
                                       dtype=torch.float32))
    acc_a, acc_b = acc
    ent = blk["chunk_entity"].long().view(nc, e_c)

    fetch, stream = _chunk_fetch(
        fixed_factors, lambda c: accum_chunk(blk, statics, lo + c),
        (gather_rows if kernels else gather_rows_plain) if xla else None,
        overlap)

    def compute(carry, buf, _x, c):
        c = lo + c
        g, args = buf
        args = dict(args, units=chunk_plan(blk, c))
        if g is not None:
            del args["nb"], args["wt"]
            a, b = (gram_tiles if kernels else gram_tiles_plain)(g, **args)
        else:
            a, b = (gram_gather if kernels else gram_gather_plain)(
                fixed_factors, **args)
        # Ranks owning no tile are zero rows routed to the trash row E by
        # chunk_entity; the trash segment a[e_c] is dropped.
        acc_a.index_add_(0, ent[c], a[:e_c])
        acc_b.index_add_(0, ent[c], b[:e_c])
        return carry, None

    if hi > lo:
        prefetch_scan(fetch, compute, hi - lo, None, stream=stream)
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
    in_kernel_gather: bool | None = None,
    reg_solve_algo: str | None = None,
    overlap: bool | None = None,
) -> torch.Tensor:
    """Accumulator-mode half-iteration: K2 per chunk (or K5 + ``gram_tiles``
    with ``in_kernel_gather=False``), then one solve of the accumulator
    (λ·n diag, or the shared ``implicit_reg`` in matrix mode): K1 fused;
    split (or past ``reg_solve_algo``'s cap), the ridge added in place and
    the split solve dispatch (``cfk_tpu/ops/tiled.py:1250-1266``)."""
    a, b = accum_grams(fixed_factors, blk, local_entities, statics=statics,
                       solver=solver, in_kernel_gather=in_kernel_gather,
                       overlap=overlap)
    if implicit_reg is None:
        return regularized_solve(a, b, blk["count"], lam, solver,
                                 fused=fused_epilogue, algo=reg_solve_algo)
    return regularized_solve_matrix(a, b, implicit_reg, solver,
                                    fused=fused_epilogue,
                                    algo=reg_solve_algo)


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
    in_kernel_gather: bool | None = None,
    reg_solve_algo: str | None = None,
    overlap: bool | None = None,
    return_chunk_rows: bool = False,
) -> torch.Tensor:
    """Stream-mode half-iteration (``cfk_tpu/ops/tiled.py:529``): per
    chunk K6 (fused) or K2 then K1 (split) — on the materialized stream
    ``gram_solve_tiles`` or ``gram_tiles`` then K1 — the carry threaded
    across chunks; one scatter by ``chunk_entity`` after the loop (or, with
    ``return_chunk_rows``, the per-chunk rows unscattered)."""
    return _chunk_scan(
        fixed_factors, blk, local_entities, lam, statics[0], statics[2],
        lambda c: stream_chunk(blk, statics, c), "stream",
        solver=solver, implicit_reg=implicit_reg,
        fused_epilogue=fused_epilogue, in_kernel_gather=in_kernel_gather,
        reg_solve_algo=reg_solve_algo, overlap=overlap,
        return_chunk_rows=return_chunk_rows)


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
    in_kernel_gather: bool | None = None,
    reg_solve_algo: str | None = None,
    overlap: bool | None = None,
) -> torch.Tensor:
    """Dense-stream half-iteration: K3 per chunk (fused), or
    ``gram_tiles_dense_gather`` then K1 (split), carry threaded across; on
    the materialized stream ``gram_solve_tiles_dense`` or
    ``gram_tiles_dense`` then K1.  With ``implicit_reg`` (iALS) each chunk
    gathers the weighted stream ``aweight_dense`` and solves against the
    shared ridge (matrix mode) — ``_chunk_reg`` of
    ``cfk_tpu/ops/tiled.py:296``."""
    nc, cap, e_c = statics[:3]
    if implicit_reg is not None and "aweight_dense" not in blk:
        raise ValueError(
            "weighted dense-stream half-step needs aweight_dense (the "
            "per-entry A-weights aligned with the gather stream)"
        )

    def chunk(c):
        args = dense_chunk(blk, statics, c)
        if "aweight_dense" in blk:
            args["wt"] = blk["aweight_dense"][c * cap:(c + 1) * cap]
        return args

    return _chunk_scan(
        fixed_factors, blk, local_entities, lam, nc, e_c, chunk, "dstream",
        solver=solver, implicit_reg=implicit_reg,
        fused_epilogue=fused_epilogue, in_kernel_gather=in_kernel_gather,
        reg_solve_algo=reg_solve_algo, overlap=overlap)


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
                         fused_epilogue=None, in_kernel_gather=None,
                         reg_solve_algo=None, table_dtype=None,
                         overlap=None):
    """Implicit-feedback (Hu et al. 2008) half-iteration on tiled blocks:
    per entity A = YᵀY + Σ_obs (c−1)·f fᵀ + λI, b = Σ_obs c·f, c = 1 + α·r,
    through the reparameterized weights of ``ials_tiled_weights`` and the
    shared ridge in matrix mode.  YᵀY sums the rows the kernels read
    (``quant.gather_operand_view`` of ``table_dtype``,
    ``cfk_tpu/ops/tiled.py:473-482``).  Negative strengths are refused by
    the trainer (``models.ials``)."""
    if gram is None:
        gram = global_gram(quant.gather_operand_view(fixed_factors,
                                                     table_dtype))
    return tiled_half_step(fixed_factors,
                           ials_tiled_weights(blk, chunks[1], alpha), chunks,
                           local_entities, lam, solver=solver,
                           implicit_reg=implicit_ridge(gram, lam),
                           fused_epilogue=fused_epilogue,
                           in_kernel_gather=in_kernel_gather,
                           reg_solve_algo=reg_solve_algo,
                           table_dtype=table_dtype, overlap=overlap)
