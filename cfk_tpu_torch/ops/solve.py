"""Batched normal-equation solves on the padded, bucketed and segment
layouts.

The port of ``cfk_tpu/ops/solve.py``'s padded, bucketed and segment paths,
explicit (ALS-WR) and implicit (iALS).  Explicit, per entity

    A = Σ f fᵀ,  b = Σ r·f,  A += λ·n_ratings·I,  x = A⁻¹ b

(``processors/MFeatureCalculator.java:85-99``), for every entity of a side at
once: one gather of neighbor factors into [E, P, k], two float32 einsums for
all Grams and right-hand sides (left to PyTorch, as the JAX package left
them to XLA), then the ridge + solve of kernel K1 (``ops.kernels.
solve_kernel.reg_solve``).  Implicit (Hu et al. 2008), per entity
A = YᵀY + Σ_obs (c−1)·f fᵀ + λI, b = Σ_obs c·f with c = 1 + α·r: the global
Gram YᵀY is one ``torch.matmul`` per half-step and the shared YᵀY + λI ridge
is K1's matrix mode.  The bucketed half-steps walk the width classes and run
each through kernel K6 (``ops.bucketed``); with ``fused_epilogue=False``
through K2 and K1 (the JAX package's split bucket piece).

The split epilogue (``fused=False``) adds the ridge on its own and hands
the system to ``dispatch_spd_solve``: ``gauss_solve`` for k ≤ 64, the
blocked Schur solve (``gauss_solve_multi``, three batched float32
contractions, ``gauss_solve`` on the Schur complement) for 64 < k ≤ 128
(``cfk_tpu/ops/solve.py:310-390``).  Their kernels run K1's blocked
Cholesky, so the split route's x equals the fused route's bit for bit
wherever both add the same ridge to the same sums.  Above k = 128 both
epilogue settings take that split route, as the reference's rank gate
routes them (``cfk_tpu/ops/solve.py:441-443, 480-481``), and the dispatch
solves with ``batched_spd_solve`` — PyTorch's batched Cholesky, the
counterpart of the XLA Cholesky the JAX package falls back to there: it has
no kernel above that rank, so neither has the port.

Gram operands follow the JAX package's compute-dtype rule
(``gram_compute_dtype``, ``cfk_tpu/ops/solve.py:30-51``): a bf16 table (a
``--dtype bfloat16`` master, or a ``--table-dtype bfloat16`` gather table) is
gathered and weighted in bf16 — each weighted product rounded to bf16, as
XLA rounds it — and the einsums run float32 on those values (bf16×bf16
products are exact in float32, TF32 stays off), so the sums equal a
bf16-input, float32-accumulating matrix unit's up to order; f32 and int8
(dequantized to f32 before any product) tables run float32 throughout.

``reg_solve_algo`` ("auto"/"lu"/"gj") picks the fused route's rank cap as in
the reference (``fused_rank_cap``): 128 for "lu" (and "auto"), 64 for "gj",
above which every system takes the split schedule.

``solver`` picks the route of every solve and Gram kernel: ``"auto"`` calls
the kernel wrappers (the CUDA kernels for CUDA tensors, their plain versions
for CPU tensors); ``"cholesky"`` names the plain PyTorch versions
(``torch.linalg.cholesky``) and is accepted for CPU tensors only — a CUDA
tensor always goes through the kernels, so ``"cholesky"`` there raises.  The
counterpart of the JAX package's ``_resolve_solver``
(``cfk_tpu/ops/solve.py:392-395``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cfk_tpu_torch.ops.kernels.solve_kernel import (
    GJ_MAX_RANK,
    MAX_RANK,
    gauss_solve,
    gauss_solve_multi,
    reg_solve,
    reg_solve_plain,
    spd_solve_plain,
)
from cfk_tpu_torch.ops.quant import dequantize_table, quantize_table

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


REG_SOLVE_ALGOS = ("auto", "lu", "gj")


def gram_compute_dtype(table: torch.Tensor) -> torch.dtype:
    """The dtype Gram operands are formed in: bf16 for a bf16 table (each
    weighted product rounded to bf16; the sums float32), float32 for f32
    and for int8 (whose rows are dequantized to f32) — the JAX package's
    ``_gram_compute_dtype`` (``cfk_tpu/ops/solve.py:30-51``)."""
    return torch.bfloat16 if table.dtype == torch.bfloat16 else torch.float32


def fused_rank_cap(algo: str | None = None) -> int:
    """The largest rank the fused reg+solve route takes under ``algo``: 128
    for "lu" and "auto" (the port's default is "lu"), 64 for "gj" — the
    reference's ``_fused_reg_rank_cap`` (``cfk_tpu/ops/pallas/
    solve_kernel.py:277-284``)."""
    if algo not in (None,) + REG_SOLVE_ALGOS:
        raise ValueError(f"reg_solve_algo must be 'lu' or 'gj', got {algo!r}")
    return GJ_MAX_RANK if algo == "gj" else MAX_RANK


# Rows a gathered Gram sums in one product: a wider rectangle is summed in
# blocks of this many rows, each block from zero, the block sums then
# added — the two-level sum of the Gram kernels' work units
# (``ops.kernels.gram_units.UNIT_ROWS``).  One float32 product over a
# million rows (a Zipf-head entity on the legacy schedule) put the solved
# row 2.8e-3 of max|x| from float64 on an H100 at the ML-25M shape; summed
# in 1,024-row blocks as the kernels sum it, 5.5e-5.
GRAM_SUM_ROWS = 1024


def _gram_sums(gw: torch.Tensor, gm: torch.Tensor, coef: torch.Tensor):
    """(Σ_p gw gmᵀ [E,k,k], Σ_p gm·coef [E,k]) over the P rows of each
    entity's float32 rectangles gw, gm [E,P,k] and coef [E,P]: one einsum
    up to ``GRAM_SUM_ROWS`` rows, else per block of that many rows (the
    last zero-padded) with the block sums added."""
    e, p, k = gm.shape
    if p <= GRAM_SUM_ROWS:
        return (torch.einsum("epk,epl->ekl", gw, gm),
                torch.einsum("epk,ep->ek", gm, coef))
    pad = -p % GRAM_SUM_ROWS
    blocks = (p + pad) // GRAM_SUM_ROWS
    gw, gm = (torch.nn.functional.pad(x, (0, 0, 0, pad)).view(
        e, blocks, GRAM_SUM_ROWS, k) for x in (gw, gm))
    coef = torch.nn.functional.pad(coef, (0, pad)).view(e, blocks,
                                                        GRAM_SUM_ROWS)
    return (torch.einsum("ebpk,ebpl->ebkl", gw, gm).sum(1),
            torch.einsum("ebpk,ebp->ebk", gm, coef).sum(1))


def gather_gram(
    fixed_factors: torch.Tensor,  # [F, k] f32 or bf16
    neighbor_idx: torch.Tensor,  # [E, P] int32
    rating: torch.Tensor,  # [E, P] float32 (0 at padding)
    mask: torch.Tensor,  # [E, P] float32 (1 = real)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram matrices A = Σ f fᵀ and RHS b = Σ r·f for every entity:
    (A [E, k, k], b [E, k]) float32; padding contributes zero via the mask.
    The masked rows and the ratings are formed in ``gram_compute_dtype``;
    the sums run in ``GRAM_SUM_ROWS``-row blocks (``_gram_sums``)."""
    ct = gram_compute_dtype(fixed_factors)
    gm = (fixed_factors[neighbor_idx.long()].to(ct)
          * mask[..., None].to(ct)).float()
    return _gram_sums(gm, gm, rating.to(ct).float())


def resolve_fused_epilogue(fused: bool | None) -> bool:
    """The per-call knob if given, else the default: on — every chunk Gram
    kernel solves in place and the accum side's ridge + solve is K1's one
    pass (``cfk_tpu/ops/solve.py:398-413``)."""
    return True if fused is None else bool(fused)


def resolve_fused_chunk(fused: bool | None, k: int,
                        algo: str | None = None) -> bool:
    """Whether a chunk or width class runs its fused Gram + solve kernel
    (K3 for the dense stream, K6 for the stream and the bucketed classes),
    and whether a batch takes K1's one pass: the knob, and a rank within
    ``algo``'s fused cap (``fused_rank_cap``: 128, or 64 for "gj").  A rank
    past it goes to the split schedule, as in ``cfk_tpu/plan/registry.py:
    212-216, 322-360`` and ``cfk_tpu/ops/solve.py:441-443`` — both
    schedules run kernels."""
    return resolve_fused_epilogue(fused) and 1 <= k <= fused_rank_cap(algo)


def batched_spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The SPD solve above k = 128: a [E,k,k], b [E,k] → x [E,k] by
    PyTorch's batched Cholesky (``cholesky_ex``, so a system that is not SPD
    gives a non-finite row, as the kernels do, instead of raising) and two
    batched triangular solves (``solve_triangular``: cuBLAS on the card,
    which a CUDA graph captures — ``cholesky_solve``'s batched route
    allocates device memory inside the library and cannot be captured).
    The counterpart of ``cfk_tpu/ops/solve.py:79-91``, XLA's Cholesky,
    which the JAX package runs at k > 128 outside any Pallas kernel; chosen
    by rank before any launch.  Reads only the lower triangle of ``a``."""
    chol, _ = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(chol, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True).squeeze(-1)


def blocked_spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SPD solve for 64 < k ≤ 128 by one level of block elimination
    (``_blocked_spd_solve_pallas``, ``cfk_tpu/ops/solve.py:310-357``):
    split A at k₁ = 64; ``gauss_solve_multi`` computes Y = A₁₁⁻¹[A₁₂ | b₁];
    the Schur complement S = A₂₂ − A₂₁·Y₁₂ (SPD) is solved by
    ``gauss_solve``; x₁ = y₁ − Y₁₂·x₂ back-substitutes.  The three batched
    contractions are plain float32 matmuls (TF32 off), as the JAX package
    left them to XLA at full precision.  A₁₁ is handed over as a view of
    ``a`` (the kernel reads it in place); S, which float32 rounding leaves
    symmetric only to its last bits, is solved from its lower triangle on
    the card.  a [E,k,k], b [E,k] → x [E,k]."""
    k = a.shape[-1]
    k1 = GJ_MAX_RANK
    k2 = k - k1
    a21, a22 = a[:, k1:, :k1], a[:, k1:, k1:]
    rhs = torch.cat([a[:, :k1, k1:], b[:, :k1, None]], dim=2)  # [E,k1,k2+1]
    y = gauss_solve_multi(a[:, :k1, :k1].permute(1, 2, 0),
                          rhs.permute(1, 2, 0)).permute(2, 0, 1)
    del rhs
    y12, y1 = y[:, :, :k2], y[:, :, k2]
    s = a22 - a21 @ y12  # [E, k2, k2]
    rhs2 = b[:, k1:] - (a21 @ y1[:, :, None])[:, :, 0]
    x2 = gauss_solve(s.permute(1, 2, 0), rhs2.T).T  # [E, k2]
    del s
    x1 = y1 - (y12 @ x2[:, :, None])[:, :, 0]
    return torch.cat([x1, x2], dim=1)


def dispatch_spd_solve(a: torch.Tensor, b: torch.Tensor,
                       solver: str = "auto") -> torch.Tensor:
    """Solve batched SPD systems a [E,k,k], b [E,k] → x [E,k] (no ridge).

    ``"auto"``: ``gauss_solve`` for k ≤ 64 (on the batch-last view of the
    batch), the blocked Schur solve for 64 < k ≤ 128, ``batched_spd_solve``
    above, as the JAX package's pallas solver falls back to XLA's Cholesky
    there.  ``"cholesky"`` (CPU only): the plain Cholesky.  The
    counterpart of ``cfk_tpu/ops/solve.py:360-389``."""
    k = a.shape[-1]
    if not use_kernels(solver, a.device):
        return spd_solve_plain(a, b)
    if k > 2 * GJ_MAX_RANK:
        return batched_spd_solve(a, b)
    if k > GJ_MAX_RANK:
        return blocked_spd_solve(a, b)
    return gauss_solve(a.permute(1, 2, 0), b.T).T.contiguous()


def regularized_solve(a: torch.Tensor, b: torch.Tensor, count: torch.Tensor,
                      lam: float, solver: str = "auto",
                      fused: bool | None = None,
                      algo: str | None = None) -> torch.Tensor:
    """Apply ALS-WR regularization λ·max(n, 1)·I and solve.

    Fused (the default, k ≤ 128; k ≤ 64 with ``algo="gj"``): K1's one pass.
    Split (``fused=False``, or a k past ``algo``'s cap —
    ``resolve_fused_chunk``): the ridge is added IN PLACE into ``a`` — the
    caller's batch is consumed (at the ML-25M shape and rank 128 a second
    [E, k, k] copy would be 3.9 GB) — λ·max(n, 1) rounded, then one add, as
    K1 adds it — and ``dispatch_spd_solve`` solves."""
    if resolve_fused_chunk(fused, a.shape[-1], algo):
        solve = reg_solve if use_kernels(solver, a.device) else reg_solve_plain
        return solve(a, b, count, lam=lam, reg_mode="diag")
    ridge = lam * count.to(torch.float32).clamp_min(1.0)
    a.diagonal(dim1=-2, dim2=-1).add_(ridge[:, None])
    return dispatch_spd_solve(a, b, solver)


def regularized_solve_matrix(a: torch.Tensor, b: torch.Tensor,
                             reg: torch.Tensor, solver: str = "auto",
                             fused: bool | None = None,
                             algo: str | None = None) -> torch.Tensor:
    """Solve (A_e + R) x_e = b_e with one shared [k,k] term R (iALS:
    YᵀY + λI): fused (within ``algo``'s cap), K1's matrix mode; split, R
    added IN PLACE into ``a`` (see ``regularized_solve``), then
    ``dispatch_spd_solve``."""
    if resolve_fused_chunk(fused, a.shape[-1], algo):
        solve = reg_solve if use_kernels(solver, a.device) else reg_solve_plain
        return solve(a, b, reg, reg_mode="matrix")
    a.add_(reg.to(torch.float32))
    return dispatch_spd_solve(a, b, solver)


def gather_gram_implicit(
    fixed_factors: torch.Tensor,  # [F, k]
    neighbor_idx: torch.Tensor,  # [E, P]
    confidence_m1: torch.Tensor,  # [E, P] c−1 = α·r observed, 0 at padding
    mask: torch.Tensor,  # [E, P]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-entity observed-part Gram of iALS: (A_obs = Σ (c−1)·f fᵀ [E,k,k],
    b = Σ c·f [E,k]); preferences are 1 at observed cells.  Rows, weights
    and weighted products in ``gram_compute_dtype`` (bf16 rounds (c−1)·f
    and c), the sums float32 in ``GRAM_SUM_ROWS``-row blocks."""
    ct = gram_compute_dtype(fixed_factors)
    gm = fixed_factors[neighbor_idx.long()].to(ct) * mask[..., None].to(ct)
    gw = (gm * confidence_m1[..., None].to(ct)).float()
    return _gram_sums(gw, gm.float(),
                      ((confidence_m1 + 1.0) * mask).to(ct).float())


def global_gram(factors: torch.Tensor) -> torch.Tensor:
    """YᵀY over all rows — [k, k] float32 (a plain matmul, TF32 off; a
    bf16 table's values are multiplied exactly in float32)."""
    f = factors.to(gram_compute_dtype(factors)).float()
    return f.T @ f


# Block height of the blocked global-Gram reduction (the JAX package's
# ``GRAM_BLOCK_ROWS``): blocks are summed in order, block 0 first.
GRAM_BLOCK_ROWS = 4096


def gram_block_add(acc: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """One blocked-Gram step: ``acc + blkᵀblk`` (float32)."""
    b = blk.to(gram_compute_dtype(blk)).float()
    return acc + b.T @ b


def global_gram_blocked(factors: torch.Tensor,
                        block_rows: int = GRAM_BLOCK_ROWS) -> torch.Tensor:
    """YᵀY by consecutive ``[block_rows, k]`` blocks accumulated in order —
    the summation order the bucketed implicit half-steps use."""
    k = factors.shape[-1]
    acc = factors.new_zeros((k, k), dtype=torch.float32)
    for lo in range(0, max(factors.shape[0], 1), block_rows):
        acc = gram_block_add(acc, factors[lo:lo + block_rows])
    return acc


def implicit_reg(gram: torch.Tensor, lam: float) -> torch.Tensor:
    """The iALS shared ridge YᵀY + λI."""
    return gram + lam * torch.eye(gram.shape[-1], dtype=gram.dtype,
                                  device=gram.device)


def ials_half_step(
    fixed_factors: torch.Tensor,  # [F, k] (full fixed side) f32 or bf16
    neighbor_idx: torch.Tensor,  # [E, P]
    rating: torch.Tensor,  # [E, P] interaction strengths; c = 1 + α·r
    mask: torch.Tensor,  # [E, P]
    lam: float,
    alpha: float,
    *,
    gram: torch.Tensor | None = None,
    solver: str = "auto",
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """Solve all entities of one side for implicit feedback (padded layout);
    plain λI regularization (Hu et al.), not ALS-WR's λ·n·I."""
    if gram is None:
        gram = global_gram(fixed_factors)
    a_obs, b = gather_gram_implicit(fixed_factors, neighbor_idx,
                                    alpha * rating, mask)
    return regularized_solve_matrix(a_obs, b, implicit_reg(gram, lam), solver,
                                    algo=reg_solve_algo)


def walk_buckets(buckets, chunk_rows, arrays_of, piece, out, plan_of=None,
                 *, overlap=None, stream=None):
    """The bucket scaffolding every width-bucketed half-step shares.

    For each bucket: extract its per-row arrays (``arrays_of(blk, out)`` —
    ``out`` is passed so warm-started optimizers can read the bucket's
    current factors), run ``piece(*arrays) -> [rows, k]`` — in [chunk, ...]
    pieces when ``chunk_rows`` bounds the bucket, as the JAX package's walk
    streams them (``cfk_tpu/ops/solve.py:206-237``) — and scatter the
    result into ``out`` at the bucket's entity rows (padding rows target the
    trash slot; real rows are unique across buckets).  Only the per-row
    arrays are cut; ``plan_of(blk, rows)``, when given, hands each piece one
    more argument, the Gram work-unit plan of a piece of ``rows`` rows (a
    width class is one tile per entity, so every piece of a class has the
    same plan).

    The pieces of all classes are one pipelined walk by default
    (``ops.pipeline.prefetch_scan``): piece i+1's operands are fetched
    before piece i runs.  ``stream`` (a ``BucketStream``, the gather-off
    walks) makes the fetch write each streamed piece's K5 stream into one
    of two buffers — on a side stream on the card, in order on the CPU —
    and hands it to ``piece`` as ``g=``.  ``overlap`` only picks where
    that fetch runs: on a side stream (on, on a card) or in order on the
    current stream (off — the serial schedule, the A/B baseline; and the
    CPU).  Both make the same calls on the same operands into disjoint
    rows: the same bits.
    """
    from cfk_tpu_torch.ops.pipeline import fetch_stream, prefetch_scan

    pieces = []  # (arrays, lo, hi, extra, entity rows, streamed)
    for blk, chunk in zip(buckets, chunk_rows):
        arrs = arrays_of(blk, out)
        rows = arrs[0].shape[0]
        step = rows if chunk is None or chunk >= rows else chunk
        if rows % step != 0:
            raise ValueError(f"bucket rows {rows} not divisible by chunk "
                             f"{step}")
        extra = () if plan_of is None else (plan_of(blk, step),)
        ent = blk["entity_local"].long()
        streamed = stream is not None and stream.wants(blk)
        pieces += [(arrs, lo, lo + step, extra, ent, streamed)
                   for lo in range(0, rows, step)]
    cells = max(((hi - lo) * arrs[0].shape[1]
                 for arrs, lo, hi, _, _, streamed in pieces if streamed),
                default=0)
    side = bufs = None
    if cells:
        side = fetch_stream(out.device, overlap)
        bufs = [torch.empty((cells, stream.k), dtype=stream.dtype,
                            device=out.device) for _ in range(2)]

    def fetch(i):
        arrs, lo, hi, _, _, streamed = pieces[i]
        views = tuple(a[lo:hi] for a in arrs)
        if not streamed:
            return views, None
        n = (hi - lo) * arrs[0].shape[1]
        return views, stream.fetch(views, bufs[i % 2][:n])

    def compute(carry, buf, _x, i):
        views, g = buf
        _, lo, hi, extra, ent, _ = pieces[i]
        x = piece(*views, *extra, **({} if g is None else {"g": g}))
        out[ent[lo:hi]] = x
        return carry, None

    prefetch_scan(fetch, compute, len(pieces), None, stream=side)
    return out


class BucketStream(NamedTuple):
    """The gather-off walk's fetch (``walk_buckets``): ``fetch(arrays,
    buf) -> g`` writes a piece's stream into ``buf`` [cells, k] of
    ``dtype``; ``wants(blk)`` says whether a class streams (a class on the
    legacy schedule gathers in its own einsum)."""

    fetch: object
    wants: object
    dtype: torch.dtype
    k: int


def bucket_plan(blk, rows: int):
    """The work-unit plan of a ``rows``-row piece of width class ``blk``:
    the one the device upload staged for the whole class or for its
    ``chunk_rows`` pieces (``piece_plan``), else None (the wrappers derive
    it)."""
    from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

    if rows == blk["neighbor"].shape[0]:
        return chunk_plan(blk, 0)
    return blk.get("piece_plan")


def class_supported(blk, k: int) -> bool:
    """Whether width class ``blk`` runs the tiled-kernel route
    (``ops.bucketed.bucket_port_supported``) rather than the legacy
    schedule."""
    from cfk_tpu_torch.ops.bucketed import bucket_port_supported

    rows, width = blk["neighbor"].shape
    return bucket_port_supported(rows, width, k)


def bucket_chunks(buckets, chunk_rows, gather: str, k: int):
    """The piece bound each width class is walked with: the blocks'
    ``chunk_rows`` on the materialized-stream route (``gather="xla"``: K5
    writes a piece's [chunk·width, k] stream, never a whole class's); one
    piece per class on the gather route — K6 (and K2, split) materialize
    neither the gathered rows nor, fused, the Gram batch, so cutting the
    widest classes into short launches would only serialize their entities
    — and on the legacy schedule (``class_supported``), whose gather and
    einsum run once over the class, so a class's rows are the same bits
    whichever walk reaches them (a batched product's order may follow its
    batch count on the card)."""
    if gather != "xla" or chunk_rows is None:
        return (None,) * len(buckets)
    return tuple(c if class_supported(blk, k) else None
                 for blk, c in zip(buckets, chunk_rows))


def _bucket_stream(data, scale, k, solver, wt_of) -> BucketStream:
    """The ``BucketStream`` of a gather-off bucketed half-step: K5 over each
    kernel-route piece's (nb, ``wt_of(arrays)``) — the class's mask, or,
    for iALS, its reparameterized weights."""
    from cfk_tpu_torch.ops.bucketed import bucket_stream
    from cfk_tpu_torch.ops.kernels.gram_kernel import stream_dtype

    return BucketStream(
        fetch=lambda arrs, buf: bucket_stream(data, arrs[0], wt_of(arrs),
                                              scale, buf, solver=solver),
        wants=lambda blk: class_supported(blk, k),
        dtype=stream_dtype(data), k=k)


def als_half_step_bucketed(
    fixed_factors: torch.Tensor,  # [F, k] f32 or bf16
    buckets,  # sequence of dicts {neighbor, rating, mask, count, entity_local}
    local_entities: int,
    lam: float,
    *,
    chunk_rows=None,  # the blocks' per-bucket piece bound (None: whole)
    solver: str = "auto",
    in_kernel_gather: bool | None = None,
    fused_epilogue: bool | None = None,
    reg_solve_algo: str | None = None,
    table_dtype: str | None = None,
    overlap: bool | None = None,
) -> torch.Tensor:
    """One ALS-WR half-iteration over width-bucketed InBlocks: every width
    class through K6 with one tile per entity (``ops.bucketed``), or, with
    ``in_kernel_gather=False``, through K5 and ``gram_solve_tiles`` in
    ``chunk_rows`` pieces (``bucket_chunks``); with ``fused_epilogue=False``
    — or at a rank past the fused cap (``resolve_fused_chunk``) — each
    class's (A, b) goes to device memory (K2, or K5 and ``gram_tiles``) and
    K1 solves it (the split dispatch past K1's cap).  A class the JAX
    package's gate refuses (``ops.bucketed.bucket_port_supported``) takes
    its legacy schedule, as there: the gather + einsum of ``_solve_chunk``
    on the dequantized table, then the ridge + solve (K1 on CUDA).
    ``table_dtype`` quantizes the gather table (``ops.quant``; int8's scale
    folded into each piece's weights).  ``overlap`` pipelines the walk
    (``walk_buckets``).  Rows in no bucket (zero ratings) stay exactly 0."""
    from cfk_tpu_torch.ops.bucketed import (
        bucket_gram_solve,
        bucket_port_supported,
    )
    from cfk_tpu_torch.ops.tiled import resolve_gather_mode

    k = fixed_factors.shape[-1]
    gather = resolve_gather_mode(in_kernel_gather)
    fused = resolve_fused_chunk(fused_epilogue, k, reg_solve_algo)
    data, scale = quantize_table(fixed_factors, table_dtype)
    legacy = not all(class_supported(blk, k) for blk in buckets)
    view = dequantize_table(data, scale) if legacy else None

    def solve_piece(ni, rt, mk, cnt, units, g=None):
        rows, width = ni.shape
        if not bucket_port_supported(rows, width, k):
            return _solve_chunk(view, lam, ni, rt, mk, cnt, solver,
                                reg_solve_algo)
        return bucket_gram_solve(data, ni, mk, rt, cnt, lam=lam,
                                 reg_mode="diag", solver=solver,
                                 gather=gather, fused=fused, units=units,
                                 scale=scale, algo=reg_solve_algo, g=g)

    stream = None
    if gather == "xla":
        stream = _bucket_stream(data, scale, k, solver, lambda a: a[2])
    out = walk_buckets(
        buckets, bucket_chunks(buckets, chunk_rows, gather, k),
        lambda blk, _out: (blk["neighbor"], blk["rating"], blk["mask"],
                           blk["count"]),
        solve_piece,
        fixed_factors.new_zeros((local_entities + 1, k), dtype=torch.float32),
        plan_of=bucket_plan, overlap=overlap, stream=stream)
    return out[:local_entities]


def ials_half_step_bucketed(
    fixed_factors: torch.Tensor,  # [F, k] f32 or bf16
    buckets,  # sequence of dicts {neighbor, rating, mask, entity_local}
    local_entities: int,
    lam: float,
    alpha: float,
    *,
    chunk_rows=None,  # the blocks' per-bucket piece bound (None: whole)
    gram: torch.Tensor | None = None,
    solver: str = "auto",
    in_kernel_gather: bool | None = None,
    fused_epilogue: bool | None = None,
    reg_solve_algo: str | None = None,
    table_dtype: str | None = None,
    overlap: bool | None = None,
) -> torch.Tensor:
    """Implicit-feedback half-iteration over width-bucketed InBlocks: per
    entity YᵀY + Σ_obs (c−1)·f fᵀ + λI, every width class through K6 (or,
    with ``in_kernel_gather=False``, K5 and ``gram_solve_tiles`` in
    ``chunk_rows`` pieces) with the sqrt-reparameterized weight stream
    (``ops.bucketed.ials_reparam``) and the shared ridge in matrix mode
    (see ``als_half_step_bucketed``, also for ``fused_epilogue=False``: K2
    + K1 matrix mode).  A class the JAX package's gate refuses takes its
    legacy schedule: ``gather_gram_implicit`` on the dequantized table
    (which rounds a bf16 table's (c−1)·f where the reference's legacy
    route rounds it), its symmetric part, then the shared ridge and the
    solve.  YᵀY sums the rows the kernels read (the dequantized view of
    ``table_dtype``).  Zero-interaction rows stay 0."""
    from cfk_tpu_torch.ops.bucketed import (
        bucket_gram_solve,
        bucket_port_supported,
        ials_reparam,
    )
    from cfk_tpu_torch.ops.tiled import resolve_gather_mode

    k = fixed_factors.shape[-1]
    gather = resolve_gather_mode(in_kernel_gather)
    fused = resolve_fused_chunk(fused_epilogue, k, reg_solve_algo)
    data, scale = quantize_table(fixed_factors, table_dtype)
    view = dequantize_table(data, scale)
    if gram is None:
        gram = global_gram_blocked(view)
    reg_m = implicit_reg(gram, lam)

    def solve_piece(ni, rt, mk, units, g=None):
        rows, width = ni.shape
        if not bucket_port_supported(rows, width, k):
            a_obs, b = gather_gram_implicit(view, ni, alpha * rt, mk)
            # Σ (c−1)·f fᵀ from the rounded (c−1)·f is symmetric only to
            # rounding (to 2^-9 relative on a bf16 table); the kernels read
            # one triangle, so hand them its symmetric part, as the
            # reference's Cholesky symmetrizes its input.
            a_obs = (a_obs + a_obs.mT) * 0.5
            return regularized_solve_matrix(a_obs, b, reg_m, solver,
                                            algo=reg_solve_algo)
        wt, rt_b = ials_reparam(rt, mk, alpha)
        return bucket_gram_solve(data, ni, wt, rt_b, reg_m,
                                 lam=0.0, reg_mode="matrix", solver=solver,
                                 gather=gather, fused=fused, units=units,
                                 scale=scale, algo=reg_solve_algo, g=g)

    stream = None
    if gather == "xla":
        stream = _bucket_stream(data, scale, k, solver,
                                lambda a: ials_reparam(a[1], a[2], alpha)[0])
    out = walk_buckets(
        buckets, bucket_chunks(buckets, chunk_rows, gather, k),
        lambda blk, _out: (blk["neighbor"], blk["rating"], blk["mask"]),
        solve_piece,
        fixed_factors.new_zeros((local_entities + 1, k), dtype=torch.float32),
        plan_of=bucket_plan, overlap=overlap, stream=stream)
    return out[:local_entities]


def segment_gram_rounded(
    fixed_factors: torch.Tensor,  # [F, k] bf16
    neighbor_idx: torch.Tensor,  # [C] one chunk's flat sorted run
    confidence_m1: torch.Tensor,  # [C] c−1 = α·r
    mask: torch.Tensor,  # [C] 1 = real entry
    lengths: torch.Tensor,  # [Ec+1] entries per segment (trash last)
    carry,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's raw iALS Gram/RHS for a bf16 table in the JAX package's
    rounding order (``cfk_tpu/ops/solve.py::_segment_gram_flat`` :576):
    (c−1)·f and c formed in bf16 (each product rounded), A_s = Σ
    [(c−1)·f] fᵀ and b_s = Σ c·f summed float32 over segment s's entries in
    entry order by ``torch.segment_reduce`` (a sequential loop per output
    element: the same sums on every run, no atomics), then cin·(ca, cb) of
    ``carry`` folded into segment 0.  A is symmetric only to that rounding:
    the solve takes its symmetric part (``ials_half_step_segment``)."""
    ct = gram_compute_dtype(fixed_factors)
    f = fixed_factors[neighbor_idx.long()].to(ct) * mask[:, None].to(ct)
    fw = (f * confidence_m1[:, None].to(ct)).float()
    f = f.float()
    rt = ((confidence_m1 + 1.0) * mask).to(ct).float()
    a = torch.segment_reduce(fw[:, :, None] * f[:, None, :], "sum",
                             lengths=lengths, unsafe=True)
    b = torch.segment_reduce(rt[:, None] * f, "sum", lengths=lengths,
                             unsafe=True)
    ca, cb, cin = carry
    a[0] += cin[0] * ca
    b[0] += cin[0] * cb
    return a, b


# The flat run's per-entry fields a segment chunk reads (its fetch).
SEGMENT_RUN = ("neighbor_idx", "rating", "mask", "seg_rel")


def segment_scan(fixed_factors, chunk_gram, solve_rows, blk, statics,
                 local_entities: int) -> torch.Tensor:
    """The chunk loop both segment half-steps share (``cfk_tpu/ops/solve.py
    ::_segment_scan`` :641, a ``prefetch_scan`` there and here:
    ``ops.pipeline``; its fetch is a slice, so it needs no side stream and
    runs the serial loop's calls in its order).

    Chunk c's fetch slices its [cap] window of the flat run (``SEGMENT_RUN``
    → views, ``index_fetch``); ``chunk_gram(run, carry, c)`` builds its raw
    Gram/RHS [Ec+1, k, k]/[Ec+1, k] with ``carry`` = (ca, cb, cin) folded
    into segment 0 as cin·(ca, cb); ``solve_rows(a, b, count) -> x`` solves
    its Ec rows.  The entity straddling each chunk boundary carries its
    partial (A, b): ``carry_in`` gates adding it to segment 0, and the next
    carry is segment ``last_seg`` of the RAW sums — copied out before
    ``solve_rows`` runs, since above k = 128 the split route adds the ridge
    into ``a`` in place.  Each chunk's rows are scattered into the output
    (rows not finalized there go to the trash row); rows that no chunk
    finalizes stay exactly 0."""
    from cfk_tpu_torch.ops.pipeline import index_fetch, prefetch_scan

    nc, cap, e_c = statics
    k = fixed_factors.shape[-1]
    out = fixed_factors.new_zeros((local_entities + 1, k), dtype=torch.float32)
    a0 = fixed_factors.new_zeros((k, k), dtype=torch.float32)
    b0 = fixed_factors.new_zeros((k,), dtype=torch.float32)
    carry_in, last_seg = blk["carry_in"], blk["last_seg"]
    fetches = {f: index_fetch(blk[f], cap) for f in SEGMENT_RUN}

    def fetch(c):
        return {f: fn(c) for f, fn in fetches.items()}

    def compute(carry, run, _x, c):
        a, b = chunk_gram(run, (carry[0], carry[1], carry_in[c:c + 1]), c)
        last = last_seg[c:c + 1]
        carry = (a.index_select(0, last)[0], b.index_select(0, last)[0])
        rows = slice(c * e_c, (c + 1) * e_c)
        x = solve_rows(a[:e_c], b[:e_c], blk["chunk_count"][rows])
        out[blk["chunk_entity"][rows].long()] = x
        return carry, None

    prefetch_scan(fetch, compute, nc, (a0, b0))
    return out[:local_entities]


def _segment_k2(fixed_factors, blk, run, wt, rt, carry, c, e_c):
    """Chunk ``c``'s Gram/RHS through K2 (``gram_gather``) with one-row
    tiles: g = table[nb]·wt, A_s = Σ g gᵀ and b_s = Σ rt·g over the
    entries segment s owns (``seg_rel``), float32 sums, the carry folded
    into segment 0.  The run is sorted by owner, so K2's work units (the
    chunk's plan, staged at block upload: ``models.als._segment_to_device``)
    sum each segment's partials in unit order: the sums are the same on
    every run, with no atomics and no [C, k, k] tensor.  Padding weighs 0,
    so the trash segment gets nothing.  On the CPU K2's plain version runs:
    the per-entry outer products summed by ``index_add_`` in entry order,
    as the JAX package's segment sum does."""
    from cfk_tpu_torch.ops.kernels.gram_kernel import gram_gather
    from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

    return gram_gather(fixed_factors, run["neighbor_idx"], wt.contiguous(),
                       rt.contiguous(), run["seg_rel"],
                       num_segments=e_c + 1, tile_rows=1, carry=carry,
                       units=chunk_plan(blk, c))


def als_half_step_segment(
    fixed_factors: torch.Tensor,  # [F, k]
    blk,  # device dict of one SegmentBlocks side (models.als)
    statics: tuple[int, int, int],
    local_entities: int,
    lam: float,
    *,
    solver: str = "auto",
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """One ALS-WR half-iteration over the segment layout
    (``cfk_tpu/ops/solve.py::als_half_step_segment`` :690): the same normal
    equations and λ·max(n, 1)·I as every other layout, the Grams summed
    chunk by chunk over the flat sorted run by K2 (``_segment_k2``: wt =
    mask, rt = r·mask; a bf16 table's rows stay exact, its weights being
    0/1), each chunk's Ec rows solved by ``regularized_solve`` — K1 on CUDA
    up to k = 128, ``batched_spd_solve`` above, the plain version on the
    CPU — with the straddling entity's partial sums carried across
    chunks."""
    e_c = statics[2]

    def chunk_gram(run, carry, c):
        mk = run["mask"]
        return _segment_k2(fixed_factors, blk, run, mk, run["rating"] * mk,
                           carry, c, e_c)

    def solve_rows(a, b, cnt):
        return regularized_solve(a, b, cnt, lam, solver,
                                 algo=reg_solve_algo)

    return segment_scan(fixed_factors, chunk_gram, solve_rows, blk, statics,
                        local_entities)


def ials_half_step_segment(
    fixed_factors: torch.Tensor,  # [F, k]
    blk,
    statics: tuple[int, int, int],
    local_entities: int,
    lam: float,
    alpha: float,
    *,
    gram: torch.Tensor | None = None,
    solver: str = "auto",
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """Implicit-feedback half-iteration over the segment layout
    (``cfk_tpu/ops/solve.py::ials_half_step_segment`` :738): per entity
    A = YᵀY + Σ_obs (c−1)·f fᵀ + λI, b = Σ_obs c·f.  The chunk loop carries
    the raw observed Gram of straddling entities; the shared YᵀY + λI is
    added at solve time only (K1's matrix mode up to k = 128).  Rows with
    no interaction stay exactly 0.  A float32 table's chunk Grams go
    through K2 with the sqrt reparameterization of the tiled layout
    (``ops.bucketed.ials_reparam``: g = √(α·r)·f, b-coefficient
    c/√(α·r)).  A bf16 table keeps the JAX package's rounding order on this
    layout — (c−1)·f rounded to bf16, where the reparameterization would
    round √(α·r)·f — so its chunks take ``segment_gram_rounded`` (the
    chunk's ``group_sizes`` as segment lengths) and each solve reads the
    symmetric part of its A, as the JAX package's Cholesky symmetrizes its
    input."""
    from cfk_tpu_torch.ops.bucketed import ials_reparam

    if gram is None:
        gram = global_gram(fixed_factors)
    reg = implicit_reg(gram, lam)
    e_c = statics[2]
    rounded = gram_compute_dtype(fixed_factors) == torch.bfloat16

    def chunk_gram(run, carry, c):
        if rounded:
            sizes = blk["group_sizes"][c * (e_c + 1):(c + 1) * (e_c + 1)]
            return segment_gram_rounded(
                fixed_factors, run["neighbor_idx"], alpha * run["rating"],
                run["mask"], sizes, carry)
        wt, rt_b = ials_reparam(run["rating"], run["mask"], alpha)
        return _segment_k2(fixed_factors, blk, run, wt, rt_b, carry, c, e_c)

    def solve_rows(a, b, _cnt):
        if rounded:
            a = (a + a.mT) * 0.5
        return regularized_solve_matrix(a, b, reg, solver,
                                        algo=reg_solve_algo)

    return segment_scan(fixed_factors, chunk_gram, solve_rows, blk, statics,
                        local_entities)


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
                 solver="auto", algo=None):
    a, b = gather_gram(fixed_factors, neighbor_idx, rating, mask)
    return regularized_solve(a, b, count, lam, solver, algo=algo)


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
    reg_solve_algo: str | None = None,
) -> torch.Tensor:
    """One ALS half-iteration on the padded layout: solve all [E] entities
    against the fixed factors (f32, or bf16 — ``gather_gram``).
    ``solve_chunk`` bounds the [chunk, P, k] gather held at once by walking
    entity chunks (an indivisible E is padded with inert rows that are
    sliced off), pipelined by ``ops.pipeline.chunk_map``."""
    from cfk_tpu_torch.ops.pipeline import chunk_map

    e = neighbor_idx.shape[0]
    if solve_chunk is None or solve_chunk >= e:
        return _solve_chunk(fixed_factors, lam, neighbor_idx, rating, mask,
                            count, solver, reg_solve_algo)
    arrs, _ = pad_rows_to_multiple((neighbor_idx, rating, mask, count),
                                   solve_chunk)
    n = arrs[0].shape[0] // solve_chunk
    out = chunk_map(
        lambda ni, rt, mk, cnt: _solve_chunk(fixed_factors, lam, ni, rt, mk,
                                             cnt, solver, reg_solve_algo),
        tuple(a.reshape(n, solve_chunk, *a.shape[1:]) for a in arrs), n)
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
