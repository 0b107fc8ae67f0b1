"""The tiled layout's Gram kernels and their plain PyTorch versions, on both
schedules of the neighbor gather (``csrc/gram_kernels.cuh`` holds the
kernels; one ``csrc/<wrapper>.cu`` library per entry).

Counterparts of ``cfk_tpu/ops/pallas/gram_kernel.py``.  The gather route
(``in_kernel_gather`` None/True, the default) reads the fixed table by index
inside the kernel:

- ``gram_gather`` (K2) ↔ ``gram_tiles_gather_pallas`` (accum-mode chunks,
  the stream mode's split chunks): the per-owner-segment Gram A_s = Σ g gᵀ
  and RHS b_s = Σ rt·g of one chunk of [T]-row tiles, g = table[nb]·wt.
- ``gram_solve_gather`` (K6) ↔ ``gram_solve_tiles_gather_pallas``: K2's
  sums plus the fused epilogue (carry fold, raw ``lseg`` row, ridge,
  solve) — the bucketed layout's width classes (one tile per entity) and
  the stream mode's chunks.
- ``gram_tiles_dense_gather`` ↔ ``gram_tiles_dense_gather_pallas``: the
  same sums over the dense stream's windowed tiles — the dense-stream
  chunk's (A, b) for the split schedule (K1 solves them).
- ``gram_solve_dense`` (K3) ↔ ``gram_solve_tiles_dense_gather_pallas``:
  the dense sums plus the fused epilogue — the Gram never leaves the kernel.

The materialized-stream route (``in_kernel_gather=False``) first writes the
gathered stream with ``gather_rows`` (K5 ↔ ``gather_rows_pallas``,
``out[i] = table[nb[i]]·wt[i]``, also what the subspace sweeps consume),
then reads it with the twin of each kernel above:

- ``gram_tiles`` ↔ ``gram_tiles_pallas`` (twin of K2),
- ``gram_solve_tiles`` ↔ ``gram_solve_tiles_pallas`` (twin of K6),
- ``gram_tiles_dense`` ↔ ``gram_tiles_dense_pallas`` (twin of
  ``gram_tiles_dense_gather``),
- ``gram_solve_tiles_dense`` ↔ ``gram_solve_tiles_dense_pallas`` (twin of
  K3).

Ranks: the fused entries (K3, K6, ``gram_solve_tiles``,
``gram_solve_tiles_dense``) take k ≤ 128 (``MAX_RANK``) on every device —
the reference's fused gate routes larger ranks to its split schedule, and
so do the port's half-steps (``ops.solve.resolve_fused_chunk``).  The split
entries (K2, ``gram_tiles_dense_gather``, ``gram_tiles``,
``gram_tiles_dense``) take any rank up to ``MAX_SPLIT_RANK``, the largest
whose k² + k Gram elements the kernels index with an int: above 128 their
grid gains an axis over the Gram's 128 × 128 block pairs
(``csrc/gram_kernels.cuh``).

Every Gram kernel's grid is work units — runs of at most 1,024 rows of one
owner segment, so a hot segment is spread over many CTAs — and every Gram
wrapper takes ``units``, the chunk's unit plan (``gram_units``: the device
upload stages one per chunk and the half-steps pass it); called without
one, the wrapper derives it on the device.  The plain versions take and
ignore it.

Tables: every gather entry takes a float32, bf16 or int8 table
(``ops.quant``: the quantized-training gather tables), K5 writes a bf16
stream for a bf16 table and float32 for the others, and the stream twins take
float32 or bf16 streams.  The rows are formed as the JAX package forms them
(``gather_rows_plain``: the compute dtype of ``ops.solve.gram_compute_dtype``,
the weight cast to it, one product — a bf16 table's g rounded to bf16 once;
an int8 table's weights carry its folded per-row scale, and an int8 call
without weights is refused), and every Gram sums float32: the kernels convert
each element in registers and stage float32 rows, the plain versions upcast
before their einsums (bf16 products are exact in float32).  The
b-coefficients rt stay float32, as the reference's CPU route keeps them
(``_emulate_gram_tiles``).  A CUDA tensor of another dtype raises; no dtype
sends a CUDA call to a plain version.

Each gather version's plain version is ``gather_rows_plain`` followed by its
stream twin's, so the two routes agree by construction on the CPU; on the
card a twin fed K5's stream runs its sibling's float32 operations in its
sibling's order.  Index F (the table height) is the virtual zero row padding
entries point at.  Segments owning no tile come back as zeros (solve:
x = 0); the TPU kernels leave them unwritten, and callers route them to the
trash row either way.
"""

from __future__ import annotations

import ctypes

import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, scalar_on, stream_of
from cfk_tpu_torch.ops.kernels.gram_units import (
    UNIT_ROWS,
    derive_dense_units,
    derive_tile_units,
)
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    MAX_RANK,
    REG_MODES,
    check_reg,
    reg_solve_plain,
)

# The C entries' element kinds (csrc/common.cuh Kind).
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
TABLE_DTYPES = (torch.float32, torch.bfloat16, torch.int8)
STREAM_DTYPES = (torch.float32, torch.bfloat16)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/gram_kernels.cuh kMaxSplitRank: k² + k (and a reduce stride) < 2^31.
MAX_SPLIT_RANK = 46000
_PLAN = (_P, _I, _P, _I, _P)  # units, nu, splits, nsp, scratch
_SOLVE = (_P, _P, _I, _F, _P, _P, _P, _P, _P, _P, _P)  # tickets .. cb_out
_GRAM_TAIL = (_P, _P, _P, _P, _P, _I, _P)  # ca, cb, cin, out_a, out_b, dev, st
_DENSE_WALK = (_P, _I, _I, _I, _I)  # meta, nt, ng, T, BG
_GATHER = (_P, _I, _I, _I, _P, _P, _P)  # table, kind, F, k, nb, wt, rt
_STREAM = (_P, _I, _I, _P)  # g, kind, k, rt
_GATHER_ARGTYPES = _GATHER + _PLAN + _GRAM_TAIL
_DENSE_GRAM_ARGTYPES = _GATHER + _DENSE_WALK + _PLAN + _GRAM_TAIL
_DENSE_ARGTYPES = _GATHER + _DENSE_WALK + _PLAN + _SOLVE + (_I, _P)
_SOLVE_GATHER_ARGTYPES = _GATHER + _PLAN + _SOLVE + (_I, _P)
_TILES_ARGTYPES = _STREAM + _PLAN + _GRAM_TAIL
_TILES_DENSE_ARGTYPES = _STREAM + _DENSE_WALK + _PLAN + _GRAM_TAIL
_SOLVE_TILES_ARGTYPES = _STREAM + _PLAN + _SOLVE + (_I, _P)
_SOLVE_TILES_DENSE_ARGTYPES = _STREAM + _DENSE_WALK + _PLAN + _SOLVE + (_I, _P)
_ROWS_ARGTYPES = (_P, _I, _I, _I, _I, _P, _P, ctypes.c_longlong, _I, _P, _I,
                  _P)


def _check_int8_weights(table, wt, name: str) -> None:
    """An int8 table's per-row scale rides only in ``wt`` (``ops.quant.
    fold_scale``): an unweighted int8 call would return raw codes, so it is
    refused on every route (``cfk_tpu/ops/pallas/gram_kernel.py:1378-1394,
    1946-1955``)."""
    if table.dtype == torch.int8 and wt is None:
        raise ValueError(
            f"{name}: an int8 table needs the per-row dequant scale folded "
            "into wt (ops.quant.fold_scale); wt=None would return raw "
            "quantized codes")


def stream_dtype(table: torch.Tensor) -> torch.dtype:
    """The dtype of the stream K5 writes from ``table``: bf16 for a bf16
    table, float32 for float32 and int8 (``gather_rows_pallas`` :1958-1960,
    the compute dtype of ``ops.solve.gram_compute_dtype``)."""
    return torch.bfloat16 if table.dtype == torch.bfloat16 else torch.float32


def gather_rows_plain(table: torch.Tensor, nb: torch.Tensor,
                      wt: torch.Tensor | None,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """g = table[nb]·wt with every index outside [0, F) reading the zero
    row (the JAX twin appends it and clamps; the kernels test the index),
    formed in ``out_dtype`` (default ``stream_dtype``): the rows cast to
    it, then one product with the weight cast to it
    (``cfk_tpu/compat.py:101-133``) — for a bf16 stream one bf16 rounding
    of an exact product."""
    f, k = table.shape
    _check_int8_weights(table, wt, "gather_rows")
    ct = stream_dtype(table) if out_dtype is None else out_dtype
    fz = torch.cat([table, table.new_zeros(1, k)])
    idx = nb.long()
    g = fz[torch.where((idx >= 0) & (idx < f), idx, f)].to(ct)
    return g if wt is None else g * wt.to(ct)[:, None]


def table_kind(t: torch.Tensor, name: str, shape, dtypes) -> int:
    """The C entries' kind of a table or stream, after refusing a dtype the
    kernel does not take, a wrong shape or layout."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    require(t, name, t.dtype, shape)
    return KINDS[t.dtype]


def gather_rows(table: torch.Tensor, nb: torch.Tensor,
                wt: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """K5: the gathered stream ``out [C,k] = table[nb]·wt``.

    table [F,k] f32, bf16 or int8 (raw: no zero row); nb [C] int32 — an
    index outside [0, F) reads the zero row; wt [C] f32 premultiply (an
    int8 table's folded scale) or None (no multiply; refused for int8).
    ``out_dtype`` None: ``stream_dtype`` (bf16 for a bf16 table, else
    float32); float32 asks a bf16 table for a float32 stream (the subspace
    sweeps, as ``cfk_tpu/ops/subspace.py:50-75`` asks ``out_dtype=f32``).
    ``out`` [C,k] of that dtype, contiguous: the buffer to write (the
    pipelined chunk walks' double buffer, ``ops.pipeline.prefetch_scan``);
    None allocates it.
    """
    c = nb.shape[0]
    f, k = table.shape
    if not on_cuda(table, nb, wt):
        g = gather_rows_plain(table, nb, wt, out_dtype)
        return g if out is None else out.copy_(g)
    kind = table_kind(table, "table", (f, k), TABLE_DTYPES)
    _check_int8_weights(table, wt, "gather_rows")
    out_dtype = stream_dtype(table) if out_dtype is None else out_dtype
    if out_dtype not in (stream_dtype(table), torch.float32):
        raise TypeError(f"gather_rows of a {table.dtype} table writes "
                        f"{stream_dtype(table)} or float32, not {out_dtype}")
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    if out is None:
        out = torch.empty((c, k), dtype=out_dtype, device=table.device)
    require(out, "out", out_dtype, (c, k))
    # Vector moves: k a multiple of the output's 16-byte vector (4 floats,
    # 8 bf16) and an aligned table base.
    vec = int(k % (16 // out.element_size()) == 0
              and table.data_ptr() % 16 == 0)
    fn = _build.function("gather_rows", "cfk_gather_rows", _ROWS_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), kind, int(out_dtype == torch.bfloat16), f, k, p(nb),
            p(wt), c, vec, p(out), table.device.index or 0,
            stream_of(table))
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


# -- plain versions: the stream forms, and the gather forms on top ------------

def _segment_sums(a_t, b_t, seg, num_segments, carry):
    k = a_t.shape[-1]
    a = a_t.new_zeros(num_segments, k, k).index_add_(0, seg.long(), a_t)
    b = b_t.new_zeros(num_segments, k).index_add_(0, seg.long(), b_t)
    if carry is not None:
        ca, cb, cin = carry
        cin = cin.reshape(()) if isinstance(cin, torch.Tensor) else cin
        a[0] += cin * ca
        b[0] += cin * cb
    return a, b


def _solve_plain(ab, reg, lseg, lam, reg_mode):
    """K1's plain ridge + Cholesky solve of (A, b) and the RAW ``lseg``
    row: the fused epilogue's (x, carry_a, carry_b)."""
    a, b = ab
    ls = lseg.reshape(()).long() if isinstance(lseg, torch.Tensor) else lseg
    x = reg_solve_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    return x, a[ls].clone(), b[ls].clone()


def gram_tiles_plain(g, rt, seg, *, num_segments, tile_rows, carry=None,
                     units=None):
    """The plain PyTorch version of ``gram_tiles``: tile einsums, segment
    sum by ``index_add_`` — the XLA twin ``_emulate_gram_tiles``.  Every
    plain version takes the kernels' work-unit plan ``units`` and has no use
    for it."""
    k = g.shape[-1]
    a_t, b_t = _tile_sums(g.float().view(-1, tile_rows, k),
                          rt.view(-1, tile_rows))
    return _segment_sums(a_t, b_t, seg, num_segments, carry)


def _tile_sums(gt, r):
    """Each tile's (A, b) of rows gt [NT, T, k] and coefficients r [NT, T],
    summed as the kernels sum a segment: in blocks of ``UNIT_ROWS`` rows
    (a tile past it zero-padded to whole blocks), each block from zero,
    the blocks then added in order.  The block products run as one batch of
    at least two (a zero block added to a batch of one): PyTorch's
    single-matrix product sums in another order than its batched one, and
    a tile's bits must not depend on the tiles beside it (a width class
    walked in one-row pieces gives the whole class's bits)."""
    nt, t, k = gt.shape
    rows = min(t, UNIT_ROWS)
    pad = -t % rows
    if pad:
        gt = torch.cat([gt, gt.new_zeros(nt, pad, k)], dim=1)
        r = torch.cat([r, r.new_zeros(nt, pad)], dim=1)
    blocks = (t + pad) // rows
    gb, rb = gt.reshape(-1, rows, k), r.reshape(-1, rows)
    n = gb.shape[0]
    if n == 1:
        gb = torch.cat([gb, torch.zeros_like(gb)])
        rb = torch.cat([rb, torch.zeros_like(rb)])
    a = torch.einsum("ntk,ntl->nkl", gb, gb)[:n]
    b = torch.einsum("ntk,nt->nk", gb, rb)[:n]
    if blocks == 1:
        return a, b
    a, b = a.view(nt, blocks, k, k), b.view(nt, blocks, k)
    sa, sb = a[:, 0].clone(), b[:, 0].clone()
    for j in range(1, blocks):
        sa += a[:, j]
        sb += b[:, j]
    return sa, sb


def gram_gather_plain(table, nb, wt, rt, seg, *, num_segments, tile_rows,
                      carry=None, units=None):
    """The plain PyTorch version of K2: ``gather_rows_plain`` then
    ``gram_tiles_plain``."""
    return gram_tiles_plain(gather_rows_plain(table, nb, wt), rt, seg,
                            num_segments=num_segments, tile_rows=tile_rows,
                            carry=carry)


def gram_solve_tiles_plain(g, rt, seg, reg, lseg, *, num_segments,
                           tile_rows, lam=0.0, reg_mode="diag", carry=None,
                           units=None):
    """The plain PyTorch version of ``gram_solve_tiles``: the plain sums,
    the raw ``lseg`` row, then K1's plain ridge + Cholesky solve."""
    return _solve_plain(gram_tiles_plain(g, rt, seg,
                                         num_segments=num_segments,
                                         tile_rows=tile_rows, carry=carry),
                        reg, lseg, lam, reg_mode)


def gram_solve_gather_plain(table, nb, wt, rt, seg, reg, lseg, *,
                            num_segments, tile_rows, lam=0.0,
                            reg_mode="diag", carry=None, units=None):
    """The plain PyTorch version of K6: ``gather_rows_plain`` then
    ``gram_solve_tiles_plain``."""
    return gram_solve_tiles_plain(
        gather_rows_plain(table, nb, wt), rt, seg, reg, lseg,
        num_segments=num_segments, tile_rows=tile_rows, lam=lam,
        reg_mode=reg_mode, carry=carry)


def gram_tiles_dense_plain(g, rt, meta, *, num_segments, tile_rows,
                           num_tiles, num_groups, block_rows, carry=None,
                           units=None):
    """The plain PyTorch version of ``gram_tiles_dense``: windowed tiles of
    the stream, masked einsums, segment sum — the indexing of
    ``_emulate_gram_dense``."""
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    m = nt // ng
    meta = meta.long()
    gblk = meta[:ng]
    lb = meta[ng:ng + nt]
    lo = meta[ng + nt:ng + 2 * nt]
    hi = meta[ng + 2 * nt:ng + 3 * nt]
    seg = meta[ng + 3 * nt:ng + 4 * nt]
    absrow = gblk.repeat_interleave(m) * bg + lb
    rows = torch.arange(t, device=meta.device)
    gt = g.float()[absrow[:, None] + rows[None, :]]  # [NT, T, k]
    keep = (rows[None, :] >= lo[:, None]) & (rows[None, :] < hi[:, None])
    gm = torch.where(keep[..., None], gt, torch.zeros((), dtype=gt.dtype,
                                                      device=gt.device))
    a_t = torch.einsum("ntk,ntl->nkl", gm, gt)
    b_t = torch.einsum("ntk,nt->nk", gt, rt.view(nt, t))
    return _segment_sums(a_t, b_t, seg, num_segments, carry)


def gram_tiles_dense_gather_plain(table, nb, wt, rt, meta, *, num_segments,
                                  tile_rows, num_tiles, num_groups,
                                  block_rows, carry=None, units=None):
    """The plain PyTorch version of ``gram_tiles_dense_gather`` (and K3's
    Gram): ``gather_rows_plain`` then ``gram_tiles_dense_plain``."""
    return gram_tiles_dense_plain(
        gather_rows_plain(table, nb, wt), rt, meta,
        num_segments=num_segments, tile_rows=tile_rows, num_tiles=num_tiles,
        num_groups=num_groups, block_rows=block_rows, carry=carry)


def gram_solve_tiles_dense_plain(g, rt, meta, reg, lseg, *, num_segments,
                                 tile_rows, num_tiles, num_groups,
                                 block_rows, lam=0.0, reg_mode="diag",
                                 carry=None, units=None):
    """The plain PyTorch version of ``gram_solve_tiles_dense``: the dense
    plain sums, the raw ``lseg`` row, ridge + Cholesky solve."""
    return _solve_plain(gram_tiles_dense_plain(
        g, rt, meta, num_segments=num_segments, tile_rows=tile_rows,
        num_tiles=num_tiles, num_groups=num_groups, block_rows=block_rows,
        carry=carry), reg, lseg, lam, reg_mode)


def gram_solve_dense_plain(table, nb, wt, rt, meta, reg, lseg, *,
                           num_segments, tile_rows, num_tiles, num_groups,
                           block_rows, lam, reg_mode="diag", carry=None,
                           units=None):
    """The plain PyTorch version of K3: ``gather_rows_plain`` then
    ``gram_solve_tiles_dense_plain``."""
    return gram_solve_tiles_dense_plain(
        gather_rows_plain(table, nb, wt), rt, meta, reg, lseg,
        num_segments=num_segments, tile_rows=tile_rows, num_tiles=num_tiles,
        num_groups=num_groups, block_rows=block_rows, lam=lam,
        reg_mode=reg_mode, carry=carry)


# -- the contracts the wrappers share -----------------------------------------

def _check_tile_chunk(c, seg, tile_rows):
    """The tile-chunk contracts of the JAX entry points; returns NT."""
    if c % tile_rows != 0:
        raise ValueError(
            f"entry count {c} not divisible by tile_rows {tile_rows}")
    nt = c // tile_rows
    if tuple(seg.shape) != (nt,):
        raise ValueError(f"seg shape {tuple(seg.shape)} != ({nt},)")
    return nt


def _check_dense_chunk(c, rt, meta, *, tile_rows, num_tiles, num_groups,
                       block_rows):
    """The dense-stream chunk contracts of the JAX entry points."""
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    if nt % ng != 0:
        raise ValueError(f"num_tiles {nt} not divisible by num_groups {ng}")
    if tuple(rt.shape) != (nt * t,):
        raise ValueError(f"rt shape {tuple(rt.shape)} != ({nt * t},)")
    if tuple(meta.shape) != (ng + 4 * nt,):
        raise ValueError(f"meta shape {tuple(meta.shape)} != ({ng + 4 * nt},)")
    if c % bg != 0 or bg < t:
        raise ValueError(f"stream length {c} not a multiple of block_rows "
                         f"{bg} >= tile_rows {t}")


def _check_rank(name, k, cap=MAX_RANK):
    if not 1 <= k <= cap:
        raise ValueError(f"{name} supports rank 1..{cap}, got {k}")


def _carry_on(carry, k, dev):
    """(ca, cb, cin) checked and on ``dev``, or three Nones."""
    if carry is None:
        return None, None, None
    ca, cb, cin = carry
    require(ca, "carry a", torch.float32, (k, k))
    require(cb, "carry b", torch.float32, (k,))
    return ca, cb, scalar_on(cin, dev, torch.float32)


def _gram_out(num_segments, k, dev):
    return (torch.empty((num_segments, k, k), dtype=torch.float32, device=dev),
            torch.empty((num_segments, k), dtype=torch.float32, device=dev))


def _solve_out(num_segments, k, dev):
    return (torch.empty((num_segments, k), dtype=torch.float32, device=dev),
            torch.zeros((k, k), dtype=torch.float32, device=dev),
            torch.zeros((k,), dtype=torch.float32, device=dev))


def _plan_args(units, derive, k, dev, solve):
    """The C entry's plan arguments (units, nu, splits, nsp, scratch[,
    tickets]) and the tensors they point at: ``units`` (a
    ``gram_units.UnitPlan``, as the device upload plans it) or, when None,
    ``derive()``'s plan on the device.  The wrapper allocates the split
    units' scratch and, for the solve shape, zeroes the kernels' nu + nsp
    tickets."""
    plan = derive() if units is None else units
    nu, nsp = plan.units.shape[0], plan.splits.shape[0]
    require(plan.units, "units", torch.int32, (nu, 4))
    require(plan.splits, "unit splits", torch.int32, (nsp,))
    if plan.units.device != dev or plan.splits.device != dev:
        raise ValueError(f"unit plan on {plan.units.device}, kernel on {dev}")
    scratch = torch.empty((plan.scratch_rows if nsp else 0, k * k + k),
                          dtype=torch.float32, device=dev)
    p = _build.ptr
    args = [p(plan.units), nu, p(plan.splits), nsp, p(scratch)]
    keep = [plan, scratch]
    if solve:
        keep.append(torch.zeros(nu + nsp, dtype=torch.int32, device=dev))
        args.append(p(keep[-1]))
    return args, keep


# -- the gather route: the table read by index inside the kernel --------------

def gram_gather(table, nb, wt, rt, seg, *, num_segments, tile_rows,
                carry=None, units=None):
    """K2: per-segment (A [S,k,k], b [S,k]) of one tiled chunk.

    table [F,k] f32, bf16 or int8 (raw: no zero row; int8 weights carry
    the folded scale); nb/wt/rt [C] (int32 / f32 / f32); seg [C/T] int32
    owner per tile, sorted; ``carry`` = (ca [k,k], cb [k],
    cin scalar) folds cin·(ca, cb) into segment 0; ``units`` = the chunk's
    work-unit plan (``gram_units``; None: derived on the device).
    """
    c = nb.shape[0]
    f, k = table.shape
    t = tile_rows
    nt = _check_tile_chunk(c, seg, t)
    if not on_cuda(table, nb, wt, rt, seg):
        return gram_gather_plain(table, nb, wt, rt, seg,
                                 num_segments=num_segments, tile_rows=t,
                                 carry=carry)
    _check_rank("gram_gather", k, MAX_SPLIT_RANK)
    kind = table_kind(table, "table", (f, k), TABLE_DTYPES)
    require(nb, "nb", torch.int32, (c,))
    require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    ca, cb, cin = _carry_on(carry, k, table.device)
    a, b = _gram_out(num_segments, k, table.device)
    plan, _keep = _plan_args(
        units, lambda: derive_tile_units(seg, t, num_segments), k,
        table.device, solve=False)
    fn = _build.function("gram_gather", "cfk_gram_gather", _GATHER_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), kind, f, k, p(nb), p(wt), p(rt), *plan, p(ca), p(cb),
            p(cin), p(a), p(b), table.device.index or 0, stream_of(table))
    _build.check(rc, "gram_gather")
    gram_gather.launches += 1
    return a, b


gram_gather.launches = 0


def gram_tiles_dense_gather(table, nb, wt, rt, meta, *, num_segments,
                            tile_rows, num_tiles, num_groups, block_rows,
                            carry=None, units=None):
    """One dense-stream chunk's per-segment (A [S,k,k], b [S,k]) — K3's
    Gram without its epilogue.

    table [F,k] f32, bf16 or int8; nb [C] int32 dense stream (padding →
    F); wt [C] f32 per-entry weight (int8: the folded scale) or None (unit); rt [NT·T] f32 tile-aligned
    b-coefficients; meta [NG+4·NT] int32 (g_blk ‖ lb ‖ lo ‖ hi ‖ seg);
    ``carry`` = (ca, cb, cin) folds cin·(ca, cb) into segment 0; ``units``
    = the work-unit plan (None: derived on the device).  A segment owning
    no tile comes back as zeros.
    """
    c = nb.shape[0]
    f, k = table.shape
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    _check_dense_chunk(c, rt, meta, tile_rows=t, num_tiles=nt,
                       num_groups=ng, block_rows=bg)
    if not on_cuda(table, nb, wt, rt, meta):
        return gram_tiles_dense_gather_plain(
            table, nb, wt, rt, meta, num_segments=num_segments, tile_rows=t,
            num_tiles=nt, num_groups=ng, block_rows=bg, carry=carry)
    _check_rank("gram_tiles_dense_gather", k, MAX_SPLIT_RANK)
    dev = table.device
    kind = table_kind(table, "table", (f, k), TABLE_DTYPES)
    _check_int8_weights(table, wt, "gram_tiles_dense_gather")
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    ca, cb, cin = _carry_on(carry, k, dev)
    a, b = _gram_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_dense_units(meta, t, nt, ng, num_segments), k,
        dev, solve=False)
    fn = _build.function("gram_tiles_dense_gather",
                         "cfk_gram_tiles_dense_gather", _DENSE_GRAM_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), kind, f, k, p(nb), p(wt), p(rt), p(meta), nt, ng, t,
            bg, *plan, p(ca), p(cb), p(cin), p(a), p(b), dev.index or 0,
            stream_of(table))
    _build.check(rc, "gram_tiles_dense_gather")
    gram_tiles_dense_gather.launches += 1
    return a, b


gram_tiles_dense_gather.launches = 0


def gram_solve_dense(table, nb, wt, rt, meta, reg, lseg, *, num_segments,
                     tile_rows, num_tiles, num_groups, block_rows, lam,
                     reg_mode="diag", carry=None, units=None):
    """K3: one dense-stream chunk: (x [S,k], carry_a [k,k], carry_b [k]).

    table [F,k] f32, bf16 or int8; nb [C] int32 dense stream (padding →
    F); wt [C] f32 per-entry weight (int8: the folded scale) or None (unit); rt [NT·T] f32 tile-aligned
    b-coefficients; meta [NG+4·NT] int32 (g_blk ‖ lb ‖ lo ‖ hi ‖ seg); reg
    [S] counts (diag; trash row floored by the caller) or [k,k] (matrix);
    lseg = the segment whose RAW (A, b) is returned as the next carry;
    ``carry`` = (ca, cb, cin) folded into segment 0; ``units`` = the
    work-unit plan (None: derived on the device).
    """
    c = nb.shape[0]
    f, k = table.shape
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    _check_dense_chunk(c, rt, meta, tile_rows=t, num_tiles=nt,
                       num_groups=ng, block_rows=bg)
    check_reg(reg, reg_mode, num_segments, k)
    _check_rank("gram_solve_dense", k)
    if not on_cuda(table, nb, wt, rt, meta, reg):
        return gram_solve_dense_plain(
            table, nb, wt, rt, meta, reg, lseg, num_segments=num_segments,
            tile_rows=t, num_tiles=nt, num_groups=ng, block_rows=bg, lam=lam,
            reg_mode=reg_mode, carry=carry,
        )
    dev = table.device
    kind = table_kind(table, "table", (f, k), TABLE_DTYPES)
    _check_int8_weights(table, wt, "gram_solve_dense")
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x, ca_out, cb_out = _solve_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_dense_units(meta, t, nt, ng, num_segments), k,
        dev, solve=True)
    fn = _build.function("gram_solve_dense", "cfk_gram_solve_dense",
                         _DENSE_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), kind, f, k, p(nb), p(wt), p(rt), p(meta), nt, ng, t,
            bg, *plan, p(reg32), REG_MODES[reg_mode], float(lam),
            p(lseg_d), p(ca), p(cb), p(cin), p(x), p(ca_out), p(cb_out),
            dev.index or 0, stream_of(table))
    _build.check(rc, "gram_solve_dense")
    gram_solve_dense.launches += 1
    return x, ca_out, cb_out


gram_solve_dense.launches = 0


def gram_solve_gather(table, nb, wt, rt, seg, reg, lseg, *, num_segments,
                      tile_rows, lam=0.0, reg_mode="diag", carry=None,
                      units=None):
    """K6: one chunk of [T]-row tiles gathered, summed per owner segment,
    regularized and solved — (x [S,k], carry_a [k,k], carry_b [k]).

    table [F,k] f32, bf16 or int8; nb/wt/rt [C] (int32 / f32 / f32; nb
    outside [0, F) is the zero row); seg [C/T] int32 owner per tile, sorted; reg [S] counts
    (diag) or [k,k] (matrix); lseg = the segment whose RAW (A, b) is
    returned as the next carry; ``carry`` = (ca, cb, cin) folds cin·(ca,
    cb) into segment 0; ``units`` = the work-unit plan (None: derived on
    the device).  A segment owning no tile solves to x = 0.
    """
    c = nb.shape[0]
    f, k = table.shape
    t = tile_rows
    nt = _check_tile_chunk(c, seg, t)
    check_reg(reg, reg_mode, num_segments, k)
    _check_rank("gram_solve_gather", k)
    if not on_cuda(table, nb, wt, rt, seg, reg):
        return gram_solve_gather_plain(
            table, nb, wt, rt, seg, reg, lseg, num_segments=num_segments,
            tile_rows=t, lam=lam, reg_mode=reg_mode, carry=carry)
    dev = table.device
    kind = table_kind(table, "table", (f, k), TABLE_DTYPES)
    require(nb, "nb", torch.int32, (c,))
    require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x, ca_out, cb_out = _solve_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_tile_units(seg, t, num_segments), k, dev,
        solve=True)
    fn = _build.function("gram_solve_gather", "cfk_gram_solve_gather",
                         _SOLVE_GATHER_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), kind, f, k, p(nb), p(wt), p(rt), *plan, p(reg32),
            REG_MODES[reg_mode], float(lam), p(lseg_d), p(ca), p(cb), p(cin),
            p(x), p(ca_out), p(cb_out), dev.index or 0, stream_of(table))
    _build.check(rc, "gram_solve_gather")
    gram_solve_gather.launches += 1
    return x, ca_out, cb_out


gram_solve_gather.launches = 0


# -- the materialized-stream route: K5's stream read by the twins -------------

def gram_tiles(g, rt, seg, *, num_segments, tile_rows, carry=None,
               units=None):
    """Per-segment (A [S,k,k], b [S,k]) of one tiled chunk's gathered
    stream — K2's twin on the materialized-stream schedule.

    g [C,k] f32 or bf16 (``gather_rows``' stream: zero rows at padding); rt
    [C] f32
    b-coefficients; seg [C/T] int32 owner per tile, sorted; ``carry`` =
    (ca [k,k], cb [k], cin scalar) folds cin·(ca, cb) into segment 0;
    ``units`` = the work-unit plan (None: derived on the device).
    """
    c, k = g.shape
    t = tile_rows
    nt = _check_tile_chunk(c, seg, t)
    if not on_cuda(g, rt, seg):
        return gram_tiles_plain(g, rt, seg, num_segments=num_segments,
                                tile_rows=t, carry=carry)
    _check_rank("gram_tiles", k, MAX_SPLIT_RANK)
    dev = g.device
    kind = table_kind(g, "g", (c, k), STREAM_DTYPES)
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    ca, cb, cin = _carry_on(carry, k, dev)
    a, b = _gram_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_tile_units(seg, t, num_segments), k, dev,
        solve=False)
    fn = _build.function("gram_tiles", "cfk_gram_tiles", _TILES_ARGTYPES)
    p = _build.ptr
    rc = fn(p(g), kind, k, p(rt), *plan, p(ca), p(cb), p(cin), p(a), p(b),
            dev.index or 0, stream_of(g))
    _build.check(rc, "gram_tiles")
    gram_tiles.launches += 1
    return a, b


gram_tiles.launches = 0


def gram_solve_tiles(g, rt, seg, reg, lseg, *, num_segments, tile_rows,
                     lam=0.0, reg_mode="diag", carry=None, units=None):
    """One tiled chunk's gathered stream summed per owner segment,
    regularized and solved — (x [S,k], carry_a [k,k], carry_b [k]); K6's
    twin on the materialized-stream schedule.

    g [C,k] f32 or bf16 (zero rows at padding); rt [C] f32; seg [C/T]
    int32, sorted;
    reg [S] counts (diag) or [k,k] (matrix); lseg = the segment whose RAW
    (A, b) is returned as the next carry; ``carry`` = (ca, cb, cin) folded
    into segment 0; ``units`` = the work-unit plan (None: derived on the
    device).  A segment owning no tile solves to x = 0.
    """
    c, k = g.shape
    t = tile_rows
    nt = _check_tile_chunk(c, seg, t)
    check_reg(reg, reg_mode, num_segments, k)
    _check_rank("gram_solve_tiles", k)
    if not on_cuda(g, rt, seg, reg):
        return gram_solve_tiles_plain(
            g, rt, seg, reg, lseg, num_segments=num_segments, tile_rows=t,
            lam=lam, reg_mode=reg_mode, carry=carry)
    dev = g.device
    kind = table_kind(g, "g", (c, k), STREAM_DTYPES)
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x, ca_out, cb_out = _solve_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_tile_units(seg, t, num_segments), k, dev,
        solve=True)
    fn = _build.function("gram_solve_tiles", "cfk_gram_solve_tiles",
                         _SOLVE_TILES_ARGTYPES)
    p = _build.ptr
    rc = fn(p(g), kind, k, p(rt), *plan, p(reg32),
            REG_MODES[reg_mode], float(lam), p(lseg_d), p(ca), p(cb), p(cin),
            p(x), p(ca_out), p(cb_out), dev.index or 0, stream_of(g))
    _build.check(rc, "gram_solve_tiles")
    gram_solve_tiles.launches += 1
    return x, ca_out, cb_out


gram_solve_tiles.launches = 0


def gram_tiles_dense(g, rt, meta, *, num_segments, tile_rows, num_tiles,
                     num_groups, block_rows, carry=None, units=None):
    """One dense-stream chunk's per-segment (A [S,k,k], b [S,k]) from its
    gathered stream — ``gram_tiles_dense_gather``'s twin on the
    materialized-stream schedule.

    g [C,k] f32 or bf16 stream-aligned (zero rows at padding); rt [NT·T] f32
    tile-aligned b-coefficients; meta [NG+4·NT] int32 (g_blk ‖ lb ‖ lo ‖ hi
    ‖ seg); ``carry`` = (ca, cb, cin) folds cin·(ca, cb) into segment 0;
    ``units`` = the work-unit plan (None: derived on the device).  A
    segment owning no tile comes back as zeros.
    """
    c, k = g.shape
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    _check_dense_chunk(c, rt, meta, tile_rows=t, num_tiles=nt,
                       num_groups=ng, block_rows=bg)
    if not on_cuda(g, rt, meta):
        return gram_tiles_dense_plain(
            g, rt, meta, num_segments=num_segments, tile_rows=t,
            num_tiles=nt, num_groups=ng, block_rows=bg, carry=carry)
    _check_rank("gram_tiles_dense", k, MAX_SPLIT_RANK)
    dev = g.device
    kind = table_kind(g, "g", (c, k), STREAM_DTYPES)
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    ca, cb, cin = _carry_on(carry, k, dev)
    a, b = _gram_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_dense_units(meta, t, nt, ng, num_segments), k,
        dev, solve=False)
    fn = _build.function("gram_tiles_dense", "cfk_gram_tiles_dense",
                         _TILES_DENSE_ARGTYPES)
    p = _build.ptr
    rc = fn(p(g), kind, k, p(rt), p(meta), nt, ng, t, bg, *plan, p(ca),
            p(cb), p(cin), p(a), p(b), dev.index or 0, stream_of(g))
    _build.check(rc, "gram_tiles_dense")
    gram_tiles_dense.launches += 1
    return a, b


gram_tiles_dense.launches = 0


def gram_solve_tiles_dense(g, rt, meta, reg, lseg, *, num_segments,
                           tile_rows, num_tiles, num_groups, block_rows,
                           lam=0.0, reg_mode="diag", carry=None, units=None):
    """One dense-stream chunk from its gathered stream: (x [S,k], carry_a
    [k,k], carry_b [k]) — K3's twin on the materialized-stream schedule.

    g [C,k] f32 or bf16 stream-aligned; rt [NT·T] f32 tile-aligned; meta
    [NG+4·NT] int32; reg [S] counts (diag) or [k,k] (matrix); lseg = the
    segment whose RAW (A, b) is returned as the next carry; ``carry`` =
    (ca, cb, cin) folded into segment 0; ``units`` = the work-unit plan
    (None: derived on the device).
    """
    c, k = g.shape
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    _check_dense_chunk(c, rt, meta, tile_rows=t, num_tiles=nt,
                       num_groups=ng, block_rows=bg)
    check_reg(reg, reg_mode, num_segments, k)
    _check_rank("gram_solve_tiles_dense", k)
    if not on_cuda(g, rt, meta, reg):
        return gram_solve_tiles_dense_plain(
            g, rt, meta, reg, lseg, num_segments=num_segments, tile_rows=t,
            num_tiles=nt, num_groups=ng, block_rows=bg, lam=lam,
            reg_mode=reg_mode, carry=carry)
    dev = g.device
    kind = table_kind(g, "g", (c, k), STREAM_DTYPES)
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x, ca_out, cb_out = _solve_out(num_segments, k, dev)
    plan, _keep = _plan_args(
        units, lambda: derive_dense_units(meta, t, nt, ng, num_segments), k,
        dev, solve=True)
    fn = _build.function("gram_solve_tiles_dense",
                         "cfk_gram_solve_tiles_dense",
                         _SOLVE_TILES_DENSE_ARGTYPES)
    p = _build.ptr
    rc = fn(p(g), kind, k, p(rt), p(meta), nt, ng, t, bg, *plan, p(reg32),
            REG_MODES[reg_mode], float(lam), p(lseg_d), p(ca), p(cb), p(cin),
            p(x), p(ca_out), p(cb_out), dev.index or 0, stream_of(g))
    _build.check(rc, "gram_solve_tiles_dense")
    gram_solve_tiles_dense.launches += 1
    return x, ca_out, cb_out


gram_solve_tiles_dense.launches = 0
