"""The gathered-Gram kernels and their plain PyTorch versions: K2
gram_gather, K3 gram_solve_dense, K5 gather_rows, K6 gram_solve_gather and
gram_tiles_dense_gather (``csrc/gram_gather.cu``, ``gram_solve_dense.cu``,
``gather_rows.cu``, ``gram_solve_gather.cu``,
``gram_tiles_dense_gather.cu``).

Counterparts of ``cfk_tpu/ops/pallas/gram_kernel.py``:

- ``gram_gather`` ↔ ``gram_tiles_gather_pallas`` (accum-mode chunks): the
  per-owner-segment Gram A_s = Σ g gᵀ and RHS b_s = Σ rt·g of one chunk of
  [T]-row tiles, g = table[nb]·wt gathered in the kernel.
- ``gram_solve_dense`` ↔ ``gram_solve_tiles_dense_gather_pallas``
  (dense-stream chunks): the same sums over the dense stream's windowed
  tiles, plus the carry fold, the raw carry row at ``lseg``, the ridge and
  the solve — the Gram never leaves the kernel.
- ``gather_rows`` ↔ ``gather_rows_pallas``: the materialized gathered stream
  ``out[i] = table[nb[i]]·wt[i]`` the subspace sweeps consume.
- ``gram_solve_gather`` ↔ ``gram_solve_tiles_gather_pallas``: K2's sums plus
  K3's epilogue (carry fold, raw ``lseg`` row, ridge, solve) — the bucketed
  layout's width classes (one tile per entity) and the padded stream mode's
  chunks.
- ``gram_tiles_dense_gather`` ↔ ``gram_tiles_dense_gather_pallas``: K3
  without its epilogue — the dense-stream chunk's carry-folded (A, b), for
  the split schedule (K1 solves them).

Index F (the table height) is the virtual zero row padding entries point at.
Segments owning no tile come back as zeros (solve: x = 0); the TPU kernels
leave them unwritten, and callers route them to the trash row either way.
"""

from __future__ import annotations

import ctypes

import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, scalar_on, stream_of
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    MAX_RANK,
    REG_MODES,
    check_reg,
    reg_solve_plain,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_GATHER_ARGTYPES = (
    _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P,
)
_DENSE_ARGTYPES = (
    _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _F, _P, _P, _P,
    _P, _P, _P, _P, _I, _P,
)
_ROWS_ARGTYPES = (_P, _I, _I, _P, _P, ctypes.c_longlong, _I, _P, _I, _P)
_DENSE_GRAM_ARGTYPES = (
    _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I,
    _P,
)
_SOLVE_GATHER_ARGTYPES = (
    _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F, _P, _P, _P, _P, _P,
    _P, _P, _I, _P,
)


def gather_rows_plain(table: torch.Tensor, nb: torch.Tensor,
                      wt: torch.Tensor | None) -> torch.Tensor:
    """g = table[nb]·wt with every index outside [0, F) reading the zero
    row (the JAX twin appends it and clamps; the kernels test the index)."""
    f, k = table.shape
    fz = torch.cat([table, table.new_zeros(1, k)])
    idx = nb.long()
    g = fz[torch.where((idx >= 0) & (idx < f), idx, f)]
    return g if wt is None else g * wt[:, None]


def gather_rows(table: torch.Tensor, nb: torch.Tensor,
                wt: torch.Tensor | None = None) -> torch.Tensor:
    """K5: the gathered stream ``out [C,k] = table[nb]·wt``.

    table [F,k] f32 (raw: no zero row); nb [C] int32 — an index outside
    [0, F) reads the zero row; wt [C] f32 premultiply or None (no multiply).
    Only an f32 table is taken on CUDA: bf16/int8 tables belong to the
    quantized-training path, which is not ported.
    """
    c = nb.shape[0]
    f, k = table.shape
    if not on_cuda(table, nb, wt):
        return gather_rows_plain(table, nb, wt)
    require(table, "table", torch.float32, (f, k))
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    out = torch.empty((c, k), dtype=torch.float32, device=table.device)
    # 16-byte loads and stores need k % 4 == 0 and an aligned table base.
    vec = int(k % 4 == 0 and table.data_ptr() % 16 == 0)
    fn = _build.function("gather_rows", "cfk_gather_rows", _ROWS_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), f, k, p(nb), p(wt), c, vec, p(out),
            table.device.index or 0, stream_of(table))
    _build.check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


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


def gram_gather_plain(table, nb, wt, rt, seg, *, num_segments, tile_rows,
                      carry=None):
    """The plain PyTorch version of K2: gather, tile einsums, segment sum
    by ``index_add_`` — the XLA twin ``_emulate_gram_tiles``."""
    k = table.shape[-1]
    gt = gather_rows_plain(table, nb, wt).view(-1, tile_rows, k)
    a_t = torch.einsum("ntk,ntl->nkl", gt, gt)
    b_t = torch.einsum("ntk,nt->nk", gt, rt.view(-1, tile_rows))
    return _segment_sums(a_t, b_t, seg, num_segments, carry)


def gram_gather(table, nb, wt, rt, seg, *, num_segments, tile_rows,
                carry=None):
    """Per-segment (A [S,k,k], b [S,k]) of one tiled chunk.

    table [F,k] f32 (raw: no zero row); nb/wt/rt [C] (int32 / f32 / f32);
    seg [C/T] int32 owner per tile, sorted; ``carry`` = (ca [k,k], cb [k],
    cin scalar) folds cin·(ca, cb) into segment 0.
    """
    c = nb.shape[0]
    f, k = table.shape
    t = tile_rows
    if c % t != 0:
        raise ValueError(f"entry count {c} not divisible by tile_rows {t}")
    nt = c // t
    if tuple(seg.shape) != (nt,):
        raise ValueError(f"seg shape {tuple(seg.shape)} != ({nt},)")
    if not on_cuda(table, nb, wt, rt, seg):
        return gram_gather_plain(table, nb, wt, rt, seg,
                                 num_segments=num_segments, tile_rows=t,
                                 carry=carry)
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"gram_gather supports rank 1..{MAX_RANK}, got {k}")
    require(table, "table", torch.float32, (f, k))
    require(nb, "nb", torch.int32, (c,))
    require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    ca, cb, cin = _carry_on(carry, k, table.device)
    a = torch.empty((num_segments, k, k), dtype=torch.float32,
                    device=table.device)
    b = torch.empty((num_segments, k), dtype=torch.float32, device=table.device)
    fn = _build.function("gram_gather", "cfk_gram_gather", _GATHER_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), f, k, p(nb), p(wt), p(rt), p(seg), nt, t, num_segments,
            p(ca), p(cb), p(cin), p(a), p(b), table.device.index or 0,
            stream_of(table))
    _build.check(rc, "gram_gather")
    gram_gather.launches += 1
    return a, b


gram_gather.launches = 0


def gram_tiles_dense_gather_plain(table, nb, wt, rt, meta, *, num_segments,
                                  tile_rows, num_tiles, num_groups,
                                  block_rows, carry=None):
    """The plain PyTorch version of ``gram_tiles_dense_gather`` (and K3's
    Gram): windowed tiles of the gathered stream, masked einsums, segment
    sum — the indexing of ``_emulate_gram_dense``."""
    k = table.shape[-1]
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    m = nt // ng
    g = gather_rows_plain(table, nb, wt)
    meta = meta.long()
    gblk = meta[:ng]
    lb = meta[ng:ng + nt]
    lo = meta[ng + nt:ng + 2 * nt]
    hi = meta[ng + 2 * nt:ng + 3 * nt]
    seg = meta[ng + 3 * nt:ng + 4 * nt]
    absrow = gblk.repeat_interleave(m) * bg + lb
    rows = torch.arange(t, device=meta.device)
    gt = g[absrow[:, None] + rows[None, :]]  # [NT, T, k]
    keep = (rows[None, :] >= lo[:, None]) & (rows[None, :] < hi[:, None])
    gm = torch.where(keep[..., None], gt, torch.zeros((), dtype=gt.dtype,
                                                      device=gt.device))
    a_t = torch.einsum("ntk,ntl->nkl", gm, gt)
    b_t = torch.einsum("ntk,nt->nk", gt, rt.view(nt, t))
    return _segment_sums(a_t, b_t, seg, num_segments, carry)


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


def _carry_on(carry, k, dev):
    """(ca, cb, cin) checked and on ``dev``, or three Nones."""
    if carry is None:
        return None, None, None
    ca, cb, cin = carry
    require(ca, "carry a", torch.float32, (k, k))
    require(cb, "carry b", torch.float32, (k,))
    return ca, cb, scalar_on(cin, dev, torch.float32)


def gram_tiles_dense_gather(table, nb, wt, rt, meta, *, num_segments,
                            tile_rows, num_tiles, num_groups, block_rows,
                            carry=None):
    """One dense-stream chunk's per-segment (A [S,k,k], b [S,k]) — K3's
    Gram without its epilogue.

    table [F,k] f32; nb [C] int32 dense stream (padding → F); wt [C] f32
    per-entry weight or None (unit); rt [NT·T] f32 tile-aligned
    b-coefficients; meta [NG+4·NT] int32 (g_blk ‖ lb ‖ lo ‖ hi ‖ seg);
    ``carry`` = (ca, cb, cin) folds cin·(ca, cb) into segment 0.  A segment
    owning no tile comes back as zeros.
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
    if not 1 <= k <= MAX_RANK:
        raise ValueError(
            f"gram_tiles_dense_gather supports rank 1..{MAX_RANK}, got {k}")
    dev = table.device
    require(table, "table", torch.float32, (f, k))
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    ca, cb, cin = _carry_on(carry, k, dev)
    a = torch.empty((num_segments, k, k), dtype=torch.float32, device=dev)
    b = torch.empty((num_segments, k), dtype=torch.float32, device=dev)
    fn = _build.function("gram_tiles_dense_gather",
                         "cfk_gram_tiles_dense_gather", _DENSE_GRAM_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), f, k, p(nb), p(wt), p(rt), p(meta), nt, ng, t, bg,
            num_segments, p(ca), p(cb), p(cin), p(a), p(b), dev.index or 0,
            stream_of(table))
    _build.check(rc, "gram_tiles_dense_gather")
    gram_tiles_dense_gather.launches += 1
    return a, b


gram_tiles_dense_gather.launches = 0


def gram_solve_dense_plain(table, nb, wt, rt, meta, reg, lseg, *,
                           num_segments, tile_rows, num_tiles, num_groups,
                           block_rows, lam, reg_mode="diag", carry=None):
    """The plain PyTorch version of K3: dense Gram, raw carry row at
    ``lseg``, ridge + Cholesky solve."""
    a, b = gram_tiles_dense_gather_plain(
        table, nb, wt, rt, meta, num_segments=num_segments,
        tile_rows=tile_rows, num_tiles=num_tiles, num_groups=num_groups,
        block_rows=block_rows, carry=carry,
    )
    ls = lseg.reshape(()).long() if isinstance(lseg, torch.Tensor) else lseg
    x = reg_solve_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    return x, a[ls].clone(), b[ls].clone()


def gram_solve_dense(table, nb, wt, rt, meta, reg, lseg, *, num_segments,
                     tile_rows, num_tiles, num_groups, block_rows, lam,
                     reg_mode="diag", carry=None):
    """One dense-stream chunk: (x [S,k], carry_a [k,k], carry_b [k]).

    table [F,k] f32; nb [C] int32 dense stream (padding → F); wt [C] f32
    per-entry weight or None (unit); rt [NT·T] f32 tile-aligned
    b-coefficients; meta [NG+4·NT] int32 (g_blk ‖ lb ‖ lo ‖ hi ‖ seg); reg
    [S] counts (diag; trash row floored by the caller) or [k,k] (matrix);
    lseg = the segment whose RAW (A, b) is returned as the next carry;
    ``carry`` = (ca, cb, cin) folded into segment 0.
    """
    c = nb.shape[0]
    f, k = table.shape
    t, nt, ng, bg = tile_rows, num_tiles, num_groups, block_rows
    _check_dense_chunk(c, rt, meta, tile_rows=t, num_tiles=nt,
                       num_groups=ng, block_rows=bg)
    check_reg(reg, reg_mode, num_segments, k)
    if not on_cuda(table, nb, wt, rt, meta, reg):
        return gram_solve_dense_plain(
            table, nb, wt, rt, meta, reg, lseg, num_segments=num_segments,
            tile_rows=t, num_tiles=nt, num_groups=ng, block_rows=bg, lam=lam,
            reg_mode=reg_mode, carry=carry,
        )
    if not 1 <= k <= MAX_RANK:
        raise ValueError(
            f"gram_solve_dense supports rank 1..{MAX_RANK}, got {k}")
    dev = table.device
    require(table, "table", torch.float32, (f, k))
    require(nb, "nb", torch.int32, (c,))
    if wt is not None:
        require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (nt * t,))
    require(meta, "meta", torch.int32, (ng + 4 * nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x = torch.empty((num_segments, k), dtype=torch.float32, device=dev)
    ca_out = torch.empty((k, k), dtype=torch.float32, device=dev)
    cb_out = torch.empty((k,), dtype=torch.float32, device=dev)
    fn = _build.function("gram_solve_dense", "cfk_gram_solve_dense",
                         _DENSE_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), f, k, p(nb), p(wt), p(rt), p(meta), nt, ng, t, bg,
            num_segments, p(reg32), REG_MODES[reg_mode], float(lam),
            p(lseg_d), p(ca), p(cb), p(cin), p(x), p(ca_out), p(cb_out),
            dev.index or 0, stream_of(table))
    _build.check(rc, "gram_solve_dense")
    gram_solve_dense.launches += 1
    return x, ca_out, cb_out


gram_solve_dense.launches = 0


def gram_solve_gather_plain(table, nb, wt, rt, seg, reg, lseg, *,
                            num_segments, tile_rows, lam=0.0,
                            reg_mode="diag", carry=None):
    """The plain PyTorch version of K6: K2's plain sums, the raw ``lseg``
    row, then K1's plain ridge + Cholesky solve."""
    a, b = gram_gather_plain(table, nb, wt, rt, seg,
                             num_segments=num_segments, tile_rows=tile_rows,
                             carry=carry)
    ls = lseg.reshape(()).long() if isinstance(lseg, torch.Tensor) else lseg
    x = reg_solve_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    return x, a[ls].clone(), b[ls].clone()


def gram_solve_gather(table, nb, wt, rt, seg, reg, lseg, *, num_segments,
                      tile_rows, lam=0.0, reg_mode="diag", carry=None):
    """K6: one chunk of [T]-row tiles gathered, summed per owner segment,
    regularized and solved — (x [S,k], carry_a [k,k], carry_b [k]).

    table [F,k] f32; nb/wt/rt [C] (int32 / f32 / f32; nb outside [0, F) is
    the zero row); seg [C/T] int32 owner per tile, sorted; reg [S] counts
    (diag) or [k,k] (matrix); lseg = the segment whose RAW (A, b) is
    returned as the next carry; ``carry`` = (ca, cb, cin) folds cin·(ca,
    cb) into segment 0.  A segment owning no tile solves to x = 0.
    """
    c = nb.shape[0]
    f, k = table.shape
    t = tile_rows
    if c % t != 0:
        raise ValueError(f"entry count {c} not divisible by tile_rows {t}")
    nt = c // t
    if tuple(seg.shape) != (nt,):
        raise ValueError(f"seg shape {tuple(seg.shape)} != ({nt},)")
    check_reg(reg, reg_mode, num_segments, k)
    if not on_cuda(table, nb, wt, rt, seg, reg):
        return gram_solve_gather_plain(
            table, nb, wt, rt, seg, reg, lseg, num_segments=num_segments,
            tile_rows=t, lam=lam, reg_mode=reg_mode, carry=carry)
    if not 1 <= k <= MAX_RANK:
        raise ValueError(
            f"gram_solve_gather supports rank 1..{MAX_RANK}, got {k}")
    dev = table.device
    require(table, "table", torch.float32, (f, k))
    require(nb, "nb", torch.int32, (c,))
    require(wt, "wt", torch.float32, (c,))
    require(rt, "rt", torch.float32, (c,))
    require(seg, "seg", torch.int32, (nt,))
    reg32 = reg.to(torch.float32).contiguous()
    lseg_d = scalar_on(lseg, dev, torch.int32)
    ca, cb, cin = _carry_on(carry, k, dev)
    x = torch.empty((num_segments, k), dtype=torch.float32, device=dev)
    ca_out = torch.zeros((k, k), dtype=torch.float32, device=dev)
    cb_out = torch.zeros((k,), dtype=torch.float32, device=dev)
    fn = _build.function("gram_solve_gather", "cfk_gram_solve_gather",
                         _SOLVE_GATHER_ARGTYPES)
    p = _build.ptr
    rc = fn(p(table), f, k, p(nb), p(wt), p(rt), p(seg), nt, t, num_segments,
            p(reg32), REG_MODES[reg_mode], float(lam), p(lseg_d), p(ca),
            p(cb), p(cin), p(x), p(ca_out), p(cb_out), dev.index or 0,
            stream_of(table))
    _build.check(rc, "gram_solve_gather")
    gram_solve_gather.launches += 1
    return x, ca_out, cb_out


gram_solve_gather.launches = 0
