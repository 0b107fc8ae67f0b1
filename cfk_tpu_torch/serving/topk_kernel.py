"""K4 topk_scores: batched score + top-K over an item table (``csrc/topk_scores.cu``).

Counterpart of ``cfk_tpu/serving/topk_kernel.py::topk_scores_pallas``.  For a
[B, k] batch of user factors it scores every row of the (optionally
quantized, ``ops.quant``) [M_pad, k] item table and returns each user's K
best (score, row) pairs.  Only the [B, K] result reaches the caller: no
[B, M] score matrix is ever written to device memory (the CUDA kernel keeps
scores in registers and candidates in shared memory; the plain version
scores one [B, tile_m] block at a time, as the JAX package's fold does).

The function, exactly as the JAX fold ``_score_tile_fold`` defines it:

- score = u · row in float32; an int8 row is dequantized element by element
  (``code · scale`` in f32) before the product; with a bf16 table ``u`` is
  rounded to bf16 first (``u.astype(bfloat16)``), products are exact in f32
  and sums are f32;
- a row whose global id ``row_offset + row`` is ≥ ``num_movies`` scores −inf
  (table padding; two-stage shortlists mask their padding tail this way);
- ``seen_tiles[t, b, :]`` lists in-tile columns of tile t (``tile_m`` rows)
  that user b has already rated; those score −inf;
- the result is the first K of the total order (score descending, id
  ascending), where empty slots (−inf, −1) rank above every −inf column —
  ``lax.top_k`` is stable and the carry comes first, so the JAX result is
  this order, ties included, with a −1 tail when fewer than K candidates
  exist.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, stream_of

# Seen-rectangle widths are multiples of this (``build_seen_tiles`` pads to
# a power of two of at least it), as the JAX kernel requires.
_SEEN_CHUNK = 16
# The CUDA kernel's limits (csrc/topk_scores.cu): its shared-memory
# candidate buffers are sized by the next power of two of k_top, and its
# user block by the rank.
MAX_K_TOP = 1024
MAX_RANK = 512
_ROWS_PER_STEP = 256  # table rows one CTA scores per step (one per thread)
_USERS_PER_CTA = 8
_MERGE_ENTRIES = 8192  # pass 2 sorts splits · pow2(k_top) ≤ this per user
_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
)


def _pow2_ceil(x: int, floor: int = 1) -> int:
    out = max(floor, 1)
    while out < x:
        out *= 2
    return out


def serve_compute_dtype(table_dtype: torch.dtype) -> torch.dtype:
    """The operand dtype of the score products: bf16 for a bf16 table (u is
    rounded to it), float32 otherwise (int8 rows dequantize to f32)."""
    return torch.bfloat16 if table_dtype == torch.bfloat16 else torch.float32


def build_seen_tiles(seen_movies, seen_indptr, batch_rows, *, num_movies,
                     tile_m, num_tiles: int | None = None,
                     min_width: int = _SEEN_CHUNK):
    """[NT, B, W] per-tile exclusion rectangle from a per-user CSR.

    ``seen_movies``/``seen_indptr`` is the CSR of already-rated movie rows by
    user row (sorted ascending within each user); ``batch_rows`` [B] selects
    the batch.  Entry [t, b, w] is the w-th in-tile column of batch user b's
    seen movies inside movie tile t, padded with ``tile_m``.  W is the pow2
    max per-(user, tile) count, at least ``min_width``.  Bit-identical to
    ``cfk_tpu.serving.topk_kernel.build_seen_tiles``.
    """
    nt = -(-num_movies // tile_m) if num_tiles is None else num_tiles
    b = len(batch_rows)
    batch_rows = np.asarray(batch_rows, dtype=np.int64)
    counts = (seen_indptr[batch_rows + 1] - seen_indptr[batch_rows]).astype(
        np.int64
    )
    rows = np.repeat(np.arange(b, dtype=np.int64), counts)
    flat = np.concatenate([
        np.arange(seen_indptr[r], seen_indptr[r + 1], dtype=np.int64)
        for r in batch_rows
    ]) if counts.sum() else np.zeros(0, np.int64)
    mv = seen_movies[flat].astype(np.int64)
    keep = mv < num_movies
    rows, mv = rows[keep], mv[keep]
    tile_of = mv // tile_m
    local = (mv % tile_m).astype(np.int32)
    # mv is sorted within each row, so (row, tile) groups are contiguous;
    # position within group = running index − group start.
    key = rows * nt + tile_of
    if key.size:
        starts = np.flatnonzero(np.concatenate(([True], key[1:] != key[:-1])))
        group_sizes = np.diff(np.concatenate((starts, [key.size])))
        pos = np.arange(key.size) - np.repeat(starts, group_sizes)
        width = int(group_sizes.max())
    else:
        pos = np.zeros(0, np.int64)
        width = 0
    w = _pow2_ceil(max(width, 1), min_width)
    out = np.full((nt, b, w), tile_m, dtype=np.int32)
    out[tile_of, rows, pos] = local
    return out


def _check_args(u, table, scale, seen_tiles, *, k_top, tile_m) -> None:
    """The contract of ``topk_scores_pallas``, with its error messages."""
    b, k = u.shape
    m_pad = table.shape[0]
    if table.shape[1] != k:
        raise ValueError(f"table rank {table.shape[1]} != user rank {k}")
    if m_pad % tile_m != 0:
        raise ValueError(
            f"table rows {m_pad} not divisible by tile_m {tile_m}; pad the "
            "table (serving.engine.pad_table does)"
        )
    if not 1 <= k_top:
        raise ValueError(f"k_top must be >= 1, got {k_top}")
    nt = m_pad // tile_m
    if seen_tiles is not None and tuple(seen_tiles.shape[:2]) != (nt, b):
        raise ValueError(
            f"seen_tiles shape {tuple(seen_tiles.shape)} != ({nt}, {b}, W)"
        )
    if seen_tiles is not None and seen_tiles.shape[2] % _SEEN_CHUNK != 0:
        raise ValueError(
            f"seen_tiles width {seen_tiles.shape[2]} must be a multiple of "
            f"{_SEEN_CHUNK} (build_seen_tiles pads it)"
        )
    if (scale is None) != (table.dtype != torch.int8):
        raise ValueError(
            "per-row scale required exactly when the table is int8 "
            "(ops.quant.quantize_table provides it)"
        )


def _score_block(u: torch.Tensor, tile: torch.Tensor,
                 scale: torch.Tensor | None) -> torch.Tensor:
    """[B, T] float32 scores of the batch against one block of rows."""
    if tile.dtype == torch.int8:
        tile_f = tile.to(torch.float32) * scale[:, None]
    else:
        tile_f = tile.to(torch.float32)
    uf = u.to(serve_compute_dtype(tile.dtype)).to(torch.float32)
    return uf @ tile_f.T


def topk_scores_plain(u, table, scale, seen_tiles, *, k_top, num_movies,
                      tile_m, row_offset=0):
    """The plain PyTorch version of K4: the JAX fold, tile by tile.

    Each [B, tile_m] score block is masked and concatenated after the [B, K]
    carry, and ``torch.sort(stable=True)`` re-selects — the carry first and
    ascending ids within a tile, so equal scores keep the lower id, as
    ``lax.top_k`` does (``torch.topk`` promises no order among ties).
    """
    _check_args(u, table, scale, seen_tiles, k_top=k_top, tile_m=tile_m)
    b = u.shape[0]
    dev = u.device
    neg = float("-inf")
    vals = torch.full((b, k_top), neg, dtype=torch.float32, device=dev)
    ids = torch.full((b, k_top), -1, dtype=torch.int32, device=dev)
    col = torch.arange(tile_m, device=dev)
    for t in range(table.shape[0] // tile_m):
        lo = t * tile_m
        sc = _score_block(u, table[lo:lo + tile_m],
                          None if scale is None else scale[lo:lo + tile_m])
        gid = int(row_offset) + lo + col
        sc = sc.masked_fill((gid >= num_movies)[None, :], neg)
        if seen_tiles is not None:
            c = seen_tiles[t].long()
            c = torch.where((c >= 0) & (c < tile_m), c, tile_m)
            hit = torch.zeros((b, tile_m + 1), dtype=torch.bool, device=dev)
            hit.scatter_(1, c, True)
            sc = sc.masked_fill(hit[:, :tile_m], neg)
        cat_v = torch.cat([vals, sc], dim=1)
        cat_i = torch.cat([ids, gid.to(torch.int32).expand(b, tile_m)], dim=1)
        order = torch.sort(cat_v, dim=1, descending=True,
                           stable=True).indices[:, :k_top]
        vals, ids = cat_v.gather(1, order), cat_i.gather(1, order)
    return vals, ids


def split_plan(b: int, m_pad: int, k_top: int, num_sms: int
               ) -> tuple[int, int]:
    """(splits, rows per split) of the CUDA kernel's pass 1.

    The grid is (user blocks of 8) × splits of the table rows, at most two
    CTAs per SM (one wave), capped so that pass 2 sorts at most ``_MERGE_ENTRIES``
    candidates per user; each split is a whole number of 256-row steps and
    none is empty."""
    steps = -(-m_pad // _ROWS_PER_STEP)
    blocks = -(-b // _USERS_PER_CTA)
    cap = max(_MERGE_ENTRIES // _pow2_ceil(k_top), 1)
    want = max(min(2 * num_sms // blocks, cap, steps), 1)
    per = -(-steps // want)
    return -(-steps // per), per * _ROWS_PER_STEP


def topk_scores(u, table, scale, seen_tiles, *, k_top, num_movies, tile_m,
                row_offset=0):
    """(scores [B, K] f32 descending, movie rows [B, K] int32).

    u [B, k] float32 (or bf16); table [M_pad, k] float32 / bfloat16 / int8
    codes; scale [M_pad] float32 exactly when the table is int8; seen_tiles
    [M_pad / tile_m, B, W] int32 (``build_seen_tiles``) or None.  Excluded
    and padding rows score −inf; when fewer than K candidates exist the
    tail ids are −1.  ``row_offset`` maps table rows to global ids (the
    two-stage rescore passes R_pad − R to mask the shortlist's padding).
    CPU tensors take ``topk_scores_plain``; CUDA tensors launch the kernel
    (two launches: per-split candidates, then the per-user merge) or raise.
    """
    _check_args(u, table, scale, seen_tiles, k_top=k_top, tile_m=tile_m)
    if not on_cuda(u, table, scale, seen_tiles):
        return topk_scores_plain(u, table, scale, seen_tiles, k_top=k_top,
                                 num_movies=num_movies, tile_m=tile_m,
                                 row_offset=row_offset)
    b, k = u.shape
    m_pad = table.shape[0]
    if k_top > MAX_K_TOP:
        raise ValueError(f"topk_scores on CUDA supports k_top <= {MAX_K_TOP} "
                         f"(shared-memory candidate buffers), got {k_top}")
    if k > MAX_RANK:
        raise ValueError(f"topk_scores on CUDA supports rank <= {MAX_RANK}, "
                         f"got {k}")
    if m_pad * k >= 1 << 31:
        raise ValueError(f"topk_scores on CUDA indexes the table with 32-bit "
                         f"offsets: {m_pad} x {k} elements is too many")
    if table.dtype not in _TABLE_KIND:
        raise TypeError(f"table must be float32, bfloat16 or int8, got "
                        f"{table.dtype}")
    require(table, "table", table.dtype, (m_pad, k))
    if scale is not None:
        require(scale, "scale", torch.float32, (m_pad,))
    w = 0
    if seen_tiles is not None:
        w = seen_tiles.shape[2]
        require(seen_tiles, "seen_tiles", torch.int32,
                (m_pad // tile_m, b, w))
    u32 = u.to(torch.float32).contiguous()
    dev = u.device
    vals = torch.empty((b, k_top), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k_top), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, ids
    splits, rows = split_plan(
        b, m_pad, k_top, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_v = torch.empty((b, splits, k_top), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, k_top), dtype=torch.int32, device=dev)
    fn = _build.function("topk_scores", "cfk_topk_scores", _ARGTYPES)
    rc = fn(_build.ptr(u32), _build.ptr(table), _TABLE_KIND[table.dtype],
            _build.ptr(scale), _build.ptr(seen_tiles), w, b, k, m_pad,
            int(num_movies), int(row_offset), int(tile_m), int(k_top),
            splits, rows, _build.ptr(part_v), _build.ptr(part_i),
            _build.ptr(vals), _build.ptr(ids), dev.index or 0,
            stream_of(u32))
    _build.check(rc, "topk_scores")
    topk_scores.launches += 2
    return vals, ids


topk_scores.launches = 0
