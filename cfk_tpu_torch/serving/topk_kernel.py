"""K4 topk_scores: batched score + top-K over an item table (``csrc/topk_scores.cu``).

Counterpart of ``cfk_tpu/serving/topk_kernel.py::topk_scores_pallas``.  For a
[B, k] batch of user factors it scores every row of the (optionally
quantized, ``ops.quant``) [M_pad, k] item table and returns each user's K
best (score, row) pairs.  Only the [B, K] result reaches the caller: no
[B, M] score matrix is ever written to device memory (the plain version
scores one [B, tile_m] block at a time, as the JAX package's fold does).

The CUDA kernel runs two launches.  Pass 1's grid is (user blocks of 16 or
32) × splits of the table's 256-row tiles (``split_plan``): a CTA scores a
[users, 256] tile at a time — FP32 FMAs from register micro-tiles for f32
and int8 tables (each int8 code times its row's scale, once per staged
slice, then the f32 products), ``mma.sync`` bf16 tensor-core products for a
bf16 table — then its warps select from the tile, each warp for its own
users: the scores above the user's running K-th best are sorted in
registers and merged into the user's sorted top list, whose K-th key is the
next tile's threshold.  Each split's top K per user goes to a [B, splits,
K] partial; pass 2 merges a user's splits, sorted list by sorted list.  The
rank is a loop bound (k is staged in slices).  The per-user lists live in
shared memory, so that route takes K ≤ ``MAX_K_TOP``; above it
``topk_scores_large_k`` runs three launches with its candidates in device
memory: pass 1's products writing every (user, row) key to a [B, M_pad]
workspace, a per-user radix select of the K-th key and compaction of the
keys at or above it, and a per-user bitonic sort that decodes the first K.

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
import functools
import threading

import numpy as np
import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, stream_of

# Seen-rectangle widths are multiples of this (``build_seen_tiles`` pads to
# a power of two of at least it), as the JAX kernel requires.
_SEEN_CHUNK = 16
# The two-launch route's largest K (csrc/topk_scores.cu): its per-user
# lists live in shared memory, pow2(k_top) keys each; a larger K takes the
# large-K route (``topk_scores_large_k``).
MAX_K_TOP = 1024
_TILE_ROWS = 256  # table rows of one pass-1 CTA tile
_CTAS_PER_SM = 2  # pass 1's grid aims at one wave of this many per SM
# Pass 2 merges splits sorted lists of pow2(k_top) keys per user: at most
# this many keys (a user's merge CTA walks them list by list).
_MERGE_ENTRIES = 32768
# A user's [splits, K] partial (8-byte keys) stays within half the bytes of
# its row of a [B, M_pad] f32 score matrix, which K4 never writes.
_PARTIAL_SHARE = 2
_TABLE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
# The fleet's replica threads launch K4 at once: its counts take a lock.
_COUNT_LOCK = threading.Lock()
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_void_p,
)
# cfk_topk_scores_large_k: the same, with the keys and candidates
# workspaces in place of the partial
_LARGE_K_ARGTYPES = _ARGTYPES[:15] + (ctypes.c_void_p,) + _ARGTYPES[15:]


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


@functools.lru_cache(maxsize=None)
def _num_sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def users_per_cta(b: int, k_top: int) -> int:
    """Users of one pass-1 CTA: 16 for small batches (so a B = 16 batch does
    not pay for a wider tile) and for K above 512 (their per-user lists
    would not fit 32 users' shared memory), else 32."""
    return 16 if b <= 32 or _pow2_ceil(k_top) > 512 else 32


def split_plan(b: int, m_pad: int, k_top: int, num_sms: int
               ) -> tuple[int, int]:
    """(users per CTA, splits) of the CUDA kernel's pass 1.

    The grid is (user blocks) × splits of the table's 256-row tiles, aimed
    at one wave of ``_CTAS_PER_SM`` CTAs per SM; never more splits than
    tiles (none is empty), at most ``_MERGE_ENTRIES`` keys for pass 2 to
    merge per user, and a partial of at most half a score row's bytes
    (``_PARTIAL_SHARE``).  Split s takes tiles [s·T // splits,
    (s + 1)·T // splits) of the T tiles, the last one cut at ``m_pad``."""
    bu = users_per_cta(b, k_top)
    tiles = -(-m_pad // _TILE_ROWS)
    blocks = -(-b // bu)
    cap = min(_MERGE_ENTRIES // _pow2_ceil(k_top),
              m_pad * 4 // (_PARTIAL_SHARE * 8 * k_top))
    want = _CTAS_PER_SM * num_sms // blocks
    return bu, max(min(want, tiles, cap), 1)


def large_k_plan(b: int, m_pad: int, num_sms: int) -> tuple[int, int]:
    """(users per CTA, splits) of the large-K route's score pass: pass 1's
    grid without per-user lists (so 32 users a CTA above B = 32 whatever
    K), aimed at one wave of ``_CTAS_PER_SM`` CTAs per SM, never more
    splits than tiles."""
    bu = 16 if b <= 32 else 32
    tiles = -(-m_pad // _TILE_ROWS)
    return bu, max(min(_CTAS_PER_SM * num_sms // -(-b // bu), tiles), 1)


def _kernel_args(u, table, scale, seen_tiles, tile_m):
    """Checks what the CUDA kernels take; (u as f32, seen width)."""
    b, k = u.shape
    m_pad = table.shape[0]
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
    return u.to(torch.float32).contiguous(), w


def topk_scores_large_k(u, table, scale, seen_tiles, *, k_top, num_movies,
                        tile_m, row_offset=0):
    """``topk_scores`` for K > ``MAX_K_TOP`` (its arguments and result).

    CPU tensors take ``topk_scores_plain``; CUDA tensors launch three
    kernels (``csrc/topk_scores.cu``, ``cfk_topk_scores_large_k``): pass 1's
    products writing every (user, row) key — score descending, id
    ascending, 0 for a row it would not take — to a [B, M_pad] int64
    workspace (B·M_pad·8 bytes: 122 MB at B = 256 and the ML-25M catalog),
    a per-user radix select of the K-th key compacting the keys at or
    above it into [B, pow2(K)], and a per-user bitonic sort decoding the
    first K, empty slots as (−inf, −1)."""
    _check_args(u, table, scale, seen_tiles, k_top=k_top, tile_m=tile_m)
    if not on_cuda(u, table, scale, seen_tiles):
        return topk_scores_plain(u, table, scale, seen_tiles, k_top=k_top,
                                 num_movies=num_movies, tile_m=tile_m,
                                 row_offset=row_offset)
    if k_top <= MAX_K_TOP:
        raise ValueError(f"topk_scores_large_k takes k_top > {MAX_K_TOP}, "
                         f"got {k_top} (topk_scores runs it)")
    b, k = u.shape
    m_pad = table.shape[0]
    u32, w = _kernel_args(u, table, scale, seen_tiles, tile_m)
    dev = u.device
    vals = torch.empty((b, k_top), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k_top), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, ids
    bu, splits = large_k_plan(b, m_pad, _num_sms(dev.index or 0))
    keys = torch.empty((b, m_pad), dtype=torch.int64, device=dev)
    cand = torch.empty((b, _pow2_ceil(k_top)), dtype=torch.int64, device=dev)
    fn = _build.function("topk_scores", "cfk_topk_scores_large_k",
                         _LARGE_K_ARGTYPES)
    rc = fn(_build.ptr(u32), _build.ptr(table), _TABLE_KIND[table.dtype],
            _build.ptr(scale), _build.ptr(seen_tiles), w, b, k, m_pad,
            int(num_movies), int(row_offset), int(tile_m), int(k_top), bu,
            splits, _build.ptr(keys), _build.ptr(cand), _build.ptr(vals),
            _build.ptr(ids), dev.index or 0, stream_of(u32))
    _build.check(rc, "topk_scores")
    _count(topk_scores_large_k, 3)
    return vals, ids


def _count(wrapper, n: int) -> None:
    """Add ``n`` launches to ``wrapper.launches`` and to the calling
    thread's entry of ``wrapper.launches_by_thread``."""
    name = threading.current_thread().name
    with _COUNT_LOCK:
        wrapper.launches += n
        by = wrapper.launches_by_thread
        by[name] = by.get(name, 0) + n


def reset_launches() -> None:
    """Zero both K4 wrappers' counts, the per-thread ones included."""
    with _COUNT_LOCK:
        for wrapper in (topk_scores, topk_scores_large_k):
            wrapper.launches = 0
            wrapper.launches_by_thread = {}


topk_scores_large_k.launches = 0
topk_scores_large_k.launches_by_thread = {}


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
    (two launches: per-split top K, then the per-user merge) or raise; a K
    above ``MAX_K_TOP`` takes ``topk_scores_large_k`` (three launches).
    """
    _check_args(u, table, scale, seen_tiles, k_top=k_top, tile_m=tile_m)
    if not on_cuda(u, table, scale, seen_tiles):
        return topk_scores_plain(u, table, scale, seen_tiles, k_top=k_top,
                                 num_movies=num_movies, tile_m=tile_m,
                                 row_offset=row_offset)
    if k_top > MAX_K_TOP:
        return topk_scores_large_k(u, table, scale, seen_tiles, k_top=k_top,
                                   num_movies=num_movies, tile_m=tile_m,
                                   row_offset=row_offset)
    b, k = u.shape
    m_pad = table.shape[0]
    u32, w = _kernel_args(u, table, scale, seen_tiles, tile_m)
    dev = u.device
    vals = torch.empty((b, k_top), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k_top), dtype=torch.int32, device=dev)
    if b == 0:
        return vals, ids
    bu, splits = split_plan(b, m_pad, k_top, _num_sms(dev.index or 0))
    # pass 1's per-split top K: (score, id) as one 64-bit key a slot
    part = torch.empty((b, splits, k_top), dtype=torch.int64, device=dev)
    fn = _build.function("topk_scores", "cfk_topk_scores", _ARGTYPES)
    rc = fn(_build.ptr(u32), _build.ptr(table), _TABLE_KIND[table.dtype],
            _build.ptr(scale), _build.ptr(seen_tiles), w, b, k, m_pad,
            int(num_movies), int(row_offset), int(tile_m), int(k_top), bu,
            splits, _build.ptr(part), _build.ptr(vals), _build.ptr(ids),
            dev.index or 0, stream_of(u32))
    _build.check(rc, "topk_scores")
    _count(topk_scores, 2)
    return vals, ids


topk_scores.launches = 0
topk_scores.launches_by_thread = {}
