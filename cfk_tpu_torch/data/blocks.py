"""Rating blocks: the per-side InBlocks the ALS half-steps consume.

The port's own copy of the host-side block builders of
``cfk_tpu/data/blocks.py`` (numpy only; the port imports nothing of
``cfk_tpu``), for one shard or for ``num_shards`` of them:

- ``RatingsCOO`` / ``IdMap`` / ``index_entities`` / ``group_by_dense`` —
  raw external ids ↔ dense ascending indices, and the grouping step every
  builder shares;
- ``PaddedBlocks`` — one [E, max_nnz] rectangle per side (small data);
- ``BucketedBlocks`` — power-of-two width classes, one rectangle each (the
  subspace optimizers' at-scale layout);
- ``SegmentBlocks`` — flat sorted runs packed into nnz chunks, entities
  straddling chunk boundaries (exactly O(nnz) memory for any skew);
- ``TiledBlocks`` — the tiled layout at scale: the few-entity side in
  ``accum`` mode (entries sorted by fixed-table slice, per-chunk tile owners,
  one accumulator over all chunks) and the many-entity side in ``stream``
  mode (entity runs padded to whole [T]-row tiles, chunk-relative segments
  and the carry of an entity that straddles two chunks) or, with
  ``dense_stream``, as the unpadded ``dstream`` dense stream (tiles are
  [T]-row windows into a stream whose runs are padded to 16 rows only).

- ``RingBlocks`` — the padded layout's per-fixed-shard rectangles of the
  ring exchange (``build_ring_blocks``); the tiled layout's ring halves are
  accum blocks whose slices are the fixed side's shards (``ring=True``).

Sharded blocks are shard-major: every flat array is the concatenation of
the shards' equal-length parts, each with shard-local entity rows
(``parallel.spmd.shard_view`` takes one rank's part).  Every array is
bit-identical to what ``cfk_tpu.data.blocks`` builds for the same ratings
and ``num_shards`` (asserted by ``tests/test_torch_blocks.py``,
``tests/test_torch_bucketed.py`` and ``tests/test_torch_mesh.py``).

Entity-count padding rows have count 0; their normal equations are made
non-singular by flooring the ALS-WR regularizer ``λ·n`` at ``λ·1`` (real rows
always have n ≥ 1, so their math is the reference's,
``processors/MFeatureCalculator.java:91-95``).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq

import numpy as np


@dataclasses.dataclass(frozen=True)
class RatingsCOO:
    """All ratings as parallel COO arrays (raw external ids)."""

    movie_raw: np.ndarray  # int64 [nnz]
    user_raw: np.ndarray  # int64 [nnz]
    rating: np.ndarray  # float32 [nnz]

    @property
    def num_ratings(self) -> int:
        return int(self.rating.shape[0])


@dataclasses.dataclass(frozen=True)
class IdMap:
    """Sorted unique raw ids; dense index i ↔ ``raw_ids[i]`` (ascending).

    Only rated entities are included, matching the reference's counting:
    prediction rows/cols are ascending-id over rated users/movies.
    """

    raw_ids: np.ndarray  # int64 [num_entities], sorted ascending

    @property
    def num_entities(self) -> int:
        return int(self.raw_ids.shape[0])

    def to_dense(self, raw: np.ndarray) -> np.ndarray:
        """Map raw ids → dense indices. Raises if any raw id is unknown."""
        idx = np.searchsorted(self.raw_ids, raw)
        clipped = np.minimum(idx, self.num_entities - 1)
        bad = (idx >= self.num_entities) | (self.raw_ids[clipped] != raw)
        if np.any(bad):
            raise KeyError(f"unknown raw ids, e.g. {raw[bad][:5]}")
        return idx.astype(np.int32)


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def group_by_dense(keys: np.ndarray, num_keys: int):
    """(stable argsort order, per-key counts int32, exclusive-prefix starts).

    The grouping step every block builder shares.  Dense keys admit an
    O(n + k) counting sort, run by the host library (``data._native``,
    ``csrc/host/cfk_native.cpp``) as in ``cfk_tpu/data/blocks.py:84-100``;
    ``group_by_dense_numpy`` (the O(n log n) comparison argsort) is the
    plain version, taken where no library could be built.  Both return the
    same arrays, bit for bit."""
    if 0 < num_keys < (1 << 31):
        from cfk_tpu_torch.data import _native

        if _native.available():
            return _native.group_by(keys, num_keys)
    return group_by_dense_numpy(keys, num_keys)


def group_by_dense_numpy(keys: np.ndarray, num_keys: int):
    """The plain version of ``group_by_dense``: numpy's stable argsort."""
    order = np.argsort(keys, kind="stable")
    count = np.bincount(keys, minlength=num_keys).astype(np.int32)
    start = np.zeros(num_keys, dtype=np.int64)
    np.cumsum(count[:-1], out=start[1:])
    return order, count, start


_PRESENCE_TABLE_MAX_RAW = 1 << 31


def index_entities(raw: np.ndarray) -> tuple[IdMap, np.ndarray]:
    """(IdMap of the distinct raw ids, dense index per element).

    Small non-negative ids (every rating dataset here) take the host
    library's O(n + max_raw) presence table (``cfk_tpu/data/blocks.py:
    113-133``), gated on the id range both absolutely and relative to nnz;
    ``index_entities_numpy`` is the plain version.  Both give the same
    ascending map."""
    if raw.size:
        from cfk_tpu_torch.data import _native

        if _native.available():
            max_raw = int(raw.max())
            if 0 <= max_raw <= min(_native.INDEX_DENSE_MAX_RAW,
                                   64 * raw.size + (1 << 16)):
                try:
                    unique, dense = _native.index_dense(raw, max_raw)
                except ValueError:
                    pass  # negative ids: the sort path below
                else:
                    return IdMap(raw_ids=unique), dense
    return index_entities_numpy(raw)


def index_entities_numpy(raw: np.ndarray) -> tuple[IdMap, np.ndarray]:
    """The plain version of ``index_entities``: a numpy presence table for
    small non-negative ids, else the sort path (``np.unique`` +
    ``searchsorted``)."""
    if raw.size:
        lo, hi = int(raw.min()), int(raw.max())
        if lo >= 0 and hi < min(_PRESENCE_TABLE_MAX_RAW,
                                64 * raw.size + (1 << 16)):
            present = np.zeros(hi + 1, dtype=bool)
            present[raw] = True
            unique = np.flatnonzero(present).astype(np.int64)
            rank = np.cumsum(present, dtype=np.int64) - 1
            return IdMap(raw_ids=unique), rank[raw].astype(np.int32)
    id_map = IdMap(raw_ids=np.unique(raw))
    return id_map, id_map.to_dense(raw)


@dataclasses.dataclass(frozen=True)
class PaddedBlocks:
    """Rectangular InBlocks for one solve side (row e = entity e)."""

    neighbor_idx: np.ndarray  # int32 [E_pad, P] dense idx into the fixed side (0 where masked)
    rating: np.ndarray  # float32 [E_pad, P] (0 where masked)
    mask: np.ndarray  # float32 [E_pad, P] 1.0 = real rating
    count: np.ndarray  # int32 [E_pad] real nnz per entity (0 for pad rows)
    num_entities: int  # real (un-padded) entity count

    @property
    def padded_entities(self) -> int:
        return int(self.neighbor_idx.shape[0])

    @property
    def max_nnz(self) -> int:
        return int(self.neighbor_idx.shape[1])


def build_padded_blocks(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    *,
    num_shards: int = 1,
    pad_multiple: int = 8,
) -> PaddedBlocks:
    """Group ratings by the solve-side entity into a padded rectangle.

    ``solve_dense``/``fixed_dense`` are dense indices (from ``IdMap.to_dense``)
    of the side being solved / held fixed.  Fully vectorized (no Python loop
    over entities); the reference does the equivalent incrementally per record
    in ``MRatings2BlocksProcessor``/``URatings2BlocksProcessor``.
    """
    nnz = solve_dense.shape[0]
    order, count, group_start = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order]
    f_sorted = fixed_dense[order].astype(np.int32)
    r_sorted = rating[order].astype(np.float32)

    max_nnz = _round_up(max(int(count.max()), 1), pad_multiple)
    e_pad = _round_up(num_solve_entities, num_shards)

    pos = np.arange(nnz, dtype=np.int64) - group_start[s_sorted]

    neighbor = np.zeros((e_pad, max_nnz), dtype=np.int32)
    rmat = np.zeros((e_pad, max_nnz), dtype=np.float32)
    mask = np.zeros((e_pad, max_nnz), dtype=np.float32)
    neighbor[s_sorted, pos] = f_sorted
    rmat[s_sorted, pos] = r_sorted
    mask[s_sorted, pos] = 1.0

    count_pad = np.zeros(e_pad, dtype=np.int32)
    count_pad[:num_solve_entities] = count
    return PaddedBlocks(
        neighbor_idx=neighbor,
        rating=rmat,
        mask=mask,
        count=count_pad,
        num_entities=num_solve_entities,
    )


@dataclasses.dataclass(frozen=True)
class TiledBlocks:
    """Tile-structured InBlocks, one mode per side.

    - ``mode="accum"`` (few solve entities, big fixed table): every entity's
      run is padded to a multiple of ``tile_rows``; entries are sorted by
      (fixed-table slice of ``slice_rows`` rows, entity); chunks never span a
      slice and ``chunk_base`` gives each chunk's slice offset.  The
      half-step sums every chunk's per-entity Grams into one [E+1, k, k]
      accumulator and solves once at the end.
    - ``mode="dstream"`` (many solve entities): runs padded to 16 rows only,
      packed back to back; tiles are [T]-row windows into that stream
      (``tile_meta``), chunks are solved one after another, and an entity
      straddling a chunk boundary carries its partial (A, b) across.
    """

    neighbor_idx: np.ndarray  # int32 [NC·C]; accum: SLICE-local rows (h = zero row)
    rating: np.ndarray  # float32 accum [NC·C]; dstream TILE-aligned [NC·NT·T]
    weight: np.ndarray  # float32 accum [NC·C] 0/1; dstream tile-aligned 0/1
    tile_seg: np.ndarray  # int32 accum [NC·NT] chunk-dense entity rank (trash = Ec)
    chunk_base: np.ndarray  # int32 accum [NC] table slice offset
    chunk_entity: np.ndarray  # int32 [NC·Ec] accum: rank→entity; dstream: finalized rows
    chunk_count: np.ndarray  # int32 [NC·Ec] dstream: rating count of finalized rows
    carry_in: np.ndarray  # float32 [NC] dstream: 1.0 = seg 0 continues the previous chunk
    last_seg: np.ndarray  # int32 [NC] dstream: chunk-relative index of the last segment
    slice_starts: np.ndarray  # int32 [n_slices+1] accum: chunk range per slice
    count: np.ndarray  # int32 [E]
    rating_sum: np.ndarray  # float32 [E]
    mode: str  # "accum" | "stream" | "dstream"
    num_entities: int
    num_chunks: int  # NC
    chunk_cap: int  # C (entries per chunk)
    chunk_entities: int  # Ec
    tile_rows: int  # T
    slice_rows: int  # H (gather-slice height; = fixed rows if unsliced)
    num_slices: int = 1  # accum: fixed-table slices (ring: = num_shards)
    num_shards: int = 1
    ring: bool = False  # built for the ring exchange (accum, slice = shard)
    tile_meta: np.ndarray | None = None  # dstream int32 [NC·(NG+4·NT)]
    rating_dense: np.ndarray | None = None  # dstream f32 [NC·C] stream-aligned
    num_tiles: int = 0  # dstream NT (tile slots per chunk)
    num_groups: int = 0  # dstream NG
    block_rows: int = 0  # dstream BG (stream rows per block)

    @property
    def padded_entities(self) -> int:
        return int(self.count.shape[0])

    @property
    def local_entities(self) -> int:
        return self.padded_entities // self.num_shards

    @property
    def statics(self):
        """Static shape tuple: stream (NC, C, Ec, T), dstream (NC, C, Ec, T,
        NT, NG, BG), accum (NC, C, T, H, Ec) — the same order as
        ``cfk_tpu``."""
        if self.mode == "stream":
            return (self.num_chunks, self.chunk_cap, self.chunk_entities,
                    self.tile_rows)
        if self.mode == "dstream":
            return (self.num_chunks, self.chunk_cap, self.chunk_entities,
                    self.tile_rows, self.num_tiles, self.num_groups,
                    self.block_rows)
        return (self.num_chunks, self.chunk_cap, self.tile_rows,
                self.slice_rows, self.chunk_entities)


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One width class of a ``BucketedBlocks``: entities whose nnz fits
    ``width``.  Rows are shard-major (shard s owns rows [s·B, (s+1)·B));
    ``entity_local`` maps each row to its entity within the shard's slice,
    padding rows to the trash slot ``local_entities``."""

    neighbor_idx: np.ndarray  # int32 [rows, width] dense idx into the fixed side
    rating: np.ndarray  # float32 [rows, width]
    mask: np.ndarray  # float32 [rows, width]
    count: np.ndarray  # int32 [rows]
    entity_local: np.ndarray  # int32 [rows]
    chunk_rows: int | None  # per-shard chunking hint (divides rows/S)

    @property
    def width(self) -> int:
        return int(self.neighbor_idx.shape[1])


@dataclasses.dataclass(frozen=True)
class BucketedBlocks:
    """InBlocks grouped into power-of-two width classes ``pad_multiple·2^j``:
    each class is its own small rectangle, so padded cells stay within 2× of
    nnz under power-law degrees.  Entities with zero ratings get no row (their
    solve is identically zero)."""

    buckets: tuple[Bucket, ...]
    count: np.ndarray  # int32 [E_pad] dense per-entity nnz (0 for pad rows)
    rating_sum: np.ndarray  # float32 [E_pad] per-entity rating sum (for init)
    num_entities: int
    num_shards: int

    @property
    def padded_entities(self) -> int:
        return int(self.count.shape[0])

    @property
    def local_entities(self) -> int:
        return self.padded_entities // self.num_shards

    @property
    def padded_cells(self) -> int:
        return sum(b.neighbor_idx.size for b in self.buckets)

    def to_tree(self):
        """(tuple of per-bucket array dicts, per-bucket ``chunk_rows``) —
        the one field list the device setup stages."""
        trees = tuple(
            {
                "neighbor": b.neighbor_idx,
                "rating": b.rating,
                "mask": b.mask,
                "count": b.count,
                "entity_local": b.entity_local,
            }
            for b in self.buckets
        )
        return trees, tuple(b.chunk_rows for b in self.buckets)


def build_bucketed_blocks(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    *,
    num_shards: int = 1,
    pad_multiple: int = 8,
    chunk_elems: int | None = 1 << 20,
) -> BucketedBlocks:
    """Bin entities into power-of-two width buckets, shard-major rows.

    ``chunk_elems`` bounds rows·width per solve chunk: a bucket whose
    per-shard row count exceeds ``chunk_elems // width`` gets that as its
    ``chunk_rows`` hint, with rows padded to a multiple of it.
    """
    e_pad = _round_up(num_solve_entities, num_shards)
    e_local = e_pad // num_shards
    order, count, group_start = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order]
    f_sorted = fixed_dense[order].astype(np.int32)
    r_sorted = rating[order].astype(np.float32)
    pos = np.arange(s_sorted.shape[0], dtype=np.int64) - group_start[s_sorted]

    max_nnz = max(int(count.max()), 1)
    widths = [pad_multiple]
    while widths[-1] < max_nnz:
        widths.append(widths[-1] * 2)

    bucket_of = np.searchsorted(widths, count)  # smallest j, width_j >= nnz
    shard_of = np.arange(num_solve_entities, dtype=np.int64) // e_local
    rated = count > 0

    # Per-bucket geometry first, then one flat-arena scatter for all ratings.
    metas = []  # (width, rows, chunk, ents, rows_idx, arena offset)
    arena_cells = 0
    entity_base = np.full(num_solve_entities, -1, dtype=np.int64)
    for j, width in enumerate(widths):
        ents = np.flatnonzero(rated & (bucket_of == j))
        if ents.size == 0:
            continue
        sh = shard_of[ents]
        per_shard = np.bincount(sh, minlength=num_shards)
        b = int(per_shard.max())
        chunk = None
        if chunk_elems is not None:
            cap = max(1, chunk_elems // width)
            if b > cap:
                chunk = cap
                b = _round_up(b, cap)
        rows = num_shards * b
        idx_in_shard = np.arange(ents.size) - np.searchsorted(sh, sh)
        rows_idx = sh * b + idx_in_shard
        entity_base[ents] = arena_cells + rows_idx * width
        metas.append((width, rows, chunk, ents, rows_idx, arena_cells))
        arena_cells += rows * width

    neighbor_arena = np.zeros(arena_cells, dtype=np.int32)
    rating_arena = np.zeros(arena_cells, dtype=np.float32)
    mask_arena = np.zeros(arena_cells, dtype=np.float32)
    target = entity_base[s_sorted] + pos
    neighbor_arena[target] = f_sorted
    rating_arena[target] = r_sorted
    mask_arena[target] = 1.0

    buckets = []
    for width, rows, chunk, ents, rows_idx, off in metas:
        count_rows = np.zeros(rows, dtype=np.int32)
        entity_local = np.full(rows, e_local, dtype=np.int32)
        count_rows[rows_idx] = count[ents]
        entity_local[rows_idx] = (ents % e_local).astype(np.int32)
        cells = slice(off, off + rows * width)
        buckets.append(Bucket(
            neighbor_idx=neighbor_arena[cells].reshape(rows, width),
            rating=rating_arena[cells].reshape(rows, width),
            mask=mask_arena[cells].reshape(rows, width),
            count=count_rows,
            entity_local=entity_local,
            chunk_rows=chunk,
        ))

    count_pad = np.zeros(e_pad, dtype=np.int32)
    count_pad[:num_solve_entities] = count
    rating_sum = np.zeros(e_pad, dtype=np.float32)
    rating_sum[:num_solve_entities] = _rating_sum(solve_dense, rating,
                                                  num_solve_entities)
    return BucketedBlocks(
        buckets=tuple(buckets),
        count=count_pad,
        rating_sum=rating_sum,
        num_entities=num_solve_entities,
        num_shards=num_shards,
    )


@dataclasses.dataclass(frozen=True)
class SegmentBlocks:
    """Flat CSR-style InBlocks packed into fixed-size chunks (the segment
    layout, ``cfk_tpu/data/blocks.py:381``).

    Ratings stay one sorted run per side, cut into ``num_chunks`` chunks of
    at most ``chunk_cap`` ratings covering at most ``chunk_entities``
    consecutive entities (dense ids are compact, so an entity range is a
    contiguous rating slice) — O(nnz) memory for any degree distribution.
    **Entities may straddle chunk boundaries**: an entity with more ratings
    than a chunk holds spans several, and the half-step carries its partial
    Gram/RHS across them (``carry_in`` flags the continuation, ``last_seg``
    indexes the straddling segment).  ``seg_rel`` holds each rating's entity
    row relative to its chunk's first entity (padding entries: the trash row
    ``chunk_entities``); ``chunk_entity``/``chunk_count`` give each chunk
    row's shard-local entity and rating count, with the trash entity
    ``local_entities`` (count 0) for rows not finalized in that chunk (an
    entity continuing into the next chunk, and padding).  ``group_sizes``
    counts the entries of every segment (trash last).  Entries are
    shard-major (each shard its own ``num_chunks`` chunks).  The fields are
    the JAX package's, so its dataset caches load here.
    """

    neighbor_idx: np.ndarray  # int32 [S·NC·C] dense idx into the fixed side (0 at padding)
    rating: np.ndarray  # float32 [S·NC·C] (0 at padding)
    mask: np.ndarray  # float32 [S·NC·C] 1.0 = real rating
    seg_rel: np.ndarray  # int32 [S·NC·C] chunk-relative entity row, sorted per chunk
    chunk_entity: np.ndarray  # int32 [S·NC·Ec] shard-local row (local_entities = trash)
    chunk_count: np.ndarray  # int32 [S·NC·Ec] full rating count of finalized rows (0 else)
    group_sizes: np.ndarray  # int32 [NC·(Ec+1)] entries per segment (trash last)
    carry_in: np.ndarray  # float32 [NC] 1.0 = chunk's seg 0 continues the previous chunk
    last_seg: np.ndarray  # int32 [NC] chunk-relative index of the last real segment
    chunk_first: np.ndarray  # int32 [NC] entity of each chunk's seg 0
    count: np.ndarray  # int32 [E] real nnz per entity
    rating_sum: np.ndarray  # float32 [E] per-entity rating sum (for init)
    num_entities: int
    num_shards: int
    num_chunks: int  # NC
    chunk_cap: int  # C: ratings per chunk (padded)
    chunk_entities: int  # Ec: entity rows per chunk (padded)

    @property
    def padded_entities(self) -> int:
        return int(self.count.shape[0])

    @property
    def local_entities(self) -> int:
        return self.padded_entities // self.num_shards

    @property
    def statics(self) -> tuple[int, int, int]:
        """(num_chunks, chunk_cap, chunk_entities)."""
        return (self.num_chunks, self.chunk_cap, self.chunk_entities)


def build_segment_blocks(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    *,
    num_shards: int = 1,
    pad_multiple: int = 8,
    chunk_nnz: int | None = None,
    chunk_entity_cap: int | None = None,
) -> SegmentBlocks:
    """Sort ratings by (shard, local entity row) and pack into nnz chunks.

    ``chunk_nnz`` is the ratings-per-chunk capacity, bounding the per-chunk
    gather; a chunk also covers at most ``chunk_entity_cap`` consecutive
    entities (default ``min(chunk_nnz // 32, 16384)``), bounding the
    [Ec, k, k] Gram accumulator even on all-degree-1 runs.  Entities whose
    degree exceeds the capacity **straddle chunks** — the solve scan carries
    their partial Gram across the boundary — so the capacity never inflates
    with the degree distribution's head.  ``None`` packs each shard into a
    single chunk (fine until the per-shard entity count × k² outgrows HBM).
    """
    e_pad = _round_up(num_solve_entities, num_shards)
    e_local = e_pad // num_shards
    order, count, _ = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order].astype(np.int64)
    f_sorted = fixed_dense[order].astype(np.int32)
    r_sorted = rating[order].astype(np.float32)
    local_sorted = (s_sorted % e_local).astype(np.int32)

    count_pad = np.zeros(e_pad, dtype=np.int32)
    count_pad[:num_solve_entities] = count
    counts_local = count_pad.reshape(num_shards, e_local)
    per_shard_nnz = counts_local.sum(axis=1, dtype=np.int64)
    shard_start = np.zeros(num_shards, dtype=np.int64)
    np.cumsum(per_shard_nnz[:-1], out=shard_start[1:])

    if chunk_nnz is None:
        cap = max(int(per_shard_nnz.max()), 1, pad_multiple)
        e_cap = max(e_local, 1)
    else:
        cap = max(min(int(chunk_nnz), int(per_shard_nnz.max())), pad_multiple)
        if chunk_entity_cap is not None:
            e_cap = max(int(chunk_entity_cap), 1)
        else:
            e_cap = max(1, min(cap // 32, 1 << 14))
    cap = _round_up(cap, pad_multiple)

    shard_cuts: list[list[tuple[int, int]]] = []
    for s in range(num_shards):
        lo = int(shard_start[s])
        hi = lo + int(per_shard_nnz[s])
        cum = np.zeros(e_local + 1, dtype=np.int64)
        np.cumsum(counts_local[s], out=cum[1:])
        cuts = []
        pos = lo
        while pos < hi:
            end = min(pos + cap, hi)
            first = int(local_sorted[pos])
            if int(local_sorted[end - 1]) - first + 1 > e_cap:
                end = lo + int(cum[first + e_cap])
            cuts.append((pos, end))
            pos = end
        shard_cuts.append(cuts)

    num_chunks = max(max((len(c) for c in shard_cuts), default=1), 1)
    e_c = 1
    for cuts in shard_cuts:
        for p0, p1 in cuts:
            e_c = max(e_c, int(local_sorted[p1 - 1]) - int(local_sorted[p0]) + 1)

    neighbor = np.zeros(num_shards * num_chunks * cap, dtype=np.int32)
    rmat = np.zeros(num_shards * num_chunks * cap, dtype=np.float32)
    mask = np.zeros(num_shards * num_chunks * cap, dtype=np.float32)
    seg = np.full(num_shards * num_chunks * cap, e_c, dtype=np.int32)  # trash
    chunk_entity = np.full(num_shards * num_chunks * e_c, e_local, dtype=np.int32)
    chunk_count = np.zeros(num_shards * num_chunks * e_c, dtype=np.int32)
    group_sizes = np.zeros(num_shards * num_chunks * (e_c + 1), dtype=np.int32)
    group_sizes.reshape(-1, e_c + 1)[:, e_c] = cap
    carry_in = np.zeros(num_shards * num_chunks, dtype=np.float32)
    last_seg = np.zeros(num_shards * num_chunks, dtype=np.int32)
    chunk_first = np.zeros(num_shards * num_chunks, dtype=np.int32)

    for s in range(num_shards):
        lo = int(shard_start[s])
        hi = lo + int(per_shard_nnz[s])
        for c, (p0, p1) in enumerate(shard_cuts[s]):
            n = p1 - p0
            ci = s * num_chunks + c
            dst = ci * cap
            first = int(local_sorted[p0])
            last = int(local_sorted[p1 - 1])
            neighbor[dst : dst + n] = f_sorted[p0:p1]
            rmat[dst : dst + n] = r_sorted[p0:p1]
            mask[dst : dst + n] = 1.0
            seg_chunk = (local_sorted[p0:p1] - first).astype(np.int64)
            seg[dst : dst + n] = seg_chunk
            sizes = np.bincount(seg_chunk, minlength=e_c + 1).astype(np.int32)
            sizes[e_c] = cap - n  # tail padding sits in the trash segment
            group_sizes[ci * (e_c + 1) : (ci + 1) * (e_c + 1)] = sizes
            carry_in[ci] = float(p0 > lo and int(local_sorted[p0 - 1]) == first)
            last_seg[ci] = last - first
            chunk_first[ci] = first
            cont_out = p1 < hi and int(local_sorted[p1]) == last
            n_final = (last - first + 1) - int(cont_out)
            if n_final > 0:
                ebase = ci * e_c
                chunk_entity[ebase : ebase + n_final] = np.arange(
                    first, first + n_final, dtype=np.int32
                )
                chunk_count[ebase : ebase + n_final] = counts_local[
                    s, first : first + n_final
                ]

    rating_sum = np.zeros(e_pad, dtype=np.float32)
    rating_sum[:num_solve_entities] = np.bincount(
        solve_dense, weights=rating.astype(np.float64), minlength=num_solve_entities
    ).astype(np.float32)
    return SegmentBlocks(
        neighbor_idx=neighbor,
        rating=rmat,
        mask=mask,
        seg_rel=seg,
        chunk_entity=chunk_entity,
        chunk_count=chunk_count,
        group_sizes=group_sizes,
        carry_in=carry_in,
        last_seg=last_seg,
        chunk_first=chunk_first,
        count=count_pad,
        rating_sum=rating_sum,
        num_entities=num_solve_entities,
        num_shards=num_shards,
        num_chunks=num_chunks,
        chunk_cap=cap,
        chunk_entities=e_c,
    )


@dataclasses.dataclass(frozen=True)
class RingBlocks:
    """Per-fixed-shard InBlocks for the ring (block-to-block join) exchange.

    ``neighbor_local[e, t, p]`` is the index *within fixed shard t's row block*
    of entity e's p-th neighbor owned by shard t (contiguous sharding: fixed
    shard t owns dense rows [t·Fs, (t+1)·Fs)).  At ring step r a device holds
    one fixed-side row block and accumulates that block's partial Gram
    contribution — the TPU analog of the reference's block-to-block join
    (README.md:152-157): each factor block moves once per shard pair instead
    of every vector moving per dependent row.
    """

    neighbor_local: np.ndarray  # int32 [E_pad, S, P_ring]
    rating: np.ndarray  # float32 [E_pad, S, P_ring]
    mask: np.ndarray  # float32 [E_pad, S, P_ring]
    count: np.ndarray  # int32 [E_pad] total real nnz per entity
    num_entities: int
    fixed_shard_size: int  # Fs = padded fixed-entity count / num_shards

    @property
    def num_shards(self) -> int:
        return int(self.neighbor_local.shape[1])


def build_ring_blocks(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    num_fixed_entities: int,
    *,
    num_shards: int,
    pad_multiple: int = 8,
) -> RingBlocks:
    """Split each entity's neighbor list by the fixed shard owning the neighbor.

    Returns rectangles [E_pad, S, P_ring] where P_ring = max ratings any
    (entity, fixed-shard) pair holds, rounded up to ``pad_multiple``.
    """
    f_pad = _round_up(num_fixed_entities, num_shards)
    fs = f_pad // num_shards
    shard_of = (fixed_dense // fs).astype(np.int64)
    local = (fixed_dense % fs).astype(np.int32)

    e_pad = _round_up(num_solve_entities, num_shards)
    key = solve_dense.astype(np.int64) * num_shards + shard_of
    order, pair_count, group_start = group_by_dense(
        key, num_solve_entities * num_shards
    )
    key_s = key[order]
    p_ring = _round_up(max(int(pair_count.max()), 1), pad_multiple)
    pos = np.arange(key_s.shape[0], dtype=np.int64) - group_start[key_s]

    e_idx = key_s // num_shards
    t_idx = key_s % num_shards
    neighbor = np.zeros((e_pad, num_shards, p_ring), dtype=np.int32)
    rmat = np.zeros((e_pad, num_shards, p_ring), dtype=np.float32)
    mask = np.zeros((e_pad, num_shards, p_ring), dtype=np.float32)
    neighbor[e_idx, t_idx, pos] = local[order]
    rmat[e_idx, t_idx, pos] = rating[order].astype(np.float32)
    mask[e_idx, t_idx, pos] = 1.0

    count = np.zeros(e_pad, dtype=np.int32)
    count[:num_solve_entities] = np.bincount(
        solve_dense, minlength=num_solve_entities
    ).astype(np.int32)
    return RingBlocks(
        neighbor_local=neighbor,
        rating=rmat,
        mask=mask,
        count=count,
        num_entities=num_solve_entities,
        fixed_shard_size=fs,
    )


TILED_SLICE_ROWS_DEFAULT = 1 << 17


def _rating_sum(solve_dense, rating, num_solve_entities):
    return np.bincount(
        solve_dense, weights=rating.astype(np.float64),
        minlength=num_solve_entities,
    ).astype(np.float32)


def build_tiled_blocks(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    num_fixed_entities: int,
    *,
    num_shards: int = 1,
    tile_rows: int = 128,
    chunk_elems: int | None = 1 << 20,
    slice_rows: int = TILED_SLICE_ROWS_DEFAULT,
    accum_max_entities: int = 1 << 16,
    ring: bool = False,
    dense_stream: bool = False,
) -> TiledBlocks:
    """Pad entity runs to tiles and pack into chunks (one mode per side).

    Mode selection: ``accum`` when the per-shard solve-entity count fits
    ``accum_max_entities`` (the [E+1, k, k] accumulator must fit in HBM),
    else ``stream``.  Table slicing engages only in accum mode and only
    when the padded fixed side exceeds ``slice_rows``.  ``dense_stream``
    upgrades the stream side to the unpadded dense layout
    (``_build_dense_stream`` — the measured explicit-ALS default at
    scale; iALS runs it too via the weighted channels, but measured
    slower than the padded stream at the ML-25M rank-128 target, see
    BASELINE.md round-4 notes).
    """
    if dense_stream and not ring:
        e_l = _round_up(num_solve_entities, num_shards) // num_shards
        if e_l > accum_max_entities:  # the side that would go stream mode
            return _build_dense_stream(
                solve_dense, fixed_dense, rating,
                num_solve_entities, num_fixed_entities,
                num_shards=num_shards, tile_rows=tile_rows,
                chunk_elems=chunk_elems,
            )
    t = int(tile_rows)
    if t < 8:
        raise ValueError(f"tile_rows must be >= 8, got {t}")
    e_pad = _round_up(num_solve_entities, num_shards)
    e_local = e_pad // num_shards
    f_pad = _round_up(num_fixed_entities, num_shards)
    if ring and e_local > accum_max_entities:
        raise ValueError(
            f"ring=True with {e_local} solve entities per shard (> "
            f"accum_max_entities={accum_max_entities}): the ring's "
            "per-entity Gram accumulator would exceed the all_gather "
            "table it saves.  Use Dataset.from_coo(..., ring='auto') "
            "(ring only where it wins) or exchange='all_gather'."
        )
    if ring:
        mode = "accum"
        n_slices = num_shards
        h = f_pad // num_shards
    else:
        mode = "accum" if e_local <= accum_max_entities else "stream"
        n_slices = 1
        h = f_pad
        if mode == "accum" and f_pad > slice_rows:
            h = int(slice_rows)
            n_slices = (f_pad + h - 1) // h

    order, count, _ = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order].astype(np.int64)
    f_sorted = fixed_dense[order].astype(np.int64)
    r_sorted = rating[order].astype(np.float32)
    local_sorted = (s_sorted % e_local).astype(np.int64)
    shard_of = s_sorted // e_local

    count_pad = np.zeros(e_pad, dtype=np.int32)
    count_pad[:num_solve_entities] = count
    rating_sum = np.zeros(e_pad, dtype=np.float32)
    rating_sum[:num_solve_entities] = np.bincount(
        solve_dense, weights=rating.astype(np.float64),
        minlength=num_solve_entities,
    ).astype(np.float32)

    cap = max(t, ((chunk_elems or (1 << 20)) // t) * t)
    nt = cap // t

    shard_data = []
    max_chunks = 1
    for s in range(num_shards):
        sel = shard_of == s
        loc = local_sorted[sel]
        fix = f_sorted[sel]
        rat = r_sorted[sel]
        if mode == "accum" and n_slices > 1:
            sl = fix // h
            o = np.lexsort((loc, sl))
            loc, fix, rat, sl = loc[o], fix[o], rat[o], sl[o]
        else:
            sl = np.zeros(loc.shape[0], dtype=np.int64)
        if loc.shape[0]:
            key = sl * e_local + loc
            boundary = np.empty(loc.shape[0], dtype=bool)
            boundary[0] = True
            np.not_equal(key[1:], key[:-1], out=boundary[1:])
            run_start = np.flatnonzero(boundary)
            run_len = np.diff(np.append(run_start, loc.shape[0]))
            run_entity = loc[run_start]
            run_slice = sl[run_start]
        else:
            run_start = np.zeros(0, np.int64)
            run_len = np.zeros(0, np.int64)
            run_entity = np.zeros(0, np.int64)
            run_slice = np.zeros(0, np.int64)
        run_pad = ((run_len + t - 1) // t) * t
        slice_rounded = None
        if mode == "accum" and n_slices > 1:
            padded_per_slice = np.bincount(
                run_slice, weights=run_pad.astype(np.float64),
                minlength=n_slices,
            ).astype(np.int64)
            slice_rounded = ((padded_per_slice + cap - 1) // cap) * cap
            slice_base = np.zeros(n_slices, dtype=np.int64)
            np.cumsum(slice_rounded[:-1], out=slice_base[1:])
            cum = np.cumsum(run_pad) - run_pad
            first_idx = np.searchsorted(run_slice, np.arange(n_slices))
            valid = first_idx < run_slice.shape[0]
            base_correction = np.zeros(n_slices, dtype=np.int64)
            base_correction[valid] = cum[first_idx[valid]]
            run_dst = slice_base[run_slice] + (cum - base_correction[run_slice])
            total_padded = int(slice_rounded.sum())
        else:
            run_dst = np.cumsum(run_pad) - run_pad
            total_padded = int(run_pad.sum())
        nc_shard = max((total_padded + cap - 1) // cap, 1)
        max_chunks = max(max_chunks, nc_shard)
        shard_data.append(
            (loc, fix, rat, sl, run_start, run_len, run_entity, run_slice,
             run_pad, run_dst, total_padded, slice_rounded)
        )

    nc = max_chunks
    total = num_shards * nc * cap
    neighbor = np.full(total, h, dtype=np.int32)
    rmat = np.zeros(total, dtype=np.float32)
    wmat = np.zeros(total, dtype=np.float32)
    tile_seg = np.zeros(num_shards * nc * nt, dtype=np.int32)
    chunk_base = np.zeros(num_shards * nc, dtype=np.int32)
    carry_in = np.zeros(num_shards * nc, dtype=np.float32)
    last_seg = np.zeros(num_shards * nc, dtype=np.int32)

    e_c = 1
    tile_entity_by_shard = []
    for s in range(num_shards):
        (loc, fix, rat, sl, run_start, run_len, run_entity, run_slice,
         run_pad, run_dst, total_padded, slice_rounded) = shard_data[s]
        n_tiles_shard = nc * nt
        tile_entity = np.full(n_tiles_shard, e_local, dtype=np.int64)
        if run_len.shape[0]:
            tile_idx = run_dst // t
            reps = (run_pad // t).astype(np.int64)
            fill_pos = np.repeat(tile_idx, reps) + _concat_aranges(reps)
            tile_entity[fill_pos] = np.repeat(run_entity, reps)
        tile_entity_by_shard.append(tile_entity)
        te = tile_entity.reshape(nc, nt)
        for c in range(nc):
            real = te[c][te[c] < e_local]
            if real.size:
                if mode == "stream":  # solve-batch rows: entity SPAN
                    e_c = max(e_c, int(real[-1] - real[0]) + 1)
                else:  # accumulator scatter rows: DISTINCT entities
                    e_c = max(e_c, int(np.unique(real).shape[0]))
    e_c = min(e_c, e_local)

    chunk_entity = np.full(num_shards * nc * e_c, e_local, dtype=np.int32)
    chunk_count = np.zeros(num_shards * nc * e_c, dtype=np.int32)
    slice_starts = np.zeros(num_shards * (n_slices + 1), dtype=np.int32)

    for s in range(num_shards):
        (loc, fix, rat, sl, run_start, run_len, run_entity, run_slice,
         run_pad, run_dst, total_padded, slice_rounded) = shard_data[s]
        base = s * nc * cap
        if run_len.shape[0]:
            pos_in_run = np.arange(loc.shape[0], dtype=np.int64) - np.repeat(
                run_start, run_len
            )
            dst = base + np.repeat(run_dst, run_len) + pos_in_run
            if mode == "accum" and n_slices > 1:
                slice_first_row = np.minimum(sl * h, f_pad - h)
                neighbor[dst] = (fix - slice_first_row).astype(np.int32)
            else:
                neighbor[dst] = fix.astype(np.int32)
            rmat[dst] = rat
            wmat[dst] = 1.0

        tile_entity = tile_entity_by_shard[s]
        tbase = s * nc * nt
        if mode == "accum":
            te = tile_entity.reshape(nc, nt)
            for c in range(nc):
                ci = s * nc + c
                tiles_c = te[c]
                real = tiles_c < e_local
                if not real.any():
                    tile_seg[tbase + c * nt : tbase + (c + 1) * nt] = e_c
                    continue
                distinct = np.unique(tiles_c[real])
                seg = np.where(
                    real, np.searchsorted(distinct, tiles_c), e_c
                ).astype(np.int32)
                tile_seg[tbase + c * nt : tbase + (c + 1) * nt] = seg
                ebase = ci * e_c
                chunk_entity[ebase : ebase + distinct.shape[0]] = (
                    distinct.astype(np.int32)
                )
            sbase = s * (n_slices + 1)
            if n_slices > 1 and run_len.shape[0]:
                chunks_per_slice = slice_rounded // cap
                sl_of_chunk = np.repeat(np.arange(n_slices), chunks_per_slice)
                cb = np.zeros(nc, dtype=np.int32)
                cb[: sl_of_chunk.shape[0]] = np.minimum(
                    sl_of_chunk * h, f_pad - h
                ).astype(np.int32)
                chunk_base[s * nc : (s + 1) * nc] = cb
                np.cumsum(
                    chunks_per_slice,
                    out=slice_starts[sbase + 1 : sbase + n_slices + 1],
                )
            else:
                slice_starts[sbase + 1 : sbase + n_slices + 1] = (
                    (total_padded + cap - 1) // cap
                )
            continue

        te = tile_entity.reshape(nc, nt)
        counts_local = count_pad.reshape(num_shards, e_local)[s]
        for c in range(nc):
            tiles_c = te[c]
            real = tiles_c < e_local
            ci = s * nc + c
            if not real.any():
                tile_seg[tbase + c * nt : tbase + (c + 1) * nt] = e_c
                continue
            first = int(tiles_c[real][0])
            last = int(tiles_c[real][-1])
            seg = np.where(real, tiles_c - first, e_c).astype(np.int32)
            tile_seg[tbase + c * nt : tbase + (c + 1) * nt] = seg
            carry_in[ci] = float(
                c > 0 and te[c - 1][te[c - 1] < e_local].size > 0
                and int(te[c - 1][te[c - 1] < e_local][-1]) == first
            )
            last_seg[ci] = last - first
            cont_out = c + 1 < nc and bool(
                (te[c + 1] < e_local).any()
                and int(te[c + 1][te[c + 1] < e_local][0]) == last
            )
            n_final = (last - first + 1) - int(cont_out)
            if n_final > 0:
                ebase = ci * e_c
                chunk_entity[ebase : ebase + n_final] = np.arange(
                    first, first + n_final, dtype=np.int32
                )
                chunk_count[ebase : ebase + n_final] = counts_local[
                    first : first + n_final
                ]

    return TiledBlocks(
        neighbor_idx=neighbor,
        rating=rmat,
        weight=wmat,
        tile_seg=tile_seg,
        chunk_base=chunk_base,
        chunk_entity=chunk_entity,
        chunk_count=chunk_count,
        carry_in=carry_in,
        last_seg=last_seg,
        slice_starts=slice_starts,
        count=count_pad,
        rating_sum=rating_sum,
        mode=mode,
        num_entities=num_solve_entities,
        num_shards=num_shards,
        num_chunks=nc,
        chunk_cap=cap,
        chunk_entities=e_c,
        tile_rows=t,
        slice_rows=h,
        num_slices=n_slices,
        ring=ring,
    )


DENSE_STREAM_BLOCK_ROWS = 1 << 15  # BG: stream rows per block; tiles never
# cross a block boundary
DENSE_STREAM_GROUP_TILES = 64  # M: tile slots per group
DENSE_STREAM_ALIGN = 16  # run padding granularity


def _balanced_entity_order(l8: np.ndarray, n_bins: int) -> np.ndarray:
    """Order entities so every stream window mixes long and short runs:
    longest-processing-time-first bin packing into ``n_bins`` ≈ chunk count
    bins, read back bin by bin, so per-chunk entity and tile counts (which
    size Ec and NT for every chunk) track the mean chunk, not the worst."""
    o = np.argsort(-l8, kind="stable")
    n = o.shape[0]
    nb = max(1, min(int(n_bins), n))
    if nb == 1:
        return o
    heap = [(0, j) for j in range(nb)]
    bins: list[list[int]] = [[] for _ in range(nb)]
    for e in o:
        rows, j = heapq.heappop(heap)
        bins[j].append(int(e))
        heapq.heappush(heap, (rows + int(l8[e]), j))
    return np.concatenate([np.asarray(b, dtype=np.int64) for b in bins if b])


def _build_dense_stream(
    solve_dense: np.ndarray,
    fixed_dense: np.ndarray,
    rating: np.ndarray,
    num_solve_entities: int,
    num_fixed_entities: int,
    *,
    num_shards: int = 1,
    tile_rows: int = 128,
    chunk_elems: int | None = 1 << 19,
    group_tiles: int = DENSE_STREAM_GROUP_TILES,
    block_rows: int = DENSE_STREAM_BLOCK_ROWS,
) -> TiledBlocks:
    """Dense-stream tiled blocks: tile structure WITHOUT tile padding.

    The padded stream layout (``mode="stream"``) rounds every entity's run
    up to a multiple of T gather slots — measured 26% wasted rows on the
    full-Netflix user half, directly on the binding resource (XLA's row
    gather engine is row-slot-bound at ~600M rows/s, BASELINE.md).  Here
    runs are padded only to 16 rows (bf16 sublane-tile alignment,
    ~3.4%), packed
    back-to-back, and tiles become [T]-row WINDOWS into the dense stream:
    per tile the kernel loads rows [lb, lb+T) at a dynamic 16-aligned
    offset and masks rows outside [lo, hi) — see
    ``ops.pallas.gram_kernel.gram_tiles_dense_pallas``.  The kernel
    pipelines the gathered stream in [BG, k] blocks selected by a
    scalar-prefetched per-group block index, so tiles never cross a BG
    boundary (the builder splits them there — same owner, and the walk
    accumulates same-owner tiles, so a split costs one extra slot).

    Per-tile metadata rides in ``tile_meta`` = [g_blk (NG) ‖ lb ‖ lo ‖
    hi ‖ seg (NT each)] per chunk.  Trash slots (group padding) INHERIT
    the previous real tile's seg with an empty [lo, hi) window, keeping
    every owner's tiles contiguous in the walk — the kernel contract.
    The b-side coefficients stay TILE-ALIGNED in ``rating`` ([NC·NT·T],
    zeros outside each tile's window) so b needs no in-kernel mask and no
    dynamic lane slicing.  For the WEIGHTED path (iALS) the blocks also
    carry ``weight`` tile-aligned (1.0 at real entries — the generic mask
    channel the iALS coefficient transform needs) and ``rating_dense``
    aligned with the gather stream (the per-entry A-weight source: the
    half-step premultiplies gw = g·aw in XLA, and the kernel masks the gw
    operand of each tile Gram).  Unit-weight explicit ALS never uploads
    those two arrays.

    Reference semantics unchanged: same normal equations per entity
    (``processors/MFeatureCalculator.java:85-99``), asserted equal to the
    padded layouts by ``tests/test_tiled.py``.
    """
    t = int(tile_rows)
    a8 = DENSE_STREAM_ALIGN
    if t % a8 != 0 or t < a8:
        raise ValueError(
            f"dense stream needs tile_rows % {a8} == 0, got {t}"
        )
    cap = max(t, chunk_elems or (1 << 19))
    bg = int(block_rows)
    if bg < t:
        bg = ((t + a8 - 1) // a8) * a8
    if cap < bg:
        bg = ((cap + a8 - 1) // a8) * a8
        cap = bg
    else:
        cap = (cap // bg) * bg  # chunk boundaries are block boundaries
    m = int(group_tiles)
    e_pad = _round_up(num_solve_entities, num_shards)
    e_local = e_pad // num_shards
    f_pad = _round_up(num_fixed_entities, num_shards)
    h = f_pad  # padding entries index the appended zero row

    order, count, _ = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order].astype(np.int64)
    f_sorted = fixed_dense[order].astype(np.int64)
    r_sorted = rating[order].astype(np.float32)
    local_sorted = (s_sorted % e_local).astype(np.int64)
    shard_of = s_sorted // e_local

    count_pad = np.zeros(e_pad, dtype=np.int32)
    count_pad[:num_solve_entities] = count
    rating_sum = np.zeros(e_pad, dtype=np.float32)
    rating_sum[:num_solve_entities] = np.bincount(
        solve_dense, weights=rating.astype(np.float64),
        minlength=num_solve_entities,
    ).astype(np.float32)

    shards = []
    nc_max, ng_max, ec_max = 1, 1, 1
    for s in range(num_shards):
        sel = shard_of == s
        loc = local_sorted[sel]
        fix = f_sorted[sel]
        rat = r_sorted[sel]
        counts_local = count_pad.reshape(num_shards, e_local)[s]
        if loc.shape[0] == 0:
            shards.append(None)
            continue
        l_all = np.bincount(loc, minlength=e_local).astype(np.int64)
        present = np.flatnonzero(l_all)
        lp = l_all[present]
        l8 = (lp + DENSE_STREAM_ALIGN - 1) // DENSE_STREAM_ALIGN * DENSE_STREAM_ALIGN
        perm = _balanced_entity_order(
            l8, (int(l8.sum()) + cap - 1) // cap
        )
        n = present.shape[0]
        rank_full = np.full(e_local, -1, dtype=np.int64)
        rank_full[present[perm]] = np.arange(n)
        ord2 = np.argsort(rank_full[loc], kind="stable")
        fix2 = fix[ord2]
        rat2 = rat[ord2]
        l_in = lp[perm]
        l8_in = l8[perm]
        run_start8 = np.cumsum(l8_in) - l8_in
        total8 = int(l8_in.sum())
        pos_in_run = _concat_aranges(l_in)
        dst = run_start8[np.repeat(np.arange(n), l_in)] + pos_in_run

        nc_shard = max((total8 + cap - 1) // cap, 1)
        bg_cuts = np.arange(bg, total8, bg, dtype=np.int64)
        cuts = np.union1d(run_start8, bg_cuts)
        piece_start = cuts
        piece_end = np.append(cuts[1:], total8)
        piece_run = np.searchsorted(run_start8, piece_start, side="right") - 1
        tpp = (piece_end - piece_start + t - 1) // t
        tile_off = np.repeat(piece_start, tpp) + _concat_aranges(tpp) * t
        tile_end = np.minimum(tile_off + t, np.repeat(piece_end, tpp))
        tile_run = np.repeat(piece_run, tpp)
        ntile = tile_off.shape[0]
        tile_chunk = tile_off // cap
        nbc = cap // bg
        tile_blk_abs = tile_off // bg
        blk_in_chunk = (tile_blk_abs - tile_chunk * nbc).astype(np.int64)
        off_rel = tile_off - tile_blk_abs * bg
        lb = np.minimum(off_rel, bg - t)
        lo = off_rel - lb
        hi = lo + (tile_end - tile_off)

        cft = np.searchsorted(tile_chunk, np.arange(nc_shard), side="left")
        clt = np.searchsorted(tile_chunk, np.arange(nc_shard), side="right") - 1
        first_rank = tile_run[cft]
        last_rank = tile_run[clt]
        seg_val = tile_run - first_rank[tile_chunk]
        span = last_rank - first_rank + 1

        key = tile_chunk * nbc + blk_in_chunk
        key_change = np.empty(ntile, dtype=bool)
        key_change[0] = True
        np.not_equal(key[1:], key[:-1], out=key_change[1:])
        key_start = np.flatnonzero(key_change)
        idx_in_key = (
            np.arange(ntile) - key_start[np.cumsum(key_change) - 1]
        )
        g_change = key_change | (idx_in_key % m == 0)
        g_id = np.cumsum(g_change) - 1
        g_in_chunk = g_id - g_id[cft][tile_chunk]
        slot = g_in_chunk * m + idx_in_key % m
        ng_shard = int(g_in_chunk[clt].max()) + 1

        nc_max = max(nc_max, nc_shard)
        ng_max = max(ng_max, ng_shard)
        ec_max = max(ec_max, int(span.max()))
        shards.append(dict(
            fix2=fix2, rat2=rat2, dst=dst, total8=total8,
            nc_shard=nc_shard, present=present, perm=perm,
            l_all=l_all, tile_off=tile_off, tile_chunk=tile_chunk,
            blk_in_chunk=blk_in_chunk, lb=lb, lo=lo, hi=hi,
            seg_val=seg_val, g_change=g_change, g_in_chunk=g_in_chunk,
            slot=slot, first_rank=first_rank, last_rank=last_rank,
            span=span, counts_local=counts_local,
        ))

    nc, ng = nc_max, ng_max
    nt = ng * m
    e_c = min(ec_max, e_local)
    mw = ng + 4 * nt
    neighbor = np.full(num_shards * nc * cap, h, dtype=np.int32)
    rt_tiled = np.zeros(num_shards * nc * nt * t, dtype=np.float32)
    wt_tiled = np.zeros(num_shards * nc * nt * t, dtype=np.float32)
    rating_dense = np.zeros(num_shards * nc * cap, dtype=np.float32)
    tile_meta = np.zeros((num_shards, nc, mw), dtype=np.int32)
    chunk_entity = np.full(num_shards * nc * e_c, e_local, dtype=np.int32)
    chunk_count = np.zeros(num_shards * nc * e_c, dtype=np.int32)
    carry_in = np.zeros(num_shards * nc, dtype=np.float32)
    last_seg = np.zeros(num_shards * nc, dtype=np.int32)

    for s in range(num_shards):
        d = shards[s]
        if d is None:
            tile_meta[s, :, ng + 3 * nt:] = e_c  # all-trash seg
            continue
        base = s * nc * cap
        neighbor[base + d["dst"]] = d["fix2"].astype(np.int32)
        rating_dense[base + d["dst"]] = d["rat2"]

        tc, sl = d["tile_chunk"], d["slot"]
        lbv, lov, hiv, sgv = d["lb"], d["lo"], d["hi"], d["seg_val"]
        et = np.searchsorted(d["tile_off"], d["dst"], side="right") - 1
        row = d["dst"] - d["tile_off"][et] + lov[et]
        rt_idx = (s * nc + tc[et]) * nt * t + sl[et] * t + row
        rt_tiled[rt_idx] = d["rat2"]
        wt_tiled[rt_idx] = 1.0

        meta = tile_meta[s]
        gsel = d["g_change"]
        meta[tc[gsel], d["g_in_chunk"][gsel]] = d["blk_in_chunk"][gsel]
        flat = np.full((nc, nt), -1, dtype=np.int64)
        flat[tc, sl] = np.arange(tc.shape[0])
        filled = flat >= 0
        src = np.where(filled, flat, 0)
        meta[:, ng:ng + nt] = np.where(filled, lbv[src], 0)
        meta[:, ng + nt:ng + 2 * nt] = np.where(filled, lov[src], 0)
        meta[:, ng + 2 * nt:ng + 3 * nt] = np.where(filled, hiv[src], 0)
        seg_slots = np.where(filled, sgv[src], -1)
        ffill = np.where(filled, np.arange(nt)[None, :], 0)
        np.maximum.accumulate(ffill, axis=1, out=ffill)
        seg_f = np.take_along_axis(seg_slots, ffill, axis=1)
        any_before = np.maximum.accumulate(filled, axis=1)
        meta[:, ng + 3 * nt:] = np.where(any_before, seg_f, e_c)

        fr, lr, spn = d["first_rank"], d["last_rank"], d["span"]
        nc_shard = d["nc_shard"]
        rows_of_rank = d["present"][d["perm"]]
        counts_local = d["counts_local"]
        for c in range(nc_shard):
            ci = s * nc + c
            carry_in[ci] = float(c > 0 and lr[c - 1] == fr[c])
            last_seg[ci] = spn[c] - 1
            cont_out = c + 1 < nc_shard and fr[c + 1] == lr[c]
            n_final = int(spn[c]) - int(cont_out)
            if n_final > 0:
                ebase = ci * e_c
                rows = rows_of_rank[fr[c]:fr[c] + n_final]
                chunk_entity[ebase:ebase + n_final] = rows.astype(np.int32)
                chunk_count[ebase:ebase + n_final] = counts_local[rows]
        tile_meta[s, nc_shard:, ng + 3 * nt:] = e_c

    return TiledBlocks(
        neighbor_idx=neighbor,
        rating=rt_tiled,
        weight=wt_tiled,
        tile_seg=np.zeros(0, dtype=np.int32),
        chunk_base=np.zeros(0, dtype=np.int32),
        chunk_entity=chunk_entity,
        chunk_count=chunk_count,
        carry_in=carry_in,
        last_seg=last_seg,
        slice_starts=np.zeros(0, dtype=np.int32),
        count=count_pad,
        rating_sum=rating_sum,
        mode="dstream",
        num_entities=num_solve_entities,
        num_shards=num_shards,
        num_chunks=nc,
        chunk_cap=cap,
        chunk_entities=e_c,
        tile_rows=t,
        slice_rows=h,
        num_slices=1,
        ring=False,
        tile_meta=tile_meta.reshape(-1),
        rating_dense=rating_dense,
        num_tiles=nt,
        num_groups=ng,
        block_rows=bg,
    )


def _concat_aranges(lengths: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated — vectorized."""
    if lengths.shape[0] == 0:
        return np.zeros(0, dtype=np.int64)
    total = int(lengths.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.cumsum(lengths) - lengths
    return out - np.repeat(starts, lengths)


class _UserCSR:
    """``user_csr`` for an index with ``coo_dense`` and ``user_map``
    (``RatingsIndex``, ``Dataset``)."""

    @functools.cached_property
    def user_csr(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(movie rows int32, ratings f32, indptr int64) of the ratings
        grouped by user in numpy's stable argsort order (the counting sort
        ``group_by_dense``); read-only, built on first use and kept with
        the index, so every ``streaming.StreamState`` over it shares one."""
        coo = self.coo_dense
        n = self.user_map.num_entities
        order, counts, _ = group_by_dense(coo.user_raw, n)
        # Cast before the random gather: half the bytes move out of order.
        movies = coo.movie_raw.astype(np.int32)[order]
        ratings = coo.rating.astype(np.float32, copy=False)[order]
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        for a in (movies, ratings, indptr):
            a.flags.writeable = False
        return movies, ratings, indptr


@dataclasses.dataclass(frozen=True)
class RatingsIndex(_UserCSR):
    """Id maps + dense-index COO without any solve-block build.

    The subset of ``Dataset`` that serving needs (raw↔dense id mapping and
    exclude-seen lists), so a full-corpus ``recommend`` or ``serve`` never
    pays for the training layout.
    """

    movie_map: IdMap
    user_map: IdMap
    coo_dense: RatingsCOO

    @classmethod
    def from_coo(cls, coo: RatingsCOO) -> "RatingsIndex":
        movie_map, m_dense = index_entities(coo.movie_raw)
        user_map, u_dense = index_entities(coo.user_raw)
        return cls(
            movie_map=movie_map,
            user_map=user_map,
            coo_dense=RatingsCOO(
                movie_raw=m_dense.astype(np.int64),
                user_raw=u_dense.astype(np.int64),
                rating=coo.rating.astype(np.float32),
            ),
        )


def _resolve_ring(ring, nm: int, nu: int, num_shards: int,
                  accum_max_entities: int, rank_hint: int,
                  dense_stream: bool, ring_warn: bool) -> tuple[bool, bool]:
    """(movie_ring, user_ring) of ``Dataset.from_coo``'s ``ring``, with the
    reference's memory rule for ``"auto"`` and its warnings for a ring half
    that costs more than the table it saves."""
    import warnings

    def ring_saves_memory(n_solve: int, n_fixed: int) -> bool:
        k = rank_hint
        e_local = -(-n_solve // num_shards)
        f_pad = _round_up(n_fixed, num_shards)
        acc = (e_local + 1) * (k * k + k) * 4
        return f_pad // num_shards * k * 2 + acc < f_pad * k * 2

    def fits_accum(n_solve: int) -> bool:
        return -(-n_solve // num_shards) <= accum_max_entities

    if ring == "auto":
        return (ring_saves_memory(nm, nu) and fits_accum(nm),
                ring_saves_memory(nu, nm) and fits_accum(nu))
    m_ring, u_ring = ring if isinstance(ring, tuple) else (ring, ring)
    for side, r, ns, nf in (("movie", m_ring, nm, nu),
                            ("user", u_ring, nu, nm)):
        if ring_warn and r and fits_accum(ns) and \
                not ring_saves_memory(ns, nf):
            warnings.warn(
                f"ring-built {side} half: the per-entity Gram accumulator "
                "exceeds the all_gather table it saves (at "
                f"rank≈{rank_hint}) — all_gather is strictly better there; "
                "consider ring='auto'", stacklevel=3)
    if dense_stream and m_ring and u_ring and ring_warn:
        warnings.warn(
            "dense_stream=True is ignored: both halves are ring-built (ring "
            "implies the accum machinery); build with ring=False/'auto' or "
            "drop dense_stream", stacklevel=3)
    return bool(m_ring), bool(u_ring)


@dataclasses.dataclass(frozen=True)
class Dataset(_UserCSR):
    """A fully indexed rating dataset: id maps + both solve-side block sets."""

    movie_map: IdMap
    user_map: IdMap
    movie_blocks: "PaddedBlocks | BucketedBlocks | SegmentBlocks | TiledBlocks"  # neighbors: users
    user_blocks: "PaddedBlocks | BucketedBlocks | SegmentBlocks | TiledBlocks"  # neighbors: movies
    coo_dense: RatingsCOO  # dense-index COO (movie_raw/user_raw hold dense idx)

    def save(self, path: str, build_key: dict | None = None) -> None:
        """Cache the built dataset on disk; see ``data.cache``."""
        from cfk_tpu_torch.data.cache import save_dataset

        save_dataset(self, path, build_key=build_key)

    @classmethod
    def load(cls, path: str, expect_build_key: dict | None = None
             ) -> "Dataset":
        """Load a dataset cached with ``save`` (or by the JAX package)."""
        from cfk_tpu_torch.data.cache import load_dataset

        return load_dataset(path, expect_build_key=expect_build_key)

    @classmethod
    def from_coo(
        cls,
        coo: RatingsCOO,
        *,
        num_shards: int = 1,
        layout: str = "padded",
        pad_multiple: int = 8,
        chunk_elems: int | None = 1 << 20,
        ring: bool | str | tuple = False,
        accum_max_entities: int = 1 << 16,
        rank_hint: int = 64,
        dense_stream: bool = False,
        ring_warn: bool = True,
        tile_rows: int = 128,
    ) -> "Dataset":
        """Index the ratings and build both halves' blocks for
        ``num_shards`` shards (``cfk_tpu/data/blocks.py:1493-1667``).

        ``layout="padded"``: one rectangle per side.  ``layout="bucketed"``:
        power-of-two width classes, ``chunk_elems`` cells per solve chunk.
        ``layout="segment"``: flat sorted runs in nnz chunks, sized for the
        ``segsum`` Gram — the JAX package's rule where its JAX has no ragged
        matmul (``cfk_tpu/data/blocks.py:1535-1552``): that Gram holds a
        [C, k, k] outer-product tensor, so a chunk takes ``max(64,
        chunk_elems // 64)`` ratings.  The port has no ragged matmul, so it
        builds by this rule always.  ``layout="tiled"``: accum mode for a
        side with at most ``accum_max_entities`` entities a shard, stream
        mode for the other (the unpadded dense stream with
        ``dense_stream``, which the CLI asks for).

        ``ring`` (tiled layout): False/True build both halves for the
        all_gather/ring exchange, a ``(movie_ring, user_ring)`` tuple sets
        each half, ``"auto"`` rings exactly the halves whose per-device
        bytes (a fixed-side shard + the [E_local+1, k, k+1] accumulator, at
        ``rank_hint`` and bf16 factors) undercut the all-gathered table.
        A ring half is accum mode with the fixed side's shards as slices."""
        movie_map, m_dense = index_entities(coo.movie_raw)
        user_map, u_dense = index_entities(coo.user_raw)
        kw = dict(num_shards=num_shards, pad_multiple=pad_multiple)
        if layout == "segment":
            chunk_nnz = (None if chunk_elems is None
                         else max(64, chunk_elems // 64))
            build = functools.partial(build_segment_blocks, chunk_nnz=chunk_nnz,
                                      **kw)
        elif layout == "bucketed":
            build = functools.partial(build_bucketed_blocks,
                                      chunk_elems=chunk_elems, **kw)
        elif layout == "tiled":
            build = functools.partial(
                build_tiled_blocks, num_shards=num_shards,
                chunk_elems=chunk_elems,
                accum_max_entities=accum_max_entities,
                dense_stream=dense_stream, tile_rows=tile_rows)
        elif layout == "padded":
            build = functools.partial(build_padded_blocks, **kw)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        if ring and layout != "tiled":
            raise ValueError(
                "ring applies to layout='tiled' (the padded layout's "
                "ring blocks are built by the sharded trainer itself)")
        if not isinstance(ring, (bool, tuple)) and ring != "auto":
            raise ValueError(
                f"ring must be True/False/'auto'/(movie, user), got {ring!r}")
        nm, nu = movie_map.num_entities, user_map.num_entities
        if layout != "tiled":
            movie_blocks = build(m_dense, u_dense, coo.rating, nm)
            user_blocks = build(u_dense, m_dense, coo.rating, nu)
        else:
            m_ring, u_ring = _resolve_ring(
                ring, nm, nu, num_shards, accum_max_entities, rank_hint,
                dense_stream, ring_warn)
            movie_blocks = build(m_dense, u_dense, coo.rating, nm, nu,
                                 ring=m_ring)
            user_blocks = build(u_dense, m_dense, coo.rating, nu, nm,
                                ring=u_ring)
        return cls(
            movie_map=movie_map,
            user_map=user_map,
            movie_blocks=movie_blocks,
            user_blocks=user_blocks,
            coo_dense=RatingsCOO(
                movie_raw=m_dense.astype(np.int64),
                user_raw=u_dense.astype(np.int64),
                rating=coo.rating.astype(np.float32),
            ),
        )
