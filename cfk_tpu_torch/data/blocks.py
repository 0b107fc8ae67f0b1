"""Rating blocks: the per-side InBlocks the ALS half-steps consume.

The port's own copy of the host-side block builders of
``cfk_tpu/data/blocks.py`` (numpy only; the port imports nothing of
``cfk_tpu``).  It keeps the single-device subset the first slice trains on:

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

Every array is bit-identical to what ``cfk_tpu.data.blocks`` builds for the
same ratings at ``num_shards=1`` (asserted by ``tests/test_torch_blocks.py``
and ``tests/test_torch_bucketed.py``).
Sharded and ring builds are later slices.

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
    pad_multiple: int = 8,
) -> PaddedBlocks:
    """Group ratings by the solve-side entity into a padded rectangle."""
    nnz = solve_dense.shape[0]
    order, count, group_start = group_by_dense(solve_dense, num_solve_entities)
    s_sorted = solve_dense[order]
    f_sorted = fixed_dense[order].astype(np.int32)
    r_sorted = rating[order].astype(np.float32)

    max_nnz = _round_up(max(int(count.max()), 1), pad_multiple)
    pos = np.arange(nnz, dtype=np.int64) - group_start[s_sorted]

    neighbor = np.zeros((num_solve_entities, max_nnz), dtype=np.int32)
    rmat = np.zeros((num_solve_entities, max_nnz), dtype=np.float32)
    mask = np.zeros((num_solve_entities, max_nnz), dtype=np.float32)
    neighbor[s_sorted, pos] = f_sorted
    rmat[s_sorted, pos] = r_sorted
    mask[s_sorted, pos] = 1.0
    return PaddedBlocks(
        neighbor_idx=neighbor,
        rating=rmat,
        mask=mask,
        count=count.astype(np.int32),
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
    num_slices: int = 1
    tile_meta: np.ndarray | None = None  # dstream int32 [NC·(NG+4·NT)]
    rating_dense: np.ndarray | None = None  # dstream f32 [NC·C] stream-aligned
    num_tiles: int = 0  # dstream NT (tile slots per chunk)
    num_groups: int = 0  # dstream NG
    block_rows: int = 0  # dstream BG (stream rows per block)

    @property
    def padded_entities(self) -> int:
        return int(self.count.shape[0])

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
    row's entity and rating count, with the trash entity ``num_entities``
    (count 0) for rows not finalized in that chunk (an entity continuing
    into the next chunk, and padding).  ``group_sizes`` counts the entries
    of every segment (trash last).  The fields are the JAX package's, so its
    dataset caches load here; the port builds and trains one shard only
    (``num_shards`` 1).
    """

    neighbor_idx: np.ndarray  # int32 [NC·C] dense idx into the fixed side (0 at padding)
    rating: np.ndarray  # float32 [NC·C] (0 at padding)
    mask: np.ndarray  # float32 [NC·C] 1.0 = real rating
    seg_rel: np.ndarray  # int32 [NC·C] chunk-relative entity row, sorted per chunk
    chunk_entity: np.ndarray  # int32 [NC·Ec] entity row (num_entities = trash)
    chunk_count: np.ndarray  # int32 [NC·Ec] full rating count of finalized rows (0 else)
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
    pad_multiple: int = 8,
    chunk_nnz: int | None = None,
    chunk_entity_cap: int | None = None,
) -> SegmentBlocks:
    """Sort ratings by entity and pack them into nnz chunks (one shard).

    ``chunk_nnz`` is the ratings-per-chunk capacity; a chunk also covers at
    most ``chunk_entity_cap`` consecutive entities (default
    ``min(chunk_nnz // 32, 16384)``), bounding the [Ec, k, k] Gram batch
    even on all-degree-1 runs.  Entities whose degree exceeds the capacity
    straddle chunks, so the capacity never grows with the degree
    distribution's head.  ``None`` packs the side into one chunk.  Arrays
    are bit-identical to ``cfk_tpu``'s ``build_segment_blocks`` at
    ``num_shards=1``.
    """
    e = num_solve_entities
    order, count, _ = group_by_dense(solve_dense, e)
    s_sorted = solve_dense[order].astype(np.int32)
    f_sorted = fixed_dense[order].astype(np.int32)
    r_sorted = rating[order].astype(np.float32)
    nnz = int(s_sorted.shape[0])
    count = count.astype(np.int32)

    if chunk_nnz is None:
        cap = max(nnz, 1, pad_multiple)
        e_cap = max(e, 1)
    else:
        # Never pad a chunk beyond the side's actual run.
        cap = max(min(int(chunk_nnz), nnz), pad_multiple)
        e_cap = (max(int(chunk_entity_cap), 1) if chunk_entity_cap is not None
                 else max(1, min(cap // 32, 1 << 14)))
    cap = _round_up(cap, pad_multiple)

    # Greedy nnz packing: cut the sorted run every ``cap`` entries, or
    # sooner where the slice would span more than ``e_cap`` entities.  A cut
    # may fall inside an entity's run: that entity straddles chunks.
    cum = np.zeros(e + 1, dtype=np.int64)  # run position of entity e's first entry
    np.cumsum(count, out=cum[1:])
    cuts = []
    pos = 0
    while pos < nnz:
        end = min(pos + cap, nnz)
        first = int(s_sorted[pos])
        if int(s_sorted[end - 1]) - first + 1 > e_cap:
            end = int(cum[first + e_cap])
        cuts.append((pos, end))
        pos = end

    nc = max(len(cuts), 1)
    e_c = max([int(s_sorted[p1 - 1]) - int(s_sorted[p0]) + 1
               for p0, p1 in cuts], default=1)

    neighbor = np.zeros(nc * cap, dtype=np.int32)
    rmat = np.zeros(nc * cap, dtype=np.float32)
    mask = np.zeros(nc * cap, dtype=np.float32)
    seg = np.full(nc * cap, e_c, dtype=np.int32)  # trash
    chunk_entity = np.full(nc * e_c, e, dtype=np.int32)
    chunk_count = np.zeros(nc * e_c, dtype=np.int32)
    group_sizes = np.zeros((nc, e_c + 1), dtype=np.int32)
    group_sizes[:, e_c] = cap  # an all-padding chunk is one trash segment
    carry_in = np.zeros(nc, dtype=np.float32)
    last_seg = np.zeros(nc, dtype=np.int32)
    chunk_first = np.zeros(nc, dtype=np.int32)

    for c, (p0, p1) in enumerate(cuts):
        n = p1 - p0
        dst = c * cap
        first = int(s_sorted[p0])
        last = int(s_sorted[p1 - 1])
        neighbor[dst:dst + n] = f_sorted[p0:p1]
        rmat[dst:dst + n] = r_sorted[p0:p1]
        mask[dst:dst + n] = 1.0
        seg_chunk = (s_sorted[p0:p1] - first).astype(np.int64)
        seg[dst:dst + n] = seg_chunk
        sizes = np.bincount(seg_chunk, minlength=e_c + 1).astype(np.int32)
        sizes[e_c] = cap - n  # the tail padding sits in the trash segment
        group_sizes[c] = sizes
        carry_in[c] = float(p0 > 0 and int(s_sorted[p0 - 1]) == first)
        last_seg[c] = last - first
        chunk_first[c] = first
        # Rows are finalized here unless the last entity continues into the
        # next chunk; only the finalizing chunk writes an entity's row.
        cont_out = p1 < nnz and int(s_sorted[p1]) == last
        n_final = (last - first + 1) - int(cont_out)
        if n_final > 0:
            chunk_entity[c * e_c:c * e_c + n_final] = np.arange(
                first, first + n_final, dtype=np.int32)
            chunk_count[c * e_c:c * e_c + n_final] = count[first:
                                                           first + n_final]

    return SegmentBlocks(
        neighbor_idx=neighbor,
        rating=rmat,
        mask=mask,
        seg_rel=seg,
        chunk_entity=chunk_entity,
        chunk_count=chunk_count,
        group_sizes=group_sizes.reshape(-1),
        carry_in=carry_in,
        last_seg=last_seg,
        chunk_first=chunk_first,
        count=count,
        rating_sum=_rating_sum(solve_dense, rating, e),
        num_entities=e,
        num_shards=1,
        num_chunks=nc,
        chunk_cap=cap,
        chunk_entities=e_c,
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
    tile_rows: int = 128,
    chunk_elems: int | None = 1 << 20,
    slice_rows: int = TILED_SLICE_ROWS_DEFAULT,
    accum_max_entities: int = 1 << 16,
    dense_stream: bool = False,
) -> TiledBlocks:
    """Pad entity runs to tiles and pack into chunks (one mode per side).

    ``accum`` when the solve-entity count fits ``accum_max_entities`` (the
    [E+1, k, k] accumulator must fit device memory), else ``stream`` — or,
    with ``dense_stream``, the unpadded dense stream.  Table slicing engages
    only in accum mode and only when the fixed side exceeds ``slice_rows``.
    """
    if dense_stream and num_solve_entities > accum_max_entities:
        return _build_dense_stream(
            solve_dense, fixed_dense, rating, num_solve_entities,
            num_fixed_entities, tile_rows=tile_rows, chunk_elems=chunk_elems,
        )
    t = int(tile_rows)
    if t < 8:
        raise ValueError(f"tile_rows must be >= 8, got {t}")
    e_local = num_solve_entities
    f_pad = num_fixed_entities
    mode = "accum" if e_local <= accum_max_entities else "stream"
    n_slices = 1
    h = f_pad
    if mode == "accum" and f_pad > slice_rows:
        h = int(slice_rows)
        n_slices = (f_pad + h - 1) // h

    order, count, _ = group_by_dense(solve_dense, num_solve_entities)
    loc = solve_dense[order].astype(np.int64)
    fix = fixed_dense[order].astype(np.int64)
    rat = rating[order].astype(np.float32)
    count = count.astype(np.int32)
    rating_sum = _rating_sum(solve_dense, rating, num_solve_entities)

    cap = max(t, ((chunk_elems or (1 << 20)) // t) * t)
    nt = cap // t

    if n_slices > 1:
        sl = fix // h
        o = np.lexsort((loc, sl))
        loc, fix, rat, sl = loc[o], fix[o], rat[o], sl[o]
    else:
        sl = np.zeros(loc.shape[0], dtype=np.int64)
    # Runs = consecutive equal (slice, entity) pairs; entries are sorted.
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
        run_start = run_len = run_entity = run_slice = np.zeros(0, np.int64)
    run_pad = ((run_len + t - 1) // t) * t
    slice_rounded = None
    if n_slices > 1:
        # Chunks must not span slices: pad each slice's stream to a
        # multiple of cap.
        padded_per_slice = np.bincount(
            run_slice, weights=run_pad.astype(np.float64), minlength=n_slices,
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
    nc = max((total_padded + cap - 1) // cap, 1)

    # Padding entries index the slice's appended zero row (= its height h).
    neighbor = np.full(nc * cap, h, dtype=np.int32)
    rmat = np.zeros(nc * cap, dtype=np.float32)
    wmat = np.zeros(nc * cap, dtype=np.float32)
    tile_seg = np.zeros(nc * nt, dtype=np.int32)
    chunk_base = np.zeros(nc, dtype=np.int32)

    tile_entity = np.full(nc * nt, e_local, dtype=np.int64)
    if run_len.shape[0]:
        tile_idx = run_dst // t
        reps = (run_pad // t).astype(np.int64)
        fill_pos = np.repeat(tile_idx, reps) + _concat_aranges(reps)
        tile_entity[fill_pos] = np.repeat(run_entity, reps)
    te = tile_entity.reshape(nc, nt)
    # Ec: stream mode, the widest entity SPAN of any chunk (solve-batch
    # rows); accum mode, the most DISTINCT entities (accumulator rows).
    e_c = 1
    for c in range(nc):
        real = te[c][te[c] < e_local]
        if real.size:
            e_c = max(e_c, int(real[-1] - real[0]) + 1 if mode == "stream"
                      else int(np.unique(real).shape[0]))
    e_c = min(e_c, e_local)

    chunk_entity = np.full(nc * e_c, e_local, dtype=np.int32)
    chunk_count = np.zeros(nc * e_c, dtype=np.int32)
    carry_in = np.zeros(nc, dtype=np.float32)
    last_seg = np.zeros(nc, dtype=np.int32)
    slice_starts = np.zeros(n_slices + 1, dtype=np.int32)
    if run_len.shape[0]:
        pos_in_run = np.arange(loc.shape[0], dtype=np.int64) - np.repeat(
            run_start, run_len
        )
        dst = np.repeat(run_dst, run_len) + pos_in_run
        if n_slices > 1:
            slice_first_row = np.minimum(sl * h, f_pad - h)
            neighbor[dst] = (fix - slice_first_row).astype(np.int32)
        else:
            neighbor[dst] = fix.astype(np.int32)
        rmat[dst] = rat
        wmat[dst] = 1.0
    if mode == "stream":
        _stream_chunk_meta(te, e_local, e_c, count, tile_seg, chunk_entity,
                           chunk_count, carry_in, last_seg)
    else:
        _accum_chunk_meta(te, e_local, e_c, tile_seg, chunk_entity)
        if n_slices > 1 and run_len.shape[0]:
            chunks_per_slice = slice_rounded // cap
            sl_of_chunk = np.repeat(np.arange(n_slices), chunks_per_slice)
            chunk_base[:sl_of_chunk.shape[0]] = np.minimum(
                sl_of_chunk * h, f_pad - h
            ).astype(np.int32)
            np.cumsum(chunks_per_slice, out=slice_starts[1:])
        else:
            slice_starts[1:] = (total_padded + cap - 1) // cap

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
        count=count,
        rating_sum=rating_sum,
        mode=mode,
        num_entities=num_solve_entities,
        num_chunks=nc,
        chunk_cap=cap,
        chunk_entities=e_c,
        tile_rows=t,
        slice_rows=h,
        num_slices=n_slices,
    )


def _accum_chunk_meta(te, e_local, e_c, tile_seg, chunk_entity):
    """Accum mode's per-chunk tile owners, filled in place: chunk-DENSE
    ranks plus an explicit entity list (slicing leaves gaps in the entity
    sequence); trash tiles rank Ec."""
    nc, nt = te.shape
    for c in range(nc):
        tiles_c = te[c]
        real = tiles_c < e_local
        if not real.any():
            tile_seg[c * nt:(c + 1) * nt] = e_c
            continue
        distinct = np.unique(tiles_c[real])
        tile_seg[c * nt:(c + 1) * nt] = np.where(
            real, np.searchsorted(distinct, tiles_c), e_c
        ).astype(np.int32)
        chunk_entity[c * e_c:c * e_c + distinct.shape[0]] = distinct


def _stream_chunk_meta(te, e_local, e_c, count, tile_seg, chunk_entity,
                       chunk_count, carry_in, last_seg):
    """Stream mode's per-chunk bookkeeping, filled in place from the tile
    owners ``te`` [NC, NT]: chunk-relative tile segments (trash = Ec), the
    carry flag of a chunk whose first entity continues the previous chunk's
    last, the last real segment (the next carry), and the finalized
    entities with their counts (an entity continuing into the next chunk is
    finalized there)."""
    nc, nt = te.shape
    for c in range(nc):
        tiles_c = te[c]
        real = tiles_c < e_local
        if not real.any():
            tile_seg[c * nt:(c + 1) * nt] = e_c
            continue
        first = int(tiles_c[real][0])
        last = int(tiles_c[real][-1])
        tile_seg[c * nt:(c + 1) * nt] = np.where(
            real, tiles_c - first, e_c).astype(np.int32)
        prev = te[c - 1][te[c - 1] < e_local] if c > 0 else tiles_c[:0]
        carry_in[c] = float(prev.size > 0 and int(prev[-1]) == first)
        last_seg[c] = last - first
        nxt = te[c + 1][te[c + 1] < e_local] if c + 1 < nc else tiles_c[:0]
        cont_out = bool(nxt.size > 0 and int(nxt[0]) == last)
        n_final = (last - first + 1) - int(cont_out)
        if n_final > 0:
            chunk_entity[c * e_c:c * e_c + n_final] = np.arange(
                first, first + n_final, dtype=np.int32)
            chunk_count[c * e_c:c * e_c + n_final] = count[first:
                                                           first + n_final]


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
    tile_rows: int = 128,
    chunk_elems: int | None = 1 << 19,
    group_tiles: int = DENSE_STREAM_GROUP_TILES,
    block_rows: int = DENSE_STREAM_BLOCK_ROWS,
) -> TiledBlocks:
    """Dense-stream tiled blocks: tile structure WITHOUT tile padding.

    Runs are padded only to 16 rows and packed back to back; tiles become
    [T]-row windows into the dense stream: tile i of a chunk covers stream
    rows ``g_blk[i // M]·BG + lb_i + r`` for ``r ∈ [lo_i, hi_i)``.  Tiles are
    cut at run starts and at BG boundaries, then every T rows.  Per-tile
    metadata rides in ``tile_meta`` = [g_blk (NG) ‖ lb ‖ lo ‖ hi ‖ seg
    (NT each)] per chunk.  Trash slots (group padding) inherit the previous
    real tile's seg with an empty window, so every owner's tiles stay
    contiguous.  The b-side coefficients are TILE-aligned in ``rating``
    ([NC·NT·T], zero outside each window); padding entries of the stream
    index the fixed table's virtual zero row (its height F).
    """
    t = int(tile_rows)
    a8 = DENSE_STREAM_ALIGN
    if t % a8 != 0 or t < a8:
        raise ValueError(f"dense stream needs tile_rows % {a8} == 0, got {t}")
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
    e_local = num_solve_entities
    h = num_fixed_entities  # padding entries index the virtual zero row

    order, count, _ = group_by_dense(solve_dense, num_solve_entities)
    loc = solve_dense[order].astype(np.int64)
    fix = fixed_dense[order].astype(np.int64)
    rat = rating[order].astype(np.float32)
    count = count.astype(np.int32)
    rating_sum = _rating_sum(solve_dense, rating, num_solve_entities)

    l_all = np.bincount(loc, minlength=e_local).astype(np.int64)
    present = np.flatnonzero(l_all)
    lp = l_all[present]
    l8 = (lp + a8 - 1) // a8 * a8
    perm = _balanced_entity_order(l8, (int(l8.sum()) + cap - 1) // cap)
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
    dst = run_start8[np.repeat(np.arange(n), l_in)] + _concat_aranges(l_in)

    nc = max((total8 + cap - 1) // cap, 1)
    # Tiles: pieces between (run start ∪ BG-boundary) cuts, then T-cut.
    cuts = np.union1d(run_start8, np.arange(bg, total8, bg, dtype=np.int64))
    piece_end = np.append(cuts[1:], total8)
    piece_run = np.searchsorted(run_start8, cuts, side="right") - 1
    tpp = (piece_end - cuts + t - 1) // t
    tile_off = np.repeat(cuts, tpp) + _concat_aranges(tpp) * t
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

    cft = np.searchsorted(tile_chunk, np.arange(nc), side="left")
    clt = np.searchsorted(tile_chunk, np.arange(nc), side="right") - 1
    first_rank = tile_run[cft]
    last_rank = tile_run[clt]
    seg_val = tile_run - first_rank[tile_chunk]
    span = last_rank - first_rank + 1

    # Groups: ≤ m consecutive tiles sharing one (chunk, block).
    key = tile_chunk * nbc + blk_in_chunk
    key_change = np.empty(ntile, dtype=bool)
    key_change[0] = True
    np.not_equal(key[1:], key[:-1], out=key_change[1:])
    key_start = np.flatnonzero(key_change)
    idx_in_key = np.arange(ntile) - key_start[np.cumsum(key_change) - 1]
    g_change = key_change | (idx_in_key % m == 0)
    g_id = np.cumsum(g_change) - 1
    g_in_chunk = g_id - g_id[cft][tile_chunk]
    slot = g_in_chunk * m + idx_in_key % m
    ng = int(g_in_chunk[clt].max()) + 1

    nt = ng * m
    e_c = min(int(span.max()), e_local)
    mw = ng + 4 * nt
    neighbor = np.full(nc * cap, h, dtype=np.int32)
    rt_tiled = np.zeros(nc * nt * t, dtype=np.float32)
    wt_tiled = np.zeros(nc * nt * t, dtype=np.float32)
    rating_dense = np.zeros(nc * cap, dtype=np.float32)
    meta = np.zeros((nc, mw), dtype=np.int32)
    chunk_entity = np.full(nc * e_c, e_local, dtype=np.int32)
    chunk_count = np.zeros(nc * e_c, dtype=np.int32)
    carry_in = np.zeros(nc, dtype=np.float32)
    last_seg = np.zeros(nc, dtype=np.int32)

    neighbor[dst] = fix2.astype(np.int32)
    rating_dense[dst] = rat2
    # Entries → tile-aligned rating/weight slots.
    et = np.searchsorted(tile_off, dst, side="right") - 1
    row = dst - tile_off[et] + lo[et]
    rt_idx = tile_chunk[et] * nt * t + slot[et] * t + row
    rt_tiled[rt_idx] = rat2
    wt_tiled[rt_idx] = 1.0

    meta[tile_chunk[g_change], g_in_chunk[g_change]] = blk_in_chunk[g_change]
    flat = np.full((nc, nt), -1, dtype=np.int64)
    flat[tile_chunk, slot] = np.arange(ntile)
    filled = flat >= 0
    src = np.where(filled, flat, 0)
    meta[:, ng:ng + nt] = np.where(filled, lb[src], 0)
    meta[:, ng + nt:ng + 2 * nt] = np.where(filled, lo[src], 0)
    meta[:, ng + 2 * nt:ng + 3 * nt] = np.where(filled, hi[src], 0)
    # hi == lo marks trash; seg forward-fills from the previous real tile so
    # every owner's tiles stay contiguous (leading trash of an all-trash
    # chunk falls through to e_c).
    seg_slots = np.where(filled, seg_val[src], -1)
    ffill = np.where(filled, np.arange(nt)[None, :], 0)
    np.maximum.accumulate(ffill, axis=1, out=ffill)
    seg_f = np.take_along_axis(seg_slots, ffill, axis=1)
    any_before = np.maximum.accumulate(filled, axis=1)
    meta[:, ng + 3 * nt:] = np.where(any_before, seg_f, e_c)

    rows_of_rank = present[perm]
    for c in range(nc):
        carry_in[c] = float(c > 0 and last_rank[c - 1] == first_rank[c])
        last_seg[c] = span[c] - 1
        cont_out = c + 1 < nc and first_rank[c + 1] == last_rank[c]
        n_final = int(span[c]) - int(cont_out)
        if n_final > 0:
            rows = rows_of_rank[first_rank[c]:first_rank[c] + n_final]
            chunk_entity[c * e_c:c * e_c + n_final] = rows.astype(np.int32)
            chunk_count[c * e_c:c * e_c + n_final] = count[rows]

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
        count=count,
        rating_sum=rating_sum,
        mode="dstream",
        num_entities=num_solve_entities,
        num_chunks=nc,
        chunk_cap=cap,
        chunk_entities=e_c,
        tile_rows=t,
        slice_rows=h,
        tile_meta=meta.reshape(-1),
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
        layout: str = "padded",
        pad_multiple: int = 8,
        chunk_elems: int | None = 1 << 20,
        accum_max_entities: int = 1 << 16,
        dense_stream: bool = False,
        tile_rows: int = 128,
    ) -> "Dataset":
        """Index the ratings and build both halves' blocks.

        ``layout="padded"``: one rectangle per side.  ``layout="bucketed"``:
        power-of-two width classes, ``chunk_elems`` cells per solve chunk.
        ``layout="segment"``: flat sorted runs in nnz chunks, sized for the
        ``segsum`` Gram — the JAX package's rule where its JAX has no ragged
        matmul (``cfk_tpu/data/blocks.py:1535-1552``): that Gram holds a
        [C, k, k] outer-product tensor, so a chunk takes ``max(64,
        chunk_elems // 64)`` ratings.  The port has no ragged matmul, so it
        builds by this rule always.  ``layout="tiled"``: accum mode for a
        side with at most ``accum_max_entities`` entities, stream mode for
        the other (the unpadded dense stream with ``dense_stream``, which the
        CLI asks for)."""
        movie_map, m_dense = index_entities(coo.movie_raw)
        user_map, u_dense = index_entities(coo.user_raw)
        if layout == "segment":
            chunk_nnz = (None if chunk_elems is None
                         else max(64, chunk_elems // 64))

            def build(s, f, ns, _nf):
                return build_segment_blocks(
                    s, f, coo.rating, ns, pad_multiple=pad_multiple,
                    chunk_nnz=chunk_nnz)
        elif layout == "bucketed":
            def build(s, f, ns, _nf):
                return build_bucketed_blocks(
                    s, f, coo.rating, ns, pad_multiple=pad_multiple,
                    chunk_elems=chunk_elems)
        elif layout == "tiled":
            def build(s, f, ns, nf):
                return build_tiled_blocks(
                    s, f, coo.rating, ns, nf, tile_rows=tile_rows,
                    chunk_elems=chunk_elems,
                    accum_max_entities=accum_max_entities,
                    dense_stream=dense_stream,
                )
        elif layout == "padded":
            def build(s, f, ns, _nf):
                return build_padded_blocks(
                    s, f, coo.rating, ns, pad_multiple=pad_multiple)
        else:
            raise ValueError(f"unknown layout {layout!r}")
        nm, nu = movie_map.num_entities, user_map.num_entities
        return cls(
            movie_map=movie_map,
            user_map=user_map,
            movie_blocks=build(m_dense, u_dense, nm, nu),
            user_blocks=build(u_dense, m_dense, nu, nm),
            coo_dense=RatingsCOO(
                movie_raw=m_dense.astype(np.int64),
                user_raw=u_dense.astype(np.int64),
                rating=coo.rating.astype(np.float32),
            ),
        )
