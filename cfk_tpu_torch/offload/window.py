"""Window planning: cut tiled chunk scans into stageable units.

The port of ``cfk_tpu/offload/window.py`` (host-side index work in numpy;
the plans are array-equal to the reference's on the same blocks).  A
windowed half-step runs the same per-chunk Gram+solve as the resident tiled
half-steps — the only difference is where the fixed factor table lives:

- ``WindowPlan`` (stream mode, the all_gather scan): chunks are grouped into
  consecutive WINDOWS, cut only where ``carry_in == 0`` (no entity crosses
  a cut, so each window's zero carry is the resident scan's state at that
  chunk), and each window's neighbor row set is the sorted unique table
  rows its chunks gather;
- ``RingWindowPlan`` (the ring / hier-ring exchanges, accum-mode ring
  blocks): each fixed-table slice's chunk range is cut into windows (the
  per-slice Gram accumulation is chunk-dense, no carry), and the staged
  window is the slice rows the shard's chunks reference;
- ``BucketWindowPlan`` (the bucketed layout of the implicit family): width
  classes cut at the resident walk's own ``chunk_rows`` pieces.

Chunk indices are REBASED into the staged window: the virtual zero row maps
to the static ``window_rows`` slot — the convention the gather kernels read
(index = table height → zero row), so they run unmodified against a window
table of ``window_rows`` rows.  All windows of a plan share one static
shape (``window_chunks`` chunks, the ragged ones padded with all-trash
chunks; ``window_rows`` staged rows).

The plan holds only the rebased neighbor stream, the per-window row sets
and scalar metadata; the rating/weight/tile/entity chunk arrays are served
at stage time as slices of the original block arrays (``stage_chunks``).
Sharded blocks are planned per shard (``shard=``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _row_set(idx: np.ndarray, limit: int) -> np.ndarray:
    """The sorted unique entries of ``idx`` below ``limit`` — ``np.unique``
    of them — through a presence mask (O(cells + limit), no sort)."""
    mask = np.zeros(int(limit), dtype=bool)
    mask[idx[idx < limit]] = True
    return np.flatnonzero(mask).astype(idx.dtype)


class _Rebase:
    """Each index's position in a window's sorted row set, entries at or
    above ``limit`` (the virtual zero row) mapped to ``zero`` — what
    ``np.searchsorted(rows_w, idx)`` gives for the set's members, by one
    lookup table reused across windows (O(cells))."""

    def __init__(self, limit: int) -> None:
        self.limit = int(limit)
        self.lut = np.zeros(self.limit + 1, dtype=np.int32)

    def __call__(self, rows_w, idx, zero: int) -> np.ndarray:
        self.lut[rows_w] = np.arange(rows_w.shape[0], dtype=np.int32)
        self.lut[self.limit] = zero
        return self.lut[np.minimum(idx, self.limit)]


def _shard_leaf(arr: np.ndarray, num_shards: int, shard: int) -> np.ndarray:
    """Shard ``shard``'s slice of a shard-major flat block array (a VIEW)."""
    return arr.reshape(num_shards, -1)[shard]


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """Stream-mode window plan: one shard's chunk scan as staged windows.

    Plan-held arrays are the rebased neighbor stream + per-window row
    sets + tiny per-window metadata; everything else is served at stage
    time as views/assemblies over ``src`` (the original block arrays)."""

    rows: np.ndarray          # [W, R] int64 table rows staged per window
    row_counts: np.ndarray    # [W] real rows (<= R; the rest pad row 0)
    chunk_lo: np.ndarray      # [W] first source chunk of each window
    chunk_counts: np.ndarray  # [W] real chunks (<= ncw; the rest all-trash)
    neighbor_idx: np.ndarray  # [W, ncw·C] int32 window-rebased (zero row → R)
    carry_in: np.ndarray      # [W, ncw] f32 (0 at every window start)
    last_seg: np.ndarray      # [W, ncw] int32
    statics: tuple            # (ncw, C, Ec, T) — the per-window half-step's
    window_rows: int          # R (static staged-table height)
    table_rows: int           # F (the fixed side's padded rows)
    local_entities: int       # solve side's padded rows (trash id)
    # Views of the source chunk arrays (shapes [nc, cap] / [nc, nt] /
    # [nc, Ec]) — shared memory with the TiledBlocks, never copied here.
    src: dict = dataclasses.field(repr=False, default_factory=dict)

    @property
    def num_windows(self) -> int:
        return int(self.rows.shape[0])

    def schedule(self) -> list[int]:
        """The window consumption order the stream half-step commits —
        the chunk scan's own order.  THE order the staging engine
        (``offload/staging.py``) must serve windows in; having one
        authority here is what keeps the pooled and serial trainers
        consuming identical sequences."""
        return list(range(self.num_windows))

    def staged_bytes_per_window(self, rank: int, stage_itemsize: int, *,
                                row_overhead_bytes: int = 0) -> int:
        """Bytes one staged window occupies on device: the gathered table
        rows at the staging dtype (+ per-row overhead — the int8 scheme's
        f32 scale) plus the window's chunk arrays."""
        ncw, cap, e_c, t = self.statics
        nt = cap // t
        table = int(self.window_rows) * (rank * stage_itemsize
                                         + row_overhead_bytes)
        chunks = (
            ncw * cap * 12            # nb (int32) + rating + weight (f32)
            + ncw * nt * 4            # tile_seg
            + 2 * ncw * e_c * 4       # chunk_entity + chunk_count
            + 2 * ncw * 4             # carry_in + last_seg
        )
        return table + chunks

    def plan_held_bytes(self) -> int:
        """Host bytes this plan PINS for its lifetime (the zero-copy
        contract: the rebased neighbor stream + row sets + metadata; the
        chunk arrays stay the TiledBlocks' own memory)."""
        return (self.rows.nbytes + self.row_counts.nbytes
                + self.chunk_lo.nbytes + self.chunk_counts.nbytes
                + self.neighbor_idx.nbytes + self.carry_in.nbytes
                + self.last_seg.nbytes)

    def chunk_entity_of(self, w: int) -> np.ndarray:
        """Window ``w``'s [ncw·Ec] finalization rows (the host scatter's
        targets — pad chunks route to ``local_entities``)."""
        ncw, cap, e_c, t = self.statics
        n = int(self.chunk_counts[w])
        lo = int(self.chunk_lo[w])
        ent = self.src["chunk_entity"]
        if n == ncw:
            return ent[lo:lo + ncw].reshape(-1)
        out = np.full(ncw * e_c, self.local_entities, dtype=ent.dtype)
        out[: n * e_c] = ent[lo:lo + n].reshape(-1)
        return out

    def stage_chunks(self, w: int) -> tuple:
        """Window ``w``'s (rating, weight, tile_seg, chunk_entity,
        chunk_count, carry_in, last_seg) host arrays.  Full windows return
        flat VIEWS of the original block arrays (zero-copy — the whole
        point); a ragged trailing window assembles its padded copy here,
        transient to the staging call."""
        ncw, cap, e_c, t = self.statics
        nt = cap // t
        n = int(self.chunk_counts[w])
        lo = int(self.chunk_lo[w])
        s = self.src
        if n == ncw:
            return (
                s["rating"][lo:lo + ncw].reshape(-1),
                s["weight"][lo:lo + ncw].reshape(-1),
                s["tile_seg"][lo:lo + ncw].reshape(-1),
                s["chunk_entity"][lo:lo + ncw].reshape(-1),
                s["chunk_count"][lo:lo + ncw].reshape(-1),
                self.carry_in[w], self.last_seg[w],
            )
        rt = np.zeros(ncw * cap, dtype=np.float32)
        wt = np.zeros(ncw * cap, dtype=np.float32)
        ts = np.full(ncw * nt, e_c, dtype=np.int32)
        ent = np.full(ncw * e_c, self.local_entities, dtype=np.int32)
        cnt = np.ones(ncw * e_c, dtype=s["chunk_count"].dtype)
        rt[: n * cap] = s["rating"][lo:lo + n].reshape(-1)
        wt[: n * cap] = s["weight"][lo:lo + n].reshape(-1)
        ts[: n * nt] = s["tile_seg"][lo:lo + n].reshape(-1)
        ent[: n * e_c] = s["chunk_entity"][lo:lo + n].reshape(-1)
        cnt[: n * e_c] = s["chunk_count"][lo:lo + n].reshape(-1)
        return rt, wt, ts, ent, cnt, self.carry_in[w], self.last_seg[w]


def build_window_plan(blocks, table_rows: int, *,
                      chunks_per_window: int = 4,
                      shard: int = 0) -> WindowPlan:
    """Cut one shard of a stream-mode ``TiledBlocks`` side into windows.

    ``table_rows`` is the FIXED side's padded entity count (the row space
    ``neighbor_idx`` addresses, with ``table_rows`` itself as the virtual
    zero row).  ``chunks_per_window`` is a target: a window grows past it
    when no ``carry_in == 0`` cut exists (a hot entity straddling chunks),
    and every window is padded up to the common maximum with all-trash
    chunks so one static shape serves them all.  ``shard`` selects the
    shard-major slice of sharded blocks (the sharded trainer builds one
    plan per shard; the per-shard chunk scan is exactly what the
    all_gather-exchange resident step runs on that shard).
    """
    if blocks.mode != "stream":
        raise ValueError(
            f"window plans cut the stream-mode chunk scan; these blocks "
            f"are mode={blocks.mode!r} (build with accum_max_entities=0 "
            "to force stream mode — the out-of-core regime's mode; the "
            "ring exchanges' accum blocks go through "
            "build_ring_window_plan)"
        )
    if not 0 <= shard < blocks.num_shards:
        raise ValueError(
            f"shard {shard} outside [0, {blocks.num_shards})"
        )
    if chunks_per_window < 1:
        raise ValueError(
            f"chunks_per_window must be >= 1, got {chunks_per_window}"
        )
    nc, cap, e_c, t = blocks.statics
    nt = cap // t
    n_sh = blocks.num_shards
    nb = _shard_leaf(blocks.neighbor_idx, n_sh, shard).reshape(nc, cap)
    rt = _shard_leaf(blocks.rating, n_sh, shard).reshape(nc, cap)
    wt = _shard_leaf(blocks.weight, n_sh, shard).reshape(nc, cap)
    ts = _shard_leaf(blocks.tile_seg, n_sh, shard).reshape(nc, nt)
    ent = _shard_leaf(blocks.chunk_entity, n_sh, shard).reshape(nc, e_c)
    cnt = _shard_leaf(blocks.chunk_count, n_sh, shard).reshape(nc, e_c)
    cin = _shard_leaf(blocks.carry_in, n_sh, shard).reshape(nc)
    lseg = _shard_leaf(blocks.last_seg, n_sh, shard).reshape(nc)
    local = blocks.local_entities

    # Cut points: a window may start at chunk c only when chunk c does not
    # continue the previous chunk's last entity.
    groups: list[tuple[int, int]] = []
    start = 0
    while start < nc:
        end = min(start + chunks_per_window, nc)
        while end < nc and cin[end] != 0.0:
            end += 1
        groups.append((start, end))
        start = end

    # Floor of 2 chunks per window (1 when the side has one chunk): the
    # reference's floor, kept so the plans stay array-equal to its; the
    # port's trainer runs only a window's real chunks.
    ncw = max(2 if nc > 1 else 1,
              max(end - start for start, end in groups))
    f = int(table_rows)

    # Per-window unique row sets (sorted ascending — locality for the host
    # gather and a canonical rebase).
    row_lists, counts = [], []
    for lo, hi in groups:
        rows_w = _row_set(nb[lo:hi].ravel(), f)
        row_lists.append(rows_w)
        counts.append(rows_w.shape[0])
    window_rows = max(_round_up(max(max(counts), 1), 8), 8)

    w = len(groups)
    rows = np.zeros((w, window_rows), dtype=np.int64)
    nb_w = np.full((w, ncw * cap), window_rows, dtype=np.int32)
    cin_w = np.zeros((w, ncw), dtype=np.float32)
    lseg_w = np.zeros((w, ncw), dtype=np.int32)
    rebase = _Rebase(f)
    for wi, ((lo, hi), rows_w) in enumerate(zip(groups, row_lists)):
        n = hi - lo
        rows[wi, : rows_w.shape[0]] = rows_w
        chunk_nb = nb[lo:hi].ravel()
        # Rebase: real rows → their window position; the virtual zero row
        # (== f) → the window's own virtual zero row (== window_rows).
        nb_w[wi, : n * cap] = rebase(rows_w, chunk_nb, window_rows)
        cin_w[wi, :n] = cin[lo:hi]
        lseg_w[wi, :n] = lseg[lo:hi]

    return WindowPlan(
        rows=rows,
        row_counts=np.asarray(counts, dtype=np.int64),
        chunk_lo=np.asarray([lo for lo, _ in groups], dtype=np.int64),
        chunk_counts=np.asarray([hi - lo for lo, hi in groups],
                                dtype=np.int64),
        neighbor_idx=nb_w, carry_in=cin_w, last_seg=lseg_w,
        statics=(ncw, cap, e_c, t),
        window_rows=window_rows, table_rows=f, local_entities=local,
        src={"rating": rt, "weight": wt, "tile_seg": ts,
             "chunk_entity": ent, "chunk_count": cnt},
    )


@dataclasses.dataclass(frozen=True)
class RingWindowPlan:
    """Ring/hier-ring window plan: one shard's accum-mode chunk scan as
    per-(fixed-table-slice) staged windows.

    The resident ring rotates whole fixed-side BLOCKS and visits each
    slice's chunk range once; windowed execution stages only the block
    rows the slice's chunks actually reference (the "window residual")
    and accumulates the identical per-chunk Grams into the shard's
    persistent [E_local+1, k(, k)] accumulator.  Cuts inside a slice are
    free (the accumulation is chunk-dense, no carry), so windows pad to
    one static shape serves every (slice, window).

    ``rows`` are ABSOLUTE fixed-store rows (slice·H + block-local), so
    the staging gather is one ``HostFactorStore.gather`` and the trainer
    can attribute each staged row to the store shard that owns it (the
    fabric-crossing accounting the bench rows record).  Zero-copy like
    ``WindowPlan``: only the rebased neighbor stream is plan-held."""

    slice_of: np.ndarray      # [NW] int32 fixed-table slice per window
    rows: np.ndarray          # [NW, R] int64 ABSOLUTE store rows
    row_counts: np.ndarray    # [NW]
    chunk_lo: np.ndarray      # [NW] first shard-local chunk
    chunk_counts: np.ndarray  # [NW] real chunks (<= ncw)
    neighbor_idx: np.ndarray  # [NW, ncw·C] int32 rebased (zero row → R)
    statics: tuple            # the blocks' accum statics (NC, C, T, H, Ec)
    window_chunks: int        # ncw (static chunks per staged window)
    window_rows: int          # R
    local_entities: int
    num_slices: int
    src: dict = dataclasses.field(repr=False, default_factory=dict)

    @property
    def num_windows(self) -> int:
        return int(self.rows.shape[0])

    def windows_of_slice(self, t: int) -> range:
        lo = int(np.searchsorted(self.slice_of, t, side="left"))
        hi = int(np.searchsorted(self.slice_of, t, side="right"))
        return range(lo, hi)

    def schedule(self, visits: list[int]) -> list[int]:
        """The window consumption order for one shard's exchange visit
        order (``hier_visit_order``): each visited slice's windows, in
        slice-internal order — exactly the sequence the resident exchange
        delivers blocks in.  The one authority the ring half-step AND the
        staging engine share (``WindowPlan.schedule``'s ring twin)."""
        return [w for t in visits for w in self.windows_of_slice(t)]

    def staged_bytes_per_window(self, rank: int, stage_itemsize: int, *,
                                row_overhead_bytes: int = 0) -> int:
        nc, cap, t, h, e_c = self.statics
        nt = cap // t
        table = int(self.window_rows) * (rank * stage_itemsize
                                         + row_overhead_bytes)
        chunks = (self.window_chunks
                  * (cap * 12 + nt * 4 + e_c * 4))
        return table + chunks

    def plan_held_bytes(self) -> int:
        return (self.slice_of.nbytes + self.rows.nbytes
                + self.row_counts.nbytes + self.chunk_lo.nbytes
                + self.chunk_counts.nbytes + self.neighbor_idx.nbytes)

    def stage_chunks(self, w: int) -> tuple:
        """Window ``w``'s (rating, weight, tile_seg, chunk_entity) host
        arrays — views for full windows, padded assembly for ragged."""
        nc, cap, t, h, e_c = self.statics
        nt = cap // t
        ncw = self.window_chunks
        n = int(self.chunk_counts[w])
        lo = int(self.chunk_lo[w])
        s = self.src
        if n == ncw:
            return (
                s["rating"][lo:lo + ncw].reshape(-1),
                s["weight"][lo:lo + ncw].reshape(-1),
                s["tile_seg"][lo:lo + ncw].reshape(-1),
                s["chunk_entity"][lo:lo + ncw].reshape(-1),
            )
        rt = np.zeros(ncw * cap, dtype=np.float32)
        wt = np.zeros(ncw * cap, dtype=np.float32)
        ts = np.full(ncw * nt, e_c, dtype=np.int32)
        ent = np.full(ncw * e_c, self.local_entities, dtype=np.int32)
        rt[: n * cap] = s["rating"][lo:lo + n].reshape(-1)
        wt[: n * cap] = s["weight"][lo:lo + n].reshape(-1)
        ts[: n * nt] = s["tile_seg"][lo:lo + n].reshape(-1)
        ent[: n * e_c] = s["chunk_entity"][lo:lo + n].reshape(-1)
        return rt, wt, ts, ent


def build_ring_window_plan(blocks, *, shard: int,
                           chunks_per_window: int = 4) -> RingWindowPlan:
    """Cut one shard of ring-built (accum-mode) ``TiledBlocks`` into
    per-slice staged windows.

    Slices are the fixed side's factor shards (``num_slices ==
    num_shards`` for ring builds); a window never spans slices — the
    slice boundary is where the resident ring would rotate to a
    different block.  Neighbor indices are block-local in the source
    arrays; the plan rebases them to the window and records ABSOLUTE
    store rows (slice·H + local) for the staging gather."""
    if blocks.mode != "accum" or not blocks.ring:
        raise ValueError(
            "ring window plans cut ring-built accum-mode tiled blocks "
            f"(mode={blocks.mode!r}, ring={blocks.ring}); build the "
            "dataset with Dataset.from_coo(..., layout='tiled', "
            "ring=True)"
        )
    if not 0 <= shard < blocks.num_shards:
        raise ValueError(
            f"shard {shard} outside [0, {blocks.num_shards})"
        )
    if chunks_per_window < 1:
        raise ValueError(
            f"chunks_per_window must be >= 1, got {chunks_per_window}"
        )
    nc, cap, t, h, e_c = blocks.statics
    nt = cap // t
    n_sh = blocks.num_shards
    n_sl = blocks.num_slices
    nb = _shard_leaf(blocks.neighbor_idx, n_sh, shard).reshape(nc, cap)
    rt = _shard_leaf(blocks.rating, n_sh, shard).reshape(nc, cap)
    wt = _shard_leaf(blocks.weight, n_sh, shard).reshape(nc, cap)
    ts = _shard_leaf(blocks.tile_seg, n_sh, shard).reshape(nc, nt)
    ent = _shard_leaf(blocks.chunk_entity, n_sh, shard).reshape(nc, e_c)
    starts = _shard_leaf(blocks.slice_starts, n_sh, shard)
    local = blocks.local_entities

    groups: list[tuple[int, int, int]] = []  # (slice, lo, hi)
    for sl in range(n_sl):
        lo, hi = int(starts[sl]), int(starts[sl + 1])
        c = lo
        while c < hi:
            end = min(c + chunks_per_window, hi)
            groups.append((sl, c, end))
            c = end
        # An empty slice gets NO windows — the resident ring's chunk loop
        # over it is empty too (fori over an empty range); the trainer's
        # windows_of_slice(t) then yields nothing for it.
    # A shard with no real chunks at all still plans (zero windows): the
    # trainer's final solve runs on the zero accumulators either way,
    # matching the resident ring's empty chunk loops.
    ncw = max((hi - lo for _, lo, hi in groups), default=1)

    row_lists, counts = [], []
    for sl, lo, hi in groups:
        rows_w = _row_set(nb[lo:hi].ravel(), h)
        row_lists.append(rows_w)
        counts.append(rows_w.shape[0])
    window_rows = max(_round_up(max(max(counts, default=1), 1), 8), 8)

    w = len(groups)
    rows = np.zeros((w, window_rows), dtype=np.int64)
    nb_w = np.full((w, ncw * cap), window_rows, dtype=np.int32)
    rebase = _Rebase(h)
    for wi, ((sl, lo, hi), rows_w) in enumerate(zip(groups, row_lists)):
        n = hi - lo
        # Absolute store rows: block-local → slice base + local (pad rows
        # repeat the slice base — gathered but never referenced).
        rows[wi] = sl * h
        rows[wi, : rows_w.shape[0]] = sl * h + rows_w
        if n:
            nb_w[wi, : n * cap] = rebase(rows_w, nb[lo:hi].ravel(),
                                         window_rows)

    return RingWindowPlan(
        slice_of=np.asarray([sl for sl, _, _ in groups], dtype=np.int32),
        rows=rows,
        row_counts=np.asarray(counts, dtype=np.int64),
        chunk_lo=np.asarray([lo for _, lo, _ in groups], dtype=np.int64),
        chunk_counts=np.asarray([hi - lo for _, lo, hi in groups],
                                dtype=np.int64),
        neighbor_idx=nb_w,
        statics=(nc, cap, t, h, e_c),
        window_chunks=ncw, window_rows=window_rows,
        local_entities=local, num_slices=n_sl,
        src={"rating": rt, "weight": wt, "tile_seg": ts,
             "chunk_entity": ent},
    )


@dataclasses.dataclass(frozen=True)
class BucketWindowPlan:
    """Bucketed-layout window plan: one side's width-class
    rectangles cut into staged windows for the implicit out-of-core path.

    A bucket is chunked exactly where the RESIDENT bucketed half-steps
    chunk it (the ``chunk_rows`` hint, which ``chunk_map`` scans), so a
    window groups consecutive resident chunks and its per-chunk batch
    shapes — hence the batched-solve bits — are identical to the
    resident scan's.  Unchunked buckets stage as ONE whole-rectangle
    window (the resident path solves them in one direct call).  Windows
    never span buckets: the width class is the solve shape.

    Row sets are the FIXED-table rows a window's neighbor cells gather
    (unique over ALL cells — padding cells point at row 0 with mask 0,
    whose contribution is exactly zero, so staging their target keeps
    every rebased index in bounds without perturbing a single bit).
    ``entity`` holds each window's ABSOLUTE solve-side entity ids
    (shard·e_local + entity_local; trash rows → ``local_entities``), so
    the hot engine's helpers run with ``shard=0, local=local_entities``
    and the host scatter needs no per-shard rebase.

    Duck-typed to the ``WindowPlan`` surface the staging pipeline and
    ``offload/hot.py`` consume: rows / row_counts / window_rows /
    num_windows / schedule() / chunk_entity_of(w) / stage_chunks(w) /
    staged_bytes_per_window / plan_held_bytes."""

    rows: np.ndarray          # [W, R] int64 fixed-table rows staged per window
    row_counts: np.ndarray    # [W] real rows (<= R; the rest pad row 0)
    bucket_of: np.ndarray     # [W] int32 source bucket per window
    chunk_lo: np.ndarray      # [W] first resident chunk (bucket-local)
    chunk_counts: np.ndarray  # [W] real chunks (<= ncw; the rest all-trash)
    neighbor_idx: tuple       # per-window flat [slots·width] int32 rebased
    entity: tuple             # per-window [slots] int64 ABSOLUTE entity ids
    shapes: tuple             # per-bucket (ncw, chunk, width, whole)
    window_rows: int          # R (static staged-table height)
    table_rows: int           # F (fixed side's padded rows)
    local_entities: int       # solve side's E_pad (trash id)
    # Per-bucket {"rating": [rows, width], "mask": [rows, width]} views of
    # the Bucket arrays — shared memory, never copied here.
    src: tuple = dataclasses.field(repr=False, default_factory=tuple)

    @property
    def num_windows(self) -> int:
        return int(self.rows.shape[0])

    def schedule(self) -> list[int]:
        """Consumption order (bucket-major, chunk order within a bucket —
        the resident layout's own scan order); the one authority the
        staging engine and the half-step share."""
        return list(range(self.num_windows))

    def window_shape(self, w: int) -> tuple:
        """Window ``w``'s static solve shape (ncw, chunk, width, whole)."""
        return self.shapes[int(self.bucket_of[w])]

    def staged_bytes_per_window(self, rank: int, stage_itemsize: int, *,
                                row_overhead_bytes: int = 0) -> int:
        """Worst-case bytes one staged window occupies on device: the
        gathered table rows at the staging dtype plus the widest bucket's
        chunk arrays (nb int32 + rating f32 + mask f32 per cell, plus the
        per-slot entity ids and iALS++'s warm-start row)."""
        table = int(self.window_rows) * (rank * stage_itemsize
                                         + row_overhead_bytes)
        cells = max((ncw * chunk * width
                     for ncw, chunk, width, _ in self.shapes), default=0)
        slots = max((ncw * chunk
                     for ncw, chunk, width, _ in self.shapes), default=0)
        # entity ids (int64) + the staged warm-start row at f32 — the
        # iALS++ upper bound covers plain iALS too.
        return table + cells * 12 + slots * (8 + rank * 4)

    def plan_held_bytes(self) -> int:
        """Host bytes the plan pins (rebased neighbor stream + row sets +
        entity ids + metadata; rating/mask stay the Buckets' own memory)."""
        return (self.rows.nbytes + self.row_counts.nbytes
                + self.bucket_of.nbytes + self.chunk_lo.nbytes
                + self.chunk_counts.nbytes
                + sum(a.nbytes for a in self.neighbor_idx)
                + sum(a.nbytes for a in self.entity))

    def chunk_entity_of(self, w: int) -> np.ndarray:
        """Window ``w``'s [slots] ABSOLUTE solve-entity ids (trash →
        ``local_entities``) — the host scatter's targets and the hot
        engine's partition key."""
        return self.entity[w]

    def stage_chunks(self, w: int) -> tuple:
        """Window ``w``'s (rating, mask) flat host arrays — views for
        full windows, zero-padded assembly for the ragged trailing window
        of a chunked bucket (all-trash pad chunks: mask 0 everywhere, so
        their contribution is exactly zero)."""
        j = int(self.bucket_of[w])
        ncw, chunk, width, _whole = self.shapes[j]
        n = int(self.chunk_counts[w])
        lo = int(self.chunk_lo[w]) * chunk
        s = self.src[j]
        if n == ncw:
            hi = lo + ncw * chunk
            return (s["rating"][lo:hi].reshape(-1),
                    s["mask"][lo:hi].reshape(-1))
        rt = np.zeros(ncw * chunk * width, dtype=np.float32)
        mk = np.zeros(ncw * chunk * width, dtype=np.float32)
        real = n * chunk * width
        rt[:real] = s["rating"][lo:lo + n * chunk].reshape(-1)
        mk[:real] = s["mask"][lo:lo + n * chunk].reshape(-1)
        return rt, mk


def build_bucket_window_plan(blocks, table_rows: int, *,
                             chunks_per_window: int = 4,
                             whole_buckets=()) -> BucketWindowPlan:
    """Cut one side of a ``BucketedBlocks`` into staged windows.

    ``blocks`` is the SOLVE side (its buckets hold the rows being
    updated), ``table_rows`` the FIXED side's padded entity count (the
    row space ``neighbor_idx`` addresses).  Chunked buckets group
    ``chunks_per_window`` consecutive resident chunks per window with a
    floor of 2 (the reference's floor, kept for array-equal plans);
    unchunked buckets stage whole, matching the resident direct solve.
    ``whole_buckets`` (bucket indices) stage whole although chunked: the
    port's trainer passes the classes whose resident walk solves the whole
    class in one batched call (the legacy schedule), so a window's batch
    is the resident one.  One plan covers every shard: rows are
    shard-major, chunk boundaries never straddle shards, and entity ids
    are absolute."""
    if chunks_per_window < 1:
        raise ValueError(
            f"chunks_per_window must be >= 1, got {chunks_per_window}"
        )
    e_local = blocks.local_entities
    e_pad = blocks.padded_entities
    n_sh = blocks.num_shards
    f = int(table_rows)

    groups = []      # (bucket j, chunk_lo, chunk_count)
    shapes = []      # per bucket (ncw, chunk, width, whole)
    src = []
    ent_abs_of = []  # per bucket [rows] int64 absolute entity ids
    for j, b in enumerate(blocks.buckets):
        rows_b, width = b.neighbor_idx.shape
        per_shard = rows_b // n_sh
        sh = np.arange(rows_b, dtype=np.int64) // per_shard
        el = b.entity_local.astype(np.int64)
        ent_abs_of.append(np.where(el < e_local, sh * e_local + el, e_pad))
        src.append({"rating": b.rating, "mask": b.mask})
        if (b.chunk_rows is None or b.chunk_rows >= rows_b
                or j in whole_buckets):
            shapes.append((1, rows_b, width, True))
            groups.append((j, 0, 1))
            continue
        chunk = int(b.chunk_rows)
        nc = rows_b // chunk  # build guarantees chunk | rows_b, nc >= 2
        ncw = max(2, min(chunks_per_window, nc))
        shapes.append((ncw, chunk, width, False))
        c = 0
        while c < nc:
            end = min(c + ncw, nc)
            groups.append((j, c, end - c))
            c = end

    # Per-window unique row sets over ALL neighbor cells (padding cells
    # included — see class docstring), sorted ascending for gather
    # locality and a canonical rebase.
    row_lists, counts = [], []
    for j, lo, n in groups:
        _, chunk, _, _ = shapes[j]
        w_nb = blocks.buckets[j].neighbor_idx[
            lo * chunk:(lo + n) * chunk
        ].ravel()
        rows_w = _row_set(w_nb, f)
        row_lists.append(rows_w)
        counts.append(rows_w.shape[0])
    window_rows = max(_round_up(max(counts, default=1), 8), 8)

    w = len(groups)
    rows = np.zeros((w, window_rows), dtype=np.int64)
    nb_list, ent_list = [], []
    rebase = _Rebase(f)
    for wi, ((j, lo, n), rows_w) in enumerate(zip(groups, row_lists)):
        ncw, chunk, width, _whole = shapes[j]
        rows[wi, : rows_w.shape[0]] = rows_w
        slots = ncw * chunk
        chunk_nb = blocks.buckets[j].neighbor_idx[
            lo * chunk:(lo + n) * chunk
        ].ravel()
        reb = rebase(rows_w, chunk_nb, 0)
        if n == ncw:
            nb_w = reb
            ent_w = ent_abs_of[j][lo * chunk:(lo + ncw) * chunk]
        else:
            # Ragged trailing window: all-trash pad chunks point their
            # neighbor cells at window position 0 (mask 0 — exact zero
            # contribution) and their entities at the trash slot.
            nb_w = np.zeros(slots * width, dtype=np.int32)
            nb_w[: n * chunk * width] = reb
            ent_w = np.full(slots, e_pad, dtype=np.int64)
            ent_w[: n * chunk] = ent_abs_of[j][lo * chunk:(lo + n) * chunk]
        nb_list.append(nb_w)
        ent_list.append(np.ascontiguousarray(ent_w))

    return BucketWindowPlan(
        rows=rows,
        row_counts=np.asarray(counts, dtype=np.int64),
        bucket_of=np.asarray([j for j, _, _ in groups], dtype=np.int32),
        chunk_lo=np.asarray([lo for _, lo, _ in groups], dtype=np.int64),
        chunk_counts=np.asarray([n for _, _, n in groups], dtype=np.int64),
        neighbor_idx=tuple(nb_list),
        entity=tuple(ent_list),
        shapes=tuple(shapes),
        window_rows=window_rows, table_rows=f, local_entities=e_pad,
        src=tuple(src),
    )
