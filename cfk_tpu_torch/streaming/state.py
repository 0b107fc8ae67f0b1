"""Deduplicated per-user rating state: the idempotency layer of fold-in.

The port's copy of ``cfk_tpu/streaming/state.py``, equal to it on the
same inputs: the same CSR (built here by the counting sort
``data.blocks.group_by_dense``, which yields numpy's stable argsort order),
the same per-cell semantics as the reference's per-row dict (a base user's
duplicate (user, movie) pairs collapse to the last one — fold-in counts a
cell once, unlike the trainer), the same new-user rows.  ``neighbors``
merges base, delta and overlay with one stable sort instead of a dict walk,
and ``stage`` resolves a batch's ids in one vectorized search; their
outputs equal the reference's bit for bit.  The base CSR is the dataset's
``user_csr``, built on first use and shared, read-only, by every state
over that dataset.

The fold-in solve is stateless per user — it re-derives a touched user's
factor row from that user's COMPLETE current ratings against the fixed
movie factors — so applying the same logical update twice, or applying two
updates to the same cell in either order, must converge to the same state.
``StreamState`` provides exactly that: the merge of the base dataset's
ratings and every applied ``(user, movie, rating, seq)`` upsert, with
last-seq-wins per (user, movie) cell (equal seq = a retried append,
dropped).

Nothing here is persisted: the state is a deterministic function of (base
dataset, the updates-log prefix below the committed cursor), so crash
recovery rebuilds it by replaying the log — the factors + cursor commit
(``cfk_tpu_torch.streaming.session``) is the only durable artifact.

Application is TRANSACTIONAL: ``stage()`` computes the post-batch view
without mutating anything, the session solves and probes against it, and
only a healthy solve ``commit()``s — a poisoned micro-batch is discarded
wholesale, leaving both the served factors and the state they were solved
from untouched.

Base ratings carry seq −1 (every streamed update outranks the batch file);
new users grow the user table in first-appearance order within the
canonical batch order, which makes row assignment replay-deterministic.
Updates naming a movie the model has never seen have no factor column to
solve against — they are counted and dropped (``unknown_movie``), to be
picked up when the operator retrains from base + log.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO
from cfk_tpu_torch.transport.serdes import RatingUpdate

_BASE_SEQ = -1


def _lookup(sorted_ids: np.ndarray, raw: np.ndarray) -> np.ndarray:
    """Dense rows of ``raw`` in the ascending ``sorted_ids``, −1 where
    absent (``movie_row``/``user_row``'s search, over a batch at once)."""
    idx = np.searchsorted(sorted_ids, raw)
    hit = idx < sorted_ids.shape[0]
    hit[hit] = sorted_ids[idx[hit]] == raw[hit]
    return np.where(hit, idx, -1)


@dataclasses.dataclass
class ApplyStats:
    """What one batch application did — chaos tests assert these fired."""

    fresh: int = 0          # state-changing upserts applied
    stale: int = 0          # outranked by an already-applied seq (dup/reorder)
    unknown_movie: int = 0  # no factor column for this movie — dropped
    new_users: int = 0      # rows grown for first-seen users


@dataclasses.dataclass(frozen=True)
class PendingApply:
    """A staged (not yet committed) batch application."""

    touched_rows: tuple[int, ...]          # sorted dense user rows to re-solve
    new_user_raw: tuple[int, ...]          # raw ids of rows grown, in order
    cell_writes: dict                      # row -> {movie_row: (rating, seq)}
    stats: ApplyStats


class StreamState:
    """Merged base + streamed rating state, queryable per user row."""

    def __init__(self, dataset) -> None:
        self._movie_raw = dataset.movie_map.raw_ids
        self.num_movies = dataset.movie_map.num_entities
        self._base_user_raw = dataset.user_map.raw_ids
        # Per-user CSR over the base ratings (the dataset's, read-only):
        # streamed deltas overlay it per touched user.
        (self._base_movies, self._base_ratings,
         self._base_indptr) = dataset.user_csr
        # Streamed overlay: row -> {movie_row: (rating, seq)}; rows past the
        # base user count are streamed-in new users.
        self._delta: dict[int, dict[int, tuple[float, int]]] = {}
        self._new_user_raw: list[int] = []
        self._new_user_rows: dict[int, int] = {}
        self.applied_seq_high = _BASE_SEQ

    # -- identity ------------------------------------------------------------

    @property
    def num_base_users(self) -> int:
        return int(self._base_user_raw.shape[0])

    @property
    def num_users(self) -> int:
        return self.num_base_users + len(self._new_user_raw)

    def user_row(self, raw: int) -> int | None:
        """Dense row of a raw user id, or None if never seen."""
        got = self._new_user_rows.get(int(raw))
        if got is not None:
            return got
        i = int(np.searchsorted(self._base_user_raw, raw))
        if i < self.num_base_users and int(self._base_user_raw[i]) == int(raw):
            return i
        return None

    def user_raw_ids(self) -> np.ndarray:
        """Raw ids in row order (base ascending, then streamed new users)."""
        return np.concatenate([
            self._base_user_raw,
            np.asarray(self._new_user_raw, np.int64),
        ]) if self._new_user_raw else self._base_user_raw

    def movie_row(self, raw: int) -> int | None:
        i = int(np.searchsorted(self._movie_raw, raw))
        if i < self.num_movies and int(self._movie_raw[i]) == int(raw):
            return i
        return None

    # -- queries -------------------------------------------------------------

    def neighbors(self, row: int, overlay: dict | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
        """(movie rows int32 ascending, ratings f32) for one user row.

        Sorted by movie row — the canonical neighbor order, so the solve
        input (and therefore its bits) depends only on the state, never on
        arrival order.
        """
        movies, ratings = [], []
        if row < self.num_base_users:
            lo, hi = self._base_indptr[row], self._base_indptr[row + 1]
            movies.append(self._base_movies[lo:hi])
            ratings.append(self._base_ratings[lo:hi])
        for cells in (self._delta.get(row), overlay):
            if cells:
                movies.append(np.fromiter(cells.keys(), np.int32,
                                          len(cells)))
                ratings.append(np.fromiter((v[0] for v in cells.values()),
                                           np.float32, len(cells)))
        if not movies or not sum(m.shape[0] for m in movies):
            return (np.zeros(0, np.int32), np.zeros(0, np.float32))
        mv = np.concatenate(movies)
        rt = np.concatenate(ratings)
        # Later entries win per movie (base duplicates, then the delta,
        # then the overlay — the reference's dict-update order): the
        # stable sort keeps arrival order within a movie, so each group's
        # last entry is the one the dict would hold.
        order = np.argsort(mv, kind="stable")
        ms = mv[order]
        last = np.ones(ms.shape[0], bool)
        last[:-1] = ms[1:] != ms[:-1]
        sel = order[last]
        return mv[sel], rt[sel]

    def to_coo(self):
        """The merged rating state as a raw-id COO (for warm full retrains:
        base + every committed upsert, exactly what the factors model).

        Rows the stream never touched pass through vectorized (deduped to
        last-occurrence per cell, matching the reference's dict semantics for
        repeated base observations); only delta rows pay the per-row merge
        — O(touched) Python work, not O(all users), so ML-25M-scale exits
        and periodic retrains don't stall on an interpreter loop."""
        raw_users = self.user_raw_ids()
        counts = np.diff(self._base_indptr)
        base_rows = np.repeat(
            np.arange(self.num_base_users, dtype=np.int64), counts
        )
        # last-occurrence dedup per (row, movie) cell: stable sort keeps
        # original order within equal keys, so each group's tail is the
        # entry the reference's dict would have kept
        key = base_rows * np.int64(self.num_movies) + self._base_movies
        order = np.argsort(key, kind="stable")
        ks = key[order]
        last = np.ones(ks.shape[0], bool)
        last[:-1] = ks[1:] != ks[:-1]
        sel = order[last]
        untouched = ~np.isin(base_rows[sel],
                             np.fromiter(self._delta, np.int64,
                                         len(self._delta)))
        sel = sel[untouched]
        users = [self._base_user_raw[base_rows[sel]]]
        movies = [self._movie_raw[self._base_movies[sel]].astype(np.int64)]
        ratings = [self._base_ratings[sel]]
        for row in sorted(self._delta):
            mv, rt = self.neighbors(row)
            users.append(np.full(mv.shape[0], raw_users[row], np.int64))
            movies.append(self._movie_raw[mv].astype(np.int64))
            ratings.append(rt)
        return RatingsCOO(
            movie_raw=np.concatenate(movies),
            user_raw=np.concatenate(users),
            rating=np.concatenate(ratings).astype(np.float32),
        )

    # -- transactional application -------------------------------------------

    def stage(self, updates: tuple[RatingUpdate, ...] | list[RatingUpdate]
              ) -> PendingApply:
        """Dedup a batch against the applied state WITHOUT mutating it.

        Updates must already be in canonical order (the consumer's
        (partition, offset) order).  Within the batch the same cell may be
        written repeatedly — the highest seq wins; against the applied
        state, only upserts whose seq outranks the cell's current seq are
        fresh.  A user whose batch records are ALL stale is not touched
        (no re-solve — the idempotent no-op for retried appends).

        The applied view of a cell is the delta's (rating, seq), else the
        base's seq −1 when the base rated it — the lookups of the
        reference's per-row dict, without building it: the batch's raw
        ids are resolved in one vectorized search, and a base row's rated
        movies become a set once per batch.
        """
        stats = ApplyStats()
        writes: dict[int, dict[int, tuple[float, int]]] = {}
        base_sets: dict[int, set] = {}
        new_raw: list[int] = []
        new_rows: dict[int, int] = {}
        next_row = self.num_users
        n = len(updates)
        mv_rows = _lookup(self._movie_raw,
                          np.fromiter((u.movie for u in updates), np.int64, n))
        base_rows = _lookup(self._base_user_raw,
                            np.fromiter((u.user for u in updates), np.int64,
                                        n))
        for i, upd in enumerate(updates):
            mv = int(mv_rows[i])
            if mv < 0:
                stats.unknown_movie += 1
                continue
            raw = int(upd.user)
            row = self._new_user_rows.get(raw)
            if row is None and base_rows[i] >= 0:
                row = int(base_rows[i])
            if row is None:
                row = new_rows.get(raw)
            if row is None:
                row = next_row
                new_rows[raw] = row
                new_raw.append(raw)
                next_row += 1
                stats.new_users += 1
            w = writes.get(row)
            current = w.get(mv) if w else None
            if current is None:
                d = self._delta.get(row)
                current = d.get(mv) if d else None
            if current is None and row < self.num_base_users:
                rated = base_sets.get(row)
                if rated is None:
                    lo, hi = self._base_indptr[row], self._base_indptr[row + 1]
                    rated = base_sets[row] = set(
                        self._base_movies[lo:hi].tolist())
                if mv in rated:
                    current = (None, _BASE_SEQ)  # only the seq is read
            if current is not None and upd.seq <= current[1]:
                stats.stale += 1
                continue
            writes.setdefault(row, {})[mv] = (float(upd.rating), int(upd.seq))
            stats.fresh += 1
        return PendingApply(
            touched_rows=tuple(sorted(writes)),
            new_user_raw=tuple(new_raw),
            cell_writes=writes,
            stats=stats,
        )

    def commit(self, pending: PendingApply) -> None:
        """Fold a staged batch into the applied state."""
        for raw in pending.new_user_raw:
            self._new_user_rows[raw] = self.num_users
            self._new_user_raw.append(raw)
        for row, cells in pending.cell_writes.items():
            self._delta.setdefault(row, {}).update(cells)
            self.applied_seq_high = max(
                self.applied_seq_high, max(s for _, s in cells.values())
            )
