"""Hot-row selection and the skew-aware hot-row device cache.

The port of ``cfk_tpu/offload/hot.py`` (numpy only, bit-equal to the
reference's on the same counts and plans).  ``coverage_curve``,
``knee_hot_rows`` and ``select_hot_rows`` also serve the serving fleet's
``DeltaPublisher`` (which rows of a commit ship eagerly).

For the out-of-core tier (``offload.windowed``) two reuse levers are
decided at window-plan build time from the plans' own per-window row sets:

- the hot partition: the top-f fixed-table rows by cross-window reference
  count stay device-resident for the whole run, at the staging dtype (int8
  rows keep their per-row scales beside them).  Each window's rebased
  index map splits into a hot half (copied on the device from the
  partition) and a cold half (staged).  Solved hot rows scatter back into
  the partition on the device; the host store stays ground truth.
- delta staging: the schedules fix the consumption order, so each window's
  cold rows split again into the rows its predecessor window already
  staged (copied device to device out of the previous window table) and
  the fresh delta that crosses PCIe.

Every row of an assembled window table is a copy of bytes identical to
what full staging would have produced, so the hot cache on or off gives
the same factors, bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def _pow2_bucket(n: int, lo: int = 8) -> int:
    """Pad a delta row count to its pow2 bucket (floor ``lo``): the
    staged-delta arrays take a handful of static shapes, and pow2
    bucketing bounds their count at log2(window_rows) while keeping
    the padded transfer ≤ 2× the real delta."""
    n = max(int(n), 1)
    b = lo
    while b < n:
        b <<= 1
    return b

def plan_row_sets(plan_obj):
    """Iterate one plan's real per-window row sets (absolute store rows,
    sorted ascending — exactly what the staging gather reads)."""
    for w in range(plan_obj.num_windows):
        c = int(plan_obj.row_counts[w])
        yield w, np.asarray(plan_obj.rows[w, :c], dtype=np.int64)

def reference_counts(plans, table_rows: int) -> np.ndarray:
    """Per fixed-table row: how many (shard, window) row sets reference
    it across ``plans`` (one side's per-shard plans).  THE classification
    signal: a row's count is exactly the number of stagings the hot
    partition saves per half-iteration, so top-by-count is optimal for
    the staged-byte objective (before delta reuse)."""
    counts = np.zeros(int(table_rows), dtype=np.int64)
    for p in plans:
        for _, rows_w in plan_row_sets(p):
            counts[rows_w] += 1
    return counts


def coverage_curve(counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows ordered hottest-first, cumulative reference coverage).

    ``coverage[i]`` is the fraction of all references covered by the first
    ``i+1`` ordered rows.  Deterministic: ties break toward the lower row id
    (stable sort on -count).  Rows with zero references are excluded."""
    counts = np.asarray(counts, dtype=np.int64)
    referenced = np.nonzero(counts > 0)[0]
    order = referenced[np.argsort(-counts[referenced], kind="stable")]
    total = counts[order].sum()
    if total == 0:
        return order, np.zeros(0, dtype=np.float64)
    return order, np.cumsum(counts[order]) / float(total)


def knee_hot_rows(counts: np.ndarray) -> int:
    """The coverage curve's knee: the f maximizing
    ``coverage(f) − f / F_referenced`` (the point farthest above the
    diagonal).  On power-law counts it lands near the top tenth of the rows;
    on uniform counts the curve is the diagonal and the knee is 0."""
    order, cov = coverage_curve(counts)
    if order.size == 0:
        return 0
    gain = cov - (np.arange(1, order.size + 1) / float(order.size))
    best = int(np.argmax(gain))
    if gain[best] <= 0.0:
        return 0
    return best + 1


def select_hot_rows(counts: np.ndarray, f: int) -> np.ndarray:
    """The top-``f`` referenced rows by count, sorted ascending."""
    order, _ = coverage_curve(counts)
    f = max(0, min(int(f), order.size))
    return np.sort(order[:f])


def _membership(sorted_rows: np.ndarray, query: np.ndarray,
                ) -> tuple[np.ndarray, np.ndarray]:
    """(insertion positions, membership mask) of ``query`` against a
    sorted row set — the one searchsorted-membership idiom every split
    here uses (safe on empty sets)."""
    pos = np.searchsorted(sorted_rows, query)
    if sorted_rows.size == 0 or query.size == 0:
        return pos, np.zeros(query.shape, dtype=bool)
    pos_c = np.minimum(pos, sorted_rows.size - 1)
    return pos, (pos < sorted_rows.size) & (sorted_rows[pos_c] == query)


@dataclasses.dataclass(frozen=True)
class HotWindowMap:
    """One plan's per-window hot/keep/delta split, in SCHEDULE order.

    For each window ``w`` (keys are window ids — each appears exactly
    once in a schedule, so the predecessor relation is a function of
    ``w``):

    - ``hot_dst[w]`` / ``hot_src[w]``: window-table positions filled from
      the device hot partition (src indexes the partition);
    - ``keep_dst[w]`` / ``keep_src[w]``: positions copied device-to-
      device out of the PREDECESSOR window's assembled table (src is the
      row's position there) — the delta-skipped rows;
    - ``delta_rows[w]`` / ``delta_dst[w]``: the cold residual actually
      staged over PCIe (sorted ascending, like full staging).

    ``hot_pad`` / ``keep_pad`` are the static index-array widths (one
    shape per plan); delta widths bucket to pow2 (``_pow2_bucket``).
    Scatter pads use OUT-OF-BOUNDS destinations (window_rows for the
    table, dropped by the assembly), so no trash
    slot is materialized."""

    hot_dst: dict
    hot_src: dict
    keep_dst: dict
    keep_src: dict
    delta_rows: dict
    delta_dst: dict
    prev_of: dict        # window -> predecessor window id (or -1)
    hot_pad: int
    keep_pad: int
    window_rows: int
    # Slot accounting (the bench/telemetry columns).
    slots_total: int
    slots_hot: int
    slots_kept: int
    slots_delta: int

    def delta_bucket(self, w: int) -> int:
        return _pow2_bucket(len(self.delta_rows[w]))


def build_hot_map(plan_obj, schedule, hot_rows: np.ndarray,
                  ) -> HotWindowMap:
    """Split one plan's windows against a sorted-ascending hot row set,
    walking ``schedule`` (the consumption order the half-step commits —
    the SAME authority the staging engine serves windows in, which is
    what makes the predecessor relation static)."""
    hot_rows = np.asarray(hot_rows, dtype=np.int64)
    hd, hs, kd, ks, dr, dd, prev_of = {}, {}, {}, {}, {}, {}, {}
    s_tot = s_hot = s_keep = s_delta = 0
    prev = -1
    for w in schedule:
        c = int(plan_obj.row_counts[w])
        rows_w = np.asarray(plan_obj.rows[w, :c], dtype=np.int64)
        pos, is_hot = _membership(hot_rows, rows_w)
        hd[w] = np.nonzero(is_hot)[0].astype(np.int32)
        hs[w] = pos[is_hot].astype(np.int32)
        cold_dst = np.nonzero(~is_hot)[0].astype(np.int32)
        cold_rows = rows_w[~is_hot]
        if prev >= 0:
            pc = int(plan_obj.row_counts[prev])
            prows = np.asarray(plan_obj.rows[prev, :pc], dtype=np.int64)
            ppos, shared = _membership(prows, cold_rows)
        else:
            ppos = np.zeros(cold_rows.shape, dtype=np.int64)
            shared = np.zeros(cold_rows.shape, dtype=bool)
        kd[w] = cold_dst[shared]
        ks[w] = ppos[shared].astype(np.int32)
        dd[w] = cold_dst[~shared]
        dr[w] = cold_rows[~shared]
        prev_of[w] = prev
        prev = w
        s_tot += c
        s_hot += int(hd[w].size)
        s_keep += int(kd[w].size)
        s_delta += int(dd[w].size)
    return HotWindowMap(
        hot_dst=hd, hot_src=hs, keep_dst=kd, keep_src=ks,
        delta_rows=dr, delta_dst=dd, prev_of=prev_of,
        hot_pad=max([v.size for v in hd.values()], default=0),
        keep_pad=max([v.size for v in kd.values()], default=0),
        window_rows=int(plan_obj.window_rows),
        slots_total=s_tot, slots_hot=s_hot, slots_kept=s_keep,
        slots_delta=s_delta,
    )


def solved_rows_of(plan_obj, shard: int, local: int) -> np.ndarray:
    """The ABSOLUTE solve-side rows one shard's plan finalizes (every
    entity with interactions on the shard): ``shard·local + entity`` over
    the windows' real ``chunk_entity`` slots.  Used to (a) verify every
    hot row of a side is re-solved each half (so the in-place device
    scatter-back can never go stale vs the host master) and (b) build the
    per-window scatter-back maps."""
    ents = []
    for w in range(plan_obj.num_windows):
        if hasattr(plan_obj, "chunk_entity_of"):
            e = plan_obj.chunk_entity_of(w)
        else:  # RingWindowPlan stages entities per chunk view
            e = plan_obj.stage_chunks(w)[3]
        e = np.asarray(e, dtype=np.int64)
        ents.append(e[e < local])
    if not ents:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.concatenate(ents)) + shard * local


def scatter_back_maps(plan_obj, shard: int, local: int,
                      hot_rows: np.ndarray) -> dict:
    """Per-window (src, dst) index pairs for the SOLVE side's in-place
    device scatter-back (stream mode): ``src`` positions into the
    window's solved ``xs`` ([ncw·Ec] finalization slots, LAST occurrence
    per entity — exactly the host scatter's last-write-wins), ``dst``
    positions into the solve side's hot partition.  Windows with no hot
    solves map to empty pairs.  Pads use dst == len(hot_rows) (OOB →
    dropped)."""
    hot_rows = np.asarray(hot_rows, dtype=np.int64)
    out = {}
    for w in range(plan_obj.num_windows):
        ent = np.asarray(plan_obj.chunk_entity_of(w), dtype=np.int64)
        # Last occurrence per entity (reversed unique keeps the LAST
        # index in the original order — the host scatter's winner).
        rev = ent[::-1]
        uniq, first_rev = np.unique(rev, return_index=True)
        last = ent.size - 1 - first_rev
        keep = uniq < local
        uniq, last = uniq[keep], last[keep]
        absolute = uniq + shard * local
        pos, m = _membership(hot_rows, absolute)
        out[w] = (last[m].astype(np.int32), pos[m].astype(np.int32))
    return out


def ring_scatter_back(shard: int, local: int, hot_rows: np.ndarray,
                      ) -> tuple[np.ndarray, np.ndarray]:
    """(src, dst) for the ring modes' once-per-shard scatter-back: the
    hot solve rows this shard owns, as (shard-local row, partition
    position) pairs — applied to the end-of-half solve output before it
    leaves the device."""
    hot_rows = np.asarray(hot_rows, dtype=np.int64)
    lo, hi = shard * local, (shard + 1) * local
    m = (hot_rows >= lo) & (hot_rows < hi)
    return ((hot_rows[m] - lo).astype(np.int32),
            np.nonzero(m)[0].astype(np.int32))
