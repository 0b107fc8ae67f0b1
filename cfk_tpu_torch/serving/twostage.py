"""Two-stage clustered retrieval: centroid probe + exact shortlist rescore.

The port of ``cfk_tpu/serving/twostage.py``:

- COARSE stage: the [B, k] batch scored against the [C, k] centroids (the
  quantized view, dequantized as K4 dequantizes a row) with ``torch.matmul``
  and ``torch.topk`` — the JAX package leaves this to XLA, outside Pallas;
- SHORTLIST: the batch union of the selected clusters' rows, as contiguous
  ranges of the cluster-major table, padded to a pow2 multiple of
  ``tile_m`` (host bookkeeping, numpy — bit-identical to the JAX package's);
- RESCORE: ``index_select`` of the shortlist rows and K4 over them, with the
  seen masks remapped to shortlist positions.  The padded width R_pad is
  the table K4 sees and ``row_offset = R_pad − R`` masks exactly the padding
  tail (ids ≥ R_pad); a returned id maps back as ``position = id − offset``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from cfk_tpu_torch.serving.cluster import ClusterIndex
from cfk_tpu_torch.serving.topk_kernel import (
    _pow2_ceil,
    build_seen_tiles,
    serve_compute_dtype,
    topk_scores,
)

# The planner's recall floor for two-stage retrieval, and the probe model
# behind it: the port's copy of ``cfk_tpu/plan/cost.py:281-305``.
SERVE_MIN_RECALL = 0.95
_RECALL_ALPHA = 4.0


def estimated_recall(clusters: int, probe_clusters: int) -> float:
    """Modeled recall@K of probing ``probe_clusters`` of ``clusters``:
    ``1 − exp(−α·probe/√clusters)``; probing every cluster is exact."""
    c = int(clusters)
    if c <= 0:
        return 1.0
    p = min(int(probe_clusters), c)
    if p <= 0:
        return 0.0
    if p >= c:
        return 1.0
    return 1.0 - math.exp(-_RECALL_ALPHA * p / math.sqrt(c))


def default_two_stage_params(num_movies: int, *,
                             min_recall: float | None = None,
                             clusters: int | None = None) -> tuple[int, int]:
    """(clusters, probe_clusters): ~√M clusters (pow2) unless ``clusters``
    is given, and the smallest probe count the recall model accepts at the
    recall floor."""
    floor = SERVE_MIN_RECALL if min_recall is None else float(min_recall)
    m = max(int(num_movies), 1)
    if clusters is None:
        clusters = min(_pow2_ceil(max(int(round(math.sqrt(m))), 1)), m)
    probe = 1
    while probe < clusters and estimated_recall(clusters, probe) < floor:
        probe += 1
    return int(clusters), probe


def coarse(u: torch.Tensor, centroids: torch.Tensor,
           scale: torch.Tensor | None, *, probe: int):
    """(scores, cluster ids) [B, probe]: each user's top-``probe`` clusters,
    scored as K4 scores a row (bf16 operands for a bf16 view, f32 ``code ·
    scale`` for int8)."""
    if centroids.dtype == torch.int8:
        cent = centroids.to(torch.float32) * scale[:, None]
    else:
        cent = centroids.to(torch.float32)
    uf = u.to(serve_compute_dtype(centroids.dtype)).to(torch.float32)
    return torch.topk(uf @ cent.T, probe, dim=1)


def rescore(u: torch.Tensor, indices: torch.Tensor, table: torch.Tensor,
            scale: torch.Tensor | None, seen_tiles, offset: int, *,
            k_top: int, tile_m: int):
    """K4 over the shortlist rows of the cluster-major table."""
    sub = table.index_select(0, indices)
    sub_scale = None if scale is None else scale.index_select(0, indices)
    return topk_scores(u, sub, sub_scale, seen_tiles, k_top=k_top,
                       num_movies=indices.shape[0], tile_m=tile_m,
                       row_offset=offset)


@dataclasses.dataclass
class Shortlist:
    """One batch's candidate set: ``indices [R_pad]`` are cluster-major
    table positions (padding repeats position 0 and is masked), and
    ``global_ids [R]`` maps shortlist position → global movie row."""

    cluster_ids: np.ndarray  # [S] int64 sorted selected clusters
    starts: np.ndarray  # [S] int64 cluster-major range starts
    ends: np.ndarray  # [S] int64 range ends
    local_starts: np.ndarray  # [S] int64 shortlist-local range starts
    indices: np.ndarray  # [R_pad] int32 table positions
    global_ids: np.ndarray  # [R] int64
    rows: int  # R
    rows_padded: int  # R_pad, a pow2 multiple of tile_m

    @property
    def offset(self) -> int:
        """K4's ``row_offset``: masks the padding tail."""
        return self.rows_padded - self.rows


def build_shortlist(index: ClusterIndex, cluster_ids, *, tile_m: int,
                    min_rows: int = 1) -> Shortlist:
    """The batch-union shortlist of the selected clusters, in cluster-major
    order; widened to every cluster when the union holds fewer than
    ``min_rows`` rows, so a short answer never comes from a small union."""
    cids = np.unique(np.asarray(cluster_ids, np.int64))
    if cids.size and (cids[0] < 0 or cids[-1] >= index.num_clusters):
        raise ValueError(
            f"cluster ids out of range [0, {index.num_clusters})"
        )
    starts, ends = index.ranges(cids)
    rows = int((ends - starts).sum())
    if rows < min_rows:
        cids = np.arange(index.num_clusters, dtype=np.int64)
        starts, ends = index.ranges(cids)
        rows = int((ends - starts).sum())
    lens = ends - starts
    local_starts = np.zeros(cids.size, np.int64)
    if cids.size > 1:
        np.cumsum(lens[:-1], out=local_starts[1:])
    positions = (
        np.concatenate([np.arange(s, e, dtype=np.int64)
                        for s, e in zip(starts, ends)])
        if rows else np.zeros(0, np.int64)
    )
    rows_padded = _pow2_ceil(max(rows, 1), tile_m)
    indices = np.zeros(rows_padded, np.int32)
    indices[:rows] = positions
    return Shortlist(
        cluster_ids=cids, starts=starts, ends=ends,
        local_starts=local_starts, indices=indices,
        global_ids=index.perm[positions], rows=rows,
        rows_padded=rows_padded,
    )


def shortlist_seen(index: ClusterIndex, shortlist: Shortlist, seen_movies,
                   seen_indptr):
    """A batch seen-CSR in global movie rows → shortlist positions (entries
    outside the shortlist dropped), re-sorted per user."""
    movies = np.asarray(seen_movies, np.int64)
    indptr = np.asarray(seen_indptr, np.int64)
    if movies.size:
        pos = index.inv_perm[movies]
        j = np.searchsorted(shortlist.starts, pos, side="right") - 1
        j = np.clip(j, 0, max(shortlist.starts.size - 1, 0))
        inside = ((pos >= shortlist.starts[j]) & (pos < shortlist.ends[j])
                  if shortlist.starts.size else np.zeros(pos.shape, bool))
        local = np.where(
            inside, shortlist.local_starts[j] + (pos - shortlist.starts[j]),
            -1,
        )
    else:
        local = np.zeros(0, np.int64)
    out_indptr = np.zeros(indptr.shape[0], np.int64)
    segs = []
    for i in range(indptr.shape[0] - 1):
        seg = local[indptr[i]: indptr[i + 1]]
        seg = np.sort(seg[seg >= 0])
        segs.append(seg)
        out_indptr[i + 1] = out_indptr[i] + seg.size
    out_movies = (np.concatenate(segs).astype(np.int32)
                  if out_indptr[-1] else np.zeros(0, np.int32))
    return out_movies, out_indptr


def shortlist_seen_tiles(index: ClusterIndex, shortlist: Shortlist,
                         seen_movies, seen_indptr, batch: int, *,
                         tile_m: int):
    """[R_pad / tile_m, B, W] exclusion rectangle in shortlist positions."""
    movies_l, indptr_l = shortlist_seen(index, shortlist, seen_movies,
                                        seen_indptr)
    return build_seen_tiles(
        movies_l, indptr_l, np.arange(batch),
        num_movies=max(shortlist.rows, 1), tile_m=tile_m,
        num_tiles=shortlist.rows_padded // tile_m,
    )


def map_shortlist_ids(ids: np.ndarray, shortlist: Shortlist) -> np.ndarray:
    """K4 ids (offset-shifted shortlist positions, −1 empty) → global rows."""
    ids = np.asarray(ids, np.int64)
    pos = np.clip(ids - shortlist.offset, 0, max(shortlist.rows - 1, 0))
    mapped = (shortlist.global_ids[pos] if shortlist.rows
              else np.zeros_like(ids))
    return np.where(ids >= 0, mapped, -1).astype(np.int32)


def recall_at_k(ids: np.ndarray, oracle_ids: np.ndarray) -> float:
    """Mean per-user fraction of the exact oracle's top-K recovered (−1
    slots ignored on both sides)."""
    ids = np.asarray(ids)
    oracle_ids = np.asarray(oracle_ids)
    if ids.shape[0] != oracle_ids.shape[0]:
        raise ValueError(f"batch mismatch {ids.shape} vs {oracle_ids.shape}")
    hits = total = 0
    for got, want in zip(ids, oracle_ids):
        oracle = {int(x) for x in want if x >= 0}
        if not oracle:
            continue
        hits += len(oracle & {int(x) for x in got if x >= 0})
        total += len(oracle)
    return hits / total if total else 1.0
