"""Clustered item-table index for two-stage retrieval.

The port's copy of ``cfk_tpu/serving/cluster.py`` (host-side numpy, so a
seed gives the identical index in both packages): a seeded k-means over the
item factor rows with a fixed iteration count, and the table stored
CLUSTER-MAJOR — rows of one cluster contiguous, ascending global row within
a cluster (a stable sort), which is what makes the rescore's tie order
reproducible.  Empty clusters re-seed at the highest-norm rows.

The engine rebuilds the index on every full table swap; per-row movie
deltas update rows in place at their existing cluster-major position and
are counted as stale.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def kmeans_item_clusters(factors: np.ndarray, clusters: int, *, seed: int = 0,
                         iters: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """(centroids [C, k] f32, assign [M] int32): Lloyd iterations with the
    assignment ``argmax(x·cᵀ − ½|c|²)`` (one matrix product)."""
    x = np.ascontiguousarray(np.asarray(factors, np.float32))
    if x.ndim != 2:
        raise ValueError(f"factors must be [M, k], got shape {x.shape}")
    m = x.shape[0]
    c = int(clusters)
    if not 1 <= c <= m:
        raise ValueError(f"clusters must be in [1, {m}], got {c}")
    rng = np.random.default_rng(seed)
    init = np.sort(rng.choice(m, size=c, replace=False))
    cent = x[init].copy()
    norms = (x * x).sum(axis=1)
    by_norm = np.argsort(-norms, kind="stable")
    for _ in range(max(int(iters), 1)):
        scores = x @ cent.T - 0.5 * (cent * cent).sum(axis=1)
        assign = np.argmax(scores, axis=1).astype(np.int32)
        sums = np.zeros((c, x.shape[1]), np.float64)
        np.add.at(sums, assign, x)
        counts = np.bincount(assign, minlength=c).astype(np.float64)
        cent = (sums / np.maximum(counts, 1.0)[:, None]).astype(np.float32)
        empty = np.flatnonzero(counts == 0)
        if empty.size:
            cent[empty] = x[by_norm[: empty.size]]
    scores = x @ cent.T - 0.5 * (cent * cent).sum(axis=1)
    assign = np.argmax(scores, axis=1).astype(np.int32)
    return cent, assign


@dataclasses.dataclass
class ClusterIndex:
    """The cluster-major view of one item-table snapshot: ``perm[pos] =
    global row``, ``inv_perm`` its inverse, cluster c owns positions
    ``[offsets[c], offsets[c+1])``."""

    centroids: np.ndarray  # [C, k] f32
    assign: np.ndarray  # [M] int32 global row -> cluster
    perm: np.ndarray  # [M] int64 cluster-major position -> global row
    inv_perm: np.ndarray  # [M] int64 global row -> cluster-major position
    offsets: np.ndarray  # [C+1] int64 cluster row ranges
    seed: int
    stale_rows: int = 0  # in-place delta rows applied since the build

    @property
    def num_clusters(self) -> int:
        return int(self.centroids.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self.perm.shape[0])

    @property
    def stale_fraction(self) -> float:
        return self.stale_rows / max(self.num_rows, 1)

    def positions_of(self, rows) -> np.ndarray:
        """Cluster-major positions of global rows."""
        return self.inv_perm[np.asarray(rows, np.int64)]

    def note_stale(self, n_rows: int) -> int:
        self.stale_rows += int(n_rows)
        return self.stale_rows

    def ranges(self, cluster_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(starts, ends) cluster-major row ranges of the given clusters."""
        cids = np.asarray(cluster_ids, np.int64)
        return self.offsets[cids], self.offsets[cids + 1]

    def quick_check(self) -> str | None:
        """Per-batch health probe (O(C·k)): why the index must not be
        served from, or None."""
        if not np.isfinite(self.centroids).all():
            return "non-finite centroid values"
        if self.offsets.shape[0] != self.num_clusters + 1:
            return "offsets length != clusters + 1"
        if int(self.offsets[0]) != 0 or int(self.offsets[-1]) != self.num_rows:
            return "offsets do not span the table rows"
        if np.any(np.diff(self.offsets) < 0):
            return "offsets not monotone"
        return None


def build_cluster_index(movie_factors: np.ndarray, clusters: int, *,
                        seed: int = 0, iters: int = 8) -> ClusterIndex:
    """Cluster the item factors and derive the cluster-major layout."""
    centroids, assign = kmeans_item_clusters(movie_factors, clusters,
                                             seed=seed, iters=iters)
    perm = np.argsort(assign, kind="stable").astype(np.int64)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.shape[0], dtype=np.int64)
    counts = np.bincount(assign, minlength=int(clusters)).astype(np.int64)
    offsets = np.zeros(int(clusters) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return ClusterIndex(centroids=centroids, assign=assign, perm=perm,
                        inv_perm=inv_perm, offsets=offsets, seed=int(seed))
