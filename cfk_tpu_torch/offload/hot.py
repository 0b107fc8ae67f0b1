"""Hot-row selection: the knee of a reference-count coverage curve.

The port's copy of ``coverage_curve``, ``knee_hot_rows`` and
``select_hot_rows`` from ``cfk_tpu/offload/hot.py`` (numpy only, bit-equal
to the reference's on the same counts).  The serving fleet's
``DeltaPublisher`` uses them to split each commit's rows into the ones that
ship eagerly (factors in the frame) and the long tail that ships lazily.
"""

from __future__ import annotations

import numpy as np


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
