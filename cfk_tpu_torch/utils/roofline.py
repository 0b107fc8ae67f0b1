"""Byte and operation models: one top-K serving batch, and the bucketed
layout's gathered rows.

The port's copy of ``cfk_tpu/utils/roofline.py``'s serving cost
(``serve_batch_cost`` with ``table_gather_bytes_per_row`` and
``expected_shortlist_rows``) and of ``bucketed_gather_rows``, with the
H100's published peaks as the bounds' defaults: 3.35 TB/s of HBM and
67 TFLOP/s of FP32 outside the tensor cores (TF32 stays off).
"""

from __future__ import annotations

import dataclasses

from cfk_tpu_torch.ops.quant import resolve_table_dtype, table_itemsize

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS_PER_S = 67e12


def table_gather_bytes_per_row(rank: int, table_dtype: str | None,
                               factor_bytes: int = 4) -> float:
    """Bytes one table row moves: k cells at the table itemsize (never more
    than the storage's), plus the int8 scheme's f32 scale per row."""
    per_row = rank * min(table_itemsize(table_dtype), factor_bytes)
    if resolve_table_dtype(table_dtype) == "int8":
        per_row += 4
    return float(per_row)


def bucketed_gather_rows(movie_blocks, user_blocks) -> float:
    """Gathered rows of one bucketed iteration: every padded cell of every
    width class of both halves fetches a row (a padding slot is charged
    like any other), so the count is Σ rows·width, not 2·nnz."""
    return float(movie_blocks.padded_cells + user_blocks.padded_cells)


@dataclasses.dataclass(frozen=True)
class ServeBatchCost:
    """Model cost of one [batch, k_top] scoring batch: every batch reads the
    scanned rows once (no [B, M] score matrix is charged: none exists),
    the [B, k] batch in and the [B, K] selection out."""

    model_flops: float  # 2·B·rows·k score multiply-adds
    hbm_bytes: float

    def flops_bound_s(self, peak=H100_FP32_FLOPS_PER_S) -> float:
        return self.model_flops / peak

    def bytes_bound_s(self, bandwidth=H100_HBM_BYTES_PER_S) -> float:
        return self.hbm_bytes / bandwidth

    def batch_bound_s(self, peak=H100_FP32_FLOPS_PER_S,
                      bandwidth=H100_HBM_BYTES_PER_S) -> float:
        return max(self.flops_bound_s(peak), self.bytes_bound_s(bandwidth))


def expected_shortlist_rows(num_movies: int, batch: int, clusters: int,
                            probe_clusters: int) -> float:
    """Expected batch-union rows of the two-stage path under independent
    probes: ``M · (1 − (1 − probe/clusters)^batch)``."""
    c = max(int(clusters), 1)
    p = min(max(int(probe_clusters), 1), c)
    return float(num_movies) * (1.0 - (1.0 - p / c) ** max(int(batch), 1))


def serve_batch_cost(num_movies: int, rank: int, batch: int, k_top: int,
                     *, table_dtype: str | None = None,
                     m_pad: int | None = None,
                     serve_mode: str = "exact",
                     clusters: int = 0, probe_clusters: int = 0,
                     shortlist_rows: float | None = None) -> ServeBatchCost:
    """Model cost of one top-K batch.

    Exact mode scans ``m_pad`` rows (padding is read too) at the table
    dtype's row bytes.  ``serve_mode="two_stage"`` scans the [clusters, k]
    centroids plus the shortlist rows (measured when ``shortlist_rows`` is
    given, else the expected batch union) at row bytes + 4 B of gather
    index each.
    """
    row_bytes = table_gather_bytes_per_row(rank, table_dtype)
    io_bytes = batch * rank * 4.0 + batch * k_top * 8.0
    if serve_mode == "two_stage":
        if clusters <= 0:
            raise ValueError("two_stage cost needs clusters >= 1")
        sl_rows = (float(shortlist_rows) if shortlist_rows is not None
                   else expected_shortlist_rows(num_movies, batch, clusters,
                                                probe_clusters))
        return ServeBatchCost(
            model_flops=2.0 * batch * (clusters + sl_rows) * rank,
            hbm_bytes=(clusters * row_bytes + sl_rows * (row_bytes + 4.0)
                       + io_bytes),
        )
    rows = float(m_pad if m_pad is not None else num_movies)
    return ServeBatchCost(model_flops=2.0 * batch * rows * rank,
                          hbm_bytes=rows * row_bytes + io_bytes)
