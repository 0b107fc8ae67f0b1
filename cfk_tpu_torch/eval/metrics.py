"""MSE / RMSE evaluation (the port of ``cfk_tpu/eval/metrics.py``).

Mean squared error over the observed rating cells only, as the reference's
offline evaluator computes it (``scripts/calculate_mse.py:78-91``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cfk_tpu_torch.data.blocks import Dataset


def mse_rmse(
    predictions: np.ndarray,  # [num_users, num_movies]
    user_dense: np.ndarray,  # [nnz] dense user indices
    movie_dense: np.ndarray,  # [nnz] dense movie indices
    rating: np.ndarray,  # [nnz]
) -> tuple[float, float]:
    """MSE/RMSE over observed ratings of a dense prediction matrix."""
    pred = predictions[user_dense, movie_dense]
    se = float(np.sum((rating.astype(np.float64) - pred.astype(np.float64)) ** 2))
    mse = se / rating.shape[0]
    return mse, math.sqrt(mse)


def mse_rmse_from_blocks(predictions: np.ndarray,
                         dataset: Dataset) -> tuple[float, float]:
    return mse_rmse(
        predictions,
        dataset.coo_dense.user_raw,
        dataset.coo_dense.movie_raw,
        dataset.coo_dense.rating,
    )


def mse_rmse_from_model(model, dataset: Dataset,
                        chunk: int = 1 << 20) -> tuple[float, float]:
    """MSE/RMSE straight from the factors on their device, never
    materializing P: per-cell dot products Σ_k U[u,k]·M[m,k] in float64,
    streamed in ``chunk``-cell pieces (works at full-Netflix scale)."""
    u, m = model.user_factors, model.movie_factors
    dev = u.device
    d = dataset.coo_dense
    se = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, d.rating.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        ud = torch.as_tensor(d.user_raw[sl], device=dev)
        md = torch.as_tensor(d.movie_raw[sl], device=dev)
        r = torch.as_tensor(d.rating[sl], device=dev).to(torch.float64)
        pred = (u[ud].to(torch.float64) * m[md].to(torch.float64)).sum(1)
        se += ((r - pred) ** 2).sum()
    mse = float(se) / max(d.rating.shape[0], 1)
    return mse, math.sqrt(mse)
