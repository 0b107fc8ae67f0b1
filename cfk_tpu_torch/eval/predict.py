"""Prediction-matrix CSV dump, wire-compatible with the reference's output
(the port of ``cfk_tpu/eval/predict.py``).

The reference dumps via EJML ``MatrixIO.saveDenseCSV``
(``processors/FeatureCollector.java:96-109``): a header line
``<numRows> <numCols> real`` followed by space-separated rows.  The offline
evaluator skips any line containing "real" (``scripts/calculate_mse.py:66-68``).
"""

from __future__ import annotations

import os
import time

import numpy as np


def save_prediction_csv(predictions: np.ndarray, path: str | None = None) -> str:
    """Write the dense prediction matrix in EJML dense-CSV format; with no
    ``path``, to ``predictions/prediction_matrix_<epoch-ms>`` like the
    reference."""
    if path is None:
        os.makedirs("predictions", exist_ok=True)
        path = os.path.join("predictions", f"prediction_matrix_{int(time.time() * 1000)}")
    rows, cols = predictions.shape
    with open(path, "w") as f:
        f.write(f"{rows} {cols} real\n")
        np.savetxt(f, predictions.astype(np.float64), fmt="%.9g", delimiter=" ")
    return path


def load_prediction_csv(path: str) -> np.ndarray:
    """Read an EJML dense-CSV prediction matrix (header line skipped)."""
    with open(path) as f:
        header = f.readline().split()
        rows, cols = int(header[0]), int(header[1])
        mat = np.loadtxt(f, dtype=np.float64)
    return mat.reshape(rows, cols)
