"""Top-K recommendation from trained factors, on the model's device.

The port of ``cfk_tpu/eval/recommend.py``: one [n, k]·[k, M] matrix product
per user chunk (full float32: TF32 stays off), already-rated movies set to
−inf through a trash-column scatter, then ``torch.topk``.  The JAX package
computes this outside Pallas (an einsum plus ``lax.top_k``), so it stays
plain PyTorch here; memory is O(chunk · num_movies).
"""

from __future__ import annotations

import numpy as np
import torch


def _seen_lists(user_rows: np.ndarray, dataset, num_movies: int):
    """Padded [n, S] seen-movie columns for the requested user rows, padded
    with ``num_movies`` (the trash column)."""
    coo = dataset.coo_dense
    uniq, inv = np.unique(user_rows, return_inverse=True)
    n = uniq.shape[0]
    row_of_user = np.full(int(coo.user_raw.max(initial=-1)) + 2, -1,
                          dtype=np.int64)
    row_of_user[uniq] = np.arange(n)
    sel = np.flatnonzero(row_of_user[coo.user_raw] >= 0)
    rows = row_of_user[coo.user_raw[sel]]
    movies = coo.movie_raw[sel]
    counts = np.bincount(rows, minlength=n)
    width = max(8, 1 << (max(int(counts.max(initial=0)), 1) - 1).bit_length())
    seen_idx = np.full((n, width), num_movies, dtype=np.int64)
    order = np.argsort(rows, kind="stable")
    pos = (np.arange(sel.size)
           - np.concatenate(([0], np.cumsum(counts)))[rows[order]])
    seen_idx[rows[order], pos] = movies[order]
    return seen_idx[inv]


def recommend_top_k(model, user_rows, k: int = 10, *, dataset=None,
                    chunk: int = 8192):
    """Top-K movie rows (dense ascending-id indices) for each user row.

    ``dataset`` (anything with a dense-index ``.coo_dense`` — a ``Dataset``
    or a ``RatingsIndex``) enables exclude-seen.  Returns (scores [n, k]
    float32, movie_rows [n, k] int32) as numpy arrays.
    """
    user_rows = np.asarray(user_rows, dtype=np.int64)
    if user_rows.ndim != 1:
        raise ValueError(f"user_rows must be 1-D, got shape {user_rows.shape}")
    bad = (user_rows < 0) | (user_rows >= model.num_users)
    if np.any(bad):
        raise ValueError(
            f"user rows out of range [0, {model.num_users}): "
            f"{user_rows[bad][:5]}"
        )
    if not 1 <= k <= model.num_movies:
        raise ValueError(f"k must be in [1, {model.num_movies}], got {k}")
    u_all = model.user_factors
    m = model.movie_factors[: model.num_movies].to(torch.float32)
    dev = m.device
    out_scores = np.empty((user_rows.shape[0], k), dtype=np.float32)
    out_movies = np.empty((user_rows.shape[0], k), dtype=np.int32)
    for lo in range(0, user_rows.shape[0], chunk):
        rows = user_rows[lo: lo + chunk]
        u = u_all[torch.as_tensor(rows, device=dev)].to(torch.float32)
        scores = torch.cat(
            [u @ m.T, torch.zeros((rows.shape[0], 1), device=dev)], dim=1)
        if dataset is not None:
            seen = torch.as_tensor(_seen_lists(rows, dataset, model.num_movies),
                                   device=dev)
            scores.scatter_(1, seen, float("-inf"))
        values, idx = torch.topk(scores[:, :-1], k, dim=1)
        out_scores[lo: lo + rows.shape[0]] = values.cpu().numpy()
        out_movies[lo: lo + rows.shape[0]] = idx.to(torch.int32).cpu().numpy()
    return out_scores, out_movies
