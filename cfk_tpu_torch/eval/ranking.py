"""Ranking evaluation of the implicit model: leave-one-out Recall@K and MPR.

The port's own copy of ``cfk_tpu/eval/ranking.py``: each held-out item is
ranked among all items the user has not interacted with in training, ties
counted half.  The split draws the same ``np.random.default_rng(seed)``
permutation, so it is identical to the JAX package's; the per-chunk scores
are one ``torch.matmul`` on the model's device (TF32 off on CUDA).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cfk_tpu_torch.data.blocks import RatingsCOO


@dataclasses.dataclass(frozen=True)
class Heldout:
    user_dense: np.ndarray  # [n] dense user index
    movie_dense: np.ndarray  # [n] dense movie index of the held-out item


def leave_one_out_split(movie_dense: np.ndarray, user_dense: np.ndarray,
                        rating: np.ndarray, *, seed: int = 0
                        ) -> tuple[RatingsCOO, Heldout]:
    """Hold out one random interaction per user with ≥ 2 interactions.

    Inputs are dense-index COO arrays; returns (train COO in dense indices,
    heldout).  An interaction is held out only while its movie keeps ≥ 2
    interactions, so every entity stays covered in train and a Dataset
    built from ``train`` has the full dataset's dense index space.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(user_dense.shape[0])
    held_mask = np.zeros(user_dense.shape[0], dtype=bool)
    user_counts = np.bincount(user_dense)
    movie_counts = np.bincount(movie_dense)
    seen: set[int] = set()
    for idx in order:
        u = int(user_dense[idx])
        mv = int(movie_dense[idx])
        if u not in seen and user_counts[u] >= 2 and movie_counts[mv] >= 2:
            held_mask[idx] = True
            seen.add(u)
            movie_counts[mv] -= 1
    train = RatingsCOO(
        movie_raw=movie_dense[~held_mask].astype(np.int64),
        user_raw=user_dense[~held_mask].astype(np.int64),
        rating=rating[~held_mask].astype(np.float32),
    )
    heldout = Heldout(
        user_dense=user_dense[held_mask].astype(np.int64),
        movie_dense=movie_dense[held_mask].astype(np.int64),
    )
    return train, heldout


def _validate_index_space(train: RatingsCOO, num_users: int, num_movies: int,
                          what: str) -> None:
    if train.user_raw.max(initial=-1) >= num_users or train.movie_raw.max(
            initial=-1) >= num_movies:
        raise ValueError(
            f"train indices exceed {what} ({num_users} users, {num_movies} "
            "movies) — the model was trained on a dataset with a different "
            "dense index space than the split; build the split with "
            "leave_one_out_split so every entity stays covered in train"
        )


def _tie_averaged_ranks(cand: np.ndarray, held_scores: np.ndarray
                        ) -> np.ndarray:
    """0-based rank of ``held_scores[i]`` within row ``cand[i]`` (train
    cells already -inf); ties count half, the held item's own cell
    excluded — a constant-score model must not rank perfectly."""
    better = (cand > held_scores[:, None]).sum(axis=1)
    ties = (cand == held_scores[:, None]).sum(axis=1) - 1
    return better + 0.5 * ties


def _num_candidates(train: RatingsCOO, heldout: Heldout, num_users: int,
                    num_movies: int) -> np.ndarray:
    """Per-held-out-user count of non-train items (the MPR denominator)."""
    return num_movies - np.bincount(
        train.user_raw, minlength=num_users)[heldout.user_dense]


def _ranks(scores: np.ndarray, train: RatingsCOO, heldout: Heldout
           ) -> np.ndarray:
    """0-based rank of each held-out item among that user's non-train
    items, from a dense [num_users, num_movies] score matrix."""
    _validate_index_space(train, scores.shape[0], scores.shape[1],
                          f"score matrix {scores.shape}")
    s = scores.copy()
    s[train.user_raw, train.movie_raw] = -np.inf  # exclude seen items
    held_scores = s[heldout.user_dense, heldout.movie_dense]
    return _tie_averaged_ranks(s[heldout.user_dense], held_scores)


def ranks_from_model(model, train: RatingsCOO, heldout: Heldout,
                     chunk: int = 8192) -> np.ndarray:
    """``_ranks``'s semantics streamed from the factors: scores per
    held-out-user chunk ([chunk, num_movies] at a time, one matmul on the
    model's device), so U·Mᵀ is never materialized."""
    # float32 scores (a bf16 model's factors upcast first, as predict_dense
    # and the MSE do).
    u = model.user_factors[: model.num_users].float()
    m = model.movie_factors[: model.num_movies].float()
    _validate_index_space(train, u.shape[0], m.shape[0], "factor shapes")
    # CSR of train interactions by user, for per-chunk exclusion.
    order = np.argsort(train.user_raw, kind="stable")
    tm = train.movie_raw[order].astype(np.int64)
    starts = np.searchsorted(train.user_raw[order], np.arange(u.shape[0] + 1))
    out = np.empty(heldout.user_dense.shape[0], dtype=np.float64)
    for lo in range(0, heldout.user_dense.shape[0], chunk):
        hu = heldout.user_dense[lo:lo + chunk]
        hm = heldout.movie_dense[lo:lo + chunk]
        rows_t = torch.as_tensor(hu, device=u.device)
        cand = (u[rows_t] @ m.T).cpu().numpy()  # [c, num_movies]
        counts = starts[hu + 1] - starts[hu]
        rows = np.repeat(np.arange(hu.shape[0]), counts)
        flat = np.arange(counts.sum()) + np.repeat(
            starts[hu] - np.concatenate(([0], np.cumsum(counts[:-1]))), counts)
        cand[rows, tm[flat]] = -np.inf  # exclude seen items
        held_scores = cand[np.arange(hu.shape[0]), hm]
        out[lo:lo + hu.shape[0]] = _tie_averaged_ranks(cand, held_scores)
    return out


def ranking_metrics_from_model(model, train: RatingsCOO, heldout: Heldout,
                               k: int = 10, chunk: int = 8192
                               ) -> tuple[float, float]:
    """(Recall@K, MPR) straight from the factors — one rank pass."""
    if heldout.user_dense.size == 0:
        raise ValueError("empty heldout set")
    ranks = ranks_from_model(model, train, heldout, chunk)
    nc = _num_candidates(train, heldout, model.num_users, model.num_movies)
    recall = float((ranks < k).mean())
    mpr = float((ranks / np.maximum(nc - 1, 1)).mean())
    return recall, mpr


def recall_at_k(scores: np.ndarray, train: RatingsCOO, heldout: Heldout,
                k: int = 10) -> float:
    """Fraction of held-out items ranked in the user's top-K unseen items."""
    if heldout.user_dense.size == 0:
        raise ValueError("empty heldout set")
    return float((_ranks(scores, train, heldout) < k).mean())


def mean_percentile_rank(scores: np.ndarray, train: RatingsCOO,
                         heldout: Heldout) -> float:
    """Hu et al.'s MPR ∈ [0, 1]; 0.5 = random, lower is better."""
    if heldout.user_dense.size == 0:
        raise ValueError("empty heldout set")
    nc = _num_candidates(train, heldout, scores.shape[0], scores.shape[1])
    ranks = _ranks(scores, train, heldout)
    return float((ranks / np.maximum(nc - 1, 1)).mean())
