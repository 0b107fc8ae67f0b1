"""Synthetic Netflix-Prize-shaped rating data for scale benchmarking.

The port's own copy of ``cfk_tpu/data/synthetic.py``: the same seeds give
the same ratings in both packages.

Throughput at the full Netflix Prize shape is measured on synthetic data
with the corpus's statistical shape: Zipf-distributed entity popularity
(power-law degree distributions — the property that stresses the block
layouts) and uniform 1-5 star ratings.  ``planted_factor_coo`` plants known
low-rank factors so that recovery quality is checkable too.
"""

from __future__ import annotations

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO


def zipf_probs(n: int, skew: float) -> np.ndarray:
    p = (1.0 / np.arange(1, n + 1)) ** skew
    return p / p.sum()


def synthetic_netflix_coo(
    num_users: int = 480_189,
    num_movies: int = 17_770,
    nnz: int = 100_480_507,
    *,
    seed: int = 0,
    movie_skew: float = 0.9,
    user_skew: float = 0.7,
) -> RatingsCOO:
    """Netflix-Prize-shaped COO (defaults are the real corpus dimensions).

    Popularity is Zipf over a random permutation of ids (so popular entities
    are scattered across the id space like the real data, not clustered at
    low ids — this matters for contiguous-range sharding load balance).
    Duplicate (movie, user) pairs may occur; ALS treats them as repeated
    observations, which does not change the math's shape or cost.
    """
    rng = np.random.default_rng(seed)
    m_ids = rng.permutation(num_movies).astype(np.int64) + 1
    u_ids = rng.permutation(num_users).astype(np.int64) + 1
    movie = m_ids[rng.choice(num_movies, size=nnz, p=zipf_probs(num_movies, movie_skew))]
    user = u_ids[rng.choice(num_users, size=nnz, p=zipf_probs(num_users, user_skew))]
    rating = rng.integers(1, 6, size=nnz).astype(np.float32)
    return RatingsCOO(movie_raw=movie, user_raw=user, rating=rating)


def serve_factors(num_users: int, num_movies: int, rank: int,
                  rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(U [num_users, rank], M [num_movies, rank]) float32 serving factors.

    Mixture-of-Gaussians item factors, with user vectors drawn near the
    components under a Zipf(1.2) popularity law and sorted, so low user rows
    (which Zipf traffic hits most) share the heavy components: trained CF
    tables cluster, which two-stage retrieval relies on.  The same ``rng``
    state gives the same arrays as the JAX package's serving bench
    (``bench.py::_serve_factors``)."""
    ncomp = min(64, max(num_movies // 16, 1))
    comp = rng.standard_normal((ncomp, rank)).astype(np.float32) * 0.3
    m = (comp[rng.integers(0, ncomp, size=num_movies)]
         + rng.standard_normal((num_movies, rank), dtype=np.float32) * 0.05)
    w = 1.0 / np.arange(1, ncomp + 1, dtype=np.float64) ** 1.2
    u_comp = np.sort(rng.choice(ncomp, size=num_users, p=w / w.sum()))
    u = (comp[u_comp]
         + rng.standard_normal((num_users, rank), dtype=np.float32) * 0.05)
    return u, m


def serve_seen_csr(num_users: int, num_movies: int, nnz: int, pool,
                   rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(seen movie rows int32, indptr [num_users+1] int64): a seen list for
    each user of ``pool`` (Poisson widths at the mean ``nnz / num_users``,
    at least 1, movies sorted and distinct), empty for everyone else — the
    rows traffic will touch get realistic exclusion widths.  Same ``rng``
    state, same arrays as ``bench.py::_serve_seen_csr``."""
    mean_seen = max(1, nnz // num_users)
    pool = np.unique(pool)
    counts = np.zeros(num_users, np.int64)
    counts[pool] = rng.poisson(mean_seen, pool.shape[0]).clip(1)
    indptr = np.zeros(num_users + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    seen = np.empty(indptr[-1], np.int32)
    for row in pool:
        lo, hi = indptr[row], indptr[row + 1]
        seen[lo:hi] = np.sort(rng.choice(num_movies, size=hi - lo,
                                         replace=False)).astype(np.int32)
    return seen, indptr


def planted_factor_coo(
    num_users: int,
    num_movies: int,
    nnz: int,
    *,
    rank: int,
    noise: float = 0.1,
    heldout: int = 0,
    seed: int = 0,
    movie_skew: float = 0.9,
    user_skew: float = 0.7,
) -> tuple[RatingsCOO, RatingsCOO | None]:
    """Ratings generated from KNOWN low-rank factors plus Gaussian noise.

    The quality validation for shapes whose real corpus is unfetchable
    (VERDICT r1 item #6): plant U* [users, rank], M* [movies, rank] with
    entries N(0, rank^-1/4) — so the rank-term dot product u*·m* has unit
    variance and planted ratings are O(1) — and emit
    r = u*·m* + ε, ε ~ N(0, noise²), at Zipf-popular (user, movie) pairs.
    A correctly working at-scale pipeline (layout + bf16 storage + pallas
    solver + sharding) must drive held-out RMSE down toward the noise
    floor σ; a subtly broken one cannot.  Returns (train COO, heldout COO)
    — ``heldout`` extra planted cells never seen in training (None if 0).
    """
    rng = np.random.default_rng(seed)
    u_star = rng.standard_normal((num_users, rank)).astype(np.float32)
    m_star = rng.standard_normal((num_movies, rank)).astype(np.float32)
    u_star /= rank ** 0.25
    m_star /= rank ** 0.25
    m_ids = rng.permutation(num_movies).astype(np.int64) + 1
    u_ids = rng.permutation(num_users).astype(np.int64) + 1
    total = nnz + heldout
    m_idx = rng.choice(num_movies, size=total, p=zipf_probs(num_movies, movie_skew))
    u_idx = rng.choice(num_users, size=total, p=zipf_probs(num_users, user_skew))
    # Chunked dot products: unchunked [total, rank] gathers would spike
    # ~52 GB host RAM at the full Netflix shape.
    r = np.empty(total, dtype=np.float32)
    chunk = 1 << 22
    for lo in range(0, total, chunk):
        sl = slice(lo, lo + chunk)
        r[sl] = np.einsum(
            "nk,nk->n", u_star[u_idx[sl]], m_star[m_idx[sl]]
        )
    r += (noise * rng.standard_normal(total)).astype(np.float32)
    train = RatingsCOO(
        movie_raw=m_ids[m_idx[:nnz]], user_raw=u_ids[u_idx[:nnz]],
        rating=r[:nnz],
    )
    if heldout == 0:
        return train, None
    # Held-out cells must be UNSEEN: Zipf-hot (user, movie) pairs are drawn
    # many times, so i.i.d. held-out draws collide with training pairs and
    # ALS would partially fit their noise — drop the collisions (this skews
    # the held-out set toward cold pairs, i.e. the CONSERVATIVE direction
    # for the recovery bound).
    key = u_idx.astype(np.int64) * num_movies + m_idx
    fresh = ~np.isin(key[nnz:], key[:nnz], kind="sort")
    held = RatingsCOO(
        movie_raw=m_ids[m_idx[nnz:]][fresh], user_raw=u_ids[u_idx[nnz:]][fresh],
        rating=r[nnz:][fresh],
    )
    return train, held
