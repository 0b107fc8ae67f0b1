"""MovieLens CSV ingest (ml-25m ``ratings.csv`` format) — the port's copy of
``cfk_tpu/data/movielens.py``.

Grammar: optional header ``userId,movieId,rating,timestamp``, then rows
``userId,movieId,rating,timestamp``; timestamps are ignored.  For the
implicit-feedback pipeline the rating column is the interaction strength;
``min_rating`` drops rows below a threshold (a common MovieLens-implicit
protocol).  ``parse_movielens_csv`` takes the host library's C++ parser
(``data._native``) as ``cfk_tpu/data/movielens.py:25-34`` does;
``parse_movielens_csv_python`` is its plain version.
"""

from __future__ import annotations

import re

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO

# Plain non-negative decimal (digits, optional .digits): no sign or exponent.
_RATING_RE = re.compile(r"\d+(\.\d*)?|\.\d+")
_INT64_MAX = 2**63 - 1


def parse_movielens_csv(path: str, *, min_rating: float = 0.0) -> RatingsCOO:
    """Parse a MovieLens CSV into COO arrays (the host library's parser,
    else the pure-Python one)."""
    from cfk_tpu_torch.data import _native

    if _native.available():
        return _native.parse_movielens(path, min_rating)
    return parse_movielens_csv_python(path, min_rating=min_rating)


def parse_movielens_csv_python(path: str, *,
                               min_rating: float = 0.0) -> RatingsCOO:
    """Pure-Python MovieLens CSV parser."""
    users: list[int] = []
    movies: list[int] = []
    ratings: list[float] = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            if lineno == 1 and line.lower().startswith("userid"):
                continue  # header
            parts = line.split(",")
            if len(parts) < 3:
                raise ValueError(f"{path}:{lineno}: malformed line {line!r}")
            try:
                if not (parts[0].isdigit() and parts[1].isdigit()):
                    raise ValueError("non-numeric id")
                if not _RATING_RE.fullmatch(parts[2]):
                    raise ValueError("malformed rating")
                user, movie = int(parts[0]), int(parts[1])
                rating = float(parts[2])
                if user > _INT64_MAX or movie > _INT64_MAX:
                    raise ValueError("id exceeds int64")
            except ValueError as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed line {line!r}") from e
            if rating < min_rating:
                continue
            users.append(user)
            movies.append(movie)
            ratings.append(rating)
    return RatingsCOO(
        movie_raw=np.asarray(movies, dtype=np.int64),
        user_raw=np.asarray(users, dtype=np.int64),
        rating=np.asarray(ratings, dtype=np.float32),
    )
