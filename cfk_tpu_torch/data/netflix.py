"""Netflix-Prize-format ingest (the port's copy of ``cfk_tpu/data/netflix.py``).

Grammar (matching ``producers/NetflixDataFormatProducer.java:44-50``):

    <movieId>:            — header line, sets the current movie
    <userId>,<rating>,<date>   — one rating row; the date field is ignored

Movies with zero rating rows exist in the files and are dropped: the
reference counts rated entities only.

``parse_netflix`` takes the host library's single-pass C++ parser
(``data._native``) as ``cfk_tpu/data/netflix.py:71-83`` takes the JAX
package's; ``parse_netflix_python`` is its plain version, taken where no
library could be built.  Both return the same arrays and raise ValueError
naming the path and line of a malformed line.
"""

from __future__ import annotations

import numpy as np

from cfk_tpu_torch.data.blocks import RatingsCOO

_INT64_MAX = 2**63 - 1


def parse_netflix_python(path: str) -> RatingsCOO:
    """Pure-Python Netflix-format parser."""
    movie_ids: list[int] = []
    user_ids: list[int] = []
    ratings: list[int] = []
    current_movie = -1
    with open(path, "r") as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                if line.endswith(":"):
                    if not line[:-1].isdigit():
                        raise ValueError("non-numeric movie id")
                    current_movie = int(line[:-1])
                    if current_movie > _INT64_MAX:
                        raise ValueError("movie id exceeds int64")
                    continue
                user_s, rating_s, _ = line.split(",", 2)
                if not (user_s.isdigit() and rating_s.isdigit()):
                    raise ValueError("non-numeric field")
                user_id, rating = int(user_s), int(rating_s)
                if user_id > _INT64_MAX or rating > _INT64_MAX:
                    raise ValueError("field exceeds int64")
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: malformed line {line!r}") from e
            if current_movie < 0:
                raise ValueError(
                    f"{path}:{lineno}: rating row before any 'movieId:' header"
                )
            movie_ids.append(current_movie)
            user_ids.append(user_id)
            ratings.append(rating)
    return RatingsCOO(
        movie_raw=np.asarray(movie_ids, dtype=np.int64),
        user_raw=np.asarray(user_ids, dtype=np.int64),
        rating=np.asarray(ratings, dtype=np.float32),
    )


def parse_netflix(path: str) -> RatingsCOO:
    """Parse a Netflix-format ratings file into COO arrays (the host
    library's parser, else the pure-Python one)."""
    from cfk_tpu_torch.data import _native

    if _native.available():
        return _native.parse_netflix(path)
    return parse_netflix_python(path)
