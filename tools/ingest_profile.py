"""Where the host set-up of the Netflix-shape training run goes, for one
source tree of the port (host work only: no device is touched).

    python3 tools/ingest_profile.py --tree DIR --label NAME \\
        [--nnz 100480507] [--coo-cache FILE] [--parse-nnz 10000000] \\
        [--out FILE]

Imports ``cfk_tpu_torch`` from ``--tree`` (the checkout itself by default;
unpack a parent with ``git archive HEAD cfk_tpu_torch | tar -x -C
archive_check/parent``), takes ``synthetic_netflix_coo(480_189, 17_770,
nnz, seed=0)`` — generated once and kept in ``--coo-cache`` when given, so
a second tree's process loads it — and times, each in a fresh call:

- ``index_entities`` of both sides' raw ids and ``group_by_dense`` of both
  sides' dense keys (the steps the ingest route changes);
- ``Dataset.from_coo(coo, layout="tiled", chunk_elems=2**20,
  dense_stream=True)``, the main smoke phase's build, once plain and once
  under ``cProfile`` (the top functions by their own time and by
  cumulative time are printed);
- ``parse_netflix`` and ``parse_netflix_python`` on a Netflix-format file
  of the first ``--parse-nnz`` ratings (written beside ``--coo-cache``).

Prints one JSON line (and writes it to ``--out``) with the seconds and
which route the tree took (``native`` if it has the host library).
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time
from pathlib import Path

NETFLIX = dict(num_users=480_189, num_movies=17_770)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _coo(args, synthetic, blocks):
    if args.coo_cache and Path(args.coo_cache).exists():
        import numpy as np

        with np.load(args.coo_cache) as z:
            return blocks.RatingsCOO(movie_raw=z["movie"], user_raw=z["user"],
                                     rating=z["rating"]), None
    coo, gen_s = _timed(lambda: synthetic.synthetic_netflix_coo(
        **NETFLIX, nnz=args.nnz, seed=0))
    if args.coo_cache:
        import numpy as np

        Path(args.coo_cache).parent.mkdir(parents=True, exist_ok=True)
        with open(args.coo_cache, "wb") as f:
            np.savez(f, movie=coo.movie_raw, user=coo.user_raw,
                     rating=coo.rating)
    return coo, gen_s


def _netflix_file(coo, n: int, path: Path) -> None:
    """The first ``n`` ratings as a Netflix-format file (grouped by movie,
    a fixed date)."""
    import numpy as np

    m, u, r = coo.movie_raw[:n], coo.user_raw[:n], coo.rating[:n]
    order = np.argsort(m, kind="stable")
    m, u, r = m[order], u[order], r[order].astype(np.int64)
    starts = np.flatnonzero(np.r_[True, m[1:] != m[:-1]])
    ends = np.r_[starts[1:], m.shape[0]]
    with open(path, "w") as f:
        for lo, hi in zip(starts, ends):
            f.write(f"{m[lo]}:\n")
            f.write("".join(f"{a},{b},2005-01-01\n"
                            for a, b in zip(u[lo:hi].tolist(),
                                            r[lo:hi].tolist())))


def _top(prof, key: str, n: int) -> list[str]:
    buf = io.StringIO()
    pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(n)
    lines = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if "ncalls" in ln)
    return lines[start:start + n + 1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    p.add_argument("--label", required=True)
    p.add_argument("--nnz", type=int, default=100_480_507)
    p.add_argument("--coo-cache", default=None)
    p.add_argument("--parse-nnz", type=int, default=10_000_000)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    from cfk_tpu_torch.data import blocks, netflix, synthetic

    try:
        from cfk_tpu_torch.data import _native

        route = "native" if _native.available() else "numpy"
    except ImportError:
        route = "numpy"  # a tree from before the host library
    coo, gen_s = _coo(args, synthetic, blocks)
    row = dict(label=args.label, tree=args.tree, route=route,
               nnz=coo.num_ratings, generate_s=gen_s)
    (mmap, m_dense), row["index_s"] = _timed(lambda: (
        blocks.index_entities(coo.movie_raw)))
    (umap, u_dense), idx_u = _timed(lambda: blocks.index_entities(
        coo.user_raw))
    row["index_s"] += idx_u
    _, row["group_by_s"] = _timed(lambda: (
        blocks.group_by_dense(m_dense, mmap.num_entities),
        blocks.group_by_dense(u_dense, umap.num_entities)))
    build = dict(layout="tiled", chunk_elems=1 << 20, dense_stream=True)
    _, row["from_coo_s"] = _timed(lambda: blocks.Dataset.from_coo(coo,
                                                                  **build))
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.runcall(blocks.Dataset.from_coo, coo, **build)
    row["from_coo_profiled_s"] = time.perf_counter() - t0
    row["profile_tottime"] = _top(prof, "tottime", args.top)
    row["profile_cumulative"] = _top(prof, "cumulative", args.top)
    if args.parse_nnz:
        path = Path(args.coo_cache or "ingest_profile.coo").with_suffix(
            f".{args.parse_nnz}.txt")
        if not path.exists():
            _netflix_file(coo, args.parse_nnz, path)
        row["parse_file_bytes"] = path.stat().st_size
        parsed, row["parse_netflix_s"] = _timed(
            lambda: netflix.parse_netflix(str(path)))
        plain, row["parse_netflix_python_s"] = _timed(
            lambda: netflix.parse_netflix_python(str(path)))
        row["parse_ratings"] = parsed.num_ratings
        row["parse_routes_equal"] = all(
            (getattr(parsed, f) == getattr(plain, f)).all()
            for f in ("movie_raw", "user_raw", "rating"))
    for key in ("profile_tottime", "profile_cumulative"):
        print(f"--- {args.label}: cProfile of Dataset.from_coo by {key}")
        print("\n".join(row[key]))
    line = json.dumps(row)
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
