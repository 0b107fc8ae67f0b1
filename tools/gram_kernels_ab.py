"""Device time of the port's tiled Gram kernels over every chunk of one
tiled dataset, for comparing two source trees on one card.

    python3 tools/gram_kernels_ab.py [--tree DIR] [--label NAME]
        [--nnz N] [--rank K] [--cache FILE]

``--tree`` names the directory holding the ``cfk_tpu_torch`` package to
measure (default: this checkout); its kernels are built from that tree's
``csrc/``.  Run two trees in turns in one call (A, B, B, A) and compare
them only within it.  The dataset is the Netflix shape's entity counts with
a cut rating count (``--nnz``, seed 0: the same chunk shapes, a lighter
Zipf head), tiled with the dense stream as ``chip_smoke.py`` builds it,
random factor tables at ``--rank``.  Per kernel: the sum over all chunks of
its device ms (CUDA events around each launch; the best of ``--reps``
passes), with the gather kernels K2 (accum chunks), K3 and
``gram_tiles_dense_gather`` (dense chunks) and, where the tree has them,
their stream twins ``gram_tiles``, ``gram_solve_tiles_dense`` and
``gram_tiles_dense`` on the stream K5 writes (outside the timing) and K5
itself.  ``--cache FILE`` keeps the built dataset in FILE (pickled; the
first process of a call writes it, the others read it), so turns at the
full Netflix rating count (``--nnz 100480507``) do not each spend minutes
building it.  Prints the card (``nvidia-smi``) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--nnz", type=int, default=10_000_000)
    ap.add_argument("--rank", type=int, default=64)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache", default=None)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("gram_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import cfk_tpu_torch
    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.models.als import _tiled_device_setup
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk
    from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk

    if Path(cfk_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {cfk_tpu_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gk._build.build_all()
    build_s = time.perf_counter() - t0
    cache = Path(args.cache) if args.cache else None
    if cache is not None and cache.exists():
        with cache.open("rb") as fh:
            ds = pickle.load(fh)
        if int(ds.movie_blocks.count.sum()) != args.nnz:
            raise RuntimeError(f"{cache} holds another --nnz")
    else:
        coo = synthetic_netflix_coo(480_189, 17_770, args.nnz, seed=0)
        ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=1 << 20,
                              dense_stream=True)
        del coo
        if cache is not None:
            with cache.open("wb") as fh:
                pickle.dump(ds, fh, protocol=pickle.HIGHEST_PROTOCOL)
    dev = torch.device("cuda")
    blk_m, blk_u, _ = _tiled_device_setup(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((ds.user_blocks.padded_entities, args.rank),
                    generator=gen, device=dev)
    m = torch.randn((ds.movie_blocks.padded_entities, args.rank),
                    generator=gen, device=dev)
    st_m, st_u = ds.movie_blocks.statics, ds.user_blocks.statics
    try:  # the work-unit plans the device upload staged, where the tree has them
        from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

        def with_plan(a, blk, c):
            return dict(a, units=chunk_plan(blk, c))
    except ImportError:
        def with_plan(a, blk, c):
            return a
    accum = [with_plan(accum_chunk(blk_m, st_m, c), blk_m, c)
             for c in range(st_m[0])]
    dense = []
    for c in range(st_u[0]):
        a = with_plan(dense_chunk(blk_u, st_u, c), blk_u, c)
        a.pop("cin")
        dense.append(a)

    def total_ms(calls):
        """Best over reps of the summed device ms of ``calls``; each call
        is (prepare, launch): prepare runs outside the timing."""
        best = None
        for _ in range(args.reps):
            events = []
            for prepare, launch in calls:
                ops = prepare()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                launch(ops)
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            ms = sum(s.elapsed_time(e) for s, e in events)
            best = ms if best is None else min(best, ms)
        return best

    def gram_of(a):
        return {n: v for n, v in a.items() if n not in ("reg", "lseg")}

    none = lambda: None  # noqa: E731
    out = {
        "gram_gather": total_ms([(none, lambda _, a=a: gk.gram_gather(u, **a))
                                 for a in accum]),
        "gram_solve_dense": total_ms([
            (none, lambda _, a=a: gk.gram_solve_dense(m, **a, lam=0.05))
            for a in dense]),
        "gram_tiles_dense_gather": total_ms([
            (none, lambda _, a=a: gk.gram_tiles_dense_gather(m, **gram_of(a)))
            for a in dense]),
    }
    if hasattr(gk, "gram_tiles"):
        def stream(table, a):
            return lambda: gk.gather_rows(table, a["nb"], a["wt"])

        def rest(a):
            return {n: v for n, v in a.items() if n not in ("nb", "wt")}

        out["gather_rows"] = total_ms([
            (none, lambda _, a=a: gk.gather_rows(u, a["nb"], a["wt"]))
            for a in accum])
        out["gram_tiles"] = total_ms([
            (stream(u, a), lambda g, a=a: gk.gram_tiles(g, **rest(a)))
            for a in accum])
        out["gram_solve_tiles_dense"] = total_ms([
            (stream(m, a), lambda g, a=a: gk.gram_solve_tiles_dense(
                g, **rest(a), lam=0.05)) for a in dense])
        out["gram_tiles_dense"] = total_ms([
            (stream(m, a), lambda g, a=a: gk.gram_tiles_dense(
                g, **gram_of(rest(a)))) for a in dense])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(dict(label=args.label, tree=str(tree), nnz=args.nnz,
                          rank=args.rank, build_s=build_s,
                          accum_chunks=len(accum), dense_chunks=len(dense),
                          total_ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
