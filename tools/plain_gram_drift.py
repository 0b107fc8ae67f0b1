"""How far the plain tile Gram moved when it began summing in 1,024-row
blocks, and how far each of its versions lies from the Gram kernel.

    python3 tools/plain_gram_drift.py [--nnz N] [--cache FILE]

The plain tile Gram (``ops/kernels/gram_kernel.py::_tile_sums``) is the
reference that the eight Gram kernels are held to on the card.  It sums a
tile in blocks of ``UNIT_ROWS`` (1,024) rows, each block from zero, the
blocks then added in order — the kernels' own two-level sum — and runs the
block products as a batch of at least two.  Before that it was one einsum
over each whole tile.  Three versions are compared here, on float32
operands:

- ``whole``: one einsum over each whole tile (the earlier plain version);
- ``whole_batch2``: the same, with a zero tile added to a batch of one;
- ``blocks``: ``_tile_sums``.

Each against K2 (``gram_gather``, the split Gram kernel: the sums every
Gram kernel forms) and ``blocks`` against ``whole``, as max |difference|
over max |reference| of A and of b, on three sets of operands:

- ``bucket8``: the 300,000-row single tile of
  ``tests/test_torch_gpu.py::test_split_segments_on_every_gram_kernel``'s
  ``bucket-8`` case (rank 8, the test's seed and draws);
- ``ials_b``: every width class of both halves of iALS (b) — the ML-25M
  shape, 25,000,095 interactions, seed 0, bucketed at 524,288 entries,
  rank 128, U(0, 1) tables, α 40 (as ``tools/gram_kernels_ab.py --parts k6``
  builds them) — the smoke's 4,096-wide class and the head class apart;
- ``tiled``: every accum chunk of the Netflix entity counts with ``--nnz``
  ratings (seed 0, tiled with the dense stream at 2^20-entry chunks, as
  ``tools/gram_kernels_ab.py`` builds them; ``--cache`` shares its pickle),
  random rank-64 tables: whether ``blocks`` equals ``whole`` bit for bit,
  tile by tile (before the segment sums, whose ``index_add_`` adds in no
  fixed order on the card; the other two sets have one tile a segment).

Needs a CUDA device.  Prints the card (``nvidia-smi``) and one JSON line.
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def whole(g, rt, t, batch2):
    """One einsum over each whole tile; ``batch2`` adds a zero tile to a
    batch of one."""
    import torch

    k = g.shape[-1]
    gt, r = g.view(-1, t, k), rt.view(-1, t)
    n = gt.shape[0]
    if batch2 and n == 1:
        gt = torch.cat([gt, torch.zeros_like(gt)])
        r = torch.cat([r, torch.zeros_like(r)])
    return (torch.einsum("ntk,ntl->nkl", gt, gt)[:n],
            torch.einsum("ntk,nt->nk", gt, r)[:n])


def versions(g, rt, seg, s, t):
    """(A, b) of each plain version, summed per segment."""
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk

    k = g.shape[-1]
    tiles = {"whole": whole(g, rt, t, False),
             "whole_batch2": whole(g, rt, t, True),
             "blocks": gk._tile_sums(g.view(-1, t, k), rt.view(-1, t))}
    return {name: gk._segment_sums(a, b, seg, s, None)
            for name, (a, b) in tiles.items()}


def compare(kernel, plain) -> dict:
    out = {f"kernel_vs_{name}": max(rel(x, y) for x, y in zip(kernel, ab))
           for name, ab in plain.items()}
    out["blocks_vs_whole"] = max(rel(x, y) for x, y in
                                 zip(plain["blocks"], plain["whole"]))
    out["blocks_equal_whole"] = all(
        bool((x == y).all()) for x, y in zip(plain["blocks"],
                                             plain["whole"]))
    return out


def bucket8(dev) -> dict:
    import numpy as np
    import torch

    from cfk_tpu_torch.ops.kernels import gram_kernel as gk

    k, f, t = 8, 3000, 300_000
    rng = np.random.default_rng(k)
    rng.standard_normal((2 * k, k))  # the test's carry draws
    rng.standard_normal(k)
    d = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    table = d(rng.standard_normal((f, k), dtype=np.float32))
    nb = d(rng.integers(0, f, t).astype(np.int32))
    wt = d(rng.random(t, dtype=np.float32) + 0.5)
    rt = d(rng.standard_normal(t, dtype=np.float32))
    seg = torch.zeros(1, dtype=torch.int32, device=dev)
    kernel = gk.gram_gather(table, nb, wt, rt, seg, num_segments=1,
                            tile_rows=t)
    g = gk.gather_rows_plain(table, nb, wt)
    return compare(kernel, versions(g, rt, seg, 1, t))


def ials_b(dev) -> dict:
    import numpy as np
    import torch

    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.ops.bucketed import ials_reparam
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk

    ds = Dataset.from_coo(synthetic_netflix_coo(162_541, 59_047, 25_000_095,
                                                seed=0),
                          layout="bucketed", chunk_elems=524_288)
    rng = np.random.default_rng(0)
    tables = {side: torch.as_tensor(rng.random((n, 128), dtype=np.float32),
                                    device=dev)
              for side, n in (("user", 162_541), ("movie", 59_047))}
    rows_out, worst = [], {}
    for side, blocks, table in (("movie", ds.movie_blocks, tables["user"]),
                                ("user", ds.user_blocks, tables["movie"])):
        for bk in blocks.buckets:
            nb = torch.as_tensor(bk.neighbor_idx, device=dev)
            mk = torch.as_tensor(bk.mask, device=dev)
            wt, rt = ials_reparam(torch.as_tensor(bk.rating, device=dev), mk,
                                  40.0)
            rows, t = int(nb.shape[0]), int(bk.width)
            seg = torch.arange(rows, dtype=torch.int32, device=dev)
            nb, wt, rt = nb.reshape(-1), wt.reshape(-1), rt.reshape(-1)
            kernel = gk.gram_gather(table, nb, wt, rt, seg,
                                    num_segments=rows, tile_rows=t)
            g = gk.gather_rows_plain(table, nb, wt)
            row = dict(side=side, width=t, rows=rows,
                       **compare(kernel, versions(g, rt, seg, rows, t)))
            rows_out.append(row)
            for key, v in row.items():
                if isinstance(v, float):
                    worst[key] = max(worst.get(key, 0.0), v)
            del g, kernel
    return {"worst": worst,
            "width_4096_movie": next(r for r in rows_out
                                     if r["side"] == "movie"
                                     and r["width"] == 4096),
            "head_class": max(rows_out, key=lambda r: r["width"]),
            "classes": rows_out}


def tiled(dev, nnz: int, cache) -> dict:
    import torch

    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.models.als import _tiled_device_setup
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk
    from cfk_tpu_torch.ops.tiled import accum_chunk

    cache = Path(cache) if cache else None
    if cache is not None and cache.exists():
        with cache.open("rb") as fh:
            ds = pickle.load(fh)
    else:
        ds = Dataset.from_coo(synthetic_netflix_coo(480_189, 17_770, nnz,
                                                    seed=0),
                              layout="tiled", chunk_elems=1 << 20,
                              dense_stream=True)
        if cache is not None:
            with cache.open("wb") as fh:
                pickle.dump(ds, fh, protocol=pickle.HIGHEST_PROTOCOL)
    blk_m, _, _ = _tiled_device_setup(ds, dev)
    u = torch.randn((ds.user_blocks.padded_entities, 64), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    st = ds.movie_blocks.statics
    equal, worst = 0, 0.0
    for c in range(st[0]):
        a = accum_chunk(blk_m, st, c)
        g = gk.gather_rows_plain(u, a["nb"], a["wt"])
        t, k = a["tile_rows"], g.shape[-1]
        # Per tile: the segment sums' index_add_ adds in no fixed order on
        # the card, so two calls of one version may differ after it.
        pairs = list(zip(gk._tile_sums(g.view(-1, t, k),
                                       a["rt"].view(-1, t)),
                         whole(g, a["rt"], t, False)))
        equal += all(bool((x == y).all()) for x, y in pairs)
        worst = max([worst] + [rel(x, y) for x, y in pairs])
    return dict(chunks=st[0], tile_rows=st[2], blocks_equal_whole=equal,
                blocks_vs_whole_worst=worst)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nnz", type=int, default=10_000_000)
    ap.add_argument("--cache", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("plain_gram_drift: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    out = dict(bucket8=bucket8(dev), tiled=tiled(dev, args.nnz, args.cache),
               ials_b=ials_b(dev))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
