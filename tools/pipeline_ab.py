"""Captured against uncaptured training iterations, and iALS (b)'s device
time an iteration, on the card.

    python3 tools/pipeline_ab.py [--tree DIR] [--label NAME]
        [--routes R1,R2,...] [--iterations 7,15] [--part routes|bucketed]

``--part routes`` (the default; the tree must have ``ops.pipeline``): for
each route, the same configuration trained from the same start with the
chunk pipeline on and ``capture`` True (iteration 1 eager, the rest replays
of one captured CUDA graph) and False (every iteration eager, the gather-off
K5 fetch on a side stream), at each count of ``--iterations``, the two in
turns (captured first at the first count, second at the next).  Each run
times ``models.als.run_iterations`` alone (host clock, ending in a sync:
the capture included, the upload not), after one untimed one-iteration run
of the route warms it.  Per run: the loop's seconds and s/iter, the route
taken, the capture and instantiation seconds, the graph's pool, and for a
captured run iteration 1's seconds and the replays' (each ending in a
sync); the segment and rank-256 routes, seconds an iteration, run only the
counts up to ``--slow-max`` (7); per pair,
whether the factors are bit-equal (and else their largest relative
difference); for the captured run at the
first count, what a replay launches against what the capture recorded
(``ops.pipeline.replay_launches``).  Routes (``chip_smoke.py``'s shapes):
``netflix`` (the main path: the Netflix shape, 100,480,507 ratings, seed 0,
tiled with the dense stream, rank 64, λ 0.05), ``netflix_gather_off`` (the
same, ``in_kernel_gather=False``), ``segment`` (the same ratings on the
segment layout at 2²⁰ cells), ``rank256`` (the main path at rank 256),
and on the ML-25M shape (162,541 × 59,047, 25,000,095 interactions, seed
0; rank 128, λ 0.1, α 40, u0 ~ U(0, 1) from seed 0) ``ials_a`` (tiled,
49,152-entry chunks, dense stream), ``ials_b`` (bucketed, 524,288),
``ialspp_c`` (iALS++ on (b)'s blocks, b = 32), ``ials_d`` ((a) split) and
``ials_e`` (tiled stream mode).

``--part bucketed`` (any tree of the port with ``_build.build_all`` and the
ML-25M-shape bucketed layout, so an older tree too): iALS (b) trained
for one iteration from u0, ``--reps`` times after one untimed call, each
call profiled by torch.profiler (CUDA activity only): the union of its
kernels' intervals in ms (the upload's few small kernels included, its
copies not), the kernels counted, and the top kernels by time.  For
comparing two trees (``--tree``) in one call: A, B, B, A.

Prints the card (``nvidia-smi``) and one JSON line a route or part.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

NETFLIX = dict(num_users=480_189, num_movies=17_770, nnz=100_480_507)
ML25M = dict(num_users=162_541, num_movies=59_047, nnz=25_000_095)
IMPLICIT = dict(rank=128, lam=0.1, alpha=40.0, tiled_chunk=49_152,
                bucketed_chunk=524_288, block_size=32)
NETFLIX_ROUTES = ("netflix", "netflix_gather_off", "segment", "rank256")
ML25M_ROUTES = ("ials_a", "ials_b", "ialspp_c", "ials_d", "ials_e")
SLOW = ("segment", "rank256")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def emit(row: dict) -> None:
    print(json.dumps(row, default=str), flush=True)


def rel_diff(a, b) -> float:
    import torch

    a, b = a.float(), b.float()
    scale = float(torch.abs(b).max()) or 1.0
    return float(torch.abs(a - b).max()) / scale


def netflix_cases(routes):
    """(name, dataset, config, warm start, implicit) of the Netflix-shape
    routes asked for."""
    from cfk_tpu_torch import ALSConfig, Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(**NETFLIX, seed=0)
    tiled = Dataset.from_coo(coo, layout="tiled", chunk_elems=1 << 20,
                             dense_stream=True)
    base = dict(lam=0.05, seed=0, layout="tiled")
    for name in routes:
        if name == "netflix":
            yield name, tiled, ALSConfig(rank=64, **base), None, False
        elif name == "netflix_gather_off":
            yield name, tiled, ALSConfig(rank=64, in_kernel_gather=False,
                                         **base), None, False
        elif name == "rank256":
            yield name, tiled, ALSConfig(rank=256, **base), None, False
        elif name == "segment":
            seg = Dataset.from_coo(tiled.coo_dense, layout="segment",
                                   chunk_elems=1 << 20)
            yield name, seg, ALSConfig(rank=64, lam=0.05, seed=0,
                                       layout="segment"), None, False
            del seg


def ml25m_data():
    import numpy as np

    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(**ML25M, seed=0)
    k = IMPLICIT["rank"]
    u0 = np.random.default_rng(0).random((ML25M["num_users"], k),
                                         dtype=np.float32)
    m0 = np.zeros((ML25M["num_movies"], k), np.float32)
    return coo, (u0, m0)


def ml25m_cases(routes):
    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.models.ials import IALSConfig

    coo, warm = ml25m_data()
    c = IMPLICIT
    sets = {}

    def data(kind):
        if kind not in sets:
            if kind == "bucketed":
                sets[kind] = Dataset.from_coo(
                    coo, layout="bucketed", chunk_elems=c["bucketed_chunk"])
            else:
                sets[kind] = Dataset.from_coo(
                    coo, layout="tiled", chunk_elems=c["tiled_chunk"],
                    dense_stream=kind == "dense")
        return sets[kind]

    for name in routes:
        kind, layout, knobs = {
            "ials_a": ("dense", "tiled", {}),
            "ials_b": ("bucketed", "bucketed", {}),
            "ialspp_c": ("bucketed", "bucketed", dict(algorithm="ials++")),
            "ials_d": ("dense", "tiled", dict(fused_epilogue=False)),
            "ials_e": ("stream", "tiled", {}),
        }[name]
        config = IALSConfig(rank=c["rank"], lam=c["lam"], alpha=c["alpha"],
                            layout=layout, block_size=c["block_size"],
                            **knobs)
        yield name, data(kind), config, warm, True


def run_route(name, ds, config, warm, implicit, counts) -> dict:
    import dataclasses

    import torch

    from cfk_tpu_torch.models.als import (
        als_steps,
        base_overrides,
        run_iterations,
    )
    from cfk_tpu_torch.models.ials import ials_steps
    from cfk_tpu_torch.ops.pipeline import replay_launches

    steps = ials_steps if implicit else als_steps
    dev = torch.device("cuda")

    def once(iters, capture):
        cfg = dataclasses.replace(config, num_iterations=iters,
                                  capture=capture)
        make_step, u, m = steps(ds, cfg, dev, warm)
        step = make_step(base_overrides(cfg))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, m, pipe = run_iterations(step, u, m, cfg, dev)
        loop_s = time.perf_counter() - t0
        del step, make_step
        return u, m, pipe, loop_s

    once(1, False)  # warm-up: cuBLAS handles, kernel loads, the allocator
    row = dict(route=name, card=card(), runs=[])
    for j, iters in enumerate(counts):
        res = {}
        order = (True, False) if j % 2 == 0 else (False, True)
        for capture in order:
            torch.cuda.empty_cache()
            u, m, pipe, loop_s = once(iters, capture)
            stats = {key: pipe.get(key) for key in (
                "route", "capture_s", "instantiate_s", "graph_pool_bytes",
                "eager_s", "replays_s", "graph_walk_s")}
            if pipe.get("replays"):
                stats["s_per_replay"] = pipe["replays_s"] / pipe["replays"]
            if capture and j == 0:
                stats["replay_launches"] = replay_launches(pipe)
                stats["launches_per_replay"] = pipe.get("launches_per_replay")
                stats["graph_kernels"] = pipe.get("graph_kernels")
            res[capture] = (u, m, dict(loop_s=loop_s,
                                       s_per_iter=loop_s / iters, **stats))
        (u1, m1, on), (u0, m0, off) = res[True], res[False]
        row["runs"].append(dict(
            iterations=iters, order=["captured" if c else "uncaptured"
                                     for c in order],
            captured=on, uncaptured=off,
            bit_equal=bool(torch.equal(u1, u0) and torch.equal(m1, m0)),
            max_rel_diff=max(rel_diff(u1, u0), rel_diff(m1, m0)),
            gain_s_per_iter=off["s_per_iter"] - on["s_per_iter"]))
        del res, u1, m1, u0, m0
    return row


def routes_part(args) -> None:
    import torch

    from cfk_tpu_torch import _build

    t0 = time.perf_counter()
    _build.build_all()
    emit(dict(part="build", tree=args.label, build_s=time.perf_counter() - t0))
    counts = [int(n) for n in args.iterations.split(",")]
    routes = args.routes.split(",")
    for group, cases in ((NETFLIX_ROUTES, netflix_cases),
                         (ML25M_ROUTES, ml25m_cases)):
        wanted = [r for r in routes if r in group]
        if not wanted:
            continue
        for name, ds, config, warm, implicit in cases(wanted):
            row = run_route(name, ds, config, warm, implicit,
                            [n for n in counts if name not in SLOW
                             or n <= args.slow_max])
            row["tree"] = args.label
            emit(row)
            torch.cuda.empty_cache()


def bucketed_part(args) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cfk_tpu_torch import Dataset, _build
    from cfk_tpu_torch.models.ials import IALSConfig, train_ials

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    coo, warm = ml25m_data()
    c = IMPLICIT
    ds = Dataset.from_coo(coo, layout="bucketed",
                          chunk_elems=c["bucketed_chunk"])
    config = IALSConfig(rank=c["rank"], lam=c["lam"], alpha=c["alpha"],
                        num_iterations=1, layout="bucketed",
                        block_size=c["block_size"])
    dev = torch.device("cuda")
    train_ials(ds, config, device=dev, warm_start=warm)
    torch.cuda.synchronize()
    calls = []
    for _ in range(args.reps):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            train_ials(ds, config, device=dev, warm_start=warm)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"]
                          if e.get("ph") == "X" and e.get("cat") == "kernel"]
        spans, by_name = [], {}
        for e in events:
            a, dur = float(e["ts"]), float(e["dur"])
            spans.append((a, a + dur))
            key = e["name"][:60]
            by_name[key] = by_name.get(key, 0.0) + dur / 1e3
        busy, last = 0.0, None
        for a, b in sorted(spans):
            if last is None or a > last[1]:
                if last is not None:
                    busy += last[1] - last[0]
                last = [a, b]
            else:
                last[1] = max(last[1], b)
        if last is not None:
            busy += last[1] - last[0]
        calls.append(dict(kernel_ms=busy / 1e3, kernels=len(spans),
                          top=sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:6]))
    emit(dict(part="bucketed", tree=args.label, card=card(),
              build_s=build_s, calls=calls,
              kernel_ms=[x["kernel_ms"] for x in calls]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="change")
    ap.add_argument("--part", choices=("routes", "bucketed"),
                    default="routes")
    ap.add_argument("--routes",
                    default=",".join(NETFLIX_ROUTES + ML25M_ROUTES))
    ap.add_argument("--iterations", default="7,15")
    ap.add_argument("--slow-max", type=int, default=7,
                    help="the largest count the segment and rank-256 "
                    "routes run (seconds an iteration, not tenths)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    (routes_part if args.part == "routes" else bucketed_part)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
