"""GPU smoke run of the PyTorch + CUDA port (cfk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile the four CUDA kernels from cfk_tpu_torch/csrc (one nvcc
             per source, in parallel);
2. main    — train explicit ALS-WR with ``train_als`` at the Netflix Prize
             shape (480,189 users x 17,770 movies x 100,480,507 synthetic
             ratings, seed 0), tiled layout (accum movie half + dense-stream
             user half), rank 64, lambda 0.05, float32, 3 iterations; every
             kernel's launch counter is zeroed just before and read just
             after, and each must be > 0; factors must be finite and the
             train RMSE below the ratings' standard deviation;
3. kernels — each kernel against its plain PyTorch version on the card at
             main-path shapes (K1: the movie half's E = 17,770 accumulated
             Grams at k = 64 with their real counts, and count-scaled random
             Grams at k = 128; K2, K3: one real chunk of the full-shape
             dataset at k = 64; the trained factors as the table throughout),
             with its time, the plain
             version's time, a one-call library yardstick where one exists
             and the card's bound for the same work;
4. breakdown — where one iteration's time goes (measurement, no checks):
             each kernel's device time per chunk beside the rows of the
             chunk's largest segment and the summed bound, and a
             torch.profiler pass over one iteration;
5. serve   — top-K serving at the repo's serving configuration (``bench.py
             --serve``: 162,541 users x 59,047 movies, the ML-25M shape,
             rank 128, K = 100, tile_m 2048, seen lists at the ML-25M mean;
             factors and seen CSR from ``serve_factors``/``serve_seen_csr``,
             seed 0): exact mode at batches 16, 64, 256 with an f32 table,
             bf16 and int8 tables at 256, two-stage at 256 (1024 clusters).
             Per configuration K4's count is zeroed, ``ServeEngine.topk`` and
             an open-loop run through ``RecommendServer`` (70% of the
             measured capacity, 256 requests) drive it, and the count must be
             > 0; then K4 on that batch's own arguments against its plain
             version, exact-mode ids against the dense route, no [B, M]
             allocation during a K4 call, times, and two-stage recall@100 vs
             the same engine's exact scan (>= 0.95, no fallback);
6. small   — ``train_als`` on small padded and tiled datasets, kernels on the
             card against the plain versions on the CPU;
7. cli     — ``python -m cfk_tpu_torch train --layout auto --checkpoint-dir``
             on a small Netflix-format file (padded is chosen), then
             ``recommend``, ``predict``, ``evaluate`` on predict's CSV (the
             train MSE again) and ``serve`` (every request answered).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and,
as its last line, ``{"ok": true, "device": {...}}``.  Exits non-zero without
that line if there is no CUDA device or any phase fails.  Details go to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores
NETFLIX = dict(num_users=480_189, num_movies=17_770, nnz=100_480_507)
RANK, LAM, ITERS = 64, 0.05, 3
# Kernel vs plain, max |difference| over max |plain|: float32 on both sides
# in different summation orders.  Gram sums 1e-4; solves 1e-3 (the Cholesky
# solves of systems with condition numbers up to ~1e3 amplify the rounding).
# K4: scores within 1e-5 of the largest |score|, ids equal except at
# near-ties (``compare_topk``) — float32 dot products in another order.
TOL = {"reg_solve": 1e-3, "gram_gather": 1e-4, "gram_solve_dense": 1e-3,
       "topk_scores": 1e-5}
REPLACES = {
    "reg_solve": "cfk_tpu/ops/pallas/solve_kernel.py:287",
    "gram_gather": "cfk_tpu/ops/pallas/gram_kernel.py:1422",
    "gram_solve_dense": "cfk_tpu/ops/pallas/gram_kernel.py:1764",
    "topk_scores": "cfk_tpu/serving/topk_kernel.py:215",
}
# bench.py --serve's configuration (bench.py:3236-3262).
SERVE = dict(num_users=162_541, num_movies=59_047, nnz=25_000_095,
             rank=128, k=100, tile_m=2048, requests=256, clusters=1024)
SERVE_CONFIGS = (("exact", "float32", 16), ("exact", "float32", 64),
                 ("exact", "float32", 256), ("exact", "bfloat16", 256),
                 ("exact", "int8", 256), ("two_stage", "float32", 256))


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def reg_solve_work(e: int, k: int) -> tuple[float, float]:
    """(bytes, flops) of K1 on e systems: read A, b, counts once, write x;
    Cholesky k³/3 + two triangular solves 2k² + ridge k."""
    return 4 * e * (k * k + 2 * k + 1), e * (k ** 3 / 3 + 2 * k * k + k)


def gram_gather_work(table, args) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K2 on one chunk: the distinct table rows the
    live entries reference, nb/wt/rt/seg once, (A, b) written once; k² + 3k
    flops per live row — what the function needs: the symmetric Gram's
    k(k+1)/2 multiply-adds and b's k (the kernel computes the full Gram)."""
    import torch

    f, k = table.shape
    nb = args["nb"].long()
    live = (nb < f) & (args["wt"] != 0)
    n_live = int(live.sum())
    rows = int(torch.unique(nb[live]).numel())
    s = args["num_segments"]
    return (4 * (rows * k + 3 * nb.numel() + args["seg"].numel()
                 + s * (k * k + k)),
            n_live * (k * k + 3 * k),
            dict(chunk_rows=nb.numel(), live_rows=n_live,
                 distinct_table_rows=rows, segments=s))


def gram_solve_dense_work(table, args) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K3 on one chunk: the distinct table rows,
    nb/rt/meta/reg once, x and the carry pair; k² + 3k flops per live row
    inside a tile window (symmetric Gram + b, as for K2) plus k³/3 + 2k² + k
    per segment solve."""
    import torch

    f, k = table.shape
    t, nt, ng, bg = (args[n] for n in ("tile_rows", "num_tiles",
                                         "num_groups", "block_rows"))
    meta = args["meta"].long()
    lo, hi = meta[ng + nt:ng + 2 * nt], meta[ng + 2 * nt:ng + 3 * nt]
    absrow = meta[:ng].repeat_interleave(nt // ng) * bg + meta[ng:ng + nt]
    r = torch.arange(t, device=meta.device)
    in_win = (r[None, :] >= lo[:, None]) & (r[None, :] < hi[:, None])
    nb = args["nb"].long()
    n_win = int((nb[(absrow[:, None] + r[None, :])[in_win]] < f).sum())
    rows = int(torch.unique(nb[nb < f]).numel())
    s = args["num_segments"]
    return (4 * (rows * k + nb.numel() + nt * t + meta.numel() + s
                 + s * k + 2 * (k * k + k)),
            n_win * (k * k + 3 * k) + s * (k ** 3 / 3 + 2 * k * k + k),
            dict(chunk_rows=nb.numel(), window_rows=n_win,
                 distinct_table_rows=rows, segments=s))


def topk_scores_work(args, kw, n: int) -> tuple[float, float, dict]:
    """(bytes, flops, counts) of K4 on one batch of ``n`` real users: only
    the live table rows (global id ``row_offset + row`` below ``num_movies``
    — padding rows cannot change the result) at the table's row bytes
    (``serve_batch_cost``: the int8 scale included), the [n, k] batch in, the
    [n, K] result out and the batch's real seen entries (in-tile columns
    below ``tile_m``) once each; 2·n·rows·k flops."""
    from cfk_tpu_torch.utils.roofline import serve_batch_cost

    _, table, _, seen = args
    m_pad, rank = table.shape
    live = min(max(kw["num_movies"] - kw.get("row_offset", 0), 0), m_pad)
    td = {"torch.float32": "float32", "torch.bfloat16": "bfloat16",
          "torch.int8": "int8"}[str(table.dtype)]
    cost = serve_batch_cost(live, rank, n, kw["k_top"], table_dtype=td,
                            m_pad=live)
    seen_cells = 0 if seen is None else int((seen[:, :n] < kw["tile_m"]).sum())
    return (cost.hbm_bytes + 4 * seen_cells, cost.model_flops,
            dict(live_rows=live, padded_rows=m_pad, seen_cells=seen_cells))


def profile_calls(fn, n: int) -> dict:
    """Where ``n`` calls of ``fn`` spend their time (measurement only):
    host wall ms per call, device-busy ms per call from torch.profiler's
    kernel rows, the idle share, and the top device rows.  Returns
    ``{"error": ...}`` if the profiler cannot trace the card."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        rows = []
        for evt in prof.key_averages():
            dev_us = getattr(evt, "self_device_time_total", 0) or 0
            if dev_us > 0 and not evt.key.startswith("aten::"):
                rows.append((evt.key[:60], dev_us / 1e3 / n, evt.count / n))
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        return dict(wall_ms=wall_ms, device_busy_ms=busy,
                    idle_share=1 - busy / wall_ms, top=rows[:8])
    except Exception:  # measurement only: keep the smoke's verdict
        return {"error": traceback.format_exc()[-400:]}


def dense_route(args, kw):
    """The library yardstick for K4's arguments: [B, M_pad] 0/−inf mask
    bias for padding and seen rows, the operands as K4 scores them
    (dequantized table, u rounded to bf16 for a bf16 table), and the two
    calls ``torch.topk(torch.addmm(bias, u, tableᵀ), K)`` — which write the
    [B, M_pad] matrix K4 never does."""
    import torch

    from cfk_tpu_torch.ops.quant import dequantize_table
    from cfk_tpu_torch.serving.topk_kernel import serve_compute_dtype

    u, table, scale, seen = args
    b, m_pad, tile_m = u.shape[0], table.shape[0], kw["tile_m"]
    bias = torch.zeros((b, m_pad + 1), device=u.device)
    gid = kw.get("row_offset", 0) + torch.arange(m_pad, device=u.device)
    bias[:, :m_pad].masked_fill_((gid >= kw["num_movies"])[None, :],
                                 float("-inf"))
    if seen is not None:
        c = seen.long()
        col = torch.where(
            c < tile_m,
            c + tile_m * torch.arange(c.shape[0], device=u.device)[:, None,
                                                                   None],
            m_pad)
        bias.scatter_(1, col.permute(1, 0, 2).reshape(b, -1),
                      float("-inf"))
    bias = bias[:, :m_pad].contiguous()
    uf = u.to(serve_compute_dtype(table.dtype)).float()
    tf = dequantize_table(table, scale).float()

    def call(k_top=kw["k_top"]):
        return torch.topk(torch.addmm(bias, uf, tf.T), k_top, dim=1)

    return call


class Smoke:
    def __init__(self):
        self.failures: list[str] = []
        self.report: dict = {}
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn, *args):
        log(f"phase {name} ...")
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase fails the run, after the others
            self.failures.append(f"{name}: {traceback.format_exc()}")
            log(f"phase {name} FAILED:\n{traceback.format_exc()}")
            return None
        log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
        self.report.setdefault("phase_s", {})[name] = time.perf_counter() - t0
        return out

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.failures.append(what)
            log(f"CHECK FAILED: {what}")

    # -- phases -------------------------------------------------------------

    def build(self):
        from cfk_tpu_torch import _build

        t0 = time.perf_counter()
        paths = _build.build_all()
        self.report["build_s"] = time.perf_counter() - t0
        for name in paths:
            log((_build.BUILD_DIR / f"{name}.ptxas.txt").read_text().strip()
                .replace("\n", " | ")[-600:])

    def main_path(self):
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
        from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
        from cfk_tpu_torch.models.als import _tiled_device_setup
        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_solve_dense)
        from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
        from cfk_tpu_torch.ops.tiled import tiled_half_step

        t0 = time.perf_counter()
        coo = synthetic_netflix_coo(**NETFLIX, seed=0)
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=1 << 20)
        build_s = time.perf_counter() - t0
        mb, ub = ds.movie_blocks, ds.user_blocks
        log(f"data: generate {gen_s:.1f} s, blocks {build_s:.1f} s; movie "
            f"{mb.mode} {mb.statics} slices={mb.num_slices}, user {ub.mode} "
            f"{ub.statics}")
        self.check(mb.mode == "accum" and ub.mode == "dstream",
                   f"layout modes {mb.mode}/{ub.mode} != accum/dstream")
        config = ALSConfig(rank=RANK, lam=LAM, num_iterations=ITERS,
                           seed=0, layout="tiled")
        dev = torch.device("cuda")
        torch.cuda.reset_peak_memory_stats()
        for fn in (reg_solve, gram_gather, gram_solve_dense):
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = train_als(ds, config, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches
                    for fn in (reg_solve, gram_gather, gram_solve_dense)}
        peak = torch.cuda.max_memory_allocated()
        for name, n in launches.items():
            self.check(n > 0, f"main path launched {name} {n} times")
        u, m = model.user_factors, model.movie_factors
        self.check(tuple(u.shape) == (NETFLIX["num_users"], RANK)
                   and tuple(m.shape) == (NETFLIX["num_movies"], RANK),
                   f"factor shapes {tuple(u.shape)} {tuple(m.shape)}")
        self.check(bool(torch.isfinite(u).all() and torch.isfinite(m).all()),
                   "non-finite factors")
        mse, rmse = mse_rmse_from_model(model, ds)
        std = float(np.std(coo.rating.astype(np.float64)))
        self.check(rmse < std, f"train RMSE {rmse} >= rating std {std}")
        # Where one iteration's time goes: each half alone, device-timed.
        blk_m, blk_u, kw = _tiled_device_setup(ds, dev)
        half_ms = {
            "movie_accum": time_ms(lambda: tiled_half_step(
                u, blk_m, kw["m_chunks"], kw["m_entities"], LAM), 1),
            "user_dstream": time_ms(lambda: tiled_half_step(
                m, blk_u, kw["u_chunks"], kw["u_entities"], LAM), 1),
        }
        self.report["main"] = dict(
            shape=NETFLIX, rank=RANK, lam=LAM, iterations=ITERS,
            generate_s=gen_s, blocks_s=build_s, train_s=train_s,
            s_per_iter=train_s / ITERS, half_ms=half_ms, train_mse=mse,
            train_rmse=rmse, rating_std=std, peak_device_bytes=peak,
            launches=launches,
            launches_per_iter={k: v / ITERS for k, v in launches.items()},
            movie_statics=list(mb.statics), user_statics=list(ub.statics),
            movie_slices=mb.num_slices,
        )
        log(f"main: {train_s / ITERS:.3f} s/iter, halves {half_ms} ms, RMSE "
            f"{rmse:.4f} (rating std {std:.4f}), peak {peak / 2**30:.2f} GiB,"
            f" launches {launches}")
        for name, n in launches.items():
            self.kernels.setdefault(name, {})["launches"] = n
        return ds, model, blk_m, blk_u

    def breakdown(self, ds, model, blk_m, blk_u):
        """Where one iteration's time goes (measurement only, no checks):
        each kernel's device time per chunk beside the rows of the chunk's
        largest segment (one CTA walks each segment, so the largest one is
        the chunk's critical path), and a torch.profiler pass over one
        iteration summed by kernel."""
        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_solve_dense)
        from cfk_tpu_torch.ops.tiled import (
            accum_chunk, dense_chunk, tiled_half_step)

        u, m = model.user_factors, model.movie_factors

        def chunk_ms(calls):
            events = []
            for call in calls:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            return np.array([s.elapsed_time(e) for s, e in events])

        st_m = ds.movie_blocks.statics
        args_m = [accum_chunk(blk_m, st_m, c) for c in range(st_m[0])]
        ms_m = chunk_ms([lambda a=a: gram_gather(u, **a) for a in args_m])
        big_m = np.array([  # tiles of the largest real segment x T
            int(torch.bincount(a["seg"], minlength=st_m[4] + 1)[:st_m[4]]
                .max()) * st_m[2] for a in args_m])
        st_u = ds.user_blocks.statics
        _, _, _, t, nt, ng, _ = st_u
        args_u = [dense_chunk(blk_u, st_u, c) for c in range(st_u[0])]
        for a in args_u:
            a.pop("cin")
        ms_u = chunk_ms([lambda a=a: gram_solve_dense(m, **a, lam=LAM)
                         for a in args_u])
        big_u = []
        for a in args_u:
            meta = a["meta"].long()
            win = meta[ng + 2 * nt:ng + 3 * nt] - meta[ng + nt:ng + 2 * nt]
            big_u.append(int(torch.bincount(meta[ng + 3 * nt:],
                                            weights=win.double()).max()))
        big_u = np.array(big_u)

        def summary(ms, big, work):
            order = np.argsort(ms)
            return dict(total_ms=float(ms.sum()), min_ms=float(ms.min()),
                        median_ms=float(np.median(ms)), max_ms=float(ms.max()),
                        bound_ms=float(sum(bound(b, f)[0] for b, f, _ in work)),
                        ns_per_row_of_largest_segment=float(
                            np.median(ms / np.maximum(big, 1)) * 1e6),
                        corr_ms_vs_largest_segment=float(
                            np.corrcoef(ms, big)[0, 1]),
                        slowest=[(float(ms[i]), int(big[i]))
                                 for i in order[-3:]])

        self.report["chunks"] = dict(
            gram_gather=summary(ms_m, big_m,
                                [gram_gather_work(u, a) for a in args_m]),
            gram_solve_dense=summary(
                ms_u, big_u, [gram_solve_dense_work(m, a) for a in args_u]))
        log(f"per-chunk kernel time vs largest segment rows: "
            f"{self.report['chunks']}")
        kw = dict(m_chunks=("tiled", "accum") + st_m,
                  u_chunks=("tiled", "dstream") + st_u)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                m1 = tiled_half_step(u, blk_m, kw["m_chunks"],
                                     ds.movie_blocks.padded_entities, LAM)
                tiled_half_step(m1, blk_u, kw["u_chunks"],
                                ds.user_blocks.padded_entities, LAM)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows = []
            for evt in prof.key_averages():
                dev_us = getattr(evt, "self_device_time_total", 0) or 0
                # aten:: rows repeat the device time of their own kernels
                if dev_us > 0 and not evt.key.startswith("aten::"):
                    rows.append((evt.key[:60], dev_us / 1e3, evt.count))
            rows.sort(key=lambda r: -r[1])
            busy = sum(r[1] for r in rows)
            self.report["profile"] = dict(
                wall_ms=wall_ms, device_busy_ms=busy,
                idle_share=1 - busy / wall_ms if wall_ms else None,
                top=rows[:12])
            log(f"profile of one iteration: {self.report['profile']}")
        except Exception:  # measurement only: keep the smoke's verdict
            log(f"profiler unavailable: {traceback.format_exc()}")

    def kernel_checks(self, ds, model, blk_m, blk_u):
        import torch

        from cfk_tpu_torch.ops.kernels.gram_kernel import (
            gram_gather, gram_gather_plain, gram_solve_dense,
            gram_solve_dense_plain)
        from cfk_tpu_torch.ops.kernels.solve_kernel import (
            add_ridge_plain, reg_solve, reg_solve_plain)
        from cfk_tpu_torch.ops.tiled import accum_chunk, accum_grams, dense_chunk

        dev = torch.device("cuda")
        k = RANK
        u, m = model.user_factors, model.movie_factors
        # K1 at k = 64 on the main path's own operands: the movie half's
        # accumulated Grams of the trained U table (what the next iteration
        # solves) with the real counts.  At k = 128, random Grams of 2k rows
        # scaled by the same counts, so the Gram outweighs the λ·n ridge.
        counts = blk_m["count"]
        a64, b64 = accum_grams(u, blk_m, ds.movie_blocks.padded_entities,
                               statics=ds.movie_blocks.statics)
        gen = torch.Generator(device=dev).manual_seed(128)
        x = torch.randn((counts.shape[0], 256, 128), generator=gen, device=dev)
        a128 = torch.einsum("enk,enl->ekl", x, x) * (
            counts.clamp_min(1).float() / 256)[:, None, None]
        b128 = torch.randn((counts.shape[0], 128), generator=gen, device=dev)
        del x
        for kk, a, b in ((64, a64, b64), (128, a128, b128)):
            e = a.shape[0]
            got = reg_solve(a, b, counts, lam=LAM)
            torch.cuda.synchronize()
            want = reg_solve_plain(a, b, counts, lam=LAM)
            err, rel = rel_err(got, want)
            ms = time_ms(lambda: reg_solve(a, b, counts, lam=LAM), 20)
            plain_ms = time_ms(lambda: reg_solve_plain(a, b, counts, lam=LAM), 5)
            lib_ms = time_ms(lambda: torch.linalg.solve(
                add_ridge_plain(a, counts, lam=LAM, reg_mode="diag"), b), 5)
            b_ms, by = bound(*reg_solve_work(e, kk))
            row = dict(max_abs_err=err, rel_err=rel, ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=b_ms, bound_by=by, e=e, k=kk,
                       operands="main path accum Grams" if kk == k
                       else "count-scaled random Grams")
            self.report.setdefault("reg_solve", {})[f"k{kk}"] = row
            log(f"K1 reg_solve k={kk}: {row}")
            self.check(rel < TOL["reg_solve"],
                       f"reg_solve k={kk} rel err {rel} >= {TOL['reg_solve']}")
            if kk == k:
                self.kernels.setdefault("reg_solve", {}).update(row)
            del got, want
        del a64, b64, a128, b128, a, b

        # K2: the middle accum chunk of the movie half, the trained U table.
        st = ds.movie_blocks.statics
        args = accum_chunk(blk_m, st, st[0] // 2)
        got = gram_gather(u, **args)
        torch.cuda.synchronize()
        want = gram_gather_plain(u, **args)
        err_a, rel_a = rel_err(got[0], want[0])
        err_b, rel_b = rel_err(got[1], want[1])
        ms = time_ms(lambda: gram_gather(u, **args), 10)
        plain_ms = time_ms(lambda: gram_gather_plain(u, **args), 3)
        nbytes, flops, counts = gram_gather_work(u, args)
        b_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=max(err_a, err_b), rel_err=max(rel_a, rel_b),
                   ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                   bound_by=by, **counts)
        self.kernels.setdefault("gram_gather", {}).update(row)
        log(f"K2 gram_gather: {row}")
        self.check(row["rel_err"] < TOL["gram_gather"],
                   f"gram_gather rel err {row['rel_err']}")
        del got, want

        # K3: the middle dense chunk of the user half, the trained M table,
        # with the carry the real previous chunk hands it.
        st = ds.user_blocks.statics
        c = st[0] // 2
        a0 = torch.zeros((k, k), device=dev)
        b0 = torch.zeros((k,), device=dev)
        for ci in range(c):
            prev = dense_chunk(blk_u, st, ci)
            cin = prev.pop("cin")
            _, a0, b0 = gram_solve_dense_plain(m, **prev, lam=LAM,
                                               carry=(a0, b0, cin))
        args = dense_chunk(blk_u, st, c)
        cin = args.pop("cin")
        carry = (a0, b0, cin)
        got = gram_solve_dense(m, **args, lam=LAM, carry=carry)
        torch.cuda.synchronize()
        want = gram_solve_dense_plain(m, **args, lam=LAM, carry=carry)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        ms = time_ms(lambda: gram_solve_dense(m, **args, lam=LAM,
                                              carry=carry), 10)
        plain_ms = time_ms(lambda: gram_solve_dense_plain(
            m, **args, lam=LAM, carry=carry), 3)
        nbytes, flops, counts = gram_solve_dense_work(m, args)
        b_ms, by = bound(nbytes, flops)
        row = dict(max_abs_err=max(x[0] for x in errs),
                   rel_err=max(x[1] for x in errs), ms=ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=by, **counts)
        self.kernels.setdefault("gram_solve_dense", {}).update(row)
        log(f"K3 gram_solve_dense: {row}")
        self.check(row["rel_err"] < TOL["gram_solve_dense"],
                   f"gram_solve_dense rel err {row['rel_err']}")

    def serve(self):
        import numpy as np
        import torch

        from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
        from cfk_tpu_torch.serving import (
            RecommendServer,
            ServeClient,
            ServeEngine,
            default_two_stage_params,
            ensure_serve_topics,
            recall_at_k,
            run_open_loop,
            warm_serve_programs,
            zipf_user_rows,
        )
        from cfk_tpu_torch.serving import engine as engine_mod
        from cfk_tpu_torch.serving import twostage as twostage_mod
        from cfk_tpu_torch.serving.topk_kernel import (
            topk_scores,
            topk_scores_plain,
        )
        from cfk_tpu_torch.transport.broker import InMemoryBroker

        sys.path.insert(0, str(ROOT / "tests"))
        from _torch_topk import compare_topk

        s = SERVE
        nu, nm, k = s["num_users"], s["num_movies"], s["k"]
        t0 = time.perf_counter()
        # bench.py run_serve's seeds at --seed 0: traffic 3, pool 1, data 2
        traffic = zipf_user_rows(nu, s["requests"], seed=3)
        pool = np.concatenate([zipf_user_rows(nu, 4096, seed=1), traffic])
        rng = np.random.default_rng(2)
        u, m = serve_factors(nu, nm, s["rank"], rng)
        seen, indptr = serve_seen_csr(nu, nm, s["nnz"], pool, rng)
        _, probe = default_two_stage_params(nm, clusters=s["clusters"])
        self.report["serve_setup"] = dict(
            generate_s=time.perf_counter() - t0, seen_cells=int(indptr[-1]),
            probe_clusters=probe, **s)
        # Record K4's arguments inside engine.topk: the parity, memory and
        # timing checks below run K4 on exactly what the engine gave it.
        captured = {}

        def recording(*a, **kw):
            captured["call"] = (a, kw)
            return topk_scores(*a, **kw)

        engine_mod.topk_scores = twostage_mod.topk_scores = recording
        engines, rows, launches_total = {}, [], 0
        try:
            for mode, td, b in SERVE_CONFIGS:
                key = (mode, td)
                if key not in engines:
                    t1 = time.perf_counter()
                    engines[key] = ServeEngine(
                        u, m, num_users=nu, num_movies=nm, seen_movies=seen,
                        seen_indptr=indptr, table_dtype=td,
                        tile_m=s["tile_m"], serve_mode=mode,
                        clusters=s["clusters"] if mode == "two_stage" else None,
                        probe_clusters=probe if mode == "two_stage" else None,
                        device="cuda")
                    warm = engines[key].prewarm(k, max_batch=256,
                                                user_rows=pool)
                    log(f"serve engine {key}: built + prewarmed in "
                        f"{time.perf_counter() - t1:.1f} s ({warm})")
                eng = engines[key]
                qrows = pool[:b]
                # -- the main path: engine + request server, counted --------
                topk_scores.launches = 0
                vals, ids = eng.topk(qrows, k)
                call = captured["call"]
                scan = dict(eng.last_scan)
                times = []
                for _ in range(5):
                    t1 = time.perf_counter()
                    eng.topk(qrows, k)
                    times.append(time.perf_counter() - t1)
                batch_s = min(times)
                broker = InMemoryBroker()
                ensure_serve_topics(broker)
                server = RecommendServer(eng, broker, max_batch=b)
                client = ServeClient(broker)
                warm_serve_programs(client, server, pool, k, b)
                report = run_open_loop(
                    client, rate_qps=max(0.7 * b / batch_s, 1.0),
                    num_requests=s["requests"], user_rows=traffic, k=k,
                    server=server, drive_server=True)
                launches = topk_scores.launches
                launches_total += launches
                name = f"{mode}/{td}/B{b}"
                self.check(launches > 0, f"serve {name}: K4 launched "
                           f"{launches} times")
                self.check(report.answered == report.num_requests,
                           f"serve {name}: answered {report.answered} of "
                           f"{report.num_requests}")
                self.check(bool(np.isfinite(vals).all())
                           and vals.shape == (b, k) and (ids >= 0).all(),
                           f"serve {name}: non-finite or short results")
                # -- K4 against its plain version on the same arguments -----
                a, kw = call
                got = topk_scores(*a, **kw)
                torch.cuda.synchronize()
                want = topk_scores_plain(*a, **kw)
                ext = topk_scores_plain(*a, **dict(kw, k_top=k + 1))
                par = compare_topk(*got, *want, ext[0], tol=TOL["topk_scores"])
                self.check(par["ok"], f"serve {name}: K4 vs plain {par}")
                row = dict(mode=mode, table_dtype=td, batch=b,
                           k4_rows=int(a[1].shape[0]),
                           seen_width=0 if a[3] is None else int(a[3].shape[2]),
                           max_abs_err=par["max_abs_err"],
                           rel_err=par["rel_err"],
                           id_mismatches_vs_plain=par["id_mismatches"])
                dense = dense_route(a, kw)
                if mode == "exact":  # the engine's ids against the dense route
                    dv, di = dense(k + 1)
                    dr = compare_topk(vals, ids, dv[:, :k], di[:, :k], dv,
                                      tol=TOL["topk_scores"])
                    row["id_mismatches_vs_dense"] = dr["id_mismatches"]
                    self.check(dr["ok"], f"serve {name}: engine vs dense {dr}")
                # -- no [B, M] score matrix during one K4 call --------------
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                topk_scores(*a, **kw)
                torch.cuda.synchronize()
                growth = torch.cuda.max_memory_allocated() - base
                dense_bytes = b * a[1].shape[0] * 4
                row.update(k4_alloc_bytes=growth, dense_bytes=dense_bytes)
                self.check(growth < dense_bytes, f"serve {name}: K4 allocated "
                           f"{growth} B >= B·M_pad·4 = {dense_bytes}")
                # -- times and the bound ------------------------------------
                nbytes, flops, counts = topk_scores_work(a, kw, b)
                b_ms, by = bound(nbytes, flops)
                row.update(**counts)
                row.update(
                    ms=time_ms(lambda: topk_scores(*a, **kw), 20),
                    plain_ms=time_ms(lambda: topk_scores_plain(*a, **kw), 3),
                    library_ms=time_ms(dense, 10), bound_ms=b_ms, bound_by=by,
                    launches=launches, engine_batch_ms=batch_s * 1e3,
                    capacity_qps=b / batch_s, open_loop=report.as_row(),
                    bytes_scanned_per_batch=scan["bytes_scanned_per_batch"])
                if mode == "two_stage":
                    self.check(scan["serve_mode"] == "two_stage",
                               f"serve {name}: ran {scan['serve_mode']}")
                    _, oracle = eng.topk(qrows, k, force_exact=True)
                    recall = recall_at_k(ids, oracle)
                    row.update(
                        recall_at_k=recall,
                        fallbacks=eng.two_stage_fallbacks,
                        shortlist_rows=scan.get("shortlist_rows"),
                        shortlist_rows_padded=scan.get(
                            "shortlist_rows_padded"),
                        exact_bytes_scanned_per_batch=eng.last_scan[
                            "bytes_scanned_per_batch"])
                    self.check(recall >= 0.95 and eng.two_stage_fallbacks == 0,
                               f"serve {name}: recall@{k} {recall}, "
                               f"{eng.two_stage_fallbacks} fallbacks")
                if b == 256 and td == "float32":
                    row["profile"] = profile_calls(lambda: eng.topk(qrows, k),
                                                   5)
                log(f"serve {name}: {row}")
                rows.append(row)
        finally:
            engine_mod.topk_scores = twostage_mod.topk_scores = topk_scores
        self.report["serve"] = rows
        head = next(r for r in rows if (r["mode"], r["table_dtype"],
                                        r["batch"]) == ("exact", "float32",
                                                        256))
        self.kernels.setdefault("topk_scores", {}).update(
            {key: head[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")},
            launches=launches_total,
            max_abs_err=max(r["max_abs_err"] for r in rows))

    def small_parity(self):
        import numpy as np
        import torch

        from cfk_tpu_torch import ALSConfig, Dataset, train_als
        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

        coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
        rng = np.random.default_rng(0)
        u0 = rng.random((3000, 16)).astype(np.float32)
        out = {}
        for layout, kw in (("padded", {}),
                           ("tiled", dict(chunk_elems=2048, tile_rows=16,
                                          accum_max_entities=1000))):
            ds = Dataset.from_coo(coo, layout=layout, **kw)
            cfg = ALSConfig(rank=16, num_iterations=3, layout=layout)
            seed = (u0[:ds.user_map.num_entities],
                    np.zeros((ds.movie_map.num_entities, 16), np.float32))
            got = train_als(ds, cfg, device="cuda", warm_start=seed)
            want = train_als(ds, cfg, device="cpu", warm_start=seed)
            pg, pw = got.predict_dense(), want.predict_dense()
            rel = float(np.abs(pg - pw).max() / np.abs(pw).max())
            out[layout] = rel
            self.check(rel < 1e-3, f"small {layout}: kernels vs plain {rel}")
        self.report["small_parity_rel"] = out
        log(f"small parity (kernels on the card vs plain on the CPU): {out}")

    def cli(self):
        import numpy as np

        from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo

        work = OUT_DIR / "smoke_cli"
        work.mkdir(parents=True, exist_ok=True)
        coo = synthetic_netflix_coo(2000, 300, 40_000, seed=2)
        data = work / "ratings.txt"
        with open(data, "w") as f:
            for mid in np.unique(coo.movie_raw):
                f.write(f"{mid}:\n")
                sel = coo.movie_raw == mid
                for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                    f.write(f"{uid},{int(r)},2005-01-01\n")
        preds = work / "predictions.csv"
        ckpt = work / "checkpoints"
        train = subprocess.run(
            [sys.executable, "-m", "cfk_tpu_torch", "train", "--data",
             str(data), "--layout", "auto", "--rank", "8", "--iterations",
             "3", "--device", "cuda", "--output", str(preds),
             "--checkpoint-dir", str(ckpt)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        log(f"cli train rc={train.returncode}: {train.stdout.strip()} | "
            f"{train.stderr.strip()[-400:]}")
        self.check(train.returncode == 0, "cli train failed")
        fields = dict(kv.split("=", 1) for kv in train.stdout.split()
                      if "=" in kv)
        self.check(fields.get("layout") == "padded",
                   f"cli auto layout {fields.get('layout')} != padded")
        ev = subprocess.run(
            [sys.executable, "-m", "cfk_tpu_torch", "evaluate", str(data),
             str(preds)], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        log(f"cli evaluate rc={ev.returncode}: {ev.stdout.strip()}")
        self.check(ev.returncode == 0, "cli evaluate failed")
        mse_eval = float(ev.stdout.split("MSE:")[1].split()[0])
        mse_train = float(fields["mse"])
        self.check(abs(mse_eval - mse_train) <= 1e-4 * mse_train,
                   f"evaluate MSE {mse_eval} != train MSE {mse_train}")
        # The serving verbs over the checkpoint train just wrote.
        serving = ["--checkpoint-dir", str(ckpt), "--data", str(data),
                   "--device", "cuda"]
        users = [str(x) for x in np.unique(coo.user_raw)[:3]]

        def verb(*argv):
            out = subprocess.run([sys.executable, "-m", "cfk_tpu_torch",
                                  *argv, *serving], cwd=ROOT,
                                 capture_output=True, text=True, timeout=300)
            log(f"cli {argv[0]} rc={out.returncode}: "
                f"{out.stdout.strip()[-300:]} | {out.stderr.strip()[-300:]}")
            self.check(out.returncode == 0, f"cli {argv[0]} failed")
            return out.stdout

        rec = verb("recommend", "--users", ",".join(users), "-k", "5")
        self.check([ln.split("\t")[0] for ln in rec.strip().splitlines()]
                   == users, "cli recommend: wrong users")
        preds2 = work / "predictions_from_checkpoint.csv"
        verb("predict", "--output", str(preds2))
        ev2 = subprocess.run(
            [sys.executable, "-m", "cfk_tpu_torch", "evaluate", str(data),
             str(preds2)], cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        self.check(ev2.returncode == 0, "cli evaluate (predict CSV) failed")
        mse_pred = float(ev2.stdout.split("MSE:")[1].split()[0])
        self.check(abs(mse_pred - mse_train) <= 1e-4 * mse_train,
                   f"predict CSV MSE {mse_pred} != train MSE {mse_train}")
        row = json.loads(verb("serve", "-k", "10", "--tile-m", "64",
                              "--max-batch", "32", "--loadgen-requests",
                              "128", "--loadgen-qps", "400")
                         .strip().splitlines()[-1])
        self.check(row["answered"] == row["requests"] == 128,
                   f"cli serve answered {row['answered']} of "
                   f"{row['requests']}")
        self.report["cli"] = dict(train=train.stdout.strip(),
                                  evaluate_mse=mse_eval,
                                  predict_mse=mse_pred, serve=row)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    import cfk_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = Smoke()
    t_start = time.perf_counter()
    smoke.phase("build", smoke.build)
    built = not smoke.failures
    main_out = None
    if built:
        main_out = smoke.phase("main", smoke.main_path)
    if main_out is not None:
        smoke.phase("kernels", smoke.kernel_checks, *main_out)
        smoke.phase("breakdown", smoke.breakdown, *main_out)
        del main_out
        torch.cuda.empty_cache()
    if built:
        smoke.phase("serve", smoke.serve)
        torch.cuda.empty_cache()
    smoke.phase("small", smoke.small_parity)
    smoke.phase("cli", smoke.cli)
    smoke.report["total_s"] = time.perf_counter() - t_start
    smoke.report["card"] = card
    kernels = []
    for name in REPLACES:
        row = smoke.kernels.get(name, {})
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cfk_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            **{key: row.get(key) for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms")},
        })
    smoke.report["kernels"] = kernels
    smoke.report["failures"] = smoke.failures
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(smoke.report,
                                                         indent=1))
    if smoke.failures:
        log(f"{len(smoke.failures)} failure(s):")
        for f in smoke.failures:
            print(f, file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
