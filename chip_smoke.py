"""GPU smoke run of the PyTorch + CUDA port (cfk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must pass:

1. build   — compile the three CUDA kernels from cfk_tpu_torch/csrc (one nvcc
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
5. small   — ``train_als`` on small padded and tiled datasets, kernels on the
             card against the plain versions on the CPU;
6. cli     — ``python -m cfk_tpu_torch train --layout auto`` on a small
             Netflix-format file (padded is chosen), then ``evaluate`` on its
             prediction CSV.

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
TOL = {"reg_solve": 1e-3, "gram_gather": 1e-4, "gram_solve_dense": 1e-3}
REPLACES = {
    "reg_solve": "cfk_tpu/ops/pallas/solve_kernel.py:287",
    "gram_gather": "cfk_tpu/ops/pallas/gram_kernel.py:1422",
    "gram_solve_dense": "cfk_tpu/ops/pallas/gram_kernel.py:1764",
}


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
        train = subprocess.run(
            [sys.executable, "-m", "cfk_tpu_torch", "train", "--data",
             str(data), "--layout", "auto", "--rank", "8", "--iterations",
             "3", "--device", "cuda", "--output", str(preds)],
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
        self.report["cli"] = dict(train=train.stdout.strip(),
                                  evaluate_mse=mse_eval)


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
    main_out = None
    if not smoke.failures:
        main_out = smoke.phase("main", smoke.main_path)
    if main_out is not None:
        smoke.phase("kernels", smoke.kernel_checks, *main_out)
        smoke.phase("breakdown", smoke.breakdown, *main_out)
        del main_out
        torch.cuda.empty_cache()
    smoke.phase("small", smoke.small_parity)
    smoke.phase("cli", smoke.cli)
    smoke.report["total_s"] = time.perf_counter() - t_start
    smoke.report["card"] = card
    kernels = []
    for name in ("reg_solve", "gram_gather", "gram_solve_dense"):
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
