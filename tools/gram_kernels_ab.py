"""Device time of the port's tiled Gram kernels over every chunk of one
tiled dataset, of K1 at the shapes its paths give it, and of K6 per width
class of the implicit bucketed layout, for comparing two source trees on
one card.

    python3 tools/gram_kernels_ab.py [--tree DIR] [--label NAME]
        [--nnz N] [--rank K] [--cache FILE] [--table-dtype DTYPE]
        [--parts grams,k1,k6,gj,k4,binv]

``--tree`` names the directory holding the ``cfk_tpu_torch`` package to
measure (default: this checkout); its kernels are built from that tree's
``csrc/``.  Run two trees in turns in one call (A, B, B, A) and compare
them only within it.  The dataset is the Netflix shape's entity counts with
a cut rating count (``--nnz``, seed 0: the same chunk shapes, a lighter
Zipf head), tiled with the dense stream as ``chip_smoke.py`` builds it,
random factor tables at ``--rank``, stored in ``--table-dtype`` (float32,
the default and the only dtype a tree before the quantized tables takes;
bfloat16; int8, its per-row scale folded into each chunk's weights — the
dense chunks' bare scale stream — as the tiled half-steps fold it).  Per
kernel: the sum over all chunks of
its device ms (CUDA events around each launch; the best of ``--reps``
passes), with the gather kernels K2 (accum chunks), K3 and
``gram_tiles_dense_gather`` (dense chunks) and, where the tree has them,
their stream twins ``gram_tiles``, ``gram_solve_tiles_dense`` and
``gram_tiles_dense`` on the stream K5 writes (outside the timing) and K5
itself, with a CRC-32 of every chunk's outputs of each; above rank 128 the
fused K3 and ``gram_solve_tiles_dense`` take no part (they refuse the
rank, as the half-steps route around them).  ``--cache FILE`` keeps the
built dataset in FILE (pickled; the
first process of a call writes it, the others read it), so turns at the
full Netflix rating count (``--nnz 100480507``) do not each spend minutes
building it.  ``--parts`` picks what runs (default ``grams,k1``):
``grams`` the above; ``k1`` K1 ``reg_solve`` (its kernel's device ms a launch,
from torch.profiler) on count-scaled random Grams at k = 128 with E = 1 (one
solve's latency) and E = 203 (a split implicit chunk, one wave), at k = 64
with E = 17,770 (the Netflix movie half) and in matrix mode on 59,047
implicit-shaped systems at k = 128 (as ``chip_smoke.py``'s binv phase
builds them); ``k6`` K6 ``gram_solve_gather`` on every width class of both
halves of iALS (b) (the ML-25M shape, 25,000,095 interactions, seed 0,
bucketed at 524,288 entries, rank 128, U(0, 1) tables, λ 0.1, α 40), one
launch each, summed, the head class apart; ``gj`` rows 11 and 12
(``gauss_solve``, ``gauss_solve_multi``) at their path shapes, each as its
kernel's device ms a launch and as the device ms of the whole wrapper call
(``_call``: every kernel it launches, operand copies included), from
torch.profiler: row 11 on count-scaled random Grams plus λ·max(n, 1) at
k = 64, E = 17,770 (the Netflix split movie half); row 12 at the Schur
shape (k = 64, m = 65, E = 59,047) on the k1 part's implicit-shaped
matrix-mode systems with their ridge, A₁₁ handed over as the blocked solve
hands it (a view of the [E, 128, 128] batch); row 11 on the Schur
complement that follows (k = 64, E = 59,047); and the whole blocked solve
(``blocked_spd_solve``, k = 128) on those systems.  Prints the card
(``nvidia-smi``) and one JSON line; its ``ptxas`` holds each built
kernel's registers and spill bytes from the tree's ``-Xptxas=-v`` reports,
its ``crc32`` a CRC-32 of the
outputs of K1 at each shape, of K6 over all classes and of rows 11 and 12
at each shape, for telling two trees' bits apart, and its ``clocks`` the
card's clocks, power draw and temperature before each row 11 and 12
measurement; ``k4`` K4 ``topk_scores`` at the six serve configurations of
``chip_smoke.py`` (the ML-25M shape, rank 128, K = 100, tile_m 2048:
exact f32 at B = 16, 64, 256, bf16 and int8 at 256, two-stage f32 at 256)
on ``serve_factors``/``serve_seen_csr`` at seed 0, each on the arguments
``ServeEngine.topk`` gives K4 (recorded inside the engine, as the smoke's
serve phase records them): pass 1's and pass 2's device ms a call and the
whole call's device ms, from torch.profiler, and the call's ms from CUDA
events, with a CRC-32 of its outputs; ``binv`` rows 14 (``binv_solve_reg``)
and 15 (``binv_inv``), each kernel's device ms a launch from
torch.profiler, with a CRC-32 of its outputs: row 14 on the prototype's
inputs at k = 128, E = 5,248 (``exp_binv.make_inputs``, seed 0, λ 0.05;
also its relative x error against a float64 solve), on count-scaled random
Grams at k = 64, E = 17,770 (the Netflix movie half's shape) and in matrix
mode on the k1 part's 59,047 implicit-shaped systems at k = 128; row 15 on
the ridged k = 128 inputs' leading 32 x 32 and 16 x 16 blocks (E = 5,248,
the Schur route's leaf operands).
"""

from __future__ import annotations

import argparse
import json
import pickle
import subprocess
import sys
import time
import zlib
from pathlib import Path


def sample_clocks(clocks: list, what: str) -> None:
    """Append the card's SM and memory clocks, power draw and temperature
    to ``clocks``, to keep beside a measurement."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    clocks.append(f"{what}: {q}")


def crc_of(crc: dict, name: str, *tensors) -> None:
    """Fold the bytes of ``tensors`` into crc[name] (CRC-32).  A tensor of
    more than 2^24 elements (a dense chunk's Gram batch, GBs) is folded in
    as a digest made on the device: per run of 2^20 elements, the sum of
    its 32-bit words times odd position weights, wrapping in int64 — any
    changed bit changes it except by a 2^-64 coincidence."""
    import torch

    for t in tensors:
        t = t.detach()
        if t.numel() > 1 << 24:
            v = t.contiguous().view(-1).view(torch.int32).long()
            v = torch.cat([v, v.new_zeros(-v.numel() % (1 << 20))])
            w = torch.arange(1, 2 << 20, 2, device=v.device,
                             dtype=torch.int64) * 0x9E3779B1
            t = (v.view(-1, 1 << 20) * w).sum(1)
        crc[name] = zlib.crc32(t.cpu().numpy().tobytes(), crc.get(name, 0))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--nnz", type=int, default=10_000_000)
    ap.add_argument("--rank", type=int, default=64)  # any: 256 for the blocks
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cache", default=None)
    ap.add_argument("--parts", default="grams,k1")
    ap.add_argument("--table-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("gram_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    import cfk_tpu_torch
    from cfk_tpu_torch import _build

    if Path(cfk_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {cfk_tpu_torch.__file__}, not {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    out, crc, clocks = {}, {}, []
    if "k1" in parts:
        out.update(k1_rows(dev, crc))
    if "k6" in parts:
        out.update(k6_rows(dev, crc))
    if "gj" in parts:
        out.update(gj_rows(dev, crc, clocks))
    if "k4" in parts:
        out.update(k4_rows(dev, crc, clocks))
    if "binv" in parts:
        out.update(binv_rows(dev, crc, clocks))
    if "grams" in parts:
        out.update(gram_rows(args, dev, crc))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps(dict(label=args.label, tree=str(tree), nnz=args.nnz,
                          rank=args.rank, table_dtype=args.table_dtype,
                          build_s=build_s, total_ms=out, crc32=crc,
                          clocks=clocks, ptxas=ptxas_report(_build))))
    return 0


def ptxas_report(build) -> dict:
    """Library → [(kernel, registers, spill stores, spill loads)] from the
    ``-Xptxas=-v`` reports the build kept (``<name>.ptxas.txt``), kernels
    only (entries that report registers), in the report's order."""
    import re

    out = {}
    for path in sorted(build.BUILD_DIR.glob("*.ptxas.txt")):
        rows, cur, props = [], None, None
        for line in path.read_text().splitlines():
            if m := re.search(r"Compiling entry function '(\S+)'", line):
                cur = [m.group(1), None, 0, 0]
                rows.append(cur)
            elif m := re.search(r"Function properties for (\S+)", line):
                props = m.group(1)
            elif cur and props == cur[0] and (m := re.search(
                    r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                    line)):
                cur[2], cur[3] = int(m.group(1)), int(m.group(2))
            elif cur and (m := re.search(r"Used (\d+) registers", line)):
                cur[1] = int(m.group(1))
        out[path.name.split(".")[0]] = [r for r in rows if r[1] is not None]
    return out


def mean_ms(fn, reps: int) -> float:
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


def kernel_ms(fn, reps: int, kernel) -> float:
    """Device ms per call of the kernels whose name holds ``kernel`` (a
    string, or a tuple of names: the parent's and the change's; "" for
    every device activity of the call), from torch.profiler rows over
    ``reps`` calls after a warm-up: K1 below one wave is too short for
    back-to-back calls to time the card and not the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if any(n in e.key for n in names)) / 1e3 / reps


def k1_rows(dev, crc: dict) -> dict:
    import torch

    from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve

    gen = torch.Generator(device=dev).manual_seed(128)
    out = {}
    for k, e, reps in ((128, 1, 200), (128, 203, 50), (64, 17_770, 20)):
        cnt = torch.randint(1, 400, (e,), generator=gen, device=dev)
        x = torch.randn((e, 2 * k, k), generator=gen, device=dev)
        a = torch.einsum("enk,enl->ekl", x, x) * (
            cnt.float() / (2 * k))[:, None, None]
        b = torch.randn((e, k), generator=gen, device=dev)
        del x
        out[f"reg_solve_k{k}_e{e}"] = kernel_ms(
            lambda: reg_solve(a, b, cnt, lam=0.05), reps, "reg_solve_kernel")
        crc_of(crc, f"reg_solve_k{k}_e{e}", reg_solve(a, b, cnt, lam=0.05))
    am, bm, rm = implicit_systems(dev, gen)
    out[f"reg_solve_matrix_k128_e{am.shape[0]}"] = kernel_ms(
        lambda: reg_solve(am, bm, rm, reg_mode="matrix"), 5,
        "reg_solve_kernel")
    crc_of(crc, "reg_solve_matrix",
           reg_solve(am, bm, rm, reg_mode="matrix"))
    del am
    torch.cuda.empty_cache()
    return out


def implicit_systems(dev, gen, k=128, em=59_047):
    """K1's matrix-mode systems at the ML-25M movie count: α·(n/64)·XᵀX,
    X [64, k] ~ U(0, 1), b ~ 100·U(0, 1), and the shared ridge YᵀY + λI
    over 162,541 rows Y ~ U(0, 1)."""
    import torch

    cnt = torch.randint(1, 400, (em,), generator=gen, device=dev)
    am = torch.empty((em, k, k), device=dev)
    for lo in range(0, em, 8192):
        xs = torch.rand((min(8192, em - lo), 64, k), generator=gen,
                        device=dev)
        torch.matmul(xs.transpose(1, 2), xs, out=am[lo:lo + xs.shape[0]])
        am[lo:lo + xs.shape[0]] *= (
            40.0 * cnt[lo:lo + xs.shape[0]].float() / 64)[:, None, None]
    del xs
    bm = torch.rand((em, k), generator=gen, device=dev) * 100
    y = torch.rand((162_541, k), generator=gen, device=dev)
    return am, bm, y.T @ y + 0.1 * torch.eye(k, device=dev)


# Rows 11 and 12's kernel in the parent tree (Gauss-Jordan) and since the
# blocked Cholesky.
GJ_KERNELS = ("gauss_jordan_kernel", "spd_batch_kernel")


def gj_rows(dev, crc: dict, clocks: list) -> dict:
    import torch

    from cfk_tpu_torch.ops.kernels.solve_kernel import (
        gauss_solve, gauss_solve_multi)
    from cfk_tpu_torch.ops.solve import blocked_spd_solve

    out = {}

    def both(name, call, reps):
        sample_clocks(clocks, name)
        out[name] = kernel_ms(call, reps, GJ_KERNELS)
        out[f"{name}_call"] = kernel_ms(call, reps, "")
        crc_of(crc, name, call())

    gen = torch.Generator(device=dev).manual_seed(64)
    k, e = 64, 17_770
    cnt = torch.randint(1, 400, (e,), generator=gen, device=dev)
    x = torch.randn((e, 2 * k, k), generator=gen, device=dev)
    a = torch.einsum("enk,enl->ekl", x, x) * (
        cnt.float() / (2 * k))[:, None, None]
    a.diagonal(dim1=-2, dim2=-1).add_(0.05 * cnt.float()[:, None])
    b = torch.randn((e, k), generator=gen, device=dev)
    del x
    both(f"gauss_solve_k{k}_e{e}",
         lambda: gauss_solve(a.permute(1, 2, 0), b.T), 20)
    del a, b
    am, bm, rm = implicit_systems(dev, torch.Generator(
        device=dev).manual_seed(128))
    am.add_(rm)
    e, k1 = am.shape[0], 64
    rhs = torch.cat([am[:, :k1, k1:], bm[:, :k1, None]], dim=2)
    al, rl = am[:, :k1, :k1].permute(1, 2, 0), rhs.permute(1, 2, 0)
    both(f"gauss_solve_multi_k{k1}_m{k1 + 1}_e{e}",
         lambda: gauss_solve_multi(al, rl), 5)
    y = gauss_solve_multi(al, rl).permute(2, 0, 1)
    s = am[:, k1:, k1:] - am[:, k1:, :k1] @ y[:, :, :k1]
    r2 = bm[:, k1:] - (am[:, k1:, :k1] @ y[:, :, k1:])[:, :, 0]
    del y, rhs, al, rl
    both(f"gauss_solve_schur_k{k1}_e{e}",
         lambda: gauss_solve(s.permute(1, 2, 0), r2.T), 5)
    del s, r2
    out[f"blocked_spd_solve_k128_e{e}_call"] = kernel_ms(
        lambda: blocked_spd_solve(am, bm), 3, "")
    del am, bm
    torch.cuda.empty_cache()
    return out


def binv_rows(dev, crc: dict, clocks: list) -> dict:
    import torch

    from cfk_tpu_torch.ops.kernels.binv_kernel import binv_inv, binv_solve_reg
    from cfk_tpu_torch.ops.kernels.solve_kernel import add_ridge_plain
    from cfk_tpu_torch.scripts.exp_binv import float64_check, make_inputs

    out = {}

    def row(name, call, reps, kernel):
        sample_clocks(clocks, name)
        out[name] = kernel_ms(call, reps, kernel)
        got = call()
        crc_of(crc, name, got)
        return got

    k, e, lam = 128, 5_248, 0.05
    a_np, b_np, cnt_np = make_inputs(k, e)
    a, b, cnt = (torch.as_tensor(x, device=dev) for x in (a_np, b_np, cnt_np))
    x = row(f"binv_solve_reg_k{k}_e{e}",
            lambda: binv_solve_reg(a, b, cnt, lam=lam), 10,
            "binv_solve_reg_kernel")
    out[f"binv_solve_reg_k{k}_e{e}_rel_err_vs_float64"] = float64_check(
        a_np, b_np, cnt_np, x.cpu().numpy(), lam)[1]
    a_reg = add_ridge_plain(a, cnt, lam=lam, reg_mode="diag")
    for n in (32, 16):
        blk = a_reg[:, :n, :n].contiguous()
        row(f"binv_inv_n{n}_e{e}", lambda: binv_inv(blk), 20,
            "binv_inv_kernel")
    del a, b, cnt, a_reg, blk
    gen = torch.Generator(device=dev).manual_seed(64)
    k, e = 64, 17_770
    cnt = torch.randint(1, 400, (e,), generator=gen, device=dev)
    xs = torch.randn((e, 2 * k, k), generator=gen, device=dev)
    a = torch.einsum("enk,enl->ekl", xs, xs) * (
        cnt.float() / (2 * k))[:, None, None]
    b = torch.randn((e, k), generator=gen, device=dev)
    del xs
    row(f"binv_solve_reg_k{k}_e{e}",
        lambda: binv_solve_reg(a, b, cnt, lam=lam), 10,
        "binv_solve_reg_kernel")
    del a, b, cnt
    am, bm, rm = implicit_systems(dev, torch.Generator(
        device=dev).manual_seed(128))
    row(f"binv_solve_reg_matrix_k128_e{am.shape[0]}",
        lambda: binv_solve_reg(am, bm, rm, reg_mode="matrix"), 3,
        "binv_solve_reg_kernel")
    del am, bm, rm
    torch.cuda.empty_cache()
    return out


# K4's two launches (the same kernel names in the parent tree and since).
K4_PASSES = (("pass1", "topk_partial_kernel"), ("pass2", "topk_merge_kernel"))


def profile_split(fn, reps: int, names) -> dict:
    """Device ms per call of ``fn`` for each (label, kernel name) of
    ``names`` and for every device activity of the call ("call"), from one
    torch.profiler window over ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages()]
    out = {label: sum(us for key, us in rows if name in key) / 1e3 / reps
           for label, name in names}
    out["call"] = sum(us for _, us in rows) / 1e3 / reps
    return out


def k4_rows(dev, crc: dict, clocks: list) -> dict:
    import numpy as np

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import SERVE, SERVE_CONFIGS

    from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
    from cfk_tpu_torch.serving import (
        ServeEngine, default_two_stage_params, zipf_user_rows)
    from cfk_tpu_torch.serving import engine as engine_mod
    from cfk_tpu_torch.serving import twostage as twostage_mod
    from cfk_tpu_torch.serving.topk_kernel import topk_scores

    s = SERVE
    nu, nm, k = s["num_users"], s["num_movies"], s["k"]
    # chip_smoke.py's serve phase at --seed 0: traffic 3, pool 1, data 2
    traffic = zipf_user_rows(nu, s["requests"], seed=3)
    pool = np.concatenate([zipf_user_rows(nu, 4096, seed=1), traffic])
    rng = np.random.default_rng(2)
    u, m = serve_factors(nu, nm, s["rank"], rng)
    seen, indptr = serve_seen_csr(nu, nm, s["nnz"], pool, rng)
    _, probe = default_two_stage_params(nm, clusters=s["clusters"])
    captured = {}

    def recording(*a, **kw):
        captured["call"] = (a, kw)
        return topk_scores(*a, **kw)

    out, engines = {}, {}
    engine_mod.topk_scores = twostage_mod.topk_scores = recording
    try:
        for mode, td, b in SERVE_CONFIGS:
            if (mode, td) not in engines:
                engines[(mode, td)] = ServeEngine(
                    u, m, num_users=nu, num_movies=nm, seen_movies=seen,
                    seen_indptr=indptr, table_dtype=td, tile_m=s["tile_m"],
                    serve_mode=mode,
                    clusters=s["clusters"] if mode == "two_stage" else None,
                    probe_clusters=probe if mode == "two_stage" else None,
                    device="cuda")
            engines[(mode, td)].topk(pool[:b], k)
            a, kw = captured["call"]
            name = f"k4_{mode}_{td}_b{b}"
            sample_clocks(clocks, name)
            call = lambda: topk_scores(*a, **kw)  # noqa: E731
            for label, ms in profile_split(call, 20, K4_PASSES).items():
                out[f"{name}_{label}"] = ms
            out[f"{name}_events"] = mean_ms(call, 20)
            crc_of(crc, name, *call())
    finally:
        engine_mod.topk_scores = twostage_mod.topk_scores = topk_scores
    return out


def k6_rows(dev, crc: dict) -> dict:
    import numpy as np
    import torch

    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.ops.bucketed import bucket_gram_solve, ials_reparam
    from cfk_tpu_torch.ops.kernels.gram_units import (
        chunk_plan, derive_tile_units, stage_plans)
    from cfk_tpu_torch.ops.solve import global_gram_blocked, implicit_reg

    ds = Dataset.from_coo(synthetic_netflix_coo(162_541, 59_047, 25_000_095,
                                                seed=0),
                          layout="bucketed", chunk_elems=524_288)
    rng = np.random.default_rng(0)
    tables = {side: torch.as_tensor(rng.random((n, 128), dtype=np.float32),
                                    device=dev)
              for side, n in (("user", 162_541), ("movie", 59_047))}
    total, head = 0.0, (0, 0.0)
    for blocks, table in ((ds.movie_blocks, tables["user"]),
                          (ds.user_blocks, tables["movie"])):
        reg = implicit_reg(global_gram_blocked(table), 0.1)
        for bk in blocks.buckets:
            nb = torch.as_tensor(bk.neighbor_idx, device=dev)
            mk = torch.as_tensor(bk.mask, device=dev)
            wt, rt = ials_reparam(torch.as_tensor(bk.rating, device=dev), mk,
                                  40.0)
            rows = int(nb.shape[0])
            seg = torch.arange(rows, dtype=torch.int32)
            plan = chunk_plan(stage_plans(
                derive_tile_units(seg[None], bk.width, rows), dev), 0)
            ms = mean_ms(lambda: bucket_gram_solve(
                table, nb, wt, rt, reg, lam=0.0, reg_mode="matrix",
                units=plan), 2)
            crc_of(crc, "gram_solve_gather_ials_b", bucket_gram_solve(
                table, nb, wt, rt, reg, lam=0.0, reg_mode="matrix",
                units=plan))
            total += ms
            if blocks is ds.movie_blocks and bk.width > head[0]:
                head = (bk.width, ms)
    return {"gram_solve_gather_ials_b_classes": total,
            "gram_solve_gather_ials_b_head_class": head[1]}


def gram_rows(args, dev, crc) -> dict:
    import torch

    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.models.als import _tiled_device_setup
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk
    from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk

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
    blk_m, blk_u, _ = _tiled_device_setup(ds, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    u = torch.randn((ds.user_blocks.padded_entities, args.rank),
                    generator=gen, device=dev)
    m = torch.randn((ds.movie_blocks.padded_entities, args.rank),
                    generator=gen, device=dev)
    scales = (None, None)
    if args.table_dtype != "float32":
        from cfk_tpu_torch.ops.quant import quantize_table

        (u, su), (m, sm) = (quantize_table(t, args.table_dtype)
                            for t in (u, m))
        scales = (su, sm)
    st_m, st_u = ds.movie_blocks.statics, ds.user_blocks.statics
    try:  # the work-unit plans the device upload staged, where the tree has them
        from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

        def with_plan(a, blk, c):
            return dict(a, units=chunk_plan(blk, c))
    except ImportError:
        def with_plan(a, blk, c):
            return a
    def folded(a, scale):
        """An int8 table's scale folded into the chunk's weights."""
        if scale is None:
            return a
        from cfk_tpu_torch.ops.quant import fold_scale

        wt = a["wt"] if a["wt"] is not None else torch.ones_like(
            a["nb"], dtype=torch.float32)
        return dict(a, wt=fold_scale(wt, scale, a["nb"]))

    accum = [folded(with_plan(accum_chunk(blk_m, st_m, c), blk_m, c),
                    scales[0]) for c in range(st_m[0])]
    dense = []
    for c in range(st_u[0]):
        a = with_plan(dense_chunk(blk_u, st_u, c), blk_u, c)
        a.pop("cin")
        dense.append(folded(a, scales[1]))

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
    fused = args.rank <= 128  # the fused kernels' ranks
    calls = {
        "gram_gather": [(none, lambda _, a=a: gk.gram_gather(u, **a))
                        for a in accum],
        "gram_tiles_dense_gather": [
            (none, lambda _, a=a: gk.gram_tiles_dense_gather(m, **gram_of(a)))
            for a in dense],
    }
    if fused:
        calls["gram_solve_dense"] = [
            (none, lambda _, a=a: gk.gram_solve_dense(m, **a, lam=0.05))
            for a in dense]
    if hasattr(gk, "gram_tiles"):
        def stream(table, a):
            return lambda: gk.gather_rows(table, a["nb"], a["wt"])

        def rest(a):
            return {n: v for n, v in a.items() if n not in ("nb", "wt")}

        calls["gather_rows"] = [
            (none, lambda _, a=a: (gk.gather_rows(u, a["nb"], a["wt"]),))
            for a in accum]
        calls["gram_tiles"] = [
            (stream(u, a), lambda g, a=a: gk.gram_tiles(g, **rest(a)))
            for a in accum]
        if fused:
            calls["gram_solve_tiles_dense"] = [
                (stream(m, a), lambda g, a=a: gk.gram_solve_tiles_dense(
                    g, **rest(a), lam=0.05)) for a in dense]
        calls["gram_tiles_dense"] = [
            (stream(m, a), lambda g, a=a: gk.gram_tiles_dense(
                g, **gram_of(rest(a)))) for a in dense]
    out = {name: total_ms(c) for name, c in calls.items()}
    for name, c in calls.items():  # every chunk's outputs, for the CRCs
        for prepare, launch in c:
            crc_of(crc, name, *launch(prepare()))
    out["accum_chunks"], out["dense_chunks"] = len(accum), len(dense)
    return out


if __name__ == "__main__":
    sys.exit(main())
