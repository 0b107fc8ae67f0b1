"""The port's implicit family (cfk_tpu_torch) against cfk_tpu, on the CPU.

Held to the JAX package on its default CPU route (``solver="cholesky"``;
the Pallas kernels of the path run their XLA emulation twins off the TPU):
the global Grams, every iALS half-step (padded, tiled accum and dense
stream, bucketed), the subspace sweep and the iALS++ half-steps, and three
training iterations from the same injected factors — ``jax.random`` cannot
be reproduced in torch, so the JAX package's ``_one_iteration`` is looped
from the same u0 (and m0 = 0) that reaches the port through
``warm_start``.  The leave-one-out split is bit-identical and the ranking
metrics equal on the same factors.  Tolerances, relative to the largest
|value|: 1e-5 for a Gram, 1e-4 for a half-step, 1e-3 for predictions after
3 iterations — float32 on both sides in different summation orders (and
the tiled and bucketed iALS halves take the √(α·r) reparameterization,
which rounds differently from the padded (c−1)-weighted form).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import build_tiled_blocks as j_build_tiled
from cfk_tpu.data.movielens import parse_movielens_csv_python as j_parse_ml
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.eval import ranking as jrank
from cfk_tpu.models.als import ALSModel as JModel
from cfk_tpu.models.als import _blocks_to_device as j_blocks_to_device
from cfk_tpu.models.als import _bucketed_device_setup as j_bucketed_setup
from cfk_tpu.models.als import _tiled_device_setup as j_tiled_setup
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.solve import global_gram as j_global_gram
from cfk_tpu.ops.solve import global_gram_blocked as j_global_gram_blocked
from cfk_tpu.ops.solve import ials_half_step as j_ials_half_step
from cfk_tpu.ops.solve import ials_half_step_bucketed as j_ials_bucketed
from cfk_tpu.ops.subspace import _sweep_rect as j_sweep_rect
from cfk_tpu.ops.subspace import ials_pp_half_step as j_ials_pp
from cfk_tpu.ops.subspace import ials_pp_half_step_bucketed as j_ials_pp_bkt
from cfk_tpu.ops.tiled import ials_tiled_half_step as j_ials_tiled
from cfk_tpu_torch import Dataset, factors_from_numpy
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.data.movielens import parse_movielens_csv
from cfk_tpu_torch.eval import ranking as trank
from cfk_tpu_torch.models.als import _bucketed_to_device, _tiled_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops.solve import (
    global_gram,
    global_gram_blocked,
    ials_half_step,
    ials_half_step_bucketed,
)
from cfk_tpu_torch.ops.subspace import (
    _sweep_rect,
    ials_pp_half_step,
    ials_pp_half_step_bucketed,
)
from cfk_tpu_torch.ops.tiled import ials_tiled_half_step

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.1, 2.0
TILED = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
             tile_rows=16)
BUCKETED = dict(layout="bucketed", chunk_elems=256)


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"max |diff| {err} > {rtol} * {scale}"


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = JDataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


def test_global_grams_match():
    y = np.random.default_rng(2).standard_normal((9000, K)).astype(np.float32)
    _close(global_gram(torch.as_tensor(y)), j_global_gram(jnp.asarray(y)),
           1e-5)
    got = global_gram_blocked(torch.as_tensor(y), block_rows=1000)
    _close(got, j_global_gram_blocked(jnp.asarray(y), block_rows=1000), 1e-5)
    _close(global_gram_blocked(torch.as_tensor(y)),
           j_global_gram_blocked(jnp.asarray(y)), 1e-5)


def test_ials_half_step_padded_matches(coo, u0):
    b = JDataset.from_coo(coo).movie_blocks
    args = (b.neighbor_idx, b.rating, b.mask)
    want = j_ials_half_step(jnp.asarray(u0), *map(jnp.asarray, args), LAM,
                            ALPHA)
    got = ials_half_step(torch.as_tensor(u0), *map(torch.as_tensor, args),
                         LAM, ALPHA)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("side", ["movie", "user"])
def test_ials_tiled_half_step_matches(coo, u0, side):
    d = JDataset.from_coo(coo).coo_dense
    nm, nu = 150, 400
    kw = dict(tile_rows=16, chunk_elems=512)
    if side == "movie":  # accum
        args, fixed = (d.movie_raw, d.user_raw, d.rating, nm, nu), u0
        kw["slice_rows"] = 128
    else:  # dense stream
        rng = np.random.default_rng(3)
        fixed = rng.random((nm, K)).astype(np.float32)
        args = (d.user_raw, d.movie_raw, d.rating, nu, nm)
        kw["accum_max_entities"] = 100
    jb = j_build_tiled(*args, dense_stream=True, **kw)
    tb = build_tiled_blocks(*args, dense_stream=True, **kw)
    assert tb.mode == ("accum" if side == "movie" else "dstream")
    chunks = ("tiled", tb.mode) + tb.statics
    want = j_ials_tiled(jnp.asarray(fixed), j_tiled_to_device(jb, True),
                        chunks, jb.padded_entities, LAM, ALPHA)
    blk = _tiled_to_device(tb, CPU, fixed.shape[0], weighted=True)
    got = ials_tiled_half_step(torch.as_tensor(fixed), blk, chunks,
                               tb.padded_entities, LAM, ALPHA)
    _close(got, want, 1e-4)
    if side == "user":  # unweighted staging cannot run the weighted path
        blk = _tiled_to_device(tb, CPU, fixed.shape[0])
        with pytest.raises(ValueError, match="weighted channels"):
            ials_tiled_half_step(torch.as_tensor(fixed), blk, chunks,
                                 tb.padded_entities, LAM, ALPHA)


def test_ials_half_step_bucketed_matches(coo, u0):
    jb = JDataset.from_coo(coo, **BUCKETED).movie_blocks
    tb = Dataset.from_coo(coo, **BUCKETED).movie_blocks
    trees, chunks = jb.to_tree()
    want = j_ials_bucketed(jnp.asarray(u0),
                           tuple({k: jnp.asarray(v) for k, v in t.items()}
                                 for t in trees), chunks,
                           jb.padded_entities, LAM, ALPHA)
    ttrees, _ = _bucketed_to_device(tb, CPU)
    got = ials_half_step_bucketed(torch.as_tensor(u0), ttrees,
                                  tb.padded_entities, LAM, ALPHA)
    _close(got, want, 1e-4)


def test_sweep_rect_implicit_matches(coo, u0):
    b = JDataset.from_coo(coo).movie_blocks
    x0 = np.random.default_rng(6).standard_normal(
        (b.padded_entities, K)).astype(np.float32)
    gram = np.array(j_global_gram(jnp.asarray(u0)))
    args = (b.neighbor_idx, b.rating, b.mask)
    want = j_sweep_rect(jnp.asarray(u0), jnp.asarray(x0),
                        *map(jnp.asarray, args), LAM, ALPHA,
                        jnp.asarray(gram), 4, "cholesky")
    got = _sweep_rect(torch.as_tensor(u0), torch.as_tensor(x0),
                      *map(torch.as_tensor, args), LAM, ALPHA,
                      torch.as_tensor(gram), 4)
    _close(got, want, 1e-4)


def test_ials_pp_half_steps_match(coo, u0):
    x0 = np.random.default_rng(7).standard_normal((150, K)).astype(np.float32)
    b = JDataset.from_coo(coo).movie_blocks
    args = (b.neighbor_idx, b.rating, b.mask)
    want = j_ials_pp(jnp.asarray(u0), jnp.asarray(x0),
                     *map(jnp.asarray, args), LAM, ALPHA, block_size=4,
                     sweeps=2)
    got = ials_pp_half_step(torch.as_tensor(u0), torch.as_tensor(x0),
                            *map(torch.as_tensor, args), LAM, ALPHA,
                            block_size=4, sweeps=2)
    _close(got, want, 1e-4)
    jb = JDataset.from_coo(coo, **BUCKETED).movie_blocks
    tb = Dataset.from_coo(coo, **BUCKETED).movie_blocks
    trees, chunks = jb.to_tree()
    want = j_ials_pp_bkt(jnp.asarray(u0), jnp.asarray(x0),
                         tuple({k: jnp.asarray(v) for k, v in t.items()}
                               for t in trees), chunks, jb.padded_entities,
                         LAM, ALPHA, block_size=4)
    ttrees, tchunks = _bucketed_to_device(tb, CPU)
    got = ials_pp_half_step_bucketed(torch.as_tensor(u0), torch.as_tensor(x0),
                                     ttrees, tchunks, tb.padded_entities,
                                     LAM, ALPHA, block_size=4)
    _close(got, want, 1e-4)


def test_full_block_is_the_full_solve(coo, u0):
    """block_size = k: one sweep from any iterate gives A⁻¹b."""
    b = Dataset.from_coo(coo).movie_blocks
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    x0 = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (b.padded_entities, K)).astype(np.float32))
    full = ials_half_step(t(u0), t(b.neighbor_idx), t(b.rating), t(b.mask),
                          LAM, ALPHA)
    pp = ials_pp_half_step(t(u0), x0, t(b.neighbor_idx), t(b.rating),
                           t(b.mask), LAM, ALPHA, block_size=K, sweeps=1)
    _close(pp, full, 1e-4)


def _jax_setup(jd, layout):
    if layout == "tiled":
        mb, ub, _, kw = j_tiled_setup(jd, weighted=True)
        return mb, ub, kw
    if layout == "bucketed":
        mb, ub, _, kw = j_bucketed_setup(jd)
        return mb, ub, kw
    return (j_blocks_to_device(jd.movie_blocks),
            j_blocks_to_device(jd.user_blocks), {})


@pytest.mark.parametrize("layout,algorithm", [
    ("padded", "als"), ("tiled", "als"), ("bucketed", "als"),
    ("bucketed", "ials++"),
])
def test_train_ials_matches_reference_iterations(coo, u0, layout, algorithm):
    kw = {"padded": {}, "tiled": TILED, "bucketed": BUCKETED}[layout]
    jkw = dict(kw, dense_stream=True) if layout == "tiled" else kw
    jd = JDataset.from_coo(coo, **jkw)
    td = Dataset.from_coo(coo, **jkw)
    if layout == "tiled":
        assert (td.movie_blocks.mode, td.user_blocks.mode) == ("accum",
                                                               "dstream")
    mb, ub, layout_kw = _jax_setup(jd, layout)
    rows_u = jd.user_blocks.padded_entities
    u = jnp.zeros((rows_u, K), jnp.float32).at[:u0.shape[0]].set(u0)
    m = jnp.zeros((jd.movie_blocks.padded_entities, K), jnp.float32)
    for _ in range(3):
        u, m = j_one_iteration(u, m, mb, ub, lam=LAM, alpha=ALPHA,
                               dtype="float32", algorithm=algorithm,
                               block_size=4, **layout_kw)
    nu, nm = jd.user_map.num_entities, jd.movie_map.num_entities
    ref = factors_from_numpy(np.asarray(u), np.asarray(m), num_users=nu,
                             num_movies=nm, device="cpu")
    m0 = np.zeros((nm, K), np.float32)
    cfg = IALSConfig(rank=K, lam=LAM, alpha=ALPHA, num_iterations=3,
                     layout=layout, algorithm=algorithm, block_size=4)
    model = train_ials(td, cfg, device="cpu", warm_start=(u0, m0))
    _close(model.predict_dense(), ref.predict_dense(), 1e-3)


def test_leave_one_out_split_and_metrics_match(coo):
    d = JDataset.from_coo(coo).coo_dense
    jtrain, jheld = jrank.leave_one_out_split(d.movie_raw, d.user_raw,
                                              d.rating, seed=3)
    ttrain, theld = trank.leave_one_out_split(d.movie_raw, d.user_raw,
                                              d.rating, seed=3)
    for name in ("movie_raw", "user_raw", "rating"):
        a, b = getattr(jtrain, name), getattr(ttrain, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jheld.user_dense, theld.user_dense)
    np.testing.assert_array_equal(jheld.movie_dense, theld.movie_dense)
    assert theld.user_dense.size > 300
    rng = np.random.default_rng(4)
    u = rng.standard_normal((400, K)).astype(np.float32)
    m = rng.standard_normal((150, K)).astype(np.float32)
    m[:3] = m[3]  # exact ties are counted half
    scores = u @ m.T
    for k in (1, 10):
        assert trank.recall_at_k(scores, ttrain, theld, k) == \
            jrank.recall_at_k(scores, jtrain, jheld, k)
    assert trank.mean_percentile_rank(scores, ttrain, theld) == \
        jrank.mean_percentile_rank(scores, jtrain, jheld)
    want = jrank.ranking_metrics_from_model(
        JModel(jnp.asarray(u), jnp.asarray(m), 400, 150), jtrain, jheld,
        k=10, chunk=64)
    got = trank.ranking_metrics_from_model(
        factors_from_numpy(u, m, device="cpu"), ttrain, theld, k=10,
        chunk=64)
    assert abs(got[0] - want[0]) <= 1e-12 and abs(got[1] - want[1]) <= 1e-9
    with pytest.raises(ValueError, match="empty heldout"):
        trank.recall_at_k(scores, ttrain, trank.Heldout(
            np.zeros(0, np.int64), np.zeros(0, np.int64)))


def test_negative_strengths_are_refused(coo):
    from cfk_tpu_torch.data.blocks import RatingsCOO

    bad = RatingsCOO(coo.movie_raw, coo.user_raw, coo.rating - 3.0)
    with pytest.raises(ValueError, match="non-negative interaction"):
        train_ials(Dataset.from_coo(bad), IALSConfig(rank=K), device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(alpha=0.0), "alpha must be > 0"),
    (dict(algorithm="als++"), "unknown algorithm 'als\\+\\+' for IALSConfig"),
    (dict(algorithm="ials++", rank=10, block_size=4), "not divisible"),
    (dict(algorithm="ials++", sweeps=0, rank=8, block_size=4),
     "sweeps must be >= 1"),
    (dict(algorithm="ials++", layout="tiled"), "use layout='bucketed'"),
])
def test_config_validation_matches_reference_messages(kw, match):
    from cfk_tpu.models.ials import IALSConfig as JIALSConfig

    with pytest.raises(ValueError, match=match):
        JIALSConfig(**kw)
    with pytest.raises(ValueError, match=match):
        IALSConfig(**kw)
    assert (IALSConfig().alpha, IALSConfig().lam) == (40.0, 0.1)


def test_movielens_parser_matches_reference(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text("userId,movieId,rating,timestamp\n1,10,4.0,100\n"
                 "1,20,2.5,101\n\n2,10,5.0,102\n3,7,.5,1\n")
    for min_rating in (0.0, 3.0):
        a = parse_movielens_csv(str(p), min_rating=min_rating)
        b = j_parse_ml(str(p), min_rating=min_rating)
        for name in ("movie_raw", "user_raw", "rating"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert parse_movielens_csv(str(p), min_rating=3.0).num_ratings == 2
    bad = tmp_path / "bad.csv"
    bad.write_text("userId,movieId,rating,timestamp\n1,xx,4.0,100\n")
    with pytest.raises(ValueError, match=":2: malformed"):
        parse_movielens_csv(str(bad))


def _planted_implicit_csv(path, users=200, movies=80, nnz=3000, seed=0):
    """A planted non-negative factor model as a MovieLens CSV: positive
    factors, ratings clipped above zero (the recipe of
    tests/test_offload_ials.py::_planted_implicit), and — so that a ranking
    metric has something to find — each cell interacted with probability
    ∝ (u·m)⁴."""
    rng = np.random.default_rng(seed)
    u = np.abs(rng.standard_normal((users, 4))) + 0.1
    m = np.abs(rng.standard_normal((movies, 4))) + 0.1
    s = u @ m.T
    p = (s ** 4).ravel()
    cell = rng.choice(users * movies, size=nnz, replace=False, p=p / p.sum())
    ui, mi = cell // movies, cell % movies
    r = np.maximum(s[ui, mi] + 0.05 * rng.standard_normal(nnz), 0.05)
    with open(path, "w") as f:
        f.write("userId,movieId,rating,timestamp\n")
        for a, b, x in zip(ui, mi, r):
            f.write(f"{a + 1},{b + 1},{x:.3f},0\n")


def test_cli_train_implicit_eval_ranking(tmp_path):
    data = tmp_path / "ratings.csv"
    _planted_implicit_csv(data)
    ckpt = tmp_path / "ckpt"
    argv = ["--data", str(data), "--format", "movielens", "--implicit",
            "--algorithm", "ials++", "--rank", "8", "--block-size", "4",
            "--iterations", "3", "--eval-ranking", "10", "--device", "cpu",
            "--output", "none", "--seed", "3", "--checkpoint-dir", str(ckpt)]
    r = subprocess.run([sys.executable, "-m", "cfk_tpu_torch", "train", *argv],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    fields = dict(kv.split("=", 1) for kv in r.stdout.split())
    assert fields["layout"] == "padded" and "mse" not in fields
    rec, mpr = float(fields["recall_at_10"]), float(fields["mpr"])
    # The same run in process: the split, the port's own seeded init.
    coo = parse_movielens_csv(str(data))
    d = Dataset.from_coo(coo).coo_dense
    train, held = trank.leave_one_out_split(d.movie_raw, d.user_raw,
                                            d.rating, seed=3)
    model = train_ials(Dataset.from_coo(train), IALSConfig(
        rank=8, lam=0.05, num_iterations=3, seed=3, algorithm="ials++",
        block_size=4), device="cpu")
    want = trank.ranking_metrics_from_model(model, train, held, k=10)
    assert abs(rec - want[0]) <= 1e-6 and abs(mpr - want[1]) <= 1e-6
    assert mpr < 0.4  # the planted structure ranks well above chance (0.5)
    # The serving verbs read the same MovieLens file (raw ids, seen lists).
    users = [str(u) for u in np.unique(coo.user_raw)[:2]]
    rec = subprocess.run([sys.executable, "-m", "cfk_tpu_torch", "recommend",
                          "--checkpoint-dir", str(ckpt), "--data", str(data),
                          "--format", "movielens", "--users", ",".join(users),
                          "-k", "3", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300)
    assert rec.returncode == 0, rec.stderr
    rows = [ln.split("\t") for ln in rec.stdout.strip().splitlines()]
    assert [r[0] for r in rows] == users
    assert all(len(r[1].split(",")) == 3 for r in rows)
    bad = subprocess.run([sys.executable, "-m", "cfk_tpu_torch", "train",
                          "--data", str(data), "--format", "movielens",
                          "--eval-ranking", "10", "--device", "cpu"],
                         capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1 and "requires --implicit" in bad.stderr
