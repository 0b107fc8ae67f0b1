"""The port's serving slice (cfk_tpu_torch.serving and its CLI verbs) against
cfk_tpu, on the CPU.

Oracles, one JAX-package function each: ``cfk_tpu.compat.emulate_topk_scores``
for the plain top-K fold (the JAX package's XLA twin of its Pallas kernel),
``cfk_tpu.eval.recommend.recommend_top_k`` for the engine's exact mode and for
``ALSModel.recommend_top_k``, and the numpy host helpers (seen tiles, table
padding, cluster index, shortlist, synthetic serving data) and codecs
(quantized tables, score frames, checkpoints) for bit equality.  Two-stage
retrieval is held to the port's own exact mode.

Tolerances: scores within 1e-5 of the largest |score| (float32 sums taken in
another order); ids equal everywhere except where the reference's adjacent
scores (the K+1-th included) differ by less than that — the near-ties whose
order a different summation order may flip.  Planted exact ties (integer
factors, exact sums) must give identical ids.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.compat import emulate_topk_scores
from cfk_tpu.ops.quant import quantize_table as j_quantize
from cfk_tpu_torch.ops.quant import dequantize_table, quantize_table
from cfk_tpu_torch.serving import engine as t_engine
from cfk_tpu_torch.serving import topk_kernel as t_kernel
from cfk_tpu_torch.serving import twostage as t_two

from _torch_topk import compare_topk, split_bounds

TOL = 1e-5


def assert_topk_close(got_v, got_i, want_v, want_i, want_v_ext=None):
    """Scores within TOL·max|score|; ids equal except at near-ties."""
    got_i, want_i = np.asarray(got_i), np.asarray(want_i)
    assert got_i.shape == want_i.shape
    report = compare_topk(got_v, got_i, want_v, want_i, want_v_ext, tol=TOL)
    assert report["ok"], report


def _csr(seen_lists):
    indptr = np.zeros(len(seen_lists) + 1, np.int64)
    indptr[1:] = np.cumsum([s.size for s in seen_lists])
    movies = (np.concatenate(seen_lists).astype(np.int32) if indptr[-1]
              else np.zeros(0, np.int32))
    return movies, indptr


def _problem(seed, b=8, m=50, k=16, tile=16, seen_max=12, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        u = rng.integers(-3, 4, (b, k)).astype(np.float32)
        mf = rng.integers(-3, 4, (m, k)).astype(np.float32)
        mf[:, 0] = 127.0  # every row's int8 scale is exactly 1
    else:
        u = rng.standard_normal((b, k)).astype(np.float32)
        mf = rng.standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // tile) * tile
    tbl = np.zeros((m_pad, k), np.float32)
    tbl[:m] = mf
    seen = [np.sort(rng.choice(m, size=int(rng.integers(0, seen_max)),
                               replace=False)) for _ in range(b)]
    return u, tbl, seen


def _both_tables(tbl, table_dtype):
    """(port data, port scale, JAX data, JAX scale) — each package quantizes
    with its own quantize_table; the codes must agree bit for bit."""
    data, scale = quantize_table(torch.as_tensor(tbl), table_dtype)
    jdata, jscale = j_quantize(jnp.asarray(tbl), table_dtype)
    np.testing.assert_array_equal(
        data.view(torch.int16).numpy() if data.dtype == torch.bfloat16
        else data.numpy(),
        np.asarray(jdata).view(np.int16) if table_dtype == "bfloat16"
        else np.asarray(jdata))
    if scale is not None:
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    return data, scale, jdata, jscale


def _reference_topk(u, jdata, jscale, st, **kw):
    out = emulate_topk_scores(jnp.asarray(u), jdata, jscale,
                              None if st is None else jnp.asarray(st), **kw)
    return np.asarray(out[0]), np.asarray(out[1])


# -- ops.quant -------------------------------------------------------------


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_quantize_table_bit_equal(table_dtype):
    rng = np.random.default_rng(3)
    tbl = rng.standard_normal((40, 12)).astype(np.float32) * 3
    tbl[5] = 0.0  # all-zero row: unit scale
    tbl[7, 3] = 127.5  # a rounding-sensitive row
    data, scale, _, _ = _both_tables(tbl, table_dtype)
    want = tbl if table_dtype == "float32" else None
    if want is not None:
        np.testing.assert_array_equal(data.numpy(), want)
    if table_dtype == "int8":
        assert float(scale[5]) == 1.0
        deq = dequantize_table(data, scale).numpy()
        assert np.abs(deq - tbl).max() <= float(scale.max()) / 2 + 1e-6


# -- K4's plain version against the JAX fold ---------------------------------


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("case", ["padded", "offset_tail"])
def test_plain_topk_matches_reference_fold(table_dtype, with_seen, case):
    u, tbl, seen = _problem(11)
    kw = dict(k_top=5, num_movies=50, tile_m=16, row_offset=0)
    if case == "offset_tail":
        # a shard at row 7 whose ids run past num_movies: 33 live rows at
        # most, fewer with seen rows out, and K = 40 forces the −1 tail
        kw = dict(k_top=40, num_movies=40, tile_m=16, row_offset=7)
    data, scale, jdata, jscale = _both_tables(tbl, table_dtype)
    st = None
    if with_seen:
        movies, indptr = _csr(seen)
        st = t_kernel.build_seen_tiles(movies, indptr, np.arange(8),
                                       num_movies=tbl.shape[0], tile_m=16)
    got_v, got_i = t_kernel.topk_scores_plain(
        torch.as_tensor(u), data, scale,
        None if st is None else torch.as_tensor(st), **kw)
    want_v, want_i = _reference_topk(u, jdata, jscale, st, **kw)
    ext_v, _ = _reference_topk(u, jdata, jscale, st,
                               **dict(kw, k_top=kw["k_top"] + 1))
    assert_topk_close(got_v.numpy(), got_i.numpy(), want_v, want_i, ext_v)
    if case == "offset_tail":
        assert (want_i == -1).any() and np.array_equal(
            got_i.numpy() == -1, want_i == -1)
        live = want_i[want_i >= 0]
        assert live.min() >= 7 and live.max() < 40
    # the dispatching wrapper takes the plain route for CPU tensors
    wv, wi = t_kernel.topk_scores(
        torch.as_tensor(u), data, scale,
        None if st is None else torch.as_tensor(st), **kw)
    np.testing.assert_array_equal(wi.numpy(), got_i.numpy())


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_plain_topk_planted_ties_identical_ids(table_dtype):
    # integer factors: every sum is exact, so many scores tie exactly and
    # the (score desc, id asc) order alone decides — ids must be identical
    u, tbl, seen = _problem(5, m=60, integer=True)
    data, scale, jdata, jscale = _both_tables(tbl, table_dtype)
    movies, indptr = _csr(seen)
    st = t_kernel.build_seen_tiles(movies, indptr, np.arange(8),
                                   num_movies=60, tile_m=16)
    kw = dict(k_top=20, num_movies=60, tile_m=16)
    got_v, got_i = t_kernel.topk_scores_plain(
        torch.as_tensor(u), data, scale, torch.as_tensor(st), **kw)
    want_v, want_i = _reference_topk(u, jdata, jscale, st, **kw)
    assert (np.diff(want_v, axis=1) == 0).sum() > 20  # ties are planted
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(got_i.numpy(), want_i)


def test_topk_validation_errors_match_reference():
    u = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="not divisible by tile_m"):
        t_kernel.topk_scores(u, torch.zeros((20, 8)), None, None, k_top=2,
                             num_movies=20, tile_m=16)
    with pytest.raises(ValueError, match="scale required"):
        t_kernel.topk_scores(u, torch.zeros((16, 8)), torch.zeros(16), None,
                             k_top=2, num_movies=16, tile_m=16)
    with pytest.raises(ValueError, match="k_top must be"):
        t_kernel.topk_scores(u, torch.zeros((16, 8)), None, None, k_top=0,
                             num_movies=16, tile_m=16)
    with pytest.raises(ValueError, match="seen_tiles shape"):
        t_kernel.topk_scores(u, torch.zeros((32, 8)), None,
                             torch.zeros((1, 4, 16), dtype=torch.int32),
                             k_top=2, num_movies=32, tile_m=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        t_kernel.topk_scores(u, torch.zeros((16, 8)), None,
                             torch.zeros((1, 4, 8), dtype=torch.int32),
                             k_top=2, num_movies=16, tile_m=16)


def test_compare_topk_flags_real_disagreements():
    # the agreement rule must excuse near-ties and nothing else
    want_v = np.asarray([[3.0, 2.0, 2.0 + 1e-7, 1.0, -np.inf]], np.float32)
    want_i = np.asarray([[7, 4, 9, 1, -1]])
    swapped_tie = want_i[:, [0, 2, 1, 3, 4]]
    assert compare_topk(want_v, swapped_tie, want_v, want_i)["ok"]
    swapped_far = want_i[:, [3, 1, 2, 0, 4]]
    rep = compare_topk(want_v, swapped_far, want_v, want_i)
    assert not rep["ok"] and rep["id_mismatches"] == 2
    off = want_v.copy()
    off[0, 3] += 1e-3
    assert not compare_topk(off, want_i, want_v, want_i)["ok"]
    tail = want_v.copy()
    tail[0, 4] = 0.5
    assert not compare_topk(tail, want_i, want_v, want_i)["ok"]


def test_split_plan_bounds():
    # pass 2 merges at most 32768 keys per user; every split holds whole
    # 256-row tiles and none is empty
    for b, m_pad, k_top in [(16, 61440, 100), (256, 61440, 100),
                            (64, 4096, 1024), (8, 64, 5), (1, 256, 1)]:
        bu, splits = t_kernel.split_plan(b, m_pad, k_top, 132)
        assert bu in (16, 32)
        assert splits * t_kernel._pow2_ceil(k_top) <= 32768
        bounds = split_bounds(splits, m_pad)
        assert bounds[0][0] == 0 and bounds[-1][1] == m_pad
        assert all(lo < hi and lo % 256 == 0 for lo, hi in bounds)
        assert all(x[1] == y[0] for x, y in zip(bounds, bounds[1:]))


# -- host helpers, bit-equal -------------------------------------------------


def test_build_seen_tiles_and_pad_table_bit_equal():
    from cfk_tpu.serving.engine import pad_table as j_pad
    from cfk_tpu.serving.topk_kernel import build_seen_tiles as j_tiles

    rng = np.random.default_rng(2)
    seen = [np.sort(rng.choice(77, size=int(rng.integers(0, 40)),
                               replace=False)) for _ in range(6)]
    seen[2] = np.zeros(0, np.int64)
    movies, indptr = _csr(seen)
    for rows in (np.arange(6), np.asarray([4, 4, 0, 2])):
        for nt in (None, 7):
            kw = dict(num_movies=77, tile_m=16, num_tiles=nt)
            np.testing.assert_array_equal(
                t_kernel.build_seen_tiles(movies, indptr, rows, **kw),
                j_tiles(movies, indptr, rows, **kw))
    tbl = rng.standard_normal((77, 5)).astype(np.float32)
    for tile in (16, 77, 128):
        np.testing.assert_array_equal(t_engine.pad_table(tbl, tile),
                                      j_pad(tbl, tile))


def test_cluster_index_and_shortlist_bit_equal():
    from cfk_tpu.serving import cluster as j_cluster
    from cfk_tpu.serving import twostage as j_two
    from cfk_tpu_torch.serving import cluster as t_cluster

    rng = np.random.default_rng(4)
    m = rng.standard_normal((300, 8)).astype(np.float32)
    ti = t_cluster.build_cluster_index(m, 16, seed=3)
    ji = j_cluster.build_cluster_index(m, 16, seed=3)
    for f in ("centroids", "assign", "perm", "inv_perm", "offsets"):
        np.testing.assert_array_equal(getattr(ti, f), getattr(ji, f))
    cent, assign = t_cluster.kmeans_item_clusters(m, 300, seed=1, iters=2)
    jc, ja = j_cluster.kmeans_item_clusters(m, 300, seed=1, iters=2)
    np.testing.assert_array_equal(cent, jc)
    np.testing.assert_array_equal(assign, ja)
    cids = np.asarray([3, 1, 3, 9, 15])
    ts = t_two.build_shortlist(ti, cids, tile_m=16, min_rows=5)
    js = j_two.build_shortlist(ji, cids, tile_m=16, min_rows=5)
    for f in ("cluster_ids", "starts", "ends", "local_starts", "indices",
              "global_ids"):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
    assert (ts.rows, ts.rows_padded, ts.offset) == (js.rows, js.rows_padded,
                                                    js.offset)
    wide = t_two.build_shortlist(ti, [0], tile_m=16, min_rows=10_000)
    assert wide.rows == 300  # widened to every cluster
    seen = [np.sort(rng.choice(300, size=int(rng.integers(0, 30)),
                               replace=False)) for _ in range(5)]
    movies, indptr = _csr(seen)
    np.testing.assert_array_equal(
        t_two.shortlist_seen_tiles(ti, ts, movies, indptr, 5, tile_m=16),
        j_two.shortlist_seen_tiles(ji, js, movies, indptr, 5, tile_m=16))
    ids = np.asarray([[ts.offset, ts.offset + 3, -1],
                      [ts.offset + ts.rows - 1, -1, -1]])
    np.testing.assert_array_equal(t_two.map_shortlist_ids(ids, ts),
                                  j_two.map_shortlist_ids(ids, js))
    assert t_two.recall_at_k(ids, ids) == j_two.recall_at_k(ids, ids) == 1.0


@pytest.mark.parametrize("movies", [1, 30, 59_047, 1_000_000])
def test_default_two_stage_params_match_reference(movies):
    from cfk_tpu.serving.twostage import default_two_stage_params as j_dp

    assert t_two.default_two_stage_params(movies) == j_dp(movies)
    c, p = t_two.default_two_stage_params(movies, clusters=1024)
    assert c == 1024 and t_two.estimated_recall(c, p) >= 0.95
    assert t_two.estimated_recall(c, p - 1) < 0.95


def test_serve_synthetic_data_matches_bench():
    import bench

    args = types.SimpleNamespace(serve_users=500, serve_movies=300,
                                 serve_rank=16, serve_nnz=20_000)
    pool = np.asarray([3, 3, 0, 77, 499, 12])
    want_u, want_m = bench._serve_factors(args, np.random.default_rng(7))
    want_seen = bench._serve_seen_csr(args, pool, np.random.default_rng(8))
    from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr

    u, m = serve_factors(500, 300, 16, np.random.default_rng(7))
    seen = serve_seen_csr(500, 300, 20_000, pool, np.random.default_rng(8))
    np.testing.assert_array_equal(u, want_u)
    np.testing.assert_array_equal(m, want_m)
    for got, want in zip(seen, want_seen):
        np.testing.assert_array_equal(got, want)


# -- engine ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """A small trained problem: (port RatingsIndex, JAX RatingsIndex, U, M)."""
    from cfk_tpu.data.blocks import RatingsIndex as JIndex
    from cfk_tpu.data.synthetic import synthetic_netflix_coo
    from cfk_tpu_torch.data.blocks import RatingsIndex

    coo = synthetic_netflix_coo(120, 70, 2400, seed=6)
    ds, jds = RatingsIndex.from_coo(coo), JIndex.from_coo(coo)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((ds.user_map.num_entities, 8)).astype(np.float32)
    m = rng.standard_normal((ds.movie_map.num_entities, 8)).astype(np.float32)
    return ds, jds, u, m


def _engine(tiny, **kw):
    ds, _, u, m = tiny
    model = types.SimpleNamespace(
        user_factors=torch.as_tensor(u), movie_factors=torch.as_tensor(m),
        num_users=u.shape[0], num_movies=m.shape[0])
    return t_engine.engine_from_model(model, ds, **dict(dict(tile_m=16), **kw))


def test_engine_exact_matches_recommend_oracle(tiny):
    from cfk_tpu.eval.recommend import recommend_top_k as j_recommend

    _, jds, u, m = tiny
    eng = _engine(tiny)
    jmodel = types.SimpleNamespace(user_factors=u, movie_factors=m,
                                   num_users=u.shape[0], num_movies=m.shape[0])
    rows = np.arange(0, u.shape[0], 7)
    got_v, got_i = eng.topk(rows, 6)
    want_v, want_i = j_recommend(jmodel, rows, 6, dataset=jds)
    ext_v, _ = j_recommend(jmodel, rows, 7, dataset=jds)
    assert_topk_close(got_v, got_i, want_v, want_i, ext_v)
    assert eng.last_scan["serve_mode"] == "exact"
    assert eng.last_scan["bytes_scanned_per_batch"] > 0
    got_v, got_i = eng.topk(rows, 6, exclude_seen=False)
    want_v, want_i = j_recommend(jmodel, rows, 6)
    ext_v, _ = j_recommend(jmodel, rows, 7)
    assert_topk_close(got_v, got_i, want_v, want_i, ext_v)


def test_engine_validation_and_prewarm(tiny):
    eng = _engine(tiny)
    with pytest.raises(ValueError, match="out of range"):
        eng.topk(np.asarray([10_000]), 3)
    with pytest.raises(ValueError, match="k must be"):
        eng.topk(np.asarray([1]), eng.num_movies + 1)
    with pytest.raises(ValueError, match="serve_mode"):
        _engine(tiny, serve_mode="ivf")
    assert not eng.ready
    warm = eng.prewarm(5, max_batch=32)
    assert set(warm) == {"programs", "new_traces", "prewarm_s"}
    assert warm["programs"] == 3 and eng.ready  # batches 8, 16, 32
    assert eng.prewarm(5, max_batch=32)["new_traces"] == 0


def test_engine_overlay_and_on_commit(tiny):
    ds, _, u, m = tiny
    eng = _engine(tiny)
    row = 3
    _, before = eng.topk(np.asarray([row]), 5)
    new_u = np.random.default_rng(9).standard_normal(8).astype(np.float32)
    eng.on_commit({"rows": [new_u], "touched_rows": [row],
                   "cells": [(row, int(before[0, 0]))]})
    assert eng.invalidations == 1
    got_v, got_i = eng.topk(np.asarray([row]), 5)
    u2 = u.copy()
    u2[row] = new_u
    seen_m, seen_p = t_engine.seen_csr(ds)
    fresh = t_engine.ServeEngine(u2, m, num_users=u.shape[0],
                                 num_movies=m.shape[0], seen_movies=seen_m,
                                 seen_indptr=seen_p, tile_m=16, device="cpu")
    fresh._seen_hot[row] = [int(before[0, 0])]
    want_v, want_i = fresh.topk(np.asarray([row]), 5)
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_i, want_i)
    assert int(before[0, 0]) not in got_i[0].tolist()
    # movie deltas land in place; the next batch scores the new rows
    m2 = m.copy()
    m2[[1, 4]] = np.random.default_rng(10).standard_normal((2, 8))
    eng.on_commit({"movie_rows": [1, 4, 10_000],
                   "movie_row_factors": np.concatenate([m2[[1, 4]],
                                                        np.ones((1, 8))])})
    fresh.apply_movie_deltas([1, 4], m2[[1, 4]])
    np.testing.assert_array_equal(eng.topk(np.asarray([row]), 5)[1],
                                  fresh.topk(np.asarray([row]), 5)[1])
    # a retrain swaps both sides and drops the hot overlay
    u3 = u[::-1].copy()
    eng.on_commit({"retrain": True, "user_factors": u3, "movie_factors": m})
    assert eng.table_swaps == 1 and eng.epoch == 1
    base = t_engine.ServeEngine(u3, m, num_users=u.shape[0],
                                num_movies=m.shape[0], seen_movies=seen_m,
                                seen_indptr=seen_p, tile_m=16, device="cpu")
    base._seen_hot[row] = [int(before[0, 0])]
    np.testing.assert_array_equal(eng.topk(np.arange(9), 5)[1],
                                  base.topk(np.arange(9), 5)[1])


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_two_stage_recall_and_fallback(table_dtype):
    from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr

    rng = np.random.default_rng(0)
    u, m = serve_factors(400, 600, 16, rng)
    rows = np.arange(64)
    seen, indptr = serve_seen_csr(400, 600, 8_000, rows, rng)
    eng = t_engine.ServeEngine(u, m, num_users=400, num_movies=600,
                               seen_movies=seen, seen_indptr=indptr,
                               table_dtype=table_dtype, tile_m=32,
                               serve_mode="two_stage", clusters=32,
                               device="cpu")
    got_v, got_i = eng.topk(rows, 10)
    assert eng.last_scan["serve_mode"] == "two_stage"
    assert eng.last_scan["shortlist_rows"] < 600
    _, exact_i = eng.topk(rows, 10, force_exact=True)
    assert t_two.recall_at_k(got_i, exact_i) >= 0.95
    assert eng.two_stage_fallbacks == 0
    # a corrupt index degrades to the exact scan: the same ids as exact
    eng._cluster[0].centroids[0, 0] = np.nan
    _, deg_i = eng.topk(rows, 10)
    np.testing.assert_array_equal(deg_i, exact_i)
    assert eng.two_stage_fallbacks == 1 and "non-finite" in eng.last_fault
    eng.load_state(u, m)  # a table swap rebuilds the index and re-arms
    eng.topk(rows, 10)
    assert eng.last_scan["serve_mode"] == "two_stage"


# -- model, checkpoints, frames ----------------------------------------------


@pytest.fixture(scope="module")
def jax_trained(tmp_path_factory):
    """Factors trained by cfk_tpu.train_als, checkpointed by the JAX
    package's CheckpointManager."""
    import warnings

    from cfk_tpu.config import ALSConfig
    from cfk_tpu.data.blocks import Dataset
    from cfk_tpu.data.synthetic import synthetic_netflix_coo
    from cfk_tpu.models.als import train_als
    from cfk_tpu.transport.checkpoint import CheckpointManager

    coo = synthetic_netflix_coo(80, 40, 1500, seed=8)
    ds = Dataset.from_coo(coo)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = train_als(ds, ALSConfig(rank=4, num_iterations=3))
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    CheckpointManager(d, async_write=False).save(
        3, np.asarray(model.user_factors), np.asarray(model.movie_factors),
        meta={"rank": 4, "model": "als"})
    return coo, ds, model, d


def test_recommend_top_k_on_jax_trained_checkpoint(jax_trained):
    from cfk_tpu_torch.data.blocks import RatingsIndex
    from cfk_tpu_torch.weights import model_from_checkpoint

    coo, jds, jmodel, d = jax_trained
    ds = RatingsIndex.from_coo(coo)
    model = model_from_checkpoint(d, num_users=ds.user_map.num_entities,
                                  num_movies=ds.movie_map.num_entities,
                                  device="cpu")
    rows = np.arange(ds.user_map.num_entities)
    got_v, got_i = model.recommend_top_k(rows, 5, dataset=ds)
    want_v, want_i = jmodel.recommend_top_k(rows, 5, dataset=jds)
    ext_v, _ = jmodel.recommend_top_k(rows, 6, dataset=jds)
    assert_topk_close(got_v, got_i, np.asarray(want_v), np.asarray(want_i),
                      np.asarray(ext_v))
    with pytest.raises(ValueError, match="smaller than the data"):
        model_from_checkpoint(d, num_users=10_000, num_movies=1,
                              device="cpu")


def test_checkpoints_cross_read(tmp_path, jax_trained):
    import ml_dtypes

    from cfk_tpu.transport.checkpoint import CheckpointManager as JManager
    from cfk_tpu_torch.transport.checkpoint import (
        CheckpointCorruptError,
        CheckpointManager,
    )

    _, _, _, jdir = jax_trained
    want = JManager(jdir, async_write=False).restore()
    got = CheckpointManager(jdir).restore()
    assert got.iteration == want.iteration == 3 and got.meta == want.meta
    np.testing.assert_array_equal(got.user_factors, want.user_factors)
    np.testing.assert_array_equal(got.movie_factors, want.movie_factors)
    assert CheckpointManager(jdir).manifest_meta(3) == {"rank": 4,
                                                        "model": "als"}
    rng = np.random.default_rng(1)
    u = rng.standard_normal((9, 3)).astype(np.float32)
    m = rng.standard_normal((5, 3)).astype(np.float32)
    port = CheckpointManager(str(tmp_path / "port"))
    port.save(2, torch.as_tensor(u), m, meta={"model": "als"})
    back = JManager(str(tmp_path / "port"), async_write=False).restore()
    assert back.iteration == 2 and back.meta == {"model": "als"}
    np.testing.assert_array_equal(back.user_factors, u)
    np.testing.assert_array_equal(back.movie_factors, m)
    # bfloat16 factors: float32 on disk, the dtype in the manifest
    jb = JManager(str(tmp_path / "bf16"), async_write=False)
    jb.save(1, u.astype(ml_dtypes.bfloat16), m.astype(ml_dtypes.bfloat16))
    bf = CheckpointManager(str(tmp_path / "bf16")).restore()
    assert bf.user_factors.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf.user_factors.float().numpy(),
        u.astype(ml_dtypes.bfloat16).astype(np.float32))
    port.save(4, torch.as_tensor(u).to(torch.bfloat16), m)
    jback = JManager(str(tmp_path / "port"), async_write=False).restore(4)
    assert jback.user_factors.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(
        jback.user_factors.astype(np.float32),
        torch.as_tensor(u).to(torch.bfloat16).float().numpy())
    # a corrupt payload is refused; the newest valid step is served instead
    assert port.iterations() == [2, 4] and port.latest_iteration() == 4
    with open(tmp_path / "port" / "step_0000004" / "movie.npy", "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\x00\x01\x02\x03")
    with pytest.raises(CheckpointCorruptError, match="checksum"):
        port.restore(4)
    with pytest.warns(UserWarning, match="corrupt"):
        assert port.latest_valid_iteration() == 2
    with pytest.warns(UserWarning):
        assert port.restore().iteration == 2


def test_score_frames_cross_decode():
    from cfk_tpu.transport import serdes as js
    from cfk_tpu_torch.transport import serdes as ts

    req = dict(req_id=(1 << 40) + 7, user=123, k=10, reply_partition=3)
    tb = ts.encode_score_request(ts.ScoreRequest(**req))
    assert tb == js.encode_score_request(js.ScoreRequest(**req))
    assert js.decode_score_request(tb) == js.ScoreRequest(**req)
    assert ts.decode_score_request(tb) == ts.ScoreRequest(**req)
    for kw in (dict(error=""), dict(error="überlastet", retriable=True),
               dict(epoch=3, staleness=-1)):
        ids = np.asarray([4, -1], np.int32)
        sc = np.asarray([1.5, -np.inf], np.float32)
        n = 0 if kw.get("error") else 2
        tb = ts.encode_score_response(ts.ScoreResponse(
            req_id=9, movie_rows=ids[:n], scores=sc[:n], **kw))
        jb = js.encode_score_response(js.ScoreResponse(
            req_id=9, movie_rows=ids[:n], scores=sc[:n], **kw))
        assert tb == jb
        a, b = ts.decode_score_response(jb), js.decode_score_response(tb)
        assert (a.req_id, a.error, a.retriable, a.epoch, a.staleness) == (
            b.req_id, b.error, b.retriable, b.epoch, b.staleness)
        np.testing.assert_array_equal(a.movie_rows, b.movie_rows)
        np.testing.assert_array_equal(a.scores, b.scores)
    with pytest.raises(ValueError):
        ts.decode_score_request(b"\x00" * 3)
    with pytest.raises(ValueError):
        ts.decode_score_response(b"\x00" * 20)


# -- server, load generator, CLI ---------------------------------------------


def test_server_round_trip_and_coalescing(tiny):
    from cfk_tpu_torch.serving import (
        RecommendServer,
        ServeClient,
        ensure_serve_topics,
    )
    from cfk_tpu_torch.transport.broker import InMemoryBroker

    eng = _engine(tiny)
    broker = InMemoryBroker()
    ensure_serve_topics(broker)
    server = RecommendServer(eng, broker)
    client = ServeClient(broker)
    got = client.ask([3, 5, 9, 2], 4, server=server)
    assert len(got) == 4 and server.batches == 1  # coalesced into one batch
    s, i = eng.topk(np.asarray([5]), 4)
    resp = got[sorted(got)[1]]
    np.testing.assert_array_equal(resp.movie_rows, i[0])
    np.testing.assert_array_equal(resp.scores, s[0])
    mixed = client.ask([1], 2, server=server)
    assert next(iter(mixed.values())).movie_rows.shape == (2,)
    bad = client.request(10_000, 4)
    good = client.request(3, 4)
    broker.produce("serve-requests", key=0, value=b"\x00" * 5, partition=0)
    server.step()
    by_id = {r.req_id: r for r in client.poll_responses()}
    assert by_id[bad].error and by_id[bad].movie_rows.size == 0
    assert not by_id[good].error and by_id[good].movie_rows.size == 4
    assert server.malformed_requests == 1


def test_loadgen_open_loop_report(tiny):
    from cfk_tpu_torch.serving import (
        RecommendServer,
        ServeClient,
        ensure_serve_topics,
        run_open_loop,
        zipf_user_rows,
    )
    from cfk_tpu.serving.loadgen import zipf_user_rows as j_zipf
    from cfk_tpu_torch.transport.broker import InMemoryBroker

    eng = _engine(tiny)
    broker = InMemoryBroker()
    ensure_serve_topics(broker)
    server = RecommendServer(eng, broker, max_batch=8)
    client = ServeClient(broker)
    rows = zipf_user_rows(eng.num_users, 20, seed=3)
    np.testing.assert_array_equal(rows, j_zipf(eng.num_users, 20, seed=3))
    rep = run_open_loop(client, rate_qps=2000.0, num_requests=20,
                        user_rows=rows, k=3, server=server, drive_server=True)
    row = rep.as_row()
    assert row["answered"] == row["requests"] == 20
    assert row["qps"] > 0 and row["batches"] >= 1
    assert row["p50_ms"] <= row["p99_ms"] <= row["max_ms"]
    assert set(row) == {"requests", "answered", "wall_s", "qps_target", "qps",
                        "p50_ms", "p99_ms", "max_ms", "batches", "mean_batch"}


@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    from cfk_tpu.data.synthetic import synthetic_netflix_coo

    coo = synthetic_netflix_coo(300, 60, 3000, seed=4)
    path = tmp_path_factory.mktemp("serve_cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    return str(path), coo


def test_cli_train_recommend_predict_serve(ratings_file, tmp_path, capsys):
    import json

    from cfk_tpu_torch.cli import main

    data, coo = ratings_file
    ckpt = str(tmp_path / "ckpt")
    assert main(["train", "--data", data, "--rank", "4", "--iterations", "3",
                 "--device", "cpu", "--output", "none", "--checkpoint-dir",
                 ckpt]) == 0
    mse_train = float(capsys.readouterr().out.split("mse=")[1].split()[0])
    users = sorted(set(coo.user_raw.tolist()))[:3]
    assert main(["recommend", "--checkpoint-dir", ckpt, "--data", data,
                 "--users", ",".join(map(str, users)), "-k", "4",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [int(x.split("\t")[0]) for x in lines] == users
    assert all(len(x.split("\t")[1].split(",")) == 4 for x in lines)
    preds = str(tmp_path / "preds.csv")
    assert main(["predict", "--checkpoint-dir", ckpt, "--data", data,
                 "--output", preds, "--device", "cpu"]) == 0
    capsys.readouterr()
    assert main(["evaluate", data, preds]) == 0
    mse = float(capsys.readouterr().out.split("MSE:")[1].split()[0])
    assert abs(mse - mse_train) <= 1e-4 * mse_train
    for mode in ("exact", "two_stage"):
        assert main(["serve", "--checkpoint-dir", ckpt, "--data", data,
                     "-k", "5", "--tile-m", "16", "--max-batch", "8",
                     "--serve-mode", mode, "--loadgen-requests", "24",
                     "--loadgen-qps", "400", "--device", "cpu"]) == 0
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["answered"] == row["requests"] == 24
        assert row["serve_mode"] == mode and row["device"] == "cpu"
    assert main(["recommend", "--checkpoint-dir", str(tmp_path / "none"),
                 "--data", data, "--users", "all", "--device", "cpu"]) == 1
