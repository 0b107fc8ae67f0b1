"""The port's sharded trainers and sharded serving against cfk_tpu, on the CPU.

The JAX package runs its shard_map steps on the conftest's virtual CPU
devices; the port runs the same S on S gloo ranks (``make_mesh(S, "cpu")``,
one PyTorch thread each).  ``jax.random`` cannot be reproduced in torch, so
the JAX package's own sharded init (threefry at the real user count, as its
``train_als_sharded`` draws it) reaches the port through ``warm_start``.

Tolerances, relative to max|x| of the reference's factors: one iteration
(the movie half-step from u0, then the user half-step from it) at 1e-5;
three iterations at 1e-4, with the train MSE within 1e-4.  The rings sum
their visits' Grams in another order than one rank does, so sharded factors
are held to one-rank factors at a tolerance too.  Bit-exact are the port's
hierarchical ring with a degenerate inner or outer ring against its flat
ring, overlap on against off, and the sharded top-K against the one-rank
scan (ties included).  Covers ``tests/test_spmd.py:24-89`` and the
two-process run of ``tests/test_multihost.py:32``.
"""

import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfk_tpu.compat import emulate_topk_scores
from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data import blocks as jblocks
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.eval.metrics import mse_rmse_from_blocks as j_mse
from cfk_tpu.models.ials import IALSConfig as JIConfig
from cfk_tpu.models.ials import train_ials_sharded as j_train_ials_sharded
from cfk_tpu.ops.solve import init_factors as j_init_factors
from cfk_tpu.ops.solve import init_factors_stats as j_init_stats
from cfk_tpu.parallel import mesh as jmesh
from cfk_tpu.parallel.spmd import train_als_sharded as j_train_sharded
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
from cfk_tpu_torch.models.ials import IALSConfig, train_ials_sharded
from cfk_tpu_torch.parallel import mesh as tmesh
from cfk_tpu_torch.parallel import spmd
from cfk_tpu_torch.parallel.launch import (
    communicate_all,
    free_port,
    spawn_workers,
)
from cfk_tpu_torch.parallel.spmd import (
    hier_phase_count,
    hier_phase_of_visit,
    serve_topk_sharded,
    train_als_sharded,
)
from cfk_tpu_torch.serving.topk_kernel import topk_scores_plain

ROOT = __file__.rsplit("/tests/", 1)[0]
K = 8


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(200, 80, 3000, seed=9)


@pytest.fixture(scope="module")
def meshes():
    """Port rank groups of 2 and 4 ranks, spawned once for the module."""
    out = {}
    try:
        out[2] = tmesh.make_mesh(2, "cpu", quiet=True)
        out[4] = tmesh.make_mesh(4, "cpu", quiet=True)
        yield out
    finally:
        for m in out.values():
            m.close()


def _rel(got, want) -> float:
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ref_init(jds, rank, seed):
    """The JAX package's sharded init (``cfk_tpu/parallel/spmd.py:1405``):
    threefry at the real user count, then zero-padded; zero movies."""
    ub, mb = jds.user_blocks, jds.movie_blocks
    key = jax.random.PRNGKey(seed)
    kw = dict(rank=rank, num_entities=ub.num_entities)
    stat = ("rank", "num_entities")
    if isinstance(ub, jblocks.PaddedBlocks):
        u = jax.jit(j_init_factors, static_argnames=stat)(
            key, ub.rating, ub.mask, ub.count, **kw)
    else:
        u = jax.jit(j_init_stats, static_argnames=stat)(
            key, ub.rating_sum, ub.count, **kw)
    return np.asarray(u), np.zeros((mb.padded_entities, rank), np.float32)


TILED = dict(layout="tiled", chunk_elems=512, tile_rows=16)
# id: (shards, exchange, build kwargs, extra config)
CASES = {
    "padded-all_gather-2": (2, "all_gather", dict(layout="padded"), {}),
    "padded-ring-2": (2, "ring", dict(layout="padded"), {}),
    "padded-ring-4": (4, "ring", dict(layout="padded"), {}),
    "tiled-all_gather-2": (2, "all_gather", dict(
        TILED, accum_max_entities=60, dense_stream=True), {}),
    "tiled-ring-2": (2, "ring", dict(TILED, ring=True), {}),
    "tiled-ring-4": (4, "ring", dict(TILED, ring=True), {}),
    "tiled-hier_ring-4": (4, "hier_ring", dict(TILED, ring=True),
                          dict(ici_group=2)),
    "tiled-auto-2": (2, "auto", dict(TILED, ring=(True, False),
                                     accum_max_entities=60,
                                     dense_stream=True), {}),
    "bucketed-all_gather-2": (2, "all_gather",
                              dict(layout="bucketed", chunk_elems=512), {}),
    "segment-all_gather-4": (4, "all_gather",
                             dict(layout="segment", chunk_elems=512), {}),
}


def _datasets(coo, shards, build):
    build = dict(build)
    if build.get("ring"):
        build["ring_warn"] = False
    if build["layout"] == "segment":
        # The JAX package sizes segment chunks for its ragged matmul; the
        # port by the segsum rule (chunk_elems // 64): ask for the same.
        jbuild = dict(build, chunk_elems=build["chunk_elems"] // 64)
    else:
        jbuild = build
    return (jblocks.Dataset.from_coo(coo, num_shards=shards, **jbuild),
            Dataset.from_coo(coo, num_shards=shards, **build))


def _pair(coo, meshes, case, iterations, implicit=False, ref_knobs=None,
          **extra):
    """(JAX model, port model, JAX dataset, port dataset) of one case from
    the same injected init; ``ref_knobs`` are the JAX run's alone."""
    shards, exchange, build, cfg_kw = case
    jds, tds = _datasets(coo, shards, build)
    kw = dict(rank=K, lam=0.05, num_iterations=iterations, seed=3,
              num_shards=shards, exchange=exchange, layout=build["layout"],
              **cfg_kw, **extra)
    jmesh_ = jmesh.make_mesh(shards)
    jkw = dict(kw, **(ref_knobs or {}))
    if implicit:
        jm = j_train_ials_sharded(jds, JIConfig(alpha=2.0, **jkw), jmesh_)
        tcfg = IALSConfig(alpha=2.0, **kw)
        trainer = train_ials_sharded
    else:
        jm = j_train_sharded(jds, JConfig(**jkw), jmesh_)
        tcfg = ALSConfig(**kw)
        trainer = train_als_sharded
    tm = trainer(tds, tcfg, meshes[shards],
                 warm_start=_ref_init(jds, K, 3))
    return jm, tm, jds, tds


@pytest.mark.parametrize("side", ["movie", "user"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_half_steps_match_reference(coo, meshes, name, side):
    """One half-step from the same injected factors, within 1e-5 of max|x|
    of the JAX package's: the movie half of one iteration, and the user
    half as the movie half of the transposed ratings (the roles swapped,
    each half's build flags with them)."""
    shards, exchange, build, cfg_kw = CASES[name]
    if side == "user":
        from cfk_tpu.data.blocks import RatingsCOO

        coo = RatingsCOO(movie_raw=coo.user_raw, user_raw=coo.movie_raw,
                         rating=coo.rating)
        if isinstance(build.get("ring"), tuple):
            build = dict(build, ring=build["ring"][::-1])
    jm, tm, _, _ = _pair(coo, meshes, (shards, exchange, build, cfg_kw), 1)
    assert _rel(tm.movie_factors, jm.movie_factors) <= 1e-5


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_als_sharded_matches_reference(coo, meshes, name):
    jm, tm, jds, tds = _pair(coo, meshes, CASES[name], 3)
    assert _rel(tm.user_factors, jm.user_factors) <= 1e-4
    assert _rel(tm.movie_factors, jm.movie_factors) <= 1e-4
    jmse, _ = j_mse(jm.predict_dense(), jds)
    tmse, _ = mse_rmse_from_model(tm, tds)
    assert abs(tmse - jmse) <= 1e-4
    assert tm.pipeline["route"] == "sharded"
    assert f"exchange {CASES[name][1]}" in tm.pipeline["reason"]


@pytest.mark.parametrize("name,algorithm", [
    ("bucketed-all_gather-2", "als"), ("segment-all_gather-4", "als"),
    ("tiled-all_gather-2", "als"), ("bucketed-all_gather-2", "ials++")])
def test_train_ials_sharded_matches_reference(coo, meshes, name, algorithm):
    extra = dict(algorithm=algorithm)
    if algorithm == "ials++":
        extra["block_size"] = 4
    jm, tm, jds, tds = _pair(coo, meshes, CASES[name], 3, implicit=True,
                             **extra)
    assert _rel(tm.user_factors, jm.user_factors) <= 1e-4
    assert _rel(tm.movie_factors, jm.movie_factors) <= 1e-4
    jmse, _ = j_mse(jm.predict_dense(), jds)
    tmse, _ = mse_rmse_from_model(tm, tds)
    assert abs(tmse - jmse) <= 1e-4


@pytest.mark.parametrize("ici_group", [1, 4])
def test_hier_ring_is_bit_equal_to_the_flat_ring(coo, meshes, ici_group):
    """A hierarchical ring with a degenerate inner (1) or outer (S) ring
    visits the slices in the flat ring's order: every bit equal.  With
    ``ici_group=2`` the visits reorder: equal to a float tolerance."""
    _, tds = _datasets(coo, 4, dict(TILED, ring=True))
    base = dict(rank=K, num_iterations=2, num_shards=4, layout="tiled")
    flat = train_als_sharded(tds, ALSConfig(exchange="ring", **base),
                             meshes[4])
    hier = train_als_sharded(tds, ALSConfig(exchange="hier_ring",
                                            ici_group=ici_group, **base),
                             meshes[4])
    assert torch.equal(flat.user_factors, hier.user_factors)
    assert torch.equal(flat.movie_factors, hier.movie_factors)
    mixed = train_als_sharded(tds, ALSConfig(exchange="hier_ring",
                                             ici_group=2, **base), meshes[4])
    assert _rel(mixed.user_factors, flat.user_factors) <= 1e-4
    assert hier_phase_count(4, 2) == 2
    assert [hier_phase_of_visit(v, 2) for v in range(4)] == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="must divide"):
        hier_phase_count(4, 3)


@pytest.mark.parametrize("layout,exchange", [("padded", "ring"),
                                             ("tiled", "ring")])
def test_overlap_on_and_off_are_bit_equal(coo, meshes, layout, exchange):
    build = dict(TILED, ring=True) if layout == "tiled" else dict(
        layout="padded")
    _, tds = _datasets(coo, 2, build)
    base = dict(rank=K, num_iterations=2, num_shards=2, layout=layout,
                exchange=exchange)
    on = train_als_sharded(tds, ALSConfig(overlap=True, **base), meshes[2])
    off = train_als_sharded(tds, ALSConfig(overlap=False, **base), meshes[2])
    assert torch.equal(on.user_factors, off.user_factors)
    assert torch.equal(on.movie_factors, off.movie_factors)


@pytest.mark.parametrize("name", ["padded-all_gather-2", "padded-ring-4",
                                  "tiled-ring-2", "tiled-auto-2",
                                  "bucketed-all_gather-2"])
def test_sharded_matches_the_ports_one_rank_run(coo, meshes, name):
    """The port's own init: drawn at the real user count, so the sharded
    run starts where ``train_als`` does and ends within 1e-4 of it (the
    padded all_gather run: bit for bit — the same ops on the same rows)."""
    shards, exchange, build, cfg_kw = CASES[name]
    _, tds = _datasets(coo, shards, build)
    one_build = {k: v for k, v in build.items() if k not in ("ring",)}
    one = train_als(Dataset.from_coo(coo, **one_build),
                    ALSConfig(rank=K, num_iterations=3,
                              layout=build["layout"]), device="cpu")
    sh = train_als_sharded(tds, ALSConfig(
        rank=K, num_iterations=3, num_shards=shards, exchange=exchange,
        layout=build["layout"], **cfg_kw), meshes[shards])
    nu, nm = one.num_users, one.num_movies
    tol = 0.0 if name == "padded-all_gather-2" else 1e-4
    assert _rel(sh.user_factors[:nu], one.user_factors[:nu]) <= tol
    assert _rel(sh.movie_factors[:nm], one.movie_factors[:nm]) <= tol


@pytest.mark.parametrize("layout,exchange,table_dtype", [
    ("padded", "ring", "bfloat16"), ("tiled", "ring", "bfloat16"),
    ("tiled", "ring", "int8"), ("tiled", "all_gather", "int8")])
def test_quantized_payloads_match_reference(coo, meshes, layout, exchange,
                                            table_dtype):
    """bf16 and int8 tables: the ring rotates the quantized payload (int8:
    codes and scales together), the all_gather moves f32 and the half-step
    quantizes.  The movie half from the same u0 quantizes the same rows:
    within 1e-5 of the JAX package's.  Later halves quantize factors that
    differ in their last bits, and one flipped int8 code moves a row by a
    whole quantization step (≈1% of its norm here), so three iterations are
    held by their train MSE, within 1e-3 of the reference's."""
    build = dict(layout="padded")
    if layout == "tiled":
        build = (dict(TILED, ring=True) if exchange == "ring" else
                 dict(TILED, accum_max_entities=60, dense_stream=True))
    case = (2, exchange, build, {})
    jm, tm, _, _ = _pair(coo, meshes, case, 1, table_dtype=table_dtype)
    assert _rel(tm.movie_factors, jm.movie_factors) <= 1e-5
    jm, tm, jds, tds = _pair(coo, meshes, case, 3, table_dtype=table_dtype)
    jmse, _ = j_mse(jm.predict_dense(), jds)
    tmse, _ = mse_rmse_from_model(tm, tds)
    assert abs(tmse - jmse) <= 1e-3 * jmse


@pytest.mark.parametrize("layout", ["padded", "tiled"])
def test_a_local_fault_trips_every_rank_in_lockstep(coo, meshes, layout):
    """NaN rows in rank 1's users only, the sentinel every iteration: the
    agreed probe word trips both ranks at the same boundary (rank 0's
    metrics record the rollback its own rows never saw), and the retry
    ends bit-equal to the fault-free run (``tests/multihost_worker.py``'s
    lockstep drill)."""
    from cfk_tpu_torch.resilience.faults import FactorCorruption, FaultInjector
    from cfk_tpu_torch.telemetry.metrics import Metrics

    build = dict(TILED, ring=True) if layout == "tiled" else dict(
        layout="padded")
    _, tds = _datasets(coo, 2, build)
    cfg = ALSConfig(rank=K, num_iterations=4, num_shards=2, layout=layout,
                    exchange="ring", health_check_every=1)
    clean = train_als_sharded(tds, cfg, meshes[2])
    metrics = Metrics()
    inj = FaultInjector(FactorCorruption(iteration=2, side="u", rows=(0, 3),
                                         only_process=1))
    got = train_als_sharded(tds, cfg, meshes[2], metrics=metrics,
                            fault_injector=inj)
    assert metrics.counters["rollbacks"] == 1
    assert metrics.counters["health_trips"] == 1
    assert torch.equal(got.user_factors, clean.user_factors)
    assert torch.equal(got.movie_factors, clean.movie_factors)


def test_checkpointed_mesh_run_resumes_bit_equal(coo, meshes, tmp_path):
    """Through a ``Mesh`` the checkpoint store and the watchdog are pickled
    to every rank and rank 0 alone writes the steps; a longer rerun over
    the same store resumes at its newest step (read by rank 0, broadcast)
    and ends bit-equal to an uninterrupted run."""
    from cfk_tpu_torch.resilience.preempt import StallWatchdog
    from cfk_tpu_torch.telemetry.metrics import Metrics
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    _, tds = _datasets(coo, 2, dict(layout="padded"))

    def cfg(n):
        return ALSConfig(rank=K, num_iterations=n, num_shards=2,
                         exchange="ring")

    train_als_sharded(tds, cfg(4), meshes[2],
                      checkpoint_manager=CheckpointManager(str(tmp_path)),
                      checkpoint_every=2, watchdog=StallWatchdog(60.0))
    store = CheckpointManager(str(tmp_path))
    assert store.iterations() == [2, 4]
    assert store.restore().meta["num_shards"] == 2
    metrics = Metrics()
    resumed = train_als_sharded(tds, cfg(6), meshes[2],
                                checkpoint_manager=store,
                                checkpoint_every=2, metrics=metrics)
    assert metrics.counters["iterations"] == 2
    full = train_als_sharded(tds, cfg(6), meshes[2])
    assert torch.equal(resumed.user_factors, full.user_factors)
    assert torch.equal(resumed.movie_factors, full.movie_factors)


def test_ring_health_flags_a_nonfinite_payload():
    """The ring half-steps fold an ``isfinite`` probe of every rotated
    block into their result; a bad block sets the flag (the sentinel's
    ``RING_EXCHANGE`` bit), a clean one leaves it 0."""
    from cfk_tpu_torch.data.blocks import Dataset as TDataset
    from cfk_tpu_torch.parallel.spmd import (
        _side_to_device,
        half_step_tiled_ring,
    )

    ds = TDataset.from_coo(synthetic_netflix_coo(60, 30, 600, seed=1),
                           layout="tiled", chunk_elems=256, tile_rows=16,
                           ring=True, ring_warn=False)
    group = tmesh.ShardGroup(device="cpu")
    blk, chunks, e = _side_to_device("tiled_ring", ds.movie_blocks, 60,
                                     "cpu", weighted=False)
    u = torch.rand(60, 4)
    for bad_row, want in ((None, 0), (5, 1)):
        table = u.clone()
        if bad_row is not None:
            table[bad_row, 1] = float("nan")
        for td in ("float32", "int8"):
            _, bad = half_step_tiled_ring(group, table, blk, chunks, e,
                                          lam=0.05, health=True,
                                          table_dtype=td)
            assert int(bad) == want


def test_bfloat16_factor_storage_and_chunked_ring(coo, meshes):
    """``tests/test_spmd.py:63-89``: bf16 factors stay bf16 through the
    sharded trainer and train in range; a chunked padded ring matches the
    unchunked one."""
    _, tds = _datasets(coo, 2, dict(layout="padded"))
    m = train_als_sharded(tds, ALSConfig(rank=5, num_iterations=4,
                                         num_shards=2, dtype="bfloat16"),
                          meshes[2])
    assert m.user_factors.dtype == torch.bfloat16
    ref = train_als_sharded(tds, ALSConfig(rank=5, num_iterations=4,
                                           num_shards=2), meshes[2])
    assert mse_rmse_from_model(m, tds)[0] <= \
        1.05 * mse_rmse_from_model(ref, tds)[0]
    base = dict(rank=3, num_iterations=2, num_shards=2, exchange="ring")
    full = train_als_sharded(tds, ALSConfig(**base), meshes[2])
    chunked = train_als_sharded(tds, ALSConfig(solve_chunk=7, **base),
                                meshes[2])
    assert _rel(chunked.user_factors, full.user_factors) <= 1e-4


def test_serve_topk_sharded_is_bit_equal(meshes):
    """Integer tables (exact ties) with seen rows: the two-rank scan equals
    one-rank K4 (its plain version) and the JAX package's per-shard scans
    merged as its ``serve_topk_sharded`` merges them, bit for bit."""
    from cfk_tpu.serving.topk_kernel import build_seen_tiles

    rng = np.random.default_rng(0)
    nm, tile, k = 250, 32, 10
    table = np.zeros((256, K), np.float32)
    table[:nm] = rng.integers(-3, 4, (nm, K))
    u = rng.integers(-2, 3, (6, K)).astype(np.float32)
    seen_movies = rng.integers(0, nm, 20).astype(np.int32)
    indptr = np.array([0, 5, 5, 9, 14, 20, 20], np.int64)
    seen = build_seen_tiles(seen_movies, indptr, np.arange(6), num_movies=nm,
                            tile_m=tile, num_tiles=256 // tile)
    kw = dict(k_top=k, num_movies=nm, tile_m=tile)
    one = topk_scores_plain(torch.tensor(u), torch.tensor(table), None,
                            torch.tensor(np.asarray(seen)), **kw)
    got = serve_topk_sharded(meshes[2], torch.tensor(u), torch.tensor(table),
                             None, torch.tensor(np.asarray(seen)), **kw)
    # The JAX package's per-rank halves at their row offsets, merged by
    # lax.top_k (its serve_topk_sharded's shard_map refuses its
    # interpret-mode kernel on the CPU).
    halves = [emulate_topk_scores(
        jnp.asarray(u), jnp.asarray(table[r * 128:(r + 1) * 128]), None,
        jnp.asarray(np.asarray(seen)[r * 4:(r + 1) * 4]),
        row_offset=r * 128, **kw) for r in range(2)]
    mv, pos = jax.lax.top_k(jnp.concatenate([h[0] for h in halves], 1), k)
    mi = jnp.take_along_axis(jnp.concatenate([h[1] for h in halves], 1),
                             pos, 1)
    for a, b, c in zip(got, one, (mv, mi)):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_engine_mesh_branch_is_bit_equal(meshes):
    from cfk_tpu_torch.serving import ServeEngine

    rng = np.random.default_rng(1)
    uu = rng.standard_normal((30, K)).astype(np.float32)
    mm = rng.integers(-3, 4, (100, K)).astype(np.float32)
    kw = dict(num_users=30, num_movies=100, tile_m=16, device="cpu")
    one = ServeEngine(uu, mm, **kw)
    sharded = ServeEngine(uu, mm, mesh=meshes[4], **kw)
    assert sharded.table_rows % (4 * 16) == 0
    assert isinstance(sharded._placed, spmd.PlacedTable)
    for a, b in zip(one.topk(np.arange(9), 7), sharded.topk(np.arange(9), 7)):
        np.testing.assert_array_equal(a, b)
    # The ranks' placed slices follow a rollover and a row delta.
    mm2 = rng.integers(-3, 4, (100, K)).astype(np.float32)
    rows = np.array([3, 50, 99])
    delta = rng.integers(-3, 4, (3, K)).astype(np.float32)
    for eng in (one, sharded):
        eng.load_state(uu, mm2)
        eng.apply_movie_deltas(rows, delta)
    assert sharded._placed.version == 3
    for a, b in zip(one.topk(np.arange(30), 9), sharded.topk(np.arange(30),
                                                              9)):
        np.testing.assert_array_equal(a, b)


def test_placed_tables_keep_the_newest_two_versions():
    """A rank keeps the newest two versions of a placed table (a batch that
    took its handle before a rollover still finds it) and names a dropped
    one; the placed scan equals the shipped one."""
    group = tmesh.ShardGroup(device="cpu")
    rng = np.random.default_rng(3)
    table = torch.tensor(rng.integers(-3, 4, (64, K)).astype(np.float32))
    u = torch.tensor(rng.standard_normal((4, K)).astype(np.float32))
    kw = dict(k_top=5, num_movies=60, tile_m=16)
    try:
        for v in (1, 2, 3):
            spmd._place_rank(group, table * v, None, name="t", version=v)
        assert sorted(spmd._PLACED["t"]) == [2, 3]
        got = spmd._serve_rank_entry(group, u, None, None, None, 0,
                                     placed=("t", 3), **kw)
        want = spmd._serve_rank_entry(group, u, table * 3, None, None, 0,
                                      **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        with pytest.raises(KeyError, match="no placed table 't' version 1"):
            spmd._serve_rank_entry(group, u, None, None, None, 0,
                                   placed=("t", 1), **kw)
    finally:
        spmd._PLACED.pop("t", None)


def test_sharded_checks_refuse_mismatched_blocks(coo, meshes):
    _, tds = _datasets(coo, 2, dict(TILED, ring=True))
    with pytest.raises(ValueError, match="built with ring=True"):
        train_als_sharded(tds, ALSConfig(rank=K, num_shards=2,
                                         layout="tiled"), meshes[2])
    with pytest.raises(ValueError, match="mesh has 2 ranks"):
        train_als_sharded(tds, ALSConfig(rank=K, num_shards=4,
                                         layout="tiled", exchange="ring"),
                          meshes[2])
    _, bds = _datasets(coo, 2, dict(layout="bucketed", chunk_elems=512))
    with pytest.raises(ValueError, match="all_gather"):
        ALSConfig(rank=K, num_shards=2, layout="bucketed", exchange="ring")
    with pytest.raises(ValueError, match="ring-built"):
        train_ials_sharded(tds, IALSConfig(rank=K, num_shards=2,
                                           layout="tiled", exchange="ring"),
                           meshes[2])
    assert bds.movie_blocks.num_shards == 2


def test_two_process_launch_resumes_to_the_single_process_result(tmp_path):
    """``tests/test_multihost.py:32``: two torchrun-style processes train
    the drill dataset; the result equals one process's sharded-as-one run,
    and a rerun over the finished store trains nothing."""
    from cfk_tpu_torch.parallel.launch import _config, _drill_dataset

    procs = spawn_workers(free_port(), 2, str(tmp_path / "ck"), "--drill",
                          "resume", "--device", "cpu")
    outs = communicate_all(procs, timeout=180)
    assert [p.returncode for p in procs] == [0, 0], outs
    m = re.search(r"DRILL_RESUME mse=([0-9.]+) .* trained=(\d+)", outs[0])
    ds = Dataset.from_coo(synthetic_netflix_coo(64, 32, 900, seed=0))
    cfg = _config(2)
    one = train_als(ds, ALSConfig(rank=cfg.rank, lam=cfg.lam, seed=0,
                                  num_iterations=cfg.num_iterations),
                    device="cpu")
    assert abs(float(m.group(1)) - mse_rmse_from_model(one, ds)[0]) <= 1e-6
    assert int(m.group(2)) == 8
    assert _drill_dataset(2).user_blocks.padded_entities % 2 == 0


def test_cli_train_shards_ring(tmp_path, capsys):
    """``train --shards 2 --exchange ring --device cpu``: the one-rank
    run's MSE (the same init) within 1e-4; the JAX CLI's sharded run
    starts from its own threefry init, so its MSE is held to the port's
    only loosely (5%), beside its own one-rank run."""
    from cfk_tpu import cli as jcli
    from cfk_tpu_torch import cli as tcli

    coo = synthetic_netflix_coo(150, 60, 2500, seed=4)
    path = tmp_path / "r.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for u, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{u},{int(r)},2005-01-01\n")

    def mse_of(mod, *extra):
        base = ["train", "--data", str(path), "--rank", "4",
                "--iterations", "4", "--output", "none"]
        assert mod.main(base + list(extra)) == 0
        out = capsys.readouterr().out
        return float(re.search(r"mse=([0-9.]+)", out).group(1))

    one = mse_of(tcli, "--device", "cpu")
    two = mse_of(tcli, "--device", "cpu", "--shards", "2", "--exchange",
                 "ring")
    assert abs(two - one) <= 1e-4 * one
    jtwo = mse_of(jcli, "--shards", "2", "--exchange", "ring")
    assert abs(jtwo - two) <= 0.05 * two


def test_run_num_partitions_trains_two_ranks(tmp_path, capsys,
                                             monkeypatch):
    """``run`` maps NUM_PARTITIONS to ranks (no fall-back to one shard):
    the MSE of the one-partition run."""
    from cfk_tpu_torch import cli as tcli

    coo = synthetic_netflix_coo(120, 50, 2000, seed=6)
    path = tmp_path / "r.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for u, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{u},{int(r)},2005-01-01\n")
    monkeypatch.chdir(tmp_path)
    got = []
    for parts in ("1", "2"):
        assert tcli.main(["run", parts, "4", "0.05", "3", str(path), "50",
                          "120", "--device", "cpu"]) == 0
        got.append(float(capsys.readouterr().out.split("MSE:")[1].split()[0]))
    assert abs(got[1] - got[0]) <= 1e-6 * got[0]


def test_spawned_ranks_import_no_jax():
    code = ("import sys, torch\n"
            "from cfk_tpu_torch.parallel.mesh import make_mesh\n"
            "def main():\n"
            "    with make_mesh(2, 'cpu', quiet=True) as m:\n"
            "        bad = m.run(__import__('cfk_tpu_torch.parallel.spmd',"
            " fromlist=['x']).kernel_launches)\n"
            "    print(bad)\n"
            "    mods = [x for x in sys.modules if x.split('.')[0] in "
            "('jax', 'cfk_tpu')]\n"
            "    sys.exit(1 if mods else 0)\n"
            "if __name__ == '__main__':\n"
            "    main()\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
