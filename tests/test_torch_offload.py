"""The port's out-of-core tier (``cfk_tpu_torch.offload``) on the CPU.

- ``budget``: every function equals ``cfk_tpu.offload.budget`` on a grid.
- ``window`` / ``hot``: the three window plans and the hot maps are
  array-equal to the JAX package's on the same blocks.
- ``store``: the sealed crc32s equal the reference store's; int8 codes equal
  the reference host quantizer's, scales the port's resident quantizer's.
- ``train_als_host_window``: crc-equal to the port's resident ``train_als``
  (one shard) and ``train_als_sharded`` (S = 2, 4 gloo ranks; all_gather,
  ring, hier_ring) at every knob — table dtype, hot cache, staging mode,
  epilogue, gather — and held to the JAX package's windowed trainer from
  its own init: one half-step within 1e-5 of max|x|, two iterations within
  1e-4.
- the trainers' exits, ``offload_tier="auto"`` through the budget, and
  ``train --offload-tier host_window --device cpu`` against the device tier.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.offload import budget as jbudget
from cfk_tpu.offload import hot as jhot
from cfk_tpu.offload import window as jwindow
from cfk_tpu.offload import windowed as jwindowed
from cfk_tpu.offload.store import HostFactorStore as JStore
from cfk_tpu.offload.store import quantize_rows_host as j_quantize_rows
from cfk_tpu.ops.quant import quantize_table as j_quantize_table
from cfk_tpu.ops.solve import init_factors_stats as j_init_stats
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.offload import budget, hot, window, windowed
from cfk_tpu_torch.offload.store import HostFactorStore, quantize_rows_host
from cfk_tpu_torch.ops.quant import quantize_table
from cfk_tpu_torch.parallel import mesh as tmesh
from cfk_tpu_torch.parallel.spmd import train_als_sharded

TILED = dict(layout="tiled", chunk_elems=512, tile_rows=16)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch intra-op thread for these small products (the suite runs
    files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(60, 30, 900, seed=0)


@pytest.fixture(scope="module")
def stream_ds(coo):
    return Dataset.from_coo(coo, accum_max_entities=0, **TILED)


def _crc(model) -> int:
    u, m = model.host_factors()
    return zlib.crc32(np.ascontiguousarray(u).tobytes()
                      + np.ascontiguousarray(m).tobytes())


def _build(coo, shards=1, ring=False):
    kw = dict(TILED, num_shards=shards)
    kw.update(dict(ring=True, ring_warn=False) if ring
              else dict(accum_max_entities=0))
    return JDataset.from_coo(coo, **kw), Dataset.from_coo(coo, **kw)


# -- budget ------------------------------------------------------------------

GRID = [(480_189, 17_770, 100_480_507, 64, "float32", None, 1),
        (162_541, 59_047, 25_000_095, 128, "bfloat16", "int8", 2),
        (1_000, 50, 20_000, 8, "float32", "bfloat16", 4),
        (10, 7, 30, 3, "bfloat16", None, 7)]


@pytest.mark.parametrize("shape", GRID, ids=lambda s: f"{s[0]}x{s[1]}")
def test_budget_matches_reference(shape):
    nu, nm, nnz, k, dt, tdt, s = shape
    hbm = 80e9
    for donation in (True, False):
        kw = dict(dtype=dt, table_dtype=tdt, num_shards=s,
                  donation=donation)
        assert budget.train_resident_bytes(nu, nm, nnz, k, **kw) == \
            jbudget.train_resident_bytes(nu, nm, nnz, k, **kw)
        assert budget.fits_device(nu, nm, nnz, k, hbm_bytes=hbm, **kw) == \
            jbudget.fits_device(nu, nm, nnz, k, hbm_bytes=hbm, **kw)
    for r in range(s):
        assert budget.shard_entity_range(nu, s, r) == \
            jbudget.shard_entity_range(nu, s, r)
    for reserved in (0.0, 1e9):
        assert budget.window_budget_bytes(hbm, reserved) == \
            jbudget.window_budget_bytes(hbm, reserved)
        assert budget.max_pool_depth(hbm, 3e8, reserved) == \
            jbudget.max_pool_depth(hbm, 3e8, reserved)
        for sd in ("float32", "bfloat16", "int8"):
            assert budget.max_hot_rows(hbm, k, sd, reserved) == \
                jbudget.max_hot_rows(hbm, k, sd, reserved)
            assert budget.hot_reservation_fits(nm, k, sd, hbm, reserved) == \
                jbudget.hot_reservation_fits(nm, k, sd, hbm, reserved)
    for sd in ("float32", "bfloat16", "int8"):
        assert budget.stage_row_bytes(k, sd) == jbudget.stage_row_bytes(k, sd)
        assert budget.hot_reservation_bytes(nm, k, sd) == \
            jbudget.hot_reservation_bytes(nm, k, sd)
        assert budget.delta_arena_bytes(nm, k, sd) == \
            jbudget.delta_arena_bytes(nm, k, sd)
        assert budget.gram_reservation_bytes(k, sd) == \
            jbudget.gram_reservation_bytes(k, sd)
    assert budget.ring_accumulator_reservation(nm, k, donated=False) == \
        jbudget.ring_accumulator_reservation(nm, k, donated=False)
    for armed in (True, False):
        assert budget.fleet_host_ram_bytes(
            nu, nm, nnz, k, dtype=dt, processes=s, armed=armed) == \
            jbudget.fleet_host_ram_bytes(nu, nm, nnz, k, dtype=dt,
                                         processes=s, armed=armed)
        assert budget.fits_fleet_host(
            nu, nm, nnz, k, host_ram_bytes=2e11, dtype=dt, processes=s,
            armed=armed) == jbudget.fits_fleet_host(
            nu, nm, nnz, k, host_ram_bytes=2e11, dtype=dt, processes=s,
            armed=armed)


def test_device_memory_is_the_devices_own():
    """The CPU takes the reference's nominal host figure (32 GiB); nothing
    of a TPU's memory enters the port's budget."""
    assert budget.device_memory_bytes("cpu") == 32 * 1024**3


# -- window plans and hot maps -----------------------------------------------


def _plans_equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, tuple) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y)
            for u, v in zip(x, y):
                np.testing.assert_array_equal(u, v, err_msg=f)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f
    for w in range(a.num_windows):
        for u, v in zip(a.stage_chunks(w), b.stage_chunks(w)):
            np.testing.assert_array_equal(u, v)
        if hasattr(a, "chunk_entity_of"):
            np.testing.assert_array_equal(a.chunk_entity_of(w),
                                          b.chunk_entity_of(w))


STREAM_FIELDS = ("rows", "row_counts", "chunk_lo", "chunk_counts",
                 "neighbor_idx", "carry_in", "last_seg", "statics",
                 "window_rows", "table_rows", "local_entities")


@pytest.mark.parametrize("shards,cpw", [(1, 1), (1, 2), (2, 2), (4, 3)])
def test_window_plan_matches_reference(coo, shards, cpw):
    jds, ds = _build(coo, shards)
    for side, fixed in (("movie_blocks", "user_blocks"),
                        ("user_blocks", "movie_blocks")):
        for d in range(shards):
            rows = getattr(ds, fixed).padded_entities
            p = window.build_window_plan(getattr(ds, side), rows,
                                         chunks_per_window=cpw, shard=d)
            j = jwindow.build_window_plan(getattr(jds, side), rows,
                                          chunks_per_window=cpw, shard=d)
            _plans_equal(p, j, STREAM_FIELDS)
            assert p.staged_bytes_per_window(8, 4) == \
                j.staged_bytes_per_window(8, 4)
            assert p.plan_held_bytes() == j.plan_held_bytes()


@pytest.mark.parametrize("shards,cpw", [(2, 1), (2, 2), (4, 2)])
def test_ring_window_plan_matches_reference(coo, shards, cpw):
    jds, ds = _build(coo, shards, ring=True)
    for side in ("movie_blocks", "user_blocks"):
        for d in range(shards):
            p = window.build_ring_window_plan(getattr(ds, side), shard=d,
                                              chunks_per_window=cpw)
            j = jwindow.build_ring_window_plan(getattr(jds, side), shard=d,
                                               chunks_per_window=cpw)
            _plans_equal(p, j, ("slice_of", "rows", "row_counts",
                                "chunk_lo", "chunk_counts", "neighbor_idx",
                                "statics", "window_chunks", "window_rows",
                                "local_entities", "num_slices"))
            visits = windowed.hier_visit_order(shards, 2, d)
            assert visits == jwindowed.hier_visit_order(shards, 2, d)
            assert p.schedule(visits) == j.schedule(visits)


@pytest.mark.parametrize("shards,cpw", [(1, 2), (2, 3)])
def test_bucket_window_plan_matches_reference(coo, shards, cpw):
    kw = dict(layout="bucketed", chunk_elems=128, num_shards=shards)
    jds, ds = JDataset.from_coo(coo, **kw), Dataset.from_coo(coo, **kw)
    for side, fixed in (("movie_blocks", "user_blocks"),
                        ("user_blocks", "movie_blocks")):
        rows = getattr(ds, fixed).padded_entities
        p = window.build_bucket_window_plan(getattr(ds, side), rows,
                                            chunks_per_window=cpw)
        j = jwindow.build_bucket_window_plan(getattr(jds, side), rows,
                                             chunks_per_window=cpw)
        _plans_equal(p, j, ("rows", "row_counts", "bucket_of", "chunk_lo",
                            "chunk_counts", "neighbor_idx", "entity",
                            "shapes", "window_rows", "table_rows",
                            "local_entities"))


def _hot_maps_equal(a, b):
    for f in ("hot_dst", "hot_src", "keep_dst", "keep_src", "delta_rows",
              "delta_dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.keys() == y.keys()
        for w in x:
            np.testing.assert_array_equal(x[w], y[w], err_msg=f)
    for f in ("prev_of", "hot_pad", "keep_pad", "window_rows",
              "slots_total", "slots_hot", "slots_kept", "slots_delta"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("ring", [False, True])
def test_hot_maps_match_reference(coo, ring):
    s = 2
    jds, ds = _build(coo, s, ring=ring)
    for side, fixed in (("movie_blocks", "user_blocks"),
                        ("user_blocks", "movie_blocks")):
        blocks, jblocks = getattr(ds, side), getattr(jds, side)
        if ring:
            plans = [window.build_ring_window_plan(blocks, shard=d,
                                                   chunks_per_window=2)
                     for d in range(s)]
            scheds = [p.schedule(windowed.hier_visit_order(s, s, d))
                      for d, p in enumerate(plans)]
            table = plans[0].num_slices * plans[0].statics[3]
        else:
            table = getattr(ds, fixed).padded_entities
            plans = [window.build_window_plan(blocks, table,
                                              chunks_per_window=2, shard=d)
                     for d in range(s)]
            scheds = [p.schedule() for p in plans]
        counts = hot.reference_counts(plans, table)
        np.testing.assert_array_equal(counts,
                                      jhot.reference_counts(plans, table))
        order, cov = hot.coverage_curve(counts)
        jorder, jcov = jhot.coverage_curve(counts)
        np.testing.assert_array_equal(order, jorder)
        np.testing.assert_array_equal(cov, jcov)
        rows = hot.select_hot_rows(counts, max(hot.knee_hot_rows(counts), 5))
        for d, (p, sch) in enumerate(zip(plans, scheds)):
            _hot_maps_equal(hot.build_hot_map(p, sch, rows),
                            jhot.build_hot_map(p, sch, rows))
            local = blocks.local_entities
            np.testing.assert_array_equal(
                hot.solved_rows_of(p, d, local),
                jhot.solved_rows_of(p, d, local))
            solve_rows = hot.solved_rows_of(p, d, local)[::2]
            if ring:
                for a, b in zip(hot.ring_scatter_back(d, local, solve_rows),
                                jhot.ring_scatter_back(d, local, solve_rows)):
                    np.testing.assert_array_equal(a, b)
            else:
                mine = hot.scatter_back_maps(p, d, local, solve_rows)
                ref = jhot.scatter_back_maps(p, d, local, solve_rows)
                assert mine.keys() == ref.keys()
                for w in mine:
                    for a, b in zip(mine[w], ref[w]):
                        np.testing.assert_array_equal(a, b)
        del jblocks


# -- the host store ----------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shards", [1, 3])
def test_store_matches_reference(dtype, shards):
    """The same rows give the same bytes (bf16: torch's round-to-nearest-
    even cast is ``ml_dtypes``'), so the sealed crc32s agree; gather and
    write_rows cross shards as the reference's do."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((37, 6)).astype(np.float32)
    mine = HostFactorStore.from_array(a, dtype=dtype, num_shards=shards)
    ref = JStore.from_array(a, dtype=dtype, num_shards=shards)
    mine.seal()
    ref.seal()
    assert mine._crcs == ref._crcs
    np.testing.assert_array_equal(mine.as_array(),
                                  np.asarray(ref.as_array(), np.float32))
    idx = rng.integers(0, 37, 20)
    np.testing.assert_array_equal(mine.gather(idx).float().numpy(),
                                  np.asarray(ref.gather(idx), np.float32))
    vals = rng.standard_normal((5, 6)).astype(np.float32)
    rows = np.array([0, 12, 13, 25, 36])
    mine.write_rows(rows, vals)
    ref.write_rows(rows, vals)
    mine.seal()
    ref.seal()
    assert mine._crcs == ref._crcs
    mine.scrub()
    from cfk_tpu_torch.offload.store import StoreIntegrityError

    mine.shard(shards - 1).view(-1).view(torch.uint8)[3] ^= 0xFF
    with pytest.raises(StoreIntegrityError) as e:
        mine.scrub()
    assert e.value.shard == shards - 1


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_quantize_rows_host(device):
    """Codes and scales bit-equal to the reference's: for rows bound for a
    card (where PyTorch divides by a scalar as a product with its
    reciprocal) to its host quantizer's ``amax · (1/127)``; for the CPU to
    its ``quantize_table`` run eagerly, which divides — and to the port's
    resident ``quantize_table`` there."""
    rng = np.random.default_rng(1)
    rows = (rng.standard_normal((500, 16))
            * rng.uniform(0.01, 100, (500, 1))).astype(np.float32)
    rows[3] = 0.0
    codes, scales = quantize_rows_host(rows, device=device)
    jcodes, jscales = j_quantize_rows(rows)
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    if device == "cuda":
        np.testing.assert_array_equal(scales.numpy(), jscales)
    else:
        rc, rs = quantize_table(torch.from_numpy(rows), "int8")
        assert torch.equal(codes, rc) and torch.equal(scales, rs)
        ecodes, escales = j_quantize_table(jnp.asarray(rows), "int8")
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ecodes))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(escales))
    nan = rows.copy()
    nan[7, 2] = np.nan
    assert bool(torch.isnan(quantize_rows_host(nan, device=device)[1][7]))


# -- the explicit trainer against the port's resident trainers ---------------


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hot_rows", [0, None, 20])
@pytest.mark.parametrize("staging", ["pool", "serial"])
def test_windowed_equals_resident(stream_ds, table_dtype, hot_rows,
                                  staging):
    cfg = ALSConfig(rank=4, num_iterations=3, layout="tiled",
                    table_dtype=table_dtype)
    res = train_als(stream_ds, cfg, device="cpu")
    win = windowed.train_als_host_window(
        stream_ds, cfg, device="cpu", chunks_per_window=2,
        hot_rows=hot_rows, staging=staging)
    assert _crc(win) == _crc(res)


@pytest.mark.parametrize("knobs", [
    dict(fused_epilogue=False), dict(in_kernel_gather=False),
    dict(fused_epilogue=False, in_kernel_gather=False),
    dict(dtype="bfloat16"), dict(dtype="bfloat16", table_dtype="int8"),
    dict(overlap=False), dict(reg_solve_algo="gj", rank=8),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_windowed_knobs_equal_resident(stream_ds, knobs):
    cfg = ALSConfig(**{"rank": 4, "num_iterations": 2, "layout": "tiled",
                       **knobs})
    res = train_als(stream_ds, cfg, device="cpu")
    for hot_rows in (0, 20):
        win = windowed.train_als_host_window(
            stream_ds, cfg, device="cpu", chunks_per_window=1,
            hot_rows=hot_rows)
        assert _crc(win) == _crc(res)


def test_windows_from_the_budget(stream_ds):
    """A small ``device_budget_bytes`` clamps the staging pool to what the
    budget holds (depth + 1 worst windows); a budget below one window and
    an impossible pinned hot cache refuse loudly."""
    from cfk_tpu_torch.telemetry import Metrics

    cfg = ALSConfig(rank=4, num_iterations=2, layout="tiled")
    res = train_als(stream_ds, cfg, device="cpu")
    m = Metrics()
    win = windowed.train_als_host_window(stream_ds, cfg, device="cpu",
                                         device_budget_bytes=45_200,
                                         metrics=m)
    assert _crc(win) == _crc(res)
    # Worst window 20,296 B: 0.9 · 45,200 holds two, so depth 1.
    assert m.gauges["offload_pool_depth"] == 1
    with pytest.raises(ValueError, match="per-window budget"):
        windowed.train_als_host_window(stream_ds, cfg, device="cpu",
                                       device_budget_bytes=1e3)
    with pytest.raises(ValueError, match="hot_rows=100000 pinned"):
        windowed.train_als_host_window(stream_ds, cfg, device="cpu",
                                       device_budget_bytes=45_200,
                                       hot_rows=100_000)


@pytest.fixture(scope="module")
def meshes():
    out = {}
    try:
        out[2] = tmesh.make_mesh(2, "cpu", quiet=True)
        out[4] = tmesh.make_mesh(4, "cpu", quiet=True)
        yield out
    finally:
        for m in out.values():
            m.close()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("exchange", ["all_gather", "ring", "hier_ring"])
@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_sharded_windowed_equals_resident(coo, meshes, shards, exchange,
                                          table_dtype):
    ring = exchange != "all_gather"
    _, ds = _build(coo, shards, ring=ring)
    cfg = ALSConfig(rank=4, num_iterations=3, layout="tiled",
                    num_shards=shards, exchange=exchange,
                    ici_group=2 if exchange == "hier_ring" else None,
                    table_dtype=table_dtype)
    res = train_als_sharded(ds, cfg, meshes[shards])
    for hot_rows, staging in ((None, "pool"), (0, "serial")):
        win = windowed.train_als_host_window(
            ds, cfg, device="cpu", chunks_per_window=2, hot_rows=hot_rows,
            staging=staging)
        assert _crc(win) == _crc(res)


def test_sharded_exit_runs_windows_in_this_process(coo, meshes):
    _, ds = _build(coo, 2, ring=True)
    cfg = ALSConfig(rank=4, num_iterations=2, layout="tiled", num_shards=2,
                    exchange="ring")
    res = train_als_sharded(ds, cfg, meshes[2])
    win = train_als_sharded(ds, dataclasses.replace(
        cfg, offload_tier="host_window"), meshes[2])
    assert win.pipeline["route"] == "host_window"
    assert _crc(win) == _crc(res)
    from cfk_tpu_torch.resilience.faults import FaultInjector

    with pytest.raises(NotImplementedError, match="fault_injector"):
        train_als_sharded(ds, dataclasses.replace(
            cfg, offload_tier="host_window"), meshes[2],
            fault_injector=FaultInjector())


# -- against the JAX package's windowed trainer -------------------------------


def _jax_u0(jds, jcfg):
    ub = jds.user_blocks
    u = jax.jit(j_init_stats, static_argnames=("rank", "num_entities"))(
        jax.random.PRNGKey(jcfg.seed), jnp.asarray(ub.rating_sum),
        jnp.asarray(ub.count), rank=jcfg.rank, num_entities=ub.num_entities)
    return np.asarray(u, np.float32)


def test_windowed_half_step_matches_reference(coo):
    jds, ds = _build(coo)
    rng = np.random.default_rng(3)
    fixed = rng.standard_normal((ds.user_blocks.padded_entities, 8)).astype(
        np.float32)
    table = ds.user_blocks.padded_entities
    p = window.build_window_plan(ds.movie_blocks, table, chunks_per_window=2)
    jp = jwindow.build_window_plan(jds.movie_blocks, table,
                                   chunks_per_window=2)
    for td in ("float32", "int8"):
        mine = windowed.windowed_half_step(
            HostFactorStore.from_array(fixed), p, lam=0.05, device="cpu",
            table_dtype=td).numpy()
        ref = np.asarray(jwindowed.windowed_half_step(
            JStore.from_array(fixed), jp, lam=0.05, solver="pallas",
            table_dtype=td))
        scale = np.abs(ref).max()
        assert np.abs(mine - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("shards,exchange", [(1, "all_gather"),
                                             (2, "ring"), (4, "hier_ring")])
def test_windowed_matches_reference_two_iterations(coo, shards, exchange):
    ring = exchange != "all_gather"
    jds, ds = _build(coo, shards, ring=ring)
    kw = dict(rank=4, num_iterations=2, layout="tiled", num_shards=shards,
              exchange=exchange,
              ici_group=2 if exchange == "hier_ring" else None)
    jcfg = JConfig(solver="pallas", **kw)
    ref = jwindowed.train_als_host_window(jds, jcfg, chunks_per_window=2)
    u0 = _jax_u0(jds, jcfg)
    mine = windowed.train_als_host_window(
        ds, ALSConfig(**kw), device="cpu", chunks_per_window=2,
        warm_start=(u0, np.zeros((ds.movie_blocks.padded_entities, 4),
                                 np.float32)))
    for a, b in zip(mine.host_factors(),
                    (np.asarray(ref.user_factors),
                     np.asarray(ref.movie_factors))):
        assert np.abs(a - b[: a.shape[0]]).max() <= 1e-4 * np.abs(b).max()


# -- exits, tier resolution, CLI ---------------------------------------------


def test_train_als_exit(stream_ds):
    cfg = ALSConfig(rank=4, num_iterations=2, layout="tiled")
    res = train_als(stream_ds, cfg, device="cpu")
    win = train_als(stream_ds, dataclasses.replace(
        cfg, offload_tier="host_window"), device="cpu")
    assert win.pipeline["route"] == "host_window"
    assert _crc(win) == _crc(res)
    for arg in ("warm_start", "watchdog", "checkpoint_manager"):
        with pytest.raises(NotImplementedError, match=arg):
            train_als(stream_ds, dataclasses.replace(
                cfg, offload_tier="host_window"), device="cpu",
                **{arg: object()})
    with pytest.raises(ValueError, match="streams the tiled"):
        ALSConfig(layout="padded", offload_tier="host_window")
    with pytest.raises(ValueError, match="hot_rows must be"):
        ALSConfig(hot_rows=-1)
    with pytest.raises(ValueError, match="staging must be"):
        ALSConfig(staging="fast")


def test_auto_tier_resolves_through_the_budget(stream_ds, monkeypatch):
    """``offload_tier="auto"`` keeps the resident tier while the budget
    predicate holds at the device's memory size and takes the windows
    past it (the predicate's answer forced, since this fixture's one
    window outweighs its resident bytes)."""
    cfg = ALSConfig(rank=4, num_iterations=2, layout="tiled")
    assert windowed.resolve_tier(stream_ds, cfg, torch.device("cpu")) == \
        "device"
    res = train_als(stream_ds, cfg, device="cpu")
    seen = {}

    def fits(*a, **kw):
        seen.update(kw)
        return False

    monkeypatch.setattr(budget, "fits_device", fits)
    assert windowed.resolve_tier(stream_ds, cfg, torch.device("cpu")) == \
        "host_window"
    padded = dataclasses.replace(cfg, layout="padded")
    assert windowed.resolve_tier(stream_ds, padded, "cpu") == "device"
    assert seen["hbm_bytes"] == 32 * 1024**3
    win = train_als(stream_ds, cfg, device="cpu")
    assert win.pipeline["route"] == "host_window"
    assert _crc(win) == _crc(res)


def _cli_train_fields(tmp_path, capsys, runs):
    """``train`` on a small Netflix-format file once per entry of ``runs``
    (name → extra flags), on the CPU: each run's printed key=value
    fields."""
    from cfk_tpu_torch.cli import main

    coo = synthetic_netflix_coo(300, 60, 3000, seed=4)
    path = tmp_path / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    fields = {}
    for name, extra in runs.items():
        assert main(["train", "--data", str(path), "--rank", "4",
                     "--iterations", "3", "--layout", "tiled",
                     "--chunk-elems", "512", *extra, "--device", "cpu",
                     "--output", "none"]) == 0
        out = capsys.readouterr().out
        fields[name] = dict(kv.split("=", 1) for kv in out.split()
                            if "=" in kv)
    return fields


def test_cli_host_window_equals_device_tier(tmp_path, capsys):
    """On the stream blocks (``--tiled-mode stream``) the resident and the
    windowed tiers train the same blocks to the same MSE."""
    knobs = ["--tiled-mode", "stream", "--hot-rows", "12", "--staging",
             "serial"]
    fields = _cli_train_fields(tmp_path, capsys, {
        tier: knobs + ["--offload-tier", tier]
        for tier in ("device", "host_window")})
    assert fields["host_window"]["mse"] == fields["device"]["mse"]
    assert fields["host_window"]["layout"] == "tiled"


def test_cli_offload_tier_changes_no_block(tmp_path, capsys):
    """``--offload-tier`` chooses the tier and nothing else: ``device``
    prints the default run's MSE; ``host_window`` on the default blocks
    rebuilds the stream blocks it needs, so it prints the MSE of the
    resident tier on ``--tiled-mode stream``, and the default run's within
    1e-5 relative (the default blocks sum the Grams in another order)."""
    fields = _cli_train_fields(tmp_path, capsys, {
        "default": [], "device": ["--offload-tier", "device"],
        "host_window": ["--offload-tier", "host_window"],
        "stream": ["--tiled-mode", "stream"]})
    mse = {k: float(v["mse"]) for k, v in fields.items()}
    assert fields["device"]["mse"] == fields["default"]["mse"]
    assert fields["host_window"]["mse"] == fields["stream"]["mse"]
    assert abs(mse["host_window"] - mse["default"]) <= 1e-5 * mse["default"]


@pytest.mark.parametrize("extra", [
    ["--layout", "padded"], ["--exchange", "ring", "--shards", "2"]])
def test_cli_tiled_mode_stream_needs_the_tiled_stream_layout(
        tmp_path, capsys, extra):
    from cfk_tpu_torch.cli import main

    path = tmp_path / "ratings.txt"
    path.write_text("1:\n1,3,2005-09-06\n2,4,2005-09-06\n")
    assert main(["train", "--data", str(path), "--tiled-mode", "stream",
                 *extra, "--device", "cpu", "--output", "none"]) == 1
    assert "--tiled-mode stream" in capsys.readouterr().err
