"""The port's bucketed layout, K5/K6 plain versions and ALS/ALS++ bucketed
half-steps (cfk_tpu_torch) against cfk_tpu, on the CPU.

The block builder must be bit-identical to the JAX package's, ``chunk_rows``
included.  ``gather_rows_plain`` is bit-equal to ``gather_rows_pallas``
(which runs its XLA emulation twin off the TPU); ``gram_solve_gather_plain``
is held to ``gram_solve_tiles_gather_pallas`` (off the TPU: the emulated
tile Grams + ``compat.emulate_fused_gram_solve``).  Half-steps are held to
the JAX functions on their default CPU route (``solver="cholesky"``).
Tolerances, relative to the largest |value|: 1e-5 for Gram sums and one
solve of a random system, 1e-4 for a half-step, 1e-3 for predictions after
3 iterations — float32 on both sides in different summation orders, the
differences compounding through chained solves.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.ops.pallas.gram_kernel import (
    gather_rows_pallas,
    gram_solve_tiles_gather_pallas,
)
from cfk_tpu.ops.solve import als_half_step_bucketed as j_als_bucketed
from cfk_tpu.ops.subspace import _sweep_rect as j_sweep_rect
from cfk_tpu.ops.subspace import als_pp_half_step as j_als_pp
from cfk_tpu.ops.subspace import als_pp_half_step_bucketed as j_als_pp_bkt
from cfk_tpu.utils.roofline import bucketed_gather_rows as j_gather_rows
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.models.als import _bucketed_to_device
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gather_rows,
    gram_solve_gather,
    gram_solve_gather_plain,
)
from cfk_tpu_torch.ops.solve import als_half_step_bucketed
from cfk_tpu_torch.ops.subspace import (
    _sweep_rect,
    als_pp_half_step,
    als_pp_half_step_bucketed,
)
from cfk_tpu_torch.utils.roofline import bucketed_gather_rows

CPU = torch.device("cpu")
K = 8
LAM = 0.05


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


@pytest.mark.parametrize("kw", [
    dict(), dict(chunk_elems=256), dict(chunk_elems=None, pad_multiple=4),
])
def test_bucketed_blocks_bit_identical(coo, kw):
    jd = JDataset.from_coo(coo, layout="bucketed", **kw)
    td = Dataset.from_coo(coo, layout="bucketed", **kw)
    for jb, tb in ((jd.movie_blocks, td.movie_blocks),
                   (jd.user_blocks, td.user_blocks)):
        assert len(jb.buckets) == len(tb.buckets) > 2
        for a, b in zip(jb.buckets, tb.buckets):
            assert a.chunk_rows == b.chunk_rows
            for name in ("neighbor_idx", "rating", "mask", "count",
                         "entity_local"):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(jb.count, tb.count)
        np.testing.assert_array_equal(jb.rating_sum, tb.rating_sum)
        assert (jb.num_entities, jb.num_shards, jb.padded_cells) == (
            tb.num_entities, tb.num_shards, tb.padded_cells)
    if kw.get("chunk_elems") == 256:
        assert any(b.chunk_rows for b in td.user_blocks.buckets)
    assert bucketed_gather_rows(td.movie_blocks, td.user_blocks) == \
        j_gather_rows(jd.movie_blocks, jd.user_blocks)


@pytest.mark.parametrize("weighted", [False, True])
def test_gather_rows_plain_bit_equal_to_pallas_twin(weighted):
    rng = np.random.default_rng(4)
    f, c, k = 50, 203, 6
    table = rng.standard_normal((f, k)).astype(np.float32)
    nb = rng.integers(0, f + 1, c).astype(np.int32)  # f = the zero row
    nb[::9] = f
    wt = rng.random(c).astype(np.float32) if weighted else None
    want = gather_rows_pallas(jnp.asarray(table), jnp.asarray(nb),
                              None if wt is None else jnp.asarray(wt))
    got = gather_rows(torch.as_tensor(table), torch.as_tensor(nb),
                      None if wt is None else torch.as_tensor(wt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy()[::9] == 0)


@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_solve_gather_plain_matches_pallas(reg_mode, with_carry):
    rng = np.random.default_rng(5)
    f, k, t, nt, s = 60, K, 4, 24, 10
    c = nt * t
    table = rng.standard_normal((f, k)).astype(np.float32)
    nb = rng.integers(0, f + 1, c).astype(np.int32)
    wt = (rng.random(c) < 0.9).astype(np.float32) * rng.random(c).astype(
        np.float32)
    rt = rng.standard_normal(c).astype(np.float32)
    seg = np.sort(np.concatenate([np.arange(s - 2), rng.integers(
        0, s - 2, nt - (s - 2))])).astype(np.int32)  # segments 8, 9 empty
    if reg_mode == "diag":
        reg = rng.integers(0, 30, s).astype(np.int32)
    else:
        y = rng.standard_normal((80, k)).astype(np.float32)
        reg = (y.T @ y + 0.1 * np.eye(k)).astype(np.float32)
    carry = None
    if with_carry:
        z = rng.standard_normal((2 * k, k)).astype(np.float32)
        carry = (z.T @ z, rng.standard_normal(k).astype(np.float32),
                 np.float32(1.0))
    lseg = 5
    kw = dict(num_segments=s, tile_rows=t, reg_mode=reg_mode, lam=LAM)
    want = gram_solve_tiles_gather_pallas(
        *map(jnp.asarray, (table, nb, wt, rt, seg, reg)), jnp.int32(lseg),
        carry=None if carry is None else tuple(map(jnp.asarray, carry)), **kw)
    t_ = torch.as_tensor
    got = gram_solve_gather(
        *map(t_, (table, nb, wt, rt, seg, reg)), lseg,
        carry=None if carry is None else tuple(map(t_, carry)), **kw)
    plain = gram_solve_gather_plain(
        *map(t_, (table, nb, wt, rt, seg, reg)), lseg,
        carry=None if carry is None else tuple(map(t_, carry)), **kw)
    for g, p, w in zip(got, plain, want):
        assert torch.equal(g, p)  # CPU tensors: the wrapper is the plain route
        _close(g, w, 1e-5)
    assert torch.all(got[0][8:] == 0)  # segments owning no tile: x = 0


def _bucket_args(blocks, lib):
    trees, chunks = blocks.to_tree()
    if lib == "jax":
        return tuple({k: jnp.asarray(v) for k, v in t.items()}
                     for t in trees), chunks
    return _bucketed_to_device(blocks, CPU)


def test_als_half_step_bucketed_matches(coo, u0):
    kw = dict(layout="bucketed", chunk_elems=256)
    jb = JDataset.from_coo(coo, **kw).movie_blocks
    tb = Dataset.from_coo(coo, **kw).movie_blocks
    jtrees, jchunks = _bucket_args(jb, "jax")
    want = j_als_bucketed(jnp.asarray(u0), jtrees, jchunks,
                          jb.padded_entities, LAM)
    ttrees, _ = _bucket_args(tb, "torch")
    got = als_half_step_bucketed(torch.as_tensor(u0), ttrees,
                                 tb.padded_entities, LAM)
    _close(got, want, 1e-4)


def test_sweep_rect_explicit_matches(coo, u0):
    jd = JDataset.from_coo(coo)
    b = jd.movie_blocks
    x0 = np.random.default_rng(6).standard_normal(
        (b.padded_entities, K)).astype(np.float32)
    args = (b.neighbor_idx, b.rating, b.mask)
    want = j_sweep_rect(jnp.asarray(u0), jnp.asarray(x0),
                        *map(jnp.asarray, args), LAM, 0.0, None, 4,
                        "cholesky", count=jnp.asarray(b.count))
    got = _sweep_rect(torch.as_tensor(u0), torch.as_tensor(x0),
                      *map(torch.as_tensor, args), LAM, 0.0, None, 4,
                      count=torch.as_tensor(b.count))
    _close(got, want, 1e-4)


def test_als_pp_half_steps_match(coo, u0):
    x0 = np.random.default_rng(7).standard_normal((150, K)).astype(np.float32)
    jb = JDataset.from_coo(coo).movie_blocks
    args = (jb.neighbor_idx, jb.rating, jb.mask, jb.count)
    want = j_als_pp(jnp.asarray(u0), jnp.asarray(x0), *map(jnp.asarray, args),
                    LAM, block_size=4, sweeps=2)
    got = als_pp_half_step(torch.as_tensor(u0), torch.as_tensor(x0),
                           *map(torch.as_tensor, args), LAM, block_size=4,
                           sweeps=2)
    _close(got, want, 1e-4)
    kw = dict(layout="bucketed", chunk_elems=256)
    jbb = JDataset.from_coo(coo, **kw).movie_blocks
    tbb = Dataset.from_coo(coo, **kw).movie_blocks
    jtrees, jchunks = _bucket_args(jbb, "jax")
    want = j_als_pp_bkt(jnp.asarray(u0), jnp.asarray(x0), jtrees, jchunks,
                        jbb.padded_entities, LAM, block_size=4)
    ttrees, tchunks = _bucket_args(tbb, "torch")
    got = als_pp_half_step_bucketed(torch.as_tensor(u0), torch.as_tensor(x0),
                                    ttrees, tchunks, tbb.padded_entities, LAM,
                                    block_size=4)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("layout,algorithm", [
    ("bucketed", "als"), ("bucketed", "als++"), ("padded", "als++"),
])
def test_train_als_bucketed_and_alspp_match_reference(coo, u0, layout,
                                                      algorithm):
    kw = dict(layout=layout, chunk_elems=256) if layout == "bucketed" else {}
    jd = JDataset.from_coo(coo, **kw)
    td = Dataset.from_coo(coo, **kw)
    m0 = np.zeros((jd.movie_map.num_entities, K), np.float32)
    cfg = dict(rank=K, num_iterations=3, layout=layout, algorithm=algorithm,
               block_size=4)
    ref = j_train_als(jd, JConfig(**cfg), warm_start=(u0, m0))
    model = train_als(td, ALSConfig(**cfg), device="cpu", warm_start=(u0, m0))
    _close(model.predict_dense(), ref.predict_dense(), 1e-3)


def test_alspp_refuses_the_tiled_layout(coo):
    with pytest.raises(ValueError, match="use layout='bucketed'"):
        ALSConfig(layout="tiled", algorithm="als++")
    td = Dataset.from_coo(coo, layout="tiled", chunk_elems=512,
                          accum_max_entities=200, tile_rows=16,
                          dense_stream=True)
    with pytest.raises(ValueError, match="padded and bucketed"):
        train_als(td, ALSConfig(rank=K, algorithm="als++", layout="auto",
                                block_size=4), device="cpu")
