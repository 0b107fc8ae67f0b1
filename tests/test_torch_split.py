"""The split epilogue of the port (``fused_epilogue=False``) against the JAX
package, on the CPU.

The Gauss-Jordan solves (``gauss_solve``, ``gauss_solve_multi``) and the
split dense-stream Gram (``gram_tiles_dense_gather``) run their plain
PyTorch versions here and are held to the JAX package's Pallas kernels in
interpret mode; ``dispatch_spd_solve`` (with the blocked Schur route at
k = 72), the split tiled half-steps (accum at k = 72, dense stream) and the
trainers are held to the JAX package's split route from the same inputs,
made from numpy seeds.  The stream mode's split half-steps are in
``test_torch_stream.py``; the kernels themselves run in
``test_torch_gpu.py`` on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _tiled_device_setup as j_tiled_setup
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.pallas.gram_kernel import gram_tiles_dense_gather_pallas
from cfk_tpu.ops.pallas.solve_kernel import (
    gauss_solve_multi_pallas,
    gauss_solve_pallas,
)
from cfk_tpu.ops.solve import dispatch_spd_solve as j_dispatch_spd_solve
from cfk_tpu.ops.tiled import ials_tiled_half_step as j_ials_tiled
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, Dataset, factors_from_numpy, train_als
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.models.als import _tiled_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops.kernels.gram_kernel import gram_tiles_dense_gather
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    batch_first,
    gauss_solve,
    gauss_solve_multi,
)
from cfk_tpu_torch.ops.solve import (
    dispatch_spd_solve,
    regularized_solve,
    resolve_fused_chunk,
    resolve_fused_epilogue,
)
from cfk_tpu_torch.ops.tiled import (
    dense_chunk,
    ials_tiled_half_step,
    tiled_half_step,
)

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.05, 2.0
T = torch.as_tensor


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _spd(e, k, seed):
    """e SPD systems A = XᵀX + 0.05·k·I (X: 2k rows of U(0,1)), b ~ U(0,1):
    condition numbers of a few hundred, batch-first."""
    rng = np.random.default_rng(seed)
    x = rng.random((e, 2 * k, k), dtype=np.float32)
    a = np.einsum("enk,enl->ekl", x, x) + np.float32(0.05 * k) * np.eye(
        k, dtype=np.float32)
    return a.astype(np.float32), rng.random((e, k), dtype=np.float32)


def _last(x):
    """A batch-first array as the batch-last layout the GJ kernels take."""
    return np.ascontiguousarray(np.moveaxis(x, 0, -1))


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = JDataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


# -- the unregularized solves (rows 11 and 12) --------------------------------

@pytest.mark.parametrize("k", [5, 16, 64])
def test_gauss_solve_matches_reference(k):
    a, b = _spd(40, k, k)
    want = gauss_solve_pallas(jnp.asarray(_last(a)), jnp.asarray(b.T),
                              interpret=True)
    got = gauss_solve(T(_last(a)), T(np.ascontiguousarray(b.T)))
    assert got.shape == (k, 40)
    # The same unrolled elimination in float32; XLA contracts the update's
    # multiply and subtract into one rounding where PyTorch takes two, so
    # the results differ by a few ulps times the condition number (~1e-6
    # measured at k = 64).
    assert _rel(got, want) < 1e-5


def test_gauss_solve_multi_matches_reference():
    k, m = 64, 65  # the Schur shape at rank 128: A₁₁⁻¹[A₁₂ | b₁]
    a, _ = _spd(40, k, 3)
    rhs = np.random.default_rng(4).random((40, k, m), dtype=np.float32)
    want = gauss_solve_multi_pallas(jnp.asarray(_last(a)),
                                    jnp.asarray(_last(rhs)), interpret=True)
    got = gauss_solve_multi(T(_last(a)), T(_last(rhs)))
    assert got.shape == (k, m, 40)
    assert _rel(got, want) < 1e-5  # as for gauss_solve


def test_gauss_solve_contracts():
    a, b = _spd(4, 72, 0)
    with pytest.raises(ValueError, match="supports rank <= 64"):
        gauss_solve(T(_last(a)), T(np.ascontiguousarray(b.T)))
    a, _ = _spd(4, 16, 0)
    with pytest.raises(ValueError, match="supports k <= 64, m <= 72"):
        gauss_solve_multi(T(_last(a)), torch.zeros(16, 73, 4))
    a, _ = _spd(4, 72, 0)
    with pytest.raises(ValueError, match="supports k <= 64, m <= 72"):
        gauss_solve_multi(T(_last(a)), torch.zeros(72, 8, 4))
    with pytest.raises(ValueError, match=r"a shape \(16, 16, 3\)"):
        gauss_solve_multi(torch.zeros(16, 16, 3), torch.zeros(16, 8, 4))


def test_gauss_operands_read_in_place():
    """The kernels of rows 11 and 12 read batch-first operands through
    ``batch_first``: the Schur route's A₁₁ (a slice of the [E, 128, 128]
    batch) and the split dispatch's transposed b as views, with their
    strides; a contiguous batch-last tensor through a batch-first copy."""
    a = torch.rand(5, 128, 128)
    v, bs, rs = batch_first(a[:, :64, :64].permute(1, 2, 0))
    assert v.data_ptr() == a.data_ptr() and (bs, rs) == (128 * 128, 128)
    assert torch.equal(v, a[:, :64, :64])
    b = torch.rand(5, 64)
    v, bs, rs = batch_first(b.T[:, None, :])
    assert v.data_ptr() == b.data_ptr() and (bs, rs) == (64, 1)
    al = torch.rand(16, 16, 5)
    v, bs, rs = batch_first(al)
    assert v.is_contiguous() and (bs, rs) == (256, 16)
    assert torch.equal(v, al.permute(2, 0, 1))


@pytest.mark.parametrize("k", [16, 72])  # 72: the blocked Schur route
def test_dispatch_spd_solve_matches_reference(k):
    a, b = _spd(40, k, 7)
    want = j_dispatch_spd_solve(jnp.asarray(a), jnp.asarray(b), "pallas")
    got = dispatch_spd_solve(T(a), T(b))
    assert got.shape == (40, k) and got.is_contiguous()
    # k = 16 as gauss_solve; at k = 72 the three Schur contractions sum in
    # another order than XLA's dots (~6e-6 measured).
    assert _rel(got, want) < (1e-5 if k <= 64 else 1e-4)
    # The plain Cholesky route solves the same systems.
    chol = dispatch_spd_solve(T(a), T(b), "cholesky")
    assert _rel(chol, want) < 1e-4


def test_fused_resolution_and_split_ridge():
    assert resolve_fused_epilogue(None) and resolve_fused_epilogue(True)
    assert not resolve_fused_epilogue(False)
    assert resolve_fused_chunk(None, 128) and not resolve_fused_chunk(None, 129)
    assert not resolve_fused_chunk(False, 8)
    a, b = _spd(30, 12, 5)
    cnt = T(np.arange(30, dtype=np.int32) % 4)
    fused = regularized_solve(T(a), T(b), cnt, LAM)
    split = regularized_solve(T(a.copy()), T(b), cnt, LAM, fused=False)
    assert _rel(split, fused) < 1e-5  # Gauss-Jordan vs Cholesky, float32


def test_split_ridge_add_rounds_twice():
    """The split ridge add is λ·max(n, 1) rounded to float32, then one add,
    as the JAX reference (``lam * jnp.maximum(count, 1)``, then ``a +``)
    and K1 add it — not one fused multiply-add: on these triples one
    rounding of the exact λ·n + A_ii (exact in float64: ≤ 33 + 24 bits
    within 20 binades) gives other bits for some of them."""
    rng = np.random.default_rng(0)
    e = 2000
    cnt = rng.integers(0, 400, e).astype(np.int32)
    diag = (1 + 29 * rng.random((e, 2))).astype(np.float32)
    a = np.zeros((e, 2, 2), np.float32)
    a[:, [0, 1], [0, 1]] = diag
    split = T(a)
    regularized_solve(split, T(np.ones((e, 2), np.float32)), T(cnt), LAM,
                      fused=False)
    got = torch.diagonal(split, dim1=1, dim2=2).numpy()
    n = np.maximum(cnt, 1).astype(np.float32)[:, None]
    twice = np.float32(LAM) * n + diag
    once = (np.float64(np.float32(LAM)) * n + diag).astype(np.float32)
    assert np.array_equal(got.view(np.int32), twice.view(np.int32))
    assert (once != twice).sum() > 0


# -- the split dense-stream Gram (row 9) --------------------------------------

@pytest.fixture(scope="module")
def dense_side(coo):
    d = JDataset.from_coo(coo).coo_dense
    blocks = build_tiled_blocks(d.user_raw, d.movie_raw, d.rating, 400, 150,
                                tile_rows=16, chunk_elems=512,
                                accum_max_entities=100, dense_stream=True)
    assert blocks.mode == "dstream"
    table = np.random.default_rng(2).standard_normal((150, K)).astype(
        np.float32)
    return blocks, _tiled_to_device(blocks, CPU, 150), table


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("cin", [0.0, 1.0])
def test_gram_tiles_dense_gather_matches_reference(dense_side, weighted,
                                                   cin):
    blocks, blk, table = dense_side
    st = blocks.statics
    nc, cap, e_c, _, nt, ng = st[:6]
    # The chunk with the fewest owner segments: some of its e_c + 1
    # segment rows own no tile, and both sides write zeros there.
    owners = [np.unique(blocks.tile_meta.reshape(nc, -1)[c, ng + 3 * nt:])
              for c in range(nc)]
    c = int(np.argmin([o.size for o in owners]))
    empty = np.setdiff1d(np.arange(e_c + 1), owners[c])
    assert empty.size > 0
    args = dense_chunk(blk, st, c)
    for key in ("reg", "lseg", "cin"):
        args.pop(key)
    rng = np.random.default_rng(6)
    if weighted:  # an iALS-like √aw stream
        args["wt"] = T(np.sqrt(rng.random(cap, dtype=np.float32) + 0.1))
    carry = (rng.random((K, K), dtype=np.float32),
             rng.random(K, dtype=np.float32), np.float32(cin))
    j_args = {key: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                    else v) for key, v in args.items()}
    want = gram_tiles_dense_gather_pallas(
        jnp.asarray(table), **j_args, interpret=True,
        carry=tuple(jnp.asarray(x) for x in carry))
    got = gram_tiles_dense_gather(T(table), **args,
                                  carry=tuple(T(x) for x in carry))
    # float32 sums of the same rows; the port sums per tile and then by
    # index_add_, the JAX emulation by segment_sum — orders differ by ulps.
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-5
    assert not got[0][T(empty)].any() and not got[1][T(empty)].any()


# -- split half-steps, against the JAX package's split route ------------------

def _tiled_args(coo, side):
    d = JDataset.from_coo(coo).coo_dense
    if side == "movie":
        return ((d.movie_raw, d.user_raw, d.rating, 150, 400),
                dict(tile_rows=16, chunk_elems=1024, slice_rows=128))
    return ((d.user_raw, d.movie_raw, d.rating, 400, 150),
            dict(tile_rows=16, chunk_elems=512, accum_max_entities=100,
                 dense_stream=True))


def _fixed(side, k):
    n = 400 if side == "movie" else 150
    return np.random.default_rng(k).random((n, k)).astype(np.float32)


_JAX_HALVES = {}


def _jax_split_half(coo, side, k, implicit):
    """The JAX package's split half-step (solver="pallas": interpret-mode
    kernels), computed once per case."""
    key = (side, k, implicit)
    if key not in _JAX_HALVES:
        args, kw = _tiled_args(coo, side)
        from cfk_tpu.data.blocks import build_tiled_blocks as j_build

        jb = j_build(*args, **kw)
        chunks = ("tiled", jb.mode) + jb.statics
        fixed = jnp.asarray(_fixed(side, k))
        if implicit:
            out = j_ials_tiled(fixed, j_tiled_to_device(jb, True), chunks,
                               jb.padded_entities, LAM, ALPHA,
                               solver="pallas", fused_epilogue=False)
        else:
            out = j_tiled_half_step(fixed, j_tiled_to_device(jb), chunks,
                                    jb.padded_entities, LAM, solver="pallas",
                                    fused_epilogue=False)
        _JAX_HALVES[key] = np.asarray(out)
    return _JAX_HALVES[key]


# The accum half at k = 72 runs the blocked Schur route on the split side.
@pytest.mark.parametrize("side,k", [("movie", 72), ("user", K)])
@pytest.mark.parametrize("fused", [False, None])
def test_tiled_half_step_split_matches_reference(coo, side, k, fused):
    want = _jax_split_half(coo, side, k, implicit=False)
    args, kw = _tiled_args(coo, side)
    tb = build_tiled_blocks(*args, **kw)
    assert tb.mode == ("accum" if side == "movie" else "dstream")
    got = tiled_half_step(T(_fixed(side, k)),
                          _tiled_to_device(tb, CPU, args[4]),
                          ("tiled", tb.mode) + tb.statics, tb.padded_entities,
                          LAM, fused_epilogue=fused)
    # float32 solves of the same normal equations (Gauss-Jordan, blocked
    # Schur or Cholesky on either side); the k = 72 Grams of movies with
    # fewer ratings than k are held up by the λ·n ridge alone (condition
    # numbers ~1e3), which the summation-order differences scale.
    assert _rel(got, want) < (1e-4 if k == K else 1e-3)


@pytest.mark.parametrize("side,k", [("movie", 72), ("user", K)])
def test_ials_tiled_half_step_split_matches_reference(coo, side, k):
    want = _jax_split_half(coo, side, k, implicit=True)
    args, kw = _tiled_args(coo, side)
    tb = build_tiled_blocks(*args, **kw)
    got = ials_tiled_half_step(
        T(_fixed(side, k)), _tiled_to_device(tb, CPU, args[4], weighted=True),
        ("tiled", tb.mode) + tb.statics, tb.padded_entities, LAM, ALPHA,
        fused_epilogue=False)
    # The shared YᵀY + λI ridge keeps these systems well conditioned.
    assert _rel(got, want) < 1e-4


# -- trainers, split, on the dense-stream dataset ------------------------------

DENSE = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
             tile_rows=16, dense_stream=True)


def test_train_als_split_matches_reference(coo, u0):
    jd, td = JDataset.from_coo(coo, **DENSE), Dataset.from_coo(coo, **DENSE)
    assert (td.movie_blocks.mode, td.user_blocks.mode) == ("accum", "dstream")
    init = (u0, np.zeros((150, K), np.float32))
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=3, layout="tiled",
                                  solver="pallas", fused_epilogue=False),
                      warm_start=init)
    model = train_als(td, ALSConfig(rank=K, num_iterations=3, layout="tiled",
                                    fused_epilogue=False),
                      device="cpu", warm_start=init)
    # Three iterations of float32 solves in different orders (the
    # tolerance of the trainer parity tests in test_torch_als.py).
    assert _rel(model.predict_dense(), ref.predict_dense()) < 1e-3


def test_train_ials_split_matches_reference(coo, u0):
    jd, td = JDataset.from_coo(coo, **DENSE), Dataset.from_coo(coo, **DENSE)
    mb, ub, _, kw = j_tiled_setup(jd, weighted=True)
    u = jnp.asarray(u0)
    m = jnp.zeros((150, K), jnp.float32)
    for _ in range(3):
        u, m = j_one_iteration(u, m, mb, ub, lam=LAM, alpha=ALPHA,
                               dtype="float32", solver="pallas",
                               fused_epilogue=False, **kw)
    ref = factors_from_numpy(np.asarray(u), np.asarray(m),
                             num_users=jd.user_map.num_entities,
                             num_movies=150, device="cpu")
    cfg = IALSConfig(rank=K, lam=LAM, alpha=ALPHA, num_iterations=3,
                     layout="tiled", fused_epilogue=False)
    model = train_ials(td, cfg, device="cpu",
                       warm_start=(u0, np.zeros((150, K), np.float32)))
    assert _rel(model.predict_dense(), ref.predict_dense()) < 1e-3


@pytest.mark.parametrize("bad", ["yes", 2])
def test_fused_epilogue_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        JConfig(fused_epilogue=bad)
    with pytest.raises(ValueError) as got:
        ALSConfig(fused_epilogue=bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fused_epilogue must be"):
        IALSConfig(fused_epilogue=bad)
