"""The port's CUDA kernels against their plain PyTorch versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``gpu`` and
skips without an NVIDIA GPU.  The repo's ``tests/conftest.py`` imports jax,
which a GPU machine need not have; run these there with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Tolerances, relative to the largest |value|: float32 on both sides with
different summation orders (the kernels accumulate each Gram entry row by
row, the plain versions per tile and then across tiles) — 1e-5 for Gram
sums, 1e-4 for K1's batches.  K3's solutions are held to the plain (A, b)
by their backward error, ||(A+R)x − b||∞ / (||A+R||∞·||x||∞ + ||b||∞)
< 1e-5 in float64, per segment: a segment with fewer rows than k has a
rank-deficient Gram held up only by the λ·n ridge (condition numbers up to
~3e3 at k = 128), so two float32 Cholesky solves may differ forwards by
~1e-3 while both solve the system to rounding.
"""

import numpy as np
import pytest
import torch

from cfk_tpu_torch.data.blocks import build_tiled_blocks, index_entities
from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.models.als import _tiled_to_device
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gather_rows,
    gather_rows_plain,
    gram_gather,
    gram_gather_plain,
    gram_solve_dense,
    gram_solve_dense_plain,
    gram_solve_gather,
    gram_solve_gather_plain,
    gram_solve_tiles,
    gram_solve_tiles_dense,
    gram_solve_tiles_dense_plain,
    gram_solve_tiles_plain,
    gram_tiles,
    gram_tiles_dense,
    gram_tiles_dense_gather,
    gram_tiles_dense_gather_plain,
    gram_tiles_dense_plain,
    gram_tiles_plain,
)
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    add_ridge_plain,
    gauss_jordan_plain,
    gauss_solve,
    gauss_solve_multi,
    gauss_solve_plain,
    reg_solve,
    reg_solve_plain,
    spd_solve_plain,
)
from cfk_tpu_torch.ops.solve import (
    batched_spd_solve,
    dispatch_spd_solve,
    regularized_solve,
    regularized_solve_matrix,
)
from cfk_tpu_torch.ops.quant import quantize_table
from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk
from cfk_tpu_torch.serving.topk_kernel import (
    build_seen_tiles,
    topk_scores,
    topk_scores_large_k,
    topk_scores_plain,
)

from _torch_topk import compare_topk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _backward_err(x, a, b, reg, lam, reg_mode):
    """Max over systems of ||(A+R)x − b||∞ / (||A+R||∞·||x||∞ + ||b||∞)."""
    m = add_ridge_plain(a.double(), reg.double(), lam=lam, reg_mode=reg_mode)
    x, b = x.double(), b.double()
    r = (torch.einsum("skl,sl->sk", m, x) - b).abs().amax(1)
    scale = (m.abs().sum(2).amax(1) * x.abs().amax(1) + b.abs().amax(1))
    return float((r / scale.clamp_min(1e-300)).max())


def _spd_batch(e, k, seed, device):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((e, 2 * k, k), generator=g)
    a = torch.einsum("enk,enl->ekl", x, x)
    b = torch.rand((e, k), generator=g)
    cnt = torch.randint(0, 50, (e,), generator=g).to(torch.int32)
    return a.to(device), b.to(device), cnt.to(device)


@pytest.mark.parametrize("e", [1, 203, 300])
@pytest.mark.parametrize("k", [1, 8, 31, 32, 33, 64, 100, 127, 128])
def test_reg_solve_matches_plain(cuda, k, e):
    """Every panel shape of the blocked solve (k below, at and above one
    32-column panel, ragged last panels) at one system, one wave and a
    batch past it."""
    a, b, cnt = _spd_batch(e, k, k, cuda)
    got = reg_solve(a, b, cnt, lam=0.05)
    torch.cuda.synchronize()
    want = reg_solve_plain(a, b, cnt, lam=0.05)
    assert _rel_err(got, want) < 1e-4
    r = torch.eye(k, device=cuda) * 0.3
    got = reg_solve(a, b, r, lam=0.0, reg_mode="matrix")
    want = reg_solve_plain(a, b, r, lam=0.0, reg_mode="matrix")
    assert _rel_err(got, want) < 1e-4


@pytest.mark.parametrize("k", [40, 128])
def test_reg_solve_bit_stable_and_non_spd_rows(cuda, k):
    """Two launches return the same bits; a system whose factorization
    meets a pivot <= 0 (−I, the zero matrix, one negative eigenvalue at
    column 35) gets a non-finite row of x, wherever the plain version's
    cholesky_ex does and on the others too, while its SPD neighbours are
    solved as before."""
    a, b, _ = _spd_batch(6, k, 7, cuda)
    eig = torch.ones(k, device=cuda)
    eig[35] = -1.0
    a[1] = -torch.eye(k, device=cuda)
    a[2] = 0.0
    a[4] = torch.diag(eig)
    zero = torch.zeros(6, dtype=torch.int32, device=cuda)
    got = reg_solve(a, b, zero, lam=0.0)
    again = reg_solve(a, b, zero, lam=0.0)
    torch.cuda.synchronize()
    assert torch.equal(torch.nan_to_num(got, 1.0, 2.0, 3.0),
                       torch.nan_to_num(again, 1.0, 2.0, 3.0))
    want = reg_solve_plain(a, b, zero, lam=0.0)
    finite = torch.isfinite(got).all(1).tolist()
    assert finite == [True, False, False, True, False, True]
    assert not (torch.isfinite(got).all(1) & ~torch.isfinite(want).all(1)).any()
    spd = torch.tensor([0, 3, 5], device=cuda)
    assert _rel_err(got[spd], want[spd]) < 1e-4


def _tiled_side(k, tile_rows, chunk_elems, device, accum):
    coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
    mm, m_dense = index_entities(coo.movie_raw)
    um, u_dense = index_entities(coo.user_raw)
    nm, nu = mm.num_entities, um.num_entities
    if accum:  # movies solved against a sliced user table
        blocks = build_tiled_blocks(m_dense, u_dense, coo.rating, nm, nu,
                                    tile_rows=tile_rows,
                                    chunk_elems=chunk_elems, slice_rows=1000)
        fixed_rows = nu
    else:
        blocks = build_tiled_blocks(u_dense, m_dense, coo.rating, nu, nm,
                                    tile_rows=tile_rows,
                                    chunk_elems=chunk_elems,
                                    accum_max_entities=16, dense_stream=True)
        fixed_rows = nm
    rng = np.random.default_rng(k)
    table = torch.as_tensor(
        rng.standard_normal((fixed_rows, k), dtype=np.float32), device=device)
    blk = _tiled_to_device(blocks, device, fixed_rows)
    return blocks, blk, table


@pytest.mark.parametrize("k,tile_rows", [(8, 16), (64, 128), (100, 32)])
def test_gram_gather_matches_plain(cuda, k, tile_rows):
    blocks, blk, table = _tiled_side(k, tile_rows, 4096, cuda, accum=True)
    assert blocks.mode == "accum" and blocks.num_slices > 1
    g = torch.Generator().manual_seed(0)
    carry = (torch.rand((k, k), generator=g).to(cuda),
             torch.rand((k,), generator=g).to(cuda),
             torch.ones((1,), device=cuda))
    for c in range(blocks.num_chunks):
        args = accum_chunk(blk, blocks.statics, c)
        a, b = gram_gather(table, **args, carry=carry)
        torch.cuda.synchronize()
        wa, wb = gram_gather_plain(table, **args, carry=carry)
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5


@pytest.mark.parametrize("k,tile_rows,weighted", [
    (8, 16, False), (64, 128, False), (100, 32, False), (128, 16, False),
    (64, 128, True), (128, 16, True)])
def test_gram_solve_dense_matches_plain(cuda, k, tile_rows, weighted):
    blocks, blk, table = _tiled_side(k, tile_rows, 4096, cuda, accum=False)
    assert blocks.mode == "dstream" and blocks.num_chunks > 2
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    cap = blocks.statics[1]
    wt_all = torch.rand(blocks.num_chunks * cap, generator=g, device=cuda)
    ridge = torch.eye(k, device=cuda) * 2.0
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin = args.pop("cin")
        reg_mode = "diag"
        if weighted:  # the iALS form: weight stream + shared ridge
            args["wt"] = wt_all[c * cap:(c + 1) * cap]
            args["reg"], reg_mode = ridge, "matrix"
        x, ca, cb = gram_solve_dense(table, **args, lam=0.05,
                                     reg_mode=reg_mode, carry=(a0, b0, cin))
        torch.cuda.synchronize()
        wx, wca, wcb = gram_solve_dense_plain(table, **args, lam=0.05,
                                              reg_mode=reg_mode,
                                              carry=(a0, b0, cin))
        a, b = gram_tiles_dense_gather_plain(
            table, args["nb"], args["wt"], args["rt"], args["meta"],
            num_segments=args["num_segments"], tile_rows=args["tile_rows"],
            num_tiles=args["num_tiles"], num_groups=args["num_groups"],
            block_rows=args["block_rows"], carry=(a0, b0, cin))
        assert _backward_err(x, a, b, args["reg"], 0.05, reg_mode) < 1e-5
        assert _rel_err(x, wx) < 1e-2
        assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
        a0, b0 = wca, wcb


@pytest.mark.parametrize("k,tile_rows,weighted", [
    (1, 16, False), (8, 16, False), (64, 128, False), (100, 32, False),
    (128, 16, True)])
def test_gram_tiles_dense_gather_matches_plain(cuda, k, tile_rows, weighted):
    """The split dense-stream Gram, carry threaded across every chunk;
    with K1 after it, the split schedule must solve what K3 solves."""
    blocks, blk, table = _tiled_side(k, tile_rows, 4096, cuda, accum=False)
    assert blocks.mode == "dstream" and blocks.num_chunks > 2
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    cap = blocks.statics[1]
    wt_all = torch.rand(blocks.num_chunks * cap, generator=g, device=cuda)
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin, reg, lseg = args.pop("cin"), args.pop("reg"), args.pop("lseg")
        if weighted:
            args["wt"] = wt_all[c * cap:(c + 1) * cap]
        a, b = gram_tiles_dense_gather(table, **args, carry=(a0, b0, cin))
        torch.cuda.synchronize()
        wa, wb = gram_tiles_dense_gather_plain(table, **args,
                                               carry=(a0, b0, cin))
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
        # Segments owning no tile are zeros, as in the plain version.
        owned = torch.zeros(args["num_segments"], dtype=torch.bool,
                            device=cuda)
        ng, nt = args["num_groups"], args["num_tiles"]
        owned[args["meta"][ng + 3 * nt:].long()] = True
        assert not a[~owned].any() and not b[~owned].any()
        x = reg_solve(a, b, reg, lam=0.05)
        xf, _, _ = gram_solve_dense(table, **args, reg=reg, lseg=lseg,
                                    lam=0.05, carry=(a0, b0, cin))
        torch.cuda.synchronize()
        # The same Gram sums and the same ridge + Cholesky code (common.cuh)
        # in both schedules; held here by backward error, as K3 is above.
        assert _backward_err(xf, a, b, reg, 0.05, "diag") < 1e-5
        assert _backward_err(x, a, b, reg, 0.05, "diag") < 1e-5
        li = lseg.long()
        a0, b0 = a.index_select(0, li)[0], b.index_select(0, li)[0]


# Rows 11 and 12 (gauss_solve, gauss_solve_multi): the kernels — K1's
# blocked Cholesky over the lower triangle — against their plain versions,
# the reference's Gauss-Jordan elimination, on the same batch-last systems:
# every panel shape of the blocked solve (k below, at and above one
# 32-column panel, a ragged last panel), one to 72 right-hand sides, at one
# system, within one wave and past it.  Two float32 solves by different
# algorithms without pivoting: relative 1e-4 on systems whose condition
# numbers are a few hundred.

GJ_KS = [1, 31, 32, 33, 64]
GJ_MS = [1, 2, 33, 65, 72]
GJ_ES = [1, 203, 300]
# The grid, then the earlier cases; E = 1000 passes one wave (4 CTAs per SM
# x 132 SMs = 528 systems resident).
GJ_CASES = [(k, e) for k in [8] + GJ_KS for e in GJ_ES] + [
    (1, 7), (8, 301), (64, 1000), (64, 33)]
GJ_MULTI_CASES = [(k, m, e) for k in GJ_KS for m in GJ_MS for e in GJ_ES] + [
    (1, 1, 5), (20, 9, 301), (64, 65, 500), (64, 72, 64), (64, 65, 1000)]


def _gj_batch(e, k, m, seed, device):
    a, _, _ = _spd_batch(e, k, seed, device)
    a = a + 0.05 * k * torch.eye(k, device=device)
    g = torch.Generator().manual_seed(seed + 1)
    b = torch.rand((e, k, m), generator=g).to(device)
    return a.permute(1, 2, 0).contiguous(), b.permute(1, 2, 0).contiguous()


@pytest.mark.parametrize("k,e", GJ_CASES)
def test_gauss_solve_matches_plain(cuda, k, e):
    a, b = _gj_batch(e, k, 1, k, cuda)
    before = gauss_solve.launches
    got = gauss_solve(a, b[:, 0])
    torch.cuda.synchronize()
    assert gauss_solve.launches == before + 1 and got.shape == (k, e)
    assert _rel_err(got, gauss_solve_plain(a, b[:, 0])) < 1e-4
    # A batch-first caller's permuted view needs no copy and no transpose.
    af = a.permute(2, 0, 1).contiguous()
    bf = b[:, 0].T.contiguous()
    assert torch.equal(gauss_solve(af.permute(1, 2, 0), bf.T), got)


@pytest.mark.parametrize("k,m,e", GJ_MULTI_CASES)
def test_gauss_solve_multi_matches_plain(cuda, k, m, e):
    a, b = _gj_batch(e, k, m, k + m, cuda)
    before = gauss_solve_multi.launches
    got = gauss_solve_multi(a, b)
    torch.cuda.synchronize()
    assert gauss_solve_multi.launches == before + 1
    assert got.shape == (k, m, e)
    assert _rel_err(got, gauss_jordan_plain(a, b)) < 1e-4


@pytest.mark.parametrize("k", [33, 64])
def test_gauss_solve_multi_columns_are_gauss_solve(cuda, k):
    """Each element of the m-column solve takes the one-column solve's
    operations: column r of row 12 equals row 11 on B's column r, bit for
    bit, in each of the three warps whose threads run the 65 back
    substitutions."""
    a, b = _gj_batch(203, k, 65, k, cuda)
    got = gauss_solve_multi(a, b)
    for r in (0, 31, 32, 64):
        assert torch.equal(got[:, r], gauss_solve(a, b[:, r].contiguous()))


def test_gauss_solve_multi_reads_a11_in_place(cuda):
    """The Schur route's A₁₁ is a strided slice of the [E, 128, 128] batch:
    the kernel reads it in place and returns what it returns on a
    contiguous copy."""
    a, b, _ = _spd_batch(300, 128, 5, cuda)
    a = a + 6.4 * torch.eye(128, device=cuda)
    rhs = torch.cat([a[:, :64, 64:], b[:, :64, None]], dim=2)
    view = gauss_solve_multi(a[:, :64, :64].permute(1, 2, 0),
                             rhs.permute(1, 2, 0))
    copy = gauss_solve_multi(a[:, :64, :64].contiguous().permute(1, 2, 0),
                             rhs.permute(1, 2, 0))
    assert torch.equal(view, copy)


@pytest.mark.parametrize("k", [40, 64])
def test_gauss_solve_bit_stable_and_non_spd_rows(cuda, k):
    """Rows 11 and 12: two launches return the same bits; a system whose
    factorization meets a pivot <= 0 (−I, the zero matrix, one negative
    eigenvalue at column 35) gets a non-finite row of x in every column
    (Gauss-Jordan gave finite numbers where its pivots were nonzero), while
    its SPD neighbours are solved as before."""
    a, b = _gj_batch(6, k, 3, 11, cuda)
    eig = torch.ones(k, device=cuda)
    eig[35] = -1.0
    a[:, :, 1] = -torch.eye(k, device=cuda)
    a[:, :, 2] = 0.0
    a[:, :, 4] = torch.diag(eig)
    spd = torch.tensor([0, 3, 5], device=cuda)
    for solve, bb, plain in ((gauss_solve, b[:, 0], gauss_solve_plain),
                             (gauss_solve_multi, b, gauss_jordan_plain)):
        got = solve(a, bb)
        again = solve(a, bb)
        torch.cuda.synchronize()
        assert torch.equal(torch.nan_to_num(got, 1.0, 2.0, 3.0),
                           torch.nan_to_num(again, 1.0, 2.0, 3.0))
        fin = torch.isfinite(got.reshape(-1, 6))
        assert fin.all(0).tolist() == [True, False, False, True, False, True]
        assert not fin[:, [1, 2, 4]].any()
        want = plain(a[..., spd], bb[..., spd])
        assert _rel_err(got[..., spd], want) < 1e-4


@pytest.mark.parametrize("k", GJ_KS)
def test_split_solve_equals_reg_solve_bitwise(cuda, k):
    """The split route's ridge add (torch: λ·max(n, 1) rounded, one add;
    matrix mode one add) then row 11 equals K1 on the same sums bit for
    bit: both run the blocked Cholesky on the same lower triangle."""
    a, b, cnt = _spd_batch(300, k, 3 * k, cuda)
    fused = regularized_solve(a, b, cnt, 0.05)
    split = regularized_solve(a.clone(), b, cnt, 0.05, fused=False)
    torch.cuda.synchronize()
    assert torch.equal(split, fused)
    r = torch.eye(k, device=cuda) * 0.3 + 0.01
    fused = regularized_solve_matrix(a, b, r)
    split = regularized_solve_matrix(a.clone(), b, r, fused=False)
    assert torch.equal(split, fused)


@pytest.mark.parametrize("k", [16, 72, 128])
def test_dispatch_spd_solve_on_the_card(cuda, k):
    """The split solve: Gauss-Jordan (k ≤ 64) or the blocked Schur route
    (64 < k ≤ 128) against the plain Cholesky; above 128 the route is
    ``batched_spd_solve``, with no Gauss-Jordan launch."""
    a, b, _ = _spd_batch(257, k, k, cuda)
    a = a + 0.05 * k * torch.eye(k, device=cuda)
    before = (gauss_solve.launches, gauss_solve_multi.launches)
    got = dispatch_spd_solve(a, b)
    torch.cuda.synchronize()
    after = (gauss_solve.launches, gauss_solve_multi.launches)
    assert after == (before[0] + 1, before[1] + int(k > 64))
    assert _rel_err(got, spd_solve_plain(a, b)) < 1e-3
    a, b, _ = _spd_batch(5, 130, 130, cuda)
    a = a + 0.05 * 130 * torch.eye(130, device=cuda)
    got = dispatch_spd_solve(a, b)
    torch.cuda.synchronize()
    assert (gauss_solve.launches, gauss_solve_multi.launches) == after
    assert torch.equal(got, batched_spd_solve(a, b))
    assert _rel_err(got, spd_solve_plain(a, b)) < 1e-3


def test_reg_solve_matrix_mode_on_implicit_grams(cuda):
    """K1's matrix mode as the iALS halves run it: observed Grams
    Σ α·r·f fᵀ with the shared YᵀY + λI ridge, at the ranks the full
    solves (8, 64, 128) and the b×b sweeps (32) use."""
    for k in (8, 32, 64, 128):
        g = torch.Generator().manual_seed(k)
        y = torch.rand((500, k), generator=g)
        ridge = y.T @ y + 0.1 * torch.eye(k)
        f = torch.rand((200, 12, k), generator=g)
        w = 40.0 * torch.rand((200, 12), generator=g)
        a = torch.einsum("epk,ep,epl->ekl", f, w, f)
        b = torch.einsum("epk,ep->ek", f, 1.0 + w)
        a, b, ridge = a.to(cuda), b.to(cuda), ridge.to(cuda)
        got = reg_solve(a, b, ridge, reg_mode="matrix")
        torch.cuda.synchronize()
        want = reg_solve_plain(a, b, ridge, reg_mode="matrix")
        assert _backward_err(got, a, b, ridge, 0.0, "matrix") < 1e-5
        assert _rel_err(got, want) < 1e-3


@pytest.mark.parametrize("k", [8, 64, 128])
def test_gram_gather_weighted_matches_plain(cuda, k):
    """K2 with the √(α·r) weight stream of the iALS accum half."""
    blocks, blk, table = _tiled_side(k, 16, 4096, cuda, accum=True)
    g = torch.Generator(device=cuda).manual_seed(2)
    for c in range(blocks.num_chunks):
        args = accum_chunk(blk, blocks.statics, c)
        args["wt"] = args["wt"] * torch.sqrt(
            40.0 * torch.rand(args["wt"].shape, generator=g, device=cuda))
        a, b = gram_gather(table, **args)
        torch.cuda.synchronize()
        wa, wb = gram_gather_plain(table, **args)
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5


# K5 gather_rows and K6 gram_solve_gather against their plain versions.


@pytest.mark.parametrize("k", [5, 8, 32, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_rows_matches_plain(cuda, k, weighted):
    """Bit-equal: one load and at most one float32 multiply per element.
    Indices past the table (F = the zero row, and larger) and negative
    ones read zeros; k = 5 takes the scalar (non-16-byte) path."""
    rng = np.random.default_rng(k)
    f, c = 1000, 4099
    table = torch.as_tensor(rng.standard_normal((f, k), dtype=np.float32),
                            device=cuda)
    nb = rng.integers(0, f, c).astype(np.int32)
    nb[::7] = f
    nb[3::11] = f + 5
    nb[5::13] = -1
    nb = torch.as_tensor(nb, device=cuda)
    wt = (torch.as_tensor(rng.random(c, dtype=np.float32), device=cuda)
          if weighted else None)
    got = gather_rows(table, nb, wt)
    torch.cuda.synchronize()
    want = gather_rows_plain(table, nb, wt)
    assert torch.equal(got, want)
    assert torch.all(got[::7] == 0)


def test_gather_rows_refuses_what_it_does_not_take(cuda):
    """float32, bf16 and int8 tables are taken (the quantized tables);
    float16 is not, nor an int8 table without the weights that carry its
    scale, nor a bf16 stream of an int8 table."""
    table = torch.zeros((10, 8), device=cuda)
    nb = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="table must be one of"):
        gather_rows(table.to(torch.float16), nb)
    with pytest.raises(TypeError, match="nb must be torch.int32"):
        gather_rows(table, nb.long())
    with pytest.raises(ValueError, match="int8 table needs"):
        gather_rows(table.to(torch.int8), nb)
    with pytest.raises(TypeError, match="writes"):
        gather_rows(table.to(torch.int8), nb, torch.ones(4, device=cuda),
                    out_dtype=torch.bfloat16)


def _segments(rng, nt, num_segments, empty):
    """Sorted tile owners over ``num_segments`` segments, ``empty`` of
    them owning no tile."""
    live = np.sort(rng.choice(num_segments, num_segments - empty,
                              replace=False))
    seg = np.sort(np.concatenate([live, rng.choice(live, nt - live.size)]))
    return seg.astype(np.int32), np.setdiff1d(np.arange(num_segments), live)


@pytest.mark.parametrize("k", [8, 32, 64, 128])
@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_solve_gather_matches_plain(cuda, k, reg_mode, with_carry):
    """Several tiles per segment, empty segments (x = 0), the zero row
    and zero weights, the carry fold and the raw carry row at lseg."""
    rng = np.random.default_rng(k + 7 * with_carry)
    f, t, nt, s = 700, 16, 96, 40
    c = nt * t
    table = torch.as_tensor(rng.standard_normal((f, k), dtype=np.float32),
                            device=cuda)
    nb = rng.integers(0, f, c).astype(np.int32)
    nb[rng.random(c) < 0.2] = f
    wt = rng.random(c, dtype=np.float32)
    wt[rng.random(c) < 0.1] = 0.0
    rt = rng.standard_normal(c, dtype=np.float32)
    seg, empty = _segments(rng, nt, s, 5)
    dev = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
    nb, wt, rt, seg = dev(nb), dev(wt), dev(rt), dev(seg)
    if reg_mode == "diag":
        reg = dev(rng.integers(0, 40, s).astype(np.int32))
    else:
        y = rng.standard_normal((300, k)).astype(np.float32)
        reg = dev(y.T @ y + 0.1 * np.eye(k, dtype=np.float32))
    carry = None
    if with_carry:
        z = rng.standard_normal((2 * k, k)).astype(np.float32)
        carry = (dev(z.T @ z), dev(rng.standard_normal(k).astype(np.float32)),
                 torch.ones((1,), device=cuda))
    lseg = int(seg[-1])
    kw = dict(num_segments=s, tile_rows=t, lam=0.05, reg_mode=reg_mode,
              carry=carry)
    x, ca, cb = gram_solve_gather(table, nb, wt, rt, seg, reg, lseg, **kw)
    torch.cuda.synchronize()
    wx, wca, wcb = gram_solve_gather_plain(table, nb, wt, rt, seg, reg, lseg,
                                           **kw)
    a, b = gram_gather_plain(table, nb, wt, rt, seg, num_segments=s,
                             tile_rows=t, carry=carry)
    assert _backward_err(x, a, b, reg, 0.05, reg_mode) < 1e-5
    assert _rel_err(x, wx) < 1e-2
    assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
    keep = torch.as_tensor(np.setdiff1d(empty, [0] if with_carry else []),
                           device=cuda, dtype=torch.long)
    assert torch.all(x[keep] == 0)


def test_gram_solve_gather_one_tile_per_entity(cuda):
    """The bucketed adapter's shape: a [rows, width] width class, one tile
    per entity, √(α·r) weights and the shared YᵀY + λI ridge, k = 128."""
    from cfk_tpu_torch.ops.bucketed import bucket_gram_solve, ials_reparam

    rng = np.random.default_rng(3)
    k, f, rows, width = 128, 5000, 300, 64
    table = torch.as_tensor(rng.random((f, k), dtype=np.float32), device=cuda)
    nb = torch.as_tensor(rng.integers(0, f, (rows, width)).astype(np.int32),
                         device=cuda)
    cnt = rng.integers(1, width + 1, rows)
    mk = torch.as_tensor((np.arange(width)[None, :] < cnt[:, None])
                         .astype(np.float32), device=cuda)
    rt = torch.as_tensor(rng.random((rows, width), dtype=np.float32),
                         device=cuda) * mk
    reg = table.T @ table + 0.1 * torch.eye(k, device=cuda)
    wt, rt_b = ials_reparam(rt, mk, 40.0)
    before = gram_solve_gather.launches
    got = bucket_gram_solve(table, nb, wt, rt_b, reg, lam=0.0,
                            reg_mode="matrix")
    torch.cuda.synchronize()
    assert gram_solve_gather.launches == before + 1
    want = bucket_gram_solve(table.cpu(), nb.cpu(), wt.cpu(), rt_b.cpu(),
                             reg.cpu(), lam=0.0, reg_mode="matrix")
    assert _rel_err(got.cpu(), want) < 1e-3


def test_launch_counters_count_kernel_calls_only(cuda):
    a, b, cnt = _spd_batch(10, 8, 0, cuda)
    before = reg_solve.launches
    reg_solve(a, b, cnt, lam=0.05)
    reg_solve(a.cpu(), b.cpu(), cnt.cpu(), lam=0.05)  # plain route
    assert reg_solve.launches == before + 1
    u = torch.zeros((4, 8), device=cuda)
    t = torch.ones((32, 8), device=cuda)
    before = topk_scores.launches
    topk_scores(u, t, None, None, k_top=3, num_movies=30, tile_m=16)
    topk_scores(u.cpu(), t.cpu(), None, None, k_top=3, num_movies=30,
                tile_m=16)
    assert topk_scores.launches == before + 2  # candidates + merge
    a, b = _gj_batch(6, 4, 3, 0, cuda)
    counts = (gauss_solve.launches, gauss_solve_multi.launches)
    gauss_solve(a, b[:, 0])
    gauss_solve_multi(a, b)
    gauss_solve(a.cpu(), b[:, 0].cpu())  # plain routes
    gauss_solve_multi(a.cpu(), b.cpu())
    assert (gauss_solve.launches, gauss_solve_multi.launches) == (
        counts[0] + 1, counts[1] + 1)


# The materialized-stream kernels (gram_tiles, gram_solve_tiles,
# gram_tiles_dense, gram_solve_tiles_dense) against their plain versions,
# and against their gather siblings (K2, K6, gram_tiles_dense_gather, K3)
# fed the stream K5 writes from the siblings' operands: the same walk, sums,
# flush points and epilogue, so the results must be bit-equal.


def _stream_chunk(k, device, seed):
    """One chunk of 256 tiles of 16 rows over 6 segments (one owns no
    tile; the others average ~800 rows, some past the 1,024-row flush),
    with the zero row, zero weights and eight 96-row runs of padding — so
    whole passes of 32 rows are padding inside segments."""
    rng = np.random.default_rng(seed)
    f, t, nt, s = 700, 16, 256, 6
    c = nt * t
    nb = rng.integers(0, f, c).astype(np.int32)
    nb[rng.random(c) < 0.2] = f
    for start in rng.choice(c - 96, 8, replace=False):
        nb[start:start + 96] = f
    wt = rng.random(c, dtype=np.float32)
    wt[rng.random(c) < 0.1] = 0.0
    seg, empty = _segments(rng, nt, s, 1)
    dev = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    table = dev(rng.standard_normal((f, k), dtype=np.float32))
    z = rng.standard_normal((2 * k, k)).astype(np.float32)
    carry = (dev(z.T @ z), dev(rng.standard_normal(k).astype(np.float32)),
             torch.ones((1,), device=device))
    args = dict(rt=dev(rng.standard_normal(c, dtype=np.float32)),
                seg=dev(seg), num_segments=s, tile_rows=t)
    return table, dev(nb), dev(wt), args, carry, empty


def _ridges(k, s, device, seed):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((300, k)).astype(np.float32)
    return {"diag": torch.as_tensor(rng.integers(0, 40, s).astype(np.int32),
                                    device=device),
            "matrix": torch.as_tensor(y.T @ y + 0.1 * np.eye(
                k, dtype=np.float32), device=device)}


@pytest.mark.parametrize("k", [8, 64, 128])
def test_stream_tile_kernels_match_plain(cuda, k):
    """gram_tiles and gram_solve_tiles on a weighted chunk with the carry,
    both ridge modes; segments owning no tile are zeros (x = 0)."""
    table, nb, wt, args, carry, empty = _stream_chunk(k, cuda, k)
    g = gather_rows(table, nb, wt)
    a, b = gram_tiles(g, **args, carry=carry)
    torch.cuda.synchronize()
    wa, wb = gram_tiles_plain(g, **args, carry=carry)
    assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
    keep = torch.as_tensor(empty[empty != 0], device=cuda, dtype=torch.long)
    assert not a[keep].any() and not b[keep].any()
    lseg = int(args["seg"][-1])
    for reg_mode, reg in _ridges(k, args["num_segments"], cuda, k).items():
        x, ca, cb = gram_solve_tiles(g, **args, reg=reg, lseg=lseg, lam=0.05,
                                     reg_mode=reg_mode, carry=carry)
        torch.cuda.synchronize()
        wx, wca, wcb = gram_solve_tiles_plain(g, **args, reg=reg, lseg=lseg,
                                              lam=0.05, reg_mode=reg_mode,
                                              carry=carry)
        assert _backward_err(x, wa, wb, reg, 0.05, reg_mode) < 1e-5
        assert _rel_err(x, wx) < 1e-2
        assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
        assert torch.all(x[keep] == 0)


@pytest.mark.parametrize("k,tile_rows,weighted", [
    (8, 16, False), (64, 128, True), (128, 16, True)])
def test_stream_dense_kernels_match_plain(cuda, k, tile_rows, weighted):
    """gram_tiles_dense and gram_solve_tiles_dense on every dense chunk of
    a real side, the carry threaded across the chunks, both ridge modes."""
    blocks, blk, table = _tiled_side(k, tile_rows, 4096, cuda, accum=False)
    assert blocks.mode == "dstream" and blocks.num_chunks > 2
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    cap = blocks.statics[1]
    wt_all = torch.rand(blocks.num_chunks * cap, generator=gen, device=cuda)
    ridge = torch.eye(k, device=cuda) * 2.0
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin, reg, lseg = args.pop("cin"), args.pop("reg"), args.pop("lseg")
        nb, wt = args.pop("nb"), args.pop("wt")
        if weighted:
            wt = wt_all[c * cap:(c + 1) * cap]
        g = gather_rows(table, nb, wt)
        carry = (a0, b0, cin)
        a, b = gram_tiles_dense(g, **args, carry=carry)
        torch.cuda.synchronize()
        wa, wb = gram_tiles_dense_plain(g, **args, carry=carry)
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
        for reg_mode, r in (("diag", reg), ("matrix", ridge)):
            x, ca, cb = gram_solve_tiles_dense(g, **args, reg=r, lseg=lseg,
                                               lam=0.05, reg_mode=reg_mode,
                                               carry=carry)
            torch.cuda.synchronize()
            wx, wca, wcb = gram_solve_tiles_dense_plain(
                g, **args, reg=r, lseg=lseg, lam=0.05, reg_mode=reg_mode,
                carry=carry)
            assert _backward_err(x, wa, wb, r, 0.05, reg_mode) < 1e-5
            assert _rel_err(x, wx) < 1e-2
            assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
        a0, b0 = wca, wcb


@pytest.mark.parametrize("k", [8, 64, 128])
def test_stream_kernels_equal_their_gather_siblings(cuda, k):
    """Each stream kernel on gather_rows(table, nb, wt) returns its gather
    sibling's bits on (table, nb, wt): padding passes inside segments, the
    1,024-row flush and the carry fold included."""
    table, nb, wt, args, carry, _ = _stream_chunk(k, cuda, 100 + k)
    g = gather_rows(table, nb, wt)
    got = gram_tiles(g, **args, carry=carry)
    want = gram_gather(table, nb, wt, **args, carry=carry)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    lseg = int(args["seg"][-1])
    for reg_mode, reg in _ridges(k, args["num_segments"], cuda, k).items():
        kw = dict(reg=reg, lseg=lseg, lam=0.05, reg_mode=reg_mode,
                  carry=carry)
        got = gram_solve_tiles(g, **args, **kw)
        want = gram_solve_gather(table, nb, wt, **args, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    blocks, blk, table = _tiled_side(k, 16, 4096, cuda, accum=False)
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    cap = blocks.statics[1]
    wt_all = torch.rand(blocks.num_chunks * cap, device=cuda)
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin, reg, lseg = args.pop("cin"), args.pop("reg"), args.pop("lseg")
        nb = args.pop("nb")
        args.pop("wt")
        for wt in (None, wt_all[c * cap:(c + 1) * cap]):
            g = gather_rows(table, nb, wt)
            carry = (a0, b0, cin)
            got = gram_tiles_dense(g, **args, carry=carry)
            want = gram_tiles_dense_gather(table, nb, wt, **args, carry=carry)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, want))
            kw = dict(reg=reg, lseg=lseg, lam=0.05, carry=carry)
            got = gram_solve_tiles_dense(g, **args, **kw)
            want = gram_solve_dense(table, nb, wt, **args, **kw)
            torch.cuda.synchronize()
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        a0, b0 = got[1], got[2]


def test_stream_kernels_refuse_what_they_do_not_take(cuda):
    table, nb, wt, args, carry, _ = _stream_chunk(8, cuda, 1)
    g = gather_rows(table, nb, wt)
    # the split entries take any rank an int indexes; the fused ones 128
    wide = torch.zeros((), device=cuda).expand(g.shape[0], 46001)
    with pytest.raises(ValueError, match="gram_tiles supports rank 1..46000"):
        gram_tiles(wide, **args)
    reg = torch.ones(args["num_segments"], device=cuda)
    with pytest.raises(ValueError,
                       match="gram_solve_tiles supports rank 1..128"):
        gram_solve_tiles(torch.zeros((g.shape[0], 129), device=cuda),
                         **args, reg=reg, lseg=0)
    with pytest.raises(TypeError, match="g must be one of"):
        gram_tiles(g.to(torch.int8), **args)
    reg = torch.ones(args["num_segments"], device=cuda)
    with pytest.raises(ValueError, match="rt shape"):
        gram_solve_tiles(g, **dict(args, rt=args["rt"][:-1]), reg=reg,
                         lseg=0)
    blocks, blk, table = _tiled_side(8, 16, 4096, cuda, accum=False)
    d = dense_chunk(blk, blocks.statics, 0)
    for key in ("cin", "lseg", "reg", "wt"):
        d.pop(key)
    g = gather_rows(table, d.pop("nb"))
    with pytest.raises(TypeError, match="meta must be torch.int32"):
        gram_tiles_dense(g, **dict(d, meta=d["meta"].long()))
    with pytest.raises(ValueError, match="gram_solve_tiles_dense supports"):
        gram_solve_tiles_dense(torch.zeros((g.shape[0], 200), device=cuda),
                               **d, reg=torch.ones(d["num_segments"],
                                                   device=cuda), lseg=0)


# K4 topk_scores: the kernel against its plain version on the card, over
# the CPU tests' matrix (table dtype x seen mask x padding / row_offset / −1
# tail) plus planted exact ties and serving-sized shapes.  Scores within
# 1e-5 of the largest |score|, ids equal except at near-ties
# (``compare_topk``); exact ties give identical ids.


def _topk_problem(seed, b, m, k, tile, seen_max, table_dtype, device,
                  integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        u = rng.integers(-3, 4, (b, k)).astype(np.float32)
        mf = rng.integers(-3, 4, (m, k)).astype(np.float32)
        mf[:, 0] = 127.0
    else:
        u = rng.standard_normal((b, k)).astype(np.float32)
        mf = rng.standard_normal((m, k)).astype(np.float32)
    m_pad = -(-m // tile) * tile
    tbl = np.zeros((m_pad, k), np.float32)
    tbl[:m] = mf
    seen = [np.sort(rng.choice(m, size=int(rng.integers(0, seen_max)),
                               replace=False)) for _ in range(b)]
    indptr = np.zeros(b + 1, np.int64)
    indptr[1:] = np.cumsum([s.size for s in seen])
    movies = np.concatenate(seen).astype(np.int32)
    st = build_seen_tiles(movies, indptr, np.arange(b), num_movies=m_pad,
                          tile_m=tile)
    data, scale = quantize_table(torch.as_tensor(tbl, device=device),
                                 table_dtype)
    return (torch.as_tensor(u, device=device), data, scale,
            torch.as_tensor(st, device=device))


def _check_topk(u, data, scale, st, exact=False, **kw):
    got_v, got_i = topk_scores(u, data, scale, st, **kw)
    torch.cuda.synchronize()
    want_v, want_i = topk_scores_plain(u, data, scale, st, **kw)
    if exact:
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
        return
    ext_v, _ = topk_scores_plain(u, data, scale, st,
                                 **dict(kw, k_top=kw["k_top"] + 1))
    report = compare_topk(got_v, got_i, want_v, want_i, ext_v)
    assert report["ok"], report


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("case", ["padded", "offset_tail", "ties", "serving",
                                  "odd"])
def test_topk_scores_matches_plain(cuda, table_dtype, with_seen, case):
    if case == "serving":  # B not a multiple of 8, many splits, K = 100
        args = _topk_problem(3, 37, 3000, 128, 256, 300, table_dtype, cuda)
        kw = dict(k_top=100, num_movies=3000, tile_m=256)
    elif case == "odd":  # rank 5, 48-row tiles straddling 256-row steps
        args = _topk_problem(7, 13, 700, 5, 48, 60, table_dtype, cuda)
        kw = dict(k_top=9, num_movies=690, tile_m=48, row_offset=3)
    else:
        args = _topk_problem(11, 8, 60 if case == "ties" else 50, 16, 16,
                             12, table_dtype, cuda, integer=case == "ties")
        kw = dict(k_top=5, num_movies=50, tile_m=16)
        if case == "offset_tail":
            kw = dict(k_top=40, num_movies=40, tile_m=16, row_offset=7)
        elif case == "ties":
            kw = dict(k_top=20, num_movies=60, tile_m=16)
    u, data, scale, st = args
    _check_topk(u, data, scale, st if with_seen else None,
                exact=case == "ties", **kw)


@pytest.mark.parametrize("k_top", [1, 257, 1024])
def test_topk_scores_large_k_and_wide_seen(cuda, k_top):
    # K up to the two-launch route's limit; heavy users (W = 512) loop over
    # W; one past it takes the large-K route and answers exactly
    u, data, scale, st = _topk_problem(5, 12, 5000, 64, 512, 3000,
                                       "float32", cuda)
    _check_topk(u, data, scale, st, k_top=k_top, num_movies=4990, tile_m=512)
    before = topk_scores_large_k.launches
    _check_topk(u, data, scale, st, k_top=1025, num_movies=4990, tile_m=512)
    assert topk_scores_large_k.launches == before + 3
    _check_routes_agree(u, data, scale, st, k_top=1025, num_movies=4990,
                        tile_m=512)


def _check_routes_agree(u, data, scale, st, **kw):
    """Both K4 routes compute every score in the same operations, so the
    large-K route's first 1,024 are the two-launch route's K = 1,024, bit
    for bit — whatever order the plain version's cuBLAS product sums in
    (at B = 12, rank 64 it differs from the kernels' in the last bits)."""
    big = topk_scores(u, data, scale, st, **kw)
    small = topk_scores(u, data, scale, st, **dict(kw, k_top=1024))
    assert torch.equal(big[0][:, :1024], small[0])
    assert torch.equal(big[1][:, :1024], small[1])


# K above 1,024: the large-K route (score pass into a [B, M_pad] key
# workspace, radix select, bitonic sort) against the plain version,
# exactly — values and ids.  f32 and int8 score in the plain version's
# order; a bf16 table sums on the tensor cores in another order, so it
# takes integer factors, whose sums are exact in any order (and tie often).
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("with_seen", [False, True])
@pytest.mark.parametrize("m,k_top", [(5000, 1025), (5000, 2048),
                                     (5000, 4096), (5000, "num_movies"),
                                     (5000, "num_movies+37"),
                                     (12000, 9000)])
def test_topk_scores_above_1024_equals_plain(cuda, table_dtype, with_seen, m,
                                             k_top):
    # num_movies 10 below m: padding rows; K = num_movies + 37 leaves a
    # (−inf, −1) tail; K = 9000 sorts 16,384 keys a user, past one
    # shared-memory chunk of the sort
    u, data, scale, st = _topk_problem(31, 40, m, 64, 512, 3000, table_dtype,
                                       cuda, integer=table_dtype == "bfloat16")
    nm = m - 10
    kt = {"num_movies": nm, "num_movies+37": nm + 37}.get(k_top, k_top)
    before, before_small = topk_scores_large_k.launches, topk_scores.launches
    _check_topk(u, data, scale, st if with_seen else None, exact=True,
                k_top=kt, num_movies=nm, tile_m=512)
    assert topk_scores_large_k.launches == before + 3
    assert topk_scores.launches == before_small
    _check_routes_agree(u, data, scale, st if with_seen else None, k_top=kt,
                        num_movies=nm, tile_m=512)


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
def test_topk_scores_above_1024_two_stage_shape_and_ties(cuda, table_dtype):
    # the two-stage rescore's call (row_offset masks a padded shortlist's
    # tail) at a serving batch, and planted exact ties across tiles
    u, data, scale, st = _topk_problem(23, 256, 3000, 64, 256, 20,
                                       table_dtype, cuda)
    _check_topk(u, data, scale, st, exact=True, k_top=1500, num_movies=3072,
                tile_m=256, row_offset=500)
    u, data, scale, st = _topk_problem(19, 40, 3000, 16, 256, 30, table_dtype,
                                       cuda, integer=True)
    _check_topk(u, data, scale, st, exact=True, k_top=2000, num_movies=2950,
                tile_m=256)


@pytest.mark.parametrize("mode", ["exact", "two_stage"])
def test_engine_topk_above_1024_on_the_card(cuda, mode):
    """ServeEngine.topk at K = 1,500 reaches the large-K route, exact and
    through the two-stage rescore; each call's K4 arguments, recorded
    inside the engine, give exactly the plain version's answer."""
    from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
    from cfk_tpu_torch.serving import ServeEngine
    from cfk_tpu_torch.serving import engine as engine_mod
    from cfk_tpu_torch.serving import twostage as twostage_mod

    rng = np.random.default_rng(0)
    u, m = serve_factors(400, 4000, 16, rng)
    rows = np.arange(64)
    seen, indptr = serve_seen_csr(400, 4000, 20_000, rows, rng)
    eng = ServeEngine(u, m, num_users=400, num_movies=4000, seen_movies=seen,
                      seen_indptr=indptr, tile_m=256, serve_mode=mode,
                      clusters=8 if mode == "two_stage" else None,
                      device="cuda")
    calls = []

    def recording(*a, **kw):
        calls.append((a, kw))
        return topk_scores(*a, **kw)

    engine_mod.topk_scores = twostage_mod.topk_scores = recording
    before = topk_scores_large_k.launches
    try:
        vals, ids = eng.topk(rows, 1500)
    finally:
        engine_mod.topk_scores = twostage_mod.topk_scores = topk_scores
    assert eng.last_scan["serve_mode"] == mode
    assert topk_scores_large_k.launches == before + 3 * len(calls) > before
    assert vals.shape == (64, 1500) and np.isfinite(vals[:, :100]).all()
    for a, kw in calls:
        _check_topk(*a, exact=True, **kw)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [1, 15, 16, 17, 63, 64, 65, 300])
def test_topk_scores_batches_cross_user_tiles(cuda, table_dtype, b):
    # pass 1 takes 16 users a CTA up to B = 32, 32 above: partial blocks,
    # block edges and several blocks, on every table kind
    u, data, scale, st = _topk_problem(13, b, 2000, 32, 256, 50, table_dtype,
                                       cuda)
    _check_topk(u, data, scale, st, k_top=50, num_movies=1990, tile_m=256)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("k", [5, 129, 600])
def test_topk_scores_any_rank(cuda, table_dtype, k):
    # rank is a loop bound: odd ranks take the element-load staging, 600 is
    # above the earlier kernel's 512 cap
    u, data, scale, st = _topk_problem(17, 40, 1500, k, 256, 40, table_dtype,
                                       cuda)
    _check_topk(u, data, scale, st, k_top=30, num_movies=1500, tile_m=256)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("b", [20, 40])
def test_topk_scores_exact_ties_across_tiles(cuda, table_dtype, b):
    # integer tables: every kind (the bf16 tensor-core path included) sums
    # exactly, so ids and values equal the plain version's, ties included
    u, data, scale, st = _topk_problem(19, b, 1200, 16, 256, 30, table_dtype,
                                       cuda, integer=True)
    _check_topk(u, data, scale, st, exact=True, k_top=64, num_movies=1150,
                tile_m=256)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_topk_scores_two_stage_shape(cuda, table_dtype):
    # the two-stage rescore's call: a shortlist padded to R_pad rows whose
    # padding tail row_offset = R_pad - R masks, at a serving batch
    u, data, scale, st = _topk_problem(23, 256, 1024, 64, 256, 20,
                                       table_dtype, cuda)
    _check_topk(u, data, scale, st, k_top=100, num_movies=1024, tile_m=256,
                row_offset=324)


# The block-inverse solve (rows 14 and 15: binv_solve_reg, binv_inv) and
# the bucketed split epilogue.  Solves against the plain recursion on the
# same CUDA tensors (cuBLAS products there, in-order shared-memory sums in
# the kernel): 1e-3 of max|x|, as K1's batches in chip_smoke.py, and the
# backward error below 1e-5 in float64, as K3's — the prototype's inputs
# are rank-k/8 Grams held up by λ·n (condition numbers up to ~6e3 at
# k = 128).  Inverses: 1e-3 of max|A⁻¹|.

def _binv_inputs(k, e, device, reg_mode):
    from cfk_tpu_torch.scripts.exp_binv import make_inputs

    a, b, cnt = make_inputs(k, e, seed=k)
    if reg_mode == "diag":
        reg = cnt
    else:
        y = np.random.default_rng(1).standard_normal((4 * k, k))
        reg = (y.T @ y / (4 * k) + 0.05 * np.eye(k)).astype(np.float32)
    return tuple(torch.as_tensor(x, device=device) for x in (a, b, reg))


@pytest.mark.parametrize("k", [1, 5, 16, 24, 32, 48, 64, 96, 128])
@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
@pytest.mark.parametrize("e", [1, 300, 5248])
def test_binv_solve_reg_matches_plain(cuda, k, reg_mode, e):
    from cfk_tpu_torch.ops.kernels.binv_kernel import (
        binv_solve_reg, binv_solve_reg_plain)

    a, b, reg = _binv_inputs(k, e, cuda, reg_mode)
    before = binv_solve_reg.launches
    got = binv_solve_reg(a, b, reg, lam=0.05, reg_mode=reg_mode)
    torch.cuda.synchronize()
    assert binv_solve_reg.launches == before + 1
    want = binv_solve_reg_plain(a, b, reg, lam=0.05, reg_mode=reg_mode)
    assert binv_solve_reg.launches == before + 1  # the plain route
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) < 1e-3
    assert _backward_err(got, a, b, reg, 0.05, reg_mode) < 1e-5


@pytest.mark.parametrize("n", [1, 3, 5, 16, 18, 20, 24, 32])
@pytest.mark.parametrize("e", [1, 9, 257, 5248])
def test_binv_inv_matches_plain(cuda, n, e):
    from cfk_tpu_torch.ops.kernels.binv_kernel import binv_inv, binv_inv_plain

    a, _, cnt = _binv_inputs(n, e, cuda, "diag")
    a = add_ridge_plain(a, cnt, lam=0.05, reg_mode="diag")
    before = binv_inv.launches
    got = binv_inv(a)
    torch.cuda.synchronize()
    assert binv_inv.launches == before + 1
    want = binv_inv_plain(a)
    assert _rel_err(got, want) < 1e-3
    if n <= 16:  # a leaf alone: the plain leaf's operations, one by one
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,scale", [(16, 1e-30), (16, 1e30), (1, 3e38),
                                     (1, 1e-39), (1, 1e-45), (1, 0.0)])
def test_binv_leaf_reciprocal_at_every_scale(cuda, n, scale):
    # the leaf's 1/pivot takes a fast path on most exponents and
    # __frcp_rn's own routine on the rest (huge, subnormal, zero): either
    # way the plain leaf's IEEE division, bit for bit
    from cfk_tpu_torch.ops.kernels.binv_kernel import binv_inv, binv_inv_plain

    a, _, cnt = _binv_inputs(n, 64, cuda, "diag")
    a = add_ridge_plain(a, cnt, lam=0.05, reg_mode="diag") * scale
    got, want = binv_inv(a), binv_inv_plain(a)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


@pytest.mark.parametrize("k,reg_mode", [(128, "diag"), (128, "matrix"),
                                        (64, "diag"), (24, "matrix")])
def test_binv_kernels_bit_stable(cuda, k, reg_mode):
    # no atomics and no order that depends on the schedule: two launches
    # of each kernel on the same inputs are bit-equal
    from cfk_tpu_torch.ops.kernels.binv_kernel import binv_inv, binv_solve_reg

    a, b, reg = _binv_inputs(k, 300, cuda, reg_mode)
    first = binv_solve_reg(a, b, reg, lam=0.05, reg_mode=reg_mode)
    assert torch.equal(first, binv_solve_reg(a, b, reg, lam=0.05,
                                             reg_mode=reg_mode))
    n = min(k, 32)
    blk = (a[:, :n, :n] + 10 * torch.eye(n, device=cuda)).contiguous()
    assert torch.equal(binv_inv(blk), binv_inv(blk))


@pytest.mark.parametrize("k,leaves", [(64, 2), (128, 4)])
def test_binv_schur_route_on_the_card(cuda, k, leaves):
    from cfk_tpu_torch.ops.kernels.binv_kernel import (
        binv_inv, binv_solve_reg_plain)
    from cfk_tpu_torch.scripts.exp_binv import xla_binv_solve_reg

    a, b, cnt = _binv_inputs(k, 300, cuda, "diag")
    before = binv_inv.launches
    got = xla_binv_solve_reg(a, b, cnt, lam=0.05)
    torch.cuda.synchronize()
    assert binv_inv.launches == before + leaves
    want = binv_solve_reg_plain(a, b, cnt, lam=0.05)
    assert _rel_err(got, want) < 1e-3
    assert _backward_err(got, a, b, cnt, 0.05, "diag") < 1e-5


def test_binv_kernels_refuse_what_they_do_not_take(cuda):
    from cfk_tpu_torch.ops.kernels.binv_kernel import binv_inv, binv_solve_reg

    for k, match in ((34, "must stay even"), (256, "rank 1..128 on CUDA")):
        a, b, cnt = _binv_inputs(k, 4, cuda, "diag")
        with pytest.raises(ValueError, match=match):
            binv_solve_reg(a, b, cnt, lam=0.05)
    a, _, _ = _binv_inputs(64, 4, cuda, "diag")
    with pytest.raises(ValueError, match="n <= 32"):
        binv_inv(a)
    a, b, cnt = _binv_inputs(32, 4, cuda, "diag")
    with pytest.raises(TypeError):
        binv_solve_reg(a.double(), b, cnt, lam=0.05)
    with pytest.raises(ValueError, match="contiguous"):
        binv_inv(a.transpose(1, 2))


@pytest.mark.parametrize("gather", [None, False])
@pytest.mark.parametrize("implicit", [False, True])
def test_bucketed_split_launches_on_the_card(cuda, gather, implicit):
    """fused_epilogue=False on the bucketed layout: each width class's
    (A, b) through K2 (gather off: K5 + gram_tiles), solved by K1; K6 and
    gram_solve_tiles launch zero times.  The factors equal the fused
    route's within K1's tolerance (Cholesky on the same sums)."""
    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.models.als import _bucketed_to_device
    from cfk_tpu_torch.ops.solve import (
        als_half_step_bucketed, ials_half_step_bucketed)

    ds = Dataset.from_coo(synthetic_netflix_coo(3000, 400, 60_000, seed=1),
                          layout="bucketed", chunk_elems=4096)
    blocks = ds.movie_blocks
    trees, _ = _bucketed_to_device(blocks, cuda)
    fixed = torch.as_tensor(np.random.default_rng(2).random(
        (ds.user_blocks.padded_entities, 32), dtype=np.float32), device=cuda)
    kernels = (gram_gather, gram_tiles, gather_rows, reg_solve,
               gram_solve_gather, gram_solve_tiles)

    def run(fused):
        for fn in kernels:
            fn.launches = 0
        if implicit:
            x = ials_half_step_bucketed(fixed, trees, blocks.padded_entities,
                                        0.1, 40.0, fused_epilogue=fused,
                                        in_kernel_gather=gather)
        else:
            x = als_half_step_bucketed(fixed, trees, blocks.padded_entities,
                                       0.05, fused_epilogue=fused,
                                       in_kernel_gather=gather)
        torch.cuda.synchronize()
        return x, {fn.__name__: fn.launches for fn in kernels}

    split, n = run(False)
    fused, _ = run(None)
    classes = len(trees)
    assert n["reg_solve"] == classes
    assert n["gram_solve_gather"] == 0 and n["gram_solve_tiles"] == 0
    if gather is False:
        assert n["gather_rows"] == classes and n["gram_tiles"] == classes
        assert n["gram_gather"] == 0
    else:
        assert n["gram_gather"] == classes and n["gram_tiles"] == 0
    assert _rel_err(split, fused) < 1e-3


# The work-unit split (csrc/gram_kernels.cuh, ops/kernels/gram_units.py):
# every Gram kernel on segments of 1, 1,024, 1,025 and 200,000 rows, one
# owning none, one of 5,000 live rows with dead passes inside, a carry into
# a split segment 0 and the carry row (lseg) of a split segment; and a
# bucketed width class of one 300,000-row tile.  Each kernel against its
# plain version (Gram sums 1e-4, solves 1e-3 of the largest |value|, as
# chip_smoke.py's TOL, and the solves' backward error), each stream twin
# bit-equal to its gather sibling, and a second launch bit-equal to the
# first (the partials are summed in unit order, no float atomics).

_SPLIT_ROWS = (3_000, 1, 1_024, 1_025, 200_000, 0, 5_000, 40)
_SPLIT_LSEG = 4


def _split_tile_case(k, rng, dev):
    """(table, nb, wt, rt, seg, S): T = 16; each segment's live rows, then
    dead rows to a whole tile; segment 6 also has six 96-row dead runs."""
    f, t = 3000, 16
    nb, seg = [], []
    for s, live in enumerate(_SPLIT_ROWS):
        rows = -(-live // t) * t
        idx = rng.integers(0, f, rows)
        idx[live:] = f
        if s == 6:
            for start in range(500, 4_000, 600):
                idx[start:start + 96] = f
        nb.append(idx)
        seg.append(np.full(rows // t, s))
    nb = np.concatenate(nb).astype(np.int32)
    c = nb.size
    wt = rng.random(c, dtype=np.float32) + 0.5
    d = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    return (d(rng.standard_normal((f, k), dtype=np.float32)), d(nb), d(wt),
            d(rng.standard_normal(c, dtype=np.float32)),
            d(np.concatenate(seg).astype(np.int32)), len(_SPLIT_ROWS))


def _split_dense_case(k, rng, dev):
    """(table, nb, wt, rt, meta, dense kwargs): one group, T = 128, tile i
    reads stream rows i·T + [lo_i, hi_i); every tile's window starts at a
    random row below 32, so units start inside tiles; rt 0 off-window."""
    f, t = 3000, 128
    lo, hi, seg = [], [], []
    for s, live in enumerate(_SPLIT_ROWS):
        while live > 0:
            a = int(rng.integers(0, 32))
            lo.append(a)
            hi.append(min(t, a + live))
            seg.append(s)
            live -= hi[-1] - a
    nt = len(seg)
    lo, hi = np.array(lo), np.array(hi)
    r = np.arange(t)
    win = ((r >= lo[:, None]) & (r < hi[:, None])).reshape(-1)
    nb = np.where(win, rng.integers(0, f, nt * t), f)
    six = np.flatnonzero(np.repeat(np.array(seg) == 6, t) & win)
    for start in range(500, 4_000, 600):
        nb[six[start:start + 96]] = f
    meta = np.concatenate([[0], np.arange(nt) * t, lo, hi, seg])
    d = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    rt = rng.standard_normal(nt * t, dtype=np.float32) * win
    kw = dict(num_segments=len(_SPLIT_ROWS), tile_rows=t, num_tiles=nt,
              num_groups=1, block_rows=nt * t)
    return (d(rng.standard_normal((f, k), dtype=np.float32)),
            d(nb.astype(np.int32)), d(rng.random(nt * t, dtype=np.float32)
                                      + 0.5), d(rt.astype(np.float32)),
            d(meta.astype(np.int32)), kw)


def _twice(fn, *args, **kw):
    """Two launches; they must agree bit for bit."""
    first = fn(*args, **kw)
    second = fn(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second)), fn.__name__
    return first


def _check_gram(got, want):
    assert _rel_err(got[0], want[0]) < 1e-4 and _rel_err(got[1], want[1]) < 1e-4


def _check_solve(got, want, ab, reg):
    assert _backward_err(got[0], *ab, reg, 0.05, "diag") < 1e-5
    assert _rel_err(got[0], want[0]) < 1e-3
    assert _rel_err(got[1], want[1]) < 1e-4 and _rel_err(got[2], want[2]) < 1e-4


@pytest.mark.parametrize("k", [8, 64, 128])
@pytest.mark.parametrize("walk", ["tile", "dense", "bucket"])
def test_split_segments_on_every_gram_kernel(cuda, k, walk):
    rng = np.random.default_rng(k)
    z = rng.standard_normal((2 * k, k)).astype(np.float32)
    carry = (torch.as_tensor(z.T @ z, device=cuda),
             torch.as_tensor(rng.standard_normal(k).astype(np.float32),
                             device=cuda), torch.ones((1,), device=cuda))
    if walk == "dense":
        table, nb, wt, rt, meta, kw = _split_dense_case(k, rng, cuda)
        gram, gram_twin = gram_tiles_dense_gather, gram_tiles_dense
        solve, solve_twin = gram_solve_dense, gram_solve_tiles_dense
        gram_plain = gram_tiles_dense_gather_plain
        solve_plain = gram_solve_dense_plain
        kw = dict(kw, meta=meta, carry=carry)
        lseg = _SPLIT_LSEG
    else:
        if walk == "tile":
            table, nb, wt, rt, seg, s = _split_tile_case(k, rng, cuda)
            t, lseg, c = 16, _SPLIT_LSEG, carry
        else:  # one width class, one 300k-row tile, no carry
            f, t, s = 3000, 300_000, 1
            d = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
            table = d(rng.standard_normal((f, k), dtype=np.float32))
            nb = d(rng.integers(0, f, t).astype(np.int32))
            wt = d(rng.random(t, dtype=np.float32) + 0.5)
            rt = d(rng.standard_normal(t, dtype=np.float32))
            seg = torch.zeros(1, dtype=torch.int32, device=cuda)
            lseg, c = 0, None
        gram, gram_twin = gram_gather, gram_tiles
        solve, solve_twin = gram_solve_gather, gram_solve_tiles
        gram_plain, solve_plain = gram_gather_plain, gram_solve_gather_plain
        kw = dict(seg=seg, num_segments=s, tile_rows=t, carry=c)
    g = gather_rows(table, nb, wt)
    ab = _twice(gram, table, nb=nb, wt=wt, rt=rt, **kw)
    want = gram_plain(table, nb=nb, wt=wt, rt=rt, **kw)
    _check_gram(ab, want)
    twin = _twice(gram_twin, g, rt=rt, **kw)
    assert all(torch.equal(x, y) for x, y in zip(twin, ab))
    counts = torch.as_tensor(np.array(_SPLIT_ROWS[:kw["num_segments"]])
                             if walk != "bucket" else np.array([t]),
                             device=cuda, dtype=torch.float32)
    skw = dict(kw, reg=counts, lseg=lseg, lam=0.05)
    x = _twice(solve, table, nb=nb, wt=wt, rt=rt, **skw)
    _check_solve(x, solve_plain(table, nb=nb, wt=wt, rt=rt, **skw), want,
                 counts)
    twin = _twice(solve_twin, g, rt=rt, **skw)
    assert all(torch.equal(a, b) for a, b in zip(twin, x))
    # The split and fused schedules solve the same sums: K1 on the Gram
    # kernel's (A, b) solves what the fused epilogue solves in place.
    assert torch.equal(reg_solve(*ab, counts, lam=0.05), x[0])


# Ranks above 128.  The four split Gram kernels (K2, gram_tiles_dense_gather
# and their stream twins gram_tiles, gram_tiles_dense) sum 128 x 128 block
# pairs there (csrc/gram_kernels.cuh, gram_pair_kernel): against their plain
# versions as below 128 (1e-5 of the largest |value| on a short chunk, 1e-4
# with 200,000-row segments), each launched twice (bit-equal), each twin fed
# K5's stream bit-equal to its gather sibling, every Gram exactly symmetric
# (a block and its mirror are the same sums).  k = 129 leaves the last block
# one column wide; 512 is 10 block pairs.  The fused kernels and K1 refuse
# these ranks: the half-steps route them to the split Grams and
# batched_spd_solve, PyTorch's Cholesky, held here to a float64 solve.

_ABOVE_128 = [129, 136, 256, 512]


def _symmetric(a):
    return torch.equal(a, a.transpose(1, 2))


@pytest.mark.parametrize("k", _ABOVE_128)
def test_split_grams_above_128_match_plain(cuda, k):
    table, nb, wt, args, carry, empty = _stream_chunk(k, cuda, 300 + k)
    g = gather_rows(table, nb, wt)
    got = _twice(gram_gather, table, nb, wt, **args, carry=carry)
    want = gram_gather_plain(table, nb, wt, **args, carry=carry)
    assert _rel_err(got[0], want[0]) < 1e-5 and _rel_err(got[1], want[1]) < 1e-5
    assert _symmetric(got[0])
    keep = torch.as_tensor(empty[empty != 0], device=cuda, dtype=torch.long)
    assert not got[0][keep].any() and not got[1][keep].any()
    twin = _twice(gram_tiles, g, **args, carry=carry)
    assert all(torch.equal(x, y) for x, y in zip(twin, got))
    rng = np.random.default_rng(k)
    table, nb, wt, rt, meta, kw = _split_dense_case(k, rng, cuda)
    kw = dict(kw, meta=meta, carry=carry)
    got = _twice(gram_tiles_dense_gather, table, nb, wt, rt, **kw)
    _check_gram(got, gram_tiles_dense_gather_plain(table, nb, wt, rt, **kw))
    assert _symmetric(got[0])
    twin = _twice(gram_tiles_dense, gather_rows(table, nb, wt), rt, **kw)
    assert all(torch.equal(x, y) for x, y in zip(twin, got))
    table, nb, wt, rt, seg, s = _split_tile_case(k, rng, cuda)
    kw = dict(seg=seg, num_segments=s, tile_rows=16, carry=carry)
    got = _twice(gram_gather, table, nb, wt, rt, **kw)
    _check_gram(got, gram_gather_plain(table, nb, wt, rt, **kw))
    twin = _twice(gram_tiles, gather_rows(table, nb, wt), rt, **kw)
    assert all(torch.equal(x, y) for x, y in zip(twin, got))


@pytest.mark.parametrize("k", [136, 256])
def test_split_grams_above_128_on_a_dense_side(cuda, k):
    """Every dense chunk of a real side at tile_rows 128, the carry
    threaded, unit plans staged by the device upload."""
    blocks, blk, table = _tiled_side(k, 128, 4096, cuda, accum=False)
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin, _, lseg = args.pop("cin"), args.pop("reg"), args.pop("lseg")
        got = gram_tiles_dense_gather(table, **args, carry=(a0, b0, cin))
        torch.cuda.synchronize()
        want = gram_tiles_dense_gather_plain(table, **args,
                                             carry=(a0, b0, cin))
        assert _rel_err(got[0], want[0]) < 1e-5
        assert _rel_err(got[1], want[1]) < 1e-5
        a0, b0 = got[0][int(lseg)], got[1][int(lseg)]


def test_batched_spd_solve_matches_float64(cuda):
    """The k > 128 solve at k = 256: ALS-shaped systems (a Gram of 2k
    normal rows plus λ·max(n, 1)·I), 1e-4 of max|x| from float64."""
    g = torch.Generator().manual_seed(256)
    e, k = 300, 256
    x = torch.randn((e, 2 * k, k), generator=g)
    a = torch.einsum("enk,enl->ekl", x, x)
    a.diagonal(dim1=1, dim2=2).add_(
        0.05 * torch.randint(1, 400, (e, 1), generator=g).float())
    b = torch.randn((e, k), generator=g)
    got = batched_spd_solve(a.to(cuda), b.to(cuda))
    want = torch.linalg.solve(a.double(), b.double())
    assert _rel_err(got.cpu().double(), want) < 1e-4
    assert _rel_err(dispatch_spd_solve(a.to(cuda), b.to(cuda)), got) == 0.0


def test_fused_kernels_refuse_above_128(cuda):
    table, nb, wt, args, carry, _ = _stream_chunk(129, cuda, 7)
    reg = torch.ones(args["num_segments"], device=cuda)
    with pytest.raises(ValueError, match="gram_solve_gather supports rank"):
        gram_solve_gather(table, nb, wt, **args, reg=reg, lseg=0)
    a, b, cnt = _spd_batch(3, 129, 1, cuda)
    with pytest.raises(ValueError, match="reg_solve supports rank 1..128"):
        reg_solve(a, b, cnt, lam=0.05)
    blocks, blk, table = _tiled_side(136, 16, 4096, cuda, accum=False)
    d = dense_chunk(blk, blocks.statics, 0)
    d.pop("cin")
    with pytest.raises(ValueError, match="gram_solve_dense supports rank"):
        gram_solve_dense(table, **d, lam=0.05)


@pytest.mark.parametrize("layout", ["tiled", "padded", "bucketed"])
def test_train_als_above_128_on_the_card(cuda, layout):
    """train_als at rank 136 on the card against the CPU's plain route
    (1e-3 of the largest |factor|, the trainer tolerance), from the same
    start: every route runs kernels (the split Grams, the dispatch's
    Cholesky) and never K1 or a fused Gram kernel."""
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    kw = dict(layout=layout, chunk_elems=2048)
    if layout == "tiled":  # the accum movie half, the dense user half
        kw.update(dense_stream=True, accum_max_entities=200)
    ds = Dataset.from_coo(coo, **kw)
    k = 136
    u0 = (np.random.default_rng(5).random(
        (ds.user_map.num_entities, k)).astype(np.float32),
          np.zeros((ds.movie_map.num_entities, k), np.float32))
    cfg = ALSConfig(rank=k, num_iterations=2, layout=layout)
    fused = (gk.gram_solve_dense, gk.gram_solve_gather, gk.gram_solve_tiles,
             gk.gram_solve_tiles_dense, reg_solve)
    for fn in fused + (gk.gram_gather, gk.gram_tiles_dense_gather):
        fn.launches = 0
    card = train_als(ds, cfg, warm_start=u0, device="cuda")
    cpu = train_als(ds, cfg, warm_start=u0, device="cpu")
    assert all(fn.launches == 0 for fn in fused)
    if layout != "padded":
        assert gk.gram_gather.launches > 0
    if layout == "tiled":
        assert gk.gram_tiles_dense_gather.launches > 0
    for got, want in ((card.user_factors, cpu.user_factors),
                      (card.movie_factors, cpu.movie_factors)):
        got, want = torch.as_tensor(got).cpu(), torch.as_tensor(want).cpu()
        assert torch.isfinite(got).all()
        assert _rel_err(got, want) < 1e-3


@pytest.mark.parametrize("table_dtype", ["float32", "int8"])
@pytest.mark.parametrize("b,two_stage", [(16, False), (64, False),
                                         (256, False), (256, True)])
def test_topk_scores_bit_equal_at_serve_shapes(cuda, table_dtype, b,
                                               two_stage):
    """At the serve configurations' shapes (rank 128, K = 100, 2,048-row
    tiles, seen lists; the two-stage rescore's padded shortlist) an int8
    table scores Σ (code·scale)·u, the plain version's order, so K4 returns
    its values and ids bit for bit, as for an f32 table."""
    u, data, scale, st = _topk_problem(29 + b, b, 6000, 128, 2048, 200,
                                       table_dtype, cuda)
    kw = dict(k_top=100, num_movies=6000, tile_m=2048)
    if two_stage:
        kw.update(num_movies=6144, row_offset=1200)
    _check_topk(u, data, scale, st, exact=True, **kw)


@pytest.mark.parametrize("k", [64, 128])
@pytest.mark.parametrize("implicit", [False, True])
def test_segment_half_step_matches_plain(cuda, k, implicit):
    """The segment half-step on the card (K2's one-row-tile Grams and K1,
    once a chunk each) against the same half-step's plain route on the CPU,
    on a side whose hot movies straddle chunks; K1 launches once a chunk.
    Float32 Grams summed in other orders, then solves: 1e-4 of the largest
    |x|, the K1 batch tolerance."""
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.models.als import _segment_to_device
    from cfk_tpu_torch.ops.solve import (
        als_half_step_segment,
        ials_half_step_segment,
    )

    coo = synthetic_netflix_coo(3000, 400, 60_000, seed=1)
    mb = Dataset.from_coo(coo, layout="segment",
                          chunk_elems=64 * 4096).movie_blocks
    assert mb.carry_in.sum() > 0 and mb.num_chunks > 4
    fixed = np.random.default_rng(k).random((3000, k), dtype=np.float32)
    out = {}
    for dev in ("cpu", cuda):
        args = (torch.as_tensor(fixed, device=dev),
                _segment_to_device(mb, dev), mb.statics, mb.padded_entities)
        reg_solve.launches = 0
        out[str(dev)] = (ials_half_step_segment(*args, 0.1, 2.0)
                         if implicit else als_half_step_segment(*args, 0.05))
        torch.cuda.synchronize()
        if dev == cuda:
            assert reg_solve.launches == mb.num_chunks
    want, got = out["cpu"], out[str(cuda)].cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


# The quantized gather tables (ops.quant): every Gram kernel and K5 on a
# bf16 table and on int8 codes whose per-row scale is folded into the
# weights (fold_scale), against their plain versions — rows 2-10 at k = 8
# (the CPU tests' rank: bf16 rows of 16 bytes take the vector loads, int8
# rows of 8 the scalar path), 16 (int8's vector width), 64, 128, and past
# 128 for the split Grams (the block-pair staging).  K5 is bit-equal to its
# plain version (one conversion, at most one product and one rounding per
# element); the Grams' sums within 1e-5 (bf16 products are exact in
# float32: only the order differs); the solves by backward error as above.
# Each stream twin fed K5's stream returns its gather sibling's bits.

QUANT_KS = [8, 16, 64, 128]


def _quantized(table, nb, wt, table_dtype):
    """(data, wt'): the table in ``table_dtype`` and the weights with an
    int8 table's scale folded in (an unweighted int8 chunk gets ones)."""
    from cfk_tpu_torch.ops.quant import fold_scale

    data, scale = quantize_table(table, table_dtype)
    if scale is not None and wt is None:
        wt = torch.ones(nb.shape, device=nb.device)
    return data, fold_scale(wt, scale, nb) if scale is not None else wt


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k", [5, 8, 16, 64, 128])
@pytest.mark.parametrize("weighted", [False, True])
def test_quant_gather_rows_matches_plain(cuda, table_dtype, k, weighted):
    """K5 on a quantized table: bf16 → bf16 stream (and float32 on
    request), int8 → float32; bit-equal to the plain version, the zero row
    and out-of-table indices zeros."""
    rng = np.random.default_rng(k)
    f, c = 1000, 4099
    table = torch.as_tensor(rng.standard_normal((f, k), dtype=np.float32),
                            device=cuda)
    nb = rng.integers(0, f, c).astype(np.int32)
    nb[::7] = f
    nb[5::13] = -1
    nb = torch.as_tensor(nb, device=cuda)
    wt = (torch.as_tensor(rng.random(c, dtype=np.float32), device=cuda)
          if weighted else None)
    data, wt = _quantized(table, nb, wt, table_dtype)
    outs = [None] + ([torch.float32] if table_dtype == "bfloat16" else [])
    for out_dtype in outs:
        got = gather_rows(data, nb, wt, out_dtype)
        torch.cuda.synchronize()
        want = gather_rows_plain(data, nb, wt, out_dtype)
        assert got.dtype == want.dtype
        assert got.dtype == (torch.bfloat16 if table_dtype == "bfloat16"
                             and out_dtype is None else torch.float32)
        assert torch.equal(got, want)
        assert torch.all(got[::7] == 0)


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k", QUANT_KS)
def test_quant_tile_kernels_match_plain(cuda, table_dtype, k):
    """K2 and K6 on a quantized table, rows 5 and 6 on its K5 stream: each
    against its plain version, each twin bit-equal to its sibling, and two
    launches of each bit-equal."""
    table, nb, wt, args, carry, empty = _stream_chunk(k, cuda, 7 * k)
    data, wt = _quantized(table, nb, wt, table_dtype)
    g = gather_rows(data, nb, wt)
    a, b = gram_gather(data, nb, wt, **args, carry=carry)
    again = gram_gather(data, nb, wt, **args, carry=carry)
    twin = gram_tiles(g, **args, carry=carry)
    torch.cuda.synchronize()
    wa, wb = gram_gather_plain(data, nb, wt, **args, carry=carry)
    assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
    assert torch.equal(a, again[0]) and torch.equal(b, again[1])
    assert torch.equal(a, twin[0]) and torch.equal(b, twin[1])
    ta, tb = gram_tiles_plain(g, **args, carry=carry)
    assert _rel_err(twin[0], ta) < 1e-5 and _rel_err(twin[1], tb) < 1e-5
    lseg = int(args["seg"][-1])
    for reg_mode, reg in _ridges(k, args["num_segments"], cuda, k).items():
        kw = dict(reg=reg, lseg=lseg, lam=0.05, reg_mode=reg_mode,
                  carry=carry)
        x, ca, cb = gram_solve_gather(data, nb, wt, **args, **kw)
        sib = gram_solve_tiles(g, **args, **kw)
        torch.cuda.synchronize()
        wx, wca, wcb = gram_solve_gather_plain(data, nb, wt, **args, **kw)
        assert _backward_err(x, wa, wb, reg, 0.05, reg_mode) < 1e-5
        assert _rel_err(x, wx) < 1e-2
        assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
        assert all(torch.equal(p, q) for p, q in zip((x, ca, cb), sib))


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k", QUANT_KS)
def test_quant_dense_kernels_match_plain(cuda, table_dtype, k):
    """K3 and row 9 on a quantized table over every dense chunk of a real
    side (explicit: unit weights — an int8 chunk carries its bare scale
    stream — and the carry threaded), rows 7 and 4 on K5's stream of the
    same operands: against the plain versions, twins bit-equal."""
    blocks, blk, table = _tiled_side(k, 16, 4096, cuda, accum=False)
    a0 = torch.zeros((k, k), device=cuda)
    b0 = torch.zeros((k,), device=cuda)
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, blocks.statics, c)
        cin, reg, lseg = args.pop("cin"), args.pop("reg"), args.pop("lseg")
        nb, wt = args.pop("nb"), args.pop("wt")
        data, wt = _quantized(table, nb, wt, table_dtype)
        carry = (a0, b0, cin)
        a, b = gram_tiles_dense_gather(data, nb, wt, **args, carry=carry)
        torch.cuda.synchronize()
        wa, wb = gram_tiles_dense_gather_plain(data, nb, wt, **args,
                                               carry=carry)
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
        kw = dict(reg=reg, lseg=lseg, lam=0.05, carry=carry)
        x, ca, cb = gram_solve_dense(data, nb, wt, **args, **kw)
        torch.cuda.synchronize()
        assert _backward_err(x, wa, wb, reg, 0.05, "diag") < 1e-5
        wx, wca, wcb = gram_solve_dense_plain(data, nb, wt, **args, **kw)
        assert _rel_err(x, wx) < 1e-2
        assert _rel_err(ca, wca) < 1e-5 and _rel_err(cb, wcb) < 1e-5
        g = gather_rows(data, nb, wt)
        twin = gram_tiles_dense(g, **args, carry=carry)
        solved = gram_solve_tiles_dense(g, **args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(twin[0], a) and torch.equal(twin[1], b)
        assert all(torch.equal(p, q) for p, q in zip(solved, (x, ca, cb)))
        pa, pb = gram_tiles_dense_plain(g, **args, carry=carry)
        assert _rel_err(twin[0], pa) < 1e-5 and _rel_err(twin[1], pb) < 1e-5
        a0, b0 = wca, wcb


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("k", [8, 64, 136])
def test_quant_accum_gram_matches_plain(cuda, table_dtype, k):
    """K2 on every accum chunk of a real side with a quantized table (the
    absolute indices, F the zero row, under the fold), and row 5 on K5's
    stream, at and past the block-pair rank."""
    blocks, blk, table = _tiled_side(k, 16, 4096, cuda, accum=True)
    for c in range(blocks.num_chunks):
        args = accum_chunk(blk, blocks.statics, c)
        nb, wt = args.pop("nb"), args.pop("wt")
        data, wt = _quantized(table, nb, wt, table_dtype)
        a, b = gram_gather(data, nb, wt, **args)
        twin = gram_tiles(gather_rows(data, nb, wt), **args)
        torch.cuda.synchronize()
        wa, wb = gram_gather_plain(data, nb, wt, **args)
        assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
        assert torch.equal(twin[0], a) and torch.equal(twin[1], b)


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
def test_quant_split_dense_grams_past_128(cuda, table_dtype):
    """Row 9 and row 4 at k = 136 (the block-pair kernel's element-wise
    conversion) on a quantized table: against plain, twin bit-equal."""
    k = 136
    blocks, blk, table = _tiled_side(k, 16, 4096, cuda, accum=False)
    args = dense_chunk(blk, blocks.statics, 1)
    for key in ("cin", "reg", "lseg"):
        args.pop(key)
    nb, wt = args.pop("nb"), args.pop("wt")
    data, wt = _quantized(table, nb, wt, table_dtype)
    a, b = gram_tiles_dense_gather(data, nb, wt, **args)
    twin = gram_tiles_dense(gather_rows(data, nb, wt), **args)
    torch.cuda.synchronize()
    wa, wb = gram_tiles_dense_gather_plain(data, nb, wt, **args)
    assert _rel_err(a, wa) < 1e-5 and _rel_err(b, wb) < 1e-5
    assert torch.equal(twin[0], a) and torch.equal(twin[1], b)


def test_quant_kernels_refuse_unweighted_int8(cuda):
    """An int8 table's scale rides only in the weights: the dense Grams
    (whose weights are optional) refuse an int8 call without them."""
    blocks, blk, table = _tiled_side(8, 16, 4096, cuda, accum=False)
    args = dense_chunk(blk, blocks.statics, 0)
    cin = args.pop("cin")
    data, _ = quantize_table(table, "int8")
    with pytest.raises(ValueError, match="int8 table needs"):
        gram_solve_dense(data, **args, lam=0.05)
    for key in ("reg", "lseg"):
        args.pop(key)
    with pytest.raises(ValueError, match="int8 table needs"):
        gram_tiles_dense_gather(data, **args)
    assert cin is not None


@pytest.mark.parametrize("table_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("layout", ["tiled", "bucketed"])
def test_quant_training_on_the_card(cuda, table_dtype, layout):
    """train_als and train_ials with a quantized table on the card: one
    iteration's movie half against the plain versions on the CPU from the
    same start (1e-4: the kernels' sums differ from the einsums' only in
    order; later halves gather their own rounded tables, where a last-bit
    difference can move a bf16 or int8 rounding, so the runs are held to
    each other one half at a time), and two iterations with the gather off
    bit-equal to the gather on."""
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.models.ials import IALSConfig, train_ials

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout=layout, chunk_elems=2048,
                          dense_stream=True)
    rng = np.random.default_rng(0)
    u0 = rng.random((ds.user_blocks.padded_entities, 8), dtype=np.float32)
    m0 = np.zeros((ds.movie_blocks.padded_entities, 8), np.float32)
    for make, train in ((ALSConfig, train_als), (IALSConfig, train_ials)):
        runs = {}
        for dev, gather, iters in ((cuda, None, 1), ("cpu", None, 1),
                                   (cuda, None, 2), (cuda, False, 2)):
            cfg = make(rank=8, num_iterations=iters, layout=layout,
                       table_dtype=table_dtype, in_kernel_gather=gather)
            runs[str(dev), gather, iters] = train(ds, cfg, device=dev,
                                                  warm_start=(u0, m0))
        card, cpu = runs["cuda", None, 1], runs["cpu", None, 1]
        assert _rel_err(card.movie_factors.cpu(), cpu.movie_factors) < 1e-4
        on, off = runs["cuda", None, 2], runs["cuda", False, 2]
        assert torch.equal(on.user_factors, off.user_factors)
        assert torch.equal(on.movie_factors, off.movie_factors)


# -- the chunk pipeline: captured iterations and the side-stream prefetch ----

_PIPE_CASES = [
    # (layout, dataset kw, config kw)
    ("padded", {}, dict(solve_chunk=64)),
    ("tiled", dict(dense_stream=True, accum_max_entities=200), {}),
    ("tiled", dict(dense_stream=True, accum_max_entities=200),
     dict(fused_epilogue=False)),
    ("tiled", dict(dense_stream=True, accum_max_entities=200),
     dict(in_kernel_gather=False)),
    ("tiled", dict(dense_stream=True, accum_max_entities=200),
     dict(in_kernel_gather=False, fused_epilogue=False)),
    ("tiled", dict(accum_max_entities=200), dict(in_kernel_gather=False)),
    ("tiled", dict(dense_stream=True, accum_max_entities=200),
     dict(table_dtype="int8")),
    ("tiled", dict(dense_stream=True, accum_max_entities=200),
     dict(dtype="bfloat16")),
    ("bucketed", {}, {}),
    ("bucketed", {}, dict(in_kernel_gather=False, table_dtype="bfloat16")),
    ("bucketed", {}, dict(fused_epilogue=False)),
    ("bucketed", {}, dict(algorithm="++", block_size=4)),
    ("segment", {}, {}),
]


def _pipe_runs(cuda, layout, ds_kw, cfg_kw, implicit, k=8, iters=3):
    """train_als / train_ials with overlap on and every iteration after the
    first captured (``capture=True``), and with overlap off, on the card
    from the same start, every kernel's launch counter zeroed before each
    run."""
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.models.ials import IALSConfig, train_ials
    from cfk_tpu_torch.ops.pipeline import launch_counters

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout=layout, chunk_elems=2048, **ds_kw)
    rng = np.random.default_rng(0)
    u0 = rng.random((ds.user_blocks.padded_entities, k), dtype=np.float32)
    m0 = np.zeros((ds.movie_blocks.padded_entities, k), np.float32)
    cfg_kw = dict(cfg_kw)
    if cfg_kw.get("algorithm") == "++":
        cfg_kw["algorithm"] = "ials++" if implicit else "als++"
    make, train = (IALSConfig, train_ials) if implicit else (ALSConfig,
                                                            train_als)
    runs = {}
    for overlap in (True, False):
        for fn in launch_counters():
            fn.launches = 0
        model = train(ds, make(rank=k, num_iterations=iters, layout=layout,
                               overlap=overlap, capture=overlap, **cfg_kw),
                      device=cuda, warm_start=(u0, m0))
        torch.cuda.synchronize()
        runs[overlap] = (model, {fn.__name__: fn.launches
                                 for fn in launch_counters() if fn.launches})
    return runs


def _check_replays(on, n_on, n_off, iters):
    """A captured run's counters (iteration 1) and its graph against the
    serial run's counters over ``iters`` iterations."""
    from cfk_tpu_torch.ops.pipeline import replay_launches

    rec = on.pipeline["launches_per_replay"]
    assert rec and on.pipeline["capture_s"] > 0
    names = set(n_on) | set(rec) | set(n_off)
    assert {name: n_on.get(name, 0) + (iters - 1) * rec.get(name, 0)
            for name in names} == {name: n_off.get(name, 0)
                                   for name in names}
    replays = replay_launches(on.pipeline)
    assert replays and all(calls == nodes
                           for calls, nodes in replays.values()), replays


@pytest.mark.parametrize("implicit", [False, True], ids=["als", "ials"])
@pytest.mark.parametrize("layout,ds_kw,cfg_kw", _PIPE_CASES)
def test_captured_iterations_match_eager(cuda, layout, ds_kw, cfg_kw,
                                         implicit):
    """Overlap on (iteration 1 eager, 2 and 3 replays of one captured
    iteration) against the serial eager loop: bit-equal factors; the
    counters show iteration 1's launches, the serial run's are those plus
    two iterations of what the capture recorded, and the graph holds one
    kernel node for each recorded launch (``replay_launches``, read from
    libcuda).  Every layout, the segment one too: its Grams go through K2's
    work units, which sum each segment in a fixed order."""
    runs = _pipe_runs(cuda, layout, ds_kw, cfg_kw, implicit)
    (on, n_on), (off, n_off) = runs[True], runs[False]
    assert on.pipeline["route"] == "captured"
    assert off.pipeline["route"] == "serial"
    _check_replays(on, n_on, n_off, 3)
    for got, want in ((on.user_factors, off.user_factors),
                      (on.movie_factors, off.movie_factors)):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


def test_replay_reads_factors_updated_in_place(cuda):
    """The captured graph reads the static factor tensors: writing new
    values into them in place and replaying gives the eager iteration from
    those values, bit for bit."""
    from cfk_tpu_torch import ALSConfig, Dataset
    from cfk_tpu_torch.models.als import (
        _half,
        device_setup,
        iteration_step,
    )
    from cfk_tpu_torch.ops.pipeline import CapturedStep
    import functools

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=2048,
                          dense_stream=True, accum_max_entities=200)
    cfg = ALSConfig(rank=8, layout="tiled")
    mblocks, ublocks, layout_kw, _ = device_setup(ds, cfg, cuda)
    step = iteration_step(functools.partial(_half, lam=0.05,
                                            solve_chunk=None, solver="auto"),
                          mblocks, ublocks, layout_kw, torch.float32)
    rng = np.random.default_rng(1)
    u = torch.as_tensor(rng.random((ds.user_blocks.padded_entities, 8),
                                   dtype=np.float32), device=cuda)
    m = torch.zeros((ds.movie_blocks.padded_entities, 8), device=cuda)
    captured = CapturedStep(step)
    su, sm = captured.run((u, m), 2)
    u2 = torch.as_tensor(rng.random(tuple(su.shape), dtype=np.float32),
                         device=cuda)
    su.copy_(u2)
    sm.zero_()
    captured.graph.replay()
    want_u, want_m = step((u2, torch.zeros_like(m)), None)
    torch.cuda.synchronize()
    assert torch.equal(su, want_u) and torch.equal(sm, want_m)


@pytest.mark.parametrize("mode", ["accum", "dstream", "stream"])
def test_side_stream_prefetch_matches_serial(cuda, mode):
    """The gather-off chunk scans with K5 on a side stream (overlap on, no
    capture) against the serial loop: bit-equal halves, the same K5 and
    Gram launch counts."""
    from cfk_tpu_torch import Dataset
    from cfk_tpu_torch.ops.kernels import gram_kernel as gk
    from cfk_tpu_torch.ops.pipeline import launch_counters
    from cfk_tpu_torch.ops.tiled import tiled_half_step

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=2048,
                          dense_stream=mode != "stream",
                          accum_max_entities=200)
    blocks = ds.movie_blocks if mode == "accum" else ds.user_blocks
    assert blocks.mode == mode
    other = ds.user_blocks if mode == "accum" else ds.movie_blocks
    blk = _tiled_to_device(blocks, cuda, other.padded_entities)
    chunks = ("tiled", blocks.mode) + blocks.statics
    assert blocks.num_chunks > 2
    table = torch.as_tensor(np.random.default_rng(2).random(
        (other.padded_entities, 16), dtype=np.float32), device=cuda)
    out = {}
    for overlap in (True, False):
        for fn in launch_counters():
            fn.launches = 0
        x = tiled_half_step(table, blk, chunks, blocks.padded_entities, 0.05,
                            in_kernel_gather=False, overlap=overlap)
        torch.cuda.synchronize()
        out[overlap] = (x, {fn.__name__: fn.launches
                            for fn in launch_counters() if fn.launches})
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    assert out[True][1]["gather_rows"] == blocks.num_chunks
    assert gk.gather_rows.launches == blocks.num_chunks


def test_rank_above_128_captured(cuda):
    """Above rank 128 every solve takes the library Cholesky route
    (``batched_spd_solve``: ``cholesky_ex`` and two cuBLAS triangular
    solves), which a CUDA graph captures: the replays are bit-equal to the
    serial loop."""
    runs = _pipe_runs(cuda, "tiled", dict(dense_stream=True,
                                          accum_max_entities=200),
                      dict(in_kernel_gather=False), False, k=136, iters=2)
    (on, n_on), (off, n_off) = runs[True], runs[False]
    assert on.pipeline["route"] == "captured"
    _check_replays(on, n_on, n_off, 2)
    assert torch.equal(on.user_factors, off.user_factors)
    assert torch.equal(on.movie_factors, off.movie_factors)


def test_batched_spd_solve_captures(cuda):
    """The k > 128 solve captured into a CUDA graph and replayed returns the
    eager call's bits, at a Netflix dense chunk's batch."""
    g = torch.Generator().manual_seed(3)
    e, k = 4879, 256
    x = torch.randn((e, k + 8, k), generator=g)
    a = torch.einsum("enk,enl->ekl", x, x).to(cuda)
    a.diagonal(dim1=1, dim2=2).add_(1.0)
    b = torch.randn((e, k), generator=g).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = batched_spd_solve(a, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = batched_spd_solve(a, b)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.isfinite(got).all()


# -- the segment layout's Gram through K2 (one-row tiles) ----------------------

def _segment_half(k=8, seed=4):
    from cfk_tpu_torch import Dataset

    coo = synthetic_netflix_coo(600, 150, 9000, seed=seed)
    ds = Dataset.from_coo(coo, layout="segment", chunk_elems=k * 512)
    mb = ds.movie_blocks
    assert mb.num_chunks > 2 and mb.carry_in.sum() > 0
    return ds, mb


@pytest.mark.parametrize("implicit,dtype", [
    (False, torch.float32), (True, torch.float32), (True, torch.bfloat16)],
    ids=["als", "ials", "ials_bf16"])
def test_segment_half_step_bit_stable_k2_per_chunk(cuda, implicit, dtype):
    """A segment half twice on the card: bit-equal (K2's work units sum
    each segment in unit order — no atomics), K2 and K1 launched once a
    chunk, and within 1e-4 of the plain route on the CPU.  iALS with a
    bf16 table keeps the JAX package's rounding order on this layout
    (``ops.solve.segment_gram_rounded``: sorted segment sums, no atomics):
    bit-equal too, with K1 once a chunk and no K2."""
    from cfk_tpu_torch.models.als import _segment_to_device
    from cfk_tpu_torch.ops import solve as t_solve

    ds, mb = _segment_half()
    fixed = np.abs(np.random.default_rng(0).standard_normal(
        (ds.user_blocks.padded_entities, 8)).astype(np.float32))

    def half(dev):
        blk = _segment_to_device(mb, dev)
        f = torch.as_tensor(fixed, device=dev).to(dtype)
        if implicit:
            return t_solve.ials_half_step_segment(
                f, blk, mb.statics, mb.padded_entities, 0.1, 40.0)
        return t_solve.als_half_step_segment(f, blk, mb.statics,
                                             mb.padded_entities, 0.05)

    gram_gather.launches = reg_solve.launches = 0
    first = half(cuda)
    k2 = 0 if dtype == torch.bfloat16 else mb.num_chunks
    assert (gram_gather.launches, reg_solve.launches) == (k2, mb.num_chunks)
    assert torch.equal(half(cuda), first)
    assert _rel_err(first.cpu(), half(torch.device("cpu"))) < 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["explicit", "weighted"])
@pytest.mark.parametrize("k", [8, 64, 136])
def test_gram_gather_one_row_tiles_matches_plain(cuda, k, weighted, dtype):
    """K2 at ``tile_rows = 1`` on segment chunks — the flat run, one owner
    per entry (``seg_rel``), the trash segment last, the staged work-unit
    plan, the carry folded into segment 0 — against its plain version
    (1e-5 of the largest |value|), launched twice (bit-equal); k = 136 on
    the block-pair grid.  Weighted: the iALS √(α·r) weights and their
    b-coefficients (``ops.bucketed.ials_reparam``)."""
    from cfk_tpu_torch.models.als import _segment_to_device
    from cfk_tpu_torch.ops.bucketed import ials_reparam
    from cfk_tpu_torch.ops.kernels.gram_units import chunk_plan

    ds, mb = _segment_half(k=k)
    nc, cap, e_c = mb.statics
    blk = _segment_to_device(mb, cuda)
    g = torch.Generator().manual_seed(k)
    table = torch.rand((ds.user_blocks.padded_entities, k),
                       generator=g).to(cuda, dtype)
    for c in sorted({1, nc // 2, nc - 1}):
        sl = slice(c * cap, (c + 1) * cap)
        nb, rt, mk = (blk[f][sl] for f in ("neighbor_idx", "rating", "mask"))
        if weighted:
            wt, rt = ials_reparam(rt, mk, 40.0)
        else:
            wt, rt = mk, rt * mk
        seg = blk["seg_rel"][sl]
        # The carry is a raw Gram, symmetric (the block-pair grid folds
        # its lower blocks and mirrors them).
        x = torch.rand((k, 2 * k), generator=g)
        ca = x @ x.T
        carry = (((ca + ca.T) * 0.5).to(cuda),
                 torch.rand((k,), generator=g).to(cuda),
                 blk["carry_in"][c:c + 1])
        kw = dict(num_segments=e_c + 1, tile_rows=1, carry=carry)
        a, b = gram_gather(table, nb, wt, rt, seg, units=chunk_plan(blk, c),
                           **kw)
        a2, b2 = gram_gather(table, nb, wt, rt, seg,
                             units=chunk_plan(blk, c), **kw)
        assert torch.equal(a, a2) and torch.equal(b, b2)
        pa, pb = gram_gather_plain(table, nb, wt, rt, seg, **kw)
        assert _rel_err(a, pa) < 1e-5 and _rel_err(b, pb) < 1e-5


# -- resilience on the card ---------------------------------------------------

@pytest.mark.parametrize("layout", ["tiled", "bucketed", "segment"])
def test_nan_trip_recovers_bit_equal(cuda, layout):
    """NaN rows injected before iteration 2: the probe trips, the loop
    rolls back to its last-good device copy and replays — the final
    factors ``torch.equal`` to the fault-free run's."""
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.resilience.faults import (
        FactorCorruption,
        FaultInjector,
    )
    from cfk_tpu_torch.telemetry import Metrics

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout=layout, chunk_elems=2048,
                          dense_stream=layout == "tiled")
    cfg = ALSConfig(rank=8, num_iterations=4, layout=layout,
                    health_check_every=1)
    free = train_als(ds, cfg, device=cuda)
    metrics = Metrics()
    inj = FaultInjector(FactorCorruption(iteration=2))
    got = train_als(ds, cfg, device=cuda, metrics=metrics,
                    fault_injector=inj)
    assert inj.fired == 1 and metrics.counters["health_trips"] == 1
    assert metrics.counters["rollbacks"] == 1
    assert got.pipeline["route"] == "stepped"
    assert torch.equal(got.user_factors, free.user_factors)
    assert torch.equal(got.movie_factors, free.movie_factors)


def test_captured_health_trip_replays_bit_equal_to_stepped(cuda):
    """λ = 0 on power-law data is singular on its own: with ``capture=True``
    and only the sentinel armed, the probe folded into the captured
    iteration trips, the run is replayed through the eager resilient loop
    from its initial factors (the graph is not replayed again), and the
    ladder's λ bump ends it finite — bit-equal to the same plan run on the
    eager stepped loop from the start (a fault injector with no faults)."""
    import warnings

    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.resilience.faults import FaultInjector
    from cfk_tpu_torch.telemetry import Metrics

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=2048,
                          dense_stream=True, accum_max_entities=200)
    cfg = ALSConfig(rank=8, num_iterations=4, lam=0.0, layout="tiled",
                    capture=True, health_check_every=1)
    runs = {}
    for name, kw in (("captured", {}),
                     ("stepped", dict(fault_injector=FaultInjector()))):
        metrics = Metrics()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = train_als(ds, cfg, device=cuda, metrics=metrics, **kw)
        runs[name] = model, metrics
    (cap, cap_m), (step, step_m) = runs["captured"], runs["stepped"]
    assert "fused_loop_trip" in cap_m.notes
    assert "fused_loop_trip" not in step_m.notes
    assert cap_m.counters["health_trips"] == step_m.counters["health_trips"]
    assert step_m.counters["health_trips"] >= 1
    assert torch.isfinite(cap.user_factors).all()
    assert torch.equal(cap.user_factors, step.user_factors)
    assert torch.equal(cap.movie_factors, step.movie_factors)


def test_health_probe_in_captured_iteration_matches_off(cuda):
    """A healthy captured run with the probe in its graph: the factors
    bit-equal to the captured run without the sentinel."""
    import dataclasses

    from cfk_tpu_torch import ALSConfig, Dataset, train_als

    coo = synthetic_netflix_coo(600, 150, 9000, seed=4)
    ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=2048,
                          dense_stream=True, accum_max_entities=200)
    base = ALSConfig(rank=8, num_iterations=4, layout="tiled", capture=True)
    off = train_als(ds, base, device=cuda)
    on = train_als(ds, dataclasses.replace(base, health_check_every=1),
                   device=cuda)
    assert on.pipeline["route"] == "captured"
    assert on.pipeline["health"] == "healthy"
    assert torch.equal(on.user_factors, off.user_factors)
    assert torch.equal(on.movie_factors, off.movie_factors)


def test_save_async_snapshot_isolated_from_in_place_updates(cuda, tmp_path):
    """``save_async`` of CUDA tensors that the caller updates in place at
    once (as the captured route writes its factors): the committed step
    holds the values at the call, bit for bit."""
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    g = torch.Generator().manual_seed(0)
    u = torch.rand((50_000, 64), generator=g).to(cuda)
    m = torch.rand((3_000, 64), generator=g).to(cuda)
    want = []
    for it in range(1, 4):
        want.append((u.cpu().numpy(), m.cpu().numpy()))
        mgr.save_async(it, u, m)
        u.mul_(1.5).add_(1.0)  # queued behind the snapshot's copy
        m.zero_()
    mgr.wait_pending()
    for it, (wu, wm) in enumerate(want, start=1):
        st = mgr.restore(it)
        np.testing.assert_array_equal(st.user_factors, wu)
        np.testing.assert_array_equal(st.movie_factors, wm)


# -- streaming fold-in -------------------------------------------------------


def _stream_fixture(layout, parts=2, n=60, new_users=(4242,)):
    """The chaos lab's stream fixture on the card: 60 × 30 × 900 ratings,
    rank 4, a base model trained there, a seeded update log."""
    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.data.blocks import Dataset
    from cfk_tpu_torch.models.als import train_als
    from cfk_tpu_torch.streaming import StreamProducer
    from cfk_tpu_torch.transport import InMemoryBroker

    coo = synthetic_netflix_coo(60, 30, 900, seed=0)
    ds = (Dataset.from_coo(coo) if layout == "padded" else Dataset.from_coo(
        coo, layout="tiled", chunk_elems=256, dense_stream=True))
    cfg = ALSConfig(rank=4, num_iterations=4, health_check_every=1,
                    layout=layout)
    base = train_als(ds, cfg, device="cuda")
    broker = InMemoryBroker()
    prod = StreamProducer(broker, num_partitions=parts)
    rng = np.random.default_rng(11)
    prod.send_many(rng.choice(ds.user_map.raw_ids, n),
                   rng.choice(ds.movie_map.raw_ids, n),
                   rng.integers(1, 6, n).astype(np.float32))
    for raw in new_users:
        prod.send(raw, int(ds.movie_map.raw_ids[0]), 4.0)
    return ds, cfg, base, broker


@pytest.mark.parametrize("layout", ["padded", "tiled"])
def test_fold_in_rows_matches_plain(cuda, layout):
    """The fold-in on the card (K1; K2 + K1 tiled) against the plain
    versions on the CPU, on the same neighbor lists and movie factors."""
    from cfk_tpu_torch.data.blocks import RatingsIndex
    from cfk_tpu_torch.ops.kernels.gram_kernel import gram_gather
    from cfk_tpu_torch.streaming import StreamState, fold_in_rows

    idx = RatingsIndex.from_coo(synthetic_netflix_coo(3000, 400, 60_000,
                                                      seed=2))
    state = StreamState(idx)
    rng = np.random.default_rng(0)
    rows = rng.choice(state.num_users, 200, replace=False)
    nd = [state.neighbors(int(r)) for r in rows]
    m = rng.standard_normal((idx.movie_map.num_entities, 32)).astype(
        np.float32)
    reg_solve.launches = gram_gather.launches = 0
    got = fold_in_rows(torch.as_tensor(m, device="cuda"), nd, lam=0.05,
                       layout=layout)
    assert reg_solve.launches > 0
    assert (gram_gather.launches > 0) == (layout == "tiled")
    want = fold_in_rows(torch.from_numpy(m), nd, lam=0.05, layout=layout)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale


@pytest.mark.parametrize("layout", ["padded", "tiled"])
def test_stream_session_runs_bit_equal_and_crash_replay(cuda, layout,
                                                        tmp_path):
    """Two sessions over the same log end bit-equal; a crash after 3
    batches resumed from its store ends crc-equal to them."""
    import zlib

    from cfk_tpu_torch.streaming import StreamConfig, StreamSession
    from cfk_tpu_torch.transport import CheckpointManager

    ds, cfg, base, broker = _stream_fixture(layout)

    def session(name, **kw):
        return StreamSession(ds, cfg, broker,
                             CheckpointManager(str(tmp_path / name)),
                             stream=StreamConfig(batch_records=8),
                             device="cuda", **kw)

    runs = []
    for name in ("a", "b"):
        s = session(name, base_model=base)
        s.run()
        runs.append(s.user_factors.copy())
    assert np.array_equal(runs[0], runs[1])
    crashed = session("c", base_model=base)
    crashed.run(max_batches=3)
    del crashed
    resumed = session("c")
    assert resumed.stream_step == 3
    resumed.run()
    assert zlib.crc32(resumed.user_factors.tobytes()) == zlib.crc32(
        runs[0].tobytes())


def test_quantized_table_scenario_on_the_card(cuda):
    """The chaos lab's quantized_table scenario on the card: the ladder's
    every rung with a bf16 gather table, the recovered RMSE within the
    reference's bound, the split and "gj" rungs pinned."""
    from cfk_tpu_torch.scripts.chaos_lab import Lab

    row = Lab("cuda", "tiled").quantized_table()
    assert row["ok"], row
    assert row["split_and_gj_pinned"]


def _fleet_on_card(replicas, seed=0, users=300, movies=2000, rank=32):
    from cfk_tpu_torch.data.synthetic import serve_factors, serve_seen_csr
    from cfk_tpu_torch.serving import DeltaPublisher, ServeEngine, ServeFleet
    from cfk_tpu_torch.transport import InMemoryBroker

    rng = np.random.default_rng(seed)
    u, m = serve_factors(users, movies, rank, rng)
    seen, indptr = serve_seen_csr(users, movies, 20 * users,
                                  np.arange(users), rng)

    def engine(uf, mf):
        return ServeEngine(uf, mf, num_users=users, num_movies=movies,
                           seen_movies=seen, seen_indptr=indptr, tile_m=256,
                           device="cuda")

    broker = InMemoryBroker()
    fleet = ServeFleet(lambda i: engine(u, m), broker, replicas=replicas,
                       max_batch=64, prewarm_k=20)
    fleet.seed_store(u, m, num_users=users)
    fleet.prewarm(20, max_batch=64)
    return fleet, DeltaPublisher(broker, fleet.store), broker, engine, (u, m)


def test_fleet_replicas_answer_as_plain_on_the_card(cuda):
    """Two replicas on the card, each on its thread: every K4 launch of
    each replica's thread, recorded inside its engine, agrees with the
    plain version on its arguments (at whatever batch the replica
    coalesced), and the answers agree with one engine's."""
    import threading

    from cfk_tpu_torch.serving import ServeClient
    from cfk_tpu_torch.serving import engine as engine_mod

    fleet, _, broker, engine, (u, m) = _fleet_on_card(2)
    calls, lock = {}, threading.Lock()

    def recording(*a, **kw):
        out = topk_scores(*a, **kw)
        with lock:
            calls.setdefault(threading.current_thread().name, []).append(
                (a, kw))
        return out

    engine_mod.topk_scores = recording
    client = ServeClient(broker, route_by_user=True)
    try:
        fleet.start()
        got = client.ask(list(range(64)), 20, timeout_s=60)
    finally:
        fleet.stop()
        engine_mod.topk_scores = topk_scores
    replica_calls = {n: c for n, c in calls.items()
                     if n.startswith("cfk-replica")}
    assert sorted(replica_calls) == ["cfk-replica-0", "cfk-replica-1"]
    for name, cs in replica_calls.items():
        for a, kw in cs:
            _check_topk(*a, **kw)
    oracle = engine(u, m)
    want_v, want_i = oracle.topk(np.arange(64), 21)
    resp = [got[rid] for rid in sorted(got)]
    res = compare_topk(np.stack([r.scores for r in resp]),
                       np.stack([r.movie_rows for r in resp]),
                       want_v[:, :20], want_i[:, :20], want_v)
    assert res["ok"], res


def test_fleet_rollover_flip_under_load_on_the_card(cuda):
    """A retrain epoch while a client keeps asking: the replica builds and
    prewarms the new engine on its background thread (its table uploaded
    on that thread's stream) and flips; every answer matches the oracle of
    the epoch it is stamped with, and the new epoch serves."""
    from cfk_tpu_torch.serving import ServeClient

    fleet, pub, broker, engine, (u, m) = _fleet_on_card(1, seed=3)
    rng = np.random.default_rng(4)
    u2 = u + rng.standard_normal(u.shape, dtype=np.float32) * 0.05
    m2 = m + rng.standard_normal(m.shape, dtype=np.float32) * 0.05
    oracles = {0: engine(u, m), 1: engine(u2, m2)}
    client = ServeClient(broker, route_by_user=True)
    replica, answered = fleet.replicas[0], []
    fleet.start()
    try:
        for i in range(400):
            if i == 20:
                pub.on_commit({"retrain": True, "user_factors": u2,
                               "movie_factors": m2, "num_users": u.shape[0]})
            users = [(7 * i + j) % u.shape[0] for j in range(8)]
            got = client.ask(users, 20, timeout_s=60)
            answered += [(users[n], got[rid])
                         for n, rid in enumerate(sorted(got))]
            if replica.rollovers and i > 40:
                break
    finally:
        fleet.stop()
    assert replica.rollovers == 1 and replica.engine.epoch == 1
    assert {r.epoch for _, r in answered} == {0, 1}
    for user, resp in answered:
        want_v, want_i = oracles[resp.epoch].topk(np.asarray([user]), 21)
        res = compare_topk(resp.scores[None], resp.movie_rows[None],
                           want_v[:, :20], want_i[:, :20], want_v)
        assert res["ok"], (user, resp.epoch, res)


# -- sharded training and serving: ranks sharing the card ---------------------


@pytest.fixture(scope="module")
def card_mesh():
    """Two ranks on one card (gloo, exchanges staged through pinned host
    memory), spawned once for the module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from cfk_tpu_torch.parallel.mesh import make_mesh

    with make_mesh(2, "cuda", quiet=True) as mesh:
        yield mesh


@pytest.mark.parametrize("layout,exchange,build", [
    ("padded", "all_gather", {}), ("padded", "ring", {}),
    ("tiled", "ring", dict(ring=True, ring_warn=False)),
    ("tiled", "all_gather", dict(dense_stream=True,
                                 accum_max_entities=300)),
    ("tiled", "hier_ring", dict(ring=True, ring_warn=False)),
    ("bucketed", "all_gather", {})])
def test_sharded_on_one_card_equals_one_rank(cuda, card_mesh, layout,
                                             exchange, build):
    """2 ranks on the card (staged) against the one-rank card run from the
    same init: within 1e-4 of max|x| (the rings sum the visits in another
    order), the launches counted per rank."""
    from cfk_tpu_torch import ALSConfig, Dataset, train_als
    from cfk_tpu_torch.parallel.spmd import (
        kernel_launches,
        reset_kernel_launches,
        train_als_sharded,
    )

    coo = synthetic_netflix_coo(1200, 400, 30000, seed=2)
    kw = dict(layout=layout)
    if layout == "tiled":
        kw.update(chunk_elems=4096)
    one_kw = {k: v for k, v in dict(kw, **build).items()
              if k not in ("ring", "ring_warn")}
    one = train_als(Dataset.from_coo(coo, **one_kw),
                    ALSConfig(rank=16, num_iterations=3, layout=layout),
                    device="cuda")
    ds = Dataset.from_coo(coo, num_shards=2, **kw, **build)
    assert card_mesh.staged and card_mesh.backend == "gloo"
    card_mesh.run(reset_kernel_launches)
    sh = train_als_sharded(ds, ALSConfig(rank=16, num_iterations=3,
                                         num_shards=2, layout=layout,
                                         exchange=exchange), card_mesh)
    counts = card_mesh.run(kernel_launches)
    nu, nm = one.num_users, one.num_movies
    for got, want in ((sh.user_factors[:nu], one.user_factors[:nu]),
                      (sh.movie_factors[:nm], one.movie_factors[:nm])):
        want = want.float().cpu()
        assert float((got.float() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    assert all(c["reg_solve"] > 0 or c["gram_solve_gather"] > 0
               or c["gram_solve_dense"] > 0 for c in counts), counts
    assert sh.pipeline["staged_bytes"] > 0


def test_serve_topk_sharded_on_one_card_is_bit_equal(cuda, card_mesh):
    """K4 on each rank's slice at its row offset, merged: ids and scores
    equal to one-rank K4 on the card, bit for bit (exact ties included),
    with the table shipped in the call and placed on the ranks before."""
    from cfk_tpu_torch.parallel.spmd import (
        kernel_launches,
        place_table_sharded,
        reset_kernel_launches,
        serve_topk_sharded,
    )
    from cfk_tpu_torch.serving.topk_kernel import topk_scores

    rng = np.random.default_rng(5)
    nm, tile = 5000, 512
    table = np.zeros((2 * 3 * tile * 2, 64), np.float32)[:6144]
    table[:nm] = rng.integers(-4, 5, (nm, 64))
    u = rng.integers(-3, 4, (32, 64)).astype(np.float32)
    kw = dict(k_top=50, num_movies=nm, tile_m=tile)
    one = topk_scores(torch.tensor(u, device=cuda),
                      torch.tensor(table, device=cuda), None, None, **kw)
    card_mesh.run(reset_kernel_launches)
    got = serve_topk_sharded(card_mesh, torch.tensor(u), torch.tensor(table),
                             None, None, **kw)
    assert all(c["topk_scores"] > 0 for c in card_mesh.run(kernel_launches))
    for a, b in zip(got, one):
        assert torch.equal(a, b.cpu())
    placed = place_table_sharded(card_mesh, torch.tensor(table), None,
                                 tile_m=tile, name="gpu-test")
    got = serve_topk_sharded(card_mesh, torch.tensor(u), placed, None, None,
                             **kw)
    for a, b in zip(got, one):
        assert torch.equal(a, b.cpu())
