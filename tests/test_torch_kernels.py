"""The port's kernel modules (plain PyTorch versions, on the CPU) against the
JAX package's kernel functions, which route to their XLA emulation or
interpret mode off-TPU.

Inputs are real chunks of small tiled datasets (built by the port; the
builders are held bit-identical by tests/test_torch_blocks.py) with tables
from numpy seeds.  Rows of segments owning no tile are compared only where
a segment owns a tile (the TPU kernels leave the others unwritten).
Tolerance rtol 1e-4: float32 on both sides, different summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.ops.pallas.gram_kernel import (
    gram_solve_tiles_dense_gather_pallas,
    gram_tiles_gather_pallas,
)
from cfk_tpu.ops.pallas.solve_kernel import gauss_solve_reg_pallas
from cfk_tpu_torch.data.blocks import build_tiled_blocks, index_entities
from cfk_tpu_torch.data.synthetic import synthetic_netflix_coo
from cfk_tpu_torch.models.als import _tiled_to_device
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gram_gather,
    gram_gather_plain,
    gram_solve_dense,
    gram_solve_dense_plain,
)
from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve, reg_solve_plain
from cfk_tpu_torch.ops.tiled import accum_chunk, dense_chunk

RTOL = 1e-4
K = 8
CPU = torch.device("cpu")


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def sides():
    coo = synthetic_netflix_coo(700, 120, 6000, seed=11)
    mm, m_dense = index_entities(coo.movie_raw)
    um, u_dense = index_entities(coo.user_raw)
    nm, nu = mm.num_entities, um.num_entities
    accum = build_tiled_blocks(m_dense, u_dense, coo.rating, nm, nu,
                               tile_rows=16, chunk_elems=1024, slice_rows=256)
    dense = build_tiled_blocks(u_dense, m_dense, coo.rating, nu, nm,
                               tile_rows=16, chunk_elems=512,
                               accum_max_entities=100, dense_stream=True)
    rng = np.random.default_rng(0)
    u_tab = rng.standard_normal((nu, K)).astype(np.float32)
    m_tab = rng.standard_normal((nm, K)).astype(np.float32)
    return dict(accum=accum, dense=dense, u_tab=u_tab, m_tab=m_tab,
                blk_accum=_tiled_to_device(accum, CPU, nu),
                blk_dense=_tiled_to_device(dense, CPU, nm))


def _spd(e, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, 2 * k, k)).astype(np.float32)
    a = np.einsum("enk,enl->ekl", x, x)
    b = rng.standard_normal((e, k)).astype(np.float32)
    cnt = rng.integers(0, 30, e).astype(np.int32)
    return a, b, cnt


@pytest.mark.parametrize("k", [8, 24])
def test_reg_solve_diag_matches_gauss_solve_reg_pallas(k):
    a, b, cnt = _spd(37, k, k)
    want = gauss_solve_reg_pallas(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(cnt), reg_mode="diag", lam=0.1)
    got = reg_solve(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(cnt), lam=0.1)
    _close(got, want)


def test_reg_solve_matrix_matches_gauss_solve_reg_pallas():
    a, b, _ = _spd(20, K, 1)
    rng = np.random.default_rng(2)
    y = rng.standard_normal((30, K)).astype(np.float32)
    reg = (y.T @ y + 0.5 * np.eye(K)).astype(np.float32)
    want = gauss_solve_reg_pallas(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(reg), reg_mode="matrix")
    got = reg_solve(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(reg), reg_mode="matrix")
    _close(got, want)


@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_gather_matches_gram_tiles_gather_pallas(sides, with_carry):
    blocks, blk = sides["accum"], sides["blk_accum"]
    assert blocks.mode == "accum" and blocks.num_slices > 1
    table = sides["u_tab"]
    rng = np.random.default_rng(4)
    ca = rng.standard_normal((K, K)).astype(np.float32)
    cb = rng.standard_normal(K).astype(np.float32)
    for c in range(blocks.num_chunks):
        args = accum_chunk(blk, blocks.statics, c)
        carry = (torch.as_tensor(ca), torch.as_tensor(cb),
                 torch.tensor(1.0)) if with_carry else None
        a, b = gram_gather(torch.as_tensor(table), **args, carry=carry)
        wa, wb = gram_tiles_gather_pallas(
            jnp.asarray(table), jnp.asarray(args["nb"].numpy()),
            jnp.asarray(args["wt"].numpy()), jnp.asarray(args["rt"].numpy()),
            jnp.asarray(args["seg"].numpy()),
            num_segments=args["num_segments"], tile_rows=args["tile_rows"],
            carry=(jnp.asarray(ca), jnp.asarray(cb), jnp.float32(1.0))
            if with_carry else None,
        )
        owned = np.unique(args["seg"].numpy())
        _close(a.numpy()[owned], np.asarray(wa)[owned])
        _close(b.numpy()[owned], np.asarray(wb)[owned])


@pytest.mark.parametrize("weighted", [False, True])
def test_gram_solve_dense_matches_dense_gather_pallas(sides, weighted):
    """Unit weights with the ALS-WR diag ridge (the main path), and a
    per-entry weight stream with a shared [k,k] ridge (the iALS form)."""
    blocks, blk = sides["dense"], sides["blk_dense"]
    assert blocks.mode == "dstream" and blocks.num_chunks > 3
    assert blocks.carry_in.sum() > 0  # some entity straddles a boundary
    table = sides["m_tab"]
    st = blocks.statics
    nt, ng = st[4], st[5]
    rng = np.random.default_rng(6)
    wt_all = rng.random(blk["neighbor_idx"].shape[0]).astype(np.float32)
    y = rng.standard_normal((40, K)).astype(np.float32)
    ridge = (y.T @ y + 0.5 * np.eye(K)).astype(np.float32)
    a0, b0 = np.zeros((K, K), np.float32), np.zeros(K, np.float32)
    for c in range(blocks.num_chunks):
        args = dense_chunk(blk, st, c)
        cin = args.pop("cin")
        reg_mode = "diag"
        if weighted:
            cap = st[1]
            args["wt"] = torch.as_tensor(wt_all[c * cap:(c + 1) * cap])
            args["reg"] = torch.as_tensor(ridge)
            reg_mode = "matrix"
        x, ca, cb = gram_solve_dense(
            torch.as_tensor(table), **args, lam=0.05, reg_mode=reg_mode,
            carry=(torch.as_tensor(a0), torch.as_tensor(b0), cin))
        wx, wca, wcb = gram_solve_tiles_dense_gather_pallas(
            jnp.asarray(table), jnp.asarray(args["nb"].numpy()),
            None if args["wt"] is None else jnp.asarray(args["wt"].numpy()),
            jnp.asarray(args["rt"].numpy()),
            jnp.asarray(args["meta"].numpy()),
            jnp.asarray(args["reg"].numpy()),
            jnp.int32(int(args["lseg"][0])),
            num_segments=args["num_segments"], tile_rows=args["tile_rows"],
            num_tiles=nt, num_groups=ng, block_rows=args["block_rows"],
            reg_mode=reg_mode, lam=0.05,
            carry=(jnp.asarray(a0), jnp.asarray(b0),
                   jnp.float32(float(cin[0]))),
        )
        meta = args["meta"].numpy()
        live = meta[ng + 2 * nt:ng + 3 * nt] > meta[ng + nt:ng + 2 * nt]
        owned = np.unique(meta[ng + 3 * nt:][live])
        _close(x.numpy()[owned], np.asarray(wx)[owned])
        _close(ca, wca)
        _close(cb, wcb)
        a0, b0 = np.array(wca), np.array(wcb)


def test_cpu_tensors_take_the_plain_versions(sides):
    """On CPU tensors each wrapper returns exactly its plain version and
    launches nothing."""
    counters = (reg_solve, gram_gather, gram_solve_dense)
    before = [f.launches for f in counters]
    a, b, cnt = (torch.as_tensor(x) for x in _spd(9, K, 3))
    assert torch.equal(reg_solve(a, b, cnt, lam=0.2),
                       reg_solve_plain(a, b, cnt, lam=0.2))
    table = torch.as_tensor(sides["u_tab"])
    args = accum_chunk(sides["blk_accum"], sides["accum"].statics, 0)
    for got, want in zip(gram_gather(table, **args),
                         gram_gather_plain(table, **args)):
        assert torch.equal(got, want)
    table = torch.as_tensor(sides["m_tab"])
    args = dense_chunk(sides["blk_dense"], sides["dense"].statics, 1)
    args.pop("cin")
    for got, want in zip(gram_solve_dense(table, **args, lam=0.05),
                         gram_solve_dense_plain(table, **args, lam=0.05)):
        assert torch.equal(got, want)
    assert [f.launches for f in counters] == before


def test_wrappers_refuse_bad_operands(sides):
    a, b, cnt = (torch.as_tensor(x) for x in _spd(4, K, 5))
    with pytest.raises(ValueError, match="diag reg shape"):
        reg_solve(a, b, cnt[:3], lam=0.1)
    with pytest.raises(ValueError, match="unknown reg_mode"):
        reg_solve(a, b, cnt, reg_mode="band")
    table = torch.as_tensor(sides["u_tab"])
    args = accum_chunk(sides["blk_accum"], sides["accum"].statics, 0)
    args["seg"] = args["seg"][:-1]
    with pytest.raises(ValueError, match="seg shape"):
        gram_gather(table, **args)
