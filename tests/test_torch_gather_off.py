"""The materialized-stream schedule of the port (``in_kernel_gather=False``)
against the JAX package's, on the CPU.

The four stream Gram wrappers (``gram_tiles``, ``gram_tiles_dense``,
``gram_solve_tiles``, ``gram_solve_tiles_dense``) run their plain PyTorch
versions here and are held to the JAX package's Pallas entry points, which
run their XLA emulation twins off the TPU (``_emulate_gram_tiles``,
``_emulate_gram_dense`` and ``compat.emulate_fused_gram_solve``).  The
tiled half-steps (accum, stream, dense stream; fused and split; explicit
and iALS) and the trainers (tiled and bucketed) are held to the JAX
package's ``in_kernel_gather=False`` route from the same inputs, made from
numpy seeds.  The JAX package's own two gather routes are never the oracle
here.  On the port's side the knob must not change a bit on the CPU: each
gather plain version is ``gather_rows_plain`` followed by its stream twin.
The kernels themselves run in ``test_torch_gpu.py`` on the card.

Tolerances, relative to the largest |value|: 1e-5 for Gram sums and one
chunk's solve (float32 sums of the same rows in another order), 1e-4 for a
half-step at rank 8 and 1e-3 at rank 16 (the rank-deficient Grams of movies
with fewer ratings than k are held up by the λ·n ridge alone, and their
condition numbers scale the summation-order differences; the tolerances of
``test_torch_split.py``), 1e-3 for predictions after 3 iterations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import build_tiled_blocks as j_build
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _bucketed_device_setup as j_bucketed_setup
from cfk_tpu.models.als import _tiled_device_setup as j_tiled_setup
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.pallas.gram_kernel import (
    gram_solve_tiles_dense_pallas,
    gram_solve_tiles_pallas,
    gram_tiles_dense_pallas,
    gram_tiles_pallas,
)
from cfk_tpu.ops.tiled import ials_tiled_half_step as j_ials_tiled
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, Dataset, factors_from_numpy, train_als
from cfk_tpu_torch.cli import main
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.models.als import _tiled_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops.kernels.gram_kernel import (
    gather_rows,
    gram_gather,
    gram_solve_dense,
    gram_solve_gather,
    gram_solve_tiles,
    gram_solve_tiles_dense,
    gram_tiles,
    gram_tiles_dense,
    gram_tiles_dense_gather,
)
from cfk_tpu_torch.ops.tiled import (
    dense_chunk,
    ials_tiled_half_step,
    resolve_gather_mode,
    tiled_half_step,
)

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.05, 2.0
T = torch.as_tensor


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax(args: dict) -> dict:
    return {key: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor)
                  else v) for key, v in args.items()}


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = JDataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


def test_resolve_gather_mode():
    assert resolve_gather_mode(None) == resolve_gather_mode(True) == "fused"
    assert resolve_gather_mode(False) == "xla"


# -- the four stream Gram kernels' plain versions (rows 4-7) -----------------

def _tile_chunk(seed, weighted):
    """One chunk of 96 tiles of 16 rows over 40 segments (five own no
    tile), the zero row among the entries; zero weights among the weighted
    ones, unit weights (a bit-exact multiply) otherwise."""
    rng = np.random.default_rng(seed)
    f, t, nt, s = 300, 16, 96, 40
    c = nt * t
    table = rng.standard_normal((f, K), dtype=np.float32)
    nb = rng.integers(0, f, c).astype(np.int32)
    nb[rng.random(c) < 0.2] = f
    wt = np.ones(c, np.float32)
    if weighted:
        wt = rng.random(c, dtype=np.float32)
        wt[rng.random(c) < 0.1] = 0.0
    live = np.sort(rng.choice(s, s - 5, replace=False))
    seg = np.sort(np.concatenate([live, rng.choice(live, nt - live.size)]))
    return dict(table=T(table), nb=T(nb), wt=T(wt),
                rt=T(rng.standard_normal(c, dtype=np.float32)),
                seg=T(seg.astype(np.int32)), num_segments=s, tile_rows=t)


def _carry(seed, with_carry):
    if not with_carry:
        return None
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2 * K, K)).astype(np.float32)
    return (T(z.T @ z), T(rng.standard_normal(K).astype(np.float32)),
            T(np.float32(1.0)))


def _ridge(reg_mode, s, seed):
    rng = np.random.default_rng(seed)
    if reg_mode == "diag":
        return T(rng.integers(0, 40, s).astype(np.float32))
    y = rng.standard_normal((300, K)).astype(np.float32)
    return T(y.T @ y + 0.1 * np.eye(K, dtype=np.float32))


def _jcarry(carry):
    return None if carry is None else tuple(jnp.asarray(x.numpy())
                                            for x in carry)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_tiles_matches_reference(weighted, with_carry):
    ch = _tile_chunk(3, weighted)
    table, nb, wt = ch.pop("table"), ch.pop("nb"), ch.pop("wt")
    g = gather_rows(table, nb, wt if weighted else None)
    carry = _carry(4, with_carry)
    want = gram_tiles_pallas(jnp.asarray(g.numpy()), **_jax(ch),
                             interpret=True, carry=_jcarry(carry))
    got = gram_tiles(g, **ch, carry=carry)
    # The TPU kernel leaves the rows of segments owning no tile unwritten
    # (its interpret run here: NaN); the port writes zeros there.
    owned = torch.unique(ch["seg"].long())
    for x, w in zip(got, want):
        assert _rel(x[owned], np.asarray(w)[owned.numpy()]) < 1e-5
    empty = np.setdiff1d(np.arange(40), owned.numpy())
    if carry is not None:  # segment 0 holds the carry either way
        empty = empty[empty != 0]
    assert not got[0][T(empty)].any() and not got[1][T(empty)].any()
    # The gather route is the gather followed by this, bit for bit.
    gathered = gram_gather(table, nb, wt, **ch, carry=carry)
    assert all(torch.equal(x, y) for x, y in zip(got, gathered))


@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_solve_tiles_matches_reference(reg_mode, with_carry):
    ch = _tile_chunk(5, True)
    table, nb, wt = ch.pop("table"), ch.pop("nb"), ch.pop("wt")
    g = gather_rows(table, nb, wt)
    reg = _ridge(reg_mode, ch["num_segments"], 6)
    carry = _carry(7, with_carry)
    lseg = int(ch["seg"][-1])
    kw = dict(reg_mode=reg_mode, lam=LAM)
    want = gram_solve_tiles_pallas(
        jnp.asarray(g.numpy()), **_jax(ch), reg=jnp.asarray(reg.numpy()),
        lseg=jnp.int32(lseg), interpret=True, carry=_jcarry(carry), **kw)
    got = gram_solve_tiles(g, **ch, reg=reg, lseg=lseg, carry=carry, **kw)
    for x, w in zip(got, want):
        assert _rel(x, w) < 1e-5
    gathered = gram_solve_gather(table, nb, wt, **ch, reg=reg, lseg=lseg,
                                 carry=carry, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, gathered))


@pytest.fixture(scope="module")
def dense_side(coo):
    d = JDataset.from_coo(coo).coo_dense
    blocks = build_tiled_blocks(d.user_raw, d.movie_raw, d.rating, 400, 150,
                                tile_rows=16, chunk_elems=512,
                                accum_max_entities=100, dense_stream=True)
    assert blocks.mode == "dstream"
    table = np.random.default_rng(2).standard_normal((150, K)).astype(
        np.float32)
    return blocks, _tiled_to_device(blocks, CPU, 150), T(table)


def _dense_args(dense_side, weighted):
    blocks, blk, table = dense_side
    st = blocks.statics
    args = dense_chunk(blk, st, st[0] // 2)
    if weighted:  # an iALS-like √aw stream
        rng = np.random.default_rng(6)
        args["wt"] = T(np.sqrt(rng.random(st[1], dtype=np.float32) + 0.1))
    nb, wt = args.pop("nb"), args.pop("wt")
    for key in ("reg", "lseg", "cin"):
        args.pop(key)
    return table, nb, wt, args


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_tiles_dense_matches_reference(dense_side, weighted,
                                            with_carry):
    table, nb, wt, args = _dense_args(dense_side, weighted)
    g = gather_rows(table, nb, wt)
    carry = _carry(8, with_carry)
    want = gram_tiles_dense_pallas(jnp.asarray(g.numpy()), **_jax(args),
                                   interpret=True, carry=_jcarry(carry))
    got = gram_tiles_dense(g, **args, carry=carry)
    for x, w in zip(got, want):
        assert _rel(x, w) < 1e-5
    gathered = gram_tiles_dense_gather(table, nb, wt, **args, carry=carry)
    assert all(torch.equal(x, y) for x, y in zip(got, gathered))


@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
@pytest.mark.parametrize("with_carry", [False, True])
def test_gram_solve_tiles_dense_matches_reference(dense_side, reg_mode,
                                                  with_carry):
    table, nb, wt, args = _dense_args(dense_side, reg_mode == "matrix")
    g = gather_rows(table, nb, wt)
    reg = _ridge(reg_mode, args["num_segments"], 9)
    carry = _carry(10, with_carry)
    lseg = args["num_segments"] - 2
    kw = dict(reg_mode=reg_mode, lam=LAM)
    want = gram_solve_tiles_dense_pallas(
        jnp.asarray(g.numpy()), **_jax(args), reg=jnp.asarray(reg.numpy()),
        lseg=jnp.int32(lseg), interpret=True, carry=_jcarry(carry), **kw)
    got = gram_solve_tiles_dense(g, **args, reg=reg, lseg=lseg, carry=carry,
                                 **kw)
    for x, w in zip(got, want):
        assert _rel(x, w) < 1e-5
    gathered = gram_solve_dense(table, nb, wt, **args, reg=reg, lseg=lseg,
                                carry=carry, **kw)
    assert all(torch.equal(x, y) for x, y in zip(got, gathered))


# -- half-steps, against the JAX package's in_kernel_gather=False route ------

def _tiled_args(coo, mode):
    d = JDataset.from_coo(coo).coo_dense
    if mode == "accum":
        return ((d.movie_raw, d.user_raw, d.rating, 150, 400),
                dict(tile_rows=16, chunk_elems=512, slice_rows=128))
    return ((d.user_raw, d.movie_raw, d.rating, 400, 150),
            dict(tile_rows=16, chunk_elems=512, accum_max_entities=100,
                 dense_stream=mode == "dstream"))


def _fixed(mode, k):
    n = 400 if mode == "accum" else 150
    return np.random.default_rng(k).random((n, k)).astype(np.float32)


_JAX_HALVES = {}


def _jax_half(coo, mode, k, implicit):
    """The JAX package's materialized-stream half-step on its default
    (fused where legal) schedule, computed once per case: the reference
    for both of the port's schedules, whose only difference is where the
    same sums are solved (the split and fused JAX routes agree to ~1e-6,
    ``test_torch_split.py``)."""
    key = (mode, k, implicit)
    if key not in _JAX_HALVES:
        args, kw = _tiled_args(coo, mode)
        jb = j_build(*args, **kw)
        chunks = ("tiled", jb.mode) + jb.statics
        fixed = jnp.asarray(_fixed(mode, k))
        jkw = dict(solver="pallas", in_kernel_gather=False)
        if implicit:
            out = j_ials_tiled(fixed, j_tiled_to_device(jb, True), chunks,
                               jb.padded_entities, LAM, ALPHA, **jkw)
        else:
            out = j_tiled_half_step(fixed, j_tiled_to_device(jb), chunks,
                                    jb.padded_entities, LAM, **jkw)
        _JAX_HALVES[key] = np.asarray(out)
    return _JAX_HALVES[key]


@pytest.mark.parametrize("mode,k", [("accum", 16), ("stream", K),
                                    ("dstream", K)])
@pytest.mark.parametrize("fused", [None, False])
@pytest.mark.parametrize("implicit", [False, True])
def test_tiled_half_step_gather_off_matches_reference(coo, mode, k, fused,
                                                      implicit):
    want = _jax_half(coo, mode, k, implicit)
    args, kw = _tiled_args(coo, mode)
    tb = build_tiled_blocks(*args, **kw)
    assert tb.mode == mode
    chunks = ("tiled", tb.mode) + tb.statics
    blk = _tiled_to_device(tb, CPU, args[4], weighted=implicit)
    fixed = T(_fixed(mode, k))
    got = {}
    for knob in (False, None):
        if implicit:
            got[knob] = ials_tiled_half_step(
                fixed, blk, chunks, tb.padded_entities, LAM, ALPHA,
                fused_epilogue=fused, in_kernel_gather=knob)
        else:
            got[knob] = tiled_half_step(fixed, blk, chunks,
                                        tb.padded_entities, LAM,
                                        fused_epilogue=fused,
                                        in_kernel_gather=knob)
    assert _rel(got[False], want) < (1e-4 if k == K else 1e-3)
    assert torch.equal(got[False], got[None])


# -- trainers, knob off, against the JAX package's ---------------------------

DENSE = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
             tile_rows=16, dense_stream=True)
BUCKETED = dict(layout="bucketed", chunk_elems=256)


@pytest.mark.parametrize("data", [DENSE, BUCKETED], ids=["tiled", "bucketed"])
def test_train_als_gather_off_matches_reference(coo, u0, data):
    jd, td = JDataset.from_coo(coo, **data), Dataset.from_coo(coo, **data)
    layout = data["layout"]
    init = (u0, np.zeros((150, K), np.float32))
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=3, layout=layout,
                                  solver="pallas", in_kernel_gather=False),
                      warm_start=init)
    models = {knob: train_als(td, ALSConfig(rank=K, num_iterations=3,
                                            layout=layout,
                                            in_kernel_gather=knob),
                              device="cpu", warm_start=init)
              for knob in (False, True)}
    assert _rel(models[False].predict_dense(), ref.predict_dense()) < 1e-3
    assert torch.equal(models[False].user_factors, models[True].user_factors)
    assert torch.equal(models[False].movie_factors,
                       models[True].movie_factors)


@pytest.mark.parametrize("data", [DENSE, BUCKETED], ids=["tiled", "bucketed"])
def test_train_ials_gather_off_matches_reference(coo, u0, data):
    jd, td = JDataset.from_coo(coo, **data), Dataset.from_coo(coo, **data)
    layout = data["layout"]
    if layout == "tiled":
        mb, ub, _, kw = j_tiled_setup(jd, weighted=True)
    else:
        mb, ub, _, kw = j_bucketed_setup(jd)
    u = jnp.zeros((jd.user_blocks.padded_entities, K),
                  jnp.float32).at[:u0.shape[0]].set(u0)
    m = jnp.zeros((jd.movie_blocks.padded_entities, K), jnp.float32)
    for _ in range(3):
        u, m = j_one_iteration(u, m, mb, ub, lam=LAM, alpha=ALPHA,
                               dtype="float32", solver="pallas",
                               in_kernel_gather=False, **kw)
    ref = factors_from_numpy(np.asarray(u), np.asarray(m),
                             num_users=jd.user_map.num_entities,
                             num_movies=150, device="cpu")
    models = {knob: train_ials(td, IALSConfig(rank=K, lam=LAM, alpha=ALPHA,
                                              num_iterations=3,
                                              layout=layout,
                                              in_kernel_gather=knob),
                               device="cpu",
                               warm_start=(u0, np.zeros((150, K),
                                                        np.float32)))
              for knob in (False, None)}
    assert _rel(models[False].predict_dense(), ref.predict_dense()) < 1e-3
    assert torch.equal(models[False].user_factors, models[None].user_factors)
    assert torch.equal(models[False].movie_factors,
                       models[None].movie_factors)


@pytest.mark.parametrize("bad", ["off", 2])
def test_in_kernel_gather_validation_matches_reference(bad):
    with pytest.raises(ValueError) as want:
        JConfig(in_kernel_gather=bad)
    with pytest.raises(ValueError) as got:
        ALSConfig(in_kernel_gather=bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="in_kernel_gather must be"):
        IALSConfig(in_kernel_gather=bad)


@pytest.mark.parametrize("layout", ["tiled", "bucketed"])
def test_cli_train_gather_off(coo, tmp_path, capsys, layout):
    path = tmp_path / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    mse = {}
    for knob in ("on", "off"):
        assert main(["train", "--data", str(path), "--rank", "4",
                     "--iterations", "2", "--layout", layout,
                     "--chunk-elems", "512", "--in-kernel-gather", knob,
                     "--device", "cpu", "--output", "none"]) == 0
        out = capsys.readouterr().out
        mse[knob] = dict(kv.split("=", 1) for kv in out.split()
                         if "=" in kv)["mse"]
    assert mse["off"] == mse["on"]
