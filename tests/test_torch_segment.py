"""The segment layout of the port (cfk_tpu_torch) against cfk_tpu, on the CPU.

The blocks are held bit-identical to the JAX package's
``build_segment_blocks`` at the same explicit ``chunk_nnz``, straddling
entities included; the explicit and implicit half-steps to the JAX
package's on both of its Gram backends (``"ragged"``, the grouped matmul,
and ``"segsum"``, the segment sum the port computes); ``train_als`` /
``train_ials`` with ``layout="segment"`` to the JAX package's trainers over
2 iterations from the same injected u0 (``jax.random`` cannot be
reproduced in torch).  Tolerances, relative to the largest |value|: 1e-4
for a half-step (float32 Gram sums in another order, then a float32 solve),
1e-3 for predictions after 2 iterations (the differences compound through
four chained solves) — the tolerances of ``tests/test_torch_als.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import build_segment_blocks as j_build_segment
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _segment_device_setup as j_segment_setup
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.solve import als_half_step_segment as j_als_segment
from cfk_tpu.ops.solve import ials_half_step_segment as j_ials_segment
from cfk_tpu_torch import ALSConfig, Dataset, factors_from_numpy, train_als
from cfk_tpu_torch.cli import main
from cfk_tpu_torch.data.blocks import build_segment_blocks
from cfk_tpu_torch.models.als import _segment_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops import solve as t_solve

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.05, 2.0
NU, NM = 400, 150
T = torch.as_tensor


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_blocks_equal(jb, tb):
    for f in dataclasses.fields(jb):
        a, b = getattr(jb, f.name), getattr(tb, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(NU, NM, 6000, seed=9)


@pytest.fixture(scope="module")
def dense(coo):
    d = JDataset.from_coo(coo).coo_dense
    assert (d.movie_raw.max() + 1, d.user_raw.max() + 1) == (NM, NU)
    return d


@pytest.fixture(scope="module")
def u0():
    return np.random.default_rng(1).random((NU, K)).astype(np.float32)


@pytest.mark.parametrize("chunk_nnz", [64, 200, 1000])
@pytest.mark.parametrize("side", ["movie", "user"])
def test_segment_blocks_identical(dense, side, chunk_nnz):
    d = dense
    args = ((d.movie_raw, d.user_raw, d.rating, NM) if side == "movie"
            else (d.user_raw, d.movie_raw, d.rating, NU))
    jb = j_build_segment(*args, chunk_nnz=chunk_nnz)
    tb = build_segment_blocks(*args, chunk_nnz=chunk_nnz)
    _assert_blocks_equal(jb, tb)
    if side == "movie" and chunk_nnz <= 200:
        # Movies hotter than one chunk straddle chunk boundaries.
        assert tb.carry_in.sum() > 0 and (tb.last_seg == 0).any()


DEGENERATE = {
    "no ratings": (np.zeros(0, np.int64), 0, 64),
    "one entity over many chunks": (np.zeros(500, np.int64), 1, 64),
    "one entity, one chunk": (np.zeros(500, np.int64), 1, None),
    "entity cap cuts first": (np.arange(1000) % 300, 300, 64),
}


@pytest.mark.parametrize("case", list(DEGENERATE))
def test_segment_blocks_degenerate_identical(case):
    keys, e, chunk_nnz = DEGENERATE[case]
    keys = np.sort(keys).astype(np.int64)
    fixed = np.arange(keys.shape[0], dtype=np.int64) % 11
    rating = (1.0 + np.arange(keys.shape[0]) % 5).astype(np.float32)
    args = (keys, fixed, rating, e)
    _assert_blocks_equal(j_build_segment(*args, chunk_nnz=chunk_nnz),
                         build_segment_blocks(*args, chunk_nnz=chunk_nnz))


def test_dataset_from_coo_segment_sizes_chunks_for_segsum(coo, dense):
    """``Dataset.from_coo(layout="segment")`` builds by the JAX package's
    segsum rule: ``max(64, chunk_elems // 64)`` ratings a chunk."""
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=64 * 300)
    d = dense
    for tb, args in ((td.movie_blocks, (d.movie_raw, d.user_raw, d.rating,
                                        NM)),
                     (td.user_blocks, (d.user_raw, d.movie_raw, d.rating,
                                       NU))):
        _assert_blocks_equal(j_build_segment(*args, chunk_nnz=300), tb)
    small = Dataset.from_coo(coo, layout="segment", chunk_elems=1000)
    assert small.movie_blocks.chunk_cap == 64


@pytest.fixture(scope="module")
def movie_half(coo):
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=64 * 200)
    mb = td.movie_blocks
    assert mb.carry_in.sum() > 0
    fixed = np.random.default_rng(0).standard_normal((NU, K)).astype(
        np.float32)
    return mb, fixed


@pytest.mark.parametrize("backend", ["ragged", "segsum"])
@pytest.mark.parametrize("model", ["als", "ials"])
def test_segment_half_step_matches(movie_half, model, backend):
    """Both models on both JAX Gram backends; two rows past the last entity
    (rows no chunk finalizes) stay exactly 0 on both sides."""
    mb, fixed = movie_half
    rows = mb.padded_entities + 2
    if model == "ials":
        fixed = np.abs(fixed)
    j_args = (jnp.asarray(fixed), jnp.asarray(mb.neighbor_idx),
              jnp.asarray(mb.rating), jnp.asarray(mb.mask),
              jnp.asarray(mb.seg_rel), jnp.asarray(mb.chunk_entity))
    j_tail = (jnp.asarray(mb.group_sizes), jnp.asarray(mb.carry_in),
              jnp.asarray(mb.last_seg), rows)
    blk = _segment_to_device(mb, CPU)
    if model == "als":
        want = j_als_segment(*j_args, jnp.asarray(mb.chunk_count), *j_tail,
                             LAM, statics=mb.statics, gram_backend=backend)
        got = t_solve.als_half_step_segment(T(fixed), blk, mb.statics, rows,
                                            LAM)
    else:
        want = j_ials_segment(*j_args, *j_tail, LAM, ALPHA,
                              statics=mb.statics, gram_backend=backend)
        got = t_solve.ials_half_step_segment(T(fixed), blk, mb.statics, rows,
                                             LAM, ALPHA)
    assert _rel(got, want) <= 1e-4
    assert torch.all(got[mb.padded_entities:] == 0)
    assert np.all(np.asarray(want)[mb.padded_entities:] == 0)


@pytest.mark.parametrize("model", ["als", "ials"])
def test_train_segment_matches_reference(coo, u0, model):
    """Two iterations from the same u0: the JAX package's trainer (explicit)
    or its iteration body (implicit, which has no warm start) against the
    port's ``train_als`` / ``train_ials``, on the same blocks."""
    chunk = 200
    jd = JDataset.from_coo(coo, layout="segment", chunk_elems=chunk)
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=64 * chunk)
    _assert_blocks_equal(jd.movie_blocks, td.movie_blocks)
    m0 = np.zeros((NM, K), np.float32)
    if model == "als":
        ref = j_train_als(jd, JConfig(rank=K, num_iterations=2,
                                      layout="segment"), warm_start=(u0, m0))
        want = ref.predict_dense()
        got = train_als(td, ALSConfig(rank=K, num_iterations=2,
                                      layout="segment"), device="cpu",
                        warm_start=(u0, m0))
    else:
        mblk, ublk, _, layout_kw = j_segment_setup(jd)
        u, m = jnp.asarray(u0), jnp.asarray(m0)
        for _ in range(2):
            u, m = j_one_iteration(u, m, mblk, ublk, lam=LAM, alpha=ALPHA,
                                   dtype="float32", **layout_kw)
        want = factors_from_numpy(np.asarray(u), np.asarray(m),
                                  device="cpu").predict_dense()
        got = train_ials(td, IALSConfig(rank=K, lam=LAM, alpha=ALPHA,
                                        num_iterations=2, layout="segment"),
                         device="cpu", warm_start=(u0, m0))
    assert _rel(got.predict_dense(), want) <= 1e-3


@pytest.mark.parametrize("what", ["half", "train"])
def test_bf16_ials_segment_matches_reference(coo, u0, movie_half, what):
    """iALS with a bf16 table on the segment layout keeps the JAX package's
    rounding order — (c−1)·f rounded to bf16, the solve on the symmetric
    part of A — at the half-step's 1e-4 and the 2-iteration 1e-3.  The
    reference runs op by op (``jax.disable_jit``): compiled with
    ``jax.jit``, XLA's excess precision keeps those bf16 products in
    float32, which is not the program as written."""
    import jax

    if what == "half":
        mb, fixed = movie_half
        fixed = np.abs(fixed)
        rows = mb.padded_entities + 2
        with jax.disable_jit():
            want = j_ials_segment(
                jnp.asarray(fixed).astype(jnp.bfloat16),
                *(jnp.asarray(getattr(mb, f)) for f in (
                    "neighbor_idx", "rating", "mask", "seg_rel",
                    "chunk_entity", "group_sizes", "carry_in", "last_seg")),
                rows, LAM, ALPHA, statics=mb.statics)
        got = t_solve.ials_half_step_segment(
            T(fixed).bfloat16(), _segment_to_device(mb, CPU), mb.statics,
            rows, LAM, ALPHA)
        assert _rel(got, want) <= 1e-4
        assert torch.all(got[mb.padded_entities:] == 0)
        return
    chunk = 200
    jd = JDataset.from_coo(coo, layout="segment", chunk_elems=chunk)
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=64 * chunk)
    m0 = np.zeros((NM, K), np.float32)
    mblk, ublk, _, layout_kw = j_segment_setup(jd)
    u, m = jnp.asarray(u0), jnp.asarray(m0)
    with jax.disable_jit():
        for _ in range(2):
            u, m = j_one_iteration(u, m, mblk, ublk, lam=LAM, alpha=ALPHA,
                                   dtype="float32", table_dtype="bfloat16",
                                   **layout_kw)
    want = factors_from_numpy(np.asarray(u), np.asarray(m),
                              device="cpu").predict_dense()
    got = train_ials(td, IALSConfig(rank=K, lam=LAM, alpha=ALPHA,
                                    num_iterations=2, layout="segment",
                                    table_dtype="bfloat16"),
                     device="cpu", warm_start=(u0, m0))
    assert _rel(got.predict_dense(), want) <= 1e-3


def test_rank_above_cap_takes_cholesky_with_the_raw_carry(coo, monkeypatch):
    """k = 136: every chunk's rows go to ``batched_spd_solve`` (the ridge
    added into the Gram batch in place), never K1; the straddling entity's
    carry is taken from the raw sums before that add, so the half-step
    equals one solve of the whole side's normal equations."""
    k = 136
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=64 * 200)
    mb = td.movie_blocks
    assert mb.carry_in.sum() > 0
    fixed = np.random.default_rng(4).standard_normal((NU, k)).astype(
        np.float32)
    calls = {"batched_spd_solve": 0, "reg_solve": 0, "reg_solve_plain": 0}
    for name in calls:
        fn = getattr(t_solve, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(t_solve, name, spy)
    got = t_solve.als_half_step_segment(T(fixed), _segment_to_device(mb, CPU),
                                        mb.statics, mb.padded_entities, LAM)
    assert calls == {"batched_spd_solve": mb.num_chunks, "reg_solve": 0,
                     "reg_solve_plain": 0}
    # The whole side at once, in float64: A = Σ f fᵀ + λ·n·I per movie.
    d = td.coo_dense
    f = fixed[d.user_raw].astype(np.float64)
    a = np.zeros((NM, k, k))
    np.add.at(a, d.movie_raw, f[:, :, None] * f[:, None, :])
    b = np.zeros((NM, k))
    np.add.at(b, d.movie_raw, d.rating[:, None] * f)
    a += LAM * np.maximum(mb.count, 1)[:, None, None] * np.eye(k)
    want = np.linalg.solve(a, b[:, :, None])[:, :, 0]
    assert _rel(got, want) <= 1e-4


def test_segment_config_and_algorithms(coo):
    """``layout="segment"`` is accepted; the subspace optimizers refuse it
    with the JAX package's message, and so does the trainer."""
    assert ALSConfig(layout="segment").layout == "segment"
    with pytest.raises(ValueError, match="cross-chunk score updates"):
        ALSConfig(layout="segment", algorithm="als++", rank=8, block_size=4)
    with pytest.raises(ValueError, match="cross-chunk score updates"):
        JConfig(layout="segment", algorithm="als++", rank=8, block_size=4)
    td = Dataset.from_coo(coo, layout="segment", chunk_elems=1 << 14)
    with pytest.raises(ValueError, match="built with the segment layout"):
        train_als(td, ALSConfig(rank=8, num_iterations=1, algorithm="als++",
                                block_size=4, layout="auto"), device="cpu")


def test_cli_segment_with_dataset_cache(coo, tmp_path, capsys):
    """``train --layout segment --dataset-cache``: the second run hits the
    cache (the JAX package's hit line) and returns bit-equal factors."""
    data = tmp_path / "ratings.txt"
    with open(data, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    cache = tmp_path / "cache"
    argv = ["train", "--data", str(data), "--layout", "segment", "--rank",
            "4", "--iterations", "2", "--chunk-elems", str(64 * 300),
            "--device", "cpu", "--output", "none", "--dataset-cache",
            str(cache)]
    runs = []
    for i in range(2):
        assert main(argv + ["--checkpoint-dir", str(tmp_path / f"c{i}")]) == 0
        cap = capsys.readouterr()
        assert "layout=segment" in cap.out
        assert ("# dataset cache hit" in cap.err) == (i == 1)
        runs.append(cap.out)
    mse = [r.split("mse=")[1].split()[0] for r in runs]
    assert mse[0] == mse[1]
    from cfk_tpu_torch.transport.checkpoint import CheckpointManager

    a, b = (CheckpointManager(str(tmp_path / f"c{i}")).restore()
            for i in range(2))
    np.testing.assert_array_equal(a.user_factors, b.user_factors)
    np.testing.assert_array_equal(a.movie_factors, b.movie_factors)
