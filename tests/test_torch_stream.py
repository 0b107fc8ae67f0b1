"""The padded tiled stream mode of the port (``dense_stream=False``) against
the JAX package, on the CPU.

The blocks must be bit-identical to ``cfk_tpu.data.blocks.
build_tiled_blocks(..., dense_stream=False)``'s; the stream half-steps (fused:
K6 per chunk; split: K2 then K1, through their plain versions here) and the
trainers on a stream-mode dataset are held to the JAX package's split
route from the same inputs, made from numpy seeds.  Also pinned here: the
``dense_stream`` default of ``build_tiled_blocks`` and ``Dataset.from_coo``
and the CLI's choice, against the JAX package's.
"""

import inspect

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import cfk_tpu.cli as jcli
from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data import blocks as jblocks
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _tiled_device_setup as j_tiled_setup
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.tiled import ials_tiled_half_step as j_ials_tiled
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, factors_from_numpy, train_als
from cfk_tpu_torch import cli as tcli
from cfk_tpu_torch.data import blocks as tblocks
from cfk_tpu_torch.models.als import _tiled_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops.tiled import ials_tiled_half_step, tiled_half_step

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.05, 2.0
T = torch.as_tensor
FIELDS = (
    "neighbor_idx", "rating", "weight", "tile_seg", "chunk_base",
    "chunk_entity", "chunk_count", "carry_in", "last_seg", "slice_starts",
    "count", "rating_sum", "tile_meta", "rating_dense",
)
SCALARS = ("mode", "num_entities", "num_chunks", "chunk_cap",
           "chunk_entities", "tile_rows", "slice_rows", "num_slices")
STREAM = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
              tile_rows=16)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = jblocks.Dataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


@pytest.mark.parametrize("kw", [
    dict(chunk_elems=512, accum_max_entities=200, tile_rows=16),
    dict(chunk_elems=4096, accum_max_entities=100, tile_rows=32),
    dict(chunk_elems=128, accum_max_entities=10, tile_rows=8),
])
def test_stream_blocks_identical(coo, kw):
    jd = jblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=False,
                                  **kw)
    td = tblocks.Dataset.from_coo(coo, layout="tiled", dense_stream=False,
                                  **kw)
    modes = set()
    for side in ("movie_blocks", "user_blocks"):
        jb, tb = getattr(jd, side), getattr(td, side)
        modes.add(tb.mode)
        for f in FIELDS:
            a, b = getattr(jb, f), getattr(tb, f)
            if a is None:
                assert b is None, f
                continue
            assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f)
        for f in SCALARS:
            assert getattr(jb, f) == getattr(tb, f), f
        assert jb.statics == tb.statics
    assert "stream" in modes
    ub = td.user_blocks
    assert ub.mode == "stream" and ub.carry_in.sum() > 0  # straddling users


def test_dense_stream_default_matches_reference():
    for j_fn, t_fn in ((jblocks.build_tiled_blocks,
                        tblocks.build_tiled_blocks),
                       (jblocks.Dataset.from_coo, tblocks.Dataset.from_coo)):
        want = inspect.signature(j_fn).parameters["dense_stream"].default
        got = inspect.signature(t_fn).parameters["dense_stream"].default
        assert got is want is False


class _Built(Exception):
    """Stops a CLI run once the dataset build was asked for."""


@pytest.fixture(scope="module")
def ratings_file(coo, tmp_path_factory):
    path = tmp_path_factory.mktemp("stream_cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    return str(path)


def test_cli_asks_for_the_dense_stream_as_the_reference(ratings_file,
                                                        monkeypatch):
    asked = {}

    def record(name):
        def build(*_args, **kwargs):
            asked[name] = kwargs["dense_stream"]
            raise _Built
        return build

    monkeypatch.setattr(jcli, "_load_dataset", record("jax"))
    monkeypatch.setattr(tblocks.Dataset, "from_coo", record("als"))
    train = ["train", "--data", ratings_file, "--layout", "tiled",
             "--output", "none"]
    with pytest.raises(_Built):
        jcli.main(train)
    with pytest.raises(_Built):
        tcli.main(train + ["--device", "cpu"])
    assert asked["als"] is asked["jax"] is True
    # The subspace optimizers never build the tiled layout: no dense stream.
    monkeypatch.setattr(tblocks.Dataset, "from_coo", record("als++"))
    with pytest.raises(_Built):
        tcli.main(["train", "--data", ratings_file, "--algorithm", "als++",
                   "--block-size", "4", "--rank", "8", "--output", "none",
                   "--device", "cpu"])
    assert asked["als++"] is False


def _user_side(coo):
    d = jblocks.Dataset.from_coo(coo).coo_dense
    args = (d.user_raw, d.movie_raw, d.rating, 400, 150)
    kw = dict(tile_rows=16, chunk_elems=512, accum_max_entities=100)
    table = np.random.default_rng(K).random((150, K)).astype(np.float32)
    return args, kw, table


@pytest.fixture(scope="module")
def jax_stream_halves(coo):
    """The JAX package's split stream half-steps (solver="pallas":
    interpret-mode kernels): explicit and implicit."""
    args, kw, table = _user_side(coo)
    jb = jblocks.build_tiled_blocks(*args, **kw)
    assert jb.mode == "stream"
    chunks = ("tiled", jb.mode) + jb.statics
    als = j_tiled_half_step(jnp.asarray(table), j_tiled_to_device(jb), chunks,
                            jb.padded_entities, LAM, solver="pallas",
                            fused_epilogue=False)
    ials = j_ials_tiled(jnp.asarray(table), j_tiled_to_device(jb, True),
                        chunks, jb.padded_entities, LAM, ALPHA,
                        solver="pallas", fused_epilogue=False)
    return np.asarray(als), np.asarray(ials)


@pytest.mark.parametrize("fused", [False, None])
def test_stream_half_step_matches_reference(coo, jax_stream_halves, fused):
    args, kw, table = _user_side(coo)
    tb = tblocks.build_tiled_blocks(*args, **kw)
    assert tb.mode == "stream" and tb.carry_in.sum() > 0
    got = tiled_half_step(T(table), _tiled_to_device(tb, CPU, 150),
                          ("tiled", tb.mode) + tb.statics, tb.padded_entities,
                          LAM, fused_epilogue=fused)
    # float32 solves of the same normal equations, the carry folded in the
    # same place; the sums run in other orders (the half-step tolerance of
    # test_torch_als.py).
    assert _rel(got, jax_stream_halves[0]) < 1e-4


@pytest.mark.parametrize("fused", [False, None])
def test_ials_stream_half_step_matches_reference(coo, jax_stream_halves,
                                                 fused):
    args, kw, table = _user_side(coo)
    tb = tblocks.build_tiled_blocks(*args, **kw)
    got = ials_tiled_half_step(
        T(table), _tiled_to_device(tb, CPU, 150, weighted=True),
        ("tiled", tb.mode) + tb.statics, tb.padded_entities, LAM, ALPHA,
        fused_epilogue=fused)
    assert _rel(got, jax_stream_halves[1]) < 1e-4  # as the explicit half


@pytest.mark.parametrize("fused", [False, None])
def test_train_als_stream_matches_reference(coo, u0, fused):
    jd = jblocks.Dataset.from_coo(coo, **STREAM)
    td = tblocks.Dataset.from_coo(coo, **STREAM)
    assert (td.movie_blocks.mode, td.user_blocks.mode) == ("accum", "stream")
    init = (u0, np.zeros((150, K), np.float32))
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=3, layout="tiled",
                                  solver="pallas", fused_epilogue=False),
                      warm_start=init)
    model = train_als(td, ALSConfig(rank=K, num_iterations=3, layout="tiled",
                                    fused_epilogue=fused),
                      device="cpu", warm_start=init)
    # Three iterations of float32 solves in different orders (the
    # tolerance of the trainer parity tests in test_torch_als.py).
    assert _rel(model.predict_dense(), ref.predict_dense()) < 1e-3


def test_train_ials_stream_split_matches_reference(coo, u0):
    jd = jblocks.Dataset.from_coo(coo, **STREAM)
    td = tblocks.Dataset.from_coo(coo, **STREAM)
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
