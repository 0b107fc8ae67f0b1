"""The port's ALS path (cfk_tpu_torch) against cfk_tpu, on the CPU.

Half-steps are held to the JAX package's half-steps with ``solver="pallas"``
(its kernels in interpret/emulation mode), whole training runs to
``cfk_tpu.models.als.train_als`` from the same injected initial factors:
``jax.random`` cannot be reproduced in torch, so the JAX package's init
reaches the port through ``warm_start``.  Tolerances: float32 on both
sides with different summation orders — rtol 1e-4 for one half-step,
1e-3 for predictions after 3 iterations (the differences compound through
six chained solves).
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import build_tiled_blocks as j_build_tiled
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.eval.metrics import mse_rmse_from_model as j_mse_from_model
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.ops.solve import als_half_step as j_als_half_step
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, Dataset, factors_from_numpy, train_als
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
from cfk_tpu_torch.models.als import ALSModel, _tiled_to_device
from cfk_tpu_torch.ops.solve import (
    als_half_step,
    init_factors_stats,
    use_kernels,
)
from cfk_tpu_torch.ops.tiled import tiled_half_step

CPU = torch.device("cpu")
K = 8


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def init(coo):
    ds = JDataset.from_coo(coo)
    rng = np.random.default_rng(1)
    u0 = rng.random((ds.user_map.num_entities, K)).astype(np.float32)
    m0 = np.zeros((ds.movie_map.num_entities, K), np.float32)
    return u0, m0


def test_padded_half_step_matches(coo, init):
    jd, td = JDataset.from_coo(coo), Dataset.from_coo(coo)
    u0 = init[0]
    jb, tb = jd.movie_blocks, td.movie_blocks
    want = j_als_half_step(
        jnp.asarray(u0), jnp.asarray(jb.neighbor_idx), jnp.asarray(jb.rating),
        jnp.asarray(jb.mask), jnp.asarray(jb.count), 0.05, solver="pallas",
    )
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    got = als_half_step(t(u0), t(tb.neighbor_idx), t(tb.rating), t(tb.mask),
                        t(tb.count), 0.05)
    _close(got, want, 1e-4)
    chunked = als_half_step(t(u0), t(tb.neighbor_idx), t(tb.rating),
                            t(tb.mask), t(tb.count), 0.05, solve_chunk=7)
    _close(chunked, want, 1e-4)


@pytest.mark.parametrize("side,kw", [
    ("movie", dict(tile_rows=16, chunk_elems=1024, slice_rows=128)),  # accum
    ("user", dict(tile_rows=16, chunk_elems=512, accum_max_entities=100)),
])
def test_tiled_half_step_matches(coo, init, side, kw):
    d = JDataset.from_coo(coo).coo_dense
    nm, nu = 150, 400
    if side == "movie":
        args, fixed = (d.movie_raw, d.user_raw, d.rating, nm, nu), init[0]
    else:
        rng = np.random.default_rng(2)
        fixed = rng.standard_normal((nm, K)).astype(np.float32)
        args = (d.user_raw, d.movie_raw, d.rating, nu, nm)
    jb = j_build_tiled(*args, dense_stream=True, **kw)
    tb = build_tiled_blocks(*args, dense_stream=True, **kw)
    assert tb.mode == ("accum" if side == "movie" else "dstream")
    chunks = ("tiled", tb.mode) + tb.statics
    want = j_tiled_half_step(
        jnp.asarray(fixed), j_tiled_to_device(jb), chunks,
        jb.padded_entities, 0.05, solver="pallas",
    )
    got = tiled_half_step(
        torch.as_tensor(fixed), _tiled_to_device(tb, CPU, fixed.shape[0]),
        chunks, tb.padded_entities, 0.05,
    )
    _close(got, want, 1e-4)


@pytest.mark.parametrize("layout,kw", [
    ("padded", {}),
    ("tiled", dict(chunk_elems=512, accum_max_entities=200, tile_rows=16)),
])
def test_train_als_matches_reference(coo, init, layout, kw):
    jkw = dict(kw, dense_stream=True) if layout == "tiled" else {}
    jd = JDataset.from_coo(coo, layout=layout, **jkw)
    td = Dataset.from_coo(coo, layout=layout, **jkw)
    if layout == "tiled":
        assert (td.movie_blocks.mode, td.user_blocks.mode) == ("accum",
                                                               "dstream")
        assert td.user_blocks.carry_in.sum() > 0
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=3, layout=layout),
                      warm_start=init)
    model = train_als(td, ALSConfig(rank=K, num_iterations=3, layout=layout),
                      device="cpu", warm_start=init)
    _close(model.predict_dense(), ref.predict_dense(), 1e-3)
    mse, rmse = mse_rmse_from_model(model, td)
    jmse, jrmse = j_mse_from_model(ref, jd)
    assert abs(mse - jmse) <= 1e-3 * jmse and np.isfinite(rmse)


def test_solver_cholesky_is_the_plain_route(coo, init):
    td = Dataset.from_coo(coo, layout="tiled", chunk_elems=512,
                          accum_max_entities=200, tile_rows=16,
                          dense_stream=True)
    cfg = dict(rank=K, num_iterations=2, layout="tiled")
    a = train_als(td, ALSConfig(**cfg), device="cpu", warm_start=init)
    b = train_als(td, ALSConfig(solver="cholesky", **cfg), device="cpu",
                  warm_start=init)
    assert torch.equal(a.user_factors, b.user_factors)
    # On the card the plain route is refused: a CUDA tensor always goes
    # through the kernels (checked before any device is touched).
    with pytest.raises(ValueError, match="CPU tensors only"):
        train_als(td, ALSConfig(solver="cholesky", **cfg), device="cuda",
                  warm_start=init)
    with pytest.raises(ValueError, match="CPU tensors only"):
        use_kernels("cholesky", torch.device("cuda"))
    assert use_kernels("auto", torch.device("cuda"))


def test_own_init_follows_the_reference_rule(coo):
    """f[0] = mean rating, f[1:] ~ U(0,1) from the seed, count-0 rows zero."""
    rs = torch.tensor([6.0, 0.0, 9.0])
    cnt = torch.tensor([2, 0, 3], dtype=torch.int32)
    f = init_factors_stats(torch.Generator().manual_seed(3), rs, cnt, 4)
    assert f[0, 0] == 3.0 and f[2, 0] == 3.0
    assert torch.all(f[1] == 0)
    assert torch.all((f[[0, 2], 1:] >= 0) & (f[[0, 2], 1:] < 1))
    td = Dataset.from_coo(coo)
    cfg = ALSConfig(rank=K, num_iterations=1, seed=5)
    a = train_als(td, cfg, device="cpu")
    b = train_als(td, cfg, device="cpu")
    assert torch.equal(a.user_factors, b.user_factors)


def test_config_layout_must_match_the_blocks(coo):
    td = Dataset.from_coo(coo)
    with pytest.raises(ValueError, match="built with the padded layout"):
        train_als(td, ALSConfig(rank=K, num_iterations=1, layout="tiled"),
                  device="cpu")
    model = train_als(td, ALSConfig(rank=K, num_iterations=1, layout="auto"),
                      device="cpu")
    assert torch.isfinite(model.user_factors).all()


def test_factors_from_numpy_holds_the_reference_state(coo, init):
    jd = JDataset.from_coo(coo)
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=1), warm_start=init)
    u, m = ref.host_factors()
    model = factors_from_numpy(u, m, device="cpu")
    assert isinstance(model, ALSModel)
    np.testing.assert_array_equal(model.predict_dense(), ref.predict_dense())
    mse, _ = mse_rmse_from_model(model, Dataset.from_coo(coo))
    jmse, _ = j_mse_from_model(ref, jd)
    assert abs(mse - jmse) <= 1e-9 * jmse
    with pytest.raises(ValueError, match="one rank"):
        factors_from_numpy(u, m[:, :3], device="cpu")


def test_predict_dense_refuses_huge():
    model = ALSModel(torch.zeros(1, 2), torch.zeros(1, 2), 100_000, 50_000)
    with pytest.raises(ValueError, match="allow_huge"):
        model.predict_dense()


def test_cuda_without_cuda_raises_not_falls_back(coo, monkeypatch):
    from cfk_tpu_torch import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    td = Dataset.from_coo(coo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        train_als(td, ALSConfig(rank=K, num_iterations=1))  # default: cuda
    with pytest.raises(RuntimeError, match="is_available"):
        factors_from_numpy(np.zeros((2, 3)), np.zeros((2, 3)))
    assert resolve_device("cpu") == CPU


@pytest.mark.parametrize("kw,match", [
    (dict(rank=0), "rank must be >= 1"),
    (dict(num_iterations=0), "num_iterations must be >= 1"),
    (dict(lam=-1.0), "lam must be >= 0"),
    (dict(solver="pallas"), "unknown solver"),
    (dict(layout="diagonal"), "unknown layout"),
    (dict(reg_solve_algo="qr"), "reg_solve_algo must be"),
    (dict(hbm_chunk_elems=0), "hbm_chunk_elems must be >= 1"),
])
def test_config_validation_matches_reference_messages(kw, match):
    with pytest.raises(ValueError, match=match):
        ALSConfig(**kw)


@pytest.mark.parametrize("algo", ["lu", "gj"])
def test_reg_solve_algo_other_than_auto_is_refused(algo):
    """"lu" and "gj" are accepted (no longer refused) and route as the
    reference's fused cap does: LU keeps rank 96 on the fused route, GJ
    (cap 64) sends it to the split schedule; both keep rank 64 fused."""
    from cfk_tpu.ops.pallas.solve_kernel import _fused_reg_rank_cap

    from cfk_tpu_torch.ops.solve import fused_rank_cap, resolve_fused_chunk

    assert ALSConfig(reg_solve_algo=algo).reg_solve_algo == algo
    assert fused_rank_cap(algo) == _fused_reg_rank_cap(algo)
    assert resolve_fused_chunk(None, 96, algo) == (algo == "lu")
    assert resolve_fused_chunk(None, 64, algo)


def test_import_pulls_in_no_jax_and_no_cfk_tpu():
    code = (
        "import sys, cfk_tpu_torch, cfk_tpu_torch.cli, cfk_tpu_torch.weights\n"
        "import cfk_tpu_torch.ops.tiled, cfk_tpu_torch.eval.metrics\n"
        "import cfk_tpu_torch.serving, cfk_tpu_torch.serving.engine\n"
        "import cfk_tpu_torch.serving.twostage, cfk_tpu_torch.serving.cluster\n"
        "import cfk_tpu_torch.serving.server, cfk_tpu_torch.serving.loadgen\n"
        "import cfk_tpu_torch.serving.topk_kernel, cfk_tpu_torch.ops.quant\n"
        "import cfk_tpu_torch.transport, cfk_tpu_torch.transport.serdes\n"
        "import cfk_tpu_torch.transport.checkpoint, cfk_tpu_torch.telemetry\n"
        "import cfk_tpu_torch.utils.roofline, cfk_tpu_torch.eval.recommend\n"
        "import cfk_tpu_torch.data.synthetic, cfk_tpu_torch.data.blocks\n"
        "import cfk_tpu_torch.models.ials, cfk_tpu_torch.ops.subspace\n"
        "import cfk_tpu_torch.ops.bucketed, cfk_tpu_torch.eval.ranking\n"
        "import cfk_tpu_torch.data.movielens, cfk_tpu_torch.data.netflix\n"
        "import cfk_tpu_torch.data._native, cfk_tpu_torch.data.cache\n"
        "import cfk_tpu_torch.data.synth\n"
        "assert cfk_tpu_torch.data._native.available()\n"
        "import cfk_tpu_torch.ops.kernels.binv_kernel\n"
        "import cfk_tpu_torch.scripts.exp_binv\n"
        "import cfk_tpu_torch.resilience, cfk_tpu_torch.resilience.loop\n"
        "import cfk_tpu_torch.resilience.faults\n"
        "import cfk_tpu_torch.resilience.retry\n"
        "import cfk_tpu_torch.scripts.chaos_lab\n"
        "import cfk_tpu_torch.streaming, cfk_tpu_torch.streaming.session\n"
        "import cfk_tpu_torch.streaming.foldin\n"
        "import cfk_tpu_torch.transport.filelog\n"
        "import cfk_tpu_torch.transport.ingest\n"
        "import cfk_tpu_torch.transport.journal\n"
        "import cfk_tpu_torch.transport.tcp, cfk_tpu_torch.serving.fleet\n"
        "import cfk_tpu_torch.offload.hot\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'cfk_tpu', 'ml_dtypes')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
