"""The port's out-of-core implicit tier and out-of-core streaming, on the CPU.

- ``train_ials_host_window`` (iALS and iALS++) is crc-equal to the port's
  resident ``train_ials`` on the same bucketed blocks at every knob — table
  dtype, hot cache, staging mode, gather, epilogue, storage dtype — and
  held to the JAX package's windowed trainer from its own init within 1e-4
  of max|x| after two iterations;
- ``windowed_store_gram`` equals the resident ``global_gram_blocked`` bit
  for bit at every staging dtype;
- ``fold_in_rows_windowed`` equals the resident padded fold-in bit for bit
  and the JAX package's within 1e-5 of max|x|, and a ``StreamSession`` with
  ``offload_tier="host_window"`` commits the same factors as a resident one.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.ials import IALSConfig as JIConfig
from cfk_tpu.offload import windowed as jwindowed
from cfk_tpu.offload.store import HostFactorStore as JStore
from cfk_tpu.ops.solve import init_factors_stats as j_init_stats
from cfk_tpu.streaming.foldin import fold_in_rows_windowed as j_fold_windowed
from cfk_tpu_torch import Dataset
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.offload import windowed
from cfk_tpu_torch.offload.store import HostFactorStore
from cfk_tpu_torch.ops.quant import quantize_table, dequantize_table
from cfk_tpu_torch.ops.solve import global_gram_blocked
from cfk_tpu_torch.streaming.foldin import (
    fold_in_rows,
    fold_in_rows_windowed,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(120, 60, 2500, seed=3)


@pytest.fixture(scope="module")
def bucketed(coo):
    return Dataset.from_coo(coo, layout="bucketed", chunk_elems=256)


def _crc(model) -> int:
    u, m = model.host_factors()
    return zlib.crc32(np.ascontiguousarray(u).tobytes()
                      + np.ascontiguousarray(m).tobytes())


def _cfg(algorithm, **kw):
    return IALSConfig(**{"rank": 8, "num_iterations": 2,
                         "layout": "bucketed", "algorithm": algorithm,
                         "block_size": 4, **kw})


@pytest.mark.parametrize("algorithm", ["als", "ials++"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("hot_rows,staging", [(0, "pool"), (None, "serial"),
                                              (30, "pool")])
def test_windowed_ials_equals_resident(bucketed, algorithm, table_dtype,
                                       hot_rows, staging):
    cfg = _cfg(algorithm, table_dtype=table_dtype)
    res = train_ials(bucketed, cfg, device="cpu")
    win = windowed.train_ials_host_window(
        bucketed, cfg, device="cpu", chunks_per_window=2,
        hot_rows=hot_rows, staging=staging)
    assert win.pipeline["route"] == "host_window"
    assert _crc(win) == _crc(res)


@pytest.mark.parametrize("algorithm", ["als", "ials++"])
@pytest.mark.parametrize("knobs", [
    dict(in_kernel_gather=False), dict(fused_epilogue=False),
    dict(dtype="bfloat16"), dict(overlap=False), dict(sweeps=2),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_windowed_ials_knobs_equal_resident(bucketed, algorithm, knobs):
    cfg = _cfg(algorithm, **knobs)
    res = train_ials(bucketed, cfg, device="cpu")
    for cpw in (1, 3):
        win = windowed.train_ials_host_window(
            bucketed, cfg, device="cpu", chunks_per_window=cpw, hot_rows=20)
        assert _crc(win) == _crc(res)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_store_gram_equals_resident(table_dtype):
    """The streamed YᵀY: the resident blocks in order — the same bits —
    across a tail block (rows not a multiple of the block)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((1000, 8)).astype(np.float32)
    store = HostFactorStore.from_array(a, num_shards=3)
    mine = windowed.windowed_store_gram(store, device="cpu",
                                        table_dtype=table_dtype,
                                        block_rows=96)
    data, scale = quantize_table(torch.from_numpy(a), table_dtype)
    ref = global_gram_blocked(dequantize_table(data, scale), block_rows=96)
    assert torch.equal(mine, ref)


@pytest.mark.parametrize("algorithm", ["als", "ials++"])
def test_windowed_ials_matches_reference(coo, algorithm):
    jds = JDataset.from_coo(coo, layout="bucketed", chunk_elems=256)
    ds = Dataset.from_coo(coo, layout="bucketed", chunk_elems=256)
    kw = dict(rank=8, num_iterations=2, layout="bucketed",
              algorithm=algorithm, block_size=4)
    jcfg = JIConfig(**kw)
    ref = jwindowed.train_ials_host_window(jds, jcfg, chunks_per_window=2)
    ub = jds.user_blocks
    u0 = np.asarray(jax.jit(
        j_init_stats, static_argnames=("rank", "num_entities"))(
        jax.random.PRNGKey(jcfg.seed), jnp.asarray(ub.rating_sum),
        jnp.asarray(ub.count), rank=8, num_entities=ub.num_entities),
        np.float32)
    mine = windowed.train_ials_host_window(
        ds, IALSConfig(**kw), device="cpu", chunks_per_window=2,
        warm_start=(u0, np.zeros((ds.movie_blocks.padded_entities, 8),
                                 np.float32)))
    for a, b in zip(mine.host_factors(), (np.asarray(ref.user_factors),
                                          np.asarray(ref.movie_factors))):
        assert np.abs(a - b[: a.shape[0]]).max() <= 1e-4 * np.abs(b).max()


def test_train_ials_exit(bucketed):
    cfg = _cfg("ials++")
    res = train_ials(bucketed, cfg, device="cpu")
    win = train_ials(bucketed, dataclasses.replace(
        cfg, offload_tier="host_window"), device="cpu")
    assert win.pipeline["route"] == "host_window"
    assert _crc(win) == _crc(res)
    with pytest.raises(NotImplementedError, match="watchdog"):
        train_ials(bucketed, dataclasses.replace(
            cfg, offload_tier="host_window"), device="cpu",
            watchdog=object())
    with pytest.raises(ValueError, match="bucketed width-class"):
        IALSConfig(layout="tiled", offload_tier="host_window")


# -- out-of-core streaming ---------------------------------------------------


def _neighbor_data(rng, n_users, n_movies):
    out = []
    for i in range(n_users):
        width = int(rng.integers(0 if i == 3 else 1, 12))
        mv = np.sort(rng.choice(n_movies, size=width, replace=False))
        out.append((mv.astype(np.int32),
                    rng.integers(1, 6, width).astype(np.float32)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fold_in_rows_windowed(dtype):
    rng = np.random.default_rng(11)
    movies = rng.standard_normal((70, 6)).astype(np.float32)
    data = _neighbor_data(rng, 13, 70)
    store = HostFactorStore.from_array(movies, dtype=dtype)
    resident = fold_in_rows(store.as_tensor().clone(), data, lam=0.05)
    stats = {}
    mine, staged = fold_in_rows_windowed(store, data, lam=0.05, stats=stats,
                                         return_staged=True, device="cpu")
    np.testing.assert_array_equal(mine, resident)
    assert stats["foldin_windows_staged"] == 1
    assert staged.shape[0] % 8 == 0
    ref = j_fold_windowed(JStore.from_array(movies, dtype=dtype), data,
                          lam=0.05)
    assert np.abs(mine - ref).max() <= 1e-5 * np.abs(ref).max()
    assert fold_in_rows_windowed(store, [], lam=0.05,
                                 device="cpu").shape == (0, 6)


def test_stream_session_host_window(tmp_path):
    """An out-of-core session (movie table in a host store, every fold-in
    against a staged window) commits the factors of a resident session
    folding in with the same (padded) layout."""
    from cfk_tpu_torch.config import ALSConfig
    from cfk_tpu_torch.models.als import train_als
    from cfk_tpu_torch.streaming import StreamProducer, StreamSession
    from cfk_tpu_torch.streaming.session import StreamConfig
    from cfk_tpu_torch.transport import CheckpointManager, InMemoryBroker

    coo = synthetic_netflix_coo(60, 30, 900, seed=0)
    ds = Dataset.from_coo(coo, layout="tiled", chunk_elems=512,
                          tile_rows=16, accum_max_entities=0)
    cfg = ALSConfig(rank=4, num_iterations=3, health_check_every=1,
                    layout="tiled")
    base = train_als(ds, cfg, device="cpu")
    broker = InMemoryBroker()
    prod = StreamProducer(broker, num_partitions=2)
    rng = np.random.default_rng(2)
    users = rng.choice(ds.user_map.raw_ids, 40)
    movies = rng.choice(ds.movie_map.raw_ids, 40)
    prod.send_many(users, movies, rng.integers(1, 6, 40).astype(np.float32))
    out = {}
    for tier in ("device", "host_window"):
        sess = StreamSession(
            ds, dataclasses.replace(cfg, offload_tier=tier), broker,
            CheckpointManager(str(tmp_path / tier)),
            stream=StreamConfig(batch_records=8, foldin_layout="padded"),
            base_model=base,
            device="cpu")
        sess.run()
        out[tier] = (np.array(sess.user_factors),
                     np.asarray(sess.movie_factors, np.float32))
        if tier == "host_window":
            assert sess.metrics.gauges["foldin_windows_staged"] >= 1
            with pytest.raises(NotImplementedError, match="retrain"):
                sess.retrain()
    for a, b in zip(out["device"], out["host_window"]):
        np.testing.assert_array_equal(a, b)
