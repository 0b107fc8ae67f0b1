"""The port's chunk pipeline (``cfk_tpu_torch.ops.pipeline``) against
``cfk_tpu.ops.pipeline``, and the overlap on/off contract of its trainers,
on the CPU.

The structure cases are those of ``tests/test_overlap.py``: the body of
step i consumes fetch(i), the carry and ``xs`` thread through, the last
prefetch never reads past the chunks, and ``chunk_map`` equals the plain
map — the port's ``prefetch_scan``/``chunk_map`` fed the same numpy inputs
as the reference's (one ``jax.jit`` for all four), outputs equal exactly
(integers and sums of a few floats in the same order).  Then
``train_als``/``train_ials`` with ``overlap=True`` and ``overlap=False``
must return bit-equal factors on every layout and schedule (on the CPU
both run the same calls in the same order; the card's captured and
side-stream routes are held to the same bits in ``test_torch_gpu.py``),
and one layout is held to the JAX package's ``overlap=True`` run at the
trainer tolerance of ``test_torch_als.py`` (1e-3 of the largest |value|
of the predictions after the same iterations: float32 sums in another
order, compounded through the chained solves).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.ops import pipeline as jpipe
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops import pipeline

NC = 5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch intra-op thread for these small products: the suite runs
    files in parallel workers, where each worker's spinning thread pool,
    oversubscribed across them, slowed this file a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
XS = np.arange(NC * 2, dtype=np.float32).reshape(NC, 2)
ARRS = (np.arange(12, dtype=np.float32).reshape(4, 3),
        np.arange(8, dtype=np.float32).reshape(4, 2))


@pytest.fixture(scope="module")
def reference():
    """The reference's four structure cases, compiled once."""
    def run():
        def fetch_i(i):
            return jnp.full((3,), i, jnp.int32)

        def consume(carry, buf, x, i):
            return carry + buf[0], (buf[0], i)

        c1, ys1 = jpipe.prefetch_scan(fetch_i, consume, NC, jnp.int32(0))

        def fetch_d(i):
            return {"buf": jnp.full((2, 2), i, jnp.float32)}

        def consume_xs(carry, buf, x, i):
            return carry + 1, buf["buf"][0, 0] + x[0]

        c2, ys2 = jpipe.prefetch_scan(fetch_d, consume_xs, NC, jnp.int32(0),
                                      xs=jnp.asarray(XS))

        def fetch_t(i):
            return jnp.take(jnp.arange(3) * 10, i, mode="fill",
                            fill_value=-1)

        c3, _ = jpipe.prefetch_scan(fetch_t, lambda c, b, x, i: (c + b, None),
                                    3, jnp.int32(0))
        ys4 = jpipe.chunk_map(lambda a, b: jnp.sum(a) * jnp.ones((2,)) + b,
                              tuple(jnp.asarray(a) for a in ARRS), 4,
                              overlap=True)
        return c1, ys1, c2, ys2, c3, ys4

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)())


def test_prefetch_scan_body_consumes_its_own_chunk(reference):
    """Step i sees fetch(i)'s buffer, never fetch(i+1)'s; each chunk is
    fetched once, in order, the fetch of i+1 before the compute of i."""
    order = []

    def fetch(i):
        order.append(("fetch", i))
        return torch.full((3,), i, dtype=torch.int32)

    def compute(carry, buf, x, i):
        assert x is None
        order.append(("compute", i))
        return carry + int(buf[0]), (int(buf[0]), i)

    carry, ys = pipeline.prefetch_scan(fetch, compute, NC, 0)
    c1, (seen, idx) = reference[0], reference[1]
    assert [y[0] for y in ys] == list(seen) == list(range(NC))
    assert [y[1] for y in ys] == list(idx)
    assert carry == int(c1) == sum(range(NC))
    assert order[:3] == [("fetch", 0), ("fetch", 1), ("compute", 0)]
    assert [i for what, i in order if what == "fetch"] == list(range(NC))


def test_prefetch_scan_carry_structure_and_xs(reference):
    """Only the inner carry comes back, advanced once per chunk, with xs
    threaded per chunk."""
    def fetch(i):
        return {"buf": torch.full((2, 2), float(i))}

    def compute(carry, buf, x, i):
        assert set(buf) == {"buf"} and buf["buf"].shape == (2, 2)
        assert x.shape == (2,)
        return carry + 1, buf["buf"][0, 0] + x[0]

    carry, ys = pipeline.prefetch_scan(fetch, compute, NC, 0,
                                       xs=torch.as_tensor(XS))
    assert carry == int(reference[2]) == NC
    np.testing.assert_array_equal(torch.stack(ys).numpy(), reference[3])


def test_prefetch_scan_final_fetch_clamps(reference):
    """No fetch past the last chunk: the reference clamps its dead last
    prefetch to nc−1, the port does not issue it; both consume only
    in-range buffers."""
    fetched = []
    table = torch.arange(3) * 10

    def fetch(i):
        fetched.append(i)
        return table[i] if i < 3 else torch.tensor(-1)

    carry, _ = pipeline.prefetch_scan(
        fetch, lambda c, b, x, i: (c + int(b), None), 3, 0)
    assert max(fetched) == 2 and fetched == [0, 1, 2]
    assert carry == int(reference[4]) == 0 + 10 + 20
    assert pipeline.prefetch_scan(fetch, None, 0, 7) == (7, [])


def test_chunk_map_matches_plain_map(reference):
    arrs = tuple(torch.as_tensor(a) for a in ARRS)

    def piece(a, b):
        return a.sum() * torch.ones(2) + b

    got = torch.stack(pipeline.chunk_map(piece, arrs, 4))
    plain = torch.stack([piece(*(a[c] for a in arrs)) for c in range(4)])
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), reference[5])
    assert pipeline.resolve_overlap(None) is pipeline.default_overlap()
    assert pipeline.resolve_overlap(False) is False
    assert pipeline.index_fetch(torch.arange(10), 4)(1).tolist() == [4, 5, 6,
                                                                     7]


# -- the trainers: overlap on and off --------------------------------------------

@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(240, 70, 3000, seed=3)


_DATA = {
    "padded": dict(layout="padded"),
    "tiled_dense": dict(layout="tiled", chunk_elems=256, dense_stream=True,
                        accum_max_entities=100, tile_rows=16),
    "tiled_stream": dict(layout="tiled", chunk_elems=256,
                         accum_max_entities=100, tile_rows=16),
    "bucketed": dict(layout="bucketed", chunk_elems=128),
    "segment": dict(layout="segment", chunk_elems=4096),
}


@pytest.fixture(scope="module")
def datasets(coo):
    return {name: Dataset.from_coo(coo, **kw) for name, kw in _DATA.items()}


# (dataset, config knobs): every layout and schedule the trainers run.
_RUNS = [
    ("padded", {}),
    ("padded", dict(solve_chunk=32)),
    ("padded", dict(algorithm="++", block_size=4)),
    ("tiled_dense", {}),
    ("tiled_dense", dict(fused_epilogue=False)),
    ("tiled_dense", dict(in_kernel_gather=False)),
    ("tiled_dense", dict(in_kernel_gather=False, fused_epilogue=False)),
    ("tiled_stream", {}),
    ("tiled_stream", dict(in_kernel_gather=False, fused_epilogue=False)),
    ("tiled_dense", dict(table_dtype="int8")),
    ("tiled_dense", dict(table_dtype="bfloat16", in_kernel_gather=False)),
    ("tiled_dense", dict(dtype="bfloat16")),
    ("bucketed", {}),
    ("bucketed", dict(in_kernel_gather=False, table_dtype="bfloat16")),
    ("bucketed", dict(fused_epilogue=False, table_dtype="int8")),
    ("bucketed", dict(algorithm="++", block_size=4)),
    ("segment", {}),
    ("segment", dict(dtype="bfloat16")),
    ("tiled_dense", dict(rank=136, in_kernel_gather=False)),
]


@pytest.mark.parametrize("implicit", [False, True], ids=["als", "ials"])
@pytest.mark.parametrize("data,knobs", _RUNS)
def test_overlap_on_off_bit_equal(datasets, data, knobs, implicit):
    ds = datasets[data]
    knobs = dict(knobs)
    if knobs.get("algorithm") == "++":
        knobs["algorithm"] = "ials++" if implicit else "als++"
    rank = knobs.pop("rank", 8)
    make, train = (IALSConfig, train_ials) if implicit else (ALSConfig,
                                                            train_als)
    rng = np.random.default_rng(0)
    u0 = rng.random((ds.user_blocks.padded_entities, rank), dtype=np.float32)
    m0 = np.zeros((ds.movie_blocks.padded_entities, rank), np.float32)
    models = {}
    for overlap in (True, False):
        cfg = make(rank=rank, num_iterations=2, layout=_DATA[data]["layout"],
                   overlap=overlap, **knobs)
        models[overlap] = train(ds, cfg, device="cpu", warm_start=(u0, m0))
    on, off = models[True], models[False]
    assert on.pipeline["route"] == "prefetched"
    assert off.pipeline["route"] == "serial"
    assert torch.isfinite(on.user_factors.float()).all()
    assert torch.equal(on.user_factors, off.user_factors)
    assert torch.equal(on.movie_factors, off.movie_factors)


def test_pipeline_route_follows_the_configuration():
    """The route is decided from the configuration before any launch."""
    from cfk_tpu_torch.models.als import pipeline_route

    cfg = ALSConfig(rank=64, num_iterations=3)
    assert pipeline_route(cfg, "cpu")[0] == "prefetched"
    # Capture is opt-in, on every route alike.
    assert pipeline_route(cfg, torch.device("cuda"))[0] == "prefetched"
    for sweeps in (ALSConfig(rank=64, num_iterations=3, algorithm="als++"),
                   IALSConfig(rank=64, num_iterations=3,
                              algorithm="ials++")):
        assert pipeline_route(sweeps, "cuda")[0] == "prefetched"
        on = dataclasses.replace(sweeps, capture=True)
        assert pipeline_route(on, "cuda")[0] == "captured"
        assert pipeline_route(dataclasses.replace(on, overlap=False),
                              "cuda")[0] == "serial"
    one = ALSConfig(rank=64, num_iterations=1, capture=True)
    assert pipeline_route(one, "cuda")[0] == "prefetched"
    big = ALSConfig(rank=256, num_iterations=3, capture=True)
    assert pipeline_route(big, "cuda")[0] == "captured"
    assert pipeline_route(big, "cpu")[0] == "prefetched"
    off = ALSConfig(rank=64, num_iterations=3, overlap=False, capture=True)
    assert pipeline_route(off, "cuda")[0] == "serial"


def test_overlap_run_matches_reference_overlap_run(coo):
    """The tiled dense-stream ALS run with overlap on, against the JAX
    package's ``overlap=True`` run from the same start."""
    kw = _DATA["tiled_dense"]
    jd, td = JDataset.from_coo(coo, **kw), Dataset.from_coo(coo, **kw)
    rng = np.random.default_rng(1)
    init = (rng.random((td.user_map.num_entities, 8), dtype=np.float32),
            np.zeros((td.movie_map.num_entities, 8), np.float32))
    ref = j_train_als(jd, JConfig(rank=8, num_iterations=2, layout="tiled",
                                  overlap=True), warm_start=init)
    got = train_als(td, ALSConfig(rank=8, num_iterations=2, layout="tiled",
                                  overlap=True), device="cpu",
                    warm_start=init)
    want = ref.predict_dense()
    assert np.abs(got.predict_dense() - want).max() <= \
        1e-3 * np.abs(want).max()
