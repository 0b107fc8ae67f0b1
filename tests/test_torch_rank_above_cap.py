"""Training above rank 128, the fused kernels' cap, against the JAX package,
on the CPU.

Above 128 the JAX package's rank gates (``fused_gram_solve_supported``,
``cfk_tpu/ops/pallas/gram_kernel.py:627-648``; ``regularized_solve``,
``cfk_tpu/ops/solve.py:441-460, 480-483``) send every chunk, width class
and accumulator to the split schedule: the split Gram kernels, which have
no rank cap, then the ridge add and XLA's Cholesky (``batched_spd_solve``,
``dispatch_spd_solve`` at k > 2·64).  The port takes the same route: the
split Gram wrappers (on the card the block-pair kernels of
``csrc/gram_kernels.cuh``; here their plain versions), then
``ops.solve.batched_spd_solve``.  The reference is the JAX package's
``solver="pallas"`` route with ``in_kernel_gather=False`` (its Pallas Gram
entries run their XLA emulation twins off the TPU); its own two gather
routes are never the oracle.  The port runs both gather settings, which
must agree bit for bit on the CPU.  Inputs come from numpy seeds.

Tolerances, relative to the largest |value|: 1e-4 for a half-step (float32
Gram sums in another order, then a float32 Cholesky on either side, the
systems held up by the λ·n or YᵀY + λI ridge), 1e-3 for a trainer's
predictions (the trainer tolerance of ``test_torch_split.py``).  The card's
kernels are held to these plain versions in ``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import build_tiled_blocks as j_build
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.ops.solve import als_half_step_bucketed as j_als_bucketed
from cfk_tpu.ops.tiled import ials_tiled_half_step as j_ials_tiled
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.models.als import _bucketed_to_device, _tiled_to_device
from cfk_tpu_torch.ops import bucketed as t_bucketed
from cfk_tpu_torch.ops import solve as t_solve
from cfk_tpu_torch.ops import tiled as t_tiled
from cfk_tpu_torch.ops.kernels import gram_kernel as gk
from cfk_tpu_torch.ops.kernels.solve_kernel import reg_solve
from cfk_tpu_torch.ops.solve import als_half_step_bucketed

CPU = torch.device("cpu")
K = 136  # LU_MAX_RANK + 8, the rank of tests/test_in_kernel_gather.py:247
LAM, ALPHA = 0.05, 2.0
T = torch.as_tensor
JKW = dict(solver="pallas", in_kernel_gather=False)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


def _tiled_args(coo, mode):
    d = JDataset.from_coo(coo).coo_dense
    if mode == "accum":
        return ((d.movie_raw, d.user_raw, d.rating, 150, 400),
                dict(tile_rows=16, chunk_elems=512, slice_rows=128))
    return ((d.user_raw, d.movie_raw, d.rating, 400, 150),
            dict(tile_rows=16, chunk_elems=512, accum_max_entities=100,
                 dense_stream=mode == "dstream"))


def _fixed(mode, k):
    """The fixed side's factors, N(0, 0.1²).  An entity with n < k ratings
    has a rank-n Gram held up by the λ·n ridge alone; with U(0, 1) factors
    its condition number reaches ~3e3 at k = 136 and the JAX package's own
    float32 route then ends 1e-4 of max|x| from a float64 solve.  At this
    scale |f|² ≈ 1.4, so the comparison holds the routes, not float32's
    conditioning (``test_dense_half_step_above_cap_matches_float64`` holds
    the port to float64 on the same systems)."""
    n = 400 if mode == "accum" else 150
    rng = np.random.default_rng(k)
    return (0.1 * rng.standard_normal((n, k))).astype(np.float32)


def _port_tiled(coo, mode, k, implicit=False, lam=LAM, **knobs):
    args, kw = _tiled_args(coo, mode)
    tb = build_tiled_blocks(*args, **kw)
    assert tb.mode == mode
    blk = _tiled_to_device(tb, CPU, args[4], weighted=implicit)
    chunks = ("tiled", tb.mode) + tb.statics
    if implicit:
        return t_tiled.ials_tiled_half_step(T(_fixed(mode, k)), blk, chunks,
                                            tb.padded_entities, lam, ALPHA,
                                            **knobs)
    return t_tiled.tiled_half_step(T(_fixed(mode, k)), blk, chunks,
                                   tb.padded_entities, lam, **knobs)


def _jax_tiled(coo, mode, k, implicit=False, lam=LAM):
    args, kw = _tiled_args(coo, mode)
    jb = j_build(*args, **kw)
    chunks = ("tiled", jb.mode) + jb.statics
    fixed = jnp.asarray(_fixed(mode, k))
    if implicit:
        return np.asarray(j_ials_tiled(fixed, j_tiled_to_device(jb, True),
                                       chunks, jb.padded_entities, lam, ALPHA,
                                       **JKW))
    return np.asarray(j_tiled_half_step(fixed, j_tiled_to_device(jb), chunks,
                                        jb.padded_entities, lam, **JKW))


def _movie_buckets(coo):
    kw = dict(layout="bucketed", chunk_elems=256)
    jb = JDataset.from_coo(coo, **kw).movie_blocks
    tb = Dataset.from_coo(coo, **kw).movie_blocks
    trees, chunks = jb.to_tree()
    jtrees = tuple({n: jnp.asarray(v) for n, v in t.items()} for t in trees)
    ttrees, _ = _bucketed_to_device(tb, CPU)
    return (jtrees, chunks, jb.padded_entities), (ttrees, tb.padded_entities)


# -- half-steps at k = 136 ------------------------------------------------------

@pytest.mark.parametrize("mode", ["accum", "stream", "dstream"])
def test_tiled_half_step_above_cap_matches_reference(coo, mode):
    want = _jax_tiled(coo, mode, K)
    got = {knob: _port_tiled(coo, mode, K, in_kernel_gather=knob)
           for knob in (None, False)}
    assert _rel(got[False], want) < 1e-4
    assert torch.equal(got[None], got[False])
    # the knob that selects the fused schedule below 128 changes nothing
    assert torch.equal(_port_tiled(coo, mode, K, fused_epilogue=False),
                       got[None])


def test_bucketed_half_step_above_cap_matches_reference(coo):
    (jtrees, jchunks, jn), (ttrees, tn) = _movie_buckets(coo)
    fixed = _fixed("accum", K)
    want = j_als_bucketed(jnp.asarray(fixed), jtrees, jchunks, jn, LAM, **JKW)
    got = {knob: als_half_step_bucketed(T(fixed), ttrees, tn, LAM,
                                        in_kernel_gather=knob)
           for knob in (None, False)}
    assert _rel(got[False], want) < 1e-4
    assert torch.equal(got[None], got[False])


def test_dense_half_step_above_cap_matches_float64(coo):
    """The dense-stream user half against each user's normal equations
    solved in float64 on the host: A = Σ f fᵀ + λ·n·I, b = Σ r·f."""
    d = JDataset.from_coo(coo).coo_dense
    f = _fixed("dstream", K).astype(np.float64)
    want = np.zeros((400, K))
    for u in range(400):
        sel = d.user_raw == u
        g = f[d.movie_raw[sel]]
        a = g.T @ g + LAM * max(int(sel.sum()), 1) * np.eye(K)
        want[u] = np.linalg.solve(a, g.T @ d.rating[sel])
    got = _port_tiled(coo, "dstream", K)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("mode", ["accum", "dstream"])
def test_ials_tiled_half_step_above_cap_matches_reference(coo, mode):
    """λ = 1: the user half's YᵀY sums 150 movie rows at k = 136, nearly
    singular, so at λ = 0.05 its systems' condition numbers let the JAX
    package's float32 route itself vary by 1e-4 between runs."""
    want = _jax_tiled(coo, mode, K, implicit=True, lam=1.0)
    got = _port_tiled(coo, mode, K, implicit=True, lam=1.0)
    assert _rel(got, want) < 1e-4


# -- trainers ---------------------------------------------------------------------

DENSE = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
             tile_rows=16, dense_stream=True)


@pytest.mark.parametrize("data,k", [(DENSE, K), (dict(layout="padded"), 256)],
                         ids=["tiled_136", "padded_256"])
def test_train_als_above_cap_matches_reference(coo, data, k):
    jd, td = JDataset.from_coo(coo, **data), Dataset.from_coo(coo, **data)
    rng = np.random.default_rng(k)
    init = (rng.random((jd.user_map.num_entities, k)).astype(np.float32),
            np.zeros((jd.movie_map.num_entities, k), np.float32))
    layout = data["layout"]
    ref = j_train_als(jd, JConfig(rank=k, num_iterations=2, layout=layout,
                                  **JKW), warm_start=init)
    model = train_als(td, ALSConfig(rank=k, num_iterations=2, layout=layout),
                      device="cpu", warm_start=init)
    assert _rel(model.predict_dense(), ref.predict_dense()) < 1e-3


# -- the route ------------------------------------------------------------------

_GRAMS = ("gram_gather", "gram_tiles", "gram_tiles_dense_gather",
          "gram_tiles_dense")
_FUSED = ("gram_solve_gather", "gram_solve_tiles", "gram_solve_dense",
          "gram_solve_tiles_dense")
_PLAINS = tuple(f"{n}_plain" for n in _GRAMS + _FUSED) + ("gather_rows_plain",)


class _Spy:
    """Counts the calls of the half-steps' kernel wrappers and plain
    versions, calling through: the module attributes of ``ops.tiled``,
    ``ops.bucketed`` and ``ops.solve``, and the functions ``ops.tiled``'s
    chunk scans look up in ``_SCAN_KERNELS``."""

    def __init__(self, monkeypatch):
        self.calls = {}
        wrapped = {}
        targets = [(t_tiled, n) for n in _GRAMS + _FUSED + _PLAINS]
        targets += [(t_bucketed, n) for n in
                    ("gram_gather", "gram_tiles", "gram_solve_gather",
                     "gram_solve_tiles", "gram_gather_plain",
                     "gram_tiles_plain", "gram_solve_gather_plain",
                     "gram_solve_tiles_plain", "gather_rows_plain")]
        targets += [(t_solve, n) for n in
                    ("reg_solve", "reg_solve_plain", "spd_solve_plain",
                     "batched_spd_solve", "gauss_solve", "gauss_solve_multi")]
        for module, name in targets:
            fn = getattr(module, name)
            self.calls.setdefault(name, 0)
            wrapped[fn] = wrapped.get(fn) or self._wrap(name, fn)
            monkeypatch.setattr(module, name, wrapped[fn])
        monkeypatch.setattr(t_tiled, "_SCAN_KERNELS", {
            key: tuple(tuple(wrapped.get(f, f) for f in pair)
                       for pair in fns)
            for key, fns in t_tiled._SCAN_KERNELS.items()})

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return spy

    def called(self, names):
        return {n: self.calls[n] for n in names if self.calls[n]}


@pytest.mark.parametrize("gather", [None, False], ids=["gather_on",
                                                       "gather_off"])
def test_route_above_cap_takes_split_grams_and_cholesky(coo, monkeypatch,
                                                        gather):
    """solver="auto" (the kernel wrappers, which on CPU tensors run their
    plain versions): at k = 136 every layout's chunks and classes go
    through the split Gram wrappers and ``batched_spd_solve``, never K1, a
    fused Gram + solve kernel, a Gauss-Jordan solve or a plain version; at
    k = 128 the same calls take the parent's route: the fused kernels and
    K1, no ``batched_spd_solve``."""
    (_, _, _), (ttrees, tn) = _movie_buckets(coo)
    for k in (K, 128):
        spy = _Spy(monkeypatch)
        for mode in ("accum", "stream", "dstream"):
            _port_tiled(coo, mode, k, in_kernel_gather=gather)
        fixed = T(_fixed("accum", k))
        als_half_step_bucketed(fixed, ttrees, tn, LAM,
                               in_kernel_gather=gather)
        grams = ("gram_tiles", "gram_tiles_dense") if gather is False else (
            "gram_gather", "gram_tiles_dense_gather")
        assert not spy.called(_PLAINS + ("reg_solve_plain", "spd_solve_plain",
                                         "gauss_solve", "gauss_solve_multi"))
        if k == K:
            assert all(spy.calls[n] > 0 for n in grams)
            # the accumulator once, every stream and dense chunk, every class
            assert spy.calls["batched_spd_solve"] > 3
            assert not spy.called(_FUSED + ("reg_solve",))
        else:
            fused = ("gram_solve_tiles", "gram_solve_tiles_dense") \
                if gather is False else ("gram_solve_gather",
                                         "gram_solve_dense")
            assert all(spy.calls[n] > 0 for n in fused)
            # K1: the accumulator, and each width class the reference's
            # gate sends to its legacy schedule (einsum Gram, then K1)
            legacy = sum(not t_solve.class_supported(t, 128) for t in ttrees)
            assert spy.calls["reg_solve"] == 1 + legacy
            assert spy.calls["batched_spd_solve"] == 0
        monkeypatch.undo()


# -- the wrappers' caps -------------------------------------------------------

def _chunk(k, seed=0):
    rng = np.random.default_rng(seed)
    f, t, nt, s = 50, 8, 12, 3
    seg = np.sort(rng.integers(0, s, nt)).astype(np.int32)
    return (T(rng.standard_normal((f, k), dtype=np.float32)),
            dict(nb=T(rng.integers(0, f + 1, nt * t).astype(np.int32)),
                 wt=T(rng.random(nt * t, dtype=np.float32)),
                 rt=T(rng.standard_normal(nt * t, dtype=np.float32)),
                 seg=T(seg), num_segments=s, tile_rows=t))


def test_fused_wrappers_refuse_above_cap_split_accept_512():
    table, args = _chunk(129)
    reg = torch.ones(args["num_segments"])
    with pytest.raises(ValueError, match="gram_solve_gather supports rank"):
        gk.gram_solve_gather(table, **args, reg=reg, lseg=0)
    g = gk.gather_rows(table, args["nb"], args["wt"])
    plain = {n: v for n, v in args.items() if n not in ("nb", "wt")}
    with pytest.raises(ValueError, match="gram_solve_tiles supports rank"):
        gk.gram_solve_tiles(g, **plain, reg=reg, lseg=0)
    with pytest.raises(ValueError, match="reg_solve supports rank 1..128"):
        reg_solve(torch.eye(129).expand(2, 129, 129), torch.ones(2, 129),
                  torch.ones(2), lam=0.05)
    table, args = _chunk(512, 1)
    a, b = gk.gram_gather(table, **args)
    assert a.shape == (3, 512, 512) and b.shape == (3, 512)
    wa, wb = gk.gram_gather_plain(table, **args)
    assert torch.equal(a, wa) and torch.equal(b, wb)
    g = gk.gather_rows(table, args["nb"], args["wt"])
    plain = {n: v for n, v in args.items() if n not in ("nb", "wt")}
    assert torch.equal(gk.gram_tiles(g, **plain)[0], a)
