"""The split epilogue (``fused_epilogue=False``) on the bucketed layout and in
the ALS++/iALS++ sweeps, against the JAX package's same-knob runs, on the
CPU.

The JAX package's split bucket piece writes each width class's (A, b) to
memory (``gram_tiles_gather_pallas``, or ``gram_tiles_pallas`` with the
gather off) and solves it with K1's one pass (``cfk_tpu/ops/bucketed.py:
208-222``); its sweeps hand ``fused=False`` to their b×b solves, which then
take the ridge add and the split dispatch (``cfk_tpu/ops/subspace.py:
158-175``).  Both sides run with ``solver="pallas"`` on the JAX side
(interpret-mode kernels) and the port's CPU route (plain versions), from
the same numpy-seeded inputs.  Spies on the Gram and solve wrappers the
half-steps call (on CPU tensors each runs its plain version) show that
the port takes the split route and not the fused one.

Tolerances, relative to the largest |value| (the rule of
``test_torch_bucketed.py``): 1e-4 for a half-step, 1e-3 for predictions
after 3 iterations — float32 on both sides in different summation orders.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _bucketed_device_setup as j_bucketed_setup
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.models.ials import _one_iteration as j_one_iteration
from cfk_tpu.ops.solve import als_half_step_bucketed as j_als_bucketed
from cfk_tpu.ops.solve import ials_half_step_bucketed as j_ials_bucketed
from cfk_tpu.ops.subspace import als_pp_half_step_bucketed as j_als_pp_bkt
from cfk_tpu.ops.subspace import ials_pp_half_step_bucketed as j_ials_pp_bkt
from cfk_tpu_torch import ALSConfig, Dataset, factors_from_numpy, train_als
from cfk_tpu_torch.models.als import _bucketed_to_device
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops import bucketed as t_bucketed
from cfk_tpu_torch.ops import solve as t_solve
from cfk_tpu_torch.ops.solve import (
    als_half_step_bucketed,
    ials_half_step_bucketed,
)
from cfk_tpu_torch.ops.subspace import (
    als_pp_half_step_bucketed,
    ials_pp_half_step_bucketed,
)

K = 8
LAM, ALPHA = 0.05, 2.0
BUCKETED = dict(layout="bucketed", chunk_elems=256)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(400, 150, 5000, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = JDataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


@pytest.fixture(scope="module")
def movie_buckets(coo):
    jb = JDataset.from_coo(coo, **BUCKETED).movie_blocks
    tb = Dataset.from_coo(coo, **BUCKETED).movie_blocks
    trees, chunks = jb.to_tree()
    jtrees = tuple({k: jnp.asarray(v) for k, v in t.items()} for t in trees)
    ttrees, tchunks = _bucketed_to_device(tb, torch.device("cpu"))
    return (jtrees, chunks, jb.padded_entities), (ttrees, tchunks,
                                                  tb.padded_entities)


class _Spy:
    """Counts the calls of module attributes, calling through."""

    def __init__(self, monkeypatch, targets):
        self.calls = {}
        for module, name in targets:
            fn = getattr(module, name)
            self.calls[name] = 0
            monkeypatch.setattr(module, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            self.calls[name] += 1
            return fn(*args, **kwargs)
        return spy


def _bucket_spy(monkeypatch):
    return _Spy(monkeypatch, [
        (t_bucketed, "gram_gather"), (t_bucketed, "gram_tiles"),
        (t_bucketed, "gram_solve_gather"), (t_bucketed, "gram_solve_tiles"),
        (t_solve, "reg_solve"), (t_solve, "gauss_solve")])


@pytest.mark.parametrize("gather", [None, False], ids=["gather_on",
                                                       "gather_off"])
@pytest.mark.parametrize("implicit", [False, True], ids=["als", "ials"])
def test_bucketed_half_step_split_matches_reference(movie_buckets, u0,
                                                    monkeypatch, gather,
                                                    implicit):
    (jtrees, jchunks, jn), (ttrees, _, tn) = movie_buckets
    knobs = dict(fused_epilogue=False, in_kernel_gather=gather)
    if implicit:
        want = j_ials_bucketed(jnp.asarray(u0), jtrees, jchunks, jn, LAM,
                               ALPHA, solver="pallas", **knobs)
    else:
        want = j_als_bucketed(jnp.asarray(u0), jtrees, jchunks, jn, LAM,
                              solver="pallas", **knobs)
    spy = _bucket_spy(monkeypatch)
    fixed = torch.as_tensor(u0)
    if implicit:
        got = ials_half_step_bucketed(fixed, ttrees, tn, LAM, ALPHA, **knobs)
    else:
        got = als_half_step_bucketed(fixed, ttrees, tn, LAM, **knobs)
    assert _rel(got, want) < 1e-4
    # The split route: one Gram to memory and one K1 solve per width
    # class, no fused Gram + solve, no Gauss-Jordan dispatch; a class the
    # reference's gate refuses (the 8-wide one) takes its legacy schedule,
    # an einsum Gram and the same one K1 solve.
    gram = "gram_tiles" if gather is False else "gram_gather"
    n = len(ttrees)
    kernel_route = sum(t_solve.class_supported(t, K) for t in ttrees)
    assert 0 < kernel_route < n
    assert spy.calls[gram] == kernel_route and spy.calls["reg_solve"] == n
    assert spy.calls["gram_solve_gather"] == 0
    assert spy.calls["gram_solve_tiles"] == 0
    assert spy.calls["gauss_solve"] == 0
    # The fused route from the same start solves the same normal
    # equations: the knob moves only where the Gram lives.
    fused = (ials_half_step_bucketed(fixed, ttrees, tn, LAM, ALPHA,
                                     in_kernel_gather=gather) if implicit
             else als_half_step_bucketed(fixed, ttrees, tn, LAM,
                                         in_kernel_gather=gather))
    assert torch.equal(got, fused)
    assert spy.calls["gram_solve_tiles" if gather is False
                     else "gram_solve_gather"] == kernel_route


@pytest.mark.parametrize("implicit", [False, True], ids=["als", "ials"])
def test_bucketed_sweeps_split_matches_reference(movie_buckets, u0,
                                                 monkeypatch, implicit):
    (jtrees, jchunks, jn), (ttrees, tchunks, tn) = movie_buckets
    x0 = np.random.default_rng(7).standard_normal((jn, K)).astype(np.float32)
    kw = dict(block_size=4, sweeps=2, fused_epilogue=False)
    if implicit:
        want = j_ials_pp_bkt(jnp.asarray(u0), jnp.asarray(x0), jtrees,
                             jchunks, jn, LAM, ALPHA, solver="pallas", **kw)
    else:
        want = j_als_pp_bkt(jnp.asarray(u0), jnp.asarray(x0), jtrees,
                            jchunks, jn, LAM, solver="pallas", **kw)
    spy = _bucket_spy(monkeypatch)
    args = (torch.as_tensor(u0), torch.as_tensor(x0), ttrees, tchunks, tn,
            LAM)
    if implicit:
        got = ials_pp_half_step_bucketed(*args, ALPHA, **kw)
    else:
        got = als_pp_half_step_bucketed(*args, **kw)
    assert _rel(got, want) < 1e-4
    # Each b×b solve takes the ridge add and the Gauss-Jordan dispatch
    # (b = 4 ≤ 64), never K1: k/b blocks × sweeps per width class piece.
    assert spy.calls["gauss_solve"] > 0
    assert spy.calls["reg_solve"] == 0


def test_train_als_bucketed_split_matches_reference(coo, u0):
    jd, td = JDataset.from_coo(coo, **BUCKETED), Dataset.from_coo(coo,
                                                                 **BUCKETED)
    init = (u0, np.zeros((150, K), np.float32))
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=3,
                                  layout="bucketed", solver="pallas",
                                  fused_epilogue=False), warm_start=init)
    got = train_als(td, ALSConfig(rank=K, num_iterations=3,
                                  layout="bucketed", fused_epilogue=False),
                    device="cpu", warm_start=init)
    assert _rel(got.predict_dense(), ref.predict_dense()) < 1e-3


def test_train_ialspp_bucketed_split_matches_reference(coo, u0):
    jd, td = JDataset.from_coo(coo, **BUCKETED), Dataset.from_coo(coo,
                                                                 **BUCKETED)
    mb, ub, _, kw = j_bucketed_setup(jd)
    u = jnp.zeros((jd.user_blocks.padded_entities, K),
                  jnp.float32).at[:u0.shape[0]].set(u0)
    m = jnp.zeros((jd.movie_blocks.padded_entities, K), jnp.float32)
    for _ in range(3):
        u, m = j_one_iteration(u, m, mb, ub, lam=LAM, alpha=ALPHA,
                               dtype="float32", solver="pallas",
                               algorithm="ials++", block_size=4,
                               fused_epilogue=False, **kw)
    ref = factors_from_numpy(np.asarray(u), np.asarray(m),
                             num_users=jd.user_map.num_entities,
                             num_movies=150, device="cpu")
    cfg = IALSConfig(rank=K, lam=LAM, alpha=ALPHA, num_iterations=3,
                     layout="bucketed", algorithm="ials++", block_size=4,
                     fused_epilogue=False)
    got = train_ials(td, cfg, device="cpu",
                     warm_start=(u0, np.zeros((150, K), np.float32)))
    assert _rel(got.predict_dense(), ref.predict_dense()) < 1e-3
