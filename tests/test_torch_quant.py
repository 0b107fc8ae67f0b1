"""Quantized training in the port (``ALSConfig.table_dtype``, ``dtype``)
against cfk_tpu, on the CPU, with the two repairs it came with
(``reg_solve_algo`` routing, the bucketed gather-off stream bounded by the
blocks' ``chunk_rows``).

The port is held to one named route of the JAX package, its knobs-off
route (``in_kernel_gather=False, fused_epilogue=False, solver="cholesky"``),
never to a cross-route bit-equality of the reference, each call compiled
once with ``jax.jit``; its grouped tile Gram (``gram_tiles_pallas``) runs
its XLA emulation twin, as it does on installs without the typed-vma
system, rather than the much slower Pallas interpreter (the same sums).
On the port's side
the gather knob must change no bit at any table dtype: each gather plain
version is ``gather_rows_plain`` followed by its stream twin's, as in the
reference's own contract (``tests/test_quant_table.py``).  The kernels run
in ``test_torch_gpu.py`` on the card.

Tolerances, relative to the largest |value|: 0 for the quantization
arrays (the same casts and roundings); 1e-4 for one half-step at rank 8
(float32 sums of the same bf16 or dequantized rows in another order, and
another Cholesky); 1e-2 for factors after two bf16-stored iterations (each
stored half rounds to bf16, 2^-9 relative, and the roundings compound).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cfk_tpu.config import ALSConfig as JConfig
from cfk_tpu.data.blocks import Dataset as JDataset
from cfk_tpu.data.blocks import RatingsCOO as JCOO
from cfk_tpu.data.blocks import build_tiled_blocks as j_build_tiled
from cfk_tpu.data.synthetic import synthetic_netflix_coo
from cfk_tpu.models.als import _half as j_half
from cfk_tpu.models.als import _segment_to_device as j_segment_to_device
from cfk_tpu.models.als import _tiled_to_device as j_tiled_to_device
from cfk_tpu.models.als import train_als as j_train_als
from cfk_tpu.ops import quant as jquant
from cfk_tpu.ops.solve import als_half_step as j_als_half_step
from cfk_tpu.ops.solve import als_half_step_bucketed as j_als_bucketed
from cfk_tpu.ops.solve import ials_half_step_bucketed as j_ials_bucketed
from cfk_tpu.ops.tiled import tiled_half_step as j_tiled_half_step
from cfk_tpu_torch import ALSConfig, Dataset, train_als
from cfk_tpu_torch.cli import main
from cfk_tpu_torch.data.blocks import build_tiled_blocks
from cfk_tpu_torch.eval.metrics import mse_rmse_from_model
from cfk_tpu_torch.models.als import (
    _bucketed_to_device,
    _half,
    _segment_to_device,
    _tiled_to_device,
)
from cfk_tpu_torch.models.ials import IALSConfig, train_ials
from cfk_tpu_torch.ops import quant
from cfk_tpu_torch.ops import solve as port_solve
from cfk_tpu_torch.ops.solve import (
    als_half_step,
    als_half_step_bucketed,
    ials_half_step_bucketed,
)
from cfk_tpu_torch.ops.tiled import ials_tiled_half_step, tiled_half_step

CPU = torch.device("cpu")
K = 8
LAM, ALPHA = 0.05, 2.0
T = torch.as_tensor
KNOBS_OFF = dict(solver="cholesky", in_kernel_gather=False,
                 fused_epilogue=False)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got = np.asarray(got, np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(x):
    """A JAX array or tensor as float32-or-int8 numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.float() if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One PyTorch intra-op thread for these small products: the suite runs
    files in parallel workers, where each worker's spinning thread pool,
    oversubscribed across them, slowed this file twentyfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _reference_tile_gram_emulated():
    import cfk_tpu.ops.pallas.gram_kernel as jgk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgk, "has_vma_system", lambda: False)
        yield


def _jit(fn, *args, **statics):
    """``fn(*args, **statics)`` compiled once, the statics bound."""
    return jax.jit(functools.partial(fn, **statics))(*args)


def _eager(fn, *args, **statics):
    """``fn(*args, **statics)`` run op by op.  For bf16 iALS: the
    reference's program rounds each weighted product (c−1)·f to bf16
    (``cfk_tpu/ops/solve.py:_gram_compute_dtype``), and compiled with
    ``jax.jit`` XLA's default excess precision keeps those products in
    float32 instead (5.5e-4 of max|x| apart on the 8-wide class of the
    fixture), so the half-steps that reach its legacy schedule with a bf16
    table are held to the program as written."""
    with jax.disable_jit():
        return fn(*args, **statics)


NM, NU = 80, 200


@pytest.fixture(scope="module")
def coo():
    return synthetic_netflix_coo(NU, NM, 2500, seed=9)


@pytest.fixture(scope="module")
def u0(coo):
    n = JDataset.from_coo(coo).user_map.num_entities
    return np.random.default_rng(1).random((n, K)).astype(np.float32)


# -- ops.quant: the same arrays as the reference's ---------------------------

def test_quantize_fold_and_view_bit_equal_to_reference():
    rng = np.random.default_rng(3)
    t = rng.standard_normal((37, K)).astype(np.float32)
    t[5] = 0.0  # all-zero row: scale 1
    t[9, 2] = np.nan  # a corrupt row keeps a NaN scale
    nb = rng.integers(0, 38, 200).astype(np.int32)  # 37 = the zero row
    wt = rng.random(200).astype(np.float32)
    for td in ("float32", "bfloat16", "int8"):
        jd, js = jquant.quantize_table(jnp.asarray(t), td)
        pd, ps = quant.quantize_table(T(t), td)
        np.testing.assert_array_equal(_np(pd), _np(jd))
        assert (ps is None) == (js is None)
        if ps is not None:
            np.testing.assert_array_equal(_np(ps), _np(js))
            assert np.isnan(_np(ps)[9])
        np.testing.assert_array_equal(
            _np(quant.gather_operand_view(T(t), td)),
            _np(jquant.gather_operand_view(jnp.asarray(t), td)))
        np.testing.assert_array_equal(
            _np(quant.fold_scale(T(wt), ps, T(nb))),
            _np(jquant.fold_scale(jnp.asarray(wt), js, jnp.asarray(nb))))
    _, scale = quant.quantize_table(T(t), "int8")
    assert quant.fold_scale(T(wt), scale, T(nb))[nb == 37].eq(0).all()


@pytest.mark.parametrize("layout", ["padded", "segment"])
def test_int8_refused_on_padded_and_segment_with_the_reference_message(
        layout):
    with pytest.raises(ValueError) as port:
        ALSConfig(layout=layout, table_dtype="int8")
    with pytest.raises(ValueError) as ref:
        JConfig(layout=layout, table_dtype="int8")
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as port:
        quant.validate_table_dtype_layout("int8", layout)
    with pytest.raises(ValueError) as ref:
        jquant.validate_table_dtype_layout("int8", layout)
    assert str(port.value) == str(ref.value)
    ALSConfig(layout=layout, table_dtype="bfloat16")
    with pytest.raises(ValueError, match="table_dtype must be"):
        ALSConfig(table_dtype="fp8")


# -- half-steps against the reference's knobs-off route ----------------------

def _tiled_args(coo, mode):
    d = JDataset.from_coo(coo).coo_dense
    if mode == "accum":
        return ((d.movie_raw, d.user_raw, d.rating, NM, NU),
                dict(tile_rows=16, chunk_elems=512, slice_rows=128))
    return ((d.user_raw, d.movie_raw, d.rating, NU, NM),
            dict(tile_rows=16, chunk_elems=512, accum_max_entities=100,
                 dense_stream=mode == "dstream"))


@pytest.mark.parametrize("mode", ["accum", "stream", "dstream"])
@pytest.mark.parametrize("td", ["bfloat16", "int8"])
def test_tiled_half_step_matches_reference(coo, mode, td):
    """One explicit half-step of each tiled mode with a quantized table:
    within 1e-4 of the reference's knobs-off route; the port's gather-off
    route bit-equal to its default (gather on, fused), its split route
    within 1e-5 (the same sums, K1's solve), and the iALS half-step's gather
    routes bit-equal too."""
    args, kw = _tiled_args(coo, mode)
    n = args[4]
    fixed = np.random.default_rng(len(mode)).random((n, K)).astype(
        np.float32)
    jb = j_build_tiled(*args, **kw)
    chunks = ("tiled", jb.mode) + jb.statics
    want = _jit(j_tiled_half_step, jnp.asarray(fixed), j_tiled_to_device(jb),
                chunks=chunks, local_entities=jb.padded_entities, lam=LAM,
                table_dtype=td, overlap=False, **KNOBS_OFF)
    tb = build_tiled_blocks(*args, **kw)
    assert tb.mode == mode
    blk = _tiled_to_device(tb, CPU, n, weighted=True)
    got = {}
    for gather, fused in ((None, None), (False, None), (False, False)):
        got[gather, fused] = tiled_half_step(
            T(fixed), blk, chunks, tb.padded_entities, LAM, table_dtype=td,
            in_kernel_gather=gather, fused_epilogue=fused)
    assert got[None, None].dtype == torch.float32
    assert _rel(got[None, None], want) < 1e-4
    assert torch.equal(got[None, None], got[False, None])
    assert _rel(got[False, False], got[None, None]) < 1e-5
    on, off = (ials_tiled_half_step(T(fixed), blk, chunks,
                                    tb.padded_entities, LAM, ALPHA,
                                    table_dtype=td, in_kernel_gather=g)
               for g in (None, False))
    assert torch.equal(on, off) and torch.isfinite(on).all()


@pytest.mark.parametrize("td", ["bfloat16", "int8"])
@pytest.mark.parametrize("implicit", [False, True])
def test_bucketed_half_step_matches_reference(coo, u0, td, implicit):
    """One bucketed half-step (chunk_rows pieces on the gather-off route)
    with a quantized table, at the default ``pad_multiple`` (an 8-wide
    class): within 1e-4 of the reference's knobs-off route; the port's
    gather on and off bit-equal."""
    kw = dict(layout="bucketed", chunk_elems=256)
    jb = JDataset.from_coo(coo, **kw).movie_blocks
    tb = Dataset.from_coo(coo, **kw).movie_blocks
    trees, jchunks = jb.to_tree()
    jtrees = tuple({k: jnp.asarray(v) for k, v in t.items()} for t in trees)
    ttrees, chunks = _bucketed_to_device(tb, CPU)
    if implicit:
        want = (_eager if td == "bfloat16" else _jit)(
            j_ials_bucketed, jnp.asarray(u0), jtrees, chunk_rows=jchunks,
            local_entities=jb.padded_entities, lam=LAM, alpha=ALPHA,
            table_dtype=td, overlap=False, **KNOBS_OFF)
        run = lambda g: ials_half_step_bucketed(  # noqa: E731
            T(u0), ttrees, tb.padded_entities, LAM, ALPHA, chunk_rows=chunks,
            table_dtype=td, in_kernel_gather=g)
    else:
        want = _jit(j_als_bucketed, jnp.asarray(u0), jtrees,
                    chunk_rows=jchunks, local_entities=jb.padded_entities,
                    lam=LAM, table_dtype=td, overlap=False, **KNOBS_OFF)
        run = lambda g: als_half_step_bucketed(  # noqa: E731
            T(u0), ttrees, tb.padded_entities, LAM, chunk_rows=chunks,
            table_dtype=td, in_kernel_gather=g)
    on, off = run(None), run(False)
    assert _rel(on, want) < 1e-4
    assert torch.equal(on, off)


def test_bf16_ials_narrow_bucketed_class_matches_reference(coo, u0):
    """At the default ``pad_multiple`` (8) the 8-wide width class is one the
    reference's gate refuses (``bucket_port_supported``: width < 16), so
    both packages run it on the legacy schedule — a gather and an einsum
    that round (c−1)·f to bf16 — and the wider classes on the tiled-kernel
    route, which rounds √(α·r)·f: every entity within 1e-4 of max|x| of the
    reference's knobs-off route, the narrow class's and the wider ones'
    (the reference run op by op, ``_eager``; the legacy route's Gram is
    symmetric only to bf16 rounding, and both packages solve its
    symmetric part)."""
    from cfk_tpu_torch.ops.bucketed import bucket_port_supported

    kw = dict(layout="bucketed", chunk_elems=256)
    jb = JDataset.from_coo(coo, **kw).movie_blocks
    tb = Dataset.from_coo(coo, **kw).movie_blocks
    assert min(b.width for b in tb.buckets) == 8
    assert not bucket_port_supported(1, 8, K)
    assert bucket_port_supported(1, 16, K)
    trees, jchunks = jb.to_tree()
    jtrees = tuple({k: jnp.asarray(v) for k, v in t.items()} for t in trees)
    ttrees, chunks = _bucketed_to_device(tb, CPU)
    want = np.asarray(_eager(
        j_ials_bucketed, jnp.asarray(u0), jtrees, chunk_rows=jchunks,
        local_entities=jb.padded_entities, lam=LAM, alpha=ALPHA,
        table_dtype="bfloat16", overlap=False, **KNOBS_OFF), np.float64)
    got = ials_half_step_bucketed(
        T(u0), ttrees, tb.padded_entities, LAM, ALPHA, chunk_rows=chunks,
        table_dtype="bfloat16").double().numpy()
    err = np.abs(got - want).max(1) / np.abs(want).max()
    narrow = np.concatenate([b.entity_local for b in tb.buckets
                             if b.width < 16])
    wide = np.concatenate([b.entity_local for b in tb.buckets
                           if b.width >= 16])
    narrow = narrow[narrow < tb.padded_entities]
    wide = wide[wide < tb.padded_entities]
    assert narrow.size and wide.size
    assert err[wide].max() < 1e-4
    assert err[narrow].max() < 1e-4


@pytest.mark.parametrize("layout", ["padded", "segment"])
def test_bf16_padded_and_segment_half_steps_match_reference(coo, u0, layout):
    """The padded and segment layouts take the bf16 view of the table (the
    models' ``_half``) and form their Grams from bf16 operands."""
    kw = dict(layout="segment") if layout == "segment" else {}
    jd, td = JDataset.from_coo(coo, **kw), Dataset.from_coo(coo, **kw)
    jm, tm = jd.movie_blocks, td.movie_blocks
    half = dict(lam=LAM, solve_chunk=None, table_dtype="bfloat16")
    if layout == "segment":
        want = _jit(j_half, jnp.asarray(u0), j_segment_to_device(jm),
                    chunks=jm.statics, entities=jm.padded_entities,
                    solver="cholesky", **half)
        got = _half(T(u0), _segment_to_device(tm, CPU), chunks=tm.statics,
                    entities=tm.padded_entities, solver="auto", **half)
    else:
        blk = {f: getattr(jm, f) for f in ("neighbor_idx", "rating", "mask",
                                           "count")}
        want = _jit(j_half, jnp.asarray(u0),
                    {k: jnp.asarray(v) for k, v in blk.items()},
                    solver="cholesky", **half)
        got = _half(T(u0), {k: T(getattr(tm, k)) for k in blk},
                    solver="auto", **half)
    assert _rel(got, want) < 1e-4


# -- trainers -----------------------------------------------------------------

def _planted(seed=0, nm=48, nu=80, nnz=1800):
    """The reference's planted fixture (``tests/test_quant_table.py``)."""
    rng = np.random.default_rng(seed)
    u0 = rng.standard_normal((nu, 4))
    m0 = rng.standard_normal((nm, 4))
    mi = rng.integers(0, nm, nnz)
    ui = rng.integers(0, nu, nnz)
    r = np.clip((u0[ui] * m0[mi]).sum(1) * 0.5 + 3.0
                + 0.2 * rng.standard_normal(nnz), 1, 5)
    return JCOO(movie_raw=(mi + 1).astype(np.int64),
                user_raw=(ui + 1).astype(np.int64),
                rating=r.astype(np.float32))


def test_quantized_rmse_contract_planted():
    """The reference's contract on its planted fixture: train RMSE with a
    bf16 table within 1.01× of f32's, with int8 within 1.10×."""
    ds = Dataset.from_coo(_planted(), layout="tiled", chunk_elems=1024,
                          tile_rows=16, accum_max_entities=0)
    cfg = ALSConfig(rank=8, lam=0.05, num_iterations=4, seed=0,
                    layout="tiled")
    rmse = {td: mse_rmse_from_model(train_als(
        ds, dataclasses.replace(cfg, table_dtype=td), device="cpu"), ds)[1]
        for td in ("float32", "bfloat16", "int8")}
    assert rmse["bfloat16"] <= rmse["float32"] * 1.01, rmse
    assert rmse["int8"] <= rmse["float32"] * 1.10, rmse


@pytest.mark.parametrize("td", ["float32", "bfloat16", "int8"])
def test_trainers_gather_on_and_off_bit_equal(coo, u0, td):
    """ALS (tiled, dense stream) and iALS (bucketed, chunk_rows pieces off)
    with each table dtype, one iteration (both halves): the gather knob
    changes no bit."""
    tiled = Dataset.from_coo(coo, layout="tiled", chunk_elems=512,
                             accum_max_entities=200, tile_rows=16,
                             dense_stream=True)
    bucketed = Dataset.from_coo(coo, layout="bucketed", chunk_elems=256)
    m0 = np.zeros((NM, K), np.float32)
    for ds, layout, make, train in (
            (tiled, "tiled", ALSConfig, train_als),
            (bucketed, "bucketed", IALSConfig, train_ials)):
        runs = [train(ds, make(rank=K, num_iterations=1, table_dtype=td,
                               layout=layout, in_kernel_gather=g),
                      device="cpu", warm_start=(u0, m0))
                for g in (None, False)]
        assert torch.equal(runs[0].user_factors, runs[1].user_factors)
        assert torch.equal(runs[0].movie_factors, runs[1].movie_factors)


def test_bf16_storage_training_matches_reference(coo, u0):
    """``dtype="bfloat16"``: factors stored bf16 (the next half gathers bf16
    rows), Gram and solve float32 — within 1e-2 of the reference's run from
    the same start; a bf16 warm start is taken as it is."""
    kw = dict(layout="tiled", chunk_elems=512, accum_max_entities=200,
              tile_rows=16, dense_stream=True)
    jd, td = JDataset.from_coo(coo, **kw), Dataset.from_coo(coo, **kw)
    m0 = np.zeros((NM, K), np.float32)
    ref = j_train_als(jd, JConfig(rank=K, num_iterations=2, layout="tiled",
                                  dtype="bfloat16"), warm_start=(u0, m0))
    cfg = ALSConfig(rank=K, num_iterations=2, layout="tiled",
                    dtype="bfloat16")
    got = train_als(td, cfg, device="cpu", warm_start=(u0, m0))
    assert got.user_factors.dtype == torch.bfloat16
    assert _rel(got.predict_dense(), ref.predict_dense()) < 1e-2
    jnp_bf16 = np.asarray(jnp.asarray(u0, jnp.bfloat16))
    again = train_als(td, cfg, device="cpu", warm_start=(jnp_bf16, m0))
    assert torch.equal(again.user_factors, got.user_factors)


# -- repair 1: reg_solve_algo routes on the reference's cap -------------------

def test_reg_solve_algo_gj_takes_the_split_route(coo, u0, monkeypatch):
    """At k = 96 "gj" (cap 64) sends the solve to the split schedule's
    blocked Schur solve, "lu" (cap 128) keeps it fused; both match the
    reference's run of the same name (its knobs-off route)."""
    k = 96
    calls = []
    real = port_solve.blocked_spd_solve
    monkeypatch.setattr(port_solve, "blocked_spd_solve",
                        lambda a, b: calls.append(a.shape) or real(a, b))
    jm, tm = (JDataset.from_coo(coo).movie_blocks,
              Dataset.from_coo(coo).movie_blocks)
    fixed = np.random.default_rng(k).random((u0.shape[0], k)).astype(
        np.float32)
    for algo in ("gj", "lu"):
        calls.clear()
        want = _jit(j_als_half_step, jnp.asarray(fixed),
                    jnp.asarray(jm.neighbor_idx), jnp.asarray(jm.rating),
                    jnp.asarray(jm.mask), jnp.asarray(jm.count), lam=0.5,
                    solver="cholesky", reg_solve_algo=algo)
        got = als_half_step(T(fixed), T(tm.neighbor_idx), T(tm.rating),
                            T(tm.mask), T(tm.count), 0.5,
                            reg_solve_algo=algo)
        assert len(calls) == (1 if algo == "gj" else 0)
        assert _rel(got, want) < 1e-4


# -- repair 2: the bucketed gather-off stream bounded by chunk_rows -----------

@pytest.mark.parametrize("td", ["float32", "bfloat16"])
def test_bucketed_gather_off_pieces_bit_equal_and_bounded(coo, u0, td,
                                                          monkeypatch):
    """With the gather off, each width class is walked in the blocks'
    chunk_rows pieces: the factors equal a whole-class walk's bit for bit,
    and no K5 stream holds more than chunk·width rows."""
    from cfk_tpu_torch.ops import bucketed

    ds = Dataset.from_coo(coo, layout="bucketed", chunk_elems=256)
    blocks = ds.movie_blocks
    trees, chunks = _bucketed_to_device(blocks, CPU)
    assert any(c is not None and c < t["neighbor"].shape[0]
               for c, t in zip(chunks, trees))
    streams = []
    real = bucketed.gather_rows
    monkeypatch.setattr(bucketed, "gather_rows",
                        lambda t, nb, wt, *a: streams.append(nb.numel())
                        or real(t, nb, wt, *a))
    kw = dict(table_dtype=td, in_kernel_gather=False)
    whole = als_half_step_bucketed(T(u0), trees, blocks.padded_entities,
                                   LAM, **kw)
    assert max(streams) == max(t["neighbor"].numel() for t in trees)
    streams.clear()
    pieces = als_half_step_bucketed(T(u0), trees, blocks.padded_entities,
                                    LAM, chunk_rows=chunks, **kw)
    bound = max((c or t["neighbor"].shape[0]) * t["neighbor"].shape[1]
                for c, t in zip(chunks, trees))
    assert len(streams) > len(trees) and max(streams) <= bound
    assert torch.equal(whole, pieces)
    iw, ip = (ials_half_step_bucketed(T(u0), trees, blocks.padded_entities,
                                      LAM, ALPHA, chunk_rows=c, **kw)
              for c in (None, chunks))
    assert torch.equal(iw, ip)


# -- the CLI --------------------------------------------------------------------

@pytest.fixture(scope="module")
def ratings_file(tmp_path_factory):
    coo = synthetic_netflix_coo(300, 60, 3000, seed=4)
    path = tmp_path_factory.mktemp("quant_cli") / "ratings.txt"
    with open(path, "w") as f:
        for mid in np.unique(coo.movie_raw):
            f.write(f"{mid}:\n")
            sel = coo.movie_raw == mid
            for uid, r in zip(coo.user_raw[sel], coo.rating[sel]):
                f.write(f"{uid},{int(r)},2005-09-06\n")
    return str(path)


def _fields(out: str) -> dict:
    return dict(kv.split("=", 1) for kv in out.split() if "=" in kv)


@pytest.mark.parametrize("flags", [
    ["--table-dtype", "int8", "--layout", "tiled"],
    ["--dtype", "bfloat16"],
    ["--reg-solve-algo", "gj", "--layout", "bucketed"],
])
def test_cli_quantized_training(ratings_file, tmp_path, capsys, flags):
    ckpt = str(tmp_path / "ckpt")
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "2", "--chunk-elems", "512", "--device",
                 "cpu", "--output", "none", "--checkpoint-dir", ckpt,
                 *flags]) == 0
    fields = _fields(capsys.readouterr().out)
    assert float(fields["rmse"]) < 1.5
    if "--dtype" not in flags:
        return
    # A bf16 checkpoint restores as bf16; serving reads it as float32.
    assert main(["recommend", "--checkpoint-dir", ckpt, "--data",
                 ratings_file, "--users", "all", "-k", "3", "--device",
                 "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(len(x.split("\t")[1].split(",")) == 3
                         for x in lines)
    preds = str(tmp_path / "preds.csv")
    assert main(["predict", "--checkpoint-dir", ckpt, "--data", ratings_file,
                 "--output", preds, "--device", "cpu"]) == 0
    assert main(["evaluate", ratings_file, preds]) == 0
    mse = float(capsys.readouterr().out.split("MSE:")[1].split()[0])
    assert abs(mse - float(fields["mse"])) <= 1e-5 * mse
    assert main(["serve", "--checkpoint-dir", ckpt, "--data", ratings_file,
                 "-k", "5", "--tile-m", "64", "--loadgen-qps", "400",
                 "--loadgen-requests", "64", "--device", "cpu"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["answered"] == row["requests"] == 64


def test_cli_refuses_int8_on_the_padded_layout(ratings_file, capsys):
    assert main(["train", "--data", ratings_file, "--rank", "4",
                 "--iterations", "1", "--table-dtype", "int8", "--layout",
                 "padded", "--device", "cpu", "--output", "none"]) != 0
    assert "table_dtype='int8' supports" in capsys.readouterr().err
