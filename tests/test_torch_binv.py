"""The block-inverse solve path (rows 14 and 15 of the TPU kernel table)
against the JAX prototype ``scripts/exp_binv.py``, on the CPU.

The prototype is loaded by path and run in interpret mode
(``binv_solve_reg(..., interpret=True)``, ``xla_binv_solve_reg(...,
interpret=True)``, ``_pallas_inv(..., interpret=True)``); the port runs its
plain PyTorch versions (``ops.kernels.binv_kernel``) and its counterpart
script (``cfk_tpu_torch.scripts.exp_binv``) on CPU tensors.  Inputs are the
prototype's (rank-k/8 Grams plus λ·max(n, 1)·I, numpy seed), and for the
matrix mode one shared SPD ridge; E = 200 and 130 are not multiples of the
prototype's tile of 128, so its identity padding is exercised.

Tolerance: the same recursion in float32 on both sides, the matrix
products summed in other orders (XLA's dots against PyTorch's), so the two
differ by rounding times the systems' condition numbers (~1e3 here: a
rank-k/8 Gram held up by a ridge of λ·n ≥ 0.05).  Each side's solve is
itself that far from a float64 solve — on the diag inputs below the
prototype's error is 1.37e-5 (k = 32) and 1.33e-5 (k = 64) of max|x|, the
port's 1.53e-5 and 1.80e-5, and the two differ by 1.9e-5 and 2.5e-5 — so
solves are held to 5e-5 of max|x|, against each other and against float64.
The explicit inverse has no refinement step: its entries carry the full
cond·ε (the n = 32 inverses differ by 3.0e-5 of max|A⁻¹|), held to 1e-4.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu_torch.ops.kernels.binv_kernel import (
    binv_inv,
    binv_solve_reg,
    block_inverse_plain,
    leaf_inverse_plain,
    recursion_accepts,
)
from cfk_tpu_torch.scripts import exp_binv as port

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "exp_binv_prototype", os.path.join(_ROOT, "scripts", "exp_binv.py"))
proto = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(proto)

LAM = 0.05
TOL = 5e-5  # solves, relative to max|x|
INV_TOL = 1e-4  # explicit inverses, relative to max|A⁻¹|
T = torch.as_tensor


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(k, e, reg_mode):
    a, b, cnt = port.make_inputs(k, e, seed=k + e)
    if reg_mode == "diag":
        return a, b, cnt
    rng = np.random.default_rng(3)
    y = rng.standard_normal((4 * k, k)).astype(np.float32)
    reg = (y.T @ y / (4 * k) + LAM * np.eye(k)).astype(np.float32)
    return a, b, reg


def _float64_solve(a, b, reg, reg_mode):
    a = a.astype(np.float64)
    if reg_mode == "diag":
        a = a + (LAM * np.maximum(reg, 1))[:, None, None] * np.eye(a.shape[-1])
    else:
        a = a + reg.astype(np.float64)
    return np.linalg.solve(a, b.astype(np.float64)[..., None])[..., 0]


@pytest.mark.parametrize("k,e", [(32, 200), (64, 130)])
@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
def test_binv_solve_reg_matches_prototype(k, e, reg_mode):
    a, b, reg = _inputs(k, e, reg_mode)
    want = np.asarray(proto.binv_solve_reg(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(reg), reg_mode=reg_mode,
        lam=LAM, interpret=True))
    got = binv_solve_reg(T(a), T(b), T(reg), lam=LAM, reg_mode=reg_mode)
    assert got.shape == (e, k) and got.dtype == torch.float32
    assert _rel(got, want) < TOL
    assert _rel(got, _float64_solve(a, b, reg, reg_mode)) < TOL


@pytest.mark.parametrize("k,e", [(32, 200), (64, 130)])
@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
def test_xla_binv_solve_reg_matches_prototype(k, e, reg_mode):
    a, b, reg = _inputs(k, e, reg_mode)
    want = np.asarray(proto.xla_binv_solve_reg(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(reg), reg_mode=reg_mode,
        lam=LAM, interpret=True))
    got = port.xla_binv_solve_reg(T(a), T(b), T(reg), reg_mode=reg_mode,
                                  lam=LAM)
    assert _rel(got, want) < TOL
    # Both routes run the same recursion: at k = 32 the Schur route is one
    # leaf call of the same function, so the two agree bit for bit.
    fused = binv_solve_reg(T(a), T(b), T(reg), lam=LAM, reg_mode=reg_mode)
    if k == 32:
        assert torch.equal(got, fused)
    else:
        assert _rel(got, fused) < TOL


def test_leaf_inverse_matches_prototype():
    a, _, cnt = port.make_inputs(16, 40, seed=5)
    a = a + (LAM * cnt)[:, None, None] * np.eye(16, dtype=np.float32)
    want = np.asarray(proto._leaf_inverse(jnp.asarray(a), 16))
    got = leaf_inverse_plain(T(a))
    assert _rel(got, want) < INV_TOL
    assert torch.equal(block_inverse_plain(T(a)), got)  # n = 16 is a leaf


def test_binv_inv_matches_prototype_pallas_inv():
    n, e = 32, 150
    a, _, cnt = port.make_inputs(n, e, seed=6)
    a = a + (LAM * cnt)[:, None, None] * np.eye(n, dtype=np.float32)
    want = np.asarray(proto._pallas_inv(jnp.asarray(a), interpret=True))
    got = binv_inv(T(a))
    assert got.shape == (e, n, n)
    assert _rel(got, want) < INV_TOL
    # The inverse inverts: A·A⁻¹ = I to float32 rounding times cond(A).
    eye = torch.eye(n).expand(e, n, n)
    assert float((T(a) @ got - eye).abs().max()) < 1e-2


def test_recursion_shapes():
    for n in (1, 15, 16, 18, 24, 36, 48, 64, 120, 128, 256):
        assert recursion_accepts(n), n
    for n in (0, 17, 33, 34, 50, 100):
        assert not recursion_accepts(n), n
    # The Schur route refuses what the recursion refuses, before any work.
    for k in (34, 66):
        z = torch.zeros(1, k, k)
        with pytest.raises(ValueError, match=f"splits n = {k}"):
            port.xla_binv_solve_reg(z, torch.zeros(1, k), torch.ones(1))
    a, b, cnt = port.make_inputs(96, 2, seed=2)
    x = port.xla_binv_solve_reg(T(a), T(b), T(cnt), lam=LAM)
    assert _rel(x, _float64_solve(a, b, cnt, "diag")) < TOL


def test_k34_refused_on_both_packages():
    a, b, cnt = port.make_inputs(34, 8, seed=1)
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(cnt))
    with pytest.raises(TypeError):
        proto.binv_solve_reg(*args, lam=LAM, interpret=True)
    with pytest.raises(TypeError):
        proto.xla_binv_solve_reg(*args, lam=LAM, interpret=True)
    with pytest.raises(ValueError, match="must stay even"):
        binv_solve_reg(T(a), T(b), T(cnt), lam=LAM)
    with pytest.raises(ValueError, match="xla_binv_solve_reg: the block recursion splits n = 34"):
        port.xla_binv_solve_reg(T(a), T(b), T(cnt), lam=LAM)
    with pytest.raises(ValueError, match="n <= 32"):
        binv_inv(T(a))
    with pytest.raises(ValueError, match="must stay even"):
        binv_inv(T(a[:, :17, :17]))


def test_main_on_the_cpu(capsys):
    assert port.main(["--device", "cpu", "--k", "32", "--e", "256"]) == 0
    out = capsys.readouterr().out
    assert "# mode: fused" in out
    rel = float(out.split("rel x err:")[1].split()[0])
    resid = float(out.split("max |Ax-b|:")[1].split()[0])
    # Against float64 (5.9e-6 of max|x| on these inputs): as the solves.
    assert rel < 1e-4 and resid < 1e-3


def test_main_as_a_module_on_the_cpu():
    r = subprocess.run(
        [sys.executable, "-m", "cfk_tpu_torch.scripts.exp_binv", "--device",
         "cpu", "--k", "64", "--e", "128", "--mode", "xla"],
        cwd=_ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "# mode: xla" in r.stdout and "rel x err:" in r.stdout
