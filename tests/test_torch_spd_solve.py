"""The blocked SPD solve's operation order, emulated on the CPU.

K1 ``reg_solve``, the fused Gram epilogue (K3, K6, the stream twins) and
rows 11 and 12 (``gauss_solve``, ``gauss_solve_multi``) share one CUDA
routine, ``cfk_tpu_torch/csrc/spd_solve.cuh``: a blocked right-looking
Cholesky with 32-column panels (a warp factors the diagonal block; the rows
below, the m right-hand sides among them as the system's last m rows, are
solved against it; the trailing lower part takes the panel's rank-32
update), inverse pivots rsqrt(d) kept on the diagonal, then a back
substitution panel by panel (warp 0 for one right-hand side, one thread per
right-hand side for m).  CUDA has no CPU mode, so this file holds a float32
emulation of that order — the same panels, stages and per-element update
order; ``fmaf`` is emulated by a float64 product and sum rounded once to
float32 (exact but for rare double roundings) — and shows on the CPU that
the order is as accurate as the column order: against a float64 solve,
against the plain versions (``reg_solve_plain``: LAPACK's float32 Cholesky;
``gauss_jordan_plain``: rows 11 and 12's, the reference's Gauss-Jordan) and
against the JAX package's ``gauss_solve_reg_pallas``, ``gauss_solve_pallas``
and ``gauss_solve_multi_pallas`` (XLA/interpret mode off-TPU).  The kernels
themselves are checked on the card (tests/test_torch_gpu.py, chip_smoke.py).

Tolerances (max |x − x₆₄| over max |x₆₄| per batch):
- float64: the emulation's error at most 4 times the plain float32
  solve's on the same systems plus 4 float32 ulps of max|x| (4·2⁻²⁴ ≈
  2.4e-7) — "as accurate as the column order", for any conditioning: two
  float32 Cholesky solves round differently, and their errors on one batch
  were seen 0.7–2.3x apart, where an order that rounds worse would be an
  order of magnitude off;
- and at most 2e-5 on the ALS- and iALS-shaped batches (condition numbers
  below ~1e2 in diag mode, a few 1e3 in matrix mode: float32 Cholesky
  error ≲ κ·ε, measured 1e-7–4e-6) and 2e-4 on the block-inverse
  prototype's inputs (κ up to 4.5e3 at k = 128; K1 on the card reads
  6.2e-5 there);
- against ``reg_solve_plain`` and ``gauss_jordan_plain`` 1e-4 (two float32
  solves, each within the bounds above), against the JAX package's kernels
  1e-4 (as tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cfk_tpu.ops.pallas.solve_kernel import (
    gauss_solve_multi_pallas,
    gauss_solve_pallas,
    gauss_solve_reg_pallas,
)
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    GJ_MAX_RANK,
    add_ridge_plain,
    gauss_jordan_plain,
    reg_solve_plain,
)
from cfk_tpu_torch.scripts.exp_binv import make_inputs

PANEL = 32
KS = [1, 31, 32, 33, 64, 100, 127, 128]
# Rows 11 and 12: k up to GJ_MAX_RANK, m up to GJ_MAX_RHS (72; 65 at the
# Schur shape of rank 128).
GJ_KS = [1, 31, 32, 33, 64]
GJ_MS = [1, 2, 33, 65, 72]
ULP4 = 4 * 2.0 ** -24


def _fma(a, b, c):
    """float32 fmaf(a, b, c): the exact product, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def blocked_factor(m: torch.Tensor) -> torch.Tensor:
    """The kernel's factorization of m [E, n, k], n = k or k + 1 (y as the
    last row), lower part read: L below the diagonal, inverse pivots on
    it, and with n = k + 1, z = L⁻¹y in the last row."""
    m = m.clone()
    n, k = m.shape[1:]
    for c0 in range(0, k, PANEL):
        c1 = min(c0 + PANEL, k)
        for j in range(c0, c1):  # 1. the diagonal block, column by column
            inv = torch.rsqrt(m[:, j, j])
            m[:, j + 1:c1, j] *= inv[:, None]
            m[:, j, j] = inv
            col = m[:, j + 1:c1, j]
            blk = m[:, j + 1:c1, j + 1:c1]
            m[:, j + 1:c1, j + 1:c1] = torch.where(
                torch.ones_like(blk[0], dtype=torch.bool).tril(),
                _fma(-col[:, :, None], col[:, None, :], blk), blk)
        for j in range(c0, c1):  # 2. the rows below (and y)
            m[:, c1:, j] *= m[:, j, j][:, None]
            m[:, c1:, j + 1:c1] = _fma(-m[:, c1:, j:j + 1],
                                       m[:, j + 1:c1, j][:, None, :],
                                       m[:, c1:, j + 1:c1])
        low = torch.ones((n - c1, k - c1), dtype=torch.bool).tril()
        for l in range(c0, c1):  # 3. the trailing lower part, 32 updates
            t = m[:, c1:, c1:]
            m[:, c1:, c1:] = torch.where(
                low, _fma(-m[:, c1:, l][:, :, None],
                          m[:, c1:k, l][:, None, :], t), t)
    return m


def blocked_solve_multi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order on a [E, k, k] (lower triangle read) with m
    right-hand sides b [E, k, m] float32 → x [E, k, m]: Bᵀ factored as m
    extra rows (z = L⁻¹B on the way), then Lᵀx = z panel by panel — one
    thread per right-hand side on the card (warp 0's lanes for m = 1),
    each element taking the same fmaf's in the same order either way."""
    k = a.shape[-1]
    m = blocked_factor(torch.cat([torch.tril(a), b.transpose(1, 2)], dim=1))
    y = m[:, k:].clone()  # [E, m, k]: zᵀ = (L⁻¹B)ᵀ
    for c0 in reversed(range(0, k, PANEL)):  # Lᵀx = z, panel by panel
        c1 = min(c0 + PANEL, k)
        z = y[:, :, c0:c1].clone()
        for i in range(k - 1, c1 - 1, -1):
            z = _fma(-m[:, None, i, c0:c1], y[:, :, i:i + 1], z)
        dinv = torch.diagonal(m[:, c0:c1, c0:c1], dim1=1, dim2=2)[:, None]
        for j in reversed(range(c1 - c0)):
            xj = z[:, :, j] * dinv[:, :, j]
            z[:, :, :j] = _fma(-m[:, None, c0 + j, c0:c0 + j], xj[..., None],
                               z[:, :, :j])
        y[:, :, c0:c1] = z * dinv
    return y.transpose(1, 2)


def blocked_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order on a [E, k, k] (ridge added; lower triangle
    read), b [E, k] float32 → x [E, k]."""
    return blocked_solve_multi(a, b[:, :, None])[:, :, 0]


def column_order_factor(a: torch.Tensor) -> torch.Tensor:
    """L (inverse pivots on the diagonal) by one column at a time, each
    step updating the whole trailing triangle — the unblocked order."""
    k = a.shape[-1]
    m = torch.tril(a).clone()
    low = torch.ones((k, k), dtype=torch.bool).tril()
    for j in range(k):
        inv = torch.rsqrt(m[:, j, j])
        m[:, j + 1:, j] *= inv[:, None]
        m[:, j, j] = inv
        col = m[:, j + 1:, j]
        t = m[:, j + 1:, j + 1:]
        m[:, j + 1:, j + 1:] = torch.where(
            low[j + 1:, j + 1:], _fma(-col[:, :, None], col[:, None, :], t), t)
    return m


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _solve64(a_reg: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.solve(a_reg.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]


def _als_batch(k: int, seed: int):
    """ALS-shaped systems: system e sums n_e rank-1 terms f fᵀ of unit-
    scale factor rows, n_e spread over 0..400 (n = 0: A = 0, the ridge
    alone gives λ·I), and b = Σ r·f with ratings r in 1..5."""
    rng = np.random.default_rng(seed)
    counts = np.r_[0, 1, 2, 5, rng.integers(0, 401, 20)].astype(np.int32)
    a = np.zeros((counts.size, k, k), np.float32)
    b = np.zeros((counts.size, k), np.float32)
    for e, n in enumerate(counts):
        f = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
        r = rng.integers(1, 6, n).astype(np.float32)
        a[e], b[e] = f.T @ f, r @ f
    return a, b, counts


def _check(a_reg_np, b_np, x_emul, x_plain, tol64):
    want = _solve64(a_reg_np, b_np)
    err, err_plain = _rel(x_emul, want), _rel(x_plain, want)
    assert err <= 4 * err_plain + ULP4, (err, err_plain)
    assert err <= tol64, err
    assert _rel(x_emul, x_plain) <= 1e-4


@pytest.mark.parametrize("k", KS)
def test_blocked_order_diag_mode(k):
    a, b, counts = _als_batch(k, k)
    at, bt, ct = (torch.as_tensor(x) for x in (a, b, counts))
    a_reg = add_ridge_plain(at, ct, lam=0.05, reg_mode="diag")
    x = blocked_solve(a_reg, bt)
    _check(a_reg.numpy(), b, x, reg_solve_plain(at, bt, ct, lam=0.05), 2e-5)


@pytest.mark.parametrize("k", KS)
def test_blocked_order_matrix_mode(k):
    """iALS-shaped: Σ α·r·f fᵀ over a few observed rows plus the shared
    YᵀY + λI."""
    rng = np.random.default_rng(100 + k)
    f = rng.random((16, 12, k), dtype=np.float32)
    w = (40.0 * rng.random((16, 12))).astype(np.float32)
    a = np.einsum("epk,ep,epl->ekl", f, w, f).astype(np.float32)
    b = np.einsum("epk,ep->ek", f, 1.0 + w).astype(np.float32)
    y = rng.random((500, k), dtype=np.float32)
    reg = (y.T @ y + 0.1 * np.eye(k)).astype(np.float32)
    at, bt, rt = (torch.as_tensor(x) for x in (a, b, reg))
    a_reg = add_ridge_plain(at, rt, lam=0.0, reg_mode="matrix")
    x = blocked_solve(a_reg, bt)
    _check(a_reg.numpy(), b, x,
           reg_solve_plain(at, bt, rt, reg_mode="matrix"), 2e-5)


@pytest.mark.parametrize("k", [32, 64, 128])
def test_blocked_order_on_block_inverse_inputs(k):
    """The block-inverse prototype's inputs (rank-k/8 Grams held up by
    λ·max(n, 1)·I, condition numbers to 4.5e3 at k = 128) — chip_smoke.py's
    binv phase, where K1 is held to float64."""
    a, b, cnt = make_inputs(k, 48)
    at, bt, ct = (torch.as_tensor(x) for x in (a, b, cnt))
    a_reg = add_ridge_plain(at, ct, lam=0.05, reg_mode="diag")
    x = blocked_solve(a_reg, bt)
    _check(a_reg.numpy(), b, x, reg_solve_plain(at, bt, ct, lam=0.05), 2e-4)


@pytest.mark.parametrize("k", [33, 100, 128])
def test_blocked_factor_is_the_column_order_factor(k):
    """Blocking reorders the updates across elements, not within one: each
    element of L takes the same fmaf's in the same order, so the blocked
    factor equals the column-at-a-time one bit for bit."""
    a, _, counts = _als_batch(k, 7 + k)
    a_reg = add_ridge_plain(torch.as_tensor(a), torch.as_tensor(counts),
                            lam=0.05, reg_mode="diag")
    assert torch.equal(blocked_factor(torch.tril(a_reg)),
                       column_order_factor(a_reg))


@pytest.mark.parametrize("reg_mode", ["diag", "matrix"])
def test_blocked_order_matches_gauss_solve_reg_pallas(reg_mode):
    k = 8
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 2 * k, k)).astype(np.float32)
    a = np.einsum("enk,enl->ekl", x, x)
    b = rng.standard_normal((37, k)).astype(np.float32)
    if reg_mode == "diag":
        reg, lam = rng.integers(0, 30, 37).astype(np.int32), 0.1
    else:
        y = rng.standard_normal((30, k)).astype(np.float32)
        reg, lam = (y.T @ y + 0.5 * np.eye(k)).astype(np.float32), 0.0
    want = gauss_solve_reg_pallas(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(reg), reg_mode=reg_mode,
                                  lam=lam)
    a_reg = add_ridge_plain(torch.as_tensor(a), torch.as_tensor(reg),
                            lam=lam, reg_mode=reg_mode)
    assert _rel(blocked_solve(a_reg, torch.as_tensor(b)), want) <= 1e-4


def test_blocked_order_non_spd_rows():
    """A pivot <= 0 (−I, the zero matrix, a negative eigenvalue past the
    first panel) makes rsqrt NaN or +inf, which reaches the whole row of x;
    the SPD neighbours are untouched."""
    k = 40
    a, b, _ = _als_batch(k, 1)
    a = torch.as_tensor(a[:5]) + torch.eye(k)
    eig = torch.ones(k)
    eig[35] = -1.0
    a[1], a[2], a[4] = -torch.eye(k), 0.0, torch.diag(eig)
    x = blocked_solve(a, torch.as_tensor(b[:5]) + 1.0)
    assert torch.isfinite(x).all(1).tolist() == [True, False, False, True,
                                                 False]


# -- rows 11 and 12: m right-hand sides as m extra rows -----------------------

def _last(x: torch.Tensor) -> torch.Tensor:
    """A batch-first tensor in the batch-last layout of rows 11 and 12."""
    return x.permute(*range(1, x.dim()), 0).contiguous()


def _rhs(e, k, m, seed) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (e, k, m)).astype(np.float32))


def _ridged_als(k, seed):
    a, _, counts = _als_batch(k, seed)
    return add_ridge_plain(torch.as_tensor(a), torch.as_tensor(counts),
                           lam=0.05, reg_mode="diag")


def _check_multi(a, b, x, tol64):
    """x [E, k, m] of the emulation against float64, the float32 Cholesky
    (LAPACK) and the reference's Gauss-Jordan (``gauss_jordan_plain``)."""
    want = np.linalg.solve(a.double().numpy(), b.double().numpy())
    chol, _ = torch.linalg.cholesky_ex(a)
    err = _rel(x, want)
    err_plain = _rel(torch.cholesky_solve(b, chol), want)
    assert err <= 4 * err_plain + ULP4, (err, err_plain)
    assert err <= tol64, err
    gj = gauss_jordan_plain(_last(a), _last(b)).permute(2, 0, 1)
    assert _rel(x, gj) <= 1e-4


@pytest.mark.parametrize("m", GJ_MS)
@pytest.mark.parametrize("k", GJ_KS)
def test_blocked_order_multi_rhs(k, m):
    """Row 12's order (row 11's at m = 1) on ALS-shaped ridged systems: as
    accurate as the column order, and column r of the m-column solve is
    the one-column solve of B's column r bit for bit (each element's
    operations do not depend on m)."""
    a = _ridged_als(k, 200 + k)
    b = _rhs(a.shape[0], k, m, k + m)
    x = blocked_solve_multi(a, b)
    _check_multi(a, b, x, 2e-5)
    for r in {0, m - 1}:
        assert torch.equal(x[:, :, r], blocked_solve(a, b[:, :, r]))


@pytest.mark.parametrize("k", GJ_KS)
def test_blocked_order_matches_gauss_solve_pallas(k):
    """Row 11 against the JAX package's Gauss-Jordan kernel (interpret
    mode), batch-last as its tests call it."""
    a = _ridged_als(k, 300 + k)
    b = _rhs(a.shape[0], k, 1, k)[:, :, 0]
    want = gauss_solve_pallas(jnp.asarray(_last(a).numpy()),
                              jnp.asarray(b.T.contiguous().numpy()),
                              interpret=True)
    assert _rel(blocked_solve(a, b), np.asarray(want).T) <= 1e-4


@pytest.mark.parametrize("k,m", [(33, 33), (64, 2), (64, 33), (64, 65),
                                 (64, 72)])
def test_blocked_order_matches_gauss_solve_multi_pallas(k, m):
    a = _ridged_als(k, 400 + k)
    b = _rhs(a.shape[0], k, m, k * m)
    want = gauss_solve_multi_pallas(jnp.asarray(_last(a).numpy()),
                                    jnp.asarray(_last(b).numpy()),
                                    interpret=True)
    got = blocked_solve_multi(a, b)
    assert _rel(got, np.moveaxis(np.asarray(want), -1, 0)) <= 1e-4


def _schur_route(a, b):
    """The blocked Schur route of ``ops.solve.blocked_spd_solve`` at
    64 < k ≤ 128 with the emulated kernels: Y = A₁₁⁻¹[A₁₂ | b₁] (row 12),
    S = A₂₂ − A₂₁·Y₁₂ and its right-hand side in float32, x₂ = S⁻¹r₂ (row
    11, lower triangle), x₁ = y₁ − Y₁₂·x₂.  Returns (S, r₂, x₂, x)."""
    k1 = GJ_MAX_RANK
    k2 = a.shape[-1] - k1
    rhs = torch.cat([a[:, :k1, k1:], b[:, :k1, None]], dim=2)
    y = blocked_solve_multi(a[:, :k1, :k1], rhs)
    y12, y1 = y[:, :, :k2], y[:, :, k2]
    s = a[:, k1:, k1:] - a[:, k1:, :k1] @ y12
    r2 = b[:, k1:] - (a[:, k1:, :k1] @ y1[:, :, None])[:, :, 0]
    x2 = blocked_solve(s, r2)
    x1 = y1 - (y12 @ x2[:, :, None])[:, :, 0]
    return s, r2, x2, torch.cat([x1, x2], dim=1)


def test_blocked_order_on_the_schur_complement():
    """S of the blocked route (k = 128) is symmetric only to its last bits;
    row 11 reads its lower triangle, Gauss-Jordan read all of it.  Solving
    the lower triangle is as accurate against a float64 solve of the full
    S as Gauss-Jordan on the full S, and as (S + Sᵀ)/2 (the symmetrized
    convention of ``jax.lax.linalg.cholesky``); the route's x holds the
    float64 bound of the direct solve."""
    a, b, counts = _als_batch(128, 17)
    a = add_ridge_plain(torch.as_tensor(a), torch.as_tensor(counts),
                        lam=0.05, reg_mode="diag")
    b = torch.as_tensor(b)
    s, r2, x2, x = _schur_route(a, b)
    assert not torch.equal(s, s.transpose(1, 2))
    want = _solve64(s.numpy(), r2.numpy())
    err = _rel(x2, want)
    err_gj = _rel(gauss_jordan_plain(_last(s), _last(r2[:, :, None]))
                  [:, 0].T, want)
    err_sym = _rel(blocked_solve((s + s.transpose(1, 2)) / 2, r2), want)
    assert err <= 4 * err_gj + ULP4, (err, err_gj)
    assert err <= 4 * err_sym + ULP4, (err, err_sym)
    assert err <= 2e-5
    want = _solve64(a.numpy(), b.numpy())
    assert _rel(x, want) <= 2e-5


def test_blocked_order_multi_non_spd_rows():
    """Rows 11 and 12 on a system that is not positive definite: every
    column of its x is non-finite (Gauss-Jordan without pivoting returns
    finite numbers there); the SPD neighbours are untouched."""
    k = 40
    a, _, _ = _als_batch(k, 2)
    a = torch.as_tensor(a[:5]) + torch.eye(k)
    eig = torch.ones(k)
    eig[35] = -1.0
    a[1], a[2], a[4] = -torch.eye(k), 0.0, torch.diag(eig)
    b = _rhs(5, k, 3, 5) + 1.0
    x = blocked_solve_multi(a, b)
    assert torch.isfinite(x).all((1, 2)).tolist() == [True, False, False,
                                                      True, False]
    assert (~torch.isfinite(x[[1, 2, 4]])).all((1, 2)).tolist() == [True] * 3
    gj = gauss_jordan_plain(_last(a[[4]]), _last(b[[4]]))
    assert torch.isfinite(gj).all()
