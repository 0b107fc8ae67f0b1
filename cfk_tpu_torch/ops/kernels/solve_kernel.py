"""The batched SPD solve kernels and their plain PyTorch versions.

- K1 ``reg_solve`` (``csrc/reg_solve.cu``) ↔ ``cfk_tpu/ops/pallas/
  solve_kernel.py::gauss_solve_reg_pallas``: x[e] = (A[e] + R_e)⁻¹ b[e] with
  R_e = λ·max(n_e, 1)·I (``reg_mode="diag"``, ALS-WR,
  ``processors/MFeatureCalculator.java:91-95``; count-0 padding rows become
  λ·I) or one shared [k,k] term (``reg_mode="matrix"``).
- ``gauss_solve`` (``csrc/gauss_solve.cu``) ↔ ``gauss_solve_pallas``: the
  unregularized SPD solve of the split epilogue, batch-last A [k,k,E],
  b [k,E] → x [k,E], k ≤ 64.
- ``gauss_solve_multi`` (``csrc/gauss_solve_multi.cu``) ↔
  ``gauss_solve_multi_pallas``: the same with m right-hand sides,
  A [k,k,E], B [k,m,E] → X [k,m,E], k ≤ 64, m ≤ 72 — the first step of the
  blocked (Schur) solve for 64 < k ≤ 128 (``ops.solve.blocked_spd_solve``).

The two unregularized entries keep the JAX package's names and batch-last
layout at the public function, and Gauss-Jordan is their plain version (the
reference's algorithm); their kernels run K1's blocked Cholesky
(``csrc/spd_batch.cuh`` over ``csrc/spd_solve.cuh``) on batch-first
systems, one CTA per system.  The wrapper hands the kernel the batch-first
view with its batch and row strides (``batch_first``): no copy when the
caller's tensor is a permuted view of a batch-first batch — as
``dispatch_spd_solve``'s is, and the Schur route's A₁₁, a slice of the
[E, 128, 128] batch.  No pivoting: the systems are SPD (a system that is
not gives a non-finite row on the card, finite Gauss-Jordan numbers on the
CPU).
"""

from __future__ import annotations

import ctypes

import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, stream_of

REG_MODES = {"diag": 0, "matrix": 1}
MAX_RANK = 128
# The Gauss-Jordan entries' caps, the JAX package's PALLAS_MAX_RANK and its
# multi-RHS width (``solve_kernel.py:57, 511``).
GJ_MAX_RANK = 64
GJ_MAX_RHS = GJ_MAX_RANK + 8
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)


def check_reg(reg: torch.Tensor, reg_mode: str, rows: int, k: int) -> None:
    if reg_mode == "diag":
        if tuple(reg.shape) != (rows,):
            raise ValueError(f"diag reg shape {tuple(reg.shape)} != ({rows},)")
    elif reg_mode == "matrix":
        if tuple(reg.shape) != (k, k):
            raise ValueError(f"matrix reg shape {tuple(reg.shape)} != ({k},{k})")
    else:
        raise ValueError(f"unknown reg_mode {reg_mode!r}")


def add_ridge_plain(a: torch.Tensor, reg: torch.Tensor, *, lam: float,
                    reg_mode: str) -> torch.Tensor:
    """A + R: the ridge of ``reg_solve``, out of place."""
    if reg_mode == "diag":
        ridge = lam * reg.to(torch.float32).clamp_min(1.0)
        return a + torch.diag_embed(ridge[:, None].expand(-1, a.shape[-1]))
    return a + reg.to(torch.float32)


def spd_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve a [E,k,k], b [E,k] → x [E,k]: Cholesky and two
    triangular solves (``cholesky_ex``: a non-SPD system yields non-finite
    rows, as in the kernels, instead of raising)."""
    chol, _ = torch.linalg.cholesky_ex(a)
    return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)


def reg_solve_plain(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor, *,
                    lam: float = 0.0, reg_mode: str = "diag") -> torch.Tensor:
    """The plain PyTorch version of K1: ridge, then ``spd_solve_plain``."""
    return spd_solve_plain(add_ridge_plain(a, reg, lam=lam,
                                           reg_mode=reg_mode), b)


def reg_solve(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor, *,
              lam: float = 0.0, reg_mode: str = "diag") -> torch.Tensor:
    """Regularize and solve a batch of SPD systems: a [E,k,k] f32, b [E,k]
    f32, reg [E] counts (diag) or [k,k] (matrix) → x [E,k] f32; k ≤ 128 on
    every device (above it the half-steps take the split route,
    ``ops.solve.batched_spd_solve``)."""
    e, k = b.shape
    check_reg(reg, reg_mode, e, k)
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"reg_solve supports rank 1..{MAX_RANK}, got {k}")
    if not on_cuda(a, b, reg):
        return reg_solve_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    require(a, "a", torch.float32, (e, k, k))
    require(b, "b", torch.float32, (e, k))
    reg32 = reg.to(torch.float32).contiguous()
    x = torch.empty((e, k), dtype=torch.float32, device=a.device)
    fn = _build.function("reg_solve", "cfk_reg_solve", _ARGTYPES)
    rc = fn(_build.ptr(a), _build.ptr(b), _build.ptr(reg32),
            REG_MODES[reg_mode], float(lam), _build.ptr(x), e, k,
            a.device.index or 0, stream_of(a))
    _build.check(rc, "reg_solve")
    reg_solve.launches += 1
    return x


reg_solve.launches = 0


_GJ_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p)


def gauss_jordan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan without pivoting, batch-last: a [k,k,E], b [k,m,E] →
    x [k,m,E].  The unrolled elimination of ``gj_solve_lanes`` /
    ``_gauss_multi_kernel`` (``cfk_tpu/ops/pallas/solve_kernel.py:65-88,
    123-141``), vectorized over the batch: step j normalizes row j by
    1/A[j,j] and subtracts column j times it from every other row."""
    k = a.shape[0]
    for j in range(k):
        inv = 1.0 / a[j, j]  # [E]
        row = a[j] * inv  # [k, E]
        bj = b[j] * inv  # [m, E]
        col = a[:, j]  # [k, E]
        a = a - col[:, None, :] * row[None, :, :]
        b = b - col[:, None, :] * bj[None, :, :]
        a[j] = row
        b[j] = bj
    return b


def gauss_solve_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``gauss_solve``: a [k,k,E], b [k,E]."""
    return gauss_jordan_plain(a, b[:, None, :])[:, 0, :]


def batch_first(t: torch.Tensor) -> tuple[torch.Tensor, int, int]:
    """A batch-last operand t [r, c, E] as the kernels read it: the
    batch-first view [E, r, c] when its columns are adjacent (stride 1, or
    one column), else a contiguous copy; with its batch and row strides."""
    v = t.permute(2, 0, 1)
    if v.shape[2] > 1 and v.stride(2) != 1:
        v = v.contiguous()
    return v, v.stride(0), v.stride(1)


def _launch_gauss(name: str, symbol: str, a: torch.Tensor, b: torch.Tensor,
                  k: int, m: int, e: int) -> torch.Tensor:
    """Runs the batch-first kernel on a [k,k,E], b [k,m,E] (batch-last, read
    through ``batch_first``) → x [E,k,m]."""
    for t, what in ((a, "a"), (b, "b")):
        if t.dtype != torch.float32:
            raise TypeError(f"{what} must be torch.float32, got {t.dtype}")
    af, a_bs, a_rs = batch_first(a)
    bf, b_bs, b_rs = batch_first(b)
    x = torch.empty((e, k, m), dtype=torch.float32, device=a.device)
    fn = _build.function(name, symbol, _GJ_ARGTYPES)
    rc = fn(_build.ptr(af), a_bs, a_rs, _build.ptr(bf), b_bs, b_rs,
            _build.ptr(x), e, k, m, a.device.index or 0, stream_of(a))
    _build.check(rc, name)
    return x


def gauss_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A[:, :, e] x = b[:, e] for every e (batch-last): a [k,k,E] f32
    SPD per system (the kernel reads its lower triangle), b [k,E] f32 →
    x [k,E], k ≤ 64."""
    k, _, e = a.shape
    if k > GJ_MAX_RANK:
        raise ValueError(
            f"gauss_solve supports rank <= {GJ_MAX_RANK}, got {k}; the "
            "blocked solve covers ranks up to 128"
        )
    if tuple(a.shape) != (k, k, e) or tuple(b.shape) != (k, e):
        raise ValueError(f"bad shapes a={tuple(a.shape)} b={tuple(b.shape)}")
    if not on_cuda(a, b):
        return gauss_solve_plain(a, b)
    x = _launch_gauss("gauss_solve", "cfk_gauss_solve", a, b[:, None, :],
                      k, 1, e)
    gauss_solve.launches += 1
    return x.view(e, k).T


gauss_solve.launches = 0


def gauss_solve_multi(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A X = B with an [m]-wide RHS block per system (batch-last):
    a [k,k,E] f32 SPD (the kernel reads its lower triangle), b [k,m,E] f32
    → X [k,m,E], k ≤ 64, m ≤ 72."""
    k, m, e = b.shape
    if tuple(a.shape) != (k, k, e):
        raise ValueError(f"a shape {tuple(a.shape)} != ({k},{k},{e})")
    if k > GJ_MAX_RANK or m > GJ_MAX_RHS:
        raise ValueError(
            f"gauss_solve_multi supports k <= {GJ_MAX_RANK}, m <= "
            f"{GJ_MAX_RHS}, got k={k} m={m}"
        )
    if not on_cuda(a, b):
        return gauss_jordan_plain(a, b)
    x = _launch_gauss("gauss_solve_multi", "cfk_gauss_solve_multi", a, b,
                      k, m, e)
    gauss_solve_multi.launches += 1
    return x.permute(1, 2, 0)


gauss_solve_multi.launches = 0
