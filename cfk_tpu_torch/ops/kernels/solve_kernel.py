"""K1 reg_solve: ridge + batched k x k SPD solve (``csrc/reg_solve.cu``).

Counterpart of ``cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_reg_pallas``:
x[e] = (A[e] + R_e)⁻¹ b[e] with R_e = λ·max(n_e, 1)·I (``reg_mode="diag"``,
ALS-WR, ``processors/MFeatureCalculator.java:91-95``; count-0 padding rows
become λ·I) or one shared [k,k] term (``reg_mode="matrix"``).
"""

from __future__ import annotations

import ctypes

import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, stream_of

REG_MODES = {"diag": 0, "matrix": 1}
MAX_RANK = 128
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


def reg_solve_plain(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor, *,
                    lam: float = 0.0, reg_mode: str = "diag") -> torch.Tensor:
    """The plain PyTorch version of K1: ridge, Cholesky, two triangular
    solves (``cholesky_ex``: a non-SPD system yields non-finite rows, as in
    the kernel, instead of raising)."""
    chol, _ = torch.linalg.cholesky_ex(
        add_ridge_plain(a, reg, lam=lam, reg_mode=reg_mode))
    return torch.cholesky_solve(b.unsqueeze(-1), chol).squeeze(-1)


def reg_solve(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor, *,
              lam: float = 0.0, reg_mode: str = "diag") -> torch.Tensor:
    """Regularize and solve a batch of SPD systems: a [E,k,k] f32, b [E,k]
    f32, reg [E] counts (diag) or [k,k] (matrix) → x [E,k] f32."""
    e, k = b.shape
    check_reg(reg, reg_mode, e, k)
    if not on_cuda(a, b, reg):
        return reg_solve_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    if not 1 <= k <= MAX_RANK:
        raise ValueError(f"reg_solve supports rank 1..{MAX_RANK}, got {k}")
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
