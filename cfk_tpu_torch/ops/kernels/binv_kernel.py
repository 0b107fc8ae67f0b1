"""The block-inverse solve kernels and their plain PyTorch versions.

Counterparts of the prototype ``scripts/exp_binv.py`` (a batched SPD solve by
an explicit inverse, recursive symmetric 2×2 Schur blocks with Gauss-Jordan
leaves, and one step of iterative refinement):

- ``binv_solve_reg`` (``csrc/binv_solve_reg.cu``) ↔ ``binv_solve_reg`` :154
  (kernel body ``_binv_reg_kernel`` :101): x[e] = (A[e] + R_e)⁻¹ b[e] with
  R_e = λ·max(n_e, 1)·I (``reg_mode="diag"``) or one shared [k,k] term
  (``"matrix"``), the inverse by ``block_inverse``, then x += A'⁻¹(b − A'x).
- ``binv_inv`` (``csrc/binv_inv.cu``) ↔ ``_pallas_inv`` :271: A [E,n,n] →
  A⁻¹ for n ≤ 32, the leaf entry of the Schur levels that
  ``cfk_tpu_torch/scripts/exp_binv.py`` runs as batched matrix products.

The plain versions (``leaf_inverse_plain``, ``block_inverse_plain``,
``binv_solve_reg_plain``, ``binv_inv_plain``) write the same recursion step
by step in float32 batched tensor ops, so that the CPU tests hold them to
the JAX prototype operation by operation.

Shapes.  The recursion splits an n×n block at m = n/2 down to leaves of
n ≤ 16 (``LEAF``); the prototype passes m for the Schur complement's size
n − m, so it takes only an n that stays even at every split above the leaf
(24, 48 and 128 do; 34 does not — JAX fails it with a TypeError).  The port
refuses such an n with a ValueError on every device.  The kernel of
``binv_solve_reg`` takes 1 ≤ k ≤ 128 (three Schur levels); above that a
CUDA tensor raises, a CPU tensor takes the plain recursion at any depth, as
the prototype does.  No pivoting: the systems are SPD.
"""

from __future__ import annotations

import ctypes

import torch

from cfk_tpu_torch import _build
from cfk_tpu_torch.ops.kernels import on_cuda, require, stream_of
from cfk_tpu_torch.ops.kernels.solve_kernel import (
    MAX_RANK,
    REG_MODES,
    add_ridge_plain,
    check_reg,
)

LEAF = 16  # the prototype's LEAF: blocks up to this size are GJ leaves
INV_MAX_N = 32  # ``_pallas_inv``'s leaf width on the Schur route
_SOLVE_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_float, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
)
_INV_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def recursion_accepts(n: int) -> bool:
    """Whether the recursion inverts an n×n block: a leaf (n ≤ 16), or an
    even n whose half it accepts."""
    if n < 1:
        return False
    while n > LEAF:
        if n % 2:
            return False
        n //= 2
    return True


def check_recursion(name: str, n: int) -> None:
    """Refuse an n the prototype's recursion cannot split."""
    if not recursion_accepts(n):
        raise ValueError(
            f"{name}: the block recursion splits n = {n} into halves that "
            f"must stay even above the leaf ({LEAF}); n = {n} does not "
            "(the prototype fails it in its concatenation)"
        )


# -- plain versions ------------------------------------------------------------

def leaf_inverse_plain(a: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan inverse of [E, n, n] blocks (n ≤ 16) on [A | I], no
    pivoting — ``_leaf_inverse`` :48: step j takes the pivot's reciprocal,
    scales row j by it and subtracts column j times that row from every
    other row, over the full 2n-wide row."""
    e, n, _ = a.shape
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    m = torch.cat([a, eye.expand(e, n, n)], dim=2)
    for j in range(n):
        piv = m[:, :, j:j + 1]  # [E, n, 1]
        inv = 1.0 / m[:, j:j + 1, j:j + 1]  # [E, 1, 1]
        prow = m[:, j:j + 1, :] * inv  # [E, 1, 2n]
        m = m - piv * prow
        m[:, j:j + 1, :] = prow
    return m[:, :, n:]


def block_inverse_plain(a: torch.Tensor, *, leaf: int = LEAF,
                        leaf_fn=leaf_inverse_plain) -> torch.Tensor:
    """[E, n, n] SPD → its inverse by the symmetric 2×2 Schur recursion —
    ``_block_inverse`` :72: P = A11⁻¹A12, S = A22 − A12ᵀP, B11 = A11⁻¹ +
    (PS⁻¹)Pᵀ, B12 = −PS⁻¹, B21 = −S⁻¹Pᵀ, B22 = S⁻¹; float32 batched
    matrix products (TF32 off).  Blocks of n ≤ ``leaf`` go to ``leaf_fn``
    (the Schur route of ``scripts/exp_binv.py`` passes ``INV_MAX_N`` and
    the ``binv_inv`` kernel)."""
    n = a.shape[-1]
    if n <= leaf:
        return leaf_fn(a)
    m = n // 2
    a11, a12, a22 = a[:, :m, :m], a[:, :m, m:], a[:, m:, m:]
    i11 = block_inverse_plain(a11, leaf=leaf, leaf_fn=leaf_fn)
    p = i11 @ a12
    s = a22 - a12.transpose(1, 2) @ p
    is_ = block_inverse_plain(s, leaf=leaf, leaf_fn=leaf_fn)
    psi = p @ is_
    b11 = i11 + psi @ p.transpose(1, 2)
    b21 = -(is_ @ p.transpose(1, 2))
    return torch.cat([torch.cat([b11, -psi], dim=2),
                      torch.cat([b21, is_], dim=2)], dim=1)


def refine_solve_plain(a: torch.Tensor, binv: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹b by the explicit inverse, then one refinement step
    x += A⁻¹(b − Ax) (``_binv_reg_kernel`` :118-123)."""
    x = (binv @ b[..., None])[..., 0]
    r = b - (a @ x[..., None])[..., 0]
    return x + (binv @ r[..., None])[..., 0]


def binv_solve_reg_plain(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor,
                         *, lam: float = 0.0,
                         reg_mode: str = "diag") -> torch.Tensor:
    """The plain PyTorch version of ``binv_solve_reg``: ridge, block
    inverse, solve and one refinement step."""
    a = add_ridge_plain(a, reg, lam=lam, reg_mode=reg_mode)
    return refine_solve_plain(a, block_inverse_plain(a), b)


def binv_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``binv_inv``."""
    return block_inverse_plain(a)


# -- kernels ---------------------------------------------------------------------

def binv_solve_reg(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor, *,
                   lam: float = 0.0, reg_mode: str = "diag") -> torch.Tensor:
    """Regularize and solve a batch of SPD systems by the block inverse:
    a [E,k,k] f32, b [E,k] f32, reg [E] counts (diag) or [k,k] f32
    (matrix) → x [E,k] f32."""
    e, k = b.shape
    check_reg(reg, reg_mode, e, k)
    check_recursion("binv_solve_reg", k)
    if not on_cuda(a, b, reg):
        return binv_solve_reg_plain(a, b, reg, lam=lam, reg_mode=reg_mode)
    if k > MAX_RANK:
        raise ValueError(
            f"binv_solve_reg supports rank 1..{MAX_RANK} on CUDA, got {k}; "
            "the Schur route (scripts/exp_binv.py's xla_binv_solve_reg) "
            "takes larger ranks"
        )
    require(a, "a", torch.float32, (e, k, k))
    require(b, "b", torch.float32, (e, k))
    reg32 = reg.to(torch.float32).contiguous()
    x = torch.empty((e, k), dtype=torch.float32, device=a.device)
    fn = _build.function("binv_solve_reg", "cfk_binv_solve_reg",
                         _SOLVE_ARGTYPES)
    rc = fn(_build.ptr(a), _build.ptr(b), _build.ptr(reg32),
            REG_MODES[reg_mode], float(lam), _build.ptr(x), e, k,
            a.device.index or 0, stream_of(a))
    _build.check(rc, "binv_solve_reg")
    binv_solve_reg.launches += 1
    return x


binv_solve_reg.launches = 0


def binv_inv(a: torch.Tensor) -> torch.Tensor:
    """Invert a batch of small SPD systems: a [E,n,n] f32, n ≤ 32 →
    A⁻¹ [E,n,n] f32."""
    e, n, n2 = a.shape
    if n2 != n:
        raise ValueError(f"a shape {tuple(a.shape)} is not [E, n, n]")
    if n > INV_MAX_N:
        raise ValueError(f"binv_inv supports n <= {INV_MAX_N}, got {n}")
    check_recursion("binv_inv", n)
    if not on_cuda(a):
        return binv_inv_plain(a)
    require(a, "a", torch.float32, (e, n, n))
    out = torch.empty_like(a)
    fn = _build.function("binv_inv", "cfk_binv_inv", _INV_ARGTYPES)
    rc = fn(_build.ptr(a), _build.ptr(out), e, n, a.device.index or 0,
            stream_of(a))
    _build.check(rc, "binv_inv")
    binv_inv.launches += 1
    return out


binv_inv.launches = 0


def ctas_per_sm(kernel: str, n: int, device: int = 0) -> int:
    """CTAs of kernel ``"binv_solve_reg"`` at rank n, or ``"binv_inv"`` at
    size n (eight systems a CTA), that one SM of the card holds at once —
    CUDA's occupancy calculator on the launch's threads and shared memory."""
    fn = _build.function(kernel, f"cfk_{kernel}_ctas_per_sm",
                         (ctypes.c_int, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_int)))
    out = ctypes.c_int(0)
    _build.check(fn(n, device, ctypes.byref(out)), kernel)
    return out.value
