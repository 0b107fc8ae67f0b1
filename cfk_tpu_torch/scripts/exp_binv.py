"""Batched SPD solve by an explicit block inverse, on the H100 — the port of
the prototype ``scripts/exp_binv.py``.

The prototype inverts each regularized Gram A' = A + R by the symmetric 2×2
Schur recursion (P = A11⁻¹A12, S = A22 − A12ᵀP, B11 = A11⁻¹ + (PS⁻¹)Pᵀ,
B12 = −PS⁻¹, B21 = −S⁻¹Pᵀ, B22 = S⁻¹) with Gauss-Jordan leaves of n ≤ 16,
then solves x = B b with one step of iterative refinement.  Two routes:

- ``binv_solve_reg`` (``--mode fused``): the whole solve in one kernel per
  batch (``csrc/binv_solve_reg.cu``, row 14 of the TPU kernel table);
- ``xla_binv_solve_reg`` (``--mode xla``): the Schur levels above n = 32 as
  batched float32 matrix products (``_xla_block_inverse``; the JAX package
  leaves them to XLA, here ``torch.matmul`` with TF32 off), the n ≤ 32
  blocks through ``_pallas_inv``'s counterpart, the ``binv_inv`` kernel
  (``csrc/binv_inv.cu``, row 15): two launches at k = 64, four at k = 128.

``--mode auto`` keeps the prototype's rule: fused at k ≤ 32 or on the CPU,
otherwise the Schur route.  Run::

    python -m cfk_tpu_torch.scripts.exp_binv                 # on the card
    python -m cfk_tpu_torch.scripts.exp_binv --device cpu --k 32

``--device cpu`` stands in for the prototype's ``--interpret``: the plain
PyTorch versions run, and the timing part is skipped.  Inputs are made from
numpy seed 0 as the prototype makes them: E = ``--e`` rounded down to a
multiple of ``--tile`` Grams of rank k/8 plus λ·max(n, 1)·I with counts n in
[1, 400), λ = 0.05.  Prints max |A'x − b| and the relative x error against a
float64 ``numpy.linalg.solve``; on the card then the solve's time beside
kernel K1 (``reg_solve``) and ``torch.linalg.solve`` on the same batch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from cfk_tpu_torch.device import resolve_device
from cfk_tpu_torch.ops.kernels.binv_kernel import (
    INV_MAX_N,
    binv_inv,
    binv_solve_reg,
    block_inverse_plain,
    check_recursion,
    refine_solve_plain,
)
from cfk_tpu_torch.ops.kernels.solve_kernel import add_ridge_plain, reg_solve

__all__ = ["binv_solve_reg", "xla_binv_solve_reg", "_xla_block_inverse",
           "_pallas_inv", "main"]

LAM = 0.05


def _pallas_inv(a: torch.Tensor) -> torch.Tensor:
    """[E, n, n] SPD batch inverse, n ≤ 32: the ``binv_inv`` kernel (its
    plain version on the CPU) — the prototype's ``_pallas_inv`` :271."""
    return binv_inv(a.contiguous())


def _xla_block_inverse(a: torch.Tensor) -> torch.Tensor:
    """Symmetric 2×2 Schur inversion with batched float32 matrix products
    above n = 32, the blocks of n ≤ 32 through ``_pallas_inv``; [E, n, n] →
    [E, n, n] (``_xla_block_inverse`` :290)."""
    return block_inverse_plain(a, leaf=INV_MAX_N, leaf_fn=_pallas_inv)


def xla_binv_solve_reg(a: torch.Tensor, b: torch.Tensor, reg: torch.Tensor,
                       *, reg_mode: str = "diag",
                       lam: float = 0.0) -> torch.Tensor:
    """Regularize, invert by ``_xla_block_inverse`` and solve with one
    refinement step (``xla_binv_solve_reg`` :312); a [E,k,k], b [E,k],
    reg [E] counts (diag) or [k,k] (matrix) → x [E,k]."""
    check_recursion("xla_binv_solve_reg", a.shape[-1])
    a = add_ridge_plain(a, reg, lam=lam, reg_mode=reg_mode)
    return refine_solve_plain(a, _xla_block_inverse(a), b)


def make_inputs(k: int, e: int, seed: int = 0):
    """The prototype's inputs (``scripts/exp_binv.py:206-216``): rank-k/8
    Grams A [E,k,k] f32, b [E,k] f32, counts [E] int32 in [1, 400)."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((e, k, max(k // 8, 2))).astype(np.float32)
    a = np.einsum("ekr,elr->ekl", x0, x0)
    b = rng.standard_normal((e, k)).astype(np.float32)
    cnt = rng.integers(1, 400, size=e).astype(np.int32)
    return a, b, cnt


def float64_check(a, b, cnt, got, lam: float = LAM) -> tuple[float, float]:
    """(max |A'x − b|, max |x − x64| / max |x64|) of ``got`` against a
    float64 ``numpy.linalg.solve`` of the diag-ridged systems."""
    a_reg = a.astype(np.float64) + (lam * np.maximum(cnt, 1))[:, None, None] \
        * np.eye(a.shape[-1])
    want = np.linalg.solve(a_reg, b.astype(np.float64)[..., None])[..., 0]
    got = np.asarray(got, np.float64)
    resid = np.einsum("ekl,el->ek", a_reg, got) - b
    return (float(np.abs(resid).max()),
            float(np.abs(got - want).max() / np.abs(want).max()))


def _time_ms(fn, repeats: int) -> float:
    """Best device ms of one call over ``repeats`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cfk_tpu_torch.scripts.exp_binv",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions; the "
                    "prototype's --interpret)")
    ap.add_argument("--mode", choices=["auto", "fused", "xla"],
                    default="auto",
                    help="auto: fused at k <= 32 or on the CPU, else the "
                    "Schur route")
    ap.add_argument("--k", type=int, default=128)
    ap.add_argument("--e", type=int, default=334 * 16)
    ap.add_argument("--tile", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cpu = dev.type == "cpu"
    if args.mode == "auto":
        args.mode = "fused" if (cpu or args.k <= 32) else "xla"
    solve = binv_solve_reg if args.mode == "fused" else xla_binv_solve_reg
    print(f"# mode: {args.mode}  device: "
          f"{'cpu' if cpu else torch.cuda.get_device_name(dev)}")
    k = args.k
    e = (args.e // args.tile) * args.tile
    a, b, cnt = make_inputs(k, e)
    aj, bj, cj = (torch.as_tensor(x, device=dev) for x in (a, b, cnt))
    got = solve(aj, bj, cj, reg_mode="diag", lam=LAM)
    resid, rel = float64_check(a, b, cnt, got.cpu().numpy())
    print("max |Ax-b|:", resid, " rel x err:", rel)
    if cpu:
        return 0
    a_reg = add_ridge_plain(aj, cj, lam=LAM, reg_mode="diag")
    for label, fn in (
            (f"binv-{args.mode}", lambda: solve(aj, bj, cj, reg_mode="diag",
                                                lam=LAM)),
            ("reg_solve (K1)", lambda: reg_solve(aj, bj, cj, lam=LAM)),
            ("torch.linalg.solve", lambda: torch.linalg.solve(a_reg, bj))):
        ms = _time_ms(fn, args.repeats)
        print(f"{label}: {ms:.3f} ms for {e} systems "
              f"({ms * 1e6 / e:.0f} ns/system)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
