// gauss_solve_multi: the batched SPD solve with m right-hand sides per
// system, the first step of the blocked (Schur) solve for 64 < k ≤ 128.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_multi_pallas
// (_gauss_multi_kernel; via _solve_call).  X[e] = A[e]⁻¹ B[e], k ≤ 64,
// m ≤ 72: at rank 128 one call computes A₁₁⁻¹[A₁₂ | b₁] (k = 64, m = 65).
// Bound and design: gauss_jordan.cuh.
#include "gauss_jordan.cuh"

extern "C" int cfk_gauss_solve_multi(const float* a, const float* b,
                                     float* x, int e, int k, int m,
                                     int device, void* stream) {
  return launch_gauss_jordan(a, b, x, e, k, m, device, stream);
}
