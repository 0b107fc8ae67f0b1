// gauss_solve: the unregularized batched SPD solve of the split epilogue,
// one right-hand side per system.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_pallas
// (_gauss_kernel, gj_solve_lanes; via _solve_call).  x[e] = A[e]⁻¹ b[e],
// k ≤ 64, for the accum side's final solve on the split schedule
// (ridge added by the caller) and for the Schur complement of the blocked
// solve at 64 < k ≤ 128.  Bound and design: gauss_jordan.cuh (m = 1).
#include "gauss_jordan.cuh"

extern "C" int cfk_gauss_solve(const float* a, const float* b, float* x,
                               int e, int k, int m, int device,
                               void* stream) {
  if (m != 1) return (int)cudaErrorInvalidValue;
  return launch_gauss_jordan(a, b, x, e, k, 1, device, stream);
}
