// gauss_solve (row 11): the unregularized batched SPD solve of the split
// epilogue, one right-hand side per system.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_pallas
// (_gauss_kernel, gj_solve_lanes; via _solve_call).  x[e] = A[e]⁻¹ b[e],
// k ≤ 64, for the accum side's final solve on the split schedule (ridge
// added by the caller), the ALS++/iALS++ sweeps' b×b solves, and the Schur
// complement of the blocked solve at 64 < k ≤ 128.  Bound and design:
// spd_batch.cuh (m = 1: warp 0 runs the back substitution, as in K1).
#include "spd_batch.cuh"

extern "C" int cfk_gauss_solve(const float* a, long long a_bs, int a_rs,
                               const float* b, long long b_bs, int b_rs,
                               float* x, int e, int k, int m, int device,
                               void* stream) {
  return launch_spd_batch<1>(a, a_bs, a_rs, b, b_bs, b_rs, x, e, k, m,
                             device, stream);
}
