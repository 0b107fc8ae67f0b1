// gauss_solve_multi (row 12): the batched SPD solve with m right-hand sides
// per system, the first step of the blocked (Schur) solve for
// 64 < k ≤ 128.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_multi_pallas
// (_gauss_multi_kernel; via _solve_call).  X[e] = A[e]⁻¹ B[e], k ≤ 64,
// m ≤ 72: at rank 128 one call computes A₁₁⁻¹[A₁₂ | b₁] (k = 64, m = 65),
// reading A₁₁ in place from the [E, 128, 128] batch.  Bound and design:
// spd_batch.cuh (MMAX = 72: one thread per right-hand side runs its back
// substitution, three warps at m = 65).
#include "spd_batch.cuh"

extern "C" int cfk_gauss_solve_multi(const float* a, long long a_bs,
                                     int a_rs, const float* b,
                                     long long b_bs, int b_rs, float* x,
                                     int e, int k, int m, int device,
                                     void* stream) {
  return launch_spd_batch<72>(a, a_bs, a_rs, b, b_bs, b_rs, x, e, k, m,
                              device, stream);
}
