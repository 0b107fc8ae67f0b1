// K1 reg_solve: add the ALS-WR ridge to a batch of k x k SPD systems and
// solve them.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_reg_pallas
// (bodies _lu_reg_kernel / _gauss_reg_kernel).  x[e] = (A[e] + R_e)⁻¹ b[e]
// with R_e = λ·max(n_e, 1)·I (diag mode) or one shared [k,k] term (matrix).
//
// What bounds it on the H100: bytes.  Each system reads k² + k floats and
// writes k, against k³/3 + 2k² flops: at k = 64 that is ~1.4 flop/byte,
// far under the card's ~20 flop/byte FP32 balance point.
//
// Design: one CTA per system.  The CTA streams A[e] into shared memory once
// (coalesced rows), adding the ridge on the way in, factors it there with a
// no-pivot Cholesky (SPD plus a positive ridge) and runs both triangular
// solves in place, so device memory sees one read of (A, b) and one write
// of x.  The TPU kernel's reverse-order LU and its 128-lane batch layout
// existed for Mosaic's sublane/lane rules and are not carried over.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(cfk::kThreads)
reg_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ reg, int reg_mode, float lam,
                 float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  const int ld = k + 1;  // odd row stride: column walks hit distinct banks
  float* A = smem;
  float* y = smem + k * ld;
  const size_t e = blockIdx.x;
  const float* ae = a + e * k * k;
  for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
    const int i = idx / k, j = idx - i * k;
    A[i * ld + j] = __ldg(ae + idx);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) y[i] = __ldg(b + e * k + i);
  __syncthreads();
  cfk::add_ridge(A, ld, k, reg_mode, lam, reg, (int)e);
  cfk::chol_solve_smem(A, ld, y, k);
  for (int i = threadIdx.x; i < k; i += blockDim.x) x[e * k + i] = y[i];
}

}  // namespace

extern "C" int cfk_reg_solve(const float* a, const float* b, const float* reg,
                             int reg_mode, float lam, float* x, int e, int k,
                             int device, void* stream) {
  if (e == 0) return 0;
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem = sizeof(float) * (size_t)(k * (k + 1) + k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reg_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  reg_solve_kernel<<<e, cfk::kThreads, smem, (cudaStream_t)stream>>>(
      a, b, reg, reg_mode, lam, x, k);
  return (int)cudaGetLastError();
}
