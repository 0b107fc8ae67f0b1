// K1 reg_solve: add the ALS-WR ridge to a batch of k x k SPD systems and
// solve them.
//
// Replaces: cfk_tpu/ops/pallas/solve_kernel.py::gauss_solve_reg_pallas
// (bodies _lu_reg_kernel / _gauss_reg_kernel).  x[e] = (A[e] + R_e)⁻¹ b[e]
// with R_e = λ·max(n_e, 1)·I (diag mode) or one shared [k,k] term (matrix).
//
// What bounds it on the H100.  A batch that fills the card: bytes — each
// system needs its lower triangle (k(k+1)/2 floats) and b, and writes x,
// against ~k³/6 FMAs: at k = 128, 6.2 flop per byte, under the card's ~20
// FP32 flop/byte.  A batch under one wave (the split schedules' chunks:
// ~200 systems at k = 128, against ~400 CTAs resident): the latency of one
// solve, a chain of k dependent pivots.
//
// Design: one CTA of 256 threads per system.  It reads the lower triangle
// of A[e] and b[e] once, every thread's loads issued before any store
// (one memory latency per 32 loads, not one per load), adds the ridge in
// shared memory and runs the blocked Cholesky solve of spd_solve.cuh —
// a warp factors each 32-column diagonal block in registers, the CTA
// solves the rows below it and applies the rank-32 trailing update, with
// y folded in as the system's last row, so a k = 128 system takes 12 CTA
// barriers where a column-at-a-time factorization took 512.  The fused
// Gram epilogue runs the same routine on the same layout, so K1 on a Gram
// kernel's sums returns the fused solve's bits.  The TPU kernel's
// reverse-order LU and its 128-lane batch layout existed for Mosaic's
// sublane/lane rules and are not carried over.
#include "spd_solve.cuh"

namespace {

// Three CTAs per SM at KMAX = 128 (71 KB of shared memory each), four
// below: the occupancy that fills the card in matrix mode and on the
// Netflix movie half, at the price of a few hundred bytes of spills.
template <int KMAX>
__global__ void __launch_bounds__(cfk::kThreads, KMAX == 128 ? 3 : 4)
reg_solve_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 const float* __restrict__ reg, int reg_mode, float lam,
                 float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  constexpr int kPer = KMAX * KMAX / cfk::kThreads;
  constexpr int kBatch = kPer < 32 ? kPer : 32;
  const int ld = cfk::spd_ld(k);
  float* A = smem;
  float* y = smem + k * ld;
  const size_t e = blockIdx.x;
  const float* ae = a + e * k * k;
  // Element idx = threadIdx.x + q·kThreads of the KMAX-wide grid is
  // (idx / KMAX, idx % KMAX): a warp reads 32 neighbouring columns of a
  // row; the upper triangle is neither read nor written.
#pragma unroll
  for (int q0 = 0; q0 < kPer; q0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * cfk::kThreads;
      const int i = idx / KMAX, j = idx % KMAX;
      v[q] = i < k && j <= i ? __ldg(ae + i * k + j) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * cfk::kThreads;
      const int i = idx / KMAX, j = idx % KMAX;
      if (i < k && j <= i) A[i * ld + j] = v[q];
    }
  }
  if (threadIdx.x < k) y[threadIdx.x] = __ldg(b + e * k + threadIdx.x);
  __syncthreads();
  cfk::add_ridge(A, ld, k, reg_mode, lam, reg, (int)e, true);
  cfk::spd_solve<KMAX>(A, ld, k);
  if (threadIdx.x < k) x[e * k + threadIdx.x] = y[threadIdx.x];
}

template <int KMAX>
int launch(const float* a, const float* b, const float* reg, int reg_mode,
           float lam, float* x, int e, int k, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)cfk::spd_floats(k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        reg_solve_kernel<KMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  reg_solve_kernel<KMAX><<<e, cfk::kThreads, smem, stream>>>(
      a, b, reg, reg_mode, lam, x, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfk_reg_solve(const float* a, const float* b, const float* reg,
                             int reg_mode, float lam, float* x, int e, int k,
                             int device, void* stream) {
  if (e == 0) return 0;
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  // The KMAX the Gram kernels dispatch for the same k.
  if (k <= 32) return launch<32>(a, b, reg, reg_mode, lam, x, e, k, st);
  if (k <= 64) return launch<64>(a, b, reg, reg_mode, lam, x, e, k, st);
  return launch<128>(a, b, reg, reg_mode, lam, x, e, k, st);
}
