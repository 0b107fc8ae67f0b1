// The unregularized batched SPD solve of rows 11 and 12: gauss_solve.cu
// (one right-hand side) and gauss_solve_multi.cu (m right-hand sides), one
// CTA per system over the port's one SPD solve, spd_solve.cuh.
//
// Replaces the elimination of cfk_tpu/ops/pallas/solve_kernel.py
// (gj_solve_lanes :65-88, _gauss_multi_kernel :123-141): X = A⁻¹B per
// system, A SPD, no pivoting.  The TPU kernels ran Gauss-Jordan because
// its column steps map onto the 128 vector lanes; here the same systems
// take the blocked Cholesky of spd_solve.cuh, which K1 and the fused Gram
// epilogue already run — so row 11 on A + λ·max(n, 1)·I (the ridge added by
// the caller) returns K1's bits for (A, n), and the split schedules return
// the fused ones'.  A system that is not positive definite gives a
// non-finite row of X (Gauss-Jordan without pivoting gave finite numbers
// wherever its pivots were nonzero); the contract is SPD.
//
// What bounds it on the H100: bytes.  A system needs A's lower triangle
// (k(k+1)/2 floats: the Cholesky reads no more), B (k·m) and writes X
// (k·m), against k³/6 + k²·m multiply-adds: at k = 64 about 15 flop/byte
// with m = 65 and 11 with m = 1, under the card's ~20 FP32 flop/byte.
//
// Design.  The public functions keep the JAX package's batch-last layout;
// the wrappers hand the kernel batch-first views with their batch and row
// strides (the column stride is 1), so it reads A₁₁ of the blocked Schur
// route in place from the [E, 128, 128] batch, with no copy.  Each thread
// starts all its loads of A's lower triangle before any store, as in K1;
// B [E, k, m] is transposed into rows k .. k+m-1 on the load (a warp reads
// 32 neighbouring columns of a row of B and writes them down a column of
// the odd-stride array: 32 banks), X is written back the same way.  At
// k = 64, m = 65 the array is 129 x 65 floats, 33.5 KB.
#pragma once

#include "spd_solve.cuh"

namespace {

// Row 11 (MMAX = 1) is K1's kernel with the ridge left out, under K1's
// launch bounds at KMAX <= 64: four CTAs per SM.
template <int KMAX, int MMAX>
__global__ void __launch_bounds__(cfk::kThreads, 4)
spd_batch_kernel(const float* __restrict__ a, long long a_bs, int a_rs,
                 const float* __restrict__ b, long long b_bs, int b_rs,
                 float* __restrict__ x, int k, int m) {
  extern __shared__ float smem[];
  constexpr int kPer = KMAX * KMAX / cfk::kThreads;
  constexpr int kBatch = kPer < 32 ? kPer : 32;
  constexpr int kPerB = (KMAX * MMAX + cfk::kThreads - 1) / cfk::kThreads;
  const int ld = cfk::spd_ld(k);
  float* A = smem;
  const size_t e = blockIdx.x;
  const float* ae = a + e * a_bs;
  const float* be = b + e * b_bs;
  // A's lower triangle: element idx = threadIdx.x + q·kThreads of the
  // KMAX-wide grid is (idx / KMAX, idx % KMAX), as in K1.
#pragma unroll
  for (int q0 = 0; q0 < kPer; q0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * cfk::kThreads;
      const int i = idx / KMAX, j = idx % KMAX;
      v[q] = i < k && j <= i ? __ldg(ae + (size_t)i * a_rs + j) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int idx = threadIdx.x + (q0 + q) * cfk::kThreads;
      const int i = idx / KMAX, j = idx % KMAX;
      if (i < k && j <= i) A[i * ld + j] = v[q];
    }
  }
  // B transposed into rows k .. k+m-1: element idx of the KMAX x MMAX grid
  // is B's (i, c) = (idx / MMAX, idx % MMAX), stored at row k + c, column i.
  {
    float v[kPerB];
#pragma unroll
    for (int q = 0; q < kPerB; ++q) {
      const int idx = threadIdx.x + q * cfk::kThreads;
      const int i = idx / MMAX, c = idx % MMAX;
      v[q] = i < k && c < m ? __ldg(be + (size_t)i * b_rs + c) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kPerB; ++q) {
      const int idx = threadIdx.x + q * cfk::kThreads;
      const int i = idx / MMAX, c = idx % MMAX;
      if (i < k && c < m) A[(k + c) * ld + i] = v[q];
    }
  }
  __syncthreads();
  cfk::spd_solve<KMAX, MMAX>(A, ld, k, m);
  float* xe = x + e * k * m;
#pragma unroll
  for (int q = 0; q < kPerB; ++q) {
    const int idx = threadIdx.x + q * cfk::kThreads;
    const int i = idx / MMAX, c = idx % MMAX;
    if (i < k && c < m) xe[i * m + c] = A[(k + c) * ld + i];
  }
}

template <int KMAX, int MMAX>
int launch(const float* a, long long a_bs, int a_rs, const float* b,
           long long b_bs, int b_rs, float* x, int e, int k, int m,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)cfk::spd_floats(k, m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        spd_batch_kernel<KMAX, MMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spd_batch_kernel<KMAX, MMAX><<<e, cfk::kThreads, smem, stream>>>(
      a, a_bs, a_rs, b, b_bs, b_rs, x, k, m);
  return (int)cudaGetLastError();
}

// Solves e systems: A [e, k, k] at element (i, j) a[s·a_bs + i·a_rs + j], B
// [e, k, m] at b[s·b_bs + i·b_rs + c] → X [e, k, m] contiguous.  k <= 64,
// 1 <= m <= MMAX.
template <int MMAX>
int launch_spd_batch(const float* a, long long a_bs, int a_rs,
                     const float* b, long long b_bs, int b_rs, float* x,
                     int e, int k, int m, int device, void* stream) {
  if (e == 0) return 0;
  if (k < 1 || k > 64 || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  // The KMAX that K1 dispatches for the same k.
  if (k <= 32)
    return launch<32, MMAX>(a, a_bs, a_rs, b, b_bs, b_rs, x, e, k, m, st);
  return launch<64, MMAX>(a, a_bs, a_rs, b, b_bs, b_rs, x, e, k, m, st);
}

}  // namespace
