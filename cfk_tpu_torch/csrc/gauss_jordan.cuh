// The Gauss-Jordan solve shared by gauss_solve.cu (one right-hand side)
// and gauss_solve_multi.cu (m right-hand sides): one CTA per system,
// the system in shared memory.
//
// Replaces the elimination of cfk_tpu/ops/pallas/solve_kernel.py
// (gj_solve_lanes :65-88, _gauss_multi_kernel :123-141): no pivoting (the
// systems are SPD), step j normalizes row j by 1/A[j][j] and subtracts
// column j times it from every other row, on A and on the right-hand
// sides, so the sides end up holding X = A⁻¹B.
//
// What bounds it on the H100: bytes.  A system reads k² + k·m floats and
// writes k·m, against k³/3 + 2k²·m flops of the least work (a Cholesky and
// its triangular solves): at k = 64, m = 1 that is ~5 flop/byte, under the
// card's ~20 flop/byte FP32 balance point.  Gauss-Jordan itself does
// ~k³/2 + k²·m multiply-adds: it updates only the columns right of the
// pivot (the columns left of it no longer feed the right-hand sides).
//
// Design.  The TPU kernel laid 128 systems along the vector lanes (batch
// last) and padded the batch with identity systems; that layout puts one
// system's k² entries E floats apart, so a CTA reading one system would
// use 4 bytes of every 32-byte sector.  The Python wrapper therefore
// permutes to batch-first with plain torch (a free view when the caller's
// batch is batch-first already, as the solve dispatch's is) and each CTA
// reads its system as one contiguous block: A (row stride k + 1, against
// bank conflicts) and B (row stride m + 1) into shared memory, k steps of
// two barriers each, X written back once.  In a step each warp updates
// whole rows, its lanes on consecutive columns (no per-element index
// division).  At k = 64, m = 72 that is 36 KB of shared memory, under the
// default 48 KB.
#pragma once

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(cfk::kThreads)
gauss_jordan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ x, int k, int m) {
  extern __shared__ float smem[];
  const int lda = k + 1, ldb = m + 1;
  float* A = smem;
  float* B = A + k * lda;
  float* prow = B + k * ldb;  // normalized pivot row: k - j - 1 + m
  float* pcol = prow + k + m;  // pivot column: k
  const int tid = threadIdx.x, nth = blockDim.x;
  const int lane = tid % 32, warp = tid / 32, warps = nth / 32;
  const size_t e = blockIdx.x;
  const float* ae = a + e * k * k;
  const float* be = b + e * k * m;
  for (int idx = tid; idx < k * k; idx += nth) {
    const int i = idx / k, j = idx - i * k;
    A[i * lda + j] = __ldg(ae + idx);
  }
  for (int idx = tid; idx < k * m; idx += nth) {
    const int i = idx / m, c = idx - i * m;
    B[i * ldb + c] = __ldg(be + idx);
  }
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    const float inv = 1.0f / A[j * lda + j];
    const int wa = k - j - 1;  // live columns of A right of the pivot
    const int w = wa + m;
    for (int c = tid; c < w; c += nth)
      prow[c] = (c < wa ? A[j * lda + j + 1 + c] : B[j * ldb + c - wa]) * inv;
    for (int i = tid; i < k; i += nth) pcol[i] = A[i * lda + j];
    __syncthreads();
    for (int i = warp; i < k; i += warps) {  // one row per warp at a time
      const float ci = pcol[i];
      float* ra = A + i * lda + j + 1;
      float* rb = B + i * ldb;
      for (int c = lane; c < w; c += 32) {
        float* p = c < wa ? ra + c : rb + (c - wa);
        *p = i == j ? prow[c] : fmaf(-ci, prow[c], *p);
      }
    }
    __syncthreads();
  }
  float* xe = x + e * k * m;
  for (int idx = tid; idx < k * m; idx += nth) {
    const int i = idx / m, c = idx - i * m;
    xe[idx] = B[i * ldb + c];
  }
}

// Solves e systems a [e, k, k], b [e, k, m] → x [e, k, m] (batch-first).
int launch_gauss_jordan(const float* a, const float* b, float* x, int e,
                        int k, int m, int device, void* stream) {
  if (e == 0) return 0;
  if (k < 1 || k > 64 || m < 1 || m > 72) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  const size_t smem =
      sizeof(float) * (size_t)(k * (k + 1) + k * (m + 1) + 2 * k + m);
  gauss_jordan_kernel<<<e, cfk::kThreads, smem, (cudaStream_t)stream>>>(
      a, b, x, k, m);
  return (int)cudaGetLastError();
}

}  // namespace
