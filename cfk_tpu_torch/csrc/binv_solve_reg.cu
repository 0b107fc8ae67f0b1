// binv_solve_reg: regularize a batch of k x k SPD systems and solve them by
// an explicit block inverse with one step of iterative refinement.
//
// Replaces: scripts/exp_binv.py::binv_solve_reg :154 (kernel body
// _binv_reg_kernel :101).  For every system e:
//
//   A' = A[e] + R_e   (diag: λ·max(n_e, 1) on the diagonal; matrix: one
//                      shared [k,k] term)
//   B  = A'⁻¹         (block_inverse.cuh: Schur recursion, Gauss-Jordan
//                      leaves)
//   x  = B b[e];  r = b[e] − A' x;  x[e] = x + B r
//
// What bounds it on the H100: FP32 operations at k >= 64 (the recursion's
// ~(5/6)·k³ multiply-adds against (k² + 2k + 1)·4 bytes read and k·4
// written; at k = 128, ~21 flop/byte).
//
// Design: one CTA per system (256 threads at k > 32, 128 below), the
// ridged A' and then B in shared memory at row stride k + 1, the recursion
// of block_inverse.cuh in place, then the three matrix-vector products one
// warp per row (lanes over columns, a shuffle reduction).  The residual
// re-reads A[e] (and the matrix ridge) from device memory, where L2 still
// holds it, rather than keep a second k x k copy in shared memory: at
// k = 128 the CTA needs 66 KB for B, 21 KB of P scratch and the leaf's
// 2.3 KB — above the default 48 KB, so the launch opts in to the larger
// dynamic shared memory.  The TPU kernel's batch-first tiles of 128
// systems and its identity padding (_pad_tile :126) were Mosaic's; here
// the grid has exactly E CTAs.
#include "block_inverse.cuh"

namespace {

// The sum of one value per lane, on every lane (the matrix-vector products
// run one warp per row, lanes over columns lane, lane + 32, …).
__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__global__ void binv_solve_reg_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ reg,
                                      int reg_mode, float lam,
                                      float* __restrict__ x, int k) {
  extern __shared__ float smem[];
  const int ld = k + 1;
  float* B = smem;
  float* scratch = B + k * ld;
  float* leaf = scratch + cfk::binv::scratch_floats(k);
  float* bv = leaf + cfk::binv::kLeafFloats;
  float* xv = bv + k;
  float* rv = xv + k;
  const size_t e = blockIdx.x;
  const float* ae = a + e * k * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  for (int idx = tid; idx < k * k; idx += blockDim.x) {
    const int i = idx / k, j = idx - i * k;
    B[i * ld + j] = __ldg(ae + idx);
  }
  for (int i = tid; i < k; i += blockDim.x) bv[i] = __ldg(b + e * k + i);
  __syncthreads();
  cfk::add_ridge(B, ld, k, reg_mode, lam, reg, (int)e);
  const float rdiag =
      reg_mode == cfk::kRegDiag ? lam * fmaxf(__ldg(reg + e), 1.0f) : 0.f;
  cfk::binv::block_inverse<cfk::binv::kMaxDepth>(B, ld, k, scratch, leaf);
  for (int i = warp; i < k; i += warps) {  // x = B b
    float s = 0.f;
    for (int j = lane; j < k; j += 32) s = fmaf(B[i * ld + j], bv[j], s);
    s = warp_sum(s);
    if (lane == 0) xv[i] = s;
  }
  __syncthreads();
  for (int i = warp; i < k; i += warps) {  // r = b − A' x
    float s = 0.f;
    for (int j = lane; j < k; j += 32) {
      float aij = __ldg(ae + i * k + j);
      if (reg_mode == cfk::kRegDiag) {
        if (i == j) aij += rdiag;
      } else {
        aij += __ldg(reg + i * k + j);
      }
      s = fmaf(aij, xv[j], s);
    }
    s = warp_sum(s);
    if (lane == 0) rv[i] = bv[i] - s;
  }
  __syncthreads();
  for (int i = warp; i < k; i += warps) {  // x + B r
    float s = 0.f;
    for (int j = lane; j < k; j += 32) s = fmaf(B[i * ld + j], rv[j], s);
    s = warp_sum(s);
    if (lane == 0) x[e * k + i] = xv[i] + s;
  }
}

}  // namespace

extern "C" int cfk_binv_solve_reg(const float* a, const float* b,
                                  const float* reg, int reg_mode, float lam,
                                  float* x, int e, int k, int device,
                                  void* stream) {
  if (e == 0) return 0;
  if (k < 1 || k > cfk::binv::kMaxRank ||
      !cfk::binv::shape_ok(k, cfk::binv::kMaxDepth))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)cfk::binv::smem_floats(k, 3 * k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(binv_solve_reg_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  binv_solve_reg_kernel<<<e, cfk::binv::threads_for(k), smem,
                          (cudaStream_t)stream>>>(a, b, reg, reg_mode, lam, x,
                                                  k);
  return (int)cudaGetLastError();
}
