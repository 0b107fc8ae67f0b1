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
// Design: one CTA per system (256 threads at k > 64, 128 at k > 32, one
// warp below: at least one thread per 4 x 4 tile of a top-level product),
// A loaded with eight 16-byte loads in flight a thread (where k is a
// multiple of 4 and the batch 16-byte aligned), the ridged A' and then B
// in shared memory at block_inverse.cuh's row stride (132 floats at
// k = 128), the recursion of block_inverse.cuh in place (register-tiled
// products, one-warp leaves, no scratch), then the three matrix-vector
// products one warp per row, four rows a warp at a time (lanes over
// columns, a shuffle reduction).  The residual re-reads A[e] (and the
// matrix ridge) from device memory, where L2 still holds it, rather than
// keep a second k x k copy in shared memory, a group of rows ahead.  At
// k = 128 the CTA needs 66 KB for B and 1.6 KB for the vectors and the
// leaves' buffer: three CTAs an SM (the launch opts in to the larger
// dynamic shared memory and the largest shared-memory carveout;
// __launch_bounds__ keeps the registers for three).  The TPU kernel's
// batch-first tiles of 128 systems and its identity padding (_pad_tile
// :126) were Mosaic's; here the grid has exactly E CTAs.
#include "block_inverse.cuh"

namespace {

// The sum of one value per lane, on every lane.
__device__ __forceinline__ float warp_sum(float s) {
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// The matrix-vector products run one warp per row, four rows a warp at a
// time: rows i0 + r·warps (r < 4, i0 = warp, warp + 4·warps, …), lane
// summing its columns lane, lane + 32, … (k <= 128) in order with fmaf,
// then warp_sum.  fetch_rows loads a group's matrix entries elem(i, j);
// dot_rows sums adj(i, j, entry) against v and hands emit(i, Σ_j …·v[j]).
template <class Elem>
__device__ __forceinline__ void fetch_rows(float (&m)[4][4], int k, int i0,
                                           Elem elem) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + r * warps, j = lane + 32 * c;
      m[r][c] = i < k && j < k ? elem(i, j) : 0.f;
    }
}

struct Same {
  __device__ float operator()(int, int, float m) const { return m; }
};

template <class Emit, class Adj = Same>
__device__ __forceinline__ void dot_rows(const float (&m)[4][4], int k,
                                         int i0, const float* v, Emit emit,
                                         Adj adj = Same{}) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float s[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = lane + 32 * c;
      if (j < k) s[r] = fmaf(adj(i0 + r * warps, j, m[r][c]), v[j], s[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + r * warps;
    s[r] = warp_sum(s[r]);
    if (lane == 0 && i < k) emit(i, s[r]);
  }
}

template <class Elem, class Emit>
__device__ __forceinline__ void rows_dot(int k, const float* v, Elem elem,
                                         Emit emit) {
  const int warps = blockDim.x >> 5;
  for (int i0 = threadIdx.x >> 5; i0 < k; i0 += 4 * warps) {
    float m[4][4];
    fetch_rows(m, k, i0, elem);
    dot_rows(m, k, i0, v, emit);
  }
}

// The recursion, called from one place in the kernel (the values the
// kernel keeps across it are saved once, not around every level's call).
__device__ __noinline__ void invert(float* B, int ld, int k, float* leaf_buf) {
  cfk::binv::block_inverse<cfk::binv::kMaxDepth>(B, ld, k,
                                                 cfk::binv::CtaTeam{leaf_buf});
}

__global__ void __launch_bounds__(256, 3)
binv_solve_reg_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ reg, int reg_mode, float lam,
                      float* __restrict__ x, int k, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int ld = cfk::binv::row_stride(k);
  float* leaf_buf = smem;  // 2·kLeaf floats, then the system
  float* B = leaf_buf + 2 * cfk::binv::kLeaf;
  float* bv = B + k * ld;
  float* xv = bv + k;
  float* rv = xv + k;
  const size_t e = blockIdx.x;
  const float* ae = a + e * k * k;
  cfk::binv::load_block(B, ld, ae, k, vec, cfk::binv::CtaTeam{leaf_buf});
  for (int i = threadIdx.x; i < k; i += blockDim.x) bv[i] = __ldg(b + e * k + i);
  __syncthreads();
  cfk::add_ridge(B, ld, k, reg_mode, lam, reg, (int)e);
  const float rdiag = reg_mode == cfk::kRegDiag
                          ? __fmul_rn(lam, fmaxf(__ldg(reg + e), 1.0f))
                          : 0.f;
  invert(B, ld, k, leaf_buf);
  const auto inv = [&](int i, int j) { return B[i * ld + j]; };
  // r = b − A' x: each group's A loaded from device memory a group ahead
  // (the first group's while x = B b is formed), the ridge added as it is
  // used — the loads stay free of anything that waits on them
  const auto raw = [&](int i, int j) { return __ldg(ae + i * k + j); };
  const auto ridge = [&](int i, int j, float aij) {
    if (reg_mode == cfk::kRegDiag) return i == j ? aij + rdiag : aij;
    return aij + __ldg(reg + i * k + j);
  };
  const int step = 4 * (blockDim.x >> 5), w0 = threadIdx.x >> 5;
  float ga[4][4], gb[4][4];
  fetch_rows(ga, k, w0, raw);
  rows_dot(k, bv, inv, [&](int i, float s) { xv[i] = s; });  // x = B b
  __syncthreads();
  const auto resid = [&](int i, float s) { rv[i] = bv[i] - s; };
  for (int i0 = w0; i0 < k; i0 += 2 * step) {
    if (i0 + step < k) fetch_rows(gb, k, i0 + step, raw);
    dot_rows(ga, k, i0, xv, resid, ridge);
    if (i0 + step < k) {
      if (i0 + 2 * step < k) fetch_rows(ga, k, i0 + 2 * step, raw);
      dot_rows(gb, k, i0 + step, xv, resid, ridge);
    }
  }
  __syncthreads();
  rows_dot(k, rv, inv,  // x + B r
           [&](int i, float s) { x[e * k + i] = xv[i] + s; });
}

// The launch's shared memory, after opting the kernel in to it and to the
// largest shared-memory carveout; 0 where k is refused.
size_t prepare(int k, cudaError_t* err) {
  *err = cudaSuccess;
  if (k < 1 || k > cfk::binv::kMaxRank ||
      !cfk::binv::shape_ok(k, cfk::binv::kMaxDepth)) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  const size_t smem =
      sizeof(float) * (size_t)(2 * cfk::binv::kLeaf +
                               k * cfk::binv::row_stride(k) + 3 * k);
  *err = cudaFuncSetAttribute(binv_solve_reg_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
  if (*err == cudaSuccess)  // room for three CTAs an SM at k = 128
    *err = cudaFuncSetAttribute(binv_solve_reg_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  return smem;
}

}  // namespace

extern "C" int cfk_binv_solve_reg(const float* a, const float* b,
                                  const float* reg, int reg_mode, float lam,
                                  float* x, int e, int k, int device,
                                  void* stream) {
  if (e == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = prepare(k, &err);
  if (err != cudaSuccess) return (int)err;
  const int vec = k % 4 == 0 && (uintptr_t)a % 16 == 0;
  binv_solve_reg_kernel<<<e, cfk::binv::threads_for(k), smem,
                          (cudaStream_t)stream>>>(a, b, reg, reg_mode, lam, x,
                                                  k, vec);
  return (int)cudaGetLastError();
}

// CTAs of the rank-k launch resident on one SM (the occupancy calculator).
extern "C" int cfk_binv_solve_reg_ctas_per_sm(int k, int device, int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = prepare(k, &err);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, binv_solve_reg_kernel, cfk::binv::threads_for(k), smem);
}
