// binv_inv: the batched SPD inverse of small systems, A [E, n, n] → A⁻¹,
// n <= 32.
//
// Replaces: scripts/exp_binv.py::_pallas_inv :271 — the leaf kernel of the
// Schur recursion whose levels above n = 32 run as batched float32 matrix
// products (_xla_block_inverse :290; the port's counterpart is
// cfk_tpu_torch/scripts/exp_binv.py).  At k = 128 that recursion launches
// it four times (on A11⁻¹'s two 32 x 32 blocks and on S⁻¹'s), at k = 64
// twice.
//
// What bounds it on the H100: bytes at n <= 32 — n²·4 bytes read and
// written a system against ~(5/6)·n³ + the leaves' multiply-adds (at
// n = 32, ~6 flop/byte, under the card's ~20 flop/byte FP32 balance
// point).
//
// Design: one warp per system, eight systems a CTA of 256 threads.  Each
// warp loads its n x n block (16-byte loads, coalesced, where n is a
// multiple of 4 and both batches are 16-byte aligned) into its own shared
// tile at block_inverse.cuh's row stride (36 floats at n = 32: 4.6 KB a
// warp, plus the leaves' 128-byte buffer), runs the recursion there as a
// WarpTeam — one Schur level at n = 32, its five 16³ products from 4 x 4
// register tiles, the two Gauss-Jordan leaves in registers — with
// __syncwarp only, and writes the inverse back the same way; four CTAs an
// SM (__launch_bounds__ keeps 64 registers).  No CTA barrier: a warp past
// the batch's end leaves at once.  The TPU kernel's tiles of 128 systems
// and identity padding were Mosaic's; here the grid has ⌈E/8⌉ CTAs.
#include "block_inverse.cuh"

namespace {

constexpr int kMaxN = 32;
constexpr int kDepth = 1;  // 32 → 16
constexpr int kWarps = 8;  // systems a CTA

__global__ void __launch_bounds__(32 * kWarps, 4)
binv_inv_kernel(const float* __restrict__ a, float* __restrict__ out, int e,
                int n, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = cfk::binv::row_stride(n);
  const long long sys = (long long)blockIdx.x * kWarps + warp;
  if (sys >= e) return;
  // the warps' leaf buffers, then their tiles
  float* X = smem + kWarps * 2 * cfk::binv::kLeaf + warp * n * ld;
  const float* ae = a + sys * n * n;
  float* oe = out + sys * n * n;
  const cfk::binv::WarpTeam tm{lane, smem + warp * 2 * cfk::binv::kLeaf};
  cfk::binv::load_block(X, ld, ae, n, vec, tm);
  tm.sync();
  cfk::binv::block_inverse<kDepth>(X, ld, n, tm);
  cfk::binv::store_block(oe, X, ld, n, vec, tm);
}

size_t smem_bytes(int n) {
  return sizeof(float) * (size_t)kWarps *
         (n * cfk::binv::row_stride(n) + 2 * cfk::binv::kLeaf);
}

}  // namespace

extern "C" int cfk_binv_inv(const float* a, float* out, int e, int n,
                            int device, void* stream) {
  if (e == 0) return 0;
  if (n < 1 || n > kMaxN || !cfk::binv::shape_ok(n, kDepth))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(binv_inv_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const int vec = n % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  binv_inv_kernel<<<(e + kWarps - 1) / kWarps, 32 * kWarps, smem_bytes(n),
                    (cudaStream_t)stream>>>(a, out, e, n, vec);
  return (int)cudaGetLastError();
}

// CTAs (of eight systems each) resident on one SM at size n.
extern "C" int cfk_binv_inv_ctas_per_sm(int n, int device, int* ctas) {
  if (n < 1 || n > kMaxN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(binv_inv_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, binv_inv_kernel, 32 * kWarps, smem_bytes(n));
}
