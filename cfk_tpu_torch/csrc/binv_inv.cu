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
// Design: one CTA of 128 threads per system, the block in shared memory at
// row stride n + 1 (4.2 KB at n = 32, with P scratch and the leaf buffer
// 7.6 KB: many CTAs per SM), block_inverse.cuh's recursion in place (one
// Schur level at n = 32, then the Gauss-Jordan leaves), one write of the
// inverse.  The TPU kernel's tiles of 128 systems and identity padding
// were Mosaic's; here the grid has exactly E CTAs.
#include "block_inverse.cuh"

namespace {

constexpr int kMaxN = 32;
constexpr int kDepth = 1;  // 32 → 16

__global__ void binv_inv_kernel(const float* __restrict__ a,
                                float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* X = smem;
  float* scratch = X + n * ld;
  float* leaf = scratch + cfk::binv::scratch_floats(n);
  const size_t e = blockIdx.x;
  const float* ae = a + e * n * n;
  float* oe = out + e * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    X[i * ld + j] = __ldg(ae + idx);
  }
  cfk::binv::block_inverse<kDepth>(X, ld, n, scratch, leaf);
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
    const int i = idx / n, j = idx - i * n;
    oe[idx] = X[i * ld + j];
  }
}

}  // namespace

extern "C" int cfk_binv_inv(const float* a, float* out, int e, int n,
                            int device, void* stream) {
  if (e == 0) return 0;
  if (n < 1 || n > kMaxN || !cfk::binv::shape_ok(n, kDepth))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)cfk::binv::smem_floats(n, 0);
  binv_inv_kernel<<<e, cfk::binv::threads_for(n), smem,
                    (cudaStream_t)stream>>>(a, out, n);
  return (int)cudaGetLastError();
}
