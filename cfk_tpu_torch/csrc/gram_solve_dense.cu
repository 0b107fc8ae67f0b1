// K3 gram_solve_dense: one dense-stream chunk's per-segment normal
// equations, gathered, accumulated, regularized and solved in one kernel.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::
// gram_solve_tiles_dense_gather_pallas (_gram_solve_gather_dense_kernel,
// _tile_grams_dense, _walk_tiles, _solve_epilogue).  Tile i of the chunk
// (NT tiles in NG groups of M = NT/NG; meta = g_blk ‖ lb ‖ lo ‖ hi ‖ seg)
// covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in [lo_i, hi_i),
// with b-coefficient rt[i·T + r]; seg is sorted.  Per segment s:
//   g_p = table[nb_p]·wt_p   (wt = 1 when absent; nb_p >= F is the zero row)
//   A_s = Σ g gᵀ, b_s = Σ rt·g, and cin·(ca, cb) folded into segment 0;
//   (ca_out, cb_out) = the RAW (A, b) of segment lseg (the next chunk's carry);
//   x_s = (A_s + R_s)⁻¹ b_s,  R_s = λ·max(reg_s, 1)·I (diag) or reg (matrix).
// This is the indexing of the XLA emulation _emulate_gram_dense
// (gram_kernel.py:581-615) followed by the fused epilogue (:200-247).
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live row
// (the symmetric Gram's half plus b) against at most k·4 gathered bytes,
// plus k³/3 per segment for the solve.  This kernel computes the full
// k x k Gram, twice the symmetric half.
//
// Design: one CTA per segment.  The CTA binary-searches seg for its tile
// range and walks those tiles' windows kRows rows at a time
// (GramAcc::add_dense_segment in common.cuh, shared with the split kernel
// gram_tiles_dense_gather.cu: gather into shared memory, RT x RT register
// blocks of A per thread, flushed into the segment's Gram in shared memory
// every 1,024 rows and at the end); tiles with an empty window (group
// padding) cost one metadata read.  In shared
// memory the carry fold, the raw carry-row copy, the ridge and the Cholesky
// solve then run in place: the [S, k, k] batch
// never reaches device memory, only x and the carry row do.  One hot entity
// is one CTA on one SM — the skew this first version leaves open.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(cfk::kThreads)
gram_solve_dense_kernel(const float* __restrict__ table, int F, int k,
                        const int* __restrict__ nb,
                        const float* __restrict__ wt,
                        const float* __restrict__ rt,
                        const int* __restrict__ meta, int nt, int ng, int T,
                        int BG, const float* __restrict__ reg, int reg_mode,
                        float lam, const int* __restrict__ lseg,
                        const float* __restrict__ ca,
                        const float* __restrict__ cb,
                        const float* __restrict__ cin, float* __restrict__ x,
                        float* __restrict__ ca_out,
                        float* __restrict__ cb_out) {
  __shared__ cfk::RowStage<KMAX> st;
  extern __shared__ float smem[];
  const int ld = k + 1;
  float* A = smem;
  float* y = smem + k * ld;
  const int s = blockIdx.x;
  cfk::GramAcc<KMAX> acc;
  acc.init(A, ld, y, k);
  acc.add_dense_segment(st, s, table, F, nb, wt, rt, meta, nt, ng, T, BG);
  if (s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.flush();
  __syncthreads();
  if (s == __ldg(lseg)) {
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
      const int i = idx / k, j = idx - i * k;
      ca_out[idx] = A[i * ld + j];
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x) cb_out[i] = y[i];
    __syncthreads();
  }
  cfk::add_ridge(A, ld, k, reg_mode, lam, reg, s);
  cfk::chol_solve_smem(A, ld, y, k);
  for (int i = threadIdx.x; i < k; i += blockDim.x) x[(size_t)s * k + i] = y[i];
}

template <int KMAX>
int launch(const float* table, int F, int k, const int* nb, const float* wt,
           const float* rt, const int* meta, int nt, int ng, int T, int BG,
           int S, const float* reg, int reg_mode, float lam, const int* lseg,
           const float* ca, const float* cb, const float* cin, float* x,
           float* ca_out, float* cb_out, cudaStream_t stream) {
  // The static RowStage plus this dynamic block pass the default 48 KB at
  // k > ~64 (KMAX = 128: 16.5 KB + 40-66 KB), so opt in every time.
  const size_t smem = sizeof(float) * (size_t)(k * (k + 1) + k);
  cudaError_t err = cudaFuncSetAttribute(
      gram_solve_dense_kernel<KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_solve_dense_kernel<KMAX><<<S, cfk::kThreads, smem, stream>>>(
      table, F, k, nb, wt, rt, meta, nt, ng, T, BG, reg, reg_mode, lam, lseg,
      ca, cb, cin, x, ca_out, cb_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfk_gram_solve_dense(
    const float* table, int F, int k, const int* nb, const float* wt,
    const float* rt, const int* meta, int nt, int ng, int T, int BG, int S,
    const float* reg, int reg_mode, float lam, const int* lseg,
    const float* ca, const float* cb, const float* cin, float* x,
    float* ca_out, float* cb_out, int device, void* stream) {
  if (S == 0) return 0;
  if (k < 1 || k > 128 || ng < 1 || nt % ng != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch<32>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, reg,
                      reg_mode, lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
  if (k <= 64)
    return launch<64>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, reg,
                      reg_mode, lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
  return launch<128>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, reg,
                     reg_mode, lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
}
