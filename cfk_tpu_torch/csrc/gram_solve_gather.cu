// K6 gram_solve_gather: one chunk of [T]-row tiles gathered, summed per owner
// segment, regularized and solved in one kernel.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_solve_tiles_gather_pallas
// (_gram_solve_gather_groups_kernel, _walk_tiles, _tile_grams,
// _solve_epilogue).  For the C entries of a chunk, cut into NT tiles of T
// rows with owner seg[tile] (sorted, so each owner's tiles are contiguous):
//   g_r = table[nb_r]·wt_r           (nb_r outside [0, F) is the zero row)
//   A_s = Σ_{r in s} g_r g_rᵀ,  b_s = Σ_{r in s} rt_r·g_r,
//   plus cin·(ca, cb) folded into segment 0 when a carry is given;
//   (ca_out, cb_out) = the RAW (A, b) of segment lseg (the next carry);
//   x_s = (A_s + R_s)⁻¹ b_s,  R_s = λ·max(reg_s, 1)·I (diag) or reg (matrix).
// This is the XLA emulation _emulate_gram_tiles followed by
// compat.emulate_fused_gram_solve.  The bucketed layout runs every width
// class through it with one tile per entity (T = width, seg = arange(rows)).
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live row
// (the symmetric Gram's half plus b) against at most k·4 gathered bytes,
// plus k³/3 + 2k² + k per segment for the solve.  This kernel computes the
// full k x k Gram, twice the symmetric half.
//
// Design: one CTA per segment — K2's walk (binary search of seg for the
// CTA's tile range, kRows gathered rows at a time into shared memory, RT x RT
// register blocks of A per thread flushed into the Gram in shared memory
// every 1,024 rows, all-padding passes skipped) and K3's epilogue (carry
// fold, raw carry-row copy, ridge, Cholesky in place), from common.cuh.  The
// two-level sum matters most here: one entity's whole width class row is
// one segment, a million rows for the Zipf head.  Only x and the carry row reach
// device memory.  The grid's x dimension takes up to 2³¹ − 1 segments and the
// shared memory (16.5 KB static stage + 66 KB dynamic at k = 128) fits one
// CTA of any width class, so no bucket is split for the kernel's sake.  Skew
// is this design's weak point: a width class whose widest row holds a
// Zipf-head entity waits on that one CTA.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(cfk::kThreads)
gram_solve_gather_kernel(const float* __restrict__ table, int F, int k,
                         const int* __restrict__ nb,
                         const float* __restrict__ wt,
                         const float* __restrict__ rt,
                         const int* __restrict__ seg, int nt, int T,
                         const float* __restrict__ reg, int reg_mode,
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
  const long row0 = (long)cfk::lower_bound(seg, nt, s) * T;
  const long row1 = (long)cfk::lower_bound(seg, nt, s + 1) * T;
  cfk::GramAcc<KMAX> acc;
  acc.init(A, ld, y, k);
  for (long base = row0; base < row1; base += cfk::kRows) {
    bool live = false;
    if (threadIdx.x < cfk::kRows) {
      const long p = base + threadIdx.x;
      const bool valid = p < row1;
      live = cfk::GramAcc<KMAX>::stage(
          st, valid, valid ? __ldg(nb + p) : -1, valid ? __ldg(wt + p) : 0.0f,
          valid ? __ldg(rt + p) : 0.0f, F);
    }
    acc.add_rows(st, live, table);
  }
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
           const float* rt, const int* seg, int nt, int T, int S,
           const float* reg, int reg_mode, float lam, const int* lseg,
           const float* ca, const float* cb, const float* cin, float* x,
           float* ca_out, float* cb_out, cudaStream_t stream) {
  // As in K3: the static row stage plus this dynamic block pass the default
  // 48 KB at k > ~64, so opt in every time.
  const size_t smem = sizeof(float) * (size_t)(k * (k + 1) + k);
  cudaError_t err = cudaFuncSetAttribute(
      gram_solve_gather_kernel<KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_solve_gather_kernel<KMAX><<<S, cfk::kThreads, smem, stream>>>(
      table, F, k, nb, wt, rt, seg, nt, T, reg, reg_mode, lam, lseg, ca, cb,
      cin, x, ca_out, cb_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfk_gram_solve_gather(
    const float* table, int F, int k, const int* nb, const float* wt,
    const float* rt, const int* seg, int nt, int T, int S, const float* reg,
    int reg_mode, float lam, const int* lseg, const float* ca,
    const float* cb, const float* cin, float* x, float* ca_out,
    float* cb_out, int device, void* stream) {
  if (S == 0) return 0;
  if (k < 1 || k > 128 || T < 1) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch<32>(table, F, k, nb, wt, rt, seg, nt, T, S, reg, reg_mode,
                      lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
  if (k <= 64)
    return launch<64>(table, F, k, nb, wt, rt, seg, nt, T, S, reg, reg_mode,
                      lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
  return launch<128>(table, F, k, nb, wt, rt, seg, nt, T, S, reg, reg_mode,
                     lam, lseg, ca, cb, cin, x, ca_out, cb_out, st);
}
