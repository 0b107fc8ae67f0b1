// gram_tiles_dense_gather: one dense-stream chunk's per-segment normal
// equations, gathered and accumulated, written to device memory — the split
// epilogue's Gram (kernel K1 solves them).
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_tiles_dense_gather_pallas
// (_gram_gather_dense_kernel, _tile_grams_dense, _walk_tiles).  Tile i of
// the chunk (NT tiles in NG groups of M = NT/NG; meta = g_blk ‖ lb ‖ lo ‖
// hi ‖ seg) covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in
// [lo_i, hi_i), with b-coefficient rt[i·T + r]; seg is sorted.  Per
// segment s:
//   g_p = table[nb_p]·wt_p   (wt = 1 when absent; nb_p >= F is the zero row)
//   A_s = Σ g gᵀ, b_s = Σ rt·g, and cin·(ca, cb) folded into segment 0.
// The indexing of the XLA emulation _emulate_gram_dense
// (gram_kernel.py:581-615).  Segments owning no tile get zeros (the TPU
// kernel leaves them unwritten; callers route those rows to the trash row).
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live
// window row (the symmetric Gram's half plus b) against at most k·4
// gathered bytes, plus the S·(k² + k)·4 bytes of (A, b) written.  This
// kernel computes the full k x k Gram, twice the symmetric half.
//
// Design: K3 (gram_solve_dense.cu) with the epilogue left out.  One CTA per
// segment walks the same windows with the same two-level sums
// (GramAcc::add_dense_segment, common.cuh), accumulating straight into the
// segment's rows of the output, as K2 does; the carry is folded into the
// register partial before the last flush, as in K3.  Each Gram element
// therefore takes the same float32 operations in the same order as in K3's
// shared memory, so the split schedule (this kernel, then K1's ridge and
// Cholesky, which K3's epilogue shares) solves the same bits as K3.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(cfk::kThreads)
gram_tiles_dense_gather_kernel(const float* __restrict__ table, int F, int k,
                               const int* __restrict__ nb,
                               const float* __restrict__ wt,
                               const float* __restrict__ rt,
                               const int* __restrict__ meta, int nt, int ng,
                               int T, int BG, const float* __restrict__ ca,
                               const float* __restrict__ cb,
                               const float* __restrict__ cin,
                               float* __restrict__ out_a,
                               float* __restrict__ out_b) {
  __shared__ cfk::RowStage<KMAX> st;
  const int s = blockIdx.x;
  cfk::GramAcc<KMAX> acc;
  acc.init(out_a + (size_t)s * k * k, k, out_b + (size_t)s * k, k);
  acc.add_dense_segment(st, s, table, F, nb, wt, rt, meta, nt, ng, T, BG);
  if (s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.flush();
}

template <int KMAX>
int launch(const float* table, int F, int k, const int* nb, const float* wt,
           const float* rt, const int* meta, int nt, int ng, int T, int BG,
           int S, const float* ca, const float* cb, const float* cin,
           float* out_a, float* out_b, cudaStream_t stream) {
  gram_tiles_dense_gather_kernel<KMAX><<<S, cfk::kThreads, 0, stream>>>(
      table, F, k, nb, wt, rt, meta, nt, ng, T, BG, ca, cb, cin, out_a,
      out_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfk_gram_tiles_dense_gather(
    const float* table, int F, int k, const int* nb, const float* wt,
    const float* rt, const int* meta, int nt, int ng, int T, int BG, int S,
    const float* ca, const float* cb, const float* cin, float* out_a,
    float* out_b, int device, void* stream) {
  if (S == 0) return 0;
  if (k < 1 || k > 128 || ng < 1 || nt % ng != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch<32>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, ca, cb,
                      cin, out_a, out_b, st);
  if (k <= 64)
    return launch<64>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, ca, cb,
                      cin, out_a, out_b, st);
  return launch<128>(table, F, k, nb, wt, rt, meta, nt, ng, T, BG, S, ca, cb,
                     cin, out_a, out_b, st);
}
