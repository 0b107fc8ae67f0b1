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
// Design: K3 (gram_solve_dense.cu) with the epilogue left out —
// gram_kernels.cuh's gram shape on the dense walk with the gather source:
// the same units and sums, a one-unit segment's sums written straight to
// its rows of the output, a longer segment's partials summed by the second
// launch, the carry folded into the last partial, as in K3.  Each Gram
// element therefore takes the same float32 operations in the same order as
// K3's, so the split schedule (this kernel, then K1's ridge and Cholesky,
// which K3's epilogue shares) solves the same bits as K3.
// gram_tiles_dense.cu is its twin on a materialized stream.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_tiles_dense_gather(
    const void* table, int kind, int F, int k, const int* nb,
    const float* wt, const float* rt, const int* meta, int nt, int ng, int T,
    int BG, const int* units, int nu, const int* splits, int nsp,
    float* scratch, const float* ca, const float* cb, const float* cin,
    float* out_a, float* out_b, int device, void* stream) {
  return cfk::with_kind(kind, [&](auto tag) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram(
        cfk::GatherRows<E>{(const E*)table, F, nb, wt},
        cfk::DenseWalk{meta, nt, ng, T, BG}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, nullptr}, rt, ca, cb, cin,
        out_a, out_b, device, stream);
  });
}
