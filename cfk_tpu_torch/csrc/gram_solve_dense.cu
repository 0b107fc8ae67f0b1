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
// Design: gram_kernels.cuh's gram_solve shape on the dense walk with the
// gather source.  What bounded the one-CTA-per-segment design was skew: a
// chunk's time tracked its largest user (136 ns per row of it), the card
// idle around that CTA.  Now the grid is the chunk's work units — each
// segment's window passes cut into runs of at most 32 passes, a unit
// possibly starting inside a tile — so a heavy user is spread over several
// CTAs.  A one-unit segment (most users) is finished by its CTA as before:
// the carry fold, the raw carry-row copy, the ridge and the Cholesky solve
// run in place in shared memory, and the [S, k, k] batch never reaches
// device memory.  The units of a longer segment write register partials
// to scratch; a second launch sums them per Gram element in unit order
// (the carry folded into the last partial) and the last of the segment's
// slice CTAs to arrive runs the same epilogue on the sums.  What is left
// is the per-segment solve (~4,900 k = 64 systems per Netflix chunk, each
// the blocked Cholesky of spd_solve.cuh, K1's) and the FMA loop.  gram_solve_tiles_dense.cu is its twin on a
// materialized stream.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_solve_dense(
    const void* table, int kind, int F, int k, const int* nb,
    const float* wt, const float* rt, const int* meta, int nt, int ng, int T,
    int BG, const int* units, int nu, const int* splits, int nsp,
    float* scratch, int* tickets, const float* reg, int reg_mode, float lam,
    const int* lseg, const float* ca, const float* cb, const float* cin,
    float* x, float* ca_out, float* cb_out, int device, void* stream) {
  return cfk::with_kind(kind, [&](auto tag) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram_solve(
        cfk::GatherRows<E>{(const E*)table, F, nb, wt},
        cfk::DenseWalk{meta, nt, ng, T, BG}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, tickets}, rt,
        cfk::SolveEpilogue{reg, reg_mode, lam, lseg, x, ca_out, cb_out}, ca,
        cb, cin, device, stream);
  });
}
