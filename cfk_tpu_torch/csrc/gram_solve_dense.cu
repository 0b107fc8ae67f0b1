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
// gather source — one CTA per segment walks its tiles' windows kRows rows
// at a time (tiles with an empty window, group padding, cost one metadata
// read), then the carry fold, the raw carry-row copy, the ridge and the
// Cholesky solve run in place in shared memory: the [S, k, k] batch never
// reaches device memory, only x and the carry row do.
// gram_solve_tiles_dense.cu is its twin on a materialized stream.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_solve_dense(
    const float* table, int F, int k, const int* nb, const float* wt,
    const float* rt, const int* meta, int nt, int ng, int T, int BG, int S,
    const float* reg, int reg_mode, float lam, const int* lseg,
    const float* ca, const float* cb, const float* cin, float* x,
    float* ca_out, float* cb_out, int device, void* stream) {
  return cfk::launch_gram_solve(cfk::GatherRows{table, F, nb, wt},
                                cfk::DenseWalk{meta, nt, ng, T, BG}, k, S, rt,
                                reg, reg_mode, lam, lseg, ca, cb, cin, x,
                                ca_out, cb_out, device, stream);
}
