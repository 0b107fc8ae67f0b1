// gram_solve_tiles_dense: one dense-stream chunk's per-segment normal
// equations, read from the materialized gathered stream, accumulated,
// regularized and solved in one kernel — K3's twin on the
// in_kernel_gather=False schedule.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_solve_tiles_dense_pallas
// (_gram_solve_dense_kernel, _tile_grams_dense, _walk_tiles,
// _solve_epilogue).  The dense walk of gram_tiles_dense.cu (g stream-aligned,
// rt tile-aligned, meta = g_blk ‖ lb ‖ lo ‖ hi ‖ seg), then per segment s:
//   A_s = Σ g gᵀ, b_s = Σ rt·g, and cin·(ca, cb) folded into segment 0;
//   (ca_out, cb_out) = the RAW (A, b) of segment lseg (the next chunk's carry);
//   x_s = (A_s + R_s)⁻¹ b_s,  R_s = λ·max(reg_s, 1)·I (diag) or reg (matrix).
// _emulate_gram_dense followed by compat.emulate_fused_gram_solve.
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live
// window row against k·4 contiguous stream bytes per row, plus k³/3 + 2k² + k
// per segment for the solve.  The full k x k Gram is computed.
//
// Design: gram_kernels.cuh's gram_solve shape on the dense walk with the
// stream source — K3's units, sums and epilogue (carry fold, raw carry row,
// ridge, Cholesky in shared memory), each window row read from g.  On the
// stream K5 writes from K3's operands it returns K3's bits.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_solve_tiles_dense(
    const void* g, int kind, int k, const float* rt,
    const int* meta, int nt, int ng, int T, int BG, const int* units, int nu,
    const int* splits, int nsp, float* scratch, int* tickets,
    const float* reg, int reg_mode, float lam, const int* lseg,
    const float* ca, const float* cb, const float* cin, float* x,
    float* ca_out, float* cb_out, int device, void* stream) {
  return cfk::with_stream_kind(kind, [&](auto tag) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram_solve(
        cfk::StreamRows<E>{(const E*)g},
        cfk::DenseWalk{meta, nt, ng, T, BG}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, tickets}, rt,
        cfk::SolveEpilogue{reg, reg_mode, lam, lseg, x, ca_out, cb_out}, ca,
        cb, cin, device, stream);
  });
}
