// gram_solve_tiles: one chunk of [T]-row tiles of the materialized gathered
// stream, summed per owner segment, regularized and solved in one kernel —
// K6's twin on the in_kernel_gather=False schedule.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_solve_tiles_pallas
// (_gram_solve_groups_kernel, _tile_grams, _walk_tiles, _solve_epilogue).
// For the C rows of a chunk's stream g [C, k] (K5's g = table[nb]·wt, zero
// rows at padding), cut into NT tiles of T rows with owner seg[tile]:
//   A_s = Σ_{r in s} g_r g_rᵀ,  b_s = Σ_{r in s} rt_r·g_r,
//   plus cin·(ca, cb) folded into segment 0 when a carry is given;
//   (ca_out, cb_out) = the RAW (A, b) of segment lseg (the next carry);
//   x_s = (A_s + R_s)⁻¹ b_s,  R_s = λ·max(reg_s, 1)·I (diag) or reg (matrix).
// This is _emulate_gram_tiles followed by compat.emulate_fused_gram_solve.
// The stream mode's fused chunks and the bucketed layout's width-class
// pieces (one tile per entity: T = width, seg = arange(rows)) run it.
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live row
// against k·4 + 8 contiguous bytes per row, plus k³/3 + 2k² + k per
// segment for the solve.  This kernel computes the full k x k Gram.
//
// Design: gram_kernels.cuh's gram_solve shape on the tile walk with the
// stream source — K6's units, sums and epilogue, reading each row from g.
// Every pass is loaded, padding rows too (the stream holds values only, as
// the TPU kernel's input does).  On the stream K5 writes from K6's operands
// it returns K6's bits.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_solve_tiles(
    const void* g, int kind, int k, const float* rt,
    const int* units, int nu, const int* splits, int nsp, float* scratch,
    int* tickets, const float* reg, int reg_mode, float lam, const int* lseg,
    const float* ca, const float* cb, const float* cin, float* x,
    float* ca_out, float* cb_out, int device, void* stream) {
  return cfk::with_stream_kind(kind, [&](auto tag) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram_solve(
        cfk::StreamRows<T>{(const T*)g}, cfk::TileWalk{}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, tickets}, rt,
        cfk::SolveEpilogue{reg, reg_mode, lam, lseg, x, ca_out, cb_out}, ca,
        cb, cin, device, stream);
  });
}
