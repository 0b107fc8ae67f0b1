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
// Design: gram_kernels.cuh's gram_solve shape on the tile walk with the
// gather source — K2's units and K3's epilogue (carry fold, raw carry-row
// copy, ridge, the blocked Cholesky solve of spd_solve.cuh in place);
// only x and the carry row reach device memory.  A class of tens of
// thousands of short rows is one solve per entity after a short walk, so
// the solve's latency (a chain of k pivots, 12 CTA barriers at k = 128)
// sets the class's time.  A width class's Zipf-head entity (one row of 1.2M entries) is
// spread over its ~1,200 units, and its partials are summed by ~65 slice
// CTAs at k = 128 before one CTA solves it.  The shared memory (16.5 KB
// static stage, 4.5 KB of solve scratch, 66 KB dynamic at k = 128) fits
// one CTA of any width class,
// so no bucket is split for the kernel's sake.  gram_solve_tiles.cu is its
// twin on a materialized stream.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_solve_gather(
    const void* table, int kind, int F, int k, const int* nb,
    const float* wt, const float* rt, const int* units, int nu,
    const int* splits, int nsp, float* scratch, int* tickets,
    const float* reg, int reg_mode, float lam, const int* lseg,
    const float* ca, const float* cb, const float* cin, float* x,
    float* ca_out, float* cb_out, int device, void* stream) {
  return cfk::with_kind(kind, [&](auto tag) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram_solve(
        cfk::GatherRows<T>{(const T*)table, F, nb, wt},
        cfk::TileWalk{}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, tickets}, rt,
        cfk::SolveEpilogue{reg, reg_mode, lam, lseg, x, ca_out, cb_out}, ca,
        cb, cin, device, stream);
  });
}
