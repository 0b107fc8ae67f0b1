// gram_tiles: per-owner-segment Gram matrices and right-hand sides of one
// tiled chunk, read from the materialized gathered stream — K2's twin on
// the in_kernel_gather=False schedule.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_tiles_pallas
// (_gram_groups_kernel, _tile_grams, _walk_tiles).  For the C rows of a
// chunk's stream g [C, k] (g = table[nb]·wt, written by K5 gather_rows; the
// padding rows are zero rows), cut into NT tiles of T rows with owner
// seg[tile] (sorted, so each owner's tiles are contiguous):
//   A_s = Σ_{r in s} g_r g_rᵀ,  b_s = Σ_{r in s} rt_r·g_r
// plus cin·(ca, cb) folded into segment 0 when a carry is given.  This is
// the XLA emulation _emulate_gram_tiles.  Segments owning no tile get zeros
// (the TPU kernel leaves them unwritten; callers route those rows to the
// trash row either way).
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live row
// (the symmetric Gram's half plus b) against k·4 + 8 contiguous bytes of
// stream, rt and the owner per row.  This kernel computes the full k x k
// Gram, twice the symmetric half.
//
// Design: gram_kernels.cuh's gram shape on the tile walk with the stream
// source — K2's units, sums and reduction, reading each row from g in place
// of gathering it.  The stream holds values only, so every pass is loaded,
// the tile padding's zero rows too (as the TPU kernel walks them), and a
// pass of zero rows is not accumulated, as K2 skips it.  On the stream K5
// writes from K2's operands it returns K2's bits.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_tiles(const void* g, int kind, int k,
                              const float* rt, const int* units, int nu,
                              const int* splits, int nsp, float* scratch,
                              const float* ca, const float* cb,
                              const float* cin, float* out_a, float* out_b,
                              int device, void* stream) {
  return cfk::with_stream_kind(kind, [&](auto tag) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram(
        cfk::StreamRows<T>{(const T*)g}, cfk::TileWalk{}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, nullptr}, rt, ca, cb, cin,
        out_a, out_b, device, stream);
  });
}
