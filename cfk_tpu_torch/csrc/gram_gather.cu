// K2 gram_gather: per-owner-segment Gram matrices and right-hand sides of
// one tiled chunk, with the neighbor rows gathered inside the kernel.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_tiles_gather_pallas
// (_gram_gather_groups_kernel, _walk_tiles, _tile_grams).  For the C
// entries of a chunk, cut into NT tiles of T rows with owner seg[tile]
// (sorted, so each owner's tiles are contiguous):
//   g_r  = table[nb_r]·wt_r          (nb_r >= F reads the zero row)
//   A_s  = Σ_{r in s} g_r g_rᵀ,  b_s = Σ_{r in s} rt_r·g_r
// plus cin·(ca, cb) folded into segment 0 when a carry is given.  Segments
// owning no tile get zeros (the TPU kernel leaves them unwritten; callers
// route those rows to the trash row either way).
//
// What bounds it on the H100: operations.  Each live row needs k² + 3k
// FP32 flops (the symmetric Gram's k(k+1)/2 multiply-adds, b's k) against
// 12 bytes of nb/wt/rt and at most k·4 gathered bytes; a chunk references
// far fewer distinct table rows than it has rows, so the flops dominate.
// This kernel computes the full k x k Gram, twice the symmetric half.  At
// the Netflix shape (rank 64, ~1M rows a chunk) it runs at ~8x that bound:
// each pass waits on its index loads, then its row loads, between
// barriers, and a chunk whose one segment holds all its rows adds the
// reduction of ~2,200 partials per element.
//
// Design: gram_kernels.cuh's gram shape on the tile walk with the gather
// source.  What bounded the one-CTA-per-segment design was skew, not the
// flops: a Netflix accum chunk holds a few hundred segments, one hot movie
// ~180k of its ~1M rows, so the chunk waited on one CTA walking that movie
// alone (93 ns per row) while the other SMs idled.  Now the grid is the
// chunk's work units — each segment cut into runs of at most 1,024 rows —
// so the hot movie is spread over ~180 CTAs; a one-unit segment's CTA
// writes its (A, b) directly, the units of a longer segment write register
// partials to scratch and a second launch sums them per Gram element in
// unit order (deterministic, equal to the running two-level sums).  Rows
// are gathered straight from the table into shared memory (premultiplied
// by wt), a pass whose rows are all padding skipped, so chunk padding costs
// index reads only.  gram_tiles.cu is its twin on a materialized stream.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_gather(const void* table, int kind, int F,
                               int k, const int* nb, const float* wt,
                               const float* rt, const int* units, int nu,
                               const int* splits, int nsp, float* scratch,
                               const float* ca, const float* cb,
                               const float* cin, float* out_a, float* out_b,
                               int device, void* stream) {
  return cfk::with_kind(kind, [&](auto tag) {
    using T = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram(
        cfk::GatherRows<T>{(const T*)table, F, nb, wt},
        cfk::TileWalk{}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, nullptr}, rt, ca, cb, cin,
        out_a, out_b, device, stream);
  });
}
