// gram_tiles_dense: one dense-stream chunk's per-segment normal equations,
// read from the materialized gathered stream and written to device memory —
// the split epilogue's Gram (kernel K1 solves them) on the
// in_kernel_gather=False schedule; gram_tiles_dense_gather's twin.
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gram_tiles_dense_pallas
// (_gram_dense_kernel, _tile_grams_dense, _walk_tiles).  Tile i of the chunk
// (NT tiles in NG groups of M = NT/NG; meta = g_blk ‖ lb ‖ lo ‖ hi ‖ seg)
// covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in [lo_i, hi_i),
// with b-coefficient rt[i·T + r] (tile-aligned) and seg sorted; the stream
// g [C, k] is stream-aligned (K5's g = table[nb]·wt, wt = 1 when absent).
// Per segment s:
//   A_s = Σ g gᵀ, b_s = Σ rt·g, and cin·(ca, cb) folded into segment 0.
// The XLA emulation _emulate_gram_dense.  Segments owning no tile get zeros.
//
// What bounds it on the H100: operations — k² + 3k FP32 flops per live
// window row against k·4 contiguous stream bytes per row, plus the
// S·(k² + k)·4 bytes of (A, b) written.  The full k x k Gram is computed.
//
// Design: gram_kernels.cuh's gram shape on the dense walk with the stream
// source — gram_tiles_dense_gather's units, sums and reduction, each window
// row read from g in place of being gathered.  The two alignments (g by
// stream row, rt by tile slot) are the dense walk's, as in K3.  On the
// stream K5 writes from gram_tiles_dense_gather's operands it returns that
// kernel's bits.
#include "gram_kernels.cuh"

extern "C" int cfk_gram_tiles_dense(
    const void* g, int kind, int k, const float* rt,
    const int* meta, int nt, int ng, int T, int BG, const int* units, int nu,
    const int* splits, int nsp, float* scratch, const float* ca,
    const float* cb, const float* cin, float* out_a, float* out_b, int device,
    void* stream) {
  return cfk::with_stream_kind(kind, [&](auto tag) {
    using E = std::remove_const_t<std::remove_pointer_t<decltype(tag)>>;
    return cfk::launch_gram(
        cfk::StreamRows<E>{(const E*)g},
        cfk::DenseWalk{meta, nt, ng, T, BG}, k,
        cfk::Plan{units, nu, splits, nsp, scratch, nullptr}, rt, ca, cb, cin,
        out_a, out_b, device, stream);
  });
}
