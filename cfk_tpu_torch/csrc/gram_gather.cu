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
// This kernel computes the full k x k Gram, twice the symmetric half.
//
// Design: one CTA per owner segment.  The CTA binary-searches seg for its
// contiguous tile range, then walks its rows kRows at a time: gathers them
// straight from the table into shared memory (premultiplied by wt), and
// every thread adds the rank-1 terms of its RT x RT register block of A,
// flushed into the segment's (A, b) in device memory every 1,024 rows and
// at the end (common.cuh: a two-level sum stays accurate over a
// million-row segment).  A pass whose
// rows are all padding (zero row or zero weight) is skipped, so chunk
// padding costs index reads only.  Skew is this design's weak point: one
// hot entity is one CTA on one SM.
#include "common.cuh"

namespace {

template <int KMAX>
__global__ void __launch_bounds__(cfk::kThreads)
gram_gather_kernel(const float* __restrict__ table, int F, int k,
                   const int* __restrict__ nb, const float* __restrict__ wt,
                   const float* __restrict__ rt, const int* __restrict__ seg,
                   int nt, int T, const float* __restrict__ ca,
                   const float* __restrict__ cb, const float* __restrict__ cin,
                   float* __restrict__ out_a, float* __restrict__ out_b) {
  __shared__ cfk::RowStage<KMAX> st;
  const int s = blockIdx.x;
  const long row0 = (long)cfk::lower_bound(seg, nt, s) * T;
  const long row1 = (long)cfk::lower_bound(seg, nt, s + 1) * T;
  cfk::GramAcc<KMAX> acc;
  acc.init(out_a + (size_t)s * k * k, k, out_b + (size_t)s * k, k);
  for (long base = row0; base < row1; base += cfk::kRows) {
    bool live = false;
    if (threadIdx.x < cfk::kRows) {
      const long p = base + threadIdx.x;
      const bool valid = p < row1;
      live = cfk::GramAcc<KMAX>::stage(
          st, valid, valid ? __ldg(nb + p) : -1, valid ? __ldg(wt + p) : 0.0f,
          valid ? __ldg(rt + p) : 0.0f, F);
    }
    acc.add_rows(st, live, table);
  }
  if (s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.flush();
}

template <int KMAX>
int launch(const float* table, int F, int k, const int* nb, const float* wt,
           const float* rt, const int* seg, int nt, int T, int S,
           const float* ca, const float* cb, const float* cin, float* out_a,
           float* out_b, cudaStream_t stream) {
  gram_gather_kernel<KMAX><<<S, cfk::kThreads, 0, stream>>>(
      table, F, k, nb, wt, rt, seg, nt, T, ca, cb, cin, out_a, out_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cfk_gram_gather(const float* table, int F, int k,
                               const int* nb, const float* wt, const float* rt,
                               const int* seg, int nt, int T, int S,
                               const float* ca, const float* cb,
                               const float* cin, float* out_a, float* out_b,
                               int device, void* stream) {
  if (S == 0) return 0;
  if (k < 1 || k > 128) return (int)cudaErrorInvalidValue;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return (int)dev_err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch<32>(table, F, k, nb, wt, rt, seg, nt, T, S, ca, cb, cin, out_a, out_b, st);
  if (k <= 64)
    return launch<64>(table, F, k, nb, wt, rt, seg, nt, T, S, ca, cb, cin, out_a, out_b, st);
  return launch<128>(table, F, k, nb, wt, rt, seg, nt, T, S, ca, cb, cin, out_a, out_b, st);
}
