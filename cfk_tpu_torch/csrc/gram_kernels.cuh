// The tiled layout's Gram kernels, templated on their walk and their row
// source (common.cuh).  Two shapes:
//   gram_kernel        per-segment (A [S,k,k], b [S,k]) written to device
//                      memory, cin·(ca, cb) folded into segment 0;
//   gram_solve_kernel  the same sums kept in shared memory, then the fused
//                      epilogue: carry fold, the RAW (A, b) of segment lseg
//                      as the next chunk's carry, the ridge, the Cholesky
//                      solve; only x [S,k] and the carry row leave the CTA.
// Two walks: TileWalk (a chunk of [T]-row tiles with sorted owners seg) and
// DenseWalk (the dense stream's windowed tiles, meta = g_blk ‖ lb ‖ lo ‖ hi
// ‖ seg).  Two sources: GatherRows (the table read by index inside the
// kernel) and StreamRows (a materialized [C, k] stream).  Each kernel
// library instantiates one (shape, walk, source) behind its own C entry:
//
//   shape       walk   GatherRows                  StreamRows
//   gram        tile   gram_gather.cu (K2)         gram_tiles.cu
//   gram_solve  tile   gram_solve_gather.cu (K6)   gram_solve_tiles.cu
//   gram        dense  gram_tiles_dense_gather.cu  gram_tiles_dense.cu
//   gram_solve  dense  gram_solve_dense.cu (K3)    gram_solve_tiles_dense.cu
//
// So a gather kernel and its stream twin run the same walk, the same float32
// operations in the same order and the same epilogue: fed the stream K5
// gathers from the same operands, the twins agree bit for bit.
//
// Design (all eight): one CTA per owner segment.  The CTA finds its rows by
// binary search of the sorted owners, stages them kRows at a time into
// shared memory, and every thread adds the rank-1 terms of its RT x RT
// register block of A, flushed into the segment's running sums every 1,024
// counted rows and at the end (common.cuh: a two-level sum stays accurate
// over a million-row segment).  Segments owning no row get zeros (solve:
// x = 0); the TPU kernels leave them unwritten, and callers route those rows
// to the trash row either way.  Skew is the design's weak point: one hot
// entity is one CTA on one SM.
#pragma once

#include "common.cuh"

namespace cfk {

// The rows of segment s of a chunk of [T]-row tiles; rt stream-aligned.
struct TileWalk {
  const int* seg;
  int nt, T;

  bool valid() const { return T >= 1; }

  template <int KMAX, class Src>
  __device__ __forceinline__ void add(GramAcc<KMAX>& acc, RowStage<KMAX>& st,
                                      int s, const Src& src,
                                      const float* rt) const {
    acc.add_tile_segment(st, s, src, rt, seg, nt, T);
  }
};

// The rows of segment s of a dense-stream chunk; rt tile-aligned [NT·T].
struct DenseWalk {
  const int* meta;
  int nt, ng, T, BG;

  bool valid() const { return ng >= 1 && nt % ng == 0; }

  template <int KMAX, class Src>
  __device__ __forceinline__ void add(GramAcc<KMAX>& acc, RowStage<KMAX>& st,
                                      int s, const Src& src,
                                      const float* rt) const {
    acc.add_dense_segment(st, s, src, rt, meta, nt, ng, T, BG);
  }
};

template <int KMAX, class Walk, class Src>
__global__ void __launch_bounds__(kThreads)
gram_kernel(Src src, Walk walk, int k, const float* __restrict__ rt,
            const float* __restrict__ ca, const float* __restrict__ cb,
            const float* __restrict__ cin, float* __restrict__ out_a,
            float* __restrict__ out_b) {
  __shared__ RowStage<KMAX> st;
  const int s = blockIdx.x;
  GramAcc<KMAX> acc;
  acc.init(out_a + (size_t)s * k * k, k, out_b + (size_t)s * k, k);
  walk.add(acc, st, s, src, rt);
  if (s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.flush();
}

// Four CTAs per SM at KMAX <= 64, two at 128 (the register cap this asks
// for): a fused chunk holds thousands of short segments, and the CTAs in
// flight hide each other's latency — uncapped, the staging registers
// halved them and K3 took 1.4-1.7x as long (tools/gram_kernels_ab.py).  The
// gram shape serves few long segments and runs uncapped.
template <int KMAX, class Walk, class Src>
__global__ void __launch_bounds__(kThreads, KMAX <= 64 ? 4 : 2)
gram_solve_kernel(Src src, Walk walk, int k, const float* __restrict__ rt,
                  const float* __restrict__ reg, int reg_mode, float lam,
                  const int* __restrict__ lseg, const float* __restrict__ ca,
                  const float* __restrict__ cb, const float* __restrict__ cin,
                  float* __restrict__ x, float* __restrict__ ca_out,
                  float* __restrict__ cb_out) {
  __shared__ RowStage<KMAX> st;
  extern __shared__ float smem[];
  const int ld = k + 1;
  float* A = smem;
  float* y = smem + k * ld;
  const int s = blockIdx.x;
  GramAcc<KMAX> acc;
  acc.init(A, ld, y, k);
  walk.add(acc, st, s, src, rt);
  if (s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.flush();
  __syncthreads();
  if (s == __ldg(lseg)) {
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
      const int i = idx / k, j = idx - i * k;
      ca_out[idx] = A[i * ld + j];
    }
    for (int i = threadIdx.x; i < k; i += blockDim.x) cb_out[i] = y[i];
    __syncthreads();
  }
  add_ridge(A, ld, k, reg_mode, lam, reg, s);
  chol_solve_smem(A, ld, y, k);
  for (int i = threadIdx.x; i < k; i += blockDim.x) x[(size_t)s * k + i] = y[i];
}

// Refuses what the kernels do not take and selects the device.
template <class Walk>
inline int prepare(int k, const Walk& walk, int device) {
  if (k < 1 || k > 128 || !walk.valid()) return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

template <int KMAX, class Walk, class Src>
int launch_gram_k(Src src, Walk walk, int k, int S, const float* rt,
                  const float* ca, const float* cb, const float* cin,
                  float* out_a, float* out_b, cudaStream_t stream) {
  gram_kernel<KMAX, Walk, Src><<<S, kThreads, 0, stream>>>(
      src, walk, k, rt, ca, cb, cin, out_a, out_b);
  return (int)cudaGetLastError();
}

// One chunk's (A, b): S CTAs, one per segment.
template <class Walk, class Src>
int launch_gram(Src src, Walk walk, int k, int S, const float* rt,
                const float* ca, const float* cb, const float* cin,
                float* out_a, float* out_b, int device, void* stream) {
  if (S == 0) return 0;
  const int err = prepare(k, walk, device);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_gram_k<32>(src, walk, k, S, rt, ca, cb, cin, out_a, out_b, st);
  if (k <= 64)
    return launch_gram_k<64>(src, walk, k, S, rt, ca, cb, cin, out_a, out_b, st);
  return launch_gram_k<128>(src, walk, k, S, rt, ca, cb, cin, out_a, out_b, st);
}

template <int KMAX, class Walk, class Src>
int launch_gram_solve_k(Src src, Walk walk, int k, int S, const float* rt,
                        const float* reg, int reg_mode, float lam,
                        const int* lseg, const float* ca, const float* cb,
                        const float* cin, float* x, float* ca_out,
                        float* cb_out, cudaStream_t stream) {
  // The static row stage plus the dynamic (A, y) block pass the default
  // 48 KB at k > ~64 (KMAX = 128: 16.5 KB + 40-66 KB), so opt in every time.
  const size_t smem = sizeof(float) * (size_t)(k * (k + 1) + k);
  cudaError_t err = cudaFuncSetAttribute(
      gram_solve_kernel<KMAX, Walk, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_solve_kernel<KMAX, Walk, Src><<<S, kThreads, smem, stream>>>(
      src, walk, k, rt, reg, reg_mode, lam, lseg, ca, cb, cin, x, ca_out,
      cb_out);
  return (int)cudaGetLastError();
}

// One chunk's solved rows x and next carry: S CTAs, one per segment.
template <class Walk, class Src>
int launch_gram_solve(Src src, Walk walk, int k, int S, const float* rt,
                      const float* reg, int reg_mode, float lam,
                      const int* lseg, const float* ca, const float* cb,
                      const float* cin, float* x, float* ca_out,
                      float* cb_out, int device, void* stream) {
  if (S == 0) return 0;
  const int err = prepare(k, walk, device);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_gram_solve_k<32>(src, walk, k, S, rt, reg, reg_mode, lam,
                                   lseg, ca, cb, cin, x, ca_out, cb_out, st);
  if (k <= 64)
    return launch_gram_solve_k<64>(src, walk, k, S, rt, reg, reg_mode, lam,
                                   lseg, ca, cb, cin, x, ca_out, cb_out, st);
  return launch_gram_solve_k<128>(src, walk, k, S, rt, reg, reg_mode, lam,
                                  lseg, ca, cb, cin, x, ca_out, cb_out, st);
}

}  // namespace cfk
