// The tiled layout's Gram kernels, templated on their walk and their row
// source (common.cuh).  Two shapes:
//   gram        per-segment (A [S,k,k], b [S,k]) written to device memory,
//               cin·(ca, cb) folded into segment 0;
//   gram_solve  the same sums, then the fused epilogue in shared memory:
//               carry fold, the RAW (A, b) of segment lseg as the next
//               chunk's carry, the ridge, the blocked Cholesky solve of
//               spd_solve.cuh (K1's); only x [S,k] and the carry row leave
//               the kernel.
// Two walks: TileWalk (a chunk of [T]-row tiles with sorted owners) and
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
// So a gather kernel and its stream twin run the same units, the same
// float32 operations in the same order and the same epilogue: fed the
// stream K5 gathers from the same operands, the twins agree bit for bit.
//
// Design (all eight): the grid is work units, not segments.  A chunk's
// unit table (ops/kernels/gram_units.py: planned once when the blocks are
// uploaded, or derived on the device by the wrapper) cuts every segment's
// passes into units of at most kUnitPasses passes (1,024 rows), so one hot
// entity is spread over as many CTAs as it has units, and a chunk's time
// follows its live rows, not its largest segment.  A CTA stages its unit's
// rows kRows at a time into shared memory and every thread adds the rank-1
// terms of its RT x RT register block.  A segment of one unit is finished
// by that CTA, straight into its output or its epilogue.  The units of a
// longer segment write their register partials to a scratch slot each,
// summed per Gram element in unit order from zero (the carry folded into
// the last partial with fmaf, for segment 0), so the sums are
// deterministic and equal the running two-level sums a single CTA would
// form.  gram: a second launch sums every split segment, one thread per
// element, and writes the sums out.  gram_solve: the last of a segment's
// units to finish (an integer ticket after a fence) sums a segment of up
// to kInlineUnits units itself and runs the epilogue at once, beside the
// other segments' work — in a second launch the split segments' k = 128
// solves would be a serial round after each chunk's units; a longer
// segment is summed by the second launch's slice CTAs, and the last of
// them to finish runs the epilogue.  Two launches per call; no float
// atomics.
// Segments owning no row get zeros (solve: x = 0); the TPU kernels leave
// them unwritten, and callers route those rows to the trash row either way.
//
// Ranks: gram_solve takes k <= 128 (its epilogue holds the system in shared
// memory, and the reference routes larger ranks to its split schedule);
// gram takes any rank.  Up to 128 one CTA sums a unit's whole Gram; past
// it the grid gains an axis over the lower-triangle pairs of 128 x 128
// blocks (gram_pair_kernel: 3 CTAs a unit at k = 256, 10 at 512), each CTA
// summing one block, with its mirror, by the same per-element operations —
// a simple kernel that re-stages each row once per pair, not yet a fast one.
#pragma once

#include "spd_solve.cuh"

namespace cfk {

// A tile-walk unit is the rows [start, end) of the chunk's stream (rt
// stream-aligned), end - start <= kUnitPasses·kRows.
struct TileWalk {
  bool valid() const { return true; }

  template <class Acc, class Stage, class Src>
  __device__ __forceinline__ void add(Acc& acc, Stage& st, const Unit& u,
                                      const Src& src, const float* rt) const {
    for (int p = u.start; p < u.end; p += kRows)
      acc.add_pass(st, src, p, min(kRows, u.end - p), rt + p);
  }
};

// A dense-walk unit is up to kUnitPasses window passes of one segment from
// the tile-aligned position start = i·T + r (tile i, window row r), over
// the segment's tiles before tile `end`.  Tile i (NT tiles in NG groups of
// M = NT/NG) covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in
// [lo_i, hi_i), b-coefficient rt[i·T + r] (tile-aligned); tiles with an
// empty window (group padding) cost one metadata read.
struct DenseWalk {
  const int* meta;
  int nt, ng, T, BG;

  bool valid() const { return ng >= 1 && nt % ng == 0 && T >= 1; }

  template <class Acc, class Stage, class Src>
  __device__ __forceinline__ void add(Acc& acc, Stage& st, const Unit& u,
                                      const Src& src, const float* rt) const {
    const int m = nt / ng;
    const int* g_blk = meta;
    const int* lb = meta + ng;
    const int* lo = lb + nt;
    const int* hi = lo + nt;
    const int i0 = u.start / T;
    int passes = 0;
    for (int i = i0; i < u.end && passes < kUnitPasses; ++i) {
      const int r_hi = __ldg(hi + i);
      const long base = (long)__ldg(g_blk + i / m) * BG + __ldg(lb + i);
      for (int r = i == i0 ? u.start - i0 * T : __ldg(lo + i);
           r < r_hi && passes < kUnitPasses; r += kRows, ++passes)
        acc.add_pass(st, src, base + r, min(kRows, r_hi - r),
                     rt + (long)i * T + r);
    }
  }
};

// A chunk's unit plan as the kernels take it: nu units [nu, 4] (Unit
// records; a segment's units consecutive, split segments' units first), the
// nsp split segments' first units, the scratch for the split units'
// partials [*, k² + k] (A row-major, then b) and, for gram_solve, nu + nsp
// zeroed tickets (the unit launch's indexed by a segment's first unit, the
// reduce launch's by split segment).
struct Plan {
  const int* units;
  int nu;
  const int* splits;
  int nsp;
  float* scratch;
  int* tickets;
};

__device__ __forceinline__ float* partial_of(float* scratch, int u, int k) {
  return scratch + (size_t)u * (k * k + k);
}

// Element e of split segment u.s's sum: its n units' partials from unit u0
// on, added in unit order from zero, cin·(ca, cb)[e] folded into the last
// with fmaf when `carry` — the operations a single CTA's running two-level
// sum performs.  The partials were written by the previous launch.
__device__ __forceinline__ float reduce_element(const float* scratch, int u0,
                                                int n, int k, int e,
                                                bool carry, const float* ca,
                                                const float* cb,
                                                const float* cin) {
  const size_t w = (size_t)k * k + k;
  const float* p = scratch + (size_t)u0 * w + e;
  float sum = 0.0f;
#pragma unroll 8
  for (int j = 0; j < n - 1; ++j) sum += __ldcg(p + (size_t)j * w);
  float last = __ldcg(p + (size_t)(n - 1) * w);
  if (carry)
    last = fmaf(__ldg(cin), e < k * k ? __ldg(ca + e) : __ldg(cb + e - k * k),
                last);
  return sum + last;
}

// A reduce launch sums each split segment's k² + k elements in slices of
// kThreads, one CTA a slice.  The gram shape takes them all; gram_solve
// takes one CTA per kReduceUnits units of the segment (CTA y then sums
// elements y·kThreads + t + j·slices·kThreads), because each of its CTAs
// holds the epilogue's shared memory (71 KB at k = 128 with the solve's
// scratch, three CTAs per SM).  gram_solve's segments of up to
// kInlineUnits units (32K rows) are summed in the unit launch by one CTA
// (at most 2 MB of partials at k = 128) before its solve.
constexpr int kReduceUnits = 16;
constexpr int kInlineUnits = 32;

__host__ __device__ __forceinline__ int max_slices(int k) {
  return (k * k + k + kThreads - 1) / kThreads;
}

// The gram shape's reduce launch: one CTA a slice up to the grid's height,
// each CTA then striding over the slices past it (k > 4,095).
constexpr int kMaxGridY = 65535;

// The ranks each shape takes.  gram_solve holds a segment's system in
// shared memory for its solve: k <= 128, the reference's fused cap.  gram
// takes any rank whose k² + k Gram elements an int indexes; past kBlk it
// runs the block-pair kernel below.
constexpr int kMaxFusedRank = 128;
constexpr int kMaxSplitRank = 46000;  // k² + k + a grid stride < 2^31

// The lower-triangle block pairs (bi >= bj) of a Gram of nb = ceil(k/kBlk)
// column blocks, numbered p = bi(bi + 1)/2 + bj: 3 at k = 256, 10 at 512.
__host__ __device__ __forceinline__ int block_pairs(int k) {
  const int nb = (k + kBlk - 1) / kBlk;
  return nb * (nb + 1) / 2;
}

__device__ __forceinline__ void pair_of(int p, int& bi, int& bj) {
  bi = 0;
  while ((bi + 1) * (bi + 2) / 2 <= p) ++bi;
  bj = p - bi * (bi + 1) / 2;
}

// Uncapped: two CTAs per SM at KMAX = 128 (128 registers, spilling) ran
// 10% faster on 1M-row chunks but 36% slower on the implicit runs'
// 49,152-entry chunks (tools/gram_kernels_ab.py, chip_smoke.py; PERF.md).
template <int KMAX, class Walk, class Src>
__global__ void __launch_bounds__(kThreads)
gram_kernel(Src src, Walk walk, int k, const int* __restrict__ units,
            const float* __restrict__ rt, const float* __restrict__ ca,
            const float* __restrict__ cb, const float* __restrict__ cin,
            float* __restrict__ out_a, float* __restrict__ out_b,
            float* __restrict__ scratch) {
  __shared__ RowStage<KMAX> st;
  const Unit u = load_unit(units, blockIdx.x);
  if (u.s < 0) return;
  GramAcc<KMAX> acc;
  acc.init(k);
  walk.add(acc, st, u, src, rt);
  if (u.n > 1) {
    float* p = partial_of(scratch, blockIdx.x, k);
    acc.store(p, k, p + k * k);
    return;
  }
  if (u.s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.store(out_a + (size_t)u.s * k * k, k, out_b + (size_t)u.s * k);
}

// The split Gram past k = 128: grid (work unit, block pair), pairs the
// fast index, so a unit's CTAs run together and share its rows in L2.  The
// CTA of unit u and pair (bi, bj) walks u's rows as gram_kernel walks them,
// staging the two kBlk-column slices its block reads (the last block masked
// at k), and writes its block and the mirror — into the segment's (A, b),
// or, for a split segment's unit, into the unit's [k² + k] partial slot,
// which gram_reduce_kernel sums per element as below k = 128.  The diagonal
// blocks' CTAs form b's slices and fold the carry's.
template <class Walk, class Src>
__global__ void __launch_bounds__(kThreads)
gram_pair_kernel(Src src, Walk walk, int k, int pairs,
                 const int* __restrict__ units, const float* __restrict__ rt,
                 const float* __restrict__ ca, const float* __restrict__ cb,
                 const float* __restrict__ cin, float* __restrict__ out_a,
                 float* __restrict__ out_b, float* __restrict__ scratch) {
  __shared__ PairStage st;
  const int ui = blockIdx.x / pairs;
  const Unit u = load_unit(units, ui);
  if (u.s < 0) return;
  int bi, bj;
  pair_of(blockIdx.x - ui * pairs, bi, bj);
  PairAcc acc;
  acc.init(k, bi, bj);
  walk.add(acc, st, u, src, rt);
  if (u.n > 1) {
    float* p = partial_of(scratch, ui, k);
    acc.store(p, k, p + (size_t)k * k);
    return;
  }
  if (u.s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
  acc.store(out_a + (size_t)u.s * k * k, k, out_b + (size_t)u.s * k);
}

// grid (split segment, slice): the split segments' sums.
__global__ void __launch_bounds__(kThreads)
gram_reduce_kernel(int k, const int* __restrict__ units,
                   const int* __restrict__ splits,
                   const float* __restrict__ ca, const float* __restrict__ cb,
                   const float* __restrict__ cin,
                   const float* __restrict__ scratch,
                   float* __restrict__ out_a, float* __restrict__ out_b) {
  const int u0 = __ldg(splits + blockIdx.x);
  if (u0 < 0) return;
  const Unit u = load_unit(units, u0);
  for (int e = blockIdx.y * kThreads + threadIdx.x; e < k * k + k;
       e += gridDim.y * kThreads) {
    const float v = reduce_element(scratch, u0, u.n, k, e,
                                   u.s == 0 && ca != nullptr, ca, cb, cin);
    if (e < k * k)
      out_a[(size_t)u.s * k * k + e] = v;
    else
      out_b[(size_t)u.s * k + e - k * k] = v;
  }
}

// The fused epilogue of segment s, whose raw sums are in shared memory in
// spd_solve's layout (A [k, k] with row stride spd_ld(k), y its row k; the
// caller synchronized).
struct SolveEpilogue {
  const float* reg;
  int reg_mode;
  float lam;
  const int* lseg;
  float* x;
  float* ca_out;
  float* cb_out;

  template <int KMAX>
  __device__ void run(float* A, int k, int s) const {
    const int ld = spd_ld(k);
    const float* y = A + k * ld;
    if (s == __ldg(lseg)) {
      for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
        const int i = idx / k, j = idx - i * k;
        ca_out[idx] = A[i * ld + j];
      }
      for (int i = threadIdx.x; i < k; i += blockDim.x) cb_out[i] = y[i];
      __syncthreads();
    }
    add_ridge(A, ld, k, reg_mode, lam, reg, s, true);
    spd_solve<KMAX>(A, ld, k);
    for (int i = threadIdx.x; i < k; i += blockDim.x)
      x[(size_t)s * k + i] = y[i];
  }
};

// Four CTAs per SM at KMAX <= 64, two at 128 (the register cap this asks
// for): a fused chunk holds thousands of short segments, and the CTAs in
// flight hide each other's latency — uncapped, the staging registers
// halved them and K3 took 1.4-1.7x as long (tools/gram_kernels_ab.py).
template <int KMAX, class Walk, class Src>
__global__ void __launch_bounds__(kThreads, KMAX <= 64 ? 4 : 2)
gram_solve_kernel(Src src, Walk walk, int k, const int* __restrict__ units,
                  const float* __restrict__ rt, SolveEpilogue ep,
                  const float* __restrict__ ca, const float* __restrict__ cb,
                  const float* __restrict__ cin, float* scratch,
                  int* __restrict__ tickets) {
  __shared__ RowStage<KMAX> st;
  __shared__ bool last;
  extern __shared__ float smem[];
  const Unit u = load_unit(units, blockIdx.x);
  if (u.s < 0) return;
  GramAcc<KMAX> acc;
  acc.init(k);
  walk.add(acc, st, u, src, rt);
  const int ld = spd_ld(k);
  float* A = smem;
  float* y = smem + k * ld;
  if (u.n == 1) {
    if (u.s == 0 && ca != nullptr) acc.fold_carry(ca, cb, __ldg(cin));
    acc.store(A, ld, y);
    __syncthreads();
    ep.template run<KMAX>(A, k, u.s);
    return;
  }
  float* p = partial_of(scratch, blockIdx.x, k);
  acc.store(p, k, p + k * k);
  if (u.n > kInlineUnits) return;  // the reduce launch's
  const int u0 = blockIdx.x - u.j;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(tickets + u0, 1) == u.n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int e = threadIdx.x; e < k * k + k; e += blockDim.x) {
    const float v = reduce_element(scratch, u0, u.n, k, e,
                                   u.s == 0 && ca != nullptr, ca, cb, cin);
    if (e < k * k)
      A[(e / k) * ld + e % k] = v;
    else
      y[e - k * k] = v;
  }
  __syncthreads();
  ep.template run<KMAX>(A, k, u.s);
}

// grid (split segment, slice), segments of more than kInlineUnits units:
// each slice CTA writes its elements of the segment's sums over the
// segment's first partial (only the thread that read an element writes
// it), then takes a ticket; the last of the segment's slices to arrive
// loads the sums and runs the epilogue.
template <int KMAX>
__global__ void __launch_bounds__(kThreads)
gram_solve_reduce_kernel(int k, const int* __restrict__ units,
                         const int* __restrict__ splits, SolveEpilogue ep,
                         const float* __restrict__ ca,
                         const float* __restrict__ cb,
                         const float* __restrict__ cin, float* scratch,
                         int* __restrict__ tickets) {
  extern __shared__ float smem[];
  __shared__ bool last;
  const int u0 = __ldg(splits + blockIdx.x);
  if (u0 < 0) return;
  const Unit u = load_unit(units, u0);
  if (u.n <= kInlineUnits) return;  // summed in the unit launch
  const int sl =
      min(max_slices(k), (u.n + kReduceUnits - 1) / kReduceUnits);
  if ((int)blockIdx.y >= sl) return;
  float* sum = partial_of(scratch, u0, k);
  for (int e = blockIdx.y * kThreads + threadIdx.x; e < k * k + k;
       e += sl * kThreads)
    sum[e] = reduce_element(scratch, u0, u.n, k, e,
                            u.s == 0 && ca != nullptr, ca, cb, cin);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(tickets + blockIdx.x, 1) == sl - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int ld = spd_ld(k);
  float* A = smem;
  float* y = smem + k * ld;
  for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
    const int i = idx / k, j = idx - i * k;
    A[i * ld + j] = __ldcg(sum + idx);
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) y[i] = __ldcg(sum + k * k + i);
  __syncthreads();
  ep.template run<KMAX>(A, k, u.s);
}

// Refuses what the kernels do not take (k past the shape's `kmax`) and
// selects the device.
template <class Walk>
inline int prepare(int k, int kmax, const Walk& walk, const Plan& plan,
                   int device) {
  if (k < 1 || k > kmax || !walk.valid() || plan.nu < 0 || plan.nsp < 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSetDevice(device);
}

inline int launch_gram_reduce(int k, const Plan& plan, const float* ca,
                              const float* cb, const float* cin, float* out_a,
                              float* out_b, cudaStream_t stream) {
  gram_reduce_kernel<<<dim3(plan.nsp, min(max_slices(k), kMaxGridY)),
                       kThreads, 0, stream>>>(k, plan.units, plan.splits, ca,
                                              cb, cin, plan.scratch, out_a,
                                              out_b);
  return (int)cudaGetLastError();
}

template <int KMAX, class Walk, class Src>
int launch_gram_k(Src src, Walk walk, int k, const Plan& plan,
                  const float* rt, const float* ca, const float* cb,
                  const float* cin, float* out_a, float* out_b,
                  cudaStream_t stream) {
  gram_kernel<KMAX, Walk, Src><<<plan.nu, kThreads, 0, stream>>>(
      src, walk, k, plan.units, rt, ca, cb, cin, out_a, out_b, plan.scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.nsp == 0) return (int)err;
  return launch_gram_reduce(k, plan, ca, cb, cin, out_a, out_b, stream);
}

template <class Walk, class Src>
int launch_gram_pairs(Src src, Walk walk, int k, const Plan& plan,
                      const float* rt, const float* ca, const float* cb,
                      const float* cin, float* out_a, float* out_b,
                      cudaStream_t stream) {
  const int pairs = block_pairs(k);
  if ((long long)plan.nu * pairs > 0x7fffffffLL)
    return (int)cudaErrorInvalidConfiguration;
  gram_pair_kernel<Walk, Src><<<plan.nu * pairs, kThreads, 0, stream>>>(
      src, walk, k, pairs, plan.units, rt, ca, cb, cin, out_a, out_b,
      plan.scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || plan.nsp == 0) return (int)err;
  return launch_gram_reduce(k, plan, ca, cb, cin, out_a, out_b, stream);
}

// One chunk's (A, b): the unit launch, then the split segments' reduction;
// past k = 128 the unit launch is the block-pair kernel's.
template <class Walk, class Src>
int launch_gram(Src src, Walk walk, int k, const Plan& plan, const float* rt,
                const float* ca, const float* cb, const float* cin,
                float* out_a, float* out_b, int device, void* stream) {
  const int err = prepare(k, kMaxSplitRank, walk, plan, device);
  if (err != 0 || plan.nu == 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_gram_k<32>(src, walk, k, plan, rt, ca, cb, cin, out_a, out_b, st);
  if (k <= 64)
    return launch_gram_k<64>(src, walk, k, plan, rt, ca, cb, cin, out_a, out_b, st);
  if (k <= kBlk)
    return launch_gram_k<128>(src, walk, k, plan, rt, ca, cb, cin, out_a, out_b, st);
  return launch_gram_pairs(src, walk, k, plan, rt, ca, cb, cin, out_a, out_b, st);
}

template <int KMAX, class Walk, class Src>
int launch_gram_solve_k(Src src, Walk walk, int k, const Plan& plan,
                        const float* rt, const SolveEpilogue& ep,
                        const float* ca, const float* cb, const float* cin,
                        cudaStream_t stream) {
  // The static row stage and solve scratch plus the dynamic (A, y) block
  // pass the default 48 KB at k > ~64 (KMAX = 128: 21 KB + 40-66 KB), so
  // opt in every time.
  const size_t smem = sizeof(float) * (size_t)spd_floats(k);
  cudaError_t err = cudaFuncSetAttribute(
      gram_solve_kernel<KMAX, Walk, Src>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_solve_kernel<KMAX, Walk, Src><<<plan.nu, kThreads, smem, stream>>>(
      src, walk, k, plan.units, rt, ep, ca, cb, cin, plan.scratch,
      plan.tickets);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.nsp == 0) return (int)err;
  err = cudaFuncSetAttribute(gram_solve_reduce_kernel<KMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  gram_solve_reduce_kernel<KMAX><<<dim3(plan.nsp, max_slices(k)), kThreads, smem,
                             stream>>>(k, plan.units, plan.splits, ep, ca, cb,
                                       cin, plan.scratch,
                                       plan.tickets + plan.nu);
  return (int)cudaGetLastError();
}

// One chunk's solved rows x and next carry: the unit launch (one-unit
// segments solved in place), then the split segments' reduction and solve.
template <class Walk, class Src>
int launch_gram_solve(Src src, Walk walk, int k, const Plan& plan,
                      const float* rt, const SolveEpilogue& ep,
                      const float* ca, const float* cb, const float* cin,
                      int device, void* stream) {
  const int err = prepare(k, kMaxFusedRank, walk, plan, device);
  if (err != 0 || plan.nu == 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 32)
    return launch_gram_solve_k<32>(src, walk, k, plan, rt, ep, ca, cb, cin, st);
  if (k <= 64)
    return launch_gram_solve_k<64>(src, walk, k, plan, rt, ep, ca, cb, cin, st);
  return launch_gram_solve_k<128>(src, walk, k, plan, rt, ep, ca, cb, cin, st);
}

}  // namespace cfk
