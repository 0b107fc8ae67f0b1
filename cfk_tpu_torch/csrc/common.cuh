// Device code shared by the port's training kernels: the ridge add of the
// solves (spd_solve.cuh holds the SPD solve itself) and the Gram
// accumulator with its two row sources — rows gathered from the table by
// index, or read from a materialized stream — fed one work unit at a time
// by the walks of gram_kernels.cuh; every kernel library takes its
// error-string export from here.
//
// Everything is plain FP32 FMA on the CUDA cores: the JAX package pins its
// Gram and solve contractions to full float32 (precision="highest",
// cfk_tpu/ops/solve.py:30-51), so no TF32 tensor-core path is used.  A
// quantized table or stream (bf16, or int8 codes with a per-row scale
// folded into the weights, cfk_tpu/ops/quant.py) is loaded in its own type
// and converted to float32 in registers: the stage the Gram reads is float32
// for every element type, and a product of two bf16 values is exact in one
// FP32 FMA, so the sums are a bf16-input, float32-accumulating matrix
// unit's up to order.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cfk {

constexpr int kThreads = 256;  // one CTA = 16 x 16 threads
constexpr int kRows = 32;      // gathered rows staged per pass
// A segment's rows are summed in work units of at most kUnitPasses passes
// (1,024 rows), each into a register partial that starts from zero; the
// segment's sum is its units' partials added in unit order
// (ops/kernels/gram_units.py plans the units, gram_kernels.cuh spreads them
// over CTAs).  One float32 register summing a whole long segment (a
// Zipf-head entity: a million rows and more, all of an implicit Gram's
// diagonal terms positive) would lose digits with every term once the sum
// dwarfs the terms, and the normal equations' condition number amplifies
// that in the solved factors; two levels of ~sqrt(n) terms each keep the
// sums near the accuracy of the per-tile sums of the JAX package's
// matrix-unit dots.
constexpr int kUnitPasses = 32;
constexpr int kRegDiag = 0;    // ridge λ·max(n,1)·I from per-row counts
constexpr int kRegMatrix = 1;  // one shared [k,k] ridge term

// Adds the ridge to the k x k system held in shared memory (row stride ld):
// diag mode λ·max(n,1) on the diagonal (padding rows, n = 0, become λ·I),
// matrix mode the shared [k,k] term — only its lower triangle when `lower`
// (the Cholesky solve reads no more).  Matrix mode: warp w adds rows w,
// w + W, ... (W warps), each thread issuing the loads of four rows x four
// columns before any add, so a CTA waits on a few L2 round trips, not on
// one per element.
__device__ void add_ridge(float* A, int ld, int k, int reg_mode, float lam,
                          const float* reg, int row, bool lower = false) {
  if (reg_mode == kRegDiag) {
    // λ·max(n, 1) rounded, then one add, as the reference and the split
    // route's torch add: __fmul_rn keeps nvcc from fusing the two into
    // one FMA, which would round once.
    const float r = __fmul_rn(lam, fmaxf(__ldg(reg + row), 1.0f));
    for (int i = threadIdx.x; i < k; i += blockDim.x) A[i * ld + i] += r;
  } else {
    const int nw = blockDim.x / 32, lane = threadIdx.x % 32;
    for (int i0 = threadIdx.x / 32; i0 < k; i0 += 4 * nw) {
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + r * nw, j = lane + 32 * c;
          v[r][c] = i < k && j < k && (!lower || j <= i)
                        ? __ldg(reg + i * k + j) : 0.0f;
        }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = i0 + r * nw, j = lane + 32 * c;
          if (i < k && j < k && (!lower || j <= i)) A[i * ld + j] += v[r][c];
        }
    }
  }
  __syncthreads();
}

// Staging buffer for kRows rows: row r holds the pass's r-th row g_r in
// columns [0, k) and zeros up to KMAX; rt[r] is its b-coefficient.  nb and w
// are the gather source's index and weight per slot (nb = -1: a zero row).
// A float32 source stages element idx = threadIdx.x + i·kThreads (row idx /
// KMAX, column idx % KMAX: a warp reads 32 neighbouring columns of one row)
// for i < kPerThread; a bf16 or int8 source stages the kPerThread
// neighbouring elements from idx = threadIdx.x·kPerThread on, one vector
// load (load_chunk).  The sources issue all of a thread's loads before
// storing any, so a pass waits on one memory latency, not on kPerThread of
// them in turn.  Two mappings, measured: the chunked one for float32 too
// gives the same sums bit for bit but other registers (8-90 fewer in the
// Gram kernels, 9-68% fewer spill bytes in the fused ones at KMAX 64, 128)
// and other times (rank 64: rows 4 and 9 about a fifth faster, row 5 5%
// slower), so float32 keeps the strided mapping it had before the
// quantized tables came, and the choice is left to speed work.
template <int KMAX>
struct RowStage {
  static constexpr int kPerThread = kRows * KMAX / kThreads;
  float g[kRows][KMAX];
  float rt[kRows];
  float w[kRows];
  int nb[kRows];
};

// The split Gram past k = 128 (gram_kernels.cuh) sums one kBlk x kBlk block
// (bi, bj), bi >= bj, of the Gram a CTA: it stages only the two kBlk-column
// slices of each row the block reads — columns [ci, ci + kBlk) into gi and
// [cj, cj + kBlk) into gj, zeros past k — or one, gi, on the diagonal
// (ci == cj).  Element idx of a slice is row idx / kBlk, column idx % kBlk,
// as in RowStage<kBlk>'s float32 mapping, for every element type.
constexpr int kBlk = 128;

struct PairStage {
  static constexpr int kPerThread = kRows * kBlk / kThreads;
  float gi[kRows][kBlk];
  float gj[kRows][kBlk];
  float rt[kRows];
  float w[kRows];
  int nb[kRows];
};

// The element types a table or stream comes in (the C entries' `kind`):
// float32, bf16, int8 codes.  Elem<T>::load reads one element as float32;
// Elem<T>::weight is the premultiply as the reference rounds it (a bf16
// table's weight is cast to bf16, cfk_tpu/compat.py:130-132); and
// Elem<T>::premul forms g = x·w as the reference does: float32 for f32 and
// int8 (w then carries the folded scale), one bf16 rounding of the exact
// product of two bf16 values for bf16.
enum Kind { kF32 = 0, kBF16 = 1, kI8 = 2 };

template <class T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float weight(float w) { return w; }
  __device__ static float premul(float x, float w) { return x * w; }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ static float weight(float w) {
    return __bfloat162float(__float2bfloat16_rn(w));
  }
  __device__ static float premul(float x, float w) {
    return __bfloat162float(__float2bfloat16_rn(x * w));
  }
};

template <>
struct Elem<int8_t> {
  __device__ static float load(const int8_t* p) {
    return (float)__ldg(reinterpret_cast<const signed char*>(p));
  }
  __device__ static float weight(float w) { return w; }
  __device__ static float premul(float x, float w) { return x * w; }
};

// Four bytes of a bf16 or int8 row as float32: two bf16 values (the low
// half first) or four int8 codes.
__device__ __forceinline__ void unpack_word(uint32_t w, float* v,
                                            const __nv_bfloat16*) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void unpack_word(uint32_t w, float* v,
                                            const int8_t*) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(w >> (8 * i));
}

// N neighbouring elements of a bf16 or int8 row from p as float32: 16-byte
// loads (8 bf16, 16 int8 a load), or one 8- or 4-byte load when the N
// elements are fewer bytes — p aligned to min(16, N·sizeof(T)) bytes.
template <class T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  constexpr int kBytes = N * (int)sizeof(T);
  constexpr int kPerWord = 4 / (int)sizeof(T);
  static_assert(kBytes % 4 == 0, "whole 32-bit words");
  if constexpr (kBytes >= 16) {
    static_assert(kBytes % 16 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(p) + q);
      float* d = v + q * 4 * kPerWord;
      unpack_word(w.x, d, p);
      unpack_word(w.y, d + kPerWord, p);
      unpack_word(w.z, d + 2 * kPerWord, p);
      unpack_word(w.w, d + 3 * kPerWord, p);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    unpack_word(w.x, v, p);
    unpack_word(w.y, v + kPerWord, p);
  } else {
    unpack_word(__ldg(reinterpret_cast<const uint32_t*>(p)), v, p);
  }
}

// Thread t's chunk of a bf16 or int8 stage: the N = kPerThread elements of
// stage row r = t·N / KMAX from column c0 = t·N % KMAX on (a row is KMAX / N
// threads), read from `src` (the row's first element; null: a zero row) as
// float32 — one vector load when the chunk lies inside [0, k) and its
// address is aligned for it (a row stride of whole 16-byte vectors and an
// aligned base make every chunk so), else element by element with zeros
// past k.
template <class T, int N>
__device__ __forceinline__ void load_chunk(const T* src, int c0, int k,
                                           float* v) {
  constexpr unsigned kAlign = N * sizeof(T) < 16 ? N * sizeof(T) : 16;
  if (src != nullptr && c0 + N <= k &&
      (reinterpret_cast<uintptr_t>(src + c0) & (kAlign - 1)) == 0) {
    load_vec<T, N>(src + c0, v);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    v[i] = src != nullptr && c0 + i < k ? Elem<T>::load(src + c0 + i) : 0.0f;
}

// Stores a thread's chunk of N float32 values into the stage at row r,
// column c0, element by element: float4 stores would need the stage 16-byte
// aligned, and aligning it changes the float32 instantiations' registers
// and spills (ptxas), which element stores keep as a float32-only build's.
template <int KMAX, int N>
__device__ __forceinline__ void store_chunk(RowStage<KMAX>& st, int r, int c0,
                                            const float* v) {
#pragma unroll
  for (int q = 0; q < N; ++q) st.g[r][c0 + q] = v[q];
}

// One work unit of a chunk (ops/kernels/gram_units.py): segment s (< 0: a
// surplus slot, which exits at once), where its walk starts and ends (the
// walks of gram_kernels.cuh read start and end), n, the segment's unit
// count, and j, this unit's index in the segment (a segment's units are
// consecutive in the table; the record packs n | j << 16).
struct Unit {
  int s, start, end, n, j;
};

__device__ __forceinline__ Unit load_unit(const int* units, int u) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(units) + u);
  return Unit{v.x, v.y, v.z, v.w & 0xffff, v.w >> 16};
}

// Where a Gram kernel's rows come from.  A source fills the stage with the
// rows p0 .. p0+n-1 of its stream (n <= kRows; slots n.. are zero rows) and
// their b-coefficients rt[0 .. n), and returns — the same on every thread,
// after a barrier that makes the stage visible — whether the pass holds a
// row that adds anything; a pass that holds none is not accumulated (its
// terms would all be exact zeros: fmaf(0, x, a) == a).  Both sources take
// their element type T (float, __nv_bfloat16, int8_t) as a template
// parameter; the float32 instantiations run the element mapping and the
// operations they always ran.
//
// GatherRows (K2, K3, K6, gram_tiles_dense_gather): g_p = table[nb_p]·wt_p,
// gathered inside the kernel (wt null = 1), formed as Elem<T>::premul.  An
// index outside [0, F) — F is the table's virtual zero row — or a zero
// weight is a dead row; a pass with no live row is skipped before anything
// is loaded, so padding costs index reads only.  An int8 table's weights
// carry the folded scale (the wrappers refuse int8 without them).
template <class T>
struct GatherRows {
  const T* table;
  int F;
  const int* nb;
  const float* wt;

  // The pass's indices, weights (as Elem<T>::weight rounds them) and
  // b-coefficients into the stage; whether any of its rows is live (the
  // same on every thread).
  template <class Stage>
  __device__ __forceinline__ bool stage_index(Stage& st, long p0, int n,
                                              const float* rt) const {
    bool live = false;
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      const bool valid = r < n;
      const int row = valid ? __ldg(nb + p0 + r) : -1;
      const float w =
          valid ? Elem<T>::weight(wt != nullptr ? __ldg(wt + p0 + r) : 1.0f)
                : 0.0f;
      live = valid && row >= 0 && row < F && w != 0.0f;
      st.nb[r] = live ? row : -1;
      st.w[r] = w;
      st.rt[r] = valid ? __ldg(rt + r) : 0.0f;
    }
    return __syncthreads_or(live);
  }

  template <int KMAX>
  __device__ __forceinline__ bool stage(RowStage<KMAX>& st, int k, long p0,
                                        int n, const float* rt) const {
    if (!stage_index(st, p0, n, rt)) return false;
    constexpr int kPer = RowStage<KMAX>::kPerThread;
    float v[kPer];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / KMAX, c = idx % KMAX;
        const int row = st.nb[r];
        v[i] = row >= 0 && c < k
                   ? __ldg(table + (size_t)row * k + c) * st.w[r] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        st.g[idx / KMAX][idx % KMAX] = v[i];
      }
    } else {
      const int idx = threadIdx.x * kPer;
      const int r = idx / KMAX, c0 = idx % KMAX;
      const int row = st.nb[r];
      load_chunk<T, kPer>(row >= 0 ? table + (size_t)row * k : nullptr, c0,
                          k, v);
      const float w = st.w[r];
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = Elem<T>::premul(v[i], w);
      store_chunk<KMAX, kPer>(st, r, c0, v);
    }
    __syncthreads();
    return true;
  }

  // The split Gram's block pass: the slices at columns ci and cj (one when
  // ci == cj) of the same gathered rows, element by element for every T.
  // Every load of both slices is issued before any store.
  __device__ __forceinline__ bool stage_pair(PairStage& st, int k, long p0,
                                             int n, const float* rt, int ci,
                                             int cj) const {
    if (!stage_index(st, p0, n, rt)) return false;
    constexpr int kPer = PairStage::kPerThread;
    const bool two = ci != cj;
    float vi[kPer], vj[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kBlk, c = idx % kBlk;
      const int row = st.nb[r];
      const T* src = table + (size_t)row * k;
      vi[i] = row >= 0 && ci + c < k
                  ? Elem<T>::premul(Elem<T>::load(src + ci + c), st.w[r])
                  : 0.0f;
      vj[i] = two && row >= 0 && cj + c < k
                  ? Elem<T>::premul(Elem<T>::load(src + cj + c), st.w[r])
                  : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      st.gi[idx / kBlk][idx % kBlk] = vi[i];
      if (two) st.gj[idx / kBlk][idx % kBlk] = vj[i];
    }
    __syncthreads();
    return true;
  }
};

// StreamRows (gram_tiles, gram_solve_tiles, gram_tiles_dense,
// gram_solve_tiles_dense): g_p read as it lies in the materialized [C, k]
// stream (kernel K5 wrote it, zero rows included), float32 or bf16 (K5's
// stream of a bf16 table).  The kernel sees values only, so it loads every
// pass, padding rows too, as the TPU kernels walk them, and skips
// accumulating a pass whose rows are all zero — exactly what its gather
// sibling adds for the same pass, so the two sources' sums agree bit for
// bit on the same rows.
template <class T>
struct StreamRows {
  const T* g;

  template <int KMAX>
  __device__ __forceinline__ bool stage(RowStage<KMAX>& st, int k, long p0,
                                        int n, const float* rt) const {
    if (threadIdx.x < kRows)
      st.rt[threadIdx.x] = threadIdx.x < n ? __ldg(rt + threadIdx.x) : 0.0f;
    constexpr int kPer = RowStage<KMAX>::kPerThread;
    float v[kPer];
    if constexpr (std::is_same<T, float>::value) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / KMAX, c = idx % KMAX;
        v[i] = r < n && c < k ? __ldg(g + (size_t)(p0 + r) * k + c) : 0.0f;
      }
      bool nonzero = false;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        st.g[idx / KMAX][idx % KMAX] = v[i];
        nonzero |= v[i] != 0.0f;
      }
      return __syncthreads_or(nonzero);
    } else {
      const int idx = threadIdx.x * kPer;
      const int r = idx / KMAX, c0 = idx % KMAX;
      load_chunk<T, kPer>(r < n ? g + (size_t)(p0 + r) * k : nullptr, c0, k,
                          v);
      bool nonzero = false;
#pragma unroll
      for (int i = 0; i < kPer; ++i) nonzero |= v[i] != 0.0f;
      store_chunk<KMAX, kPer>(st, r, c0, v);
      return __syncthreads_or(nonzero);
    }
  }

  // The split Gram's block pass: the stream rows' slices at columns ci and
  // cj (one when ci == cj).  A pass skipped because both slices are zero
  // would add exact zeros, so the sums still equal the gather sibling's.
  __device__ __forceinline__ bool stage_pair(PairStage& st, int k, long p0,
                                             int n, const float* rt, int ci,
                                             int cj) const {
    if (threadIdx.x < kRows)
      st.rt[threadIdx.x] = threadIdx.x < n ? __ldg(rt + threadIdx.x) : 0.0f;
    constexpr int kPer = PairStage::kPerThread;
    const bool two = ci != cj;
    float vi[kPer], vj[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / kBlk, c = idx % kBlk;
      const T* src = g + (size_t)(p0 + r) * k;
      vi[i] = r < n && ci + c < k ? Elem<T>::load(src + ci + c) : 0.0f;
      vj[i] = two && r < n && cj + c < k ? Elem<T>::load(src + cj + c) : 0.0f;
    }
    bool nonzero = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      st.gi[idx / kBlk][idx % kBlk] = vi[i];
      if (two) st.gj[idx / kBlk][idx % kBlk] = vj[i];
      nonzero |= vi[i] != 0.0f || vj[i] != 0.0f;
    }
    return __syncthreads_or(nonzero);
  }
};

// Calls fn with a null pointer of the element type `kind` names (Kind):
// the C entries' one switch from the wrapper's dtype to an instantiation
// (with_kind: a gather table, float32, bf16 or int8; with_stream_kind: a
// materialized stream, float32 or bf16 — K5 writes int8 tables' streams in
// float32).
template <class Fn>
inline int with_kind(int kind, Fn&& fn) {
  switch (kind) {
    case kF32:
      return fn((const float*)nullptr);
    case kBF16:
      return fn((const __nv_bfloat16*)nullptr);
    case kI8:
      return fn((const int8_t*)nullptr);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <class Fn>
inline int with_stream_kind(int kind, Fn&& fn) {
  switch (kind) {
    case kF32:
      return fn((const float*)nullptr);
    case kBF16:
      return fn((const __nv_bfloat16*)nullptr);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The register sums of one work unit: thread (ti, tj) of the 16 x 16 CTA
// owns the RT x RT block A[ti·RT.., tj·RT..] of the Gram, thread c < KMAX
// owns b[c].
template <int KMAX>
struct GramAcc {
  static constexpr int RT = KMAX / 16;
  float a[RT][RT];
  float b;
  int ti, tj, k;

  __device__ __forceinline__ void init(int k_) {
    ti = threadIdx.x / 16;
    tj = threadIdx.x % 16;
    k = k_;
    b = 0.0f;
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) a[p][q] = 0.0f;
  }

  // Adds the rank-1 terms of the kRows staged rows.
  __device__ __forceinline__ void accumulate(RowStage<KMAX>& st) {
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float gi[RT], gj[RT];
#pragma unroll
      for (int p = 0; p < RT; ++p) {
        gi[p] = st.g[r][ti * RT + p];
        gj[p] = st.g[r][tj * RT + p];
      }
#pragma unroll
      for (int p = 0; p < RT; ++p)
#pragma unroll
        for (int q = 0; q < RT; ++q) a[p][q] = fmaf(gi[p], gj[q], a[p][q]);
      if (threadIdx.x < KMAX) b = fmaf(st.rt[r], st.g[r][threadIdx.x], b);
    }
    __syncthreads();
  }

  // One pass: rows p0 .. p0+n-1 of `src`, b-coefficients rt[0 .. n).
  template <class Src>
  __device__ __forceinline__ void add_pass(RowStage<KMAX>& st, const Src& src,
                                           long p0, int n, const float* rt) {
    if (src.stage(st, k, p0, n, rt)) accumulate(st);
  }

  // Adds cin·(ca, cb) — the previous chunk's carried partial — into the
  // sums (callers do this for the last unit of segment 0 only).
  __device__ __forceinline__ void fold_carry(const float* ca, const float* cb,
                                             float cin) {
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int i = ti * RT + p, j = tj * RT + q;
        if (i < k && j < k) a[p][q] = fmaf(cin, __ldg(ca + i * k + j), a[p][q]);
      }
    if (threadIdx.x < k) b = fmaf(cin, __ldg(cb + threadIdx.x), b);
  }

  // Writes the sums to A [k, k] (row stride ld) and bv [k].
  __device__ __forceinline__ void store(float* A, int ld, float* bv) const {
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int i = ti * RT + p, j = tj * RT + q;
        if (i < k && j < k) A[(size_t)i * ld + j] = a[p][q];
      }
    if (threadIdx.x < k) bv[threadIdx.x] = b;
  }
};

// The register sums of block (bi, bj) of a Gram past k = 128, columns
// ci = bi·kBlk and cj = bj·kBlk: thread (ti, tj) owns the RT x RT block
// A[ci + ti·RT.., cj + tj·RT..], summed row by row with the operations
// GramAcc<kBlk> performs on its elements; a diagonal block's thread c < kBlk
// owns b[ci + c].  An off-diagonal block is stored with its mirror (the
// same sums: fmaf(x, y, a) == fmaf(y, x, a)).
struct PairAcc {
  static constexpr int RT = kBlk / 16;
  float a[RT][RT];
  float b;
  int ti, tj, k, ci, cj;

  __device__ __forceinline__ void init(int k_, int bi, int bj) {
    ti = threadIdx.x / 16;
    tj = threadIdx.x % 16;
    k = k_;
    ci = bi * kBlk;
    cj = bj * kBlk;
    b = 0.0f;
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) a[p][q] = 0.0f;
  }

  __device__ __forceinline__ void accumulate(PairStage& st) {
    const bool diag = ci == cj;
    const float(*gjs)[kBlk] = diag ? st.gi : st.gj;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float gi[RT], gj[RT];
#pragma unroll
      for (int p = 0; p < RT; ++p) {
        gi[p] = st.gi[r][ti * RT + p];
        gj[p] = gjs[r][tj * RT + p];
      }
#pragma unroll
      for (int p = 0; p < RT; ++p)
#pragma unroll
        for (int q = 0; q < RT; ++q) a[p][q] = fmaf(gi[p], gj[q], a[p][q]);
      if (diag && threadIdx.x < kBlk)
        b = fmaf(st.rt[r], st.gi[r][threadIdx.x], b);
    }
    __syncthreads();
  }

  template <class Src>
  __device__ __forceinline__ void add_pass(PairStage& st, const Src& src,
                                           long p0, int n, const float* rt) {
    if (src.stage_pair(st, k, p0, n, rt, ci, cj)) accumulate(st);
  }

  __device__ __forceinline__ void fold_carry(const float* ca, const float* cb,
                                             float cin) {
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int i = ci + ti * RT + p, j = cj + tj * RT + q;
        if (i < k && j < k)
          a[p][q] = fmaf(cin, __ldg(ca + (size_t)i * k + j), a[p][q]);
      }
    if (ci == cj && threadIdx.x < kBlk && ci + (int)threadIdx.x < k)
      b = fmaf(cin, __ldg(cb + ci + threadIdx.x), b);
  }

  // Writes the block (and its mirror) to A [k, k] (row stride ld) and a
  // diagonal block's slice of bv [k].
  __device__ __forceinline__ void store(float* A, int ld, float* bv) const {
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int i = ci + ti * RT + p, j = cj + tj * RT + q;
        if (i < k && j < k) {
          A[(size_t)i * ld + j] = a[p][q];
          if (ci != cj) A[(size_t)j * ld + i] = a[p][q];
        }
      }
    if (ci == cj && threadIdx.x < kBlk && ci + (int)threadIdx.x < k)
      bv[ci + threadIdx.x] = b;
  }
};

}  // namespace cfk

// Each kernel library exports this, so the Python wrappers can name the
// error a C entry returned.
extern "C" const char* cfk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
