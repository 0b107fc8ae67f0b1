// Device code shared by the port's training kernels: the in-shared-memory
// Cholesky solve (reg_solve.cu and the fused Gram kernels) and the Gram
// accumulator with its two row sources — rows gathered from the table by
// index, or read from a materialized stream — and its two walks, over a
// chunk's [T]-row tiles and over the dense stream's windows (instantiated
// in gram_kernels.cuh); every kernel library takes its error-string export
// from here.
//
// Everything is plain FP32 FMA on the CUDA cores: the JAX package pins its
// Gram and solve contractions to full float32 (precision="highest",
// cfk_tpu/ops/solve.py:30-51), so no TF32 tensor-core path is used.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cfk {

constexpr int kThreads = 256;  // one CTA = 16 x 16 threads
constexpr int kRows = 32;      // gathered rows staged per pass
// Register partial sums are flushed into the segment's running sums every
// kFlushPasses passes (1,024 rows).  One float32 register summing a whole
// long segment (a Zipf-head entity: a million rows and more, all of an
// implicit Gram's diagonal terms positive) loses digits with every term
// once the sum dwarfs the terms, and the normal equations' condition
// number amplifies that in the solved factors; two levels of ~sqrt(n)
// terms each keep the sums near the accuracy of the per-tile sums of the
// JAX package's matrix-unit dots.
constexpr int kFlushPasses = 32;
constexpr int kRegDiag = 0;    // ridge λ·max(n,1)·I from per-row counts
constexpr int kRegMatrix = 1;  // one shared [k,k] ridge term

// First index in sorted a[0, n) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Adds the ridge to the k x k system held in shared memory (row stride ld):
// diag mode λ·max(n,1) on the diagonal (padding rows, n = 0, become λ·I),
// matrix mode the shared [k,k] term.
__device__ void add_ridge(float* A, int ld, int k, int reg_mode, float lam,
                          const float* reg, int row) {
  if (reg_mode == kRegDiag) {
    const float r = lam * fmaxf(__ldg(reg + row), 1.0f);
    for (int i = threadIdx.x; i < k; i += blockDim.x) A[i * ld + i] += r;
  } else {
    for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
      const int i = idx / k, j = idx - i * k;
      A[i * ld + j] += __ldg(reg + idx);
    }
  }
  __syncthreads();
}

// Solves A x = y in place for one SPD system in shared memory: a no-pivot
// Cholesky factorization A = L·Lᵀ over the lower triangle (L overwrites it),
// then the two triangular solves; x overwrites y.  Every thread of the CTA
// takes part; the caller has synchronized after filling A and y.
__device__ void chol_solve_smem(float* A, int ld, float* y, int k) {
  const int tid = threadIdx.x, nth = blockDim.x;
  for (int j = 0; j < k; ++j) {
    const float d = sqrtf(A[j * ld + j]);
    const float inv = 1.0f / d;
    for (int i = j + 1 + tid; i < k; i += nth) A[i * ld + j] *= inv;
    __syncthreads();
    if (tid == 0) A[j * ld + j] = d;
    const int n = k - j - 1;
    for (int idx = tid; idx < n * n; idx += nth) {
      const int i = j + 1 + idx / n;
      const int l = j + 1 + idx % n;
      if (l <= i) A[i * ld + l] = fmaf(-A[i * ld + j], A[l * ld + j], A[i * ld + l]);
    }
    __syncthreads();
  }
  for (int j = 0; j < k; ++j) {  // L z = y
    const float zj = y[j] / A[j * ld + j];
    for (int i = j + 1 + tid; i < k; i += nth) y[i] = fmaf(-A[i * ld + j], zj, y[i]);
    __syncthreads();
    if (tid == 0) y[j] = zj;
  }
  __syncthreads();
  for (int j = k - 1; j >= 0; --j) {  // Lᵀ x = z
    const float xj = y[j] / A[j * ld + j];
    for (int i = tid; i < j; i += nth) y[i] = fmaf(-A[j * ld + i], xj, y[i]);
    __syncthreads();
    if (tid == 0) y[j] = xj;
  }
  __syncthreads();
}

// Staging buffer for kRows rows: row r holds the pass's r-th row g_r in
// columns [0, k) and zeros up to KMAX; rt[r] is its b-coefficient.  nb and w
// are the gather source's index and weight per slot (nb = -1: a zero row).
// Each of the kThreads threads stages kPerThread of the kRows·KMAX elements,
// element idx = threadIdx.x + i·kThreads (row idx / KMAX, column idx % KMAX:
// a warp reads 32 neighbouring columns of one row).  The sources issue all
// of a thread's loads before storing any, so a pass waits on one memory
// latency, not on kPerThread of them in turn.
template <int KMAX>
struct RowStage {
  static constexpr int kPerThread = kRows * KMAX / kThreads;
  float g[kRows][KMAX];
  float rt[kRows];
  float w[kRows];
  int nb[kRows];
};

// Where a Gram kernel's rows come from.  A source fills the stage with the
// rows p0 .. p0+n-1 of its stream (n <= kRows; slots n.. are zero rows) and
// their b-coefficients rt[0 .. n), and returns — the same on every thread,
// after a barrier that makes the stage visible — whether the pass holds a
// row that adds anything.  kSkipsEmpty: a pass that holds none is not
// accumulated at all.
//
// GatherRows (K2, K3, K6, gram_tiles_dense_gather): g_p = table[nb_p]·wt_p,
// gathered inside the kernel (wt null = 1).  An index outside [0, F) — F is
// the table's virtual zero row — or a zero weight is a dead row; a pass
// with no live row is skipped before anything is loaded, so padding costs
// index reads only.
struct GatherRows {
  static constexpr bool kSkipsEmpty = true;
  const float* table;
  int F;
  const int* nb;
  const float* wt;

  template <int KMAX>
  __device__ __forceinline__ bool stage(RowStage<KMAX>& st, int k, long p0,
                                        int n, const float* rt) const {
    bool live = false;
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      const bool valid = r < n;
      const int row = valid ? __ldg(nb + p0 + r) : -1;
      const float w =
          valid ? (wt != nullptr ? __ldg(wt + p0 + r) : 1.0f) : 0.0f;
      live = valid && row >= 0 && row < F && w != 0.0f;
      st.nb[r] = live ? row : -1;
      st.w[r] = w;
      st.rt[r] = valid ? __ldg(rt + r) : 0.0f;
    }
    if (!__syncthreads_or(live)) return false;
    constexpr int kPer = RowStage<KMAX>::kPerThread;
    float v[kPer];
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
    __syncthreads();
    return true;
  }
};

// StreamRows (gram_tiles, gram_solve_tiles, gram_tiles_dense,
// gram_solve_tiles_dense): g_p read as it lies in the materialized [C, k]
// stream (kernel K5 wrote it, zero rows included).  The kernel sees values
// only, so every pass is accumulated, padding rows too, as the TPU kernels
// do; a pass whose rows are all zero adds exactly nothing (fmaf(0, x, a) ==
// a) and is not counted towards the register flush, so the flushes fall
// where the gather sources' fall (they skip such passes) and the two
// sources' sums agree bit for bit on the same rows.
struct StreamRows {
  static constexpr bool kSkipsEmpty = false;
  const float* g;

  template <int KMAX>
  __device__ __forceinline__ bool stage(RowStage<KMAX>& st, int k, long p0,
                                        int n, const float* rt) const {
    if (threadIdx.x < kRows)
      st.rt[threadIdx.x] = threadIdx.x < n ? __ldg(rt + threadIdx.x) : 0.0f;
    constexpr int kPer = RowStage<KMAX>::kPerThread;
    float v[kPer];
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
  }
};

// The running Gram of one segment: thread (ti, tj) of the 16 x 16 CTA owns
// the RT x RT block A[ti·RT.., tj·RT..] of a register partial and of the
// segment's running sums (in shared or device memory, row stride ld);
// thread c < KMAX owns b[c].  Every element has one owner thread, so the
// partial-to-running flushes need no barrier.
template <int KMAX>
struct GramAcc {
  static constexpr int RT = KMAX / 16;
  float a[RT][RT];
  float b;
  int ti, tj, passes, k, ld;
  float* A;
  float* bsum;

  // Zeroes the partial and this thread's elements of the running sums
  // A [k, k] (row stride ld_) and bsum [k].
  __device__ __forceinline__ void init(float* A_, int ld_, float* bsum_,
                                       int k_) {
    ti = threadIdx.x / 16;
    tj = threadIdx.x % 16;
    A = A_;
    ld = ld_;
    bsum = bsum_;
    k = k_;
    passes = 0;
    b = 0.0f;
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        a[p][q] = 0.0f;
        const int i = ti * RT + p, j = tj * RT + q;
        if (i < k && j < k) A[(size_t)i * ld + j] = 0.0f;
      }
    if (threadIdx.x < k) bsum[threadIdx.x] = 0.0f;
  }

  // Adds the register partial into the running sums and zeroes it.
  __device__ __forceinline__ void flush() {
#pragma unroll
    for (int p = 0; p < RT; ++p)
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        const int i = ti * RT + p, j = tj * RT + q;
        if (i < k && j < k) A[(size_t)i * ld + j] += a[p][q];
        a[p][q] = 0.0f;
      }
    if (threadIdx.x < k) bsum[threadIdx.x] += b;
    b = 0.0f;
  }

  // Adds the rank-1 terms of the kRows staged rows to the register partial;
  // a `counted` pass moves the partial towards its next flush.
  __device__ __forceinline__ void accumulate(RowStage<KMAX>& st,
                                             bool counted) {
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
    if (counted && ++passes == kFlushPasses) {
      flush();
      passes = 0;
    }
    __syncthreads();
  }

  // One pass: rows p0 .. p0+n-1 of `src`, b-coefficients rt[0 .. n).
  template <class Src>
  __device__ __forceinline__ void add_pass(RowStage<KMAX>& st, const Src& src,
                                           long p0, int n, const float* rt) {
    const bool nonzero = src.stage(st, k, p0, n, rt);
    if (nonzero || !Src::kSkipsEmpty) accumulate(st, nonzero);
  }

  // Adds the rows of segment s of one chunk of [T]-row tiles (NT tiles,
  // owner seg[tile] sorted, so the segment's tiles are contiguous: found by
  // binary search), b-coefficients rt[p] stream-aligned.
  template <class Src>
  __device__ __forceinline__ void add_tile_segment(
      RowStage<KMAX>& st, int s, const Src& src, const float* rt,
      const int* seg, int nt, int T) {
    const long row0 = (long)lower_bound(seg, nt, s) * T;
    const long row1 = (long)lower_bound(seg, nt, s + 1) * T;
    for (long base = row0; base < row1; base += kRows) {
      const int n = row1 - base < kRows ? (int)(row1 - base) : kRows;
      add_pass(st, src, base, n, rt + base);
    }
  }

  // Adds the rows of segment s of one dense-stream chunk: tile i (NT tiles
  // in NG groups of M = NT/NG; meta = g_blk ‖ lb ‖ lo ‖ hi ‖ seg, seg
  // sorted) covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in
  // [lo_i, hi_i), with b-coefficient rt[i·T + r] (tile-aligned).
  template <class Src>
  __device__ __forceinline__ void add_dense_segment(
      RowStage<KMAX>& st, int s, const Src& src, const float* rt,
      const int* meta, int nt, int ng, int T, int BG) {
    const int m = nt / ng;
    const int* g_blk = meta;
    const int* lb = meta + ng;
    const int* lo = lb + nt;
    const int* hi = lo + nt;
    const int* seg = hi + nt;
    const int t0 = lower_bound(seg, nt, s);
    const int t1 = lower_bound(seg, nt, s + 1);
    for (int i = t0; i < t1; ++i) {
      const int r_lo = __ldg(lo + i), r_hi = __ldg(hi + i);
      const long base = (long)__ldg(g_blk + i / m) * BG + __ldg(lb + i);
      for (int r0 = r_lo; r0 < r_hi; r0 += kRows) {
        const int n = r_hi - r0 < kRows ? r_hi - r0 : kRows;
        add_pass(st, src, base + r0, n, rt + (long)i * T + r0);
      }
    }
  }

  // Adds cin·(ca, cb) — the previous chunk's carried partial — into this
  // segment's sums (callers do this for segment 0 only).
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
};

}  // namespace cfk

// Each kernel library exports this, so the Python wrappers can name the
// error a C entry returned.
extern "C" const char* cfk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
