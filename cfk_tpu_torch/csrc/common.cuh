// Device code shared by the port's training kernels: the in-shared-memory
// Cholesky solve (reg_solve.cu, gram_solve_dense.cu, gram_solve_gather.cu)
// and the gathered-row Gram accumulator with its dense-stream window walk
// (gram_gather.cu, gram_solve_dense.cu, gram_tiles_dense_gather.cu,
// gram_solve_gather.cu); every kernel library takes its error-string
// export from here.
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

// Staging buffer for kRows gathered rows: row r holds table[nb[r]]·w[r] in
// columns [0, k) and zeros up to KMAX (nb[r] < 0 = the zero row).
template <int KMAX>
struct RowStage {
  float g[kRows][KMAX];
  float rt[kRows];
  float w[kRows];
  int nb[kRows];
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
  __device__ void init(float* A_, int ld_, float* bsum_, int k_) {
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
  __device__ void flush() {
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

  // Threads < kRows have filled st.nb/w/rt for their slot (nb = -1 for a
  // zero row) and passed `live` = this slot contributes.  Gathers the live
  // rows and adds their rank-1 terms; a pass with no live row is skipped
  // (every thread sees the same barrier result).
  __device__ void add_rows(RowStage<KMAX>& st, bool live, const float* table) {
    if (!__syncthreads_or(live)) return;
    for (int idx = threadIdx.x; idx < kRows * KMAX; idx += blockDim.x) {
      const int r = idx / KMAX, c = idx % KMAX;
      const int row = st.nb[r];
      float v = 0.0f;
      if (row >= 0 && c < k) v = __ldg(table + (size_t)row * k + c) * st.w[r];
      st.g[r][c] = v;
    }
    __syncthreads();
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
    if (++passes == kFlushPasses) {
      flush();
      passes = 0;
    }
    __syncthreads();
  }

  // Stages slot r = threadIdx.x (< kRows): table row n with weight w and
  // b-coefficient rv, or a zero row when `valid` is false.  Indices outside
  // [0, F) — F is the table's virtual zero row — and zero weights read as
  // the zero row.  Returns whether the slot contributes.
  __device__ static bool stage(RowStage<KMAX>& st, bool valid, int n, float w,
                               float rv, int F) {
    const bool live = valid && n >= 0 && n < F && w != 0.0f;
    st.nb[threadIdx.x] = live ? n : -1;
    st.w[threadIdx.x] = w;
    st.rt[threadIdx.x] = rv;
    return live;
  }

  // Adds the rows of segment s of one dense-stream chunk: tile i (NT tiles
  // in NG groups of M = NT/NG; meta = g_blk ‖ lb ‖ lo ‖ hi ‖ seg, seg
  // sorted) covers stream rows p = g_blk[i/M]·BG + lb_i + r for r in
  // [lo_i, hi_i), with weight wt[p] (1 when wt is null) and b-coefficient
  // rt[i·T + r].  Shared by gram_solve_dense.cu and
  // gram_tiles_dense_gather.cu.
  __device__ void add_dense_segment(RowStage<KMAX>& st, int s,
                                    const float* table, int F, const int* nb,
                                    const float* wt, const float* rt,
                                    const int* meta, int nt, int ng, int T,
                                    int BG) {
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
        bool live = false;
        if (threadIdx.x < kRows) {
          const int r = r0 + threadIdx.x;
          const bool valid = r < r_hi;
          const long p = base + r;
          live = stage(st, valid, valid ? __ldg(nb + p) : -1,
                       valid ? (wt != nullptr ? __ldg(wt + p) : 1.0f) : 0.0f,
                       valid ? __ldg(rt + (long)i * T + r) : 0.0f, F);
        }
        add_rows(st, live, table);
      }
    }
  }

  // Adds cin·(ca, cb) — the previous chunk's carried partial — into this
  // segment's sums (callers do this for segment 0 only).
  __device__ void fold_carry(const float* ca, const float* cb, float cin) {
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
