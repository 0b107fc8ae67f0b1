// The port's one SPD solve: X = A⁻¹ B for a k x k symmetric positive
// definite system with m right-hand sides, held in shared memory by one CTA
// of kThreads threads, k <= 128, float32, no pivoting.  K1 (reg_solve.cu),
// the fused Gram epilogue (gram_kernels.cuh: K3, K6 and the stream twins)
// and rows 11 and 12 (spd_batch.cuh: gauss_solve, gauss_solve_multi) call
// it, so the split and fused schedules solve the same sums to the same bits.
//
// Layout: A row-major with row stride ld = spd_ld(k) (odd, so a warp
// walking a column hits 32 banks), only its lower triangle read; Bᵀ is rows
// k .. k+m-1 of the same array (right-hand side r = A + (k+r)·ld; m = 1:
// y = A + k·ld).  The solve reads the k + m rows as one (k+m) x k
// lower-trapezoidal matrix [A; Bᵀ]: factoring it by Cholesky turns the
// rows below k into Zᵀ = (L⁻¹B)ᵀ on the way, so the forward substitution
// costs no stage of its own.  On return L overwrites the lower triangle
// (its diagonal holds 1/L_jj) and Xᵀ overwrites Bᵀ; every thread sees X.
//
// Blocked right-looking Cholesky, panels of kPanel = 32 columns.  Per
// panel, three stages, each ended by one CTA barrier:
//   1. factor   warp 0 factors the diagonal block in registers, lane i
//               holding row i: a shuffle brings each pivot, a 4.5 KB
//               scratch T each finished column (float4 loads) — warp
//               syncs only;
//   2. rows     the rows below the block (and Bᵀ's m rows) are solved
//               against it, one thread per row, L₁₁ broadcast from T;
//   3. update   the trailing lower part (the triangle, and Bᵀ's m rows
//               below it in full) takes the panel's rank-32 update: thread
//               (ty, tx) of the 16 x 16 CTA owns rows ty + 16a and columns
//               tx + 16b, b <= a, a register-tiled SYRK with no integer
//               division.
// The last panel (ragged when 32 ∤ k) has no trailing block, so k = 128
// takes 3 + 3 + 3 + 2 barriers, then one after the back substitution
// Lᵀ X = Z.  With one right-hand side (MMAX = 1) warp 0 runs it alone: per
// panel from the last, the rows below it (already solved) are folded into
// its z by one dot product per lane, then its block is solved by shuffles.
// With m of them (MMAX > 1) thread r solves right-hand side r on its own —
// the same fold and block solve, its z in registers, L broadcast — so the
// m back substitutions run side by side, not one after another on warp 0.
// (Eight warps each running back() on m/8 right-hand sides, their chains
// interleaved, issue about twice the instructions — a shuffle and a scale
// per step, lanes past j idle — and row 12 measured 1.4x slower.)
// Twelve CTA barriers at k = 128; the column-at-a-time solve it replaces
// took 4k = 512.
//
// Each full panel's stages are unrolled with no runtime test in them (a
// test on the panel width in every step ended a basic block at every
// update, and the solve ran ~3x slower); a ragged last panel takes
// guarded twins of the same code.
//
// Bits: every element sees the same float32 operations in the same order
// whatever the CTA shape, template instance or number of right-hand sides
// — an update of element (i, j) is fmaf(-L_il, L_jl, a) for l ascending, a
// column is scaled by the inverse pivot 1/√d (one MUFU op), a back
// substitution step is fmaf(-L_ji, x_j, z_i) for j descending then
// x_i = z_i·(1/L_ii) — so callers that fill the same system get the same
// X, column r of an m-column solve is the one-column solve of B's column
// r, and L is the column-at-a-time factorization's bit for bit.  A pivot
// that is not positive gives NaN or +inf, which reaches every later column
// and X: the system's row of X is non-finite, as with the plain version's
// cholesky_ex.
#pragma once

#include "common.cuh"

namespace cfk {

constexpr int kPanel = 32;

__host__ __device__ __forceinline__ int spd_ld(int k) { return k | 1; }

// Floats of [A; Bᵀ] in shared memory (m right-hand sides).
__host__ __device__ __forceinline__ int spd_floats(int k, int m = 1) {
  return (k + m - 1) * spd_ld(k) + k;
}

namespace spd {

constexpr unsigned kWarp = 0xffffffffu;

// Each stage comes in two instances: kFull (w = 32), whose unrolled loops
// hold no runtime test, so the compiler overlaps a step's independent
// loads and FMAs, and the ragged last panel's, guarded by in(j, w).
template <bool kFull>
__device__ __forceinline__ bool in(int j, int w) {
  return kFull || j < w;
}

// Inverse square root in one MUFU op (flush-to-zero: a denormal pivot
// counts as zero, whose +inf, like a negative pivot's NaN, reaches x).
__device__ __forceinline__ float rsqrt_pivot(float d) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return r;
}

// The diagonal block's columns as stage 1 finishes each: T[j][l] = L_lj
// (l > j) and T[j][j] = 1/L_jj, rows kTs floats apart (16-byte aligned),
// so stage 1's broadcast of column j and stage 2's reads of it are
// float4 loads.
constexpr int kTs = kPanel + 4;

// Stage 1 (warp 0): Cholesky of the w x w diagonal block at (c0, c0);
// L below the diagonal, 1/L_jj on it, and the same in T.  Lane i holds row
// c0 + i.  Step j's pivot is lane j's diagonal after step j - 1, computed
// there from its own registers (next) so that the chain from pivot to
// pivot holds one shuffle; column j then goes through T (one store a lane,
// float4 loads), and every lane applies it to its row — unconditionally:
// a lane's entries right of its diagonal are never read.
template <bool kFull>
__device__ __forceinline__ void factor(float* A, int ld, int c0, int w,
                                       int lane, float* T) {
  float* row = A + (c0 + lane) * ld + c0;
  const bool live = in<kFull>(lane, w);
  float r[kPanel];
#pragma unroll
  for (int l = 0; l < kPanel; ++l) r[l] = live && l <= lane ? row[l] : 0.0f;
  float inv_own = 0.0f, next = r[0];
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (in<kFull>(j, w)) {
      const float inv = rsqrt_pivot(__shfl_sync(kWarp, next, j));
      if (lane == j) inv_own = inv;
      r[j] *= inv;
      if (j + 1 < kPanel) next = fmaf(-r[j], r[j], r[j + 1]);
      T[j * kTs + lane] = r[j];
      __syncwarp();
#pragma unroll
      for (int q = (j + 1) / 4; q < kPanel / 4; ++q) {
        const float4 v4 = *reinterpret_cast<const float4*>(T + j * kTs + 4 * q);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = 4 * q + u;
          if (l > j && in<kFull>(l, w)) r[l] = fmaf(-r[j], v[u], r[l]);
        }
      }
    }
  }
  if (live) {
#pragma unroll
    for (int l = 0; l < kPanel; ++l)
      if (l < lane) row[l] = r[l];
    row[lane] = inv_own;
  }
  T[lane * kTs + lane] = inv_own;
}

// Stage 2: row c0 + w + t (t = threadIdx.x; rows k .. n-1 are Bᵀ, n = k + m)
// solved against the factored block, read from T:
// l_j = (a_j − Σ_{l<j} l_l·L_jl) / L_jj, the same updates the block's own
// rows took.
template <bool kFull>
__device__ __forceinline__ void rows(float* A, int ld, int n, int c0, int w,
                                     int t, const float* T) {
  const int i = c0 + w + t;
  if (i >= n) return;
  float* row = A + i * ld + c0;
  float a[kPanel];
#pragma unroll
  for (int l = 0; l < kPanel; ++l) a[l] = in<kFull>(l, w) ? row[l] : 0.0f;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (in<kFull>(j, w)) {
      a[j] *= T[j * kTs + j];
#pragma unroll
      for (int q = (j + 1) / 4; q < kPanel / 4; ++q) {
        const float4 v4 = *reinterpret_cast<const float4*>(T + j * kTs + 4 * q);
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int l = 4 * q + u;
          if (l > j && in<kFull>(l, w)) a[l] = fmaf(-a[j], v[u], a[l]);
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < kPanel; ++l)
    if (in<kFull>(l, w)) row[l] = a[l];
}

// Stage 3 with NA row tiles: rows c1 + ty + 16a (a < NA; rows k .. n-1 are
// Bᵀ), columns c1 + tx + 16b (b <= a, b < NB), each element
// a − Σ_l L_il·L_jl over the panel's 32 columns l in order.  Rows past n − 1
// and columns past k − 1 read a valid row and are not stored.  (b > a
// would put the column right of the row, tx − ty + 16(b − a) > 0: no
// element of the lower part, Bᵀ's rows included, is skipped.)
template <int NA, int NB>
__device__ __forceinline__ void update_tiles(float* A, int ld, int k, int n,
                                             int c0, int t) {
  const int c1 = c0 + kPanel;
  const int ty = t >> 4, tx = t & 15;
  const float* rp[NA];
  const float* cp[NB];
  int ri[NA], cj[NB];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    ri[a] = c1 + ty + 16 * a;
    rp[a] = A + min(ri[a], n - 1) * ld + c0;
  }
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    cj[b] = c1 + tx + 16 * b;
    cp[b] = A + min(cj[b], k - 1) * ld + c0;
  }
  float acc[NA][NB];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b <= a) acc[a][b] = A[min(ri[a], n - 1) * ld + min(cj[b], k - 1)];
#pragma unroll 8
  for (int l = 0; l < kPanel; ++l) {
    float rv[NA], cv[NB];
#pragma unroll
    for (int a = 0; a < NA; ++a) rv[a] = rp[a][l];
#pragma unroll
    for (int b = 0; b < NB; ++b) cv[b] = cp[b][l];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b)
        if (b <= a) acc[a][b] = fmaf(-rv[a], cv[b], acc[a][b]);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b <= a && ri[a] < n && cj[b] < k && cj[b] <= ri[a])
        A[ri[a] * ld + cj[b]] = acc[a][b];
}

// Stage 3: the trailing block below panel c0 (n − c1 rows, k − c1 columns,
// c1 = c0 + 32), dispatched to the tile count it needs.  KMAX and MMAX
// bound the instances: at most (KMAX + MMAX − 32) rows remain.
template <int KMAX, int MMAX, int NA = 1>
__device__ __forceinline__ void update(float* A, int ld, int k, int n,
                                       int c0, int t) {
  constexpr int kMaxA = (KMAX + MMAX - kPanel + 15) / 16;
  constexpr int kMaxB = (KMAX - kPanel + 15) / 16;
  const int na = (n - c0 - kPanel + 15) >> 4;
  if constexpr (NA < kMaxA) {
    if (na > NA) {
      update<KMAX, MMAX, NA + 1>(A, ld, k, n, c0, t);
      return;
    }
  }
  update_tiles<NA, (NA < kMaxB ? NA : kMaxB)>(A, ld, k, n, c0, t);
}

// Back substitution Lᵀx = z for the panel at c0 (warp 0 alone; the panels
// after it are solved): lane l folds the solved rows below the panel into
// z_l (one dot product down column c0 + l, rows descending), then the
// block is solved from its last row up, lane j broadcasting x_j.  x
// overwrites y.
template <bool kFull>
__device__ __forceinline__ void back(float* A, int ld, int k, int c0, int w,
                                     int lane) {
  float* y = A + k * ld;
  const bool live = in<kFull>(lane, w);
  float z = 0.0f, dinv = 0.0f;
  if (live) {
    z = y[c0 + lane];
#pragma unroll 8
    for (int i = k - 1; i >= c0 + w; --i)
      z = fmaf(-A[i * ld + c0 + lane], y[i], z);
    dinv = A[(c0 + lane) * ld + c0 + lane];
  }
  float col[kPanel];
#pragma unroll
  for (int j = 0; j < kPanel; ++j)
    col[j] = lane < j && in<kFull>(j, w) ? A[(c0 + j) * ld + c0 + lane]
                                         : 0.0f;
#pragma unroll
  for (int j = kPanel - 1; j >= 0; --j) {
    if (in<kFull>(j, w)) {
      const float xj = __shfl_sync(kWarp, z * dinv, j);
      z = fmaf(-col[j], xj, z);  // col[j] = 0 for lanes >= j: z unchanged
    }
  }
  if (live) y[c0 + lane] = z * dinv;
  __syncwarp();
}

// Back substitution Lᵀx = z for the panel at c0 by one thread alone, on its
// own right-hand side y (row k + r; the panels after c0 are solved): the
// solved entries below the panel are folded into z one row at a time, rows
// descending, then the block is solved from its last row up — for each
// element the fmaf's of back() in back()'s order, z and the panel's x in
// registers, every L read a broadcast (all threads read the same entry).
template <bool kFull>
__device__ __forceinline__ void back_rhs(const float* A, int ld, int k,
                                         int c0, int w, float* y) {
  float z[kPanel];
#pragma unroll
  for (int l = 0; l < kPanel; ++l) z[l] = in<kFull>(l, w) ? y[c0 + l] : 0.0f;
#pragma unroll 2
  for (int i = k - 1; i >= c0 + w; --i) {
    const float yi = y[i];
    const float* li = A + i * ld + c0;
#pragma unroll
    for (int l = 0; l < kPanel; ++l)
      if (in<kFull>(l, w)) z[l] = fmaf(-li[l], yi, z[l]);
  }
#pragma unroll
  for (int j = kPanel - 1; j >= 0; --j) {
    if (in<kFull>(j, w)) {
      const float* lj = A + (c0 + j) * ld + c0;
      z[j] *= lj[j];  // x_j = z_j·(1/L_jj)
#pragma unroll
      for (int l = 0; l < j; ++l) z[l] = fmaf(-lj[l], z[j], z[l]);
    }
  }
#pragma unroll
  for (int l = 0; l < kPanel; ++l)
    if (in<kFull>(l, w)) y[c0 + l] = z[l];
}

}  // namespace spd

// Solves [A; Bᵀ] in place (layout above), m right-hand sides (m <= MMAX;
// MMAX = 1: one, y = row k).  Every thread of the CTA calls it; the caller
// has synchronized after filling A's lower triangle and Bᵀ.  KMAX (32, 64
// or 128, >= k) and MMAX size the trailing update's register tiles.
template <int KMAX, int MMAX = 1>
__device__ void spd_solve(float* A, int ld, int k, int m = 1) {
  static_assert(KMAX <= 128 && KMAX % kPanel == 0, "KMAX: 32, 64 or 128");
  static_assert(MMAX >= 1 && KMAX + MMAX - kPanel <= kThreads,
                "stage 2 takes one thread a row");
  __shared__ __align__(16) float T[kPanel * spd::kTs];
  const int t = threadIdx.x, lane = t & 31;
  const bool warp0 = t < 32;
  const int n = k + (MMAX == 1 ? 1 : m);
  for (int c0 = 0; c0 < k; c0 += kPanel) {
    const int w = min(kPanel, k - c0);
    if (w == kPanel) {
      if (warp0) spd::factor<true>(A, ld, c0, w, lane, T);
      __syncthreads();
      spd::rows<true>(A, ld, n, c0, w, t, T);
    } else {
      if (warp0) spd::factor<false>(A, ld, c0, w, lane, T);
      __syncthreads();
      spd::rows<false>(A, ld, n, c0, w, t, T);
    }
    __syncthreads();
    if (c0 + w < k) {
      if constexpr (KMAX > kPanel) spd::update<KMAX, MMAX>(A, ld, k, n, c0, t);
      __syncthreads();
    }
  }
  if constexpr (MMAX == 1) {
    if (warp0) {
      for (int c0 = (k - 1) / kPanel * kPanel; c0 >= 0; c0 -= kPanel) {
        const int w = min(kPanel, k - c0);
        if (w == kPanel)
          spd::back<true>(A, ld, k, c0, w, lane);
        else
          spd::back<false>(A, ld, k, c0, w, lane);
      }
    }
  } else if (t < m) {
    float* y = A + (k + t) * ld;
    for (int c0 = (k - 1) / kPanel * kPanel; c0 >= 0; c0 -= kPanel) {
      const int w = min(kPanel, k - c0);
      if (w == kPanel)
        spd::back_rhs<true>(A, ld, k, c0, w, y);
      else
        spd::back_rhs<false>(A, ld, k, c0, w, y);
    }
  }
  __syncthreads();
}

}  // namespace cfk
