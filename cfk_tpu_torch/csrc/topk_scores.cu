// K4 topk_scores: score a batch of users against every row of an item table
// and keep each user's K best (score, row) pairs.
//
// Replaces: cfk_tpu/serving/topk_kernel.py::topk_scores_pallas (body
// _topk_kernel, per-tile fold _score_tile_fold).  score = u · row in f32
// (an int8 row is its codes times the row's scale; with a bf16 table u is
// rounded to bf16 first); a row whose global id row_offset + r is
// >= num_movies, or whose in-tile column is listed in seen[t, b, :], scores
// -inf.  The result is the first K of the order (score descending, id
// ascending) with empty slots (-inf, -1) — what lax.top_k's stable carry-
// first merge gives, ties included.
//
// What bounds it on the H100: at a serving batch of 256 users and rank 128,
// an f32 or int8 table's 2·B·M·k flops on the FP32 cores (TF32 stays off);
// a bf16 table's products run on the tensor cores, where the table read
// bounds them, as it bounds every kind at 16 users.  No [B, M] score
// matrix is written: only [B, K] leaves the kernel, plus a [B, splits, K]
// partial.
//
// Design, two launches:
//  1. topk_partial_kernel<TABLE, BU> — grid (user blocks of BU = 16 or 32)
//     x (splits of the table's 256-row tiles, split_plan), 8·BU threads.
//     A CTA walks its split tile by tile and, per tile, k in slices (16
//     columns for f32/int8, 32 for bf16) staged in shared memory by 16-byte
//     cp.async, double-buffered: the next slice's copy is in flight while
//     the current one is multiplied; rows are padded so every read is free
//     of bank conflicts; a table that is not 16-byte aligned, or a rank that
//     is not a multiple of the 16-byte chunk, falls back to element loads.
//     u is staged per slice too, through registers (rounded to bf16 there
//     for a bf16 table), so the rank is a loop bound, not a shared-memory
//     size.
//     - f32: each thread owns an 8-row x 4-user micro-tile, 32 FP32 FMA
//       accumulators fed by 3 LDS.128 per 32 FMAs (TF32 stays off).
//     - int8: the codes are staged (a quarter of the bytes) and each is
//       multiplied by its row's scale as it is converted to f32, once per
//       CTA slice — each conversion feeds BU users — then run through the
//       f32 FMAs: Σ (code·scale)·u, the reference's dequantize-then-dot
//       order, so an int8 table scores as the f32 table code·scale does.
//     - bf16: mma.sync m16n8k16 on the tensor cores (operands by ldmatrix,
//       f32 accumulators) — the reference's arithmetic: bf16 operands,
//       exact products, f32 sums; each warp computes 64 rows x 16 users.
//     When a tile's k-loop ends its scores go to a [BU][256] shared tile
//     (over the staging buffers) and warp w selects for users w, w + W, ...:
//     it masks padding and seen rows (a per-tile bitmap built from
//     seen[t, b, 0:W], a loop over W: shared memory never scales with W),
//     keeps the scores above the user's running K-th best (ballot
//     compaction into the warp's 256-key scratch, no atomics), sorts them in
//     registers (a bitonic network over 32·P keys, P = 1 .. 8, shuffles
//     across lanes) and merges them into the user's sorted top-pow2(K) list:
//     the larger of list[i] and survivors[n-1-i] is a bitonic sequence that
//     holds the best n, one bitonic merge sorts it (lists of up to 128 keys
//     in registers, longer ones in shared memory).  The list's K-th key is
//     the next tile's threshold.  (score, id) travel as one 64-bit key whose
//     unsigned order is (score desc, id asc), so ties resolve as the
//     reference's.  The list's first K go to part[b, split, :].
//     What the card shows (NVIDIA H100, PERF.md): the selection's sorts and
//     merges take about as many issue slots as the f32 FMAs at a serving
//     batch — each split's first tile passes every row, and a split of
//     ~1,800 rows keeps ~440 survivors a user.
//  2. topk_merge_kernel — one CTA of 16 warps per user: each warp merges
//     every 16th split's sorted list into its own with the same step in
//     registers (the next list's loads in flight), the warps' lists combine
//     in a tree, and the first K are written, empty slots as (-inf, -1).
// Those lists live in shared memory, pow2(K) keys a user, so this route
// takes K <= 1024 (kMaxTop).  Above it, cfk_topk_scores_large_k runs three
// launches instead, with candidates in device memory:
//  1. topk_partial_kernel<TABLE, BU, KEYS = true> — pass 1's grid, staging
//     and products, each score computed in the same operations in the same
//     order (so its bits are the small-K route's), but no selection: every
//     (user, row) goes to a [B, M_pad] workspace as its 64-bit key, a
//     padding, num_movies, seen or −inf row as key 0, which never wins.
//  2. topk_select_kernel — one CTA per user, an MSB-first radix select over
//     its M_pad keys: eight 8-bit digits, each a pass that histograms the
//     keys under the prefix found so far (per-warp shared histograms,
//     __match_any_sync aggregating equal digits) and a scan from the top
//     digit to the bucket holding the K-th key.  Live keys are unique (ids
//     are), so it ends on exactly the K-th key; the keys at or above it —
//     every live key when fewer than K are live — are compacted (one
//     ballot and one shared atomic a warp) into a [B, pow2(K)] buffer,
//     zero-filled.
//  3. topk_sort_kernel — one CTA per user sorts its pow2(K) keys
//     descending by a bitonic network: chunks of up to 8,192 keys sort in
//     shared memory, stages whose stride spans chunks run over device
//     memory (one CTA owns a user's buffer, so __syncthreads orders them),
//     then the first K decode to (vals, ids), key 0 as (−inf, −1).
// What bounds it: the [B, M_pad] keys written once and read by eight
// digit passes and the compaction; it is written to be right and simple
// first, not fast.
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr int kTileRows = 256;  // table rows of one CTA tile
constexpr int kBitWords = kTileRows / 32;
constexpr int kBkF = 16;           // f32/int8 k-slice
constexpr int kLdF = kBkF + 4;     // staged f32 row stride (floats)
constexpr int kBkH = 32;           // bf16 k-slice: two m16n8k16 steps
constexpr int kLdH = kBkH + 8;     // staged bf16 row stride: 80 bytes
constexpr int kMergeThreads = 512;
constexpr int kMaxTop = 1024;  // the two-launch route's K
constexpr int kSelThreads = 512;
constexpr int kSortThreads = 1024;
constexpr int kSortChunk = 8192;  // keys a sort CTA holds in shared memory
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kTableF32 = 0, kTableBF16 = 1, kTableI8 = 2;
// Every key of a -inf score is <= this; every other score's key is above.
constexpr u64 kNegInfKey = (0x007FFFFFull << 32) | 0xFFFFFFFFull;

__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// (score, id) as one key: the score's bits made order-preserving in the
// high word (-0 folded into +0 first: the two compare equal), 0x7FFFFFFF -
// id in the low word, so a larger key is a higher score or, at equal
// scores, a lower id.  Key 0 is an empty slot.
__device__ __forceinline__ u64 make_key(float s, int id) {
  unsigned b = __float_as_uint(__fadd_rn(s, 0.0f));
  b ^= (b & 0x80000000u) ? 0xFFFFFFFFu : 0x80000000u;
  return ((u64)b << 32) | (0x7FFFFFFFu - (unsigned)id);
}

__device__ __forceinline__ void split_key(u64 key, float& s, int& id) {
  if (key == 0ull) {
    s = -INFINITY;
    id = -1;
    return;
  }
  unsigned b = (unsigned)(key >> 32);
  b ^= (b & 0x80000000u) ? 0x80000000u : 0xFFFFFFFFu;
  s = __uint_as_float(b);
  id = (int)(0x7FFFFFFFu - (unsigned)key);
}

// One warp sorts a[0, n) (n a power of two) descending.
__device__ void warp_sort_desc(u64* a, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = lane; p < (n >> 1); p += 32) {
        const int i = 2 * p - (p & (stride - 1)), j = i + stride;
        const u64 x = a[i], y = a[j];
        if (((i & size) == 0) ? x < y : x > y) {
          a[i] = y;
          a[j] = x;
        }
      }
      __syncwarp();
    }
  }
}

// One warp sorts the bitonic sequence a[0, n) descending.
__device__ void warp_merge_desc(u64* a, int n, int lane) {
  for (int stride = n >> 1; stride > 0; stride >>= 1) {
    for (int p = lane; p < (n >> 1); p += 32) {
      const int i = 2 * p - (p & (stride - 1)), j = i + stride;
      const u64 x = a[i], y = a[j];
      if (x < y) {
        a[i] = y;
        a[j] = x;
      }
    }
    __syncwarp();
  }
}

// L[0, kp) and c[0, n) sorted descending: L becomes the best kp of both,
// sorted.  max(L[i], c[kp-1-i]) is bitonic and holds the best kp.
__device__ void warp_merge_into(u64* L, int kp, const u64* c, int n,
                                int lane) {
  for (int i = lane; i < kp; i += 32) {
    const int j = kp - 1 - i;
    if (j < n && c[j] > L[i]) L[i] = c[j];
  }
  __syncwarp();
  warp_merge_desc(L, kp, lane);
}

__device__ __forceinline__ u64 kmax(u64 a, u64 b) { return a > b ? a : b; }

// One compare-exchange stage of a register bitonic network over 32·P keys
// (element e = P·lane + t): pairs (e, e ^ STRIDE) ordered descending where
// e & SIZE is 0, ascending elsewhere.  Strides below P pair keys of one
// lane, the others pair lanes by shuffles.  Templates keep every register
// index a compile-time constant.
template <int P, int SIZE, int STRIDE>
__device__ __forceinline__ void reg_stage(u64 (&v)[P], int lane) {
  // e & SIZE: t's bit while SIZE < P, else the lane's (P·lane has no bits
  // below P, so adding t never carries into it)
  const bool lane_desc = ((P * lane) & SIZE) == 0;
  if constexpr (STRIDE < P) {
#pragma unroll
    for (int t = 0; t < P; ++t) {
      if ((t & STRIDE) == 0) {
        const bool desc = SIZE < P ? (t & SIZE) == 0 : lane_desc;
        const u64 x = v[t], y = v[t + STRIDE];
        const bool swap = (x < y) == desc;
        v[t] = swap ? y : x;
        v[t + STRIDE] = swap ? x : y;
      }
    }
  } else {
    constexpr int kLane = STRIDE / P;
    const bool keep_max = lane_desc == ((lane & kLane) == 0);
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v[t], kLane);
      if ((o > v[t]) == keep_max) v[t] = o;
    }
  }
  if constexpr (STRIDE > 1) reg_stage<P, SIZE, STRIDE / 2>(v, lane);
}

template <int P, int SIZE>
__device__ __forceinline__ void reg_sort_level(u64 (&v)[P], int lane) {
  reg_stage<P, SIZE, SIZE / 2>(v, lane);
  if constexpr (SIZE < 32 * P) reg_sort_level<P, SIZE * 2>(v, lane);
}

// One warp sorts the 32·P keys v descending in registers.
template <int P>
__device__ __forceinline__ void reg_sort_desc(u64 (&v)[P], int lane) {
  reg_sort_level<P, 2>(v, lane);
}

// a (128 keys, sorted descending, e = 4·lane + t) becomes the best 128 of
// a and b (same layout, sorted descending), sorted: max(a[e], b[127-e]) is
// bitonic and holds the best 128; one bitonic merge sorts it.
__device__ __forceinline__ void reg_merge_into(u64 (&a)[4], const u64 (&b)[4],
                                               int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    a[t] = kmax(a[t], __shfl_xor_sync(0xffffffffu, b[3 - t], 31));
  // the bitonic merge: the descending half-cleaners of strides 64 .. 1
  reg_stage<4, 256, 64>(a, lane);
}

// Sorts the survivors scr[0, cnt) (32·P >= cnt) in registers and writes
// them back, descending, zero-padded to 32·P.
template <int P>
__device__ void sort_survivors(u64* scr, int cnt, int lane) {
  u64 v[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const int e = P * lane + t;
    v[t] = e < cnt ? scr[e] : 0ull;
  }
  reg_sort_desc<P>(v, lane);
  __syncwarp();
#pragma unroll
  for (int t = 0; t < P; ++t) scr[P * lane + t] = v[t];
  __syncwarp();
}

// Merges one tile's survivors scr[0, cnt) (cnt <= 256) of a user into its
// sorted list L[0, kp); returns the new threshold (the K-th best key, or
// kNegInfKey while the list holds fewer than K).  Lists of up to 128 keys
// run in registers, longer ones in shared memory.
__device__ u64 merge_tile(u64* L, u64* scr, int cnt, int kp, int k_top,
                          int lane) {
  if (kp <= 128) {
    int n;
    if (cnt <= 32) {
      sort_survivors<1>(scr, cnt, lane);
      n = 32;
    } else if (cnt <= 64) {
      sort_survivors<2>(scr, cnt, lane);
      n = 64;
    } else if (cnt <= 128) {
      sort_survivors<4>(scr, cnt, lane);
      n = 128;
    } else {
      sort_survivors<8>(scr, cnt, lane);
      n = 128;  // the best 128 of the sorted 256
    }
    u64 a[4], b[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int e = 4 * lane + t;
      a[t] = e < kp ? L[e] : 0ull;
      b[t] = e < n ? scr[e] : 0ull;
    }
    if (L[0] != 0ull) {  // an empty list takes the sorted survivors as they are
      reg_merge_into(a, b, lane);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) a[t] = b[t];
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * lane + t < kp) L[4 * lane + t] = a[t];
  } else {
    int n = 32;
    while (n < cnt) n <<= 1;
    for (int i = cnt + lane; i < n; i += 32) scr[i] = 0ull;
    __syncwarp();
    warp_sort_desc(scr, n, lane);
    warp_merge_into(L, kp, scr, n, lane);
  }
  __syncwarp();
  return kmax(L[k_top - 1], kNegInfKey);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2,
                                         float& d3, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pass 1's shared-memory layout for one (table kind, users per CTA).  The
// staging buffers and the score tile share one region (a tile's scores are
// written after its last slice is consumed).
template <int TABLE, int BU>
struct Pass1 {
  static constexpr int kThreads = 8 * BU;  // (BU/4 user groups) x 32 row groups
  static constexpr int kWarps = kThreads / 32;
  static constexpr bool kHalf = TABLE == kTableBF16;
  static constexpr int kBk = kHalf ? kBkH : kBkF;
  static constexpr int kLd = kHalf ? kLdH : kLdF;  // staged row stride
  static constexpr int kEl = kHalf ? 2 : 4;        // staged element bytes
  // score tile [BU][kLdS] floats: both writers' patterns conflict-free
  static constexpr int kLdS = kHalf ? kTileRows + 4 : kTileRows + 8;
  static constexpr size_t kTBytes = (size_t)kTileRows * kLd * kEl;  // one slice
  static constexpr size_t kUBytes = (size_t)BU * kLd * kEl;
  static constexpr size_t kCodeBytes = (size_t)kTileRows * kBkF;  // int8 slice
  static constexpr size_t kStage =
      TABLE == kTableI8 ? 2 * kCodeBytes + kTBytes + 2 * kUBytes
                        : 2 * (kTBytes + kUBytes);
  static constexpr size_t kScore = (size_t)BU * kLdS * 4;
  static constexpr size_t kRegion = kStage > kScore ? kStage : kScore;
  // + lists, survivor scratch (neither in KEYS mode), thresholds, bits
  static size_t smem(int kp, bool keys) {
    return kRegion +
           (keys ? 0 : (size_t)BU * kp * 8 + (size_t)kWarps * kTileRows * 8) +
           (size_t)BU * 8 + (size_t)BU * kBitWords * 4;
  }
};

// KEYS: write every (user, row) key to part [B, m_pad] instead of selecting.
template <int TABLE, int BU, bool KEYS>
__global__ void __launch_bounds__(8 * BU, 64 / BU)
topk_partial_kernel(const float* __restrict__ u, const void* __restrict__ table,
                    const float* __restrict__ scale,
                    const int* __restrict__ seen, int seen_w, int b_total,
                    int k, int m_pad, int num_movies, int row_offset,
                    int tile_m, int k_top, int kp, int splits, int vec,
                    u64* __restrict__ part) {
  using P = Pass1<TABLE, BU>;
  constexpr int kThreads = P::kThreads, kBk = P::kBk, kLd = P::kLd, kLdS = P::kLdS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* region = smem_raw;  // staging, then the tile's scores
  float* score = reinterpret_cast<float*>(region);
  u64* lists = reinterpret_cast<u64*>(smem_raw + P::kRegion);  // [BU][kp]
  u64* scratch = lists + (size_t)BU * kp;  // [warps][256] tile survivors
  u64* thr_s = scratch + (KEYS ? 0 : P::kWarps * kTileRows);  // [BU]
  unsigned* bits = reinterpret_cast<unsigned*>(thr_s + BU);  // [BU][8]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * BU;
  const int n_users = min(BU, b_total - b0);
  const int split = blockIdx.y;
  const int tiles = (m_pad + kTileRows - 1) / kTileRows;
  const int t_lo = (int)((long long)split * tiles / splits);
  const int t_hi = (int)((long long)(split + 1) * tiles / splits);
  const int nslices = (k + kBk - 1) / kBk;

  for (int i = tid; i < BU * kp; i += kThreads) lists[i] = 0ull;
  for (int i = tid; i < BU * kBitWords; i += kThreads) bits[i] = 0u;
  if (tid < BU) thr_s[tid] = kNegInfKey;
  __syncthreads();

  // thread (user group ug, row group rg) of warp (wu, wr): rows
  // wr·64 + rg + 8i (i < 8), users wu·16 + ug + 4j (j < 4) — the bf16 path
  // maps the same warp tile onto mma fragments
  const int wu = warp >> 2, wr = warp & 3;
  const int ug = lane >> 3, rg = lane & 7;

  // -- staging ----------------------------------------------------------
  // u: kBk/8 consecutive columns of one user per thread, through registers
  constexpr int kUPer = kBk / 8;
  const int su = tid / 8, sc = (tid % 8) * kUPer;
  float ureg[kUPer];
  auto load_u = [&](int s) {
    const int k0 = s * kBk + sc;
#pragma unroll
    for (int e = 0; e < kUPer; ++e)
      ureg[e] = (su < n_users && k0 + e < k)
                    ? __ldg(u + (size_t)(b0 + su) * k + k0 + e)
                    : 0.0f;
  };
  auto store_u = [&](int buf) {
    unsigned char* ub = region + (TABLE == kTableI8
                                      ? 2 * P::kCodeBytes + P::kTBytes
                                      : 2 * P::kTBytes) +
                        buf * P::kUBytes;
    if (TABLE == kTableBF16) {
      __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(ub) + su * kLd + sc;
#pragma unroll
      for (int e = 0; e < kUPer; ++e) d[e] = __float2bfloat16_rn(ureg[e]);
    } else {
      float* d = reinterpret_cast<float*>(ub) + su * kLd + sc;
#pragma unroll
      for (int e = 0; e < kUPer; ++e) d[e] = ureg[e];
    }
  };
  // the table slice: rows [r0, r0 + 256) x columns [s·kBk, s·kBk + kBk)
  auto stage_table = [&](int r0, int s, int buf) {
    const int k0 = s * kBk;
    if (TABLE == kTableI8) {
      int8_t* d = reinterpret_cast<int8_t*>(region) + buf * P::kCodeBytes;
      const int8_t* t = static_cast<const int8_t*>(table);
      if (vec) {
        for (int row = tid; row < kTileRows; row += kThreads) {
          const bool ok = r0 + row < m_pad && k0 < k;
          cp_async16(d + row * kBkF,
                     ok ? t + (size_t)(r0 + row) * k + k0 : t, ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kTileRows * kBkF; e += kThreads) {
          const int row = e / kBkF, c = e % kBkF;
          d[e] = (r0 + row < m_pad && k0 + c < k)
                     ? t[(size_t)(r0 + row) * k + k0 + c] : (int8_t)0;
        }
      }
    } else {
      constexpr int kPer = 16 / P::kEl;  // elements per 16-byte chunk
      constexpr int kChunks = kBk / kPer;
      unsigned char* d = region + buf * P::kTBytes;
      const unsigned char* t = static_cast<const unsigned char*>(table);
      if (vec) {
        for (int c = tid; c < kTileRows * kChunks; c += kThreads) {
          const int row = c / kChunks, col = k0 + (c % kChunks) * kPer;
          const bool ok = r0 + row < m_pad && col < k;
          cp_async16(d + (row * kLd + (c % kChunks) * kPer) * P::kEl,
                     ok ? t + ((size_t)(r0 + row) * k + col) * P::kEl : t,
                     ok ? 16 : 0);
        }
      } else {
        for (int e = tid; e < kTileRows * kBk; e += kThreads) {
          const int row = e / kBk, c = e % kBk;
          const bool ok = r0 + row < m_pad && k0 + c < k;
          const size_t o = (size_t)(r0 + row) * k + k0 + c;
          if (TABLE == kTableBF16) {
            reinterpret_cast<__nv_bfloat16*>(d)[row * kLd + c] =
                ok ? static_cast<const __nv_bfloat16*>(table)[o]
                   : __float2bfloat16_rn(0.0f);
          } else {
            reinterpret_cast<float*>(d)[row * kLd + c] =
                ok ? __ldg(static_cast<const float*>(table) + o) : 0.0f;
          }
        }
      }
    }
    cp_async_commit();
  };

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int r0 = tile * kTileRows;
    if (seen != nullptr) {  // this tile's seen bitmap (cleared by the scan)
      const int t_last = (min(r0 + kTileRows, m_pad) - 1) / tile_m;
      for (int t = r0 / tile_m; t <= t_last; ++t) {
        const int* st = seen + ((size_t)t * b_total + b0) * seen_w;
        for (int idx = tid; idx < n_users * seen_w; idx += kThreads) {
          const int c = __ldg(st + idx);
          const int row = t * tile_m + c - r0;
          if (c >= 0 && c < tile_m && row >= 0 && row < kTileRows)
            atomicOr(&bits[(idx / seen_w) * kBitWords + (row >> 5)],
                     1u << (row & 31));
        }
      }
    }
    load_u(0);
    store_u(0);
    stage_table(r0, 0, 0);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    for (int s = 0; s < nslices; ++s) {
      const int buf = s & 1;
      cp_async_wait_all();
      __syncthreads();  // slice s landed; slice s-1 consumed everywhere
      if (s + 1 < nslices) {
        stage_table(r0, s + 1, buf ^ 1);
        load_u(s + 1);
      }
      if (TABLE == kTableBF16) {
        const __nv_bfloat16* T =
            reinterpret_cast<const __nv_bfloat16*>(region + buf * P::kTBytes);
        const __nv_bfloat16* U = reinterpret_cast<const __nv_bfloat16*>(
            region + 2 * P::kTBytes + buf * P::kUBytes);
#pragma unroll
        for (int kk = 0; kk < kBk; kk += 16) {
          unsigned a[4][4], bb[4];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            ldmatrix_x4(a[mt], T + (wr * 64 + mt * 16 + (lane & 15)) * kLd +
                                   kk + (lane >> 4) * 8);
          ldmatrix_x4(bb, U + (wu * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                              kk + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              float* d = acc + (mt * 2 + nt) * 4;
              mma_bf16(d[0], d[1], d[2], d[3], a[mt], bb[2 * nt],
                       bb[2 * nt + 1]);
            }
        }
      } else {
        const float* T;
        if (TABLE == kTableI8) {  // code·scale -> f32 once per CTA slice
          const int8_t* cs =
              reinterpret_cast<const int8_t*>(region) + buf * P::kCodeBytes;
          float* F = reinterpret_cast<float*>(region + 2 * P::kCodeBytes);
          for (int row = tid; row < kTileRows; row += kThreads) {
            const int4 w = *reinterpret_cast<const int4*>(cs + row * kBkF);
            const int8_t* c8 = reinterpret_cast<const int8_t*>(&w);
            const float sc = r0 + row < m_pad ? __ldg(scale + r0 + row) : 0.0f;
            float4* d = reinterpret_cast<float4*>(F + row * kLd);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              d[q] = make_float4((float)c8[4 * q] * sc,
                                 (float)c8[4 * q + 1] * sc,
                                 (float)c8[4 * q + 2] * sc,
                                 (float)c8[4 * q + 3] * sc);
          }
          __syncthreads();
          T = F;
        } else {
          T = reinterpret_cast<const float*>(region + buf * P::kTBytes);
        }
        const float* U = reinterpret_cast<const float*>(
            region + (TABLE == kTableI8 ? 2 * P::kCodeBytes + P::kTBytes
                                        : 2 * P::kTBytes) +
            buf * P::kUBytes);
        const float* Tb = T + (wr * 64 + rg) * kLd;
        const float* Ub = U + (wu * 16 + ug) * kLd;
#pragma unroll
        for (int kk = 0; kk < kBk; kk += 4) {
          float4 a[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            a[i] = *reinterpret_cast<const float4*>(Tb + 8 * i * kLd + kk);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(Ub + 4 * j * kLd + kk);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float& c = acc[i * 4 + j];
              c = fmaf(a[i].x, bv[j].x, c);
              c = fmaf(a[i].y, bv[j].y, c);
              c = fmaf(a[i].z, bv[j].z, c);
              c = fmaf(a[i].w, bv[j].w, c);
            }
        }
      }
      if (s + 1 < nslices) store_u(buf ^ 1);
    }
    __syncthreads();  // every slice consumed: the region holds scores now
    if (TABLE == kTableBF16) {
      const int g = lane >> 2, q = lane & 3;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = wr * 64 + mt * 16 + g + 8 * (e >> 1);
            const int user = wu * 16 + nt * 8 + 2 * q + (e & 1);
            score[user * kLdS + row] = acc[(mt * 2 + nt) * 4 + e];
          }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = wr * 64 + rg + 8 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          score[(wu * 16 + ug + 4 * j) * kLdS + row] = acc[i * 4 + j];
      }
    }
    __syncthreads();
    // -- selection: warp w owns users w, w + W, ... ---------------------
    u64* scr = scratch + warp * kTileRows;
    unsigned live_c[kBitWords];  // table rows below num_movies, per chunk
#pragma unroll
    for (int c = 0; c < kBitWords; ++c) {
      const int row = r0 + c * 32 + lane;
      live_c[c] = __ballot_sync(
          0xffffffffu, row < m_pad && (long long)row_offset + row < num_movies);
    }
    if constexpr (KEYS) {  // every row's key; 0 where pass 1 takes nothing
      for (int uu = warp; uu < n_users; uu += P::kWarps) {
        u64* out = part + (size_t)(b0 + uu) * m_pad + r0;
#pragma unroll
        for (int c = 0; c < kBitWords; ++c) {
          unsigned live = live_c[c];
          if (seen != nullptr) live &= ~bits[uu * kBitWords + c];
          const int row = c * 32 + lane;
          const float sc = score[uu * kLdS + row];
          if (r0 + row < m_pad)
            out[row] = ((live >> lane) & 1u) && sc > -INFINITY
                           ? make_key(sc, row_offset + r0 + row) : 0ull;
        }
        __syncwarp();  // every lane has read the bitmap before it clears
        if (seen != nullptr && lane < kBitWords) bits[uu * kBitWords + lane] = 0u;
      }
      __syncthreads();  // the score tile and bitmap are free again
      continue;
    }
    for (int uu = warp; uu < n_users; uu += P::kWarps) {
      float tv;  // the threshold as (score, id): take s > tv, or s == tv
      int ti;    // with a lower id — the key order
      split_key(thr_s[uu], tv, ti);
      int cnt = 0;
#pragma unroll
      for (int c = 0; c < kBitWords; ++c) {
        unsigned live = live_c[c];
        if (seen != nullptr) live &= ~bits[uu * kBitWords + c];
        const float sc = score[uu * kLdS + c * 32 + lane];
        const int gid = row_offset + r0 + c * 32 + lane;
        const bool take = ((live >> lane) & 1u) &&
                          (sc > tv || (sc == tv && gid < ti));
        const unsigned m = __ballot_sync(0xffffffffu, take);
        if (take) scr[cnt + __popc(m & ((1u << lane) - 1u))] = make_key(sc, gid);
        cnt += __popc(m);
      }
      if (seen != nullptr && lane < kBitWords) bits[uu * kBitWords + lane] = 0u;
      if (cnt > 0) {
        __syncwarp();
        const u64 t = merge_tile(lists + (size_t)uu * kp, scr, cnt, kp, k_top,
                                 lane);
        if (lane == 0) thr_s[uu] = t;
      }
    }
    __syncthreads();  // the score tile and bitmap are free again
  }
  if constexpr (KEYS) return;
  for (int uu = warp; uu < n_users; uu += P::kWarps) {
    const u64* L = lists + (size_t)uu * kp;
    u64* out = part + ((size_t)(b0 + uu) * splits + split) * k_top;
    for (int i = lane; i < k_top; i += 32) out[i] = L[i];
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const u64* __restrict__ part, int splits, int k_top, int kp,
                  float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarps = kMergeThreads / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = kp < 128 ? 128 : kp;  // a warp's list in shared memory
  u64* A = reinterpret_cast<u64*>(smem_raw) + (size_t)warp * ld;
  const u64* pb = part + (size_t)blockIdx.x * splits * k_top;
  float* vo = vals + (size_t)blockIdx.x * k_top;
  int* io = ids + (size_t)blockIdx.x * k_top;
  if (kp <= 128) {  // lists in registers (e = 4·lane + t)
    auto load = [&](u64 (&r)[4], int s) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * lane + t;
        r[t] = s < splits && e < k_top ? __ldg(pb + (size_t)s * k_top + e)
                                       : 0ull;
      }
    };
    u64 a[4] = {0ull, 0ull, 0ull, 0ull}, cur[4], nxt[4];
    load(cur, warp);
    for (int s = warp; s < splits; s += kWarps) {
      load(nxt, s + kWarps);  // in flight during this merge
      reg_merge_into(a, cur, lane);
#pragma unroll
      for (int t = 0; t < 4; ++t) cur[t] = nxt[t];
    }
    for (int half = kWarps / 2; half > 0; half >>= 1) {
      if (warp >= half && warp < 2 * half)
#pragma unroll
        for (int t = 0; t < 4; ++t) A[4 * lane + t] = a[t];
      __syncthreads();
      if (warp < half) {
        u64 b[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) b[t] = A[(size_t)half * ld + 4 * lane + t];
        reg_merge_into(a, b, lane);
      }
      __syncthreads();
    }
    if (warp == 0) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = 4 * lane + t;
        if (e < k_top) split_key(a[t], vo[e], io[e]);
      }
    }
    return;
  }
  for (int i = lane; i < kp; i += 32) A[i] = 0ull;
  __syncwarp();
  for (int s = warp; s < splits; s += kWarps) {
    for (int i = lane; i < kp; i += 32) {
      const int j = kp - 1 - i;
      if (j < k_top) A[i] = kmax(A[i], __ldg(pb + (size_t)s * k_top + j));
    }
    __syncwarp();
    warp_merge_desc(A, kp, lane);
  }
  __syncthreads();
  for (int half = kWarps / 2; half > 0; half >>= 1) {
    if (warp < half) {
      const u64* B = A + (size_t)half * ld;
      for (int i = lane; i < kp; i += 32) A[i] = kmax(A[i], B[kp - 1 - i]);
      __syncwarp();
      warp_merge_desc(A, kp, lane);
    }
    __syncthreads();
  }
  if (warp == 0)
    for (int i = lane; i < k_top; i += 32) split_key(A[i], vo[i], io[i]);
}

// One CTA per user: the K-th largest of its m_pad keys by an MSB-first
// radix select (8-bit digits), then every key at or above it (every
// nonzero key when the K-th is 0, i.e. fewer than K are live) compacted
// into cand[user, 0, kp), the rest 0.
__global__ void __launch_bounds__(kSelThreads)
topk_select_kernel(const u64* __restrict__ keys, int m_pad, int k_top, int kp,
                   u64* __restrict__ cand) {
  constexpr int kWarps = kSelThreads / 32;
  __shared__ unsigned hist[kWarps][256];
  __shared__ u64 s_prefix;
  __shared__ int s_remaining, s_count;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* kb = keys + (size_t)blockIdx.x * m_pad;
  u64* cb = cand + (size_t)blockIdx.x * kp;
  u64 prefix = 0ull;  // the K-th largest key, digit by digit
  if (k_top < m_pad) {
    u64 mask = 0ull;
    int remaining = k_top;  // its rank among the keys under the prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < kWarps * 256; i += kSelThreads)
        (&hist[0][0])[i] = 0u;
      __syncthreads();
      for (int base = warp * 32; base < m_pad; base += kSelThreads) {
        const int i = base + lane;
        const u64 key = i < m_pad ? kb[i] : 0ull;
        const unsigned dig = i < m_pad && (key & mask) == prefix
                                 ? (unsigned)(key >> shift) & 0xFFu : 256u;
        const unsigned peers = __match_any_sync(0xffffffffu, dig);
        if (dig < 256u && lane == __ffs(peers) - 1)
          atomicAdd(&hist[warp][dig], (unsigned)__popc(peers));
      }
      __syncthreads();
      if (tid < 256) {  // the digit's count over the warps
        unsigned t = 0;
        for (int w = 0; w < kWarps; ++w) t += hist[w][tid];
        hist[0][tid] = t;
      }
      __syncthreads();
      if (tid == 0) {  // the bucket holding the remaining-th largest
        int above = 0, d = 255;
        for (; d > 0 && above + (int)hist[0][d] < remaining; --d)
          above += (int)hist[0][d];
        s_prefix = prefix | ((u64)d << shift);
        s_remaining = remaining - above;
      }
      __syncthreads();
      prefix = s_prefix;
      remaining = s_remaining;
      mask |= 0xFFull << shift;
    }
  }
  const u64 t = prefix > 0ull ? prefix : 1ull;
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int base = warp * 32; base < m_pad; base += kSelThreads) {
    const int i = base + lane;
    const u64 key = i < m_pad ? kb[i] : 0ull;
    const bool take = i < m_pad && key >= t;
    const unsigned m = __ballot_sync(0xffffffffu, take);
    int at = 0;
    if (lane == 0 && m) at = atomicAdd(&s_count, __popc(m));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (take) cb[at + __popc(m & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  for (int i = s_count + tid; i < kp; i += kSelThreads) cb[i] = 0ull;
}

// One compare-exchange stage of the bitonic sort over a[0, n/2 pairs):
// pair (i, i + stride), descending where (base + i) & size is 0.
__device__ __forceinline__ void sort_stage(u64* a, int n, int base, int size,
                                           int stride) {
  for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
    const int i = 2 * p - (p & (stride - 1)), j = i + stride;
    const u64 x = a[i], y = a[j];
    if (((base + i) & size) == 0 ? x < y : x > y) {
      a[i] = y;
      a[j] = x;
    }
  }
}

// One CTA per user: cand[user, 0, kp) sorted descending (kp a power of
// two), then its first K decoded into vals/ids.  Chunks of c = min(kp,
// kSortChunk) keys run their stages of stride < c in shared memory; the
// stages of longer strides run on the user's buffer in device memory.
__global__ void __launch_bounds__(kSortThreads)
topk_sort_kernel(u64* __restrict__ cand, int kp, int k_top,
                 float* __restrict__ vals, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* sk = reinterpret_cast<u64*>(smem_raw);
  u64* g = cand + (size_t)blockIdx.x * kp;
  const int c = kp < kSortChunk ? kp : kSortChunk;
  // stages of `size` from stride `from` down to 1, chunk by chunk
  auto chunk_stages = [&](int size, int from) {
    for (int c0 = 0; c0 < kp; c0 += c) {
      for (int i = threadIdx.x; i < c; i += blockDim.x) sk[i] = g[c0 + i];
      __syncthreads();
      for (int s = from; s > 0; s >>= 1) {
        sort_stage(sk, c, c0, size, s);
        __syncthreads();
      }
      for (int i = threadIdx.x; i < c; i += blockDim.x) g[c0 + i] = sk[i];
      __syncthreads();
    }
  };
  for (int c0 = 0; c0 < kp; c0 += c) {  // sizes 2 … c inside each chunk
    for (int i = threadIdx.x; i < c; i += blockDim.x) sk[i] = g[c0 + i];
    __syncthreads();
    for (int size = 2; size <= c; size <<= 1)
      for (int s = size >> 1; s > 0; s >>= 1) {
        sort_stage(sk, c, c0, size, s);
        __syncthreads();
      }
    for (int i = threadIdx.x; i < c; i += blockDim.x) g[c0 + i] = sk[i];
    __syncthreads();
  }
  for (int size = 2 * c; size <= kp; size <<= 1) {
    int s = size >> 1;
    for (; s >= c; s >>= 1) {
      sort_stage(g, kp, 0, size, s);
      __syncthreads();
    }
    chunk_stages(size, s);
  }
  float* vo = vals + (size_t)blockIdx.x * k_top;
  int* io = ids + (size_t)blockIdx.x * k_top;
  for (int i = threadIdx.x; i < k_top; i += blockDim.x)
    split_key(g[i], vo[i], io[i]);
}

template <int TABLE, int BU, bool KEYS>
cudaError_t launch_partial(int splits, int kp, cudaStream_t st,
                           const float* u, const void* table,
                           const float* scale, const int* seen, int seen_w,
                           int b, int k, int m_pad, int num_movies,
                           int row_offset, int tile_m, int k_top, int vec,
                           u64* part) {
  const size_t smem = Pass1<TABLE, BU>::smem(kp, KEYS);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<TABLE, BU, KEYS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)  // room for two CTAs an SM
    err = cudaFuncSetAttribute(topk_partial_kernel<TABLE, BU, KEYS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((b + BU - 1) / BU, splits);
  topk_partial_kernel<TABLE, BU, KEYS><<<grid, 8 * BU, smem, st>>>(
      u, table, scale, seen, seen_w, b, k, m_pad, num_movies, row_offset,
      tile_m, k_top, kp, splits, vec, part);
  return cudaGetLastError();
}

template <int BU, bool KEYS>
cudaError_t launch_kind(int table_kind, int splits, int kp, cudaStream_t st,
                        const float* u, const void* table, const float* scale,
                        const int* seen, int seen_w, int b, int k, int m_pad,
                        int num_movies, int row_offset, int tile_m, int k_top,
                        int vec, u64* part) {
  switch (table_kind) {
    case kTableF32:
      return launch_partial<kTableF32, BU, KEYS>(splits, kp, st, u, table, scale,
                                           seen, seen_w, b, k, m_pad,
                                           num_movies, row_offset, tile_m,
                                           k_top, vec, part);
    case kTableBF16:
      return launch_partial<kTableBF16, BU, KEYS>(splits, kp, st, u, table, scale,
                                            seen, seen_w, b, k, m_pad,
                                            num_movies, row_offset, tile_m,
                                            k_top, vec, part);
    default:
      return launch_partial<kTableI8, BU, KEYS>(splits, kp, st, u, table, scale,
                                          seen, seen_w, b, k, m_pad,
                                          num_movies, row_offset, tile_m,
                                          k_top, vec, part);
  }
}

}  // namespace

extern "C" int cfk_topk_scores(const float* u, const void* table,
                               int table_kind, const float* scale,
                               const int* seen, int seen_w, int b, int k,
                               int m_pad, int num_movies, int row_offset,
                               int tile_m, int k_top, int users_per_cta,
                               int splits, void* part, float* vals, int* ids,
                               int device, void* stream) {
  if (b == 0) return 0;
  const int tiles = (m_pad + kTileRows - 1) / kTileRows;
  if (k < 1 || k_top < 1 || k_top > kMaxTop || splits < 1 || m_pad < 0 ||
      splits > (tiles > 0 ? tiles : 1) ||
      (users_per_cta != 16 && users_per_cta != 32) || tile_m < 1 ||
      m_pad % tile_m != 0 || table_kind < kTableF32 ||
      table_kind > kTableI8 || (table_kind == kTableI8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kp = pow2_ceil(k_top);
  const size_t smem2 =
      (size_t)(kMergeThreads / 32) * (kp < 128 ? 128 : kp) * sizeof(u64);
  if (smem2 > kMaxSmem) return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte rows: the chunk's element count divides k
  const int chunk = table_kind == kTableI8 ? 16 : table_kind == kTableBF16 ? 8 : 4;
  const int vec = (k % chunk == 0) && ((uintptr_t)table % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  u64* p = static_cast<u64*>(part);
  err = users_per_cta == 16
            ? launch_kind<16, false>(table_kind, splits, kp, st, u, table, scale,
                              seen, seen_w, b, k, m_pad, num_movies,
                              row_offset, tile_m, k_top, vec, p)
            : launch_kind<32, false>(table_kind, splits, kp, st, u, table, scale,
                              seen, seen_w, b, k, m_pad, num_movies,
                              row_offset, tile_m, k_top, vec, p);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<b, kMergeThreads, smem2, st>>>(p, splits, k_top, kp,
                                                     vals, ids);
  return (int)cudaGetLastError();
}

// K > kMaxTop: pass 1 in KEYS mode into keys [B, m_pad], then the radix
// select into cand [B, pow2(K)], then the sort and decode (three launches).
extern "C" int cfk_topk_scores_large_k(
    const float* u, const void* table, int table_kind, const float* scale,
    const int* seen, int seen_w, int b, int k, int m_pad, int num_movies,
    int row_offset, int tile_m, int k_top, int users_per_cta, int splits,
    void* keys, void* cand, float* vals, int* ids, int device, void* stream) {
  if (b == 0) return 0;
  const int tiles = (m_pad + kTileRows - 1) / kTileRows;
  if (k < 1 || k_top <= kMaxTop || k_top > (1 << 30) || splits < 1 ||
      m_pad < 0 || splits > (tiles > 0 ? tiles : 1) ||
      (users_per_cta != 16 && users_per_cta != 32) || tile_m < 1 ||
      m_pad % tile_m != 0 || table_kind < kTableF32 ||
      table_kind > kTableI8 || (table_kind == kTableI8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kp = pow2_ceil(k_top);
  const int chunk = table_kind == kTableI8 ? 16 : table_kind == kTableBF16 ? 8 : 4;
  const int vec = (k % chunk == 0) && ((uintptr_t)table % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  u64* kk = static_cast<u64*>(keys);
  u64* cc = static_cast<u64*>(cand);
  if (m_pad > 0) {
    err = users_per_cta == 16
              ? launch_kind<16, true>(table_kind, splits, 0, st, u, table,
                                      scale, seen, seen_w, b, k, m_pad,
                                      num_movies, row_offset, tile_m, k_top,
                                      vec, kk)
              : launch_kind<32, true>(table_kind, splits, 0, st, u, table,
                                      scale, seen, seen_w, b, k, m_pad,
                                      num_movies, row_offset, tile_m, k_top,
                                      vec, kk);
    if (err != cudaSuccess) return (int)err;
  }
  topk_select_kernel<<<b, kSelThreads, 0, st>>>(kk, m_pad, k_top, kp, cc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = (kp < kSortChunk ? kp : kSortChunk) * (int)sizeof(u64);
  err = cudaFuncSetAttribute(topk_sort_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  topk_sort_kernel<<<b, kSortThreads, smem, st>>>(cc, kp, k_top, vals, ids);
  return (int)cudaGetLastError();
}
