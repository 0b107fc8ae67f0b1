// K4 topk_scores: score a batch of users against every row of an item table
// and keep each user's K best (score, row) pairs.
//
// Replaces: cfk_tpu/serving/topk_kernel.py::topk_scores_pallas (body
// _topk_kernel, per-tile fold _score_tile_fold).  score = u · row in f32
// (int8 rows dequantized element by element, code · scale; with a bf16
// table u is rounded to bf16 first); a row whose global id row_offset + r is
// >= num_movies, or whose in-tile column is listed in seen[t, b, :], scores
// -inf.  The result is the first K of the order (score descending, id
// ascending) with empty slots (-inf, -1) — what lax.top_k's stable carry-
// first merge gives, ties included.
//
// What bounds it on the H100: at a serving batch of 256 users and rank 128,
// operations (2·B·M·k FP32 flops against one read of the table); at 16
// users, bytes (the table read).  Either way no [B, M] score matrix may be
// written: only [B, K] leaves the kernel, plus a [B, splits, K] partial.
//
// Design, two launches:
//  1. topk_partial_kernel — grid (user blocks of 8) x (splits of the table
//     rows).  A CTA of 256 threads stages its 8 users in shared memory
//     (layout [k][8], read as broadcasts) and walks its rows 256 at a time,
//     one row per thread: 32-column slices of the rows are staged
//     transposed in shared memory (coalesced global reads, conflict-free
//     row-stride-257 layout, int8 dequantized and bf16 widened on the way
//     in; the next slice is read into registers while the current one is
//     multiplied), and each thread accumulates its row's 8 scores with FP32
//     FMAs in column order.  The seen mask of a 256-row window is a bitmap rebuilt
//     per step from seen[t, b, 0:W] (a loop over W: shared memory never
//     scales with W).  A score above the user's running K-th best is
//     appended to that user's candidate buffer (warp-aggregated atomics);
//     when a buffer could overflow, a CTA-wide bitonic sort compacts every
//     buffer to its best K and raises the thresholds.  The CTA's sorted
//     top K per user goes to part[b, split, :].
//  2. topk_merge_kernel — one CTA per user bitonic-sorts its splits·K
//     candidates and writes the first K, empty slots as (-inf, -1).
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerStep = 256;  // T: one table row per thread per step
constexpr int kUsers = 8;          // users per CTA of pass 1
constexpr int kColChunk = 32;      // table columns staged per pass
constexpr int kTileLd = kRowsPerStep + 1;  // odd stride: conflict-free
constexpr int kSliceRegs = kColChunk;  // slice elements per thread
constexpr int kBitWords = kRowsPerStep / 32;
constexpr int kMergeThreads = 512;
constexpr int kMaxTop = 1024;
constexpr int kMaxRank = 512;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kEmptyId = INT_MAX;  // id of an empty slot while sorting
constexpr int kTableF32 = 0, kTableBF16 = 1, kTableI8 = 2;

__host__ __device__ inline int pow2_ceil(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sorts each aligned segment of `seg` (a power of two) entries of v/id[0, n)
// best first.  Every thread of the CTA takes part; ends synchronized.
__device__ void bitonic_sort(float* v, int* id, int n, int seg) {
  for (int size = 2; size <= seg; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));
        const int j = i + stride;
        const bool best_first = (((i & (seg - 1)) & size) == 0);
        const float vi = v[i], vj = v[j];
        const int ii = id[i], ij = id[j];
        if (best_first ? better(vj, ij, vi, ii) : better(vi, ii, vj, ij)) {
          v[i] = vj;
          v[j] = vi;
          id[i] = ij;
          id[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

template <int TABLE>
__device__ __forceinline__ float table_elem(const void* table,
                                            const float* scale, int row,
                                            int k, int col) {
  const int o = row * k + col;  // m_pad·k < 2^31, checked at launch
  if (TABLE == kTableF32) return __ldg(static_cast<const float*>(table) + o);
  if (TABLE == kTableBF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(table)[o]);
  return (float)static_cast<const int8_t*>(table)[o] * __ldg(scale + row);
}

// Thread t's share of one slice: elements i·T + t of the [T rows x
// kColChunk columns] block (row-major), so each warp reads 128 contiguous
// bytes of a row per f32 load; out-of-range rows and columns read 0.
template <int TABLE>
__device__ __forceinline__ void load_slice(float (&v)[kSliceRegs],
                                           const void* table,
                                           const float* scale, int r0, int hi,
                                           int k, int jc) {
#pragma unroll
  for (int i = 0; i < kSliceRegs; ++i) {
    const int idx = i * kRowsPerStep + threadIdx.x;
    const int row = r0 + idx / kColChunk, col = jc + idx % kColChunk;
    v[i] = (row < hi && col < k) ? table_elem<TABLE>(table, scale, row, k, col)
                                 : 0.0f;
  }
}

// Writes the slice transposed, tile_s[column][row]: the odd row stride
// keeps both this write and the per-row reads free of bank conflicts.
__device__ __forceinline__ void store_slice(const float (&v)[kSliceRegs],
                                            float* tile_s) {
#pragma unroll
  for (int i = 0; i < kSliceRegs; ++i) {
    const int idx = i * kRowsPerStep + threadIdx.x;
    tile_s[(idx % kColChunk) * kTileLd + idx / kColChunk] = v[i];
  }
}

// Keeps each user's best `k_top` candidates, sorted, and sets the
// thresholds a new candidate must beat.
__device__ void compact(float* cv, int* ci, int* cnt, float* thresh, int buf,
                        int k_top) {
  for (int idx = threadIdx.x; idx < kUsers * buf; idx += blockDim.x) {
    const int b = idx / buf;
    if (idx - b * buf >= cnt[b]) {
      cv[idx] = -INFINITY;
      ci[idx] = kEmptyId;
    }
  }
  __syncthreads();
  bitonic_sort(cv, ci, kUsers * buf, buf);
  if (threadIdx.x < kUsers) {
    const int b = threadIdx.x;
    const int c = min(cnt[b], k_top);
    cnt[b] = c;
    thresh[b] = c == k_top ? cv[b * buf + k_top - 1] : -INFINITY;
  }
  __syncthreads();
}

template <int TABLE>
__global__ void __launch_bounds__(kRowsPerStep, 2)
topk_partial_kernel(const float* __restrict__ u, const void* __restrict__ table,
                    const float* __restrict__ scale,
                    const int* __restrict__ seen, int seen_w, int b_total,
                    int k, int m_pad, int num_movies, int row_offset,
                    int tile_m, int k_top, int buf, int rows_per_split,
                    float* __restrict__ part_v, int* __restrict__ part_id) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* u_s = reinterpret_cast<float*>(smem_raw);  // [k][kUsers]
  float* tile_s = u_s + k * kUsers;                 // [kColChunk][kTileLd]
  float* cand_v = tile_s + kColChunk * kTileLd;     // [kUsers][buf]
  int* cand_id = reinterpret_cast<int*>(cand_v + kUsers * buf);
  unsigned* bits = reinterpret_cast<unsigned*>(cand_id + kUsers * buf);
  __shared__ int cnt[kUsers];
  __shared__ float thresh[kUsers];
  __shared__ int need_compact;

  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const int b0 = blockIdx.x * kUsers;
  const int n_users = min(kUsers, b_total - b0);
  const int split = blockIdx.y;
  const int lo = min(m_pad, split * rows_per_split);
  const int hi = min(m_pad, lo + rows_per_split);

  for (int idx = tid; idx < k * kUsers; idx += blockDim.x) {
    const int j = idx / kUsers, b = idx - j * kUsers;
    float x = b < n_users ? __ldg(u + (size_t)(b0 + b) * k + j) : 0.0f;
    if (TABLE == kTableBF16) x = __bfloat162float(__float2bfloat16_rn(x));
    u_s[idx] = x;
  }
  if (tid < kUsers) {
    cnt[tid] = 0;
    thresh[tid] = -INFINITY;
  }
  __syncthreads();

  // One slice = kColChunk columns of one step's kRowsPerStep rows.  Slices
  // run in (step, column) order; the next slice's elements are loaded into
  // registers while the current one is multiplied, so the global reads of
  // the staging are in flight behind the FMAs instead of in front of them.
  const int nchunks = (k + kColChunk - 1) / kColChunk;
  const int nslices = (hi - lo + kRowsPerStep - 1) / kRowsPerStep * nchunks;
  float next[kSliceRegs];
  if (nslices > 0) load_slice<TABLE>(next, table, scale, lo, hi, k, 0);
  float acc[kUsers];
  for (int sl = 0; sl < nslices; ++sl) {
    const int step = sl / nchunks, jc = (sl - step * nchunks) * kColChunk;
    const int r0 = lo + step * kRowsPerStep;
    const int r = r0 + tid;
    if (jc == 0) {
#pragma unroll
      for (int b = 0; b < kUsers; ++b) acc[b] = 0.0f;
      if (seen != nullptr) {  // this step's seen bitmap, per user
        for (int i = tid; i < kUsers * kBitWords; i += kRowsPerStep) bits[i] = 0u;
        __syncthreads();
        const int t_last = (min(r0 + kRowsPerStep, hi) - 1) / tile_m;
        for (int t = r0 / tile_m; t <= t_last; ++t) {
          const int* st = seen + ((size_t)t * b_total + b0) * seen_w;
          for (int idx = tid; idx < n_users * seen_w; idx += kRowsPerStep) {
            const int c = __ldg(st + idx);
            const int row = t * tile_m + c - r0;
            if (c >= 0 && c < tile_m && row >= 0 && row < kRowsPerStep)
              atomicOr(&bits[(idx / seen_w) * kBitWords + (row >> 5)],
                       1u << (row & 31));
          }
        }
      }
    }
    __syncthreads();  // the previous slice is consumed, the bitmap built
    store_slice(next, tile_s);
    __syncthreads();
    if (sl + 1 < nslices) {
      const int nstep = (sl + 1) / nchunks;
      load_slice<TABLE>(next, table, scale, lo + nstep * kRowsPerStep, hi, k,
                        (sl + 1 - nstep * nchunks) * kColChunk);
    }
    const int nc = min(kColChunk, k - jc);
    for (int c = 0; c < nc; ++c) {
      const float t = tile_s[c * kTileLd + tid];
      const float4* uj =
          reinterpret_cast<const float4*>(u_s + (jc + c) * kUsers);
      const float4 ua = uj[0], ub = uj[1];
      acc[0] = fmaf(ua.x, t, acc[0]);
      acc[1] = fmaf(ua.y, t, acc[1]);
      acc[2] = fmaf(ua.z, t, acc[2]);
      acc[3] = fmaf(ua.w, t, acc[3]);
      acc[4] = fmaf(ub.x, t, acc[4]);
      acc[5] = fmaf(ub.y, t, acc[5]);
      acc[6] = fmaf(ub.z, t, acc[6]);
      acc[7] = fmaf(ub.w, t, acc[7]);
    }
    if (jc + kColChunk < k) continue;
    // the step's last slice: its scores are complete
    const bool live_row = r < hi;
    const int gid = row_offset + r;
#pragma unroll
    for (int b = 0; b < kUsers; ++b) {
      if (b < n_users) {  // uniform across the CTA
        float s = acc[b];
        if (gid >= num_movies) s = -INFINITY;
        if (seen != nullptr && ((bits[b * kBitWords + (tid >> 5)] >> lane) & 1u))
          s = -INFINITY;
        const bool take = live_row && s > thresh[b];
        const unsigned mask = __ballot_sync(0xffffffffu, take);
        if (mask != 0u) {
          int base = 0;
          if (lane == 0) base = atomicAdd(&cnt[b], __popc(mask));
          base = __shfl_sync(0xffffffffu, base, 0);
          if (take) {
            const int pos = base + __popc(mask & ((1u << lane) - 1u));
            cand_v[b * buf + pos] = s;
            cand_id[b * buf + pos] = gid;
          }
        }
      }
    }
    __syncthreads();
    if (tid == 0) {
      int need = 0;
      for (int b = 0; b < kUsers; ++b) need |= cnt[b] > buf - kRowsPerStep;
      need_compact = need;
    }
    __syncthreads();
    if (need_compact) compact(cand_v, cand_id, cnt, thresh, buf, k_top);
  }
  compact(cand_v, cand_id, cnt, thresh, buf, k_top);
  for (int idx = tid; idx < n_users * k_top; idx += blockDim.x) {
    const int b = idx / k_top, i = idx - b * k_top;
    const size_t o = ((size_t)(b0 + b) * gridDim.y + split) * k_top + i;
    const bool full = i < cnt[b];
    part_v[o] = full ? cand_v[b * buf + i] : -INFINITY;
    part_id[o] = full ? cand_id[b * buf + i] : kEmptyId;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_id, int splits, int kp,
                  int k_top, int n, float* __restrict__ vals,
                  int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* v = reinterpret_cast<float*>(smem_raw);
  int* id = reinterpret_cast<int*>(v + n);
  const size_t b = blockIdx.x;
  for (int idx = threadIdx.x; idx < n; idx += blockDim.x) {
    const int s = idx / kp, i = idx - s * kp;
    if (s < splits && i < k_top) {
      const size_t o = (b * splits + s) * k_top + i;
      v[idx] = __ldg(part_v + o);
      id[idx] = __ldg(part_id + o);
    } else {
      v[idx] = -INFINITY;
      id[idx] = kEmptyId;
    }
  }
  __syncthreads();
  bitonic_sort(v, id, n, n);
  for (int i = threadIdx.x; i < k_top; i += blockDim.x) {
    vals[b * k_top + i] = v[i];
    ids[b * k_top + i] = id[i] == kEmptyId ? -1 : id[i];
  }
}

template <int TABLE>
cudaError_t launch_partial(dim3 grid, size_t smem, cudaStream_t st,
                           const float* u, const void* table,
                           const float* scale, const int* seen, int seen_w,
                           int b, int k, int m_pad, int num_movies,
                           int row_offset, int tile_m, int k_top, int buf,
                           int rows_per_split, float* part_v, int* part_id) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_partial_kernel<TABLE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  topk_partial_kernel<TABLE><<<grid, kRowsPerStep, smem, st>>>(
      u, table, scale, seen, seen_w, b, k, m_pad, num_movies, row_offset,
      tile_m, k_top, buf, rows_per_split, part_v, part_id);
  return cudaGetLastError();
}

}  // namespace

extern "C" int cfk_topk_scores(const float* u, const void* table,
                               int table_kind, const float* scale,
                               const int* seen, int seen_w, int b, int k,
                               int m_pad, int num_movies, int row_offset,
                               int tile_m, int k_top, int splits,
                               int rows_per_split, float* part_v,
                               int* part_id, float* vals, int* ids,
                               int device, void* stream) {
  if (b == 0) return 0;
  if (k < 1 || k > kMaxRank || k_top < 1 || k_top > kMaxTop || splits < 1 ||
      (long long)m_pad * k >= (1LL << 31) ||
      rows_per_split < 1 || rows_per_split % kRowsPerStep != 0 ||
      tile_m < 1 || m_pad % tile_m != 0 || table_kind < kTableF32 ||
      table_kind > kTableI8 || (table_kind == kTableI8) != (scale != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int kp = pow2_ceil(k_top);
  const int buf = pow2_ceil(kp + kRowsPerStep);
  const size_t smem1 =
      sizeof(float) * ((size_t)k * kUsers + (size_t)kColChunk * kTileLd) +
      (sizeof(float) + sizeof(int)) * (size_t)kUsers * buf +
      sizeof(unsigned) * kUsers * kBitWords;
  const int n2 = pow2_ceil(splits * kp);
  const size_t smem2 = (sizeof(float) + sizeof(int)) * (size_t)n2;
  if (smem1 > kMaxSmem || smem2 > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((b + kUsers - 1) / kUsers, splits);
  switch (table_kind) {
    case kTableF32:
      err = launch_partial<kTableF32>(grid, smem1, st, u, table, scale, seen,
                                      seen_w, b, k, m_pad, num_movies,
                                      row_offset, tile_m, k_top, buf,
                                      rows_per_split, part_v, part_id);
      break;
    case kTableBF16:
      err = launch_partial<kTableBF16>(grid, smem1, st, u, table, scale, seen,
                                       seen_w, b, k, m_pad, num_movies,
                                       row_offset, tile_m, k_top, buf,
                                       rows_per_split, part_v, part_id);
      break;
    default:
      err = launch_partial<kTableI8>(grid, smem1, st, u, table, scale, seen,
                                     seen_w, b, k, m_pad, num_movies,
                                     row_offset, tile_m, k_top, buf,
                                     rows_per_split, part_v, part_id);
  }
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(topk_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<b, kMergeThreads, smem2, st>>>(part_v, part_id, splits,
                                                     kp, k_top, n2, vals, ids);
  return (int)cudaGetLastError();
}
