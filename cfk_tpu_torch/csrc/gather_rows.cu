// K5 gather_rows: the materialized gathered stream out[i] = table[nb[i]]·wt[i].
//
// Replaces: cfk_tpu/ops/pallas/gram_kernel.py::gather_rows_pallas
// (_gather_rows_kernel).  For C entries with row index nb[i]:
//   out[i, :] = table[nb[i], :] · wt[i]   (no multiply when wt is null)
// and an index outside [0, F) — F is the table's virtual zero row — reads
// zeros.  The subspace sweeps (ops/subspace.py) consume the whole [C, k]
// stream: their score stream is rank-updated across coordinate blocks, so it
// has to exist in device memory.
//
// What bounds it on the H100: bytes.  Each entry reads one k·4-byte row (L2
// serves repeated rows; the bound charges each once per entry, as the
// consumer sees it), 8 bytes of index and weight, and writes k·4 bytes; no
// arithmetic beyond one multiply per element.
//
// Design: a flat grid-stride loop over the C·k/V vectors (V = 4 floats when
// k % 4 == 0 and the table base is 16-byte aligned, else 1), so neighbouring
// threads read neighbouring columns of a row and write neighbouring output
// addresses — each warp moves whole 128-byte lines.  Offsets are 64-bit:
// C·k passes 2³¹ for the widest sweep rectangles.
#include "common.cuh"

namespace {

template <int V>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.0f; }
  __device__ static T scale(T v, float w) { return v * w; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T scale(T v, float w) {
    return make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
  }
};

template <int V>
__global__ void __launch_bounds__(cfk::kThreads)
gather_rows_kernel(const float* __restrict__ table, int F, int k,
                   const int* __restrict__ nb, const float* __restrict__ wt,
                   long long C, float* __restrict__ out) {
  using T = typename Vec<V>::T;
  const long long kv = k / V;
  const long long total = C * kv;
  const T* tab = reinterpret_cast<const T*>(table);
  T* dst = reinterpret_cast<T*>(out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / kv;
    const long long col = i - row * kv;
    const int n = __ldg(nb + row);
    T v = Vec<V>::zero();
    if (n >= 0 && n < F) v = __ldg(tab + (long long)n * kv + col);
    if (wt != nullptr) v = Vec<V>::scale(v, __ldg(wt + row));
    dst[i] = v;
  }
}

}  // namespace

extern "C" int cfk_gather_rows(const float* table, int F, int k,
                               const int* nb, const float* wt, long long C,
                               int vec, float* out, int device,
                               void* stream) {
  if (C == 0) return 0;
  if (k < 1 || (vec && k % 4 != 0)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const long long total = C * (vec ? k / 4 : k);
  // Enough CTAs for ~8 resident per SM on 132 SMs; the loop covers the rest.
  const long long want = (total + cfk::kThreads - 1) / cfk::kThreads;
  const int grid = (int)(want < 132 * 8 ? want : 132 * 8);
  if (vec)
    gather_rows_kernel<4><<<grid, cfk::kThreads, 0, st>>>(table, F, k, nb, wt,
                                                           C, out);
  else
    gather_rows_kernel<1><<<grid, cfk::kThreads, 0, st>>>(table, F, k, nb, wt,
                                                           C, out);
  return (int)cudaGetLastError();
}
