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
// A quantized table (cfk_tpu/ops/quant.py) is read in its own type: a bf16
// table gives a bf16 stream, out = bf16(x · bf16(wt)) (one rounding of an
// exact product, the reference's cast order, gram_kernel.py:1958-1960), or,
// asked for float32 (the subspace sweeps), x · wt in float32; int8 codes
// give a float32 stream, code · wt, with the row's scale already folded
// into wt (the wrapper refuses int8 without wt).
//
// What bounds it on the H100: bytes.  Each entry reads one row of k
// elements (4, 2 or 1 bytes each; L2 serves repeated rows; the bound
// charges each once per entry, as the consumer sees it), 8 bytes of index
// and weight, and writes k·4 or k·2 bytes; no arithmetic beyond one
// multiply per element.
//
// Design: a flat grid-stride loop over the C·k/V vectors of V elements, V
// the elements of one 16-byte store of the output (4 floats, 8 bf16) when
// k % V == 0 and the table base is 16-byte aligned, else 1 — so
// neighbouring threads read neighbouring columns of a row and write
// neighbouring output addresses: each warp writes whole 128-byte lines,
// and reads V input elements a thread (16, 8 or 4 bytes).  Offsets are
// 64-bit: C·k passes 2³¹ for the widest sweep rectangles.
#include "common.cuh"

namespace {

// The V elements a thread moves: loaded as one vector, converted to
// float32, multiplied by the entry's weight (the output type's
// Elem::premul) and stored as one vector of V elements of Tout.
template <class T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <class Tout>
__device__ __forceinline__ Tout from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <class Tin, class Tout, int V>
__global__ void __launch_bounds__(cfk::kThreads)
gather_rows_kernel(const Tin* __restrict__ table, int F, int k,
                   const int* __restrict__ nb, const float* __restrict__ wt,
                   long long C, Tout* __restrict__ out) {
  // A bf16 output rounds the premultiply as the reference does (bf16
  // weight, one rounding of the product); a float32 one multiplies in
  // float32 (Elem<float>'s operations).
  using Op = cfk::Elem<typename std::conditional<
      std::is_same<Tout, __nv_bfloat16>::value, __nv_bfloat16, float>::type>;
  const long long kv = k / V;
  const long long total = C * kv;
  const Vec<Tin, V>* tab = reinterpret_cast<const Vec<Tin, V>*>(table);
  Vec<Tout, V>* dst = reinterpret_cast<Vec<Tout, V>*>(out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / kv;
    const long long col = i - row * kv;
    const int n = __ldg(nb + row);
    Vec<Tin, V> v{};
    if (n >= 0 && n < F) v = tab[(long long)n * kv + col];
    Vec<Tout, V> o;
    if (wt != nullptr) {
      const float w = Op::weight(__ldg(wt + row));
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = from_f<Tout>(Op::premul(to_f(v.v[j]), w));
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) o.v[j] = from_f<Tout>(to_f(v.v[j]));
    }
    dst[i] = o;
  }
}

template <class Tin, class Tout>
int launch(const void* table, int F, int k, const int* nb, const float* wt,
           long long C, int vec, void* out, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(Tout);
  const long long total = C * (vec ? k / kVec : k);
  // Enough CTAs for ~8 resident per SM on 132 SMs; the loop covers the rest.
  const long long want = (total + cfk::kThreads - 1) / cfk::kThreads;
  const int grid = (int)(want < 132 * 8 ? want : 132 * 8);
  if (vec)
    gather_rows_kernel<Tin, Tout, kVec><<<grid, cfk::kThreads, 0, st>>>(
        (const Tin*)table, F, k, nb, wt, C, (Tout*)out);
  else
    gather_rows_kernel<Tin, Tout, 1><<<grid, cfk::kThreads, 0, st>>>(
        (const Tin*)table, F, k, nb, wt, C, (Tout*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: the table's element type (cfk::Kind); out_bf16: a bf16 stream
// (bf16 tables only) rather than float32; vec: vector moves (k a multiple
// of the output's 16-byte vector, a 16-byte table base).
extern "C" int cfk_gather_rows(const void* table, int kind, int out_bf16,
                               int F, int k, const int* nb, const float* wt,
                               long long C, int vec, void* out, int device,
                               void* stream) {
  if (C == 0) return 0;
  const int width = out_bf16 ? 8 : 4;
  if (k < 1 || (vec && k % width != 0) || (out_bf16 && kind != cfk::kBF16) ||
      (kind == cfk::kI8 && wt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case cfk::kF32:
      return launch<float, float>(table, F, k, nb, wt, C, vec, out, st);
    case cfk::kBF16:
      return out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                            table, F, k, nb, wt, C, vec, out, st)
                      : launch<__nv_bfloat16, float>(table, F, k, nb, wt, C,
                                                     vec, out, st);
    case cfk::kI8:
      return launch<int8_t, float>(table, F, k, nb, wt, C, vec, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
