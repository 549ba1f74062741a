// Segment reduce (sum / min / max by segment id) on the card.
//
// Replaces the Pallas kernel segment_reduce_kernel
// (src/repro/kernels/segment_reduce/kernel.py:60, pallas_call at :72):
//     out[s, :] = reduce { values[i, :] : ids[i] == s }
// with the identity (0, +inf, -inf) for an empty segment; ids outside
// [0, num_segments) match no segment.  On the stationary path it is
// HitGraph's gather: the PR/SpMV updates summed onto their destinations
// (d = 1).
//
// What bounds it.  Bytes: ids and values read once, out written once
// (8 B an update and 4 B a segment in f32 with d = 1), about 0.027 ms over
// 3.35 TB/s for the wiki-talk stand-in (10.0 M updates, 2.39 M segments).
//
// What the design does about it.  The TPU kernel resolves write conflicts
// with a one-hot matmul on the MXU; the card resolves them with atomics in
// L2, so there is no one-hot intermediate and every byte is read once.
// One thread per (update, column), grid-stride over the coalesced update
// arrays.  sum adds into a float64 scratch array with atomicAdd and rounds
// once at the end: with float32 atomics the 1.54 M near-equal updates of
// the wiki-talk hub, added one by one onto a growing sum, drifted by 4e-3
// relative to a float64 recompute (measured on an H100), while float64
// keeps the result within one float32 rounding of the exact sum, in any
// order.  min and max are exact in float32: integer atomics on the float's
// bits (ordered like the floats as signed ints when the value is
// non-negative, in reverse as unsigned ints when it is negative); bf16 min
// and max go through a float32 scratch array.  Updates of one hub
// destination serialise on one L2 address: right, not fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

enum Op { kSum = 0, kMin = 1, kMax = 2 };

int blocks_for(long long work) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b));
}

template <typename Acc>
__global__ void fill_kernel(Acc* out, long long size, Acc v) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < size; i += stride)
    out[i] = v;
}

__device__ __forceinline__ void atomic_min_f32(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(a), __float_as_uint(v));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Acc is double for sum and float for min / max.
template <typename Acc, typename T, int OP>
__global__ void segment_reduce_kernel(const int* __restrict__ ids,
                                      const T* __restrict__ values,
                                      Acc* acc, long long m, int d,
                                      int num_segments) {
  const long long total = m * d;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < total; t += stride) {
    const long long i = d == 1 ? t : t / d;
    const int s = ids[i];
    if (s < 0 || s >= num_segments) continue;
    const float v = to_f32(values[t]);
    Acc* out = acc + static_cast<long long>(s) * d + (t - i * d);
    if constexpr (OP == kSum)
      atomicAdd(out, static_cast<double>(v));
    else if constexpr (OP == kMin)
      atomic_min_f32(out, v);
    else
      atomic_max_f32(out, v);
  }
}

__device__ __forceinline__ void store(float* o, double v) {
  *o = static_cast<float>(v);
}
__device__ __forceinline__ void store(__nv_bfloat16* o, double v) {
  *o = __float2bfloat16_rn(static_cast<float>(v));
}
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename Acc, typename Out>
__global__ void round_kernel(const Acc* __restrict__ acc,
                             Out* __restrict__ out, long long size) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < size; i += stride)
    store(out + i, acc[i]);
}

template <typename Acc, int OP, typename T>
cudaError_t reduce_and_round(const int* ids, const T* values, Acc* acc,
                             T* out, bool round, long long m, int d,
                             int num_segments, Acc ident,
                             cudaStream_t stream) {
  const long long size = static_cast<long long>(num_segments) * d;
  fill_kernel<Acc><<<blocks_for(size), kThreads, 0, stream>>>(acc, size,
                                                               ident);
  if (m > 0)
    segment_reduce_kernel<Acc, T, OP>
        <<<blocks_for(m * d), kThreads, 0, stream>>>(ids, values, acc, m, d,
                                                     num_segments);
  if (round)
    round_kernel<Acc, T><<<blocks_for(size), kThreads, 0, stream>>>(
        acc, out, size);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int op, const int* ids, const T* values, T* out,
                     void* scratch, long long m, int d, int num_segments,
                     cudaStream_t s) {
  const float inf = std::numeric_limits<float>::infinity();
  // min / max reduce in place in a float32 out; bf16 goes through scratch
  const bool f32 = sizeof(T) == sizeof(float);
  float* acc32 = f32 ? reinterpret_cast<float*>(out)
                     : static_cast<float*>(scratch);
  switch (op) {
    case kSum:
      return reduce_and_round<double, kSum>(
          ids, values, static_cast<double*>(scratch), out, true, m, d,
          num_segments, 0.0, s);
    case kMin:
      return reduce_and_round<float, kMin>(ids, values, acc32, out, !f32, m,
                                           d, num_segments, inf, s);
    case kMax:
      return reduce_and_round<float, kMax>(ids, values, acc32, out, !f32, m,
                                           d, num_segments, -inf, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// ids int32[m]; values float32 or bfloat16 [m, d] (bf16 != 0 for
// bfloat16); out [num_segments, d] in the values' type.  scratch
// [num_segments, d]: float64 for sum, float32 for bfloat16 min / max,
// unused for float32 min / max.  op: 0 sum, 1 min, 2 max.
extern "C" int repro_segment_reduce(const void* ids, const void* values,
                                    void* out, void* scratch, long long m,
                                    int d, int num_segments, int op,
                                    int bf16, void* stream) {
  if (static_cast<long long>(num_segments) * d <= 0)
    return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  const cudaError_t err =
      bf16 ? dispatch(op, id, static_cast<const __nv_bfloat16*>(values),
                      static_cast<__nv_bfloat16*>(out), scratch, m, d,
                      num_segments, s)
           : dispatch(op, id, static_cast<const float*>(values),
                      static_cast<float*>(out), scratch, m, d, num_segments,
                      s);
  return static_cast<int>(err);
}
