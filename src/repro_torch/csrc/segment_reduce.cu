// Segment reduce (sum / min / max by segment id) on the card.
//
// Replaces the Pallas kernel segment_reduce_kernel
// (src/repro/kernels/segment_reduce/kernel.py:60, pallas_call at :72):
//     out[s, :] = reduce { values[i, :] : ids[i] == s }
// with the identity (0, +inf, -inf) for an empty segment; ids outside
// [0, num_segments) match no segment.  On the stationary path it is
// HitGraph's gather: the PR/SpMV updates summed onto their destinations
// (d = 1), fed in destination order.
//
// What bounds it.  Bytes: ids and values read once, out written once
// (8 B an update and 4 B a segment in f32 with d = 1), about 0.027 ms over
// 3.35 TB/s for the wiki-talk stand-in (10.0 M updates, 2.39 M segments).
//
// What the design does about it.  The TPU kernel resolves write conflicts
// with a one-hot matmul on the MXU; the card combines runs of equal ids
// before it touches memory.  A block takes a tile of kTile consecutive
// updates of one column: it stages ids and values through shared memory
// with coalesced loads, each thread reduces its kItems consecutive updates
// in registers, and a segmented scan over the threads (warp shuffles, then
// one shared-memory pass over the block's warps) carries each run that
// crosses a thread boundary to the thread where it ends.  Each (tile, run)
// then costs one atomic, issued by the thread that holds the run's end.  A
// run is a maximal stretch of equal ids; an out-of-range id breaks a run
// and adds nothing.  On destination-sorted updates the wiki-talk hub's
// 1.54 M updates become ~380 atomics, and the gather becomes one streaming
// pass plus one atomic a destination; on unsorted ids nearly every update
// is its own run, as before.  sum adds into a float64 scratch array and
// rounds once at the end: with float32 atomics the 1.54 M near-equal
// updates of the hub, added one by one onto a growing sum, drifted by 4e-3
// relative to a float64 recompute (measured on an H100), while float64
// keeps the result within one float32 rounding of the exact sum, in any
// order.  min and max are exact in float32: integer atomics on the float's
// bits (ordered like the floats as signed ints when the value is
// non-negative, in reverse as unsigned ints when it is negative); bf16 min
// and max go through a float32 scratch array.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 1 << 20;
constexpr unsigned kFull = 0xffffffffu;
// shared-memory slot of tile position p: one word of padding every 32, so
// that thread t's reads of positions t kItems + k fall in distinct banks
__device__ __forceinline__ int spos(int p) { return p + (p >> 5); }
constexpr int kSmem = kTile + kTile / 32;

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

template <typename Acc, int OP>
__host__ __device__ __forceinline__ Acc identity() {
  if constexpr (OP == kSum) return Acc(0);
  else if constexpr (OP == kMin) return Acc(INFINITY);
  else return Acc(-INFINITY);
}

template <typename Acc, int OP>
__device__ __forceinline__ Acc combine(Acc a, Acc b) {
  if constexpr (OP == kSum) return a + b;
  else if constexpr (OP == kMin) return b < a ? b : a;
  else return b > a ? b : a;
}

template <typename Acc, int OP>
__device__ __forceinline__ void emit(Acc* acc, int s, int num_segments,
                                     long long d, int col, Acc v) {
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(num_segments)) return;
  Acc* out = acc + static_cast<long long>(s) * d + col;
  if constexpr (OP == kSum)
    atomicAdd(out, v);
  else if constexpr (OP == kMin)
    atomic_min_f32(out, v);
  else
    atomic_max_f32(out, v);
}

// A scan element: whether a run starts inside the span (head), and the
// reduction of the span from its last run start (or from its beginning).
template <typename Acc, int OP>
__device__ __forceinline__ void scan_op(int& head, Acc& val, int pre_head,
                                        Acc pre_val) {
  if (!head) val = combine<Acc, OP>(pre_val, val);
  head |= pre_head;
}

// Acc is double for sum and float for min / max.  Block b works tile
// b / d of column b % d.
template <typename Acc, typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    segment_reduce_kernel(const int* __restrict__ ids,
                          const T* __restrict__ values, Acc* acc,
                          long long m, int d, int num_segments) {
  __shared__ int s_id[kSmem];
  __shared__ float s_val[kSmem];
  __shared__ int w_head[kWarps];
  __shared__ Acc w_val[kWarps];
  const long long tile = blockIdx.x / d;
  const int col = static_cast<int>(blockIdx.x % d);
  const long long base = tile * kTile;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // stage the tile, coalesced; past m an out-of-range id adds nothing
  for (int p = t; p < kTile; p += kThreads) {
    const long long i = base + p;
    const bool in = i < m;
    s_id[spos(p)] = in ? ids[i] : -1;
    s_val[spos(p)] = in ? to_f32(values[i * d + col]) : 0.0f;
  }
  __syncthreads();

  int id[kItems];
  float v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    id[k] = s_id[spos(t * kItems + k)];
    v[k] = s_val[spos(t * kItems + k)];
  }
  const int prev_id = t ? s_id[spos(t * kItems - 1)] : id[0];
  const int next_id = t + 1 < kThreads ? s_id[spos((t + 1) * kItems)] : 0;

  // this thread's scan element: is there a run head in it, and its tail
  int head = 0;
  Acc tail = identity<Acc, OP>();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (id[k] != (k ? id[k - 1] : prev_id)) {
      head = 1;
      tail = identity<Acc, OP>();
    }
    tail = combine<Acc, OP>(tail, static_cast<Acc>(v[k]));
  }

  // inclusive segmented scan over the warp, then over the warps
  int h = head;
  Acc val = tail;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int ph = __shfl_up_sync(kFull, h, off);
    const Acc pv = __shfl_up_sync(kFull, val, off);
    if (lane >= off) scan_op<Acc, OP>(h, val, ph, pv);
  }
  if (lane == 31) {
    w_head[warp] = h;
    w_val[warp] = val;
  }
  __syncthreads();
  // exclusive within the warp: the inclusive value of the lane before
  int eh = __shfl_up_sync(kFull, h, 1);
  Acc ev = __shfl_up_sync(kFull, val, 1);
  // prefix of the earlier warps, then this warp's lanes before this one
  int ph = 0;
  Acc pv = identity<Acc, OP>();
  for (int w = 0; w < warp; ++w) {
    int wh = w_head[w];
    Acc wv = w_val[w];
    scan_op<Acc, OP>(wh, wv, ph, pv);
    ph = wh;
    pv = wv;
  }
  if (lane) scan_op<Acc, OP>(eh, ev, ph, pv);
  else ev = pv;
  // ev: the reduction of the run that is open at the end of thread t - 1

  // walk the items again: one atomic at each run's end in this tile
  int cur = id[0];
  Acc run = t && id[0] == prev_id ? ev : identity<Acc, OP>();
  run = combine<Acc, OP>(run, static_cast<Acc>(v[0]));
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    if (id[k] != cur) {
      emit<Acc, OP>(acc, cur, num_segments, d, col, run);
      cur = id[k];
      run = identity<Acc, OP>();
    }
    run = combine<Acc, OP>(run, static_cast<Acc>(v[k]));
  }
  if (t + 1 == kThreads || next_id != cur)
    emit<Acc, OP>(acc, cur, num_segments, d, col, run);
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
                             int num_segments, cudaStream_t stream) {
  const long long size = static_cast<long long>(num_segments) * d;
  if constexpr (OP == kSum) {
    const cudaError_t err =
        cudaMemsetAsync(acc, 0, size * sizeof(Acc), stream);
    if (err != cudaSuccess) return err;
  } else {
    fill_kernel<Acc><<<blocks_for(size), kThreads, 0, stream>>>(
        acc, size, identity<Acc, OP>());
  }
  const long long blocks = (m + kTile - 1) / kTile * d;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  if (blocks > 0)
    segment_reduce_kernel<Acc, T, OP>
        <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            ids, values, acc, m, d, num_segments);
  if (round)
    round_kernel<Acc, T><<<blocks_for(size), kThreads, 0, stream>>>(
        acc, out, size);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int op, const int* ids, const T* values, T* out,
                     void* scratch, long long m, int d, int num_segments,
                     cudaStream_t s) {
  // min / max reduce in place in a float32 out; bf16 goes through scratch
  const bool f32 = sizeof(T) == sizeof(float);
  float* acc32 = f32 ? reinterpret_cast<float*>(out)
                     : static_cast<float*>(scratch);
  switch (op) {
    case kSum:
      return reduce_and_round<double, kSum>(
          ids, values, static_cast<double*>(scratch), out, true, m, d,
          num_segments, s);
    case kMin:
      return reduce_and_round<float, kMin>(ids, values, acc32, out, !f32, m,
                                           d, num_segments, s);
    case kMax:
      return reduce_and_round<float, kMax>(ids, values, acc32, out, !f32, m,
                                           d, num_segments, s);
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
