// SpMV in sliced ELL (SELL-32) layout on the card, one launch a pull step.
//
// Replaces the Pallas kernel spmv_ell_kernel
// (src/repro/kernels/spmv_ell/kernel.py:46, pallas_call at :55):
//     y[r] = sum_k vals[r, k] * x[cols[r, k]]
// where a column id outside [0, len(x)) adds 0, whatever vals holds.  On
// the stationary path it is AccuGraph's whole pull, y[v] = sum over the
// in-edges u -> v of w * x[u], for every destination v at once.
//
// The layout (built by kernels/spmv_ell/ops.py::pack_in_edges):
//   - light rows (in-degree below a threshold, 32 by default), sorted by
//     in-degree, widest first, cut into slices of 32 rows; a slice is
//     padded to its widest row and stored column-major, so slot j of its
//     32 rows is 32 consecutive words at slice_ptr[s] + 32 j;
//   - heavy rows (the hub of the wiki-talk stand-in is one row of
//     1,540,932) stored unpadded after the slices, their edges sorted by
//     source, cut into chunks of slots (4,096 by default), chunk c =
//     [chunk_ptr[c], chunk_ptr[c + 1]) of row chunk_rows[c].
// The Pallas counterpart's row-major [n, k] ELL is the same layout with
// no heavy rows and a uniform width: slice s is rows 32 s .. 32 s + 31 and
// slot j of row r lies at r k + j (slice_ptr == nullptr).
//
// What bounds it.  Bytes: cols and vals read once (8 B an edge, plus the
// slices' padding), y written once, a destination id a row; about
// 0.028 ms over 3.35 TB/s for the stand-in's 10.04 M in-edges.  x (9.6 MB)
// stays in the 50 MB L2, but each 4-byte gather from it moves a 32-byte
// sector from L2 to the SM: ~320 MB of L2 traffic a step, beside the
// 80 MB streamed: that traffic, more than the device-memory bytes, is
// what the step's time on an H100 follows (PERF.md).
//
// What the design does about it.  One launch computes the whole y, after
// one cudaMemsetAsync that zeroes it (destinations with no in-edge stay 0,
// heavy rows start from 0 for their atomics).  Blocks [0, H) work the H
// heavy chunks: 256 threads stride over the chunk's contiguous slots, sum
// over the block and add into y atomically; sorted by source, a dense
// row's neighbouring lanes gather neighbouring words of x, so the hub's
// gathers share sectors.  Blocks [H, ...) work the slices, one warp a
// slice and one thread a row: a warp's load of cols and vals for slot j
// is one coalesced 128-byte line, streamed past L2 (evict-first) so that
// x stays resident; x is gathered through the read-only path, and each
// thread stores its row's y directly.  The light threshold bounds the
// longest walk of one thread (31 slots): at 256 the widest slices set the
// step's time (chip_smoke.py's ms_by_heavy_threshold).  Loads do not
// depend on the running sum: a padding slot gathers x[0] and its product
// is dropped by a select, so the unrolled loop keeps several slots in
// flight.  Sums are f32 fused multiply-adds, in another order than the
// plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSliceRows = 32;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_slot(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ x,
                                          long long at, int nx, float acc) {
  const int c = __ldcs(cols + at);
  const float v = __ldcs(vals + at);
  const bool inside = static_cast<unsigned>(c) < static_cast<unsigned>(nx);
  const float p = fmaf(v, __ldg(x + (inside ? c : 0)), acc);
  return inside ? p : acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
    spmv_sell_kernel(const int* __restrict__ cols,
                     const float* __restrict__ vals,
                     const float* __restrict__ x, float* __restrict__ y,
                     const long long* __restrict__ slice_ptr,
                     const int* __restrict__ slice_rows, long long n_slices,
                     const long long* __restrict__ chunk_ptr,
                     const int* __restrict__ chunk_rows, int n_chunks,
                     long long n_rows, int k, int nx) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < n_chunks) {
    // a heavy chunk: the whole block, one atomic
    const long long lo = chunk_ptr[blockIdx.x];
    const long long hi = chunk_ptr[blockIdx.x + 1];
    float acc = 0.0f;
#pragma unroll 4
    for (long long at = lo + threadIdx.x; at < hi; at += kThreads)
      acc = add_slot(cols, vals, x, at, nx, acc);
    acc = warp_sum(acc);
    __shared__ float part[kWarps];
    if (lane == 0) part[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x < 32) {
      acc = warp_sum(lane < kWarps ? part[lane] : 0.0f);
      if (lane == 0) atomicAdd(y + chunk_rows[blockIdx.x], acc);
    }
    return;
  }
  const long long s =
      (static_cast<long long>(blockIdx.x) - n_chunks) * kWarps +
      (threadIdx.x >> 5);
  if (s >= n_slices) return;
  long long at;
  int width, step, dst;
  if (slice_ptr != nullptr) {
    at = slice_ptr[s] + lane;
    width = static_cast<int>((slice_ptr[s + 1] - slice_ptr[s]) / kSliceRows);
    step = kSliceRows;
    dst = slice_rows[s * kSliceRows + lane];
  } else {
    const long long row = s * kSliceRows + lane;
    dst = row < n_rows ? static_cast<int>(row) : -1;
    width = dst >= 0 ? k : 0;
    at = row * k;
    step = 1;
  }
  float acc = 0.0f;
#pragma unroll 8
  for (int j = 0; j < width; ++j, at += step)
    acc = add_slot(cols, vals, x, at, nx, acc);
  if (dst >= 0) y[dst] = acc;
}

}  // namespace

// cols int32 and vals float32 [slots]; x float32[nx]; y float32[ny].
// Sliced layout: slice_ptr int64[n_slices + 1], slice_rows int32[32
// n_slices] (-1 for no row), chunk_ptr int64[n_chunks + 1], chunk_rows
// int32[n_chunks]; y is zeroed first.  Row-major [ny, k] ELL: slice_ptr,
// slice_rows and the chunk arrays null, n_chunks 0, n_slices = ceil(ny /
// 32); every row of y is written.
extern "C" int repro_spmv_ell(const void* cols, const void* vals,
                              const void* x, void* y, const void* slice_ptr,
                              const void* slice_rows, long long n_slices,
                              const void* chunk_ptr, const void* chunk_rows,
                              int n_chunks, long long ny, int k, int nx,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* yp = static_cast<float*>(y);
  if (slice_ptr != nullptr && ny > 0) {
    const cudaError_t err = cudaMemsetAsync(yp, 0, ny * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (nx <= 0) {
    // nothing to gather: every sum is 0
    if (slice_ptr == nullptr && ny > 0)
      return static_cast<int>(cudaMemsetAsync(yp, 0, ny * sizeof(float), s));
    return static_cast<int>(cudaGetLastError());
  }
  const long long blocks = n_chunks + (n_slices + kWarps - 1) / kWarps;
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  if (blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  spmv_sell_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int*>(cols), static_cast<const float*>(vals),
      static_cast<const float*>(x), yp,
      static_cast<const long long*>(slice_ptr),
      static_cast<const int*>(slice_rows), n_slices,
      static_cast<const long long*>(chunk_ptr),
      static_cast<const int*>(chunk_rows), n_chunks, ny, k, nx);
  return static_cast<int>(cudaGetLastError());
}
