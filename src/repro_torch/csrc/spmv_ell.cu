// SpMV in ELL layout on the card.
//
// Replaces the Pallas kernel spmv_ell_kernel
// (src/repro/kernels/spmv_ell/kernel.py:46, pallas_call at :55):
//     y[r] = sum_k vals[r, k] * x[cols[r, k]]
// where a column id outside [0, len(x)) adds 0, whatever vals holds.  On
// the stationary path it is AccuGraph's pull, y[v] = sum over the
// in-edges u -> v of w * x[u], one launch per in-degree bucket (each
// bucket's rows padded to one power-of-two width).
//
// What bounds it.  Bytes: cols and vals read once (8 B a slot, padding
// included), x read once and y written once; about 0.04 ms over 3.35 TB/s
// for the 22 buckets of the wiki-talk stand-in (13.9 M slots).
//
// What the design does about it.  The TPU kernel gathers x with a one-hot
// matmul per slot on its matrix unit; the card gathers directly, from an x
// that fits the 50 MB L2, so cols and vals stream through once.  A row is
// worked by a group of G lanes of one warp, G the power of two >= k capped
// at 32: lane j takes slots j, j + G, ..., so adjacent lanes read adjacent
// words of the row-major [n, k] arrays, and the group sums with a shuffle
// tree (k = 1 is one thread a row, k >= 32 one warp a row).  Rows of
// kSplitSlots slots or more (the hub on the main path is one row of 2^21)
// are cut into chunks of kSplitSlots, one block of 256 threads each, whose
// sums are added into y atomically after y is zeroed, so a hub row does
// not sit on one warp.  Sums are f32 fused multiply-adds, in another order
// than the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSplitSlots = 4096;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_slot(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ x,
                                          long long at, int nx, float acc) {
  const int c = cols[at];
  if (static_cast<unsigned>(c) < static_cast<unsigned>(nx))
    acc = fmaf(vals[at], x[c], acc);
  return acc;
}

template <int G>
__global__ void spmv_ell_rows_kernel(const int* __restrict__ cols,
                                     const float* __restrict__ vals,
                                     const float* __restrict__ x,
                                     float* __restrict__ y, long long n,
                                     int k, int nx) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long row = t / G;
  const int lane = static_cast<int>(t % G);
  float acc = 0.0f;
  if (row < n) {
    const long long base = row * k;
    for (int s = lane; s < k; s += G)
      acc = add_slot(cols, vals, x, base + s, nx, acc);
  }
  // every lane of the warp reaches the shuffles: rows past n add 0
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off, G);
  if (row < n && lane == 0) y[row] = acc;
}

__global__ void spmv_ell_split_kernel(const int* __restrict__ cols,
                                      const float* __restrict__ vals,
                                      const float* __restrict__ x,
                                      float* __restrict__ y, int k, int nx,
                                      int chunks) {
  const long long row = blockIdx.x / chunks;
  const int lo = static_cast<int>(blockIdx.x % chunks) * kSplitSlots;
  const int hi = min(k, lo + kSplitSlots);
  const long long base = row * k;
  float acc = 0.0f;
  for (int s = lo + threadIdx.x; s < hi; s += kThreads)
    acc = add_slot(cols, vals, x, base + s, nx, acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off);
  __shared__ float part[kThreads / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kThreads / 32 ? part[threadIdx.x] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(kFull, acc, off);
    if (threadIdx.x == 0) atomicAdd(y + row, acc);
  }
}

template <int G>
void launch_rows(const int* cols, const float* vals, const float* x,
                 float* y, long long n, int k, int nx, cudaStream_t s) {
  const long long blocks = (n * G + kThreads - 1) / kThreads;
  spmv_ell_rows_kernel<G><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      cols, vals, x, y, n, k, nx);
}

}  // namespace

// cols int32[n, k] and vals float32[n, k], row-major; x float32[nx];
// y float32[n].
extern "C" int repro_spmv_ell(const void* cols, const void* vals,
                              const void* x, void* y, long long n, int k,
                              int nx, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const float* v = static_cast<const float*>(vals);
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  if (k == 0 || k >= kSplitSlots) {
    cudaError_t err = cudaMemsetAsync(yp, 0, n * sizeof(float), s);
    if (err != cudaSuccess || k == 0) return static_cast<int>(err);
    const int chunks = (k + kSplitSlots - 1) / kSplitSlots;
    const long long blocks = n * chunks;
    if (blocks > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    spmv_ell_split_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        c, v, xp, yp, k, nx, chunks);
    return static_cast<int>(cudaGetLastError());
  }
  int g = 1;
  while (g < k && g < 32) g <<= 1;
  switch (g) {
    case 1: launch_rows<1>(c, v, xp, yp, n, k, nx, s); break;
    case 2: launch_rows<2>(c, v, xp, yp, n, k, nx, s); break;
    case 4: launch_rows<4>(c, v, xp, yp, n, k, nx, s); break;
    case 8: launch_rows<8>(c, v, xp, yp, n, k, nx, s); break;
    case 16: launch_rows<16>(c, v, xp, yp, n, k, nx, s); break;
    default: launch_rows<32>(c, v, xp, yp, n, k, nx, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
