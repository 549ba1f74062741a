// HitGraph's scatter phase on the card: one update per edge.
//
// Replaces the Pallas kernel edge_scatter_kernel
// (src/repro/kernels/edge_scatter/kernel.py:63, pallas_call at :76):
//     upd[i]   = values[src[i]]  (op copy), then + w[i] (add) or * w[i] (mul)
//     valid[i] = active[src[i]]
// where a src outside [0, q) gathers 0 and gives valid 0, and the op is
// still applied (kernel.py:52-60).  On the stationary path it makes the
// PR/SpMV updates values[src] * w, with w the edge weight (SpMV) or
// 1/outdeg(src) (PR).
//
// What bounds it.  Bytes: src and w read and upd and valid written once
// (16 B an edge), values and active read once (8 B a vertex); about
// 0.054 ms over 3.35 TB/s for the wiki-talk stand-in (10.0 M edges,
// 2.39 M vertices).
//
// What the design does about it.  The TPU kernel turns the gather into a
// one-hot matmul because its matrix unit has no dynamic gather; the card
// gathers directly, so the edge arrays stream through once, coalesced,
// one thread an edge (grid-stride), and the random 4-byte gathers hit a
// vertex array that fits the 50 MB L2.  The op is one f32 operation, so
// the result equals the plain version's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

enum Op { kCopy = 0, kAdd = 1, kMul = 2 };

template <int OP>
__global__ void edge_scatter_kernel(const int* __restrict__ src,
                                    const float* __restrict__ w,
                                    const float* __restrict__ values,
                                    const float* __restrict__ active,
                                    float* __restrict__ upd,
                                    float* __restrict__ valid, long long m,
                                    int q) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += stride) {
    const int s = src[i];
    const bool inside = static_cast<unsigned>(s) < static_cast<unsigned>(q);
    const float g = inside ? values[s] : 0.0f;
    float u = g;
    if (OP == kAdd) u = g + w[i];
    if (OP == kMul) u = g * w[i];
    upd[i] = u;
    valid[i] = inside ? active[s] : 0.0f;
  }
}

}  // namespace

// src int32[m]; w, upd, valid float32[m]; values, active float32[q].
// op: 0 copy, 1 add, 2 mul.
extern "C" int repro_edge_scatter(const void* src, const void* w,
                                  const void* values, const void* active,
                                  void* upd, void* valid, long long m, int q,
                                  int op, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long b = (m + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(b > kMaxBlocks ? kMaxBlocks : b);
  const int* sp = static_cast<const int*>(src);
  const float* wp = static_cast<const float*>(w);
  const float* vp = static_cast<const float*>(values);
  const float* ap = static_cast<const float*>(active);
  float* up = static_cast<float*>(upd);
  float* okp = static_cast<float*>(valid);
  switch (op) {
    case kCopy:
      edge_scatter_kernel<kCopy><<<blocks, kThreads, 0, s>>>(
          sp, wp, vp, ap, up, okp, m, q);
      break;
    case kAdd:
      edge_scatter_kernel<kAdd><<<blocks, kThreads, 0, s>>>(
          sp, wp, vp, ap, up, okp, m, q);
      break;
    case kMul:
      edge_scatter_kernel<kMul><<<blocks, kThreads, 0, s>>>(
          sp, wp, vp, ap, up, okp, m, q);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
