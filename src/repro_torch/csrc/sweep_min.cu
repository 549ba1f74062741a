// Asynchronous min-relaxation sweep of one AccuGraph block, on the card.
//
// Replaces the XLA lax.scan _sweep_min
// (src/repro/algorithms/vertex_centric.py:41; not a Pallas kernel): for
// each in-edge (src -> dst) in edge order,
//     values[dst] = min(values[dst], values[src] + add)
// against the *current* values, in place.  That program order is the
// model of AccuGraph's asynchronous on-chip accumulation and decides the
// iteration counts and the per-block change sets, so it must be kept.
//
// What bounds it.  By bytes: the edge arrays read once (8 B per edge)
// plus the value array read and written once, a few tens of
// microseconds over 3.35 TB/s for the main-path block.  In practice: one
// dependent memory access per edge, executed in order by one thread.
//
// What the design does about it.  Exact asynchronous semantics need
// program order, so one thread walks the block's edges; the relaxation
// is deliberately not parallelised.  The value of the current
// destination stays in a register while consecutive edges share it (the
// block's edges are destination-sorted, so runs are long) and is stored
// once when the destination changes; a source equal to the current
// destination reads the register.  Every edge still sees exactly the
// values the sequential sweep would.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void sweep_min_kernel(int* values, const int* __restrict__ src,
                                 const int* __restrict__ dst, long long m,
                                 int add) {
  if (threadIdx.x != 0 || blockIdx.x != 0 || m <= 0) return;
  int cur_d = dst[0];
  int cur_v = values[cur_d];
  for (long long i = 0; i < m; ++i) {
    const int d = dst[i];
    if (d != cur_d) {
      values[cur_d] = cur_v;
      cur_d = d;
      cur_v = values[d];
    }
    const int s = src[i];
    const int vs = (s == cur_d) ? cur_v : values[s];
    cur_v = min(cur_v, wadd(vs, add));
  }
  values[cur_d] = cur_v;
}

}  // namespace

extern "C" int repro_sweep_min(void* values, const void* src,
                               const void* dst, long long m, int add,
                               void* stream) {
  sweep_min_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(values), static_cast<const int*>(src),
      static_cast<const int*>(dst), m, add);
  return static_cast<int>(cudaGetLastError());
}
