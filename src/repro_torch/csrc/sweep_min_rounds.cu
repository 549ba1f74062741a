// The asynchronous min-relaxation sweep of one AccuGraph block as exact
// parallel rounds, written by hand for Hopper (sm_90a).
//
// Replaces, with csrc/sweep_min.cu as its serial route, the XLA lax.scan
// _sweep_min (src/repro/algorithms/vertex_centric.py:41; not a Pallas
// kernel): for each in-edge (u -> v) of the block in edge order,
//     y[v] = min(y[v], y[u] + add)
// against the *current* values, in place.
//
// Why rounds give the serial result, bit for bit.  The block's edges are
// sorted by destination, so each destination v is one contiguous run and
// the runs come in ascending v.  Let x0 be the values before the sweep
// and x' the serial result.  While the serial sweep walks v's run, y[u]
// for u < v is already final (x'[u]: only v's own run writes y[v]), y[u]
// for u > v is still x0[u], and a self-loop adds nothing (add >= 0 and,
// checked by the wrapper, max(x0) + add < 2^31, so nothing wraps).  The
// order of edges inside a run does not matter, min being commutative.
// Hence x' is the unique solution of
//     x'[v] = min(x0[v], min_{u>v} (x0[u] + add), min_{u<v} (x'[u] + add))
// over v's in-edges.  A round sets y[v] = min(y[v], those terms) with
// x0[u] for u > v and the current y[u] for u < v, for every v at once, in
// place; y[u] may be read while another thread writes it.  Every value
// ever read or written is >= x' (true of x0; a term x0[u] + add or
// y[u] + add >= x'[u] + add is >= x'[v] by the equation), and values only
// fall.  So the rounds reach a fixed point, and a round in which nothing
// changes read one consistent y with y[v] <= F_v(y) for every v, where
// F_v is the right-hand side; by induction over ascending v, y[u] = x'[u]
// for u < v gives y[v] <= F_v(x') = x'[v] <= y[v].  That fixed point is x'.
//
// What bounds it.  Bytes: the sweep needs one pass, the sliced-ELL
// sources (4 B a slot), the destination ids and the values read and
// written once, about 0.018 ms for the wiki-talk block over 3.35 TB/s.
// This design makes that pass once a round.  Rounds follow the longest
// ascending-id chain along which a value improves: at most 8 (the
// synchronous count) for the first WCC sweep of the wiki-talk block, ~n
// on an ascending path.  The wrapper caps the rounds by a budget and
// then runs the serial route from x0, so the worst case costs about
// twice the serial sweep.
//
// What the design does about it.  One cooperative launch a sweep: a
// persistent grid (as many blocks as fit on the card at once) walks the
// block's in-edges in PR 14's sliced-ELL layout (kernels/spmv_ell/ops.py:
// pack_in_edges) every round, with a grid-wide barrier between rounds.
// Heavy rows: a 256-thread block a 4,096-slot chunk, a block min and one
// atomicMin.  Light rows: a warp a 32-row slice, a thread a row, the
// slice's slots column-major so each load is one coalesced line; the
// owning thread stores its row.  x0 is read through the read-only path,
// y through L2 (ld.global.cg), never a stale L1 line across rounds.  A
// warp that lowered a value records the round in a device word; after
// the barrier every thread reads it, and a round that changed nothing
// ends the launch.  The round count and whether the sweep converged are
// written to the status words the wrapper reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSliceRows = 32;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Sell {
  const int* cols;
  const long long* slice_ptr;
  const int* slice_rows;
  long long n_slices;
  const long long* chunk_ptr;
  const int* chunk_rows;
  long long n_chunks;
  int n;
};

// the relaxation term of slot u into row v; INT_MAX for none (padding,
// a self-loop)
__device__ __forceinline__ int term(int u, int v, const int* __restrict__ x0,
                                    const int* y, int add, int n) {
  if (static_cast<unsigned>(u) >= static_cast<unsigned>(n) || u == v)
    return INT_MAX;
  const int xu = u > v ? __ldg(x0 + u) : __ldcg(y + u);
  return xu + add;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// status: [0] the last round that lowered a value, counted from 1 (0 at
// the start), [1] rounds run, [2] 1 if the last round changed nothing
__global__ void __launch_bounds__(kThreads)
    sweep_rounds_kernel(int* y, const int* __restrict__ x0, Sell a, int add,
                        int max_rounds, int* status) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long units = a.n_chunks + (a.n_slices + kWarps - 1) / kWarps;
  volatile int* last_change = status;
  for (int r = 0; r < max_rounds; ++r) {
    bool changed = false;
    for (long long u = blockIdx.x; u < units; u += gridDim.x) {
      if (u < a.n_chunks) {
        // a heavy chunk: the whole block, one atomicMin
        const int row = a.chunk_rows[u];
        const long long hi = a.chunk_ptr[u + 1];
        int best = INT_MAX;
#pragma unroll 4
        for (long long at = a.chunk_ptr[u] + threadIdx.x; at < hi;
             at += kThreads)
          best = min(best, term(__ldg(a.cols + at), row, x0, y, add, a.n));
        best = warp_min(best);
        if (lane == 0) part[warp] = best;
        __syncthreads();
        if (threadIdx.x == 0) {
          for (int w = 1; w < kWarps; ++w) best = min(best, part[w]);
          if (best < __ldcg(y + row) && best < atomicMin(y + row, best))
            changed = true;
        }
        __syncthreads();
        continue;
      }
      // light slices: a warp a slice, a thread a row
      const long long s = (u - a.n_chunks) * kWarps + warp;
      if (s >= a.n_slices) continue;
      const int row = a.slice_rows[s * kSliceRows + lane];
      const long long lo = a.slice_ptr[s];
      const int width =
          static_cast<int>((a.slice_ptr[s + 1] - lo) / kSliceRows);
      int best = INT_MAX;
      long long at = lo + lane;
#pragma unroll 8
      for (int j = 0; j < width; ++j, at += kSliceRows)
        best = min(best, term(__ldg(a.cols + at), row, x0, y, add, a.n));
      if (row >= 0 && best < __ldcg(y + row)) {
        __stcg(y + row, best);
        changed = true;
      }
    }
    if (__any_sync(kFull, changed) && lane == 0) atomicMax(status, r + 1);
    grid.sync();
    // every thread reads the word after the same barrier; a round r that
    // changed nothing leaves it at most r, and no thread writes it again
    if (*last_change <= r) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        status[1] = r + 1;
        status[2] = 1;
      }
      return;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[1] = max_rounds;
    status[2] = 0;
  }
}

}  // namespace

// values int32[n] (updated in place), x0 int32[n] (a copy of values),
// the sliced ELL of the block's in-edges (cols int32[slots], slice_ptr
// int64[n_slices + 1], slice_rows int32[32 n_slices], chunk_ptr
// int64[n_chunks + 1], chunk_rows int32[n_chunks]); status int32[3] =
// {0, 0, 0} on entry, {last round that changed (from 1), rounds,
// converged} on exit.  At most max_rounds rounds.
extern "C" int repro_sweep_min_rounds(
    void* values, const void* x0, const void* cols, const void* slice_ptr,
    const void* slice_rows, long long n_slices, const void* chunk_ptr,
    const void* chunk_rows, long long n_chunks, int n, int add,
    int max_rounds, void* status, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_rounds_kernel, kThreads, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long grid_cap = static_cast<long long>(sms) * per_sm;
  if (grid_cap <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long units = n_chunks + (n_slices + kWarps - 1) / kWarps;
  const int grid = static_cast<int>(
      units < 1 ? 1 : (units < grid_cap ? units : grid_cap));
  Sell a{static_cast<const int*>(cols),
         static_cast<const long long*>(slice_ptr),
         static_cast<const int*>(slice_rows), n_slices,
         static_cast<const long long*>(chunk_ptr),
         static_cast<const int*>(chunk_rows), n_chunks, n};
  int* y = static_cast<int*>(values);
  const int* x = static_cast<const int*>(x0);
  int* st = static_cast<int*>(status);
  void* args[] = {&y, &x, &a, &add, &max_rounds, &st};
  e = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(sweep_rounds_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
