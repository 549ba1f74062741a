// Blocked multi-phase DRAM serve, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dram_serve_kernel
// (src/repro/kernels/dram_timing/kernel.py:210, body _serve_kernel at
// :163).  Its per-step semantics are make_serve_step
// (src/repro/core/vectorized.py:579-695), followed here literally and
// bit-exactly, with int32 arithmetic that wraps as XLA's does.
//
// What it computes.  A packed program is a stream of S lockstep steps of
// [C, K] request blocks (C channels, K lanes).  In each step every
// channel retires up to K row hits (a same-bank max-plus chain plus a
// prefix max on the shared data bus) or one row miss (tRAS/tRP on the
// bank, tRRD/tFAW on the rank's ACT history).  At a phase's last step
// the time carry of every channel is re-based by the phase makespan,
// max(pmf) over all channels.
//
// What bounds it.  By bytes: S*C*K*12 B (issue, meta, finish) over the
// card's 3.35 TB/s, a fraction of a millisecond for the largest main-path
// program.  In practice: the dependent chain of one step (the lanes'
// chains, the channel reductions, two block barriers) times S, because
// step s+1 reads the carry step s wrote; nothing in the recurrence lets
// two steps overlap.
//
// What the design does about it.  One CTA per program, one thread per
// (channel, lane): C*K threads, padded to whole warps.  The carry (bank
// availability, ACT times, bus, ACT history, pointer, phase makespan)
// stays in shared memory for the whole run, and one launch walks all S
// steps, so no carry crosses device memory or a launch boundary.  A
// channel's K lanes are K consecutive threads of one warp (K divides
// 32), so the in-block chains and reductions are warp shuffles over
// width-K segments.  The next step's issue/meta row is loaded into
// registers while the current step computes; a step's row is one
// coalesced [C, K] read and its finishes one coalesced write.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int NEG_INF32 = -(1 << 30);
constexpr int META_MISS = 1 << 8;
constexpr int META_CONFL = 1 << 9;
constexpr int META_VALID = 1 << 10;
constexpr int META_RB_SHIFT = 11;
constexpr int META_RB_MASK = 0x1F;
constexpr unsigned FULL = 0xffffffffu;

// int32 add/sub/mul that wrap like XLA's (signed overflow is undefined
// in C++, so the arithmetic goes through unsigned).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
// floor-mod 4, the sign convention of jnp's `%` (two's complement)
__device__ __forceinline__ int mod4(int x) { return x & 3; }

// max over the K lanes of this thread's segment (butterfly)
__device__ __forceinline__ int seg_max(int x, int K) {
  for (int off = K >> 1; off > 0; off >>= 1)
    x = max(x, __shfl_xor_sync(FULL, x, off, K));
  return x;
}

__global__ void dram_serve_kernel(
    const int* __restrict__ issue, const int* __restrict__ meta,
    const int* __restrict__ boundary, const int* __restrict__ timing,
    const int* __restrict__ avail_in, const int* __restrict__ act_in,
    const int* __restrict__ bus_in, const int* __restrict__ hist_in,
    const int* __restrict__ ptr_in, const int* __restrict__ pmf_in,
    int* __restrict__ fin, int* __restrict__ avail_out,
    int* __restrict__ act_out, int* __restrict__ bus_out,
    int* __restrict__ hist_out, int* __restrict__ ptr_out,
    int* __restrict__ pmf_out, long long S, int C, int K, int B, int R,
    int banks_per_rank) {
  extern __shared__ int smem[];
  int* s_avail = smem;            // [C, B]
  int* s_act = s_avail + C * B;   // [C, B]
  int* s_bus = s_act + C * B;     // [C]
  int* s_pmf = s_bus + C;         // [C]
  int* s_hist = s_pmf + C;        // [C, R, 4]
  int* s_ptr = s_hist + C * R * 4;  // [C, R]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  for (int i = tid; i < C * B; i += nthr) {
    s_avail[i] = avail_in[i];
    s_act[i] = act_in[i];
  }
  for (int i = tid; i < C; i += nthr) {
    s_bus[i] = bus_in[i];
    s_pmf[i] = pmf_in[i];
  }
  for (int i = tid; i < C * R * 4; i += nthr) s_hist[i] = hist_in[i];
  for (int i = tid; i < C * R; i += nthr) s_ptr[i] = ptr_in[i];

  const int tCL = timing[0], tRCD = timing[1], tRP = timing[2];
  const int tRAS = timing[3], tBL = timing[4], tRRD = timing[5];
  const int tFAW = timing[6];
  const int CK = C * K;
  // threads past C*K fill the last warp: they run every shuffle and
  // barrier as invalid lanes of channel 0 and write nothing
  const bool active = tid < CK;
  const int k = tid % K;
  const int c = active ? tid / K : 0;
  const int lane_tbl = wmul(k, tBL);
  const int lane_tbl1 = wmul(k + 1, tBL);
  __syncthreads();

  int iss_n = 0, mt_n = 0, bnd_n = 0;
  if (S > 0) {
    if (active) {
      iss_n = issue[tid];
      mt_n = meta[tid];
    }
    bnd_n = boundary[0];
  }
  for (long long s = 0; s < S; ++s) {
    const int iss = iss_n, mt = mt_n, bnd = bnd_n;
    if (s + 1 < S) {
      const long long o = (s + 1) * CK + tid;
      if (active) {
        iss_n = issue[o];
        mt_n = meta[o];
      }
      bnd_n = boundary[s + 1];
    }

    // ---- read phase: this step's lanes against the carry ------------
    const int b = mt & 0xFF;
    const bool ms = (mt & META_MISS) != 0;
    const bool cf = (mt & META_CONFL) != 0;
    const bool v = (mt & META_VALID) != 0;
    const int rb_tbl = wmul((mt >> META_RB_SHIFT) & META_RB_MASK, tBL);
    const bool in_b = b < B;
    const int avail_b = in_b ? s_avail[c * B + b] : NEG_INF32;
    const int act_b = in_b ? s_act[c * B + b] : NEG_INF32;
    const int bus_c = s_bus[c];

    // hit chain: own = max over lanes j <= k on the same bank of
    // iss_j - rank_j * tBL (masked by tril, not by validity)
    const int adj = wsub(iss, rb_tbl);
    int own = INT_MIN;
    for (int j = 0; j < K; ++j) {
      const int bj = __shfl_sync(FULL, b, j, K);
      const int aj = __shfl_sync(FULL, adj, j, K);
      own = max(own, (j <= k && bj == b) ? aj : NEG_INF32);
    }
    const int col_hit = wadd(rb_tbl, max(own, avail_b));

    // miss machinery at block level (at most one miss per block)
    const bool mv = ms && v;
    int m_any = mv ? 1 : 0;
    int rank_m = (mv && R > 1) ? b / banks_per_rank : 0;
    m_any = seg_max(m_any, K);
    rank_m = seg_max(rank_m, K);
    int ptr_m;
    int hist_m[4];
    if (R == 1) {
      ptr_m = s_ptr[c];
      for (int j = 0; j < 4; ++j) hist_m[j] = s_hist[c * 4 + j];
    } else if (rank_m < R) {
      ptr_m = max(0, s_ptr[c * R + rank_m]);
      for (int j = 0; j < 4; ++j)
        hist_m[j] = max(NEG_INF32, s_hist[(c * R + rank_m) * 4 + j]);
    } else {
      ptr_m = 0;
      for (int j = 0; j < 4; ++j) hist_m[j] = NEG_INF32;
    }
    const int last_idx = mod4(wadd(ptr_m, 3));
    int hist_p = NEG_INF32, last_r = NEG_INF32;
    for (int j = 0; j < 4; ++j) {
      hist_p = max(hist_p, j == ptr_m ? hist_m[j] : NEG_INF32);
      last_r = max(last_r, j == last_idx ? hist_m[j] : NEG_INF32);
    }
    // ACT rate limits per rank (tRRD, tFAW over the 4th-last ACT)
    const int floor_c = max(wadd(last_r, tRRD), wadd(hist_p, tFAW));
    const int base = max(iss, avail_b);
    const int pre = cf ? wadd(max(base, wadd(act_b, tRAS)), tRP) : base;
    const int a = max(pre, floor_c);
    const int col = ms ? wadd(a, tRCD) : col_hit;

    // shared data bus: prefix max over the valid lanes j <= k
    const int cadj = wsub(wadd(col, tCL), lane_tbl);
    int ccm = INT_MIN;
    for (int j = 0; j < K; ++j) {
      const int cj = __shfl_sync(FULL, cadj, j, K);
      const int vj = __shfl_sync(FULL, v ? 1 : 0, j, K);
      ccm = max(ccm, (j <= k && vj) ? cj : NEG_INF32);
    }
    const int fin_out = v ? wadd(lane_tbl1, max(bus_c, ccm)) : 0;
    if (active) fin[s * CK + tid] = fin_out;
    const int mx = seg_max(fin_out, K);
    const int a_m = seg_max(mv ? a : NEG_INF32, K);
    __syncthreads();

    // ---- write phase: the carry only ever grows (max updates) -------
    if (active) {
      if (v && in_b) atomicMax(&s_avail[c * B + b], wadd(col, tBL));
      if (mv && in_b) atomicMax(&s_act[c * B + b], a);
      if (k == 0) {
        s_bus[c] = max(bus_c, mx);
        s_pmf[c] = max(s_pmf[c], mx);
        if (m_any) {
          const int r = (R == 1) ? 0 : rank_m;
          if (r < R) {
            if (ptr_m >= 0 && ptr_m < 4) {
              int* h = &s_hist[(c * R + r) * 4 + ptr_m];
              *h = max(*h, a_m);
            }
            s_ptr[c * R + r] = mod4(wadd(ptr_m, 1));
          }
        }
      }
    }
    __syncthreads();

    // ---- phase boundary: re-base by the makespan over all channels ---
    if (bnd != 0) {
      int shift = s_pmf[0];
      for (int i = 1; i < C; ++i) shift = max(shift, s_pmf[i]);
      __syncthreads();
      const int lo = wadd(shift, NEG_INF32);
      for (int i = tid; i < C * B; i += nthr) {
        s_avail[i] = wsub(max(s_avail[i], lo), shift);
        s_act[i] = wsub(max(s_act[i], lo), shift);
      }
      for (int i = tid; i < C; i += nthr) {
        s_bus[i] = wsub(max(s_bus[i], lo), shift);
        s_pmf[i] = 0;
      }
      for (int i = tid; i < C * R * 4; i += nthr)
        s_hist[i] = wsub(max(s_hist[i], lo), shift);
      __syncthreads();
    }
  }

  for (int i = tid; i < C * B; i += nthr) {
    avail_out[i] = s_avail[i];
    act_out[i] = s_act[i];
  }
  for (int i = tid; i < C; i += nthr) {
    bus_out[i] = s_bus[i];
    pmf_out[i] = s_pmf[i];
  }
  for (int i = tid; i < C * R * 4; i += nthr) hist_out[i] = s_hist[i];
  for (int i = tid; i < C * R; i += nthr) ptr_out[i] = s_ptr[i];
}

}  // namespace

extern "C" int repro_dram_serve(
    const void* issue, const void* meta, const void* boundary,
    const void* timing, const void* avail_in, const void* act_in,
    const void* bus_in, const void* hist_in, const void* ptr_in,
    const void* pmf_in, void* fin, void* avail_out, void* act_out,
    void* bus_out, void* hist_out, void* ptr_out, void* pmf_out,
    long long S, int C, int K, int B, int R, int banks_per_rank,
    void* stream) {
  const int threads = ((C * K + 31) / 32) * 32;
  const size_t smem =
      static_cast<size_t>(2 * C * B + 2 * C + 5 * C * R) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dram_serve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dram_serve_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(issue), static_cast<const int*>(meta),
      static_cast<const int*>(boundary), static_cast<const int*>(timing),
      static_cast<const int*>(avail_in), static_cast<const int*>(act_in),
      static_cast<const int*>(bus_in), static_cast<const int*>(hist_in),
      static_cast<const int*>(ptr_in), static_cast<const int*>(pmf_in),
      static_cast<int*>(fin), static_cast<int*>(avail_out),
      static_cast<int*>(act_out), static_cast<int*>(bus_out),
      static_cast<int*>(hist_out), static_cast<int*>(ptr_out),
      static_cast<int*>(pmf_out), S, C, K, B, R, banks_per_rank);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
