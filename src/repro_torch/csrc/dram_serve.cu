// Blocked multi-phase DRAM serve, written by hand for Hopper (sm_90a):
// a carry-free pre-pass and a short serial carry chain.
//
// Replaces the Pallas TPU kernel dram_serve_kernel
// (src/repro/kernels/dram_timing/kernel.py:210, body _serve_kernel at
// :163).  Its per-step semantics are make_serve_step
// (src/repro/core/vectorized.py:579-695), followed here bit-exactly, with
// int32 arithmetic that wraps as XLA's does.
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
// program.  In practice: the dependent chain of one step times S, for
// step s+1 reads the carry step s wrote.
//
// What the design does about it.  Much of a step does not depend on the
// carry: the decoded meta, the same-bank hit chain `own` (lanes j <= k on
// k's bank, max of iss_j - rank_j * tBL), whether the block holds a miss
// and the miss's rank.  So the serve is two launches:
//
//  (a) serve_prepass_kernel, fully parallel over all S x C x K lanes and
//      bound by bytes: it writes, per (channel, step), a record of K
//      lanes {x, meta'}: x = iss for a miss lane and `own` for a hit
//      lane (a lane uses only one of them), meta' = meta's low 16 bits
//      plus the block's miss flag and miss rank, the phase-boundary flag
//      and an "empty" flag (no valid lane).  Records are channel-major,
//      [C, S_pad, K], so a channel's steps are contiguous.
//
//  (b) serve_records_kernel, one CTA of one warp per channel, lane k =
//      block lane k.  Channels are independent between phase boundaries,
//      so the warps meet only on boundary steps, at a named barrier, to
//      take the makespan over channels (pmf values exchanged through
//      double-buffered shared words).  A warp's bank times (avail, act),
//      ACT history and pointers sit in its own shared memory, the bus and
//      phase makespan in registers; the K lanes' loops and shuffle
//      ladders unroll (K is a template parameter).  Per step the chain
//      is: one shared load of the bank's times, a few integer ops, a
//      log2(K) shuffle scan for the bus prefix max, one warp reduction
//      (redux.sync) for the step's makespan, and shared atomicMax on the
//      bank (a miss also reads and writes the rank's ACT history).  An empty block only clamps the
//      bus and makespan at 0.  Records stream into a per-warp ring of
//      shared memory, four chunks of T steps deep, by cp.async.bulk (the
//      TMA's bulk copy) completing on an mbarrier per slot; lane 0
//      refills a slot as soon as the warp has read it.  Finishes are
//      staged in shared memory, a chunk's T steps, and stored by the
//      whole warp, coalesced, once a chunk into the [S, C, K] output (a
//      store a lane a step straight from the lanes was 1-2 % slower on
//      the full main-path programs on an H100: tools/serve_variants.py).
//
// The case axis (dram_serve_batch).  A sweep serves M cases of one
// shape at once: M timing vectors against one shared program (the
// geometry-keyed pack cache), or M stacked programs.  This replaces
// jax.vmap over _fused_scan_core (src/repro/core/vectorized.py:775-795,
// an XLA scan, not a Pallas kernel).  Both launches take the case
// axis: the pre-pass on gridDim.y (case m reads its program at a case
// stride, 0 for a shared program, so one is never copied M times, and
// writes rec[m] with its own tBL), the serve as one CTA a case,
// blockIdx.x = m, which offsets the records, the timing vector, the six
// carries and fin[m, S, C, K].  The named barrier and the pmf exchange
// stay inside the CTA: cases never meet, and no CTA waits on another, so
// the launch needs no co-residency; M cases take M SMs (past 132 the
// CTAs queue).  Bound: the call's own bytes over 3.35 TB/s (for M
// stacked programs M times the single-case bytes; a shared program is
// read once, and only each case's finishes and carries are M-fold), and
// the carry chain of the longest case.  dram_serve is the case M = 1.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int NEG_INF32 = -(1 << 30);
constexpr int META_MISS = 1 << 8;
constexpr int META_CONFL = 1 << 9;
constexpr int META_VALID = 1 << 10;
constexpr int META_RB_SHIFT = 11;
constexpr int META_RB_MASK = 0x1F;
// record-only bits of meta'
constexpr int REC_M_ANY = 1 << 16;
constexpr int REC_RANK_SHIFT = 17;  // 8 bits
constexpr int REC_BOUNDARY = 1 << 25;
constexpr int REC_EMPTY = 1 << 26;
constexpr unsigned FULL = 0xffffffffu;
constexpr int kSlots = 4;
constexpr int kPrepassThreads = 256;

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

// ---- (a) the carry-free pre-pass ---------------------------------------

__global__ void __launch_bounds__(kPrepassThreads)
    serve_prepass_kernel(const int* __restrict__ issue,
                         const int* __restrict__ meta,
                         const int* __restrict__ boundary,
                         const int* __restrict__ timing,
                         int2* __restrict__ rec, long long S,
                         long long S_pad, int C, int K, int R,
                         int banks_per_rank, long long case_stride,
                         long long bnd_stride) {
  // case m = blockIdx.y: its program (stride 0 when shared), its timing
  // vector and its records
  const long long m = blockIdx.y;
  issue += m * case_stride;
  meta += m * case_stride;
  boundary += m * bnd_stride;
  timing += m * 7;
  rec += m * S_pad * C * K;
  const int tBL = timing[4];
  const long long CK = static_cast<long long>(C) * K;
  const long long total = S_pad * CK;
  // every lane of a warp runs the same trip count (the shuffles need the
  // whole warp), lanes past the end on dummy values
  const long long span = (total + 31) / 32 * 32;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t - threadIdx.x % 32 < span; t += stride) {
    const bool in = t < total;
    const long long s = in ? t / CK : 0;
    const int c = in ? static_cast<int>((t / K) % C) : 0;
    const int k = static_cast<int>(t % K);
    const bool live = in && s < S;
    const int iss = live ? issue[t] : 0;
    const int mt = live ? meta[t] : 0;
    const int bnd = live ? boundary[s] : 0;
    const int b = mt & 0xFF;
    const bool ms = (mt & META_MISS) != 0;
    const bool v = (mt & META_VALID) != 0;
    const int rb_tbl = wmul((mt >> META_RB_SHIFT) & META_RB_MASK, tBL);
    // hit chain: own = max over lanes j <= k on the same bank of
    // iss_j - rank_j * tBL (masked by tril, not by validity)
    const int adj = wsub(iss, rb_tbl);
    int own = INT_MIN;
    for (int j = 0; j < K; ++j) {
      const int bj = __shfl_sync(FULL, b, j, K);
      const int aj = __shfl_sync(FULL, adj, j, K);
      own = max(own, (j <= k && bj == b) ? aj : NEG_INF32);
    }
    const bool mv = ms && v;
    const int m_any = seg_max(mv ? 1 : 0, K);
    const int rank_m = seg_max((mv && R > 1) ? b / banks_per_rank : 0, K);
    const int any_valid = seg_max(v ? 1 : 0, K);
    const int mt2 = (mt & 0xFFFF) | (m_any ? REC_M_ANY : 0) |
                    ((rank_m & 0xFF) << REC_RANK_SHIFT) |
                    (bnd != 0 ? REC_BOUNDARY : 0) |
                    (any_valid ? 0 : REC_EMPTY);
    if (in)
      rec[(static_cast<long long>(c) * S_pad + s) * K + k] =
          make_int2(ms ? iss : own, mt2);
  }
}

// ---- (b) the serial chain over the records ------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one bulk copy global -> shared that completes on `bar` (lane 0 only)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  // the warp's generic reads of this slot come before the async write
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// The serve's carry chain, one warp a channel; K (the block's lanes) is a
// compile-time width, so every lane loop and shuffle ladder unrolls.
template <int K>
__global__ void __launch_bounds__(1024) serve_records_kernel(
    const int2* __restrict__ rec, const int* __restrict__ timing,
    const int* __restrict__ avail_in, const int* __restrict__ act_in,
    const int* __restrict__ bus_in, const int* __restrict__ hist_in,
    const int* __restrict__ ptr_in, const int* __restrict__ pmf_in,
    int* __restrict__ fin, int* __restrict__ avail_out,
    int* __restrict__ act_out, int* __restrict__ bus_out,
    int* __restrict__ hist_out, int* __restrict__ ptr_out,
    int* __restrict__ pmf_out, long long S, long long S_pad, int T, int C,
    int B, int R) {
  extern __shared__ __align__(128) unsigned char smem[];
  {
    // one CTA a case: case m = blockIdx.x serves its own records, timing
    // vector, carries and finishes
    const long long m = blockIdx.x;
    const long long CB = static_cast<long long>(C) * B;
    const long long CR = static_cast<long long>(C) * R;
    rec += m * C * S_pad * K;
    timing += m * 7;
    avail_in += m * CB;
    act_in += m * CB;
    bus_in += m * C;
    hist_in += m * CR * 4;
    ptr_in += m * CR;
    pmf_in += m * C;
    fin += m * S * C * K;
    avail_out += m * CB;
    act_out += m * CB;
    bus_out += m * C;
    hist_out += m * CR * 4;
    ptr_out += m * CR;
    pmf_out += m * C;
  }
  const int c = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int TK = T * K;
  int2* ring = reinterpret_cast<int2*>(smem) + c * kSlots * TK;
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + static_cast<size_t>(C) * kSlots * TK * 8) +
                   c * kSlots;
  int* s_pmfx = reinterpret_cast<int*>(
      smem + static_cast<size_t>(C) * kSlots * TK * 8 + C * kSlots * 8);
  int* s_avail = s_pmfx + 2 * C + c * B;       // this channel's [B]
  int* s_act = s_pmfx + 2 * C + C * B + c * B;
  int* s_hist = s_pmfx + 2 * C + 2 * C * B + c * R * 4;  // [R, 4]
  int* s_ptr = s_pmfx + 2 * C + 2 * C * B + C * R * 4 + c * R;
  int* s_fin = s_pmfx + 2 * C + 2 * C * B + 5 * C * R + c * TK;  // [T, K]

  for (int i = lane; i < B; i += 32) {
    s_avail[i] = avail_in[c * B + i];
    s_act[i] = act_in[c * B + i];
  }
  for (int i = lane; i < R * 4; i += 32) s_hist[i] = hist_in[c * R * 4 + i];
  for (int i = lane; i < R; i += 32) s_ptr[i] = ptr_in[c * R + i];
  int bus = bus_in[c];
  int pmf = pmf_in[c];

  const int tCL = timing[0], tRCD = timing[1], tRP = timing[2];
  const int tRAS = timing[3], tBL = timing[4], tRRD = timing[5];
  const int tFAW = timing[6];
  const int k = lane % K;
  const bool writer = lane < K;
  const int lane_tbl = wmul(k, tBL);
  const int lane_tbl1 = wmul(k + 1, tBL);
  const int tcl_lane = wsub(tCL, lane_tbl);
  const long long n_chunks = (S + T - 1) / T;
  const int2* src = rec + static_cast<long long>(c) * S_pad * K;
  const int chunk_bytes = TK * 8;
  // the finish of lane k at step s is fin[s * C * K + c * K + k]
  const long long fstride = static_cast<long long>(C) * K;

  if (lane == 0) {
    for (int i = 0; i < kSlots; ++i) mbar_init(&bars[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (long long i = 0; i < kSlots && i < n_chunks; ++i)
      bulk_load(ring + i * TK, src + i * TK, chunk_bytes, &bars[i]);
  }
  __syncwarp();

  int par = 0;
  for (long long ch = 0; ch < n_chunks; ++ch) {
    const int slot = static_cast<int>(ch % kSlots);
    mbar_wait(&bars[slot], static_cast<int>((ch / kSlots) & 1));
    const int2* buf = ring + slot * TK;
    const int steps = static_cast<int>(S - ch * T < T ? S - ch * T : T);
    int2 r_next = buf[k];
    for (int i = 0; i < steps; ++i) {
      // the record of the next step is read while this one computes
      const int2 r = r_next;
      if (i + 1 < steps) r_next = buf[(i + 1) * K + k];
      const int x = r.x, mt = r.y;
      if (mt & REC_EMPTY) {
        // no valid lane: every finish 0, the step's makespan 0
        if (writer) s_fin[i * K + k] = 0;
        bus = max(bus, 0);
        pmf = max(pmf, 0);
      } else {
        // ---- read phase: this step's lanes against the carry --------
        const int b = mt & 0xFF;
        const bool ms = (mt & META_MISS) != 0;
        const bool v = (mt & META_VALID) != 0;
        const int rb_tbl = wmul((mt >> META_RB_SHIFT) & META_RB_MASK, tBL);
        const bool in_b = b < B;
        const int avail_b = in_b ? s_avail[b] : NEG_INF32;
        const bool m_any = (mt & REC_M_ANY) != 0;   // warp-uniform
        const bool mv = ms && v;
        int col, a = NEG_INF32, ptr_m = 0, rank_m = 0;
        if (m_any) {
          // miss machinery at block level (x is this lane's issue)
          const bool cf = (mt & META_CONFL) != 0;
          rank_m = (mt >> REC_RANK_SHIFT) & 0xFF;
          const int act_b = in_b ? s_act[b] : NEG_INF32;
          int hist_m[4];
          if (R == 1) {
            ptr_m = s_ptr[0];
#pragma unroll
            for (int j = 0; j < 4; ++j) hist_m[j] = s_hist[j];
          } else if (rank_m < R) {
            ptr_m = max(0, s_ptr[rank_m]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              hist_m[j] = max(NEG_INF32, s_hist[rank_m * 4 + j]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) hist_m[j] = NEG_INF32;
          }
          const int last_idx = mod4(wadd(ptr_m, 3));
          int hist_p = NEG_INF32, last_r = NEG_INF32;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hist_p = max(hist_p, j == ptr_m ? hist_m[j] : NEG_INF32);
            last_r = max(last_r, j == last_idx ? hist_m[j] : NEG_INF32);
          }
          // ACT rate limits per rank (tRRD, tFAW over the 4th-last ACT)
          const int floor_c = max(wadd(last_r, tRRD), wadd(hist_p, tFAW));
          const int base = max(x, avail_b);
          const int pre = cf ? wadd(max(base, wadd(act_b, tRAS)), tRP) : base;
          a = max(pre, floor_c);
          col = ms ? wadd(a, tRCD) : wadd(rb_tbl, max(x, avail_b));
        } else {
          // hits only (x is this lane's `own`); an invalid lane's col
          // is never used
          col = wadd(rb_tbl, max(x, avail_b));
        }
        // shared data bus: prefix max over the valid lanes j <= k
        int ccm = v ? wadd(col, tcl_lane) : NEG_INF32;
#pragma unroll
        for (int off = 1; off < K; off <<= 1) {
          const int up = __shfl_up_sync(FULL, ccm, off, K);
          if (k >= off) ccm = max(ccm, up);
        }
        const int fin_out = v ? wadd(lane_tbl1, max(bus, ccm)) : 0;
        if (writer) s_fin[i * K + k] = fin_out;
        // every lane >= K replicates lane (lane % K), so the max over the
        // whole warp is the max over the block's K lanes
        const int mx = __reduce_max_sync(FULL, fin_out);
        const int a_m = m_any ? __reduce_max_sync(FULL, mv ? a : NEG_INF32)
                              : NEG_INF32;
        __syncwarp();
        // ---- write phase: the carry only ever grows (max updates) ----
        if (writer && v && in_b) atomicMax(&s_avail[b], wadd(col, tBL));
        if (m_any) {
          if (writer && mv && in_b) atomicMax(&s_act[b], a);
          if (lane == 0) {
            const int rr = (R == 1) ? 0 : rank_m;
            if (rr < R) {
              if (ptr_m >= 0 && ptr_m < 4) {
                int* h = &s_hist[rr * 4 + ptr_m];
                *h = max(*h, a_m);
              }
              s_ptr[rr] = mod4(wadd(ptr_m, 1));
            }
          }
        }
        bus = max(bus, mx);
        pmf = max(pmf, mx);
      }
      // ---- phase boundary: re-base by the makespan over all channels --
      if (mt & REC_BOUNDARY) {
        int shift = pmf;
        if (C > 1) {
          if (lane == 0) s_pmfx[par * C + c] = pmf;
          named_barrier(32 * C);
          shift = s_pmfx[par * C];
          for (int i = 1; i < C; ++i) shift = max(shift, s_pmfx[par * C + i]);
          par ^= 1;
        }
        __syncwarp();
        const int lo = wadd(shift, NEG_INF32);
        for (int i = lane; i < B; i += 32) {
          s_avail[i] = wsub(max(s_avail[i], lo), shift);
          s_act[i] = wsub(max(s_act[i], lo), shift);
        }
        for (int i = lane; i < R * 4; i += 32)
          s_hist[i] = wsub(max(s_hist[i], lo), shift);
        bus = wsub(max(bus, lo), shift);
        pmf = 0;
      }
      __syncwarp();
    }
    // the chunk's finishes, from shared memory, by the whole warp
    __syncwarp();
    for (int e = lane; e < steps * K; e += 32)
      fin[(ch * T + e / K) * fstride + c * K + e % K] = s_fin[e];
    __syncwarp();
    // refill the slot just read with the chunk kSlots ahead
    if (lane == 0 && ch + kSlots < n_chunks)
      bulk_load(ring + slot * TK, src + (ch + kSlots) * TK, chunk_bytes,
                &bars[slot]);
  }

  for (int i = lane; i < B; i += 32) {
    avail_out[c * B + i] = s_avail[i];
    act_out[c * B + i] = s_act[i];
  }
  for (int i = lane; i < R * 4; i += 32) hist_out[c * R * 4 + i] = s_hist[i];
  for (int i = lane; i < R; i += 32) ptr_out[c * R + i] = s_ptr[i];
  if (lane == 0) {
    bus_out[c] = bus;
    pmf_out[c] = pmf;
  }
}

size_t records_smem(int C, int K, int T, int B, int R) {
  return static_cast<size_t>(C) * kSlots * T * K * 8 +
         static_cast<size_t>(C) * kSlots * 8 +
         static_cast<size_t>(2 * C + 2 * C * B + 5 * C * R + C * T * K) *
             sizeof(int);
}

template <int K>
int launch_records(const void* rec, const void* timing, const void* avail_in,
                   const void* act_in, const void* bus_in,
                   const void* hist_in, const void* ptr_in,
                   const void* pmf_in, void* fin, void* avail_out,
                   void* act_out, void* bus_out, void* hist_out,
                   void* ptr_out, void* pmf_out, long long S,
                   long long S_pad, int T, int C, int B, int R, int M,
                   size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        serve_records_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  serve_records_kernel<K><<<M, 32 * C, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(rec), static_cast<const int*>(timing),
      static_cast<const int*>(avail_in), static_cast<const int*>(act_in),
      static_cast<const int*>(bus_in), static_cast<const int*>(hist_in),
      static_cast<const int*>(ptr_in), static_cast<const int*>(pmf_in),
      static_cast<int*>(fin), static_cast<int*>(avail_out),
      static_cast<int*>(act_out), static_cast<int*>(bus_out),
      static_cast<int*>(hist_out), static_cast<int*>(ptr_out),
      static_cast<int*>(pmf_out), S, S_pad, T, C, B, R);
  return static_cast<int>(cudaGetLastError());
}

int launch_prepass(const void* issue, const void* meta, const void* boundary,
                   const void* timing, void* rec, long long S,
                   long long S_pad, int C, int K, int R, int banks_per_rank,
                   int M, long long case_stride, long long bnd_stride,
                   void* stream) {
  const long long total = S_pad * C * K;
  if (total <= 0 || M < 1) return static_cast<int>(cudaGetLastError());
  if (M > 65535) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (total + kPrepassThreads - 1) / kPrepassThreads;
  if (blocks > 65536) blocks = 65536;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(M));
  serve_prepass_kernel<<<grid, kPrepassThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(issue), static_cast<const int*>(meta),
      static_cast<const int*>(boundary), static_cast<const int*>(timing),
      static_cast<int2*>(rec), S, S_pad, C, K, R, banks_per_rank,
      case_stride, bnd_stride);
  return static_cast<int>(cudaGetLastError());
}

int launch_serve(const void* rec, const void* timing, const void* avail_in,
                 const void* act_in, const void* bus_in, const void* hist_in,
                 const void* ptr_in, const void* pmf_in, void* fin,
                 void* avail_out, void* act_out, void* bus_out,
                 void* hist_out, void* ptr_out, void* pmf_out, long long S,
                 long long S_pad, int T, int C, int K, int B, int R, int M,
                 void* stream) {
  if (C < 1 || C > 32 || T < 1 || (T * K * 8) % 16 != 0 || S_pad % T != 0 ||
      S_pad < S || M < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = records_smem(C, K, T, B, R);
  switch (K) {
#define REPRO_SERVE_CASE(KK)                                                  \
  case KK:                                                                    \
    return launch_records<KK>(rec, timing, avail_in, act_in, bus_in, hist_in, \
                              ptr_in, pmf_in, fin, avail_out, act_out,        \
                              bus_out, hist_out, ptr_out, pmf_out, S, S_pad,  \
                              T, C, B, R, M, smem, stream);
    REPRO_SERVE_CASE(1)
    REPRO_SERVE_CASE(2)
    REPRO_SERVE_CASE(4)
    REPRO_SERVE_CASE(8)
    REPRO_SERVE_CASE(16)
    REPRO_SERVE_CASE(32)
#undef REPRO_SERVE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The pre-pass for M cases: issue, meta int32[M, S, C, K] and boundary
// int32[M, S] (or, with shared != 0, one [S, C, K] program and [S] for
// every case), timing int32[M, 7] -> rec int32[M, C, S_pad, K, 2]
// (S_pad >= S; steps past S are written as empty blocks).  M <= 65535.
extern "C" int repro_dram_serve_prepass_batch(
    const void* issue, const void* meta, const void* boundary,
    const void* timing, void* rec, long long S, long long S_pad, int C, int K,
    int R, int banks_per_rank, int M, int shared, void* stream) {
  const long long case_stride = shared ? 0 : S * C * K;
  return launch_prepass(issue, meta, boundary, timing, rec, S, S_pad, C, K,
                        R, banks_per_rank, M, case_stride, shared ? 0 : S,
                        stream);
}

// The serve of M cases, one CTA a case, over the records of
// repro_dram_serve_prepass_batch (chunks of T steps: T * K * 8 bytes a
// multiple of 16, S_pad a multiple of T): timing int32[M, 7], the 6
// carries with a leading case axis in and out, fin int32[M, S, C, K].
// C <= 32 (a warp a channel).
extern "C" int repro_dram_serve_batch(
    const void* rec, const void* timing, const void* avail_in,
    const void* act_in, const void* bus_in, const void* hist_in,
    const void* ptr_in, const void* pmf_in, void* fin, void* avail_out,
    void* act_out, void* bus_out, void* hist_out, void* ptr_out,
    void* pmf_out, long long S, long long S_pad, int T, int C, int K, int B,
    int R, int M, void* stream) {
  return launch_serve(rec, timing, avail_in, act_in, bus_in, hist_in, ptr_in,
                      pmf_in, fin, avail_out, act_out, bus_out, hist_out,
                      ptr_out, pmf_out, S, S_pad, T, C, K, B, R, M, stream);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
