// Blocked multi-phase DRAM serve, written by hand for Hopper (sm_90a):
// a carry-free pre-pass, then the carry chain either walked (short
// programs) or as an exact chunked max-plus scan over the whole card.
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
// and the miss's rank.  So the serve starts with a pre-pass:
//
//  (a) serve_prepass_kernel, fully parallel over all S x C x K lanes and
//      bound by bytes: it writes, per (channel, step), a record of K
//      lanes {x, meta'}: x = iss for a miss lane and `own` for a hit
//      lane (a lane uses only one of them), meta' = meta's low 16 bits
//      plus the block's miss flag and miss rank, the phase-boundary flag
//      and an "empty" flag (no valid lane).  Records are channel-major,
//      [C, S_pad, K], so a channel's steps are contiguous.
//
// Then one of two routes over the records, which the wrapper picks from
// the input's shape and values (kernels/dram_timing/ops.py::serve_route).
//
//  (b) The walk, for short programs and where the bound of (c) fails:
//      serve_records_kernel, one CTA of one warp per channel, lane k =
//      block lane k (serve_step).  Channels are independent between phase
//      boundaries, so the warps meet only on boundary steps, at a named
//      barrier, to take the makespan over channels (pmf values exchanged
//      through double-buffered shared words).  A warp's bank times (avail,
//      act), ACT history and pointers sit in its own shared memory, the
//      bus and phase makespan in registers; the K lanes' loops and shuffle
//      ladders unroll (K is a template parameter).  Records stream into a
//      per-warp ring of shared memory, four chunks of T steps deep, by
//      cp.async.bulk (the TMA's bulk copy) completing on an mbarrier per
//      slot; lane 0 refills a slot as soon as the warp has read it.
//      Finishes are staged in shared memory, a chunk's T steps, and stored
//      by the whole warp, coalesced, once a chunk into the [S, C, K]
//      output.  Bound in practice: the dependent chain of one step
//      (about 0.35 us) times S.
//
//  (c) The chunked route breaks that chain.  With the records fixed,
//      every choice a step makes is fixed before the chain runs (miss,
//      conflict, valid, bank, the miss's rank; a rank's ring pointer moves
//      on by one at each block with a miss on it, a count, never a time),
//      and every operation on the carry is a max or the addition of a
//      constant.  So on a channel's state vector (its banks' avail and
//      act, its ranks' ACT rings, the bus, the phase makespan, a constant
//      0 through which the records' times and every constant enter) a run
//      of steps inside a phase is one max-plus matrix.  The one operation
//      that is not, the phase end's re-base by the makespan over all
//      channels, stays in a short serial walk over the pieces.  Six
//      launches, no host synchronisation: count (phase ends and misses a
//      tile of T steps), scan (entry ring pointers, the pieces: tiles cut
//      after each phase end), transfer (a lane a basis vector walks its
//      tile over steps decoded once a CTA: invalid lanes dropped, a step's
//      hits merged a bank, giving each piece's matrix), compose (prefix
//      products in groups of G pieces, restarting after a phase end), walk
//      (one CTA a case: s <- P (x) s run by run, the re-base at each phase
//      end; each run's entry state, each shift, the carry out) and emit
//      (32 / K tiles a warp, each walked once more from its entry state by
//      serve_step, each shift from the walk).  Exact where no int32 step of
//      (b) wraps: the wrapper routes here only where a bound on the largest
//      reachable time says so.  Every kernel's name holds
//      serve_records_kernel.
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

// The timing vector and the lane constants a walk of the records uses.
struct StepTiming {
  int tCL, tRCD, tRP, tRAS, tBL, tRRD, tFAW, lane_tbl1, tcl_lane;
};

__device__ __forceinline__ StepTiming step_timing(const int* timing, int k) {
  StepTiming tm;
  tm.tCL = timing[0];
  tm.tRCD = timing[1];
  tm.tRP = timing[2];
  tm.tRAS = timing[3];
  tm.tBL = timing[4];
  tm.tRRD = timing[5];
  tm.tFAW = timing[6];
  tm.lane_tbl1 = wmul(k + 1, tm.tBL);
  tm.tcl_lane = wsub(tm.tCL, wmul(k, tm.tBL));
  return tm;
}

// One step of a channel's record walk by K lanes (lane k = block lane k):
// the bank times (avail, act), ACT history and pointers in shared memory,
// the bus and phase makespan in registers.  With `store`, this lane's
// finish goes to *out before the step's reductions (stored after them, the
// walk over the full HitGraph program took 286 ms against 258 ms on an
// H100).
// Per step the chain is: one shared load of the bank's times, a few
// integer ops, a log2(K) shuffle scan for the bus prefix max, a reduction
// for the step's makespan, and shared atomicMax on the bank (a miss also
// reads and writes the rank's ACT history).  With SEG false the warp walks
// one channel (lanes >= K replicate lane lane % K; the reduction is one
// redux.sync, and an empty block only clamps the bus and makespan at 0);
// with SEG true each K-lane segment of the warp walks its own records and
// state (the reductions are segment shuffles, and every lane runs every
// step, an empty block as a block of invalid lanes).
template <int K, bool SEG = false>
__device__ __forceinline__ void serve_step(const int2 r, const int lane,
                                           const bool writer, int* out,
                                           const bool store, const int B,
                                           const int R, const StepTiming& tm,
                                           int* s_avail, int* s_act,
                                           int* s_hist, int* s_ptr, int& bus,
                                           int& pmf) {
  const int x = r.x, mt = r.y;
  if (!SEG && (mt & REC_EMPTY)) {
    // no valid lane: every finish 0, the step's makespan 0
    if (store) *out = 0;
    bus = max(bus, 0);
    pmf = max(pmf, 0);
    return;
  }
  // ---- read phase: this step's lanes against the carry ----------------
  const int k = lane % K;
  const int b = mt & 0xFF;
  const bool ms = (mt & META_MISS) != 0;
  const bool v = (mt & META_VALID) != 0;
  const int rb_tbl = wmul((mt >> META_RB_SHIFT) & META_RB_MASK, tm.tBL);
  const bool in_b = b < B;
  const int avail_b = in_b ? s_avail[b] : NEG_INF32;
  const bool m_any = (mt & REC_M_ANY) != 0;   // uniform over the K lanes
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
    const int floor_c = max(wadd(last_r, tm.tRRD), wadd(hist_p, tm.tFAW));
    const int base = max(x, avail_b);
    const int pre =
        cf ? wadd(max(base, wadd(act_b, tm.tRAS)), tm.tRP) : base;
    a = max(pre, floor_c);
    col = ms ? wadd(a, tm.tRCD) : wadd(rb_tbl, max(x, avail_b));
  } else {
    // hits only (x is this lane's `own`); an invalid lane's col is never
    // used
    col = wadd(rb_tbl, max(x, avail_b));
  }
  // shared data bus: prefix max over the valid lanes j <= k
  int ccm = v ? wadd(col, tm.tcl_lane) : NEG_INF32;
#pragma unroll
  for (int off = 1; off < K; off <<= 1) {
    const int up = __shfl_up_sync(FULL, ccm, off, K);
    if (k >= off) ccm = max(ccm, up);
  }
  const int fin_out = v ? wadd(tm.lane_tbl1, max(bus, ccm)) : 0;
  if (store) *out = fin_out;
  int mx, a_m;
  if (SEG) {
    mx = seg_max(fin_out, K);
    a_m = seg_max(mv ? a : NEG_INF32, K);
  } else {
    // every lane >= K replicates lane (lane % K), so the max over the
    // whole warp is the max over the block's K lanes
    mx = __reduce_max_sync(FULL, fin_out);
    a_m = m_any ? __reduce_max_sync(FULL, mv ? a : NEG_INF32) : NEG_INF32;
  }
  __syncwarp();
  // ---- write phase: the carry only ever grows (max updates) -----------
  if (writer && v && in_b) atomicMax(&s_avail[b], wadd(col, tm.tBL));
  if (m_any) {
    if (writer && mv && in_b) atomicMax(&s_act[b], a);
    if (k == 0 && (SEG || lane == 0)) {
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

// The phase boundary's re-base of a channel's carry by the makespan over
// all channels, `shift`, by the lanes that walk it (lane i of `lanes`,
// after a __syncwarp over them).
__device__ __forceinline__ void rebase(const int shift, const int i0,
                                       const int lanes, const int B,
                                       const int R, int* s_avail, int* s_act,
                                       int* s_hist, int& bus, int& pmf) {
  const int lo = wadd(shift, NEG_INF32);
  for (int i = i0; i < B; i += lanes) {
    s_avail[i] = wsub(max(s_avail[i], lo), shift);
    s_act[i] = wsub(max(s_act[i], lo), shift);
  }
  for (int i = i0; i < R * 4; i += lanes)
    s_hist[i] = wsub(max(s_hist[i], lo), shift);
  bus = wsub(max(bus, lo), shift);
  pmf = 0;
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

  const int k = lane % K;
  const bool writer = lane < K;
  const StepTiming tm = step_timing(timing, k);
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
      serve_step<K>(r, lane, writer, &s_fin[i * K + k], writer, B, R, tm,
                    s_avail, s_act, s_hist, s_ptr, bus, pmf);
      // ---- phase boundary: re-base by the makespan over all channels --
      if (r.y & REC_BOUNDARY) {
        int shift = pmf;
        if (C > 1) {
          if (lane == 0) s_pmfx[par * C + c] = pmf;
          named_barrier(32 * C);
          shift = s_pmfx[par * C];
          for (int j = 1; j < C; ++j) shift = max(shift, s_pmfx[par * C + j]);
          par ^= 1;
        }
        __syncwarp();
        rebase(shift, lane, 32, B, R, s_avail, s_act, s_hist, bus, pmf);
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

// ---- (c) the chunked route: an exact chunked max-plus scan ------------

// A case's steps are cut into tiles of T steps, and each tile after every
// phase's last step into pieces; piece p of a case is its p-th such run of
// steps.  A channel's state vector, of length Dp = 2B + 4R + 4, is its
// banks' avail and act, its ranks' ACT histories (the ring in absolute
// order: the ring pointers are counts, fixed by the count and scan
// passes), the bus, the phase makespan, a constant 0 (through which the
// records' times and every constant enter) and one unused component that
// makes Dp even.  The max-plus zero of the int64 matrices is NEG; the
// transfer's int32 lanes use NEG_INF32 as theirs (widened to NEG), exact
// where the route's bound holds.
constexpr long long NEG = -(1LL << 61);
constexpr int kTile = 32;             // steps a transfer CTA stages at a time
constexpr int kCountThreads = 256;
constexpr int kComposeThreads = 512;
constexpr int kEmitWarps = 4;         // tiles an emit CTA walks

struct Chunked {
  const int2* rec;
  const int* timing;
  const int* avail_in;
  const int* act_in;
  const int* bus_in;
  const int* hist_in;
  const int* ptr_in;
  const int* pmf_in;
  int* fin;
  int* avail_out;
  int* act_out;
  int* bus_out;
  int* hist_out;
  int* ptr_out;
  int* pmf_out;
  long long S, S_pad;
  int C, K, B, R, T, G, nt, NPmax, Dp;
  int* nb;              // [M][nt] phase ends in the tile
  int* lastb;           // [M][nt] the tile's last step ends a phase
  int* miss;            // [M][nt][C][R] blocks with a miss, by rank
  int* ptr_entry;       // [M][nt][C][R] ring pointers on entry
  int* pbase;           // [M][nt] the tile's first piece
  int* np;              // [M] pieces
  int* ends;            // [M][NPmax] the piece ends a phase
  int* runs;            // [M][NPmax] the carry walk's run ends
  long long* mat;       // [M][C][NPmax][Dp][Dp] row-major; prefix products
  long long* entry;     // [M][C][NPmax][Dp] each run's entry state
  long long* shift;     // [M][NPmax] each phase's re-base
};

__device__ __forceinline__ long long widen(int v) {
  return v < -(1 << 29) ? NEG : static_cast<long long>(v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Exclusive scan under `op` (identity `id`) of get(k), k in [0, n), by
// the whole block (blockDim.x a multiple of 32); put(k, prefix) for each
// k.  Returns the reduction of all n.  `sums` is 32 words of shared memory.
template <class Get, class Put, class Op>
__device__ long long block_scan(int n, long long id, Get get, Put put, Op op,
                                long long* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  long long x = id;
  for (int k = lo; k < hi; ++k) x = op(x, get(k));
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = op(x, y);
  }
  long long ex = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < nwarps ? sums[lane] : id;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v = op(v, y);
    }
    sums[lane] = v;
  }
  __syncthreads();
  long long run = op(warp ? sums[warp - 1] : id, ex);
  const long long total = sums[nwarps - 1];
  for (int k = lo; k < hi; ++k) {
    put(k, run);
    run = op(run, get(k));
  }
  __syncthreads();
  return total;
}

// 1. count, one CTA a (tile, case): the tile's phase ends (from channel
// 0's records; every channel's are the same) and each (channel, rank)'s
// blocks with a miss, read from lane 0's meta'.
__global__ void __launch_bounds__(kCountThreads)
    serve_records_kernel_count(Chunked P) {
  extern __shared__ int s_cnt[];   // [C * R] misses, phase ends, last
  const int t = blockIdx.x, m = blockIdx.y, tid = threadIdx.x;
  const int CR = P.C * P.R;
  for (int i = tid; i < CR + 2; i += blockDim.x) s_cnt[i] = 0;
  __syncthreads();
  const long long s0 = static_cast<long long>(t) * P.T;
  const int n = static_cast<int>(min(static_cast<long long>(P.T), P.S - s0));
  for (int i = tid; i < n; i += blockDim.x) {
    for (int c = 0; c < P.C; ++c) {
      const int mt =
          P.rec[((static_cast<long long>(m) * P.C + c) * P.S_pad + s0 + i) *
                P.K]
              .y;
      if (c == 0 && (mt & REC_BOUNDARY)) {
        atomicAdd(&s_cnt[CR], 1);
        if (i == n - 1) s_cnt[CR + 1] = 1;
      }
      if (mt & REC_M_ANY) {
        const int rk = P.R == 1 ? 0 : (mt >> REC_RANK_SHIFT) & 0xFF;
        if (rk < P.R) atomicAdd(&s_cnt[c * P.R + rk], 1);
      }
    }
  }
  __syncthreads();
  const long long tix = static_cast<long long>(m) * P.nt + t;
  for (int i = tid; i < CR; i += blockDim.x) P.miss[tix * CR + i] = s_cnt[i];
  if (tid == 0) {
    P.nb[tix] = s_cnt[CR];
    P.lastb[tix] = s_cnt[CR + 1];
  }
}

// 2. scan, one CTA a case: each tile's entry ring pointers (the carry's
// pointer plus the misses before it, mod 4) and first piece; the carry's
// pointers out and the case's pieces.
__global__ void __launch_bounds__(1024) serve_records_kernel_scan(Chunked P) {
  __shared__ long long sums[32];
  const int m = blockIdx.x, CR = P.C * P.R, nt = P.nt;
  const long long base = static_cast<long long>(m) * nt;
  auto add = [](long long a, long long b) { return a + b; };
  for (int cr = 0; cr < CR; ++cr) {
    const int p0 = P.ptr_in[m * CR + cr];
    const long long total = block_scan(
        nt, 0LL,
        [&](int t) {
          return static_cast<long long>(P.miss[(base + t) * CR + cr]);
        },
        [&](int t, long long x) {
          P.ptr_entry[(base + t) * CR + cr] = static_cast<int>((p0 + x) & 3);
        },
        add, sums);
    if (threadIdx.x == 0)
      P.ptr_out[m * CR + cr] = static_cast<int>((p0 + total) & 3);
  }
  const long long np = block_scan(
      nt, 0LL,
      [&](int t) {
        return static_cast<long long>(P.nb[base + t] +
                                      (P.lastb[base + t] ? 0 : 1));
      },
      [&](int t, long long x) { P.pbase[base + t] = static_cast<int>(x); },
      add, sums);
  if (threadIdx.x == 0) P.np[m] = static_cast<int>(np);
}

// A step as the transfer reads it, decoded once for all lanes: its
// entries, then per step (info) lane 0's meta', (kv + 1) tBL for kv its
// last valid lane, the entry count and flags, and the constant part of its
// makespan.  Invalid lanes make no entry.  The valid lanes whose column is
// a hit's (rb tBL + max(x, avail)) merge into one entry a bank: its avail
// becomes max(av, av + R_b, A_b) and it adds av + Q_b to the makespan,
// R_b, Q_b the max over its lanes j of (rb_j + 1) tBL and rb_j tBL + e_j
// (e_j = tCL + (kv + 1 - j) tBL, lane j's share of the makespan), A_b and
// the step's constant the max of rb_j tBL + x_j + tBL and rb_j tBL + x_j +
// e_j (the constant lane's).  A valid miss lane is an entry of its own.
// An entry's first word is the offset of its bank's avail row (a row of
// NEG_INF32 past the channel's banks) with its flags in the low bits
// (offsets are multiples of the 32-lane stride); its second the row its
// updates go to (a trash row past the channel's banks).
constexpr int F_HITB = 1;    // a bank's hit lanes: {ro, wo, R_b, Q_b}, A_b
constexpr int F_MISSE = 2;   // a miss lane: {ro, wo, x, e}
constexpr int F_CF = 4;      // the miss is a conflict
constexpr int F_INB = 8;     // the miss's bank is the channel's

// 3. transfer, one CTA a (tile, channel, case) of Dp lanes: lane j walks
// the tile from the basis vector e_j, the bank times and histories in
// shared memory (component-major, so the lanes' accesses never conflict),
// the bus and makespan in registers.  Every selection comes from the
// records, the same for every lane, so the lanes never diverge; each
// constant enters through the constant-0 lane (z0 below).  The records
// stream in by cp.async, double-buffered, and the first kTile threads
// decode a stage's steps (above), a thread a step.  A step's makespan
// needs no prefix scan: with kv its last valid lane, it is the max of bus
// + (kv + 1) tBL, each valid lane j's col_j + e_j and, where a lane is
// invalid, 0.  At each phase's last step, and at the tile's end, lane j
// stores column j of the piece's matrix and starts again from e_j.
template <int K>
__global__ void __launch_bounds__(64) serve_records_kernel_transfer(
    Chunked P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.x, c = blockIdx.y, m = blockIdx.z;
  const int DL = blockDim.x, lane = threadIdx.x;
  const int B = P.B, R = P.R, C = P.C, Dp = P.Dp;
  const int HI = 2 * B, NH = 2 * B + 4 * R;
  const int BUS = NH, PMF = NH + 1, Z = NH + 2, DUM = NH + 3;
  const int NEGROW = NH, TRASH = NH + 1;
  int2* stage = reinterpret_cast<int2*>(smem);                 // [2][kTile*K]
  int4* dec = reinterpret_cast<int4*>(stage + 2 * kTile * K);  // [kTile*K]
  int4* info = dec + kTile * K;                                // [kTile]
  int* hitA = reinterpret_cast<int*>(info + kTile);            // [kTile*K]
  int* st = hitA + kTile * K;                                  // [NH+2][DL]
  int* pp = st + (NH + 2) * DL;                                // [R][DL]
  const long long s0 = static_cast<long long>(t) * P.T;
  const int n = static_cast<int>(min(static_cast<long long>(P.T), P.S - s0));
  const long long tix = static_cast<long long>(m) * P.nt + t;
  const int2* src =
      P.rec + ((static_cast<long long>(m) * C + c) * P.S_pad + s0) * K;
  const int* tmv = P.timing + m * 7;
  const int tCL = tmv[0], tRCD = tmv[1], tRP = tmv[2], tRAS = tmv[3];
  const int tBL = tmv[4], tRRD = tmv[5], tFAW = tmv[6];
  const int BDL = B * DL;
  const bool zl = lane == Z;
  const int z0 = zl ? 0 : NEG_INF32;
  int bus = 0, pmf = 0;
  auto basis = [&]() {
    for (int i = 0; i < NH; ++i) st[i * DL + lane] = i == lane ? 0 : NEG_INF32;
    bus = lane == BUS ? 0 : NEG_INF32;
    pmf = lane == PMF ? 0 : NEG_INF32;
  };
  basis();
  st[NEGROW * DL + lane] = NEG_INF32;
  for (int r = 0; r < R; ++r)
    pp[r * DL + lane] = P.ptr_entry[(tix * C + c) * R + r];
  long long piece = P.pbase[tix];
  long long* mats = P.mat + (static_cast<long long>(m) * C + c) * P.NPmax *
                                static_cast<long long>(Dp) * Dp;
  auto store = [&](bool phase_end) {
    if (piece < P.NPmax) {
      if (lane < Dp) {
        long long* col = mats + piece * Dp * Dp + lane;   // column `lane`
        for (int i = 0; i < NH; ++i)
          col[static_cast<long long>(i) * Dp] = widen(st[i * DL + lane]);
        col[static_cast<long long>(BUS) * Dp] = widen(bus);
        col[static_cast<long long>(PMF) * Dp] = widen(pmf);
        col[static_cast<long long>(Z) * Dp] = zl ? 0 : NEG;
        col[static_cast<long long>(DUM) * Dp] = lane == DUM ? 0 : NEG;
      }
      if (c == 0 && lane == 0) P.ends[m * static_cast<long long>(P.NPmax) +
                                      piece] = phase_end;
    }
    ++piece;
  };
  // records exist up to S_pad; a stage copies whole 16-byte units (S_pad,
  // T and kTile are even)
  auto fetch = [&](int i0, int buf) {
    if (i0 < n) {
      const int steps =
          static_cast<int>(min(static_cast<long long>(kTile), P.S_pad - s0 - i0));
      const int2* from = src + static_cast<long long>(i0) * K;
      int2* to = stage + buf * kTile * K;
      for (int u = lane; u < steps * K / 2; u += DL)
        cp_async16(to + 2 * u, from + 2 * u);
    }
    cp_async_commit();
  };
  fetch(0, 0);
  bool open = false;
  for (int i0 = 0, buf = 0; i0 < n; i0 += kTile, buf ^= 1) {
    fetch(i0 + kTile, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();
    const int steps = min(kTile, n - i0);
    if (lane < steps) {
      const int2* r = stage + buf * kTile * K + lane * K;
      int4* d = dec + lane * K;
      int* da = hitA + lane * K;
      int kv = -1, invalid = 0;
      for (int k = 0; k < K; ++k) {
        const bool v = (r[k].y & META_VALID) != 0;
        kv = v ? k : kv;
        invalid |= !v;
      }
      int ne = 0, zmx = NEG_INF32;
      for (int k = 0; k < K; ++k) {
        const int mt = r[k].y, x = r[k].x;
        if (!(mt & META_VALID)) continue;
        const int b = mt & 0xFF;
        const bool in_b = b < B;
        const int ro = (in_b ? b : NEGROW) * DL, wo = (in_b ? b : TRASH) * DL;
        const int e = tCL + (kv + 1 - k) * tBL;
        if ((mt & REC_M_ANY) && (mt & META_MISS)) {
          const int fl = F_MISSE | ((mt & META_CONFL) ? F_CF : 0) |
                         (in_b ? F_INB : 0);
          d[ne++] = make_int4(ro | fl, wo, x, e);
          continue;
        }
        const int rbt = ((mt >> META_RB_SHIFT) & META_RB_MASK) * tBL;
        zmx = max(zmx, x + rbt + e);
        int f = 0;
        while (f < ne && d[f].x != (ro | F_HITB)) ++f;
        if (f == ne) {
          d[ne++] = make_int4(ro | F_HITB, wo, rbt + tBL, rbt + e);
          da[f] = x + rbt + tBL;
        } else {
          d[f].z = max(d[f].z, rbt + tBL);
          d[f].w = max(d[f].w, rbt + e);
          da[f] = max(da[f], x + rbt + tBL);
        }
      }
      info[lane] = make_int4(r[0].y, (kv + 1) * tBL,
                             (ne << 2) | (kv >= 0 ? 2 : 0) | invalid, zmx);
    }
    __syncthreads();
    for (int i = 0; i < steps; ++i) {
      const int4 in = info[i];
      const int mt0 = in.x;
      if (lane < Dp) {
        if (mt0 & REC_EMPTY) {
          bus = max(bus, z0);
          pmf = max(pmf, z0);
        } else {
          const bool m_any = (mt0 & REC_M_ANY) != 0;
          const int rk = R == 1 ? 0 : (mt0 >> REC_RANK_SHIFT) & 0xFF;
          const bool moves = m_any && rk < R;
          int floor_c = NEG_INF32, pm = 0;
          if (moves) {
            pm = pp[rk * DL + lane];
            const int hp = st[(HI + 4 * rk + pm) * DL + lane];
            const int hl = st[(HI + 4 * rk + ((pm + 3) & 3)) * DL + lane];
            floor_c = max(hl + tRRD, hp + tFAW);
          }
          const int ne = in.z >> 2;
          const int4* d = dec + i * K;
          const int* da = hitA + i * K;
          int upd[K], act[K];
          int mx = zl ? in.w : NEG_INF32;
#pragma unroll
          for (int e = 0; e < K; ++e) {
            if (e >= ne) break;
            const int4 de = d[e];
            const int av = st[(de.x & ~31) + lane];
            if (de.x & F_HITB) {
              mx = max(mx, av + de.w);
              const int nv = max(av, av + de.z);
              upd[e] = zl ? max(nv, da[e]) : nv;
            } else {
              const int base = max(zl ? de.z : NEG_INF32, av);
              const int at =
                  (de.x & F_INB) ? st[de.y + BDL + lane] : NEG_INF32;
              const int pre =
                  (de.x & F_CF) ? max(base, at + tRAS) + tRP : base;
              const int ak = max(pre, floor_c);
              const int cl = ak + tRCD;
              mx = max(mx, cl + de.w);
              upd[e] = cl + tBL;
              act[e] = ak;
            }
          }
          if (in.z & 2) mx = max(mx, bus + in.y);
          if (in.z & 1) mx = max(mx, z0);
          int a_m = NEG_INF32;
#pragma unroll
          for (int e = 0; e < K; ++e) {
            if (e >= ne) break;
            const int4 de = d[e];
            int* q = &st[de.y + lane];
            *q = max(*q, upd[e]);
            if (de.x & F_MISSE) {
              a_m = max(a_m, act[e]);
              if (de.x & F_INB) {
                q = &st[de.y + BDL + lane];
                *q = max(*q, act[e]);
              }
            }
          }
          if (moves) {
            int* h = &st[(HI + 4 * rk + pm) * DL + lane];
            *h = max(*h, a_m);
            pp[rk * DL + lane] = (pm + 1) & 3;
          }
          bus = max(bus, mx);
          pmf = max(pmf, mx);
        }
      }
      open = (mt0 & REC_BOUNDARY) == 0;
      if (!open) {
        store(true);
        if (lane < Dp) basis();
      }
    }
    __syncthreads();   // before the next stage lands and is decoded
  }
  if (open) store(false);
}

// Entries (i0..i0+1, j0..j0+1) of the max-plus product a (x) b of two
// row-major D x D matrices (D even), each at least NEG so that the zero
// never drifts down through a group's products.
__device__ __forceinline__ void product_block(const long long* a,
                                              const long long* b, int D,
                                              int i0, int j0, long long* q) {
  long long q00 = NEG, q01 = NEG, q10 = NEG, q11 = NEG;
  const long long* a0 = a + i0 * D;
  const long long* a1 = a0 + D;
  for (int l = 0; l < D; ++l) {
    const longlong2 bv = *reinterpret_cast<const longlong2*>(b + l * D + j0);
    const long long x0 = a0[l], x1 = a1[l];
    q00 = max(q00, x0 + bv.x);
    q01 = max(q01, x0 + bv.y);
    q10 = max(q10, x1 + bv.x);
    q11 = max(q11, x1 + bv.y);
  }
  q[i0 * D + j0] = q00;
  q[i0 * D + j0 + 1] = q01;
  q[(i0 + 1) * D + j0] = q10;
  q[(i0 + 1) * D + j0 + 1] = q11;
}

// 4. compose, one CTA a (group of G pieces, channel, case): the prefix
// products P_k = M_k (x) P_{k-1} within each run (a run restarts after a
// phase's last piece), each written over M_k; the next piece's matrix
// streams in (cp.async) while the CTA multiplies.
__global__ void __launch_bounds__(kComposeThreads)
    serve_records_kernel_compose(Chunked P) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = P.Dp, DD = Dp * Dp;
  long long* pm = reinterpret_cast<long long*>(smem);   // [DD] prefix
  long long* qm = pm + DD;                              // [DD] product
  long long* mb = qm + DD;                              // [2][DD] M_k
  const int g = blockIdx.x, c = blockIdx.y, m = blockIdx.z, t = threadIdx.x;
  const int k0 = g * P.G, k1 = min(P.np[m], k0 + P.G);
  if (k0 >= k1) return;
  long long* M =
      P.mat + (static_cast<long long>(m) * P.C + c) * P.NPmax *
                  static_cast<long long>(DD);
  const int* ends = P.ends + static_cast<long long>(m) * P.NPmax;
  auto fetch = [&](int k) {
    if (k < k1) {
      long long* dst = mb + (k & 1) * DD;
      const long long* src = M + static_cast<long long>(k) * DD;
      for (int u = t; u < DD / 2; u += blockDim.x)
        cp_async16(dst + 2 * u, src + 2 * u);
    }
    cp_async_commit();
  };
  fetch(k0 + 1);
  for (int x = t; x < DD; x += blockDim.x)
    pm[x] = M[static_cast<long long>(k0) * DD + x];
  for (int k = k0 + 1; k < k1; ++k) {
    fetch(k + 1);
    cp_async_wait<1>();   // M_k has landed
    __syncthreads();
    const long long* mm = mb + (k & 1) * DD;
    if (ends[k - 1]) {
      // a run starts at k: M_k is its own prefix
      for (int x = t; x < DD; x += blockDim.x) pm[x] = mm[x];
    } else {
      const int half = Dp / 2;
      for (int x = t; x < half * half; x += blockDim.x) {
        const int ib = x / half;
        product_block(mm, pm, Dp, 2 * ib, 2 * (x - ib * half), qm);
      }
      __syncthreads();
      long long* mk = M + static_cast<long long>(k) * DD;
      for (int x = t; x < DD; x += blockDim.x) {
        pm[x] = qm[x];
        mk[x] = qm[x];
      }
    }
    __syncthreads();   // before M_{k+2} lands over M_k
  }
  cp_async_wait<0>();
}

// 5. walk, one CTA a case, the only serial pass: the case's runs (a run
// ends at a phase's last piece or a group's last) in order, s <- P (x) s
// for every channel at once (Q threads a row, combined by shuffles), the
// next run's products streaming into a ring of RING slots by cp.async; at
// a phase's end the shift, the makespan over the channels, and the
// re-base.  Writes each run's entry state, each phase's shift and the
// carry out.
template <int RING>
__global__ void __launch_bounds__(1024) serve_records_kernel_walk(Chunked P,
                                                                  int Q) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long sums[32];
  const int m = blockIdx.x, tid = threadIdx.x;
  const int C = P.C, B = P.B, R = P.R, Dp = P.Dp, DD = Dp * Dp, G = P.G;
  const int HI = 2 * B, BUS = HI + 4 * R, PMF = BUS + 1, Z = BUS + 2;
  const int CD = C * Dp;
  long long* ring = reinterpret_cast<long long*>(smem);      // [RING][C*DD]
  long long* s = ring + static_cast<long long>(RING) * C * DD;   // [2][CD]
  const int np = P.np[m];
  const long long NPmax = P.NPmax;
  const int* ends = P.ends + m * NPmax;
  int* runs = P.runs + m * NPmax;
  auto run_end = [&](int p) {
    return ends[p] != 0 || (p + 1) % G == 0 || p == np - 1;
  };
  const long long nr = block_scan(
      np, 0LL, [&](int p) { return static_cast<long long>(run_end(p)); },
      [&](int p, long long x) {
        if (run_end(p)) runs[x] = p;
      },
      [](long long a, long long b) { return a + b; }, sums);
  for (int x = tid; x < CD; x += blockDim.x) {
    const int c = x / Dp, i = x % Dp;
    const long long mc = static_cast<long long>(m) * C + c;
    long long v = NEG;
    if (i < B) v = P.avail_in[mc * B + i];
    else if (i < HI) v = P.act_in[mc * B + i - B];
    else if (i < BUS) v = P.hist_in[mc * R * 4 + i - HI];
    else if (i == BUS) v = P.bus_in[mc];
    else if (i == PMF) v = P.pmf_in[mc];
    else if (i == Z) v = 0;
    s[x] = v;
  }
  const long long* mats = P.mat + static_cast<long long>(m) * C * NPmax * DD;
  long long* entry = P.entry + static_cast<long long>(m) * C * NPmax * Dp;
  auto fetch = [&](long long r) {
    if (r < nr) {
      const long long p = runs[r];
      long long* dst = ring + (r % RING) * C * DD;
      for (int c = 0; c < C; ++c) {
        const long long* src = mats + (c * NPmax + p) * DD;
        for (int u = tid; u < DD / 2; u += blockDim.x)
          cp_async16(dst + c * DD + 2 * u, src + 2 * u);
      }
    }
    cp_async_commit();
  };
  for (int r = 0; r < RING - 1; ++r) fetch(r);
  const int row = tid / Q, q = tid % Q;   // row = c * Dp + i
  int cur = 0;
  long long first = 0;
  for (long long r = 0; r < nr; ++r) {
    fetch(r + RING - 1);
    cp_async_wait<RING - 1>();   // run r's products have landed
    __syncthreads();
    const long long pe = runs[r];
    long long* sc = s + cur * CD;
    long long* sn = s + (cur ^ 1) * CD;
    for (int x = tid; x < CD; x += blockDim.x)
      entry[((x / Dp) * NPmax + first) * Dp + x % Dp] = sc[x];
    long long acc = NEG;
    if (row < CD) {
      const int c = row / Dp, i = row % Dp;
      const long long* mr = ring + (r % RING) * C * DD + c * DD + i * Dp;
      const long long* sv = sc + c * Dp;
      for (int j = q; j < Dp; j += Q) acc = max(acc, mr[j] + sv[j]);
    }
    for (int o = 1; o < Q; o <<= 1)
      acc = max(acc, __shfl_xor_sync(FULL, acc, o));
    if (q == 0 && row < CD) sn[row] = acc;
    __syncthreads();
    if (ends[pe]) {
      long long sh = NEG;
      for (int c = 0; c < C; ++c) sh = max(sh, sn[c * Dp + PMF]);
      __syncthreads();
      for (int x = tid; x < CD; x += blockDim.x) {
        const int i = x % Dp;
        if (i < PMF) sn[x] = max(sn[x], sh + NEG_INF32) - sh;
        else if (i == PMF) sn[x] = 0;
      }
      if (tid == 0) P.shift[m * NPmax + pe] = sh;
      __syncthreads();
    }
    cur ^= 1;
    first = pe + 1;
  }
  cp_async_wait<0>();
  const long long* fs = s + cur * CD;
  for (int x = tid; x < CD; x += blockDim.x) {
    const int c = x / Dp, i = x % Dp;
    const long long mc = static_cast<long long>(m) * C + c;
    const int v = static_cast<int>(fs[x]);
    if (i < B) P.avail_out[mc * B + i] = v;
    else if (i < HI) P.act_out[mc * B + i - B] = v;
    else if (i < BUS) P.hist_out[mc * R * 4 + i - HI] = v;
    else if (i == BUS) P.bus_out[mc] = v;
    else if (i == PMF) P.pmf_out[mc] = v;
  }
}

// 6. emit, 32 / K tiles of a (channel, case) a warp, one K-lane segment
// a tile, kEmitWarps warps a CTA: the tiles' entry states (each its run's
// entry state times the prefix product before it, by the whole warp),
// then each segment walks its tile once more in int32 by the record
// walk's own step (serve_step with SEG), each phase's shift taken from the
// walk.  Every lane runs the warp's longest tile; a segment past its own
// steps runs blocks of invalid lanes and writes nothing.  Each lane's
// record is read two steps ahead.
template <int K>
__global__ void __launch_bounds__(32 * kEmitWarps)
    serve_records_kernel_emit(Chunked P) {
  constexpr int W = 32 / K;
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg = lane / K, k = lane % K;
  const int tw = (blockIdx.x * kEmitWarps + w) * W;   // the warp's 1st tile
  const int c = blockIdx.y, m = blockIdx.z;
  if (tw >= P.nt) return;
  const int B = P.B, R = P.R, C = P.C, Dp = P.Dp, G = P.G;
  const int HI = 2 * B, BUS = HI + 4 * R, PMF = BUS + 1;
  const int words = (2 * Dp + 2 * B + 5 * R + 3) & ~3;   // 16-byte slices
  const long long NPmax = P.NPmax;
  const long long mc = static_cast<long long>(m) * C + c;
  const int* ends = P.ends + m * NPmax;
  auto slice = [&](int sg) {
    return reinterpret_cast<int*>(smem) + (w * W + sg) * words;
  };
  // the entry states, a row a lane
  for (int sg = 0; sg < W && tw + sg < P.nt; ++sg) {
    const int p0 = P.pbase[static_cast<long long>(m) * P.nt + tw + sg];
    int rs = p0;
    while (rs % G != 0 && !ends[rs - 1]) --rs;
    const long long* er = P.entry + (mc * NPmax + rs) * Dp;
    long long* e = reinterpret_cast<long long*>(slice(sg));
    const long long* pr =
        P.mat + (mc * NPmax + p0 - 1) * static_cast<long long>(Dp) * Dp;
    for (int i = lane; i < Dp; i += 32) {
      long long acc = NEG;
      if (rs == p0) {
        acc = er[i];
      } else {
        for (int j = 0; j < Dp; ++j)
          acc = max(acc, pr[static_cast<long long>(i) * Dp + j] + er[j]);
      }
      e[i] = acc;
    }
  }
  __syncwarp();
  const int t = tw + seg;
  const bool on = t < P.nt;
  int* mine = slice(seg);
  const long long* e = reinterpret_cast<const long long*>(mine);
  int* s_avail = mine + 2 * Dp;
  int* s_act = s_avail + B;
  int* s_hist = s_act + B;
  int* s_ptr = s_hist + 4 * R;
  const long long tix = static_cast<long long>(m) * P.nt + (on ? t : tw);
  const long long s0 = static_cast<long long>(on ? t : tw) * P.T;
  const int n =
      on ? static_cast<int>(min(static_cast<long long>(P.T), P.S - s0)) : 0;
  int bus = 0, pmf = 0;
  if (on) {
    for (int i = k; i < B; i += K) {
      s_avail[i] = static_cast<int>(e[i]);
      s_act[i] = static_cast<int>(e[B + i]);
    }
    for (int i = k; i < 4 * R; i += K) s_hist[i] = static_cast<int>(e[HI + i]);
    for (int i = k; i < R; i += K)
      s_ptr[i] = P.ptr_entry[(tix * C + c) * R + i];
    bus = static_cast<int>(e[BUS]);
    pmf = static_cast<int>(e[PMF]);
  }
  const int steps = __reduce_max_sync(FULL, n);
  __syncwarp();
  const StepTiming tm = step_timing(P.timing + m * 7, k);
  const unsigned seg_mask =
      (K == 32 ? FULL : ((1u << (K & 31)) - 1u)) << (seg * K % 32);
  const int2* src = P.rec + (mc * P.S_pad + s0) * K + k;
  const long long fstride = static_cast<long long>(C) * K;
  int* fout = P.fin + ((static_cast<long long>(m) * P.S + s0) * C + c) * K + k;
  const long long* shifts = P.shift + m * NPmax;
  long long piece = on ? P.pbase[tix] : 0;
  const int2 none = make_int2(0, 0);   // a block of invalid lanes
  int2 r1 = n > 0 ? src[0] : none, r2 = n > 1 ? src[K] : none;
  for (int i = 0; i < steps; ++i) {
    const int2 r = r1;
    r1 = r2;
    r2 = i + 2 < n ? src[static_cast<long long>(i + 2) * K] : none;
    serve_step<K, true>(r, lane, true, fout + i * fstride, i < n, B, R, tm,
                        s_avail, s_act, s_hist, s_ptr, bus, pmf);
    if (i < n) {
      if (r.y & REC_BOUNDARY) {
        __syncwarp(seg_mask);
        rebase(static_cast<int>(shifts[piece++]), k, K, B, R, s_avail,
               s_act, s_hist, bus, pmf);
      }
    }
    __syncwarp();
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

// ---- the chunked route's launch ----------------------------------------

constexpr int kWorkArrays = 11;

int round32(int x) { return (x + 31) / 32 * 32; }

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The workspace's arrays (Chunked's, in order) and their offsets.
size_t work_layout(long long nt, long long NPmax, int C, int R, int Dp,
                   int M, size_t* offs) {
  const long long tiles = M * nt, pieces = M * NPmax;
  const size_t sizes[kWorkArrays] = {
      sizeof(int) * tiles,                    // nb
      sizeof(int) * tiles,                    // lastb
      sizeof(int) * tiles * C * R,            // miss
      sizeof(int) * tiles * C * R,            // ptr_entry
      sizeof(int) * tiles,                    // pbase
      sizeof(int) * M,                        // np
      sizeof(int) * pieces,                   // ends
      sizeof(int) * pieces,                   // runs
      sizeof(long long) * pieces * C * Dp * Dp,   // mat
      sizeof(long long) * pieces * C * Dp,        // entry
      sizeof(long long) * pieces};                // shift
  size_t total = 0;
  for (int i = 0; i < kWorkArrays; ++i) {
    if (offs) offs[i] = total;
    total += align_up(sizes[i]);
  }
  return total;
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// the walk keeps a second run's products in flight where they fit
constexpr size_t kWalkSmem = 200 * 1024;

template <int K>
int run_chunked(Chunked P, int M, float* pass_ms, cudaStream_t stream) {
  const int C = P.C, B = P.B, R = P.R, Dp = P.Dp;
  const int DL = round32(Dp), NH = 2 * B + 4 * R;
  const size_t DD = static_cast<size_t>(Dp) * Dp;
  const size_t sm_count = sizeof(int) * (C * R + 2);
  const size_t sm_transfer = sizeof(int2) * 2 * kTile * K +
                             sizeof(int4) * (kTile * K + kTile) +
                             sizeof(int) * (kTile * K + (NH + 2 + R) * DL);
  const size_t sm_compose = sizeof(long long) * 4 * DD;
  const int CD = C * Dp;
  const int Q = CD * 4 <= 1024 ? 4 : (CD * 2 <= 1024 ? 2 : 1);
  const auto sm_walk_for = [&](int ring) {
    return sizeof(long long) * (ring * C * DD + 2 * CD);
  };
  const bool deep = sm_walk_for(2) <= kWalkSmem;
  const size_t sm_walk = sm_walk_for(deep ? 2 : 1);
  const void* walk =
      deep ? reinterpret_cast<const void*>(serve_records_kernel_walk<2>)
           : reinterpret_cast<const void*>(serve_records_kernel_walk<1>);
  const size_t sm_emit = sizeof(int) * kEmitWarps * (32 / K) *
                         ((2 * Dp + 2 * B + 5 * R + 3) & ~3);
  cudaError_t e;
  if ((e = allow_smem(reinterpret_cast<const void*>(
                          serve_records_kernel_transfer<K>),
                      sm_transfer)) != cudaSuccess ||
      (e = allow_smem(
           reinterpret_cast<const void*>(serve_records_kernel_compose),
           sm_compose)) != cudaSuccess ||
      (e = allow_smem(walk, sm_walk)) != cudaSuccess ||
      (e = allow_smem(
           reinterpret_cast<const void*>(serve_records_kernel_emit<K>),
           sm_emit)) != cudaSuccess)
    return static_cast<int>(e);
  constexpr int N_LAUNCHES = 6;
  cudaEvent_t ev[N_LAUNCHES + 1];
  if (pass_ms)
    for (int i = 0; i <= N_LAUNCHES; ++i) cudaEventCreate(&ev[i]);
  auto mark = [&](int i) {
    if (pass_ms) cudaEventRecord(ev[i], stream);
  };
  const unsigned nt = static_cast<unsigned>(P.nt);
  const unsigned groups = static_cast<unsigned>((P.NPmax + P.G - 1) / P.G);
  mark(0);
  serve_records_kernel_count<<<dim3(nt, M), kCountThreads, sm_count,
                               stream>>>(P);
  mark(1);
  serve_records_kernel_scan<<<M, 1024, 0, stream>>>(P);
  mark(2);
  serve_records_kernel_transfer<K><<<dim3(nt, C, M), DL, sm_transfer,
                                     stream>>>(P);
  mark(3);
  serve_records_kernel_compose<<<dim3(groups, C, M), kComposeThreads,
                                 sm_compose, stream>>>(P);
  mark(4);
  const int walk_threads = round32(CD * Q);
  if (deep)
    serve_records_kernel_walk<2><<<M, walk_threads, sm_walk, stream>>>(P, Q);
  else
    serve_records_kernel_walk<1><<<M, walk_threads, sm_walk, stream>>>(P, Q);
  mark(5);
  const unsigned emit_tiles = kEmitWarps * (32 / K);
  serve_records_kernel_emit<K><<<dim3((nt + emit_tiles - 1) / emit_tiles, C,
                                      M),
                                 32 * kEmitWarps, sm_emit, stream>>>(P);
  mark(6);
  e = cudaGetLastError();
  if (pass_ms) {
    cudaEventSynchronize(ev[N_LAUNCHES]);
    for (int i = 0; i < N_LAUNCHES; ++i)
      cudaEventElapsedTime(pass_ms + i, ev[i], ev[i + 1]);
    for (int i = 0; i <= N_LAUNCHES; ++i) cudaEventDestroy(ev[i]);
  }
  return static_cast<int>(e);
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

// The chunked route's pieces of a case: tiles of T steps over S, each cut
// once more after each of at most nb_max phase ends.
static long long chunked_pieces(long long S, int T, long long nb_max) {
  return (S + T - 1) / T + nb_max;
}

static int state_width(int B, int R) { return 2 * B + 4 * R + 4; }

// Bytes of the workspace repro_dram_serve_chunked takes for M cases of S
// steps (tiles of T, at most nb_max phase ends a case); -1 for shapes it
// does not take.
extern "C" long long repro_dram_serve_chunked_bytes(long long S, int C, int B,
                                                    int R, int M, int T,
                                                    long long nb_max) {
  if (S < 1 || T < 1 || M < 1 || nb_max < 0) return -1;
  return static_cast<long long>(work_layout(
      (S + T - 1) / T, chunked_pieces(S, T, nb_max), C, R, state_width(B, R),
      M, nullptr));
}

// The serve of M cases by the chunked route, over the records of
// repro_dram_serve_prepass_batch (S_pad even) and as repro_dram_serve_batch
// takes its other arguments: tiles of T steps (a multiple of 32, at most
// 4096), the carry walk composing groups of G pieces (1 to 64), at most
// nb_max phase ends in a case's S steps, `work` the workspace
// (repro_dram_serve_chunked_bytes, uninitialised).  Exact where no int32
// step of the record walk wraps: the caller checks a bound on that.
// Takes Dp = 2B + 4R + 4 <= 64 and C * Dp <= 1024.  When `pass_ms` is not
// null, the six launches (count, scan, transfer, compose, walk, emit) are
// timed with CUDA events and their milliseconds written there (float[6])
// after a synchronisation.
extern "C" int repro_dram_serve_chunked(
    const void* rec, const void* timing, const void* avail_in,
    const void* act_in, const void* bus_in, const void* hist_in,
    const void* ptr_in, const void* pmf_in, void* fin, void* avail_out,
    void* act_out, void* bus_out, void* hist_out, void* ptr_out,
    void* pmf_out, long long S, long long S_pad, int C, int K, int B, int R,
    int M, int T, int G, long long nb_max, void* work, void* pass_ms,
    void* stream) {
  const int Dp = state_width(B, R);
  if (S < 1 || S_pad < S || S_pad % 2 || C < 1 || C > 32 || R < 1 ||
      B % R || M < 1 || M > 65535 || T < kTile || T > 4096 || T % kTile ||
      G < 1 || G > 64 || nb_max < 0 || Dp > 64 || C * Dp > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long nt = (S + T - 1) / T, NPmax = chunked_pieces(S, T, nb_max);
  if (NPmax > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  size_t offs[kWorkArrays];
  work_layout(nt, NPmax, C, R, Dp, M, offs);
  char* ws = static_cast<char*>(work);
  Chunked P;
  P.rec = static_cast<const int2*>(rec);
  P.timing = static_cast<const int*>(timing);
  P.avail_in = static_cast<const int*>(avail_in);
  P.act_in = static_cast<const int*>(act_in);
  P.bus_in = static_cast<const int*>(bus_in);
  P.hist_in = static_cast<const int*>(hist_in);
  P.ptr_in = static_cast<const int*>(ptr_in);
  P.pmf_in = static_cast<const int*>(pmf_in);
  P.fin = static_cast<int*>(fin);
  P.avail_out = static_cast<int*>(avail_out);
  P.act_out = static_cast<int*>(act_out);
  P.bus_out = static_cast<int*>(bus_out);
  P.hist_out = static_cast<int*>(hist_out);
  P.ptr_out = static_cast<int*>(ptr_out);
  P.pmf_out = static_cast<int*>(pmf_out);
  P.S = S;
  P.S_pad = S_pad;
  P.C = C;
  P.K = K;
  P.B = B;
  P.R = R;
  P.T = T;
  P.G = G;
  P.nt = static_cast<int>(nt);
  P.NPmax = static_cast<int>(NPmax);
  P.Dp = Dp;
  P.nb = reinterpret_cast<int*>(ws + offs[0]);
  P.lastb = reinterpret_cast<int*>(ws + offs[1]);
  P.miss = reinterpret_cast<int*>(ws + offs[2]);
  P.ptr_entry = reinterpret_cast<int*>(ws + offs[3]);
  P.pbase = reinterpret_cast<int*>(ws + offs[4]);
  P.np = reinterpret_cast<int*>(ws + offs[5]);
  P.ends = reinterpret_cast<int*>(ws + offs[6]);
  P.runs = reinterpret_cast<int*>(ws + offs[7]);
  P.mat = reinterpret_cast<long long*>(ws + offs[8]);
  P.entry = reinterpret_cast<long long*>(ws + offs[9]);
  P.shift = reinterpret_cast<long long*>(ws + offs[10]);
  float* ms = static_cast<float*>(pass_ms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return run_chunked<1>(P, M, ms, st);
    case 2: return run_chunked<2>(P, M, ms, st);
    case 4: return run_chunked<4>(P, M, ms, st);
    case 8: return run_chunked<8>(P, M, ms, st);
    case 16: return run_chunked<16>(P, M, ms, st);
    case 32: return run_chunked<32>(P, M, ms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
