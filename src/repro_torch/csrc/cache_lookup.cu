// LRU lookup of a read stream through a set-associative on-chip cache.
//
// Replaces the XLA lax.scan _lookup_scan (src/repro/core/cache.py:258;
// not a Pallas kernel) and its NumPy twin _lookup_numpy (:229).  Input:
// the reads of a stream sorted stably by set, as CSR segments (seg_ptr,
// one segment a touched set, program order kept inside each), each read's
// tag and its position in program order, and the touched sets' [U, W]
// tags and LRU ages.  Output: the per-read hit flag in program order; the
// state rows are updated in place.  The LRU rules are the reference's:
// the threshold is the largest age among the ways holding the tag (-1
// where none does), and on a hit the ways younger than it age by one and
// the first way holding the tag becomes age 0; on a miss every way
// younger than W ages by one and the first way of the largest age takes
// the tag at age 0.
//
// What bounds it.  By bytes: each read's tag (8 B), position (4 B) and
// hit flag (1 B) once, and the touched rows of the state read and written
// once; tens of microseconds for millions of reads over 3.35 TB/s.  In
// practice: the chain of dependent steps in the longest segment (the
// hottest set), one step a read.  The default cache's stream has 2,048
// sets of ~2,265 reads each: 64 warps of one set a lane, one warp a
// scheduler, so a step costs what one warp's instructions for it cost.
//
// What the design does about it.  Two paths, picked by W.
//
// W <= 32, a thread a set (lookup_thread_kernel).  The ages of a set are
// a permutation of 0..W-1 (CacheState keeps them so), so the set is kept
// as its ways in recency order: register slot r holds the tag and the way
// whose age is r.  A read compares its tag with the W slots at once (no
// warp collective, no dependence between lanes); the matching slot k, or
// W - 1 on a miss (the oldest way), moves to slot 0 with the read's tag
// and slots 0..k-1 move down one.  Tags are compared in 32 bits (a line's
// tag is below 2^31 at every size this simulator runs), the match mask is
// a tree, the moves are selects, the ways are packed 4 bits a slot up to
// 16 ways, and a step has no branch (a lane past its segment selects its
// old state): ~85 integer instructions, which the 16-lane integer pipe
// issues at one per two cycles, so ~270 cycles a step; the steps of a
// chunk are unrolled so that one step's independent work fills another's
// latency.  A warp's lanes step in lockstep, a chunk at a time, to its
// longest segment.  Each thread's next reads come into shared memory by
// asynchronous copies (cp.async, 16 B each, completed on an mbarrier of
// the thread's own), kStages chunks of kChunk reads ahead, so the loads
// of a chunk overlap the steps of the ones before it; a chunk is counted
// from the thread's own segment start (copied from the 16 B boundary
// before it), so every lane waits and refills at the same step.  One bulk
// copy (cp.async.bulk) a run, a vote and a branch to a shorter path for
// a step where no lane hits, and no staging were each slower
// (tools/lookup_variants.py).  At the end the row is written once: each
// way's tag, and as its age its slot.
//
// A set that the rule does not fit goes to the warp path within the same
// launch: from its first read a row whose ages are not a permutation,
// that holds a tag outside 32 bits or the same line (a tag >= 0) in two
// ways; from that read on (the row written back first) a set where a
// read's tag is negative or 2^31 or more.  Where the rule fits, a read's
// line is held by one way at most and the slots are the reference's ages,
// so every set is served by the reference's rule, bit for bit.
//
// W > 32 (and the sets handed over above), a warp a set (serve_warp, the
// design the thread path replaced for W <= 32): the ways sit on the lanes (way g * 32 + lane in
// register slot g, G = ceil(W / 32) slots), a match is one ballot a slot,
// the threshold is the one matching way's age (a shuffle) or the largest
// among several (a warp maximum), the victim comes from a warp maximum of
// the ages (32-bit where they fit, as they do in every CacheState), and
// the update is register arithmetic.  The warp loads 32 reads' tags and
// positions at a time and writes their 32 hit flags after serving them.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;   // warp path: sets a block
constexpr int kThreads = 64;        // thread path: sets a block
constexpr int kChunk = 16;          // reads a stage
constexpr int kStages = 3;          // chunks a thread has in flight
// a chunk's tags copied from the even index at or before it, its
// positions from the multiple of 4: runs of 144 and 80 bytes that start
// on 16 B, as a bulk copy needs
constexpr int kTagRun = kChunk + 2;
constexpr int kPosRun = kChunk + 4;

// The warp's largest v: one 32-bit reduction, or five 64-bit shuffles.
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(kFull, v);
}
__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The reads [b, e) of a set whose ways the warp holds (tags t, ages a of
// type A, way g * 32 + lane in slot g), by the reference's rule.
template <int G, typename A>
__device__ void walk_warp(long long b, long long e,
                          const long long* __restrict__ tag,
                          const int* __restrict__ pos,
                          unsigned char* __restrict__ hit, int W,
                          long long (&t)[G], A (&a)[G], const bool (&own)[G]) {
  const int lane = threadIdx.x & 31;
  constexpr A kNone = sizeof(A) == 4 ? INT_MIN : LLONG_MIN;
  for (long long base = b; base < e; base += 32) {
    const int n = static_cast<int>(min(32LL, e - base));
    const long long my_tag = lane < n ? tag[base + lane] : 0;
    const int my_pos = lane < n ? pos[base + lane] : 0;
    unsigned char my_hit = 0;
    for (int j = 0; j < n; ++j) {
      const long long cur = __shfl_sync(kFull, my_tag, j);
      // the first way holding the tag, and how many hold it
      int tg = -1, tl = 0, held = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const unsigned mask = __ballot_sync(kFull, own[g] && t[g] == cur);
        held += __popc(mask);
        if (tg < 0 && mask) {
          tg = g;
          tl = __ffs(mask) - 1;
        }
      }
      const bool h = tg >= 0;
      A thresh;
      if (held == 1) {  // the age of the one way holding it
        A mine = 0;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g == tg) mine = a[g];
        thresh = __shfl_sync(kFull, mine, tl);
      } else if (h) {  // the largest age among the ways holding it
        A mx = kNone;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (own[g]) mx = max(mx, t[g] == cur ? a[g] : static_cast<A>(-1));
        thresh = warp_max(mx);
      } else {
        // the victim: the first way holding the largest age
        A mx = kNone;
#pragma unroll
        for (int g = 0; g < G; ++g) mx = max(mx, a[g]);
        mx = warp_max(mx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const unsigned mask = __ballot_sync(kFull, own[g] && a[g] == mx);
          if (tg < 0 && mask) {
            tg = g;
            tl = __ffs(mask) - 1;
          }
        }
        thresh = W;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (!own[g]) continue;
        if (g == tg && lane == tl) {
          a[g] = 0;
          t[g] = cur;
        } else if (a[g] < thresh) {
          a[g] += 1;
        }
      }
      if (lane == j) my_hit = h ? 1 : 0;
    }
    if (lane < n) hit[my_pos] = my_hit;
  }
}

// One warp serves reads [b, e) of set `set` by the reference's rule:
// the ages in 32 bits where they start within +-2^30 (an age never passes
// the larger of its start and W, so they stay in range), else in 64.
template <int G>
__device__ void serve_warp(long long set, long long b, long long e,
                           const long long* __restrict__ tag,
                           const int* __restrict__ pos,
                           long long* __restrict__ tags,
                           long long* __restrict__ age,
                           unsigned char* __restrict__ hit, int W) {
  const int lane = threadIdx.x & 31;
  long long t[G], a[G];
  bool own[G];
  bool fits = true;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int w = g * 32 + lane;
    own[g] = w < W;
    t[g] = own[g] ? tags[set * W + w] : -1;
    a[g] = own[g] ? age[set * W + w] : LLONG_MIN;
    if (own[g]) fits = fits && a[g] >= -(1LL << 30) && a[g] <= (1LL << 30);
  }
  if (__all_sync(kFull, fits)) {
    int a32[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      a32[g] = own[g] ? static_cast<int>(a[g]) : INT_MIN;
    walk_warp<G, int>(b, e, tag, pos, hit, W, t, a32, own);
#pragma unroll
    for (int g = 0; g < G; ++g) a[g] = a32[g];
  } else {
    walk_warp<G, long long>(b, e, tag, pos, hit, W, t, a, own);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!own[g]) continue;
    const long long i = set * W + g * 32 + lane;
    tags[i] = t[g];
    age[i] = a[g];
  }
}

template <int G>
__global__ void lookup_warp_kernel(const long long* __restrict__ seg_ptr,
                                   const long long* __restrict__ tag,
                                   const int* __restrict__ pos,
                                   long long* __restrict__ tags,
                                   long long* __restrict__ age,
                                   unsigned char* __restrict__ hit, int U,
                                   int W) {
  const int set = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (set >= U) return;
  serve_warp<G>(set, seg_ptr[set], seg_ptr[set + 1], tag, pos, tags, age,
                hit, W);
}

// ---- mbarrier and asynchronous copy (PTX) ----------------------------------

__device__ __forceinline__ unsigned smem(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// 16 bytes from global to shared memory, asynchronously (cp.async, L2
// only)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem(dst)),
               "l"(src)
               : "memory");
}

// the thread's arrival on `bar` once its earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_copies(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem(bar))
               : "memory");
}

// ---- thread path ----------------------------------------------------------

// The slots holding `cur`, as a bit mask (an OR tree, so that the step's
// chain of dependent instructions stays short).
template <int WM, typename T>
__device__ __forceinline__ unsigned held_by(const T (&st)[WM], T cur) {
  unsigned bits[WM];
#pragma unroll
  for (int r = 0; r < WM; ++r) bits[r] = st[r] == cur ? 1u << r : 0u;
#pragma unroll
  for (int w = 1; w < WM; w *= 2)
#pragma unroll
    for (int r = 0; r + w < WM; r += 2 * w) bits[r] |= bits[r + w];
  return bits[0];
}

// Slots 0..k-1 (the bits of `down`) move down one and `cur` takes slot 0.
template <int WM, typename T>
__device__ __forceinline__ void shift_in(T (&st)[WM], unsigned down, T cur) {
#pragma unroll
  for (int r = WM - 1; r >= 1; --r)
    if ((down >> (r - 1)) & 1u) st[r] = st[r - 1];
  st[0] = cur;
}

// The way of each slot: 4 bits a slot in one word up to 16 ways, else a
// register a slot.
template <int WM, bool kPacked = (WM <= 16)>
struct Ways;

template <int WM>
struct Ways<WM, true> {
  unsigned long long p = 0;
  __device__ int get(int r) const {
    return static_cast<int>((p >> (4 * r)) & 15u);
  }
  __device__ void init(int r, int w) {
    p |= static_cast<unsigned long long>(w) << (4 * r);
  }
  // the slot `front` (one bit) to slot 0, the slots before it down one
  __device__ void to_front(unsigned front) {
    const int k = __ffs(front) - 1;
    const unsigned long long low = (1ull << (4 * k)) - 1ull;
    const unsigned long long wk = (p >> (4 * k)) & 15ull;
    p = (p & ~((low << 4) | 15ull)) | ((p & low) << 4) | wk;
  }
};

template <int WM>
struct Ways<WM, false> {
  int w[WM];
  __device__ int get(int r) const { return w[r]; }
  __device__ void init(int r, int v) { w[r] = v; }
  __device__ void to_front(unsigned front) {
    int sel[WM];
#pragma unroll
    for (int r = 0; r < WM; ++r) sel[r] = (front >> r) & 1u ? w[r] : 0;
#pragma unroll
    for (int d = 1; d < WM; d *= 2)
#pragma unroll
      for (int r = 0; r + d < WM; r += 2 * d) sel[r] |= sel[r + d];
    shift_in(w, front - 1u, sel[0]);
  }
};

template <int WM>
__global__ void __launch_bounds__(kThreads)
    lookup_thread_kernel(const long long* __restrict__ seg_ptr,
                         const long long* __restrict__ tag,
                         const int* __restrict__ pos,
                         long long* __restrict__ tags,
                         long long* __restrict__ age,
                         unsigned char* __restrict__ hit, int U, int W,
                         long long N, int aligned) {
  __shared__ __align__(128) long long s_tag[kThreads][kStages][kTagRun];
  __shared__ __align__(128) int s_pos[kThreads][kStages][kPosRun];
  __shared__ __align__(8) unsigned long long s_bar[kThreads][kStages];
  __shared__ int n_handed;
  __shared__ int handed_set[kThreads];
  __shared__ long long handed_from[kThreads];

  const int tid = threadIdx.x;
  const int set = blockIdx.x * kThreads + tid;
  if (tid == 0) n_handed = 0;
#pragma unroll
  for (int s = 0; s < kStages; ++s) mbar_init(&s_bar[tid][s]);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  const bool live = set < U;
  const long long b = live ? seg_ptr[set] : 0;
  const long long e = live ? seg_ptr[set + 1] : 0;
  long long* row_t = tags + static_cast<long long>(set) * W;
  long long* row_a = age + static_cast<long long>(set) * W;
  // the row, all loads in flight at once
  long long rt[WM], ra[WM];
#pragma unroll
  for (int r = 0; r < WM; ++r) {
    rt[r] = live && r < W ? row_t[r] : 0;
    ra[r] = live && r < W ? row_a[r] : r;
  }
  // the rule holds where the ages are a permutation of 0..W-1, every tag
  // fits in 32 bits and no two ways hold the same line (a tag >= 0): a
  // read of a line then matches one way at most, and a line enters only
  // on a miss, so that stays so.  The row in recency order goes through
  // the thread's own staging space (54 and 60 entries, W <= 32 used).
  long long* by_age_t = &s_tag[tid][0][0];
  int* by_age_w = &s_pos[tid][0][0];
  unsigned seen = 0;
  bool fits = true;
#pragma unroll
  for (int r = 0; r < WM; ++r) {
    if (r >= W) break;
    const long long a = ra[r];
    const bool ok = a >= 0 && a < W && !((seen >> a) & 1u);
    fits = fits && ok && rt[r] == static_cast<int>(rt[r]);
    if (ok) {
      seen |= 1u << a;
      by_age_t[a] = rt[r];
      by_age_w[a] = r;
    }
#pragma unroll
    for (int q = 0; q < r; ++q) fits = fits && !(rt[r] >= 0 && rt[q] == rt[r]);
  }
  int st[WM];  // the tag of each slot
  Ways<WM> ways;
#pragma unroll
  for (int r = 0; r < WM; ++r) {  // past W, a tag no line matches
    st[r] = r < W ? static_cast<int>(by_age_t[r]) : -1;
    ways.init(r, r < W ? by_age_w[r] : 0);
  }
  const unsigned oldest = 1u << (W - 1);
  // this thread serves reads [b, b + len); the warp path the rest
  int len = live && fits ? static_cast<int>(e - b) : 0;

  // chunk k holds reads b + k * kChunk onwards, at offsets off_t / off_p
  // of its stage (the same for every chunk of the thread)
  const int off_t = static_cast<int>(b & 1), off_p = static_cast<int>(b & 3);
  const int chunks = (len + kChunk - 1) / kChunk;
  int next_issue = 0, next_wait = 0;
  unsigned parity = 0;  // bit s: the phase stage s completes next
  auto issue = [&]() {
    const int s = next_issue % kStages;
    const long long A = b + static_cast<long long>(next_issue) * kChunk;
    const long long at = A - off_t, ap = A - off_p;
    unsigned long long* bar = &s_bar[tid][s];
    if (aligned && at + kTagRun <= N && ap + kPosRun <= N) {
#pragma unroll
      for (int q = 0; q < kTagRun / 2; ++q)
        copy16(&s_tag[tid][s][2 * q], tag + at + 2 * q);
#pragma unroll
      for (int q = 0; q < kPosRun / 4; ++q)
        copy16(&s_pos[tid][s][4 * q], pos + ap + 4 * q);
      mbar_arrive_copies(bar);
    } else {
      for (long long i = A; i < min(e, A + kChunk); ++i) {
        s_tag[tid][s][off_t + i - A] = tag[i];
        s_pos[tid][s][off_p + i - A] = pos[i];
      }
      mbar_arrive(bar);
    }
    ++next_issue;
  };
  auto wait = [&]() {
    const int s = next_wait % kStages;
    mbar_wait(&s_bar[tid][s], (parity >> s) & 1u);
    parity ^= 1u << s;
    ++next_wait;
    return s;
  };
  while (next_issue < chunks && next_issue < kStages) issue();

  // the warp's lanes in lockstep, a chunk at a time to the warp's longest
  // segment: every lane waits for and refills its chunk k together, then
  // takes its kChunk steps, each without a branch (a lane past its own
  // segment keeps its state)
  const int warp_chunks = __reduce_max_sync(kFull, chunks);
  for (int k = 0; k < warp_chunks; ++k) {
    int s = 0;
    if (k < chunks) {
      s = wait();
      if (k > 0 && next_issue < chunks) issue();  // the stage just left
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int t = k * kChunk + j;
      const long long cur = s_tag[tid][s][off_t + j];
      // a tag that is no line below 2^31: the warp path's from here
      if (t < len && static_cast<unsigned long long>(cur) >= 0x80000000ull)
        len = t;
      const bool upd = t < len;
      const int c = static_cast<int>(cur);
      const unsigned m = held_by(st, c);
      // the slot that comes to the front (none where the lane is idle)
      const unsigned front = upd ? (m ? m : oldest) : 1u;
      ways.to_front(front);
      shift_in(st, front - 1u, upd ? c : st[0]);
      if (upd) hit[s_pos[tid][s][off_p + j]] = m ? 1 : 0;
    }
  }
  const long long stop = b + len;
  // no copy may land in shared memory after the thread moves on
  while (next_wait < next_issue) wait();
  if (live && fits) {
#pragma unroll
    for (int r = 0; r < WM; ++r) {
      if (r < W) {
        const int w = ways.get(r);
        row_t[w] = st[r];
        row_a[w] = r;
      }
    }
  }
  if (live && stop < e) {
    const int d = atomicAdd(&n_handed, 1);
    handed_set[d] = set;
    handed_from[d] = stop;
  }
  __syncthreads();
  // the sets the rule does not fit, a warp each, by the reference's rule
  const int n = n_handed;
  for (int d = tid >> 5; d < n; d += kThreads / 32) {
    const int s = handed_set[d];
    serve_warp<1>(s, handed_from[d], seg_ptr[s + 1], tag, pos, tags, age,
                  hit, W);
  }
}

template <int G>
cudaError_t launch_warp(const long long* seg_ptr, const long long* tag,
                        const int* pos, long long* tags, long long* age,
                        unsigned char* hit, int U, int W,
                        cudaStream_t stream) {
  const int blocks = (U + kWarpsPerBlock - 1) / kWarpsPerBlock;
  lookup_warp_kernel<G><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      seg_ptr, tag, pos, tags, age, hit, U, W);
  return cudaGetLastError();
}

template <int WM>
cudaError_t launch_thread(const long long* seg_ptr, const long long* tag,
                          const int* pos, long long* tags, long long* age,
                          unsigned char* hit, int U, int W, long long N,
                          cudaStream_t stream) {
  const int blocks = (U + kThreads - 1) / kThreads;
  const int aligned = reinterpret_cast<uintptr_t>(tag) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(pos) % 16 == 0;
  lookup_thread_kernel<WM><<<blocks, kThreads, 0, stream>>>(
      seg_ptr, tag, pos, tags, age, hit, U, W, N, aligned);
  return cudaGetLastError();
}

cudaError_t warp_path(const long long* sp, const long long* tg,
                      const int* ps, long long* ts, long long* ag,
                      unsigned char* ht, int U, int W, cudaStream_t st) {
  const int G = (W + 31) / 32;
  if (G <= 1) return launch_warp<1>(sp, tg, ps, ts, ag, ht, U, W, st);
  if (G <= 2) return launch_warp<2>(sp, tg, ps, ts, ag, ht, U, W, st);
  if (G <= 4) return launch_warp<4>(sp, tg, ps, ts, ag, ht, U, W, st);
  if (G <= 8) return launch_warp<8>(sp, tg, ps, ts, ag, ht, U, W, st);
  if (G <= 16) return launch_warp<16>(sp, tg, ps, ts, ag, ht, U, W, st);
  if (G <= 32) return launch_warp<32>(sp, tg, ps, ts, ag, ht, U, W, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// The largest associativity the kernel takes (32 register slots a lane).
extern "C" int repro_cache_lookup_max_ways() { return 32 * 32; }

// The widest set the thread path serves; wider ones go to the warp path.
extern "C" int repro_cache_lookup_thread_max_ways() { return 32; }

// The lookup: the thread path for W <= 32, else the warp path.  `warp`
// non-zero serves every set by the warp path (to time the two paths on
// the same stream).
extern "C" int repro_cache_lookup(const void* seg_ptr, const void* tag,
                                  const void* pos, void* tags, void* age,
                                  void* hit, int U, int W, long long N,
                                  int warp, void* stream) {
  if (U <= 0) return 0;
  auto* sp = static_cast<const long long*>(seg_ptr);
  auto* tg = static_cast<const long long*>(tag);
  auto* ps = static_cast<const int*>(pos);
  auto* ts = static_cast<long long*>(tags);
  auto* ag = static_cast<long long*>(age);
  auto* ht = static_cast<unsigned char*>(hit);
  auto* st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (warp || W > 32) err = warp_path(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (W <= 1) err = launch_thread<1>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  else if (W <= 2) err = launch_thread<2>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  else if (W <= 4) err = launch_thread<4>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  else if (W <= 8) err = launch_thread<8>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  else if (W <= 16)
    err = launch_thread<16>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  else err = launch_thread<32>(sp, tg, ps, ts, ag, ht, U, W, N, st);
  return static_cast<int>(err);
}
