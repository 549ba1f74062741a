// Per-channel DRAM timing scan of one phase as an exact chunked max-plus
// scan, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel dram_timing_kernel
// (src/repro/kernels/dram_timing/kernel.py:117, body _kernel at :51).
// Its semantics are the JAX scan step _request_step
// (src/repro/core/vectorized.py:227-276), over each channel's [L] stream,
// with the channel carry in and out (VectorizedDRAM.run_phase chains
// phases on one memory timeline).  The one-lane transcription of that
// step is csrc/dram_timing_serial.cu; the plain torch version of this
// design is dram_timing_chunked_ref (kernels/dram_timing/ref.py).
//
// What it computes.  Per valid slot of a channel: hit / empty from the
// bank's open row; the ACT time under tRP/tRAS and the rank's tRRD/tFAW
// window (a 4-deep ACT ring); col = hit ? base : act + tRCD; finish =
// max(col + tCL, bus) + tBL.  Invalid slots emit (finish 0, kind -1).
//
// What bounds it.  Bytes: 13 B in and 5 B out a slot, 0.0113 ms for the
// largest dynamic-path phase over 3.35 TB/s.  Walked slot by slot, a
// channel is one dependent chain of L steps (176 ns a step in the serial
// kernel), so the chain, not the bytes, has to be broken.
//
// Why an exact parallel form exists.
//  (a) The selections need no carry.  A bank's open row before a slot is
//      the row of the previous valid slot to that bank, or the carry's;
//      so hit, empty, kind and "this slot ACTs" follow from the rows
//      alone, and so does a rank's ring pointer (its ACTs so far, mod 4).
//  (b) With the selections fixed every other operation is a max or an
//      addition of a constant (a timing parameter, or the slot's issue
//      through a constant-0 component).  So on a rank's state vector
//      s = (bank_avail[b], act_time[b] for its banks, the ACT ring in
//      order from the chunk's entry pointer, last_act, 0), of length
//      D = 2 * banks_per_rank + 6, a chunk of slots is one max-plus matrix.
//      Ranks touch disjoint state, so each rank is its own chain.
//  (c) col never reads the bus, and with n_i the channel's valid slots up
//      to and including slot i, finish_i = n_i * tBL + max(bus_in,
//      max_{j <= i} (col_j + tCL + tBL - n_j * tBL)): a prefix max.  A
//      chunk's share of it is one more row of its matrix.
// The matrices and the carry scan are int64 (a max-plus zero far below
// any time; the transfer walks in int32 where that is provably the same),
// which equals the int32 reference wherever that never wraps.  The emit
// walks each chunk in int32 from its entry state and marks the kind
// KIND_WRAPPED of a slot where an addition wraps, and the wrapper then
// raises: that is the one departure, on inputs the reference wraps on
// (where the entry states could differ from the wrapped ones).
//
// The design: fixed chunks of T slots (T a template parameter), seven
// launches (five passes) on one stream, no host synchronisation.  Scratch
// comes from the stream-ordered allocator (cudaMallocAsync), since the
// entry point takes no scratch buffer.
//  1. summary_kernel, one CTA a chunk: each bank's first and last valid
//     row, the ACTs of slots that are not the first to their bank, the
//     valid slots of each rank; and a padded record a slot (rank and bank
//     or -1, issue, row, and later its kind).
//  2. entry_kernel, one CTA a channel: each chunk's entry open rows (one
//     thread a bank walks the chunks' summaries; first-slot ACTs added
//     to the chunk's count), then block scans for the entry ring pointers
//     and valid counts.  Gives the carry's open_row and act_ptr.
//  3. transfer_kernel, one CTA a (chunk, rank) of D lanes: lane j runs
//     the chunk's slots from the basis vector e_j (the state in shared
//     memory, component-major so the lanes' accesses are conflict-free;
//     last ACT and the bus row in registers).  The selections are the
//     same for every lane, so the warp never diverges.  Lanes walk the
//     ring relative to the chunk's entry pointer and store column j of
//     the chunk's matrix, and its bus row, in the ring's absolute order
//     (pass 2 fixed the pointer); lane 0 writes each slot's kind, to the
//     output and to the slot's record.  Records stream in by cp.async,
//     double-buffered.
//  4. the carry scan, three launches: compose_kernel multiplies each
//     group of G chunks' matrices into prefix products (one CTA a
//     group); chain_kernel, one CTA a (channel, rank), walks the groups,
//     s <- P (x) s, four threads a component, the products streaming into
//     a shared-memory ring by cp.async, and gives the carry out;
//     expand_kernel, one CTA a chunk, gives each chunk's entry state and
//     its bus term, and the channel's last CTA to finish turns the bus
//     terms into each chunk's bus on entry (a prefix max) and the carry's
//     bus_free.
//  5. emit_kernel, one lane a chunk: from the true entry state the lane
//     walks its chunk once more with the whole channel's bank and rank
//     times (shared memory, a column a lane; the kinds from the records):
//     the reference step itself, in int32 that wraps as the reference
//     does, a wrap marked on the slot's kind, each slot's state read one
//     slot ahead.  A chunk with no valid slot only writes zeros.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

// the max-plus zero: far below any time, and two of it still an int64
constexpr long long NEG = -(1LL << 61);
constexpr int TILE = 256;                  // slots staged at a time
constexpr int SEGS = 32;                   // a chunk's segments in the summary
constexpr int MAX_GROUP = 64;              // chunks composed into one product
constexpr int DEFAULT_GROUP = 32;
constexpr int EMIT_LANES = 32;             // chunks an emit CTA walks
constexpr int EMIT_TILE = 16;              // slots an emit CTA stages at a time
constexpr signed char KIND_WRAPPED = 3;    // a slot whose step left int32

struct Work {
  int4* rec;            // [C][nK*T] slot records {code, issue, row, kind}
  int* has;             // [C][nK][B] bank has a valid slot in the chunk
  int* first;           // [C][nK][B] its first row there
  int* last;            // [C][nK][B] its last row there
  int* acts;            // [C][nK][R] ACTs in the chunk
  int* cnt;             // [C][nK][R] valid slots of each rank
  int* nvalid;          // [C][nK]
  int* open_entry;      // [C][nK][B]
  int* ptr_entry;       // [C][nK][R]
  long long* nbefore;   // [C][nK] valid slots before the chunk
  long long* M;         // [C][R][nK][D][D] column j = lane j's state
  long long* G;         // [C][R][nK][D] bus row
  long long* entry;     // [C][R][nK][D] entry state, ring in absolute order
  long long* h;         // [C][R][nK] the chunk's bus term
  long long* gentry;    // [C][R][nG] each group's entry state
  long long* fentry;    // [C][nK] bus on entry, less nbefore * tBL
  int* done;            // [C] carry-scan CTAs finished
};

struct Params {
  const int* issue;
  const int* bank;
  const int* row;
  const unsigned char* valid;
  const int* timing;
  const int* open_in;
  const int* act_in;
  const int* avail_in;
  const int* bus_in;
  const int* hist_in;
  const int* ptr_in;
  const int* last_in;
  int* finish;
  signed char* kind;
  int* open_out;
  int* act_out;
  int* avail_out;
  int* bus_out;
  int* hist_out;
  int* ptr_out;
  int* last_out;
  long long L;
  int C, B, R, bpr, D, nK;
  int G;   // chunks a group of the carry scan (1: one serial walk)
  Work w;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Stage the records of slots [t0, t0 + n) of chunk k of channel c into
// shared memory, one 16-byte copy a slot.
__device__ __forceinline__ void stage_tile(const Params& P, int c, int k,
                                           int T, int t0, int n, int4* dst) {
  const int4* src = P.w.rec + (static_cast<long long>(c) * P.nK + k) * T + t0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    cp_async16(dst + i, src + i);
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
    const long long y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(x, y);
  }
  long long ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < nwarps ? sums[lane] : id;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, v, o);
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

// ---- 1. chunk summary --------------------------------------------------

// A slot's code: -1 if invalid, else its rank << 16 | its bank.  The
// chunk's records are written out, its slots split into SEGS segments
// that one lane each summarises by bank (shared tables [B][SEGS]), and
// one thread a bank combines the segments in order.
template <int T>
__global__ void __launch_bounds__(128) summary_kernel(Params P) {
  constexpr int SL = T / SEGS;
  __shared__ int s_bank[T], s_row[T];
  __shared__ int s_acts[32], s_cnt[32];
  extern __shared__ int tables[];   // has, first, last, nf, nb: [B][SEGS]
  const int k = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int B = P.B, R = P.R, bpr = P.bpr;
  int* has = tables;
  int* first = has + B * SEGS;
  int* last = first + B * SEGS;
  int* nf = last + B * SEGS;
  int* nb = nf + B * SEGS;
  if (tid < R) s_acts[tid] = s_cnt[tid] = 0;
  for (int x = tid; x < B * SEGS; x += blockDim.x) has[x] = nf[x] = nb[x] = 0;
  const long long gbase = static_cast<long long>(c) * P.L;
  const long long s0 = static_cast<long long>(k) * T;
  int4* rec = P.w.rec + static_cast<long long>(c) * P.nK * T + s0;
  for (int i = tid; i < T; i += blockDim.x) {
    int b = -1, r = 0, is = 0;
    if (s0 + i < P.L && P.valid[gbase + s0 + i]) {
      b = P.bank[gbase + s0 + i];
      r = P.row[gbase + s0 + i];
      is = P.issue[gbase + s0 + i];
    }
    s_bank[i] = b;
    s_row[i] = r;
    rec[i] = make_int4(b < 0 ? -1 : (b / bpr) << 16 | b, is, r, 0);
  }
  __syncthreads();
  if (tid < SEGS) {
    for (int i = tid * SL; i < (tid + 1) * SL; ++i) {
      const int b = s_bank[i];
      if (b < 0) continue;
      const int x = b * SEGS + tid, r = s_row[i];
      nf[x] += has[x] && r != last[x];
      if (!has[x]) first[x] = r;
      has[x] = 1;
      last[x] = r;
      ++nb[x];
    }
  }
  __syncthreads();
  const long long ck = static_cast<long long>(c) * P.nK + k;
  for (int b = tid; b < B; b += blockDim.x) {
    int h = 0, f = 0, l = 0, acts = 0, n = 0;
    for (int g = 0; g < SEGS; ++g) {
      const int x = b * SEGS + g;
      if (!has[x]) continue;
      acts += nf[x] + (h && first[x] != l);
      f = h ? f : first[x];
      h = 1;
      l = last[x];
      n += nb[x];
    }
    P.w.has[ck * B + b] = h;
    P.w.first[ck * B + b] = f;
    P.w.last[ck * B + b] = l;
    if (acts) atomicAdd(&s_acts[b / bpr], acts);
    if (n) atomicAdd(&s_cnt[b / bpr], n);
  }
  __syncthreads();
  if (tid < R) {
    P.w.acts[ck * R + tid] = s_acts[tid];
    P.w.cnt[ck * R + tid] = s_cnt[tid];
  }
  if (tid == 0) {
    int n = 0;
    for (int r = 0; r < R; ++r) n += s_cnt[r];
    P.w.nvalid[ck] = n;
  }
}

// ---- 2. entry scan -----------------------------------------------------

// Thread (bank b, segment g) of the chunks: the segment's last chunk with
// a slot on b, then (after the earlier segments' are known) the walk
// through its chunks from the open row on entry.
constexpr int ENTRY_THREADS = 1024;

__global__ void __launch_bounds__(ENTRY_THREADS) entry_kernel(Params P) {
  __shared__ long long sums[32];
  __shared__ int seg_last[ENTRY_THREADS];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int B = P.B, R = P.R, nK = P.nK;
  const long long cb = static_cast<long long>(c) * nK;
  const int G = max(1, static_cast<int>(blockDim.x) / B);
  const int b = tid % B, g = tid / B;
  const int per = (nK + G - 1) / G;
  const int lo = min(nK, g * per), hi = min(nK, lo + per);
  const bool active = g < G;
  const int* __restrict__ has = P.w.has + cb * B + b;
  const int* __restrict__ last = P.w.last + cb * B + b;
  if (tid == 0) P.w.done[c] = 0;
  if (active) {
    int lk = -1;
#pragma unroll 8
    for (int k = lo; k < hi; ++k)
      lk = has[static_cast<long long>(k) * B] ? k : lk;
    seg_last[g * B + b] = lk;
  }
  __syncthreads();
  if (active) {
    int prev = -1;
    for (int gg = 0; gg < g; ++gg)
      prev = seg_last[gg * B + b] >= 0 ? seg_last[gg * B + b] : prev;
    const int* __restrict__ first = P.w.first + cb * B + b;
    int* __restrict__ open_entry = P.w.open_entry + cb * B + b;
    int* acts = P.w.acts + cb * R + b / P.bpr;
    int opn = prev >= 0 ? last[static_cast<long long>(prev) * B]
                        : P.open_in[c * B + b];
    constexpr int U = 8;   // chunks whose summaries load together
    for (int k0 = lo; k0 < hi; k0 += U) {
      int hs[U], fs[U], ls[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long o = static_cast<long long>(k0 + u) * B;
        const bool in = k0 + u < hi;
        hs[u] = in ? has[o] : 0;
        fs[u] = in ? first[o] : 0;
        ls[u] = in ? last[o] : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + u >= hi) break;
        open_entry[static_cast<long long>(k0 + u) * B] = opn;
        if (hs[u]) {
          if (fs[u] != opn) atomicAdd(acts + (k0 + u) * R, 1);
          opn = ls[u];
        }
      }
    }
    if (g == G - 1) P.open_out[c * B + b] = opn;
  }
  __syncthreads();
  auto add = [](long long a, long long b) { return a + b; };
  for (int r = 0; r < R; ++r) {
    const int p0 = P.ptr_in[c * R + r];
    const long long total = block_scan(
        nK, 0LL,
        [&](int k) {
          return static_cast<long long>(P.w.acts[(cb + k) * R + r]);
        },
        [&](int k, long long x) {
          P.w.ptr_entry[(cb + k) * R + r] = static_cast<int>((p0 + x) & 3);
        },
        add, sums);
    if (tid == 0) P.ptr_out[c * R + r] = static_cast<int>((p0 + total) & 3);
  }
  block_scan(
      nK, 0LL,
      [&](int k) { return static_cast<long long>(P.w.nvalid[cb + k]); },
      [&](int k, long long x) { P.w.nbefore[cb + k] = x; }, add, sums);
}

// ---- 3. chunk transfer -------------------------------------------------

// The max-plus zero for the lanes' values: int64 NEG, or -2^30 in int32,
// where (see the kernel) nothing that starts there climbs past -2^29 and
// nothing finite falls to it.
template <typename V>
struct Zero;
template <>
struct Zero<long long> {
  static constexpr long long value = NEG;
  __device__ static long long widen(long long v) { return v; }
};
template <>
struct Zero<int> {
  static constexpr int value = -(1 << 30);
  __device__ static long long widen(int v) {
    return v < -(1 << 29) ? NEG : static_cast<long long>(v);
  }
};

// Lane `lane` walks the chunk's slots of rank r from the basis vector
// e_lane in values of type V, and writes column `lane` of the chunk's
// matrix and its bus row.
template <int T, typename V>
__device__ void transfer_walk(const Params& P, int k, int r, int c,
                              unsigned char* smem) {
  constexpr int TT = T < TILE ? T : TILE;
  constexpr V ZERO = Zero<V>::value;
  const int DL = blockDim.x;
  const int bpr = P.bpr, D = P.D;
  const int A = bpr, H = 2 * bpr, LAST = H + 4, Z = H + 5;
  // rows: bank_avail, act_time of the rank's banks, then the ACT ring in
  // order from the chunk's entry pointer; a lane's values in its column
  V* st = reinterpret_cast<V*>(smem);                          // [H+4][DL]
  int4* tile = reinterpret_cast<int4*>(
      smem + sizeof(long long) * (H + 4) * DL);                // [2][TT]
  int* opn = reinterpret_cast<int*>(tile + 2 * TT);            // [bpr][DL]
  const int lane = threadIdx.x;
  const long long ck = static_cast<long long>(c) * P.nK + k;
  const long long gbase = static_cast<long long>(c) * P.L;
  const long long s0 = static_cast<long long>(k) * T;
  int4* rec = P.w.rec + ck * T;   // the slots' kinds go to their fourth word
  const V tCL = P.timing[0], tRCD = P.timing[1], tRP = P.timing[2];
  const V tRAS = P.timing[3], tBL = P.timing[4], tRRD = P.timing[5];
  const V tFAW = P.timing[6];
  const int rbase = r * bpr;
  for (int i = 0; i < H + 4; ++i) st[i * DL + lane] = i == lane ? 0 : ZERO;
  for (int b = 0; b < bpr; ++b)
    opn[b * DL + lane] = P.w.open_entry[ck * P.B + rbase + b];
  V lastv = lane == LAST ? 0 : ZERO;
  // the issue enters through the constant-0 component only
  const bool zlane = lane == Z;
  V g = ZERO, ntbl = 0;
  int p = 0;

  stage_tile(P, c, k, T, 0, TT, tile);
  cp_async_commit();
  for (int t0 = 0, buf = 0; t0 < T; t0 += TT, buf ^= 1) {
    if (t0 + TT < T) {
      stage_tile(P, c, k, T, t0 + TT, TT, tile + (buf ^ 1) * TT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int4* tr = tile + buf * TT;
    if (lane < D) {
      for (int i = 0; i < TT; ++i) {
        const int4 sl = tr[i];
        const int code = sl.x;
        if (code < 0) continue;
        ntbl += tBL;
        if ((code >> 16) != r) continue;
        const int bl = (code & 0xFFFF) - rbase;
        const int rw = sl.z;
        const int o = opn[bl * DL + lane];
        const bool hit = o == rw, empty = o == -1;
        const V av = st[bl * DL + lane];
        const V at = st[(A + bl) * DL + lane];
        const V hp = st[(H + p) * DL + lane];
        const V base = max(zlane ? static_cast<V>(sl.y) : ZERO, av);
        const V floor = max(lastv + tRRD, hp + tFAW);
        const V act = empty ? max(base, floor)
                            : max(max(base, at + tRAS) + tRP, floor);
        const V col = hit ? base : act + tRCD;
        g = max(g, col + tCL + tBL - ntbl);
        if (!hit) {
          opn[bl * DL + lane] = rw;
          st[(A + bl) * DL + lane] = act;
          st[(H + p) * DL + lane] = act;
          p = (p + 1) & 3;
          lastv = act;
        }
        st[bl * DL + lane] = col + tBL;
        if (lane == 0) {
          const int kd = hit ? 0 : (empty ? 1 : 2);
          P.kind[gbase + s0 + t0 + i] = kd;
          rec[t0 + i].w = kd;
        }
      }
    }
    __syncthreads();
  }
  if (lane < D) {
    // stored in the ring's absolute order, which the entry scan fixed, so
    // the carry scan multiplies without rotating
    const int ptr = P.w.ptr_entry[ck * P.R + r];
    auto rot = [&](int x) {
      return x >= H && x < H + 4 ? H + ((ptr + x - H) & 3) : x;
    };
    const long long base = (static_cast<long long>(c) * P.R + r) * P.nK + k;
    long long* col =
        P.w.M + base * D * D + static_cast<long long>(rot(lane)) * D;
    for (int i = 0; i < H + 4; ++i)
      col[rot(i)] = Zero<V>::widen(st[i * DL + lane]);
    col[LAST] = Zero<V>::widen(lastv);
    col[Z] = zlane ? 0 : NEG;
    P.w.G[base * D + rot(lane)] = Zero<V>::widen(g);
  }
}

// One CTA a (chunk, rank).  In int32 where that is exact: with every
// timing parameter >= 0 and T * (their sum + tBL) < 2^26, a finite value
// lies in [-2^26, 2^31) (issues are below MAX_PHASE_ISSUE = 2^31 - 2^26)
// and one that started at -2^30 stays below -2^29; else in int64.
template <int T>
__global__ void transfer_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.x, r = blockIdx.y, c = blockIdx.z;
  const long long ck = static_cast<long long>(c) * P.nK + k;
  const long long s0 = static_cast<long long>(k) * T;
  if (r == 0) {
    const long long gbase = static_cast<long long>(c) * P.L;
    const int4* rec = P.w.rec + static_cast<long long>(c) * P.nK * T + s0;
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      if (s0 + i < P.L && rec[i].x < 0) P.kind[gbase + s0 + i] = -1;
  }
  if (P.w.cnt[ck * P.R + r] == 0) return;
  long long sum = 0;
  bool nonneg = true;
  for (int i = 0; i < 7; ++i) {
    sum += P.timing[i];
    nonneg &= P.timing[i] >= 0;
  }
  if (nonneg && static_cast<long long>(T) * (sum + P.timing[4]) < (1LL << 26))
    transfer_walk<T, int>(P, k, r, c, smem);
  else
    transfer_walk<T, long long>(P, k, r, c, smem);
}

// ---- 4. carry scan -----------------------------------------------------

// The chunks of a (channel, rank) in groups of P.G.  (a) compose_kernel,
// one CTA a group: the group's prefix products P_i = M_i (x) ... (x) M_0,
// each written over M_i (identity where the rank has no slot in the
// chunk).  (b) chain_kernel, one CTA a (channel, rank): s <- P_last (x) s
// group by group, the only serial walk, giving each group's entry state
// and the carry out.  (c) expand_kernel, one CTA a chunk: its entry state
// P_{i-1} (x) s_group and its bus term g_k (x) entry; the channel's last
// CTA to finish turns the bus terms into each chunk's bus on entry (a
// prefix max over the chunks) and the carry's bus_free.
// Matrices are stored column-major: M[j * D + i] is row i, column j.

__device__ __forceinline__ long long identity(int x, int D) {
  return x % (D + 1) == 0 ? 0 : NEG;
}

constexpr int COMPOSE_THREADS = 512;

// Entries (i0..i0+1, j0..j0+1) of the max-plus product of two
// column-major D x D matrices (D even), each at least NEG so that the
// zero never drifts down through a group's products.
__device__ __forceinline__ void product_block(const long long* a,
                                              const long long* b, int D,
                                              int i0, int j0,
                                              long long* q) {
  long long q00 = NEG, q10 = NEG, q01 = NEG, q11 = NEG;
  const long long* b0 = b + j0 * D;
  const long long* b1 = b0 + D;
  for (int l = 0; l < D; ++l) {
    const longlong2 av = *reinterpret_cast<const longlong2*>(a + l * D + i0);
    const long long x0 = b0[l], x1 = b1[l];
    q00 = max(q00, av.x + x0);
    q10 = max(q10, av.y + x0);
    q01 = max(q01, av.x + x1);
    q11 = max(q11, av.y + x1);
  }
  q[j0 * D + i0] = q00;
  q[j0 * D + i0 + 1] = q10;
  q[(j0 + 1) * D + i0] = q01;
  q[(j0 + 1) * D + i0 + 1] = q11;
}

// One CTA a group: P_k = M_k (x) P_{k-1} over the group's chunks, each
// written over M_k; the next chunk's matrix streams in (cp.async) while
// the CTA multiplies.
__global__ void __launch_bounds__(COMPOSE_THREADS) compose_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live[MAX_GROUP];
  const int D = P.D, DD = D * D, nK = P.nK, R = P.R;
  long long* pm = reinterpret_cast<long long*>(smem);   // [DD] prefix
  long long* qm = pm + DD;                              // [DD] product
  long long* mb = qm + DD;                              // [2][DD] M_k
  const int g = blockIdx.x, r = blockIdx.y, c = blockIdx.z, t = threadIdx.x;
  const long long cr = static_cast<long long>(c) * R + r;
  const long long cb = static_cast<long long>(c) * nK;
  const int k0 = g * P.G, k1 = min(nK, k0 + P.G);
  long long* M = P.w.M + cr * nK * DD;
  if (t < k1 - k0) live[t] = P.w.cnt[(cb + k0 + t) * R + r] > 0;
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
  __syncthreads();
  for (int x = t; x < DD; x += blockDim.x) {
    pm[x] = live[0] ? M[static_cast<long long>(k0) * DD + x] : identity(x, D);
    if (!live[0]) M[static_cast<long long>(k0) * DD + x] = pm[x];
  }
  for (int k = k0 + 1; k < k1; ++k) {
    fetch(k + 1);
    cp_async_wait<1>();   // M_k has landed
    __syncthreads();
    long long* mk = M + static_cast<long long>(k) * DD;
    if (live[k - k0]) {
      const long long* mm = mb + (k & 1) * DD;
      const int half = D / 2;
      for (int x = t; x < half * half; x += blockDim.x) {
        const int jb = x / half;
        product_block(mm, pm, D, 2 * (x - jb * half), 2 * jb, qm);
      }
      __syncthreads();
      for (int x = t; x < DD; x += blockDim.x) {
        pm[x] = qm[x];
        mk[x] = qm[x];
      }
    } else {
      for (int x = t; x < DD; x += blockDim.x) mk[x] = pm[x];
    }
    __syncthreads();   // before M_{k+2} lands over M_k
  }
  cp_async_wait<0>();
}

// Four threads a row of M (x) s, each over every fourth column, combined by
// shuffles.  Rows past D give NEG.
__device__ __forceinline__ long long row_times(const long long* m, int D,
                                               int row, int q,
                                               const long long* s) {
  long long acc = NEG, acc2 = NEG;
  if (row < D) {
    int j = q;
    for (; j + 4 < D; j += 8) {
      acc = max(acc, m[j * D + row] + s[j]);
      acc2 = max(acc2, m[(j + 4) * D + row] + s[j + 4]);
    }
    if (j < D) acc = max(acc, m[j * D + row] + s[j]);
  }
  acc = max(acc, acc2);
  acc = max(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
  return max(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
}

// RING groups' products are in flight (cp.async groups) ahead of the
// chain; one __syncthreads a group.
template <int RING>
__global__ void chain_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = P.D, DD = D * D, bpr = P.bpr, nK = P.nK, R = P.R;
  const int nG = (nK + P.G - 1) / P.G;
  long long* ring = reinterpret_cast<long long*>(smem);   // [RING][DD]
  long long* s = ring + RING * DD;                        // [2][D]
  const int r = blockIdx.x, c = blockIdx.y, t = threadIdx.x;
  const int row = t >> 2, q = t & 3;
  const int H = 2 * bpr, LAST = H + 4, Z = H + 5;
  const int rbase = r * bpr;
  const long long cr = static_cast<long long>(c) * R + r;
  if (t < bpr) {
    s[t] = P.avail_in[c * P.B + rbase + t];
    s[bpr + t] = P.act_in[c * P.B + rbase + t];
  } else if (t >= H && t < H + 4) {
    s[t] = P.hist_in[cr * 4 + (t - H)];
  } else if (t == LAST) {
    s[t] = P.last_in[cr];
  } else if (t == Z) {
    s[t] = 0;
  }
  auto fetch = [&](int gi) {
    if (gi < nG) {
      long long* dst = ring + (gi % RING) * DD;
      const long long* m =
          P.w.M + (cr * nK + min(nK, (gi + 1) * P.G) - 1) * DD;
      // D is even, so a matrix is whole 16-byte units
      for (int u = t; u < DD / 2; u += blockDim.x)
        cp_async16(dst + 2 * u, m + 2 * u);
    }
    cp_async_commit();
  };
  for (int gi = 0; gi < RING - 1; ++gi) fetch(gi);
  long long* gentry = P.w.gentry + cr * nG * D;
  for (int gi = 0; gi < nG; ++gi) {
    cp_async_wait<RING - 2>();   // group gi's product has landed
    __syncthreads();
    fetch(gi + RING - 1);
    const long long* cur = s + (gi & 1) * D;
    long long* nxt = s + ((gi + 1) & 1) * D;
    if (t < D) gentry[static_cast<long long>(gi) * D + t] = cur[t];
    const long long acc = row_times(ring + (gi % RING) * DD, D, row, q, cur);
    if (q == 0 && row < D) nxt[row] = acc;
  }
  cp_async_wait<0>();
  __syncthreads();
  const long long* fin = s + (nG & 1) * D;
  if (t < bpr) {
    P.avail_out[c * P.B + rbase + t] = static_cast<int>(fin[t]);
    P.act_out[c * P.B + rbase + t] = static_cast<int>(fin[bpr + t]);
  } else if (t >= H && t < H + 4) {
    P.hist_out[cr * 4 + (t - H)] = static_cast<int>(fin[t]);
  } else if (t == LAST) {
    P.last_out[cr] = static_cast<int>(fin[t]);
  }
}

// One CTA a chunk: its entry state P_{k-1} (x) s_group and its bus term.
__global__ void expand_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long sums[32];
  __shared__ int last_cta;
  const int D = P.D, DD = D * D, nK = P.nK, R = P.R;
  const int nG = (nK + P.G - 1) / P.G;
  long long* pm = reinterpret_cast<long long*>(smem);   // [DD]
  long long* sg = pm + DD;                              // [D]
  long long* se = sg + D;                               // [D]
  const int k = blockIdx.x, r = blockIdx.y, c = blockIdx.z, t = threadIdx.x;
  const int row = t >> 2, q = t & 3;
  const long long cr = static_cast<long long>(c) * R + r;
  const long long cb = static_cast<long long>(c) * nK;
  const int gi = k / P.G, first = k == gi * P.G;
  const long long* g0 = P.w.gentry + (cr * nG + gi) * D;
  for (int x = t; x < D; x += blockDim.x) sg[x] = g0[x];
  if (!first) {
    const long long* m = P.w.M + (cr * nK + k - 1) * DD;
    for (int u = t; u < DD / 2; u += blockDim.x)
      cp_async16(pm + 2 * u, m + 2 * u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!first) {
    const long long acc = row_times(pm, D, row, q, sg);
    if (q == 0 && row < D) se[row] = acc;
  } else if (t < D) {
    se[t] = sg[t];
  }
  __syncthreads();
  if (t < D) P.w.entry[(cr * nK + k) * D + t] = se[t];
  // the bus term g_k (x) entry, four threads over the bus row
  long long hk = NEG;
  if (row == 0 && P.w.cnt[(cb + k) * R + r] > 0) {
    const long long* gk = P.w.G + (cr * nK + k) * D;
    for (int j = q; j < D; j += 4) hk = max(hk, gk[j] + se[j]);
  }
  hk = max(hk, __shfl_xor_sync(0xffffffffu, hk, 1));
  hk = max(hk, __shfl_xor_sync(0xffffffffu, hk, 2));
  if (t == 0) P.w.h[cr * nK + k] = hk;
  // the channel's last CTA: each chunk's bus on entry, and bus_free
  __threadfence();
  __syncthreads();
  if (t == 0) last_cta = atomicAdd(P.w.done + c, 1) == nK * R - 1;
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  const long long tBL = P.timing[4];
  const long long bus = P.bus_in[c];
  const long long top = block_scan(
      nK, NEG,
      [&](int kk) {
        long long x = NEG;
        for (int rr = 0; rr < R; ++rr)
          x = max(x, __ldcg(P.w.h + (static_cast<long long>(c) * R + rr) * nK +
                            kk));
        return x - __ldcg(P.w.nbefore + cb + kk) * tBL;
      },
      [&](int kk, long long x) { P.w.fentry[cb + kk] = max(bus, x); },
      [](long long a, long long b) { return max(a, b); }, sums);
  if (t == 0)
    P.bus_out[c] = static_cast<int>(
        max(bus, top) +
        (P.w.nbefore[cb + nK - 1] + P.w.nvalid[cb + nK - 1]) * tBL);
}

// ---- 5. emit -----------------------------------------------------------

__device__ __forceinline__ int wadd(int a, int b, bool& wrapped) {
  const int r = static_cast<int>(static_cast<unsigned>(a) +
                                 static_cast<unsigned>(b));
  wrapped |= ((a ^ r) & (b ^ r)) < 0;
  return r;
}

// A slot's record and the state it reads, fetched one slot ahead: its
// bank's times, its rank's pointer, last ACT and the ring entries at the
// pointer and one further on.
struct Ahead {
  bool valid;
  int b, rr, kind, issue, av, at, p, hp0, hp1, last;
};

__device__ __forceinline__ Ahead read_ahead(int4 sl, bool on, const int* av,
                                            const int* at, const int* hist,
                                            const int* lastv, const int* ptr,
                                            int NL, int lane) {
  Ahead a;
  a.valid = on && sl.x >= 0;
  a.b = a.valid ? sl.x & 0xFFFF : 0;
  a.rr = a.valid ? sl.x >> 16 : 0;
  a.kind = sl.w;
  a.issue = sl.y;
  a.av = av[a.b * NL + lane];
  a.at = at[a.b * NL + lane];
  a.p = ptr[a.rr * NL + lane] & 3;   // unset where the lane has no chunk
  a.hp0 = hist[(a.rr * 4 + a.p) * NL + lane];
  a.hp1 = hist[(a.rr * 4 + ((a.p + 1) & 3)) * NL + lane];
  a.last = lastv[a.rr * NL + lane];
  return a;
}

// One lane a chunk: the lane walks its chunk once more from the true entry
// state, with the whole channel's state in shared memory (a column a
// lane), and writes each finish.  With the entry state known this is the
// reference step itself, in int32 that wraps as the reference does (the
// slot's hit / empty / conflict read from its record, where the transfer
// put it); a slot where an addition wraps is marked KIND_WRAPPED.  The
// CTA's chunks' records come in tiles of EMIT_TILE slots ([slot][lane],
// cp.async, double-buffered), and the finishes leave through shared
// memory, a chunk's tile at a time.
template <int T>
__global__ void __launch_bounds__(EMIT_LANES) emit_kernel(Params P) {
  constexpr int NL = EMIT_LANES, TS = EMIT_TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) int4 tile[2][TS][NL];
  __shared__ int fin_tile[TS][NL + 1];
  __shared__ int live[NL];
  const int B = P.B, R = P.R, bpr = P.bpr, D = P.D, nK = P.nK;
  const int lane = threadIdx.x;
  int* av = reinterpret_cast<int*>(smem);   // [B][NL]
  int* at = av + B * NL;                    // [B][NL]
  int* hist = at + B * NL;                  // [R*4][NL]
  int* lastv = hist + R * 4 * NL;           // [R][NL]
  int* ptr = lastv + R * NL;                // [R][NL]
  const int c = blockIdx.y, k0 = blockIdx.x * NL;
  const int k = k0 + lane;
  const long long ck = static_cast<long long>(c) * nK + k;
  live[lane] = k < nK && P.w.nvalid[ck] > 0;
  const int tCL = P.timing[0], tRCD = P.timing[1], tRP = P.timing[2];
  const int tRAS = P.timing[3], tBL = P.timing[4], tRRD = P.timing[5];
  const int tFAW = P.timing[6];
  int bus = 0;
  if (live[lane]) {
    for (int rr = 0; rr < R; ++rr) {
      const long long* e =
          P.w.entry + ((static_cast<long long>(c) * R + rr) * nK + k) * D;
      for (int b = 0; b < bpr; ++b) {
        av[(rr * bpr + b) * NL + lane] = static_cast<int>(e[b]);
        at[(rr * bpr + b) * NL + lane] = static_cast<int>(e[bpr + b]);
      }
      for (int u = 0; u < 4; ++u)
        hist[(rr * 4 + u) * NL + lane] = static_cast<int>(e[2 * bpr + u]);
      lastv[rr * NL + lane] = static_cast<int>(e[2 * bpr + 4]);
      ptr[rr * NL + lane] = P.w.ptr_entry[ck * R + rr];
    }
    bus = static_cast<int>(P.w.fentry[ck] + P.w.nbefore[ck] * tBL);
  }
  __syncwarp();
  const int4* rec = P.w.rec + (static_cast<long long>(c) * nK + k0) * T;
  auto stage = [&](int t0, int buf) {
    for (int x = lane; x < NL * TS; x += NL) {
      const int l = x / TS, i = x % TS;
      if (live[l])
        cp_async16(&tile[buf][i][l],
                   rec + static_cast<long long>(l) * T + t0 + i);
    }
    cp_async_commit();
  };
  int* fin = P.finish + static_cast<long long>(c) * P.L;
  signed char* kind = P.kind + static_cast<long long>(c) * P.L;
  stage(0, 0);
  for (int t0 = 0, buf = 0; t0 < T; t0 += TS, buf ^= 1) {
    if (t0 + TS < T) {
      stage(t0 + TS, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    // A slot's state is read while the slot before it is computed; what
    // that slot then writes reaches this one in registers (same bank:
    // its new bank times; same rank after an ACT: the ring one further
    // on, read ahead too, and its ACT time).
    const bool on = live[lane];
    Ahead nx = read_ahead(tile[buf][0][lane], on, av, at, hist, lastv, ptr,
                          NL, lane);
    bool pv = false, pmiss = false;
    int pb = -1, pr = -1, p_av = 0, p_act = 0;
    for (int i = 0; i < TS; ++i) {
      const Ahead cu = nx;
      if (i + 1 < TS)
        nx = read_ahead(tile[buf][i + 1][lane], on, av, at, hist, lastv,
                        ptr, NL, lane);
      if (!cu.valid) {
        fin_tile[i][lane] = 0;
        pv = false;
        continue;
      }
      const int b = cu.b, rr = cu.rr;
      const bool hit = cu.kind == 0, empty = cu.kind == 1;
      const bool same_bank = pv && pb == b;
      const bool advanced = pv && pmiss && pr == rr;
      const int a_v = same_bank ? p_av : cu.av;
      const int a_t = same_bank && pmiss ? p_act : cu.at;
      const int p = advanced ? (cu.p + 1) & 3 : cu.p;
      const int hp = advanced ? cu.hp1 : cu.hp0;
      const int lr = advanced ? p_act : cu.last;
      bool wrapped = false;
      const int base = max(cu.issue, a_v);
      const int x_rp = wadd(max(base, wadd(a_t, tRAS, wrapped)), tRP, wrapped);
      const int floor = max(wadd(lr, tRRD, wrapped), wadd(hp, tFAW, wrapped));
      const int act = empty ? max(base, floor) : max(x_rp, floor);
      const int x_rcd = wadd(act, tRCD, wrapped);
      const int col = hit ? base : x_rcd;
      bus = wadd(max(wadd(col, tCL, wrapped), bus), tBL, wrapped);
      const int c_bl = wadd(col, tBL, wrapped);
      if (wrapped) kind[static_cast<long long>(k) * T + t0 + i] = KIND_WRAPPED;
      if (!hit) {
        at[b * NL + lane] = act;
        hist[(rr * 4 + p) * NL + lane] = act;
        ptr[rr * NL + lane] = (p + 1) & 3;
        lastv[rr * NL + lane] = act;
      }
      av[b * NL + lane] = c_bl;
      fin_tile[i][lane] = bus;
      pv = true;
      pmiss = !hit;
      pb = b;
      pr = rr;
      p_av = c_bl;
      p_act = act;
    }
    __syncwarp();
    for (int x = lane; x < NL * TS; x += NL) {
      const int l = x / TS, i = x % TS;
      const long long slot = static_cast<long long>(k0 + l) * T + t0 + i;
      if (k0 + l < nK && slot < P.L) fin[slot] = fin_tile[i][l];
    }
    __syncwarp();
  }
}

// ---- launch ------------------------------------------------------------

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

int round32(int x) { return (x + 31) / 32 * 32; }

// Allow `bytes` of dynamic shared memory beside the kernel's static share
// (set on every launch: past 48 KB in all it must be asked for).
cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Keep what the pool frees for the next call instead of handing it back
// to the system at every synchronisation.
void keep_pool(int device) {
  static bool done[64] = {};
  if (device < 0 || device >= 64 || done[device]) return;
  cudaMemPool_t pool;
  if (cudaDeviceGetDefaultMemPool(&pool, device) == cudaSuccess) {
    uint64_t keep = UINT64_MAX;
    cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold, &keep);
  }
  done[device] = true;
}

template <int T>
int run(Params P, float* pass_ms, cudaStream_t stream) {
  constexpr int TT = T < TILE ? T : TILE;
  const int C = P.C, B = P.B, R = P.R, D = P.D, bpr = P.bpr;
  const long long nK = P.nK;
  // the workspace, one stream-ordered allocation
  const size_t sizes[] = {
      sizeof(int4) * C * nK * T,    sizeof(int) * C * nK * B,
      sizeof(int) * C * nK * B,     sizeof(int) * C * nK * B,
      sizeof(int) * C * nK * R,     sizeof(int) * C * nK * R,
      sizeof(int) * C * nK,         sizeof(int) * C * nK * B,
      sizeof(int) * C * nK * R,     sizeof(long long) * C * nK,
      sizeof(long long) * C * R * nK * D * D,
      sizeof(long long) * C * R * nK * D,
      sizeof(long long) * C * R * nK * D,
      sizeof(long long) * C * R * nK,
      sizeof(long long) * C * R * ((nK + P.G - 1) / P.G) * D,
      sizeof(long long) * C * nK,   sizeof(int) * C};
  constexpr int N_ARRAYS = sizeof(sizes) / sizeof(sizes[0]);
  size_t offs[N_ARRAYS], total = 0;
  for (int i = 0; i < N_ARRAYS; ++i) {
    offs[i] = total;
    total += align_up(sizes[i]);
  }
  int device = 0;
  cudaGetDevice(&device);
  keep_pool(device);
  char* ws = nullptr;
  cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&ws), total, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  Work& w = P.w;
  w.rec = reinterpret_cast<int4*>(ws + offs[0]);
  w.has = reinterpret_cast<int*>(ws + offs[1]);
  w.first = reinterpret_cast<int*>(ws + offs[2]);
  w.last = reinterpret_cast<int*>(ws + offs[3]);
  w.acts = reinterpret_cast<int*>(ws + offs[4]);
  w.cnt = reinterpret_cast<int*>(ws + offs[5]);
  w.nvalid = reinterpret_cast<int*>(ws + offs[6]);
  w.open_entry = reinterpret_cast<int*>(ws + offs[7]);
  w.ptr_entry = reinterpret_cast<int*>(ws + offs[8]);
  w.nbefore = reinterpret_cast<long long*>(ws + offs[9]);
  w.M = reinterpret_cast<long long*>(ws + offs[10]);
  w.G = reinterpret_cast<long long*>(ws + offs[11]);
  w.entry = reinterpret_cast<long long*>(ws + offs[12]);
  w.h = reinterpret_cast<long long*>(ws + offs[13]);
  w.gentry = reinterpret_cast<long long*>(ws + offs[14]);
  w.fentry = reinterpret_cast<long long*>(ws + offs[15]);
  w.done = reinterpret_cast<int*>(ws + offs[16]);

  const int DL = round32(D);
  const int threads4 = round32(4 * (D + 1));
  const size_t smem1 = sizeof(int) * 5 * B * SEGS;
  const size_t smem3 = sizeof(long long) * (2 * bpr + 4) * DL +
                       sizeof(int4) * 2 * TT + sizeof(int) * bpr * DL;
  const size_t smem_compose = sizeof(long long) * 4 * D * D;
  // the chain keeps 8 groups' products in flight where they fit, else 2
  const auto smem_chain_for = [&](int ring) {
    return sizeof(long long) * (ring * D * D + 2 * D);
  };
  const bool deep = smem_chain_for(8) <= 160 * 1024;
  const size_t smem_chain = smem_chain_for(deep ? 8 : 2);
  const void* chain = deep ? reinterpret_cast<const void*>(chain_kernel<8>)
                           : reinterpret_cast<const void*>(chain_kernel<2>);
  const size_t smem_expand = sizeof(long long) * (D * D + 2 * D);
  const size_t smem5 = sizeof(int) * (2 * B + 6 * R) * EMIT_LANES;
  if ((e = allow_smem(reinterpret_cast<const void*>(summary_kernel<T>),
                      smem1)) != cudaSuccess ||
      (e = allow_smem(reinterpret_cast<const void*>(transfer_kernel<T>),
                      smem3)) != cudaSuccess ||
      (e = allow_smem(reinterpret_cast<const void*>(compose_kernel),
                      smem_compose)) != cudaSuccess ||
      (e = allow_smem(chain, smem_chain)) != cudaSuccess ||
      (e = allow_smem(reinterpret_cast<const void*>(expand_kernel),
                      smem_expand)) != cudaSuccess ||
      (e = allow_smem(reinterpret_cast<const void*>(emit_kernel<T>), smem5)) !=
          cudaSuccess) {
    cudaFreeAsync(ws, stream);
    return static_cast<int>(e);
  }
  constexpr int N_LAUNCHES = 7;
  cudaEvent_t ev[N_LAUNCHES + 1];
  if (pass_ms)
    for (int i = 0; i <= N_LAUNCHES; ++i) cudaEventCreate(&ev[i]);
  auto mark = [&](int i) {
    if (pass_ms) cudaEventRecord(ev[i], stream);
  };
  mark(0);
  summary_kernel<T><<<dim3(static_cast<unsigned>(nK), C), 128, smem1,
                      stream>>>(P);
  mark(1);
  entry_kernel<<<C, ENTRY_THREADS, 0, stream>>>(P);
  mark(2);
  transfer_kernel<T><<<dim3(static_cast<unsigned>(nK), R, C), DL, smem3,
                       stream>>>(P);
  mark(3);
  const unsigned groups = static_cast<unsigned>((nK + P.G - 1) / P.G);
  compose_kernel<<<dim3(groups, R, C), COMPOSE_THREADS, smem_compose,
                   stream>>>(P);
  mark(4);
  if (deep)
    chain_kernel<8><<<dim3(R, C), threads4, smem_chain, stream>>>(P);
  else
    chain_kernel<2><<<dim3(R, C), threads4, smem_chain, stream>>>(P);
  mark(5);
  expand_kernel<<<dim3(static_cast<unsigned>(nK), R, C), threads4,
                  smem_expand, stream>>>(P);
  mark(6);
  emit_kernel<T><<<dim3(static_cast<unsigned>((nK + EMIT_LANES - 1) /
                                              EMIT_LANES),
                        C),
                   EMIT_LANES, smem5, stream>>>(P);
  mark(7);
  e = cudaGetLastError();
  cudaFreeAsync(ws, stream);
  if (pass_ms) {
    cudaEventSynchronize(ev[N_LAUNCHES]);
    for (int i = 0; i < N_LAUNCHES; ++i)
      cudaEventElapsedTime(pass_ms + i, ev[i], ev[i + 1]);
    for (int i = 0; i <= N_LAUNCHES; ++i) cudaEventDestroy(ev[i]);
  }
  return static_cast<int>(e);
}

}  // namespace

// The chunked scan with chunks of T slots (64, 128, 256, 512, 1024, 2048
// or 4096), composed in groups of G chunks (1 to MAX_GROUP; 1 makes the
// carry scan one serial walk over the chunks); when `pass_ms` is not
// null, the seven launches (summary, entry scan, transfer, compose, chain,
// expand, emit) are timed with CUDA events and their milliseconds written
// there (float[7]) after a synchronisation.
extern "C" int repro_dram_timing_chunks(
    const void* issue, const void* bank, const void* row, const void* valid,
    const void* timing, const void* open_in, const void* act_in,
    const void* avail_in, const void* bus_in, const void* hist_in,
    const void* ptr_in, const void* last_in, void* finish, void* kind,
    void* open_out, void* act_out, void* avail_out, void* bus_out,
    void* hist_out, void* ptr_out, void* last_out, int C, long long L, int B,
    int R, int banks_per_rank, int T, int G, void* pass_ms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > MAX_GROUP) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) {
    // no slot: the carry passes through
    const size_t cb = sizeof(int) * C * B, cr = sizeof(int) * C * R;
    const void* in[] = {open_in, act_in, avail_in, bus_in,
                        hist_in, ptr_in, last_in};
    void* out[] = {open_out, act_out, avail_out, bus_out,
                   hist_out, ptr_out, last_out};
    const size_t bytes[] = {cb, cb, cb, sizeof(int) * C, 4 * cr, cr, cr};
    for (int i = 0; i < 7; ++i) {
      cudaError_t e =
          cudaMemcpyAsync(out[i], in[i], bytes[i], cudaMemcpyDeviceToDevice, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  Params P;
  P.issue = static_cast<const int*>(issue);
  P.bank = static_cast<const int*>(bank);
  P.row = static_cast<const int*>(row);
  P.valid = static_cast<const unsigned char*>(valid);
  P.timing = static_cast<const int*>(timing);
  P.open_in = static_cast<const int*>(open_in);
  P.act_in = static_cast<const int*>(act_in);
  P.avail_in = static_cast<const int*>(avail_in);
  P.bus_in = static_cast<const int*>(bus_in);
  P.hist_in = static_cast<const int*>(hist_in);
  P.ptr_in = static_cast<const int*>(ptr_in);
  P.last_in = static_cast<const int*>(last_in);
  P.finish = static_cast<int*>(finish);
  P.kind = static_cast<signed char*>(kind);
  P.open_out = static_cast<int*>(open_out);
  P.act_out = static_cast<int*>(act_out);
  P.avail_out = static_cast<int*>(avail_out);
  P.bus_out = static_cast<int*>(bus_out);
  P.hist_out = static_cast<int*>(hist_out);
  P.ptr_out = static_cast<int*>(ptr_out);
  P.last_out = static_cast<int*>(last_out);
  P.L = L;
  P.C = C;
  P.B = B;
  P.R = R;
  P.bpr = banks_per_rank;
  P.D = 2 * banks_per_rank + 6;
  P.nK = static_cast<int>((L + T - 1) / T);
  P.G = G;
  float* ms = static_cast<float*>(pass_ms);
  switch (T) {
    case 64: return run<64>(P, ms, s);
    case 128: return run<128>(P, ms, s);
    case 256: return run<256>(P, ms, s);
    case 512: return run<512>(P, ms, s);
    case 1024: return run<1024>(P, ms, s);
    case 2048: return run<2048>(P, ms, s);
    case 4096: return run<4096>(P, ms, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Chunk length for a [C, L] phase of R ranks a channel.  The emit walks a
// chunk on one lane, so its time grows with T; the carry scan's products
// and entry states grow with the chunks' number.  512 was the fastest on
// the dynamic path's full phases (chip_smoke.py's ms_by_chunk_len); short
// phases take short chunks so that they still split.
extern "C" int repro_dram_timing_chunk_len(int C, long long L, int R) {
  (void)C;
  (void)R;
  return L > 16384 ? 512 : (L > 2048 ? 128 : 64);
}

extern "C" int repro_dram_timing(
    const void* issue, const void* bank, const void* row, const void* valid,
    const void* timing, const void* open_in, const void* act_in,
    const void* avail_in, const void* bus_in, const void* hist_in,
    const void* ptr_in, const void* last_in, void* finish, void* kind,
    void* open_out, void* act_out, void* avail_out, void* bus_out,
    void* hist_out, void* ptr_out, void* last_out, int C, long long L, int B,
    int R, int banks_per_rank, void* stream) {
  return repro_dram_timing_chunks(
      issue, bank, row, valid, timing, open_in, act_in, avail_in, bus_in,
      hist_in, ptr_in, last_in, finish, kind, open_out, act_out, avail_out,
      bus_out, hist_out, ptr_out, last_out, C, L, B, R, banks_per_rank,
      repro_dram_timing_chunk_len(C, L, R), DEFAULT_GROUP, nullptr, stream);
}
