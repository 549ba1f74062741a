// LRU lookup of a read stream through a set-associative on-chip cache.
//
// Replaces the XLA lax.scan _lookup_scan (src/repro/core/cache.py:257;
// not a Pallas kernel) and its NumPy twin _lookup_numpy (:229).  Input:
// the reads of a stream sorted stably by set, as CSR segments (seg_ptr,
// one segment a touched set, program order kept inside each), each read's
// tag and its position in program order, and the touched sets' [U, W]
// tags and LRU ages.  Output: the per-read hit flag in program order; the
// state rows are updated in place.  The LRU rules are the reference's:
// on a hit, the ways younger than the hit way age by one and the hit way
// becomes age 0; on a miss every way ages by one and the oldest way (the
// largest age; ages stay a permutation of 0..W-1) takes the tag at age 0.
// Ties, which a permutation never has, break to the lowest way, as
// argmax does.
//
// What bounds it.  By bytes: each read's tag (8 B), position (4 B) and
// hit flag (1 B) once, and the touched rows of the state read and written
// once; tens of microseconds for millions of reads over 3.35 TB/s.  In
// practice: the chain of dependent steps in the longest segment (the
// hottest set), one ballot-and-shuffle step a read.
//
// What the design does about it.  Sets are independent, so one warp walks
// one set's segment in order: the set's ways sit on the lanes (way
// g * 32 + lane in register slot g of that lane, G = ceil(W / 32) slots),
// a match is one ballot a slot, the victim is found by a warp max of the
// ages and a ballot, and the whole update is register arithmetic.  The
// warp loads 32 reads' tags and positions at a time, coalesced, and
// writes their 32 hit flags after serving them.  No dense [L, U] column
// matrix is built, so a skewed stream costs its hottest set's length in
// steps and nothing more.  Tags are int64 throughout.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;

template <int G>
__global__ void cache_lookup_kernel(const long long* __restrict__ seg_ptr,
                                    const long long* __restrict__ tag,
                                    const int* __restrict__ pos,
                                    long long* __restrict__ tags,
                                    long long* __restrict__ age,
                                    unsigned char* __restrict__ hit, int U,
                                    int W) {
  const int set = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (set >= U) return;
  long long t[G];
  int a[G];
  bool own[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int w = g * 32 + lane;
    own[g] = w < W;
    t[g] = own[g] ? tags[static_cast<long long>(set) * W + w] : -1;
    a[g] = own[g] ? static_cast<int>(age[static_cast<long long>(set) * W + w])
                  : -1;
  }
  const long long b = seg_ptr[set], e = seg_ptr[set + 1];
  for (long long base = b; base < e; base += 32) {
    const int n = static_cast<int>(min(32LL, e - base));
    const long long my_tag = lane < n ? tag[base + lane] : 0;
    const int my_pos = lane < n ? pos[base + lane] : 0;
    unsigned char my_hit = 0;
    for (int j = 0; j < n; ++j) {
      const long long cur = __shfl_sync(kFull, my_tag, j);
      // the first way holding the tag (at most one does)
      int tg = -1, tl = 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const unsigned m = __ballot_sync(kFull, own[g] && t[g] == cur);
        if (tg < 0 && m) {
          tg = g;
          tl = __ffs(m) - 1;
        }
      }
      const bool h = tg >= 0;
      int thresh;
      if (h) {
        int mine = 0;
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (g == tg) mine = a[g];
        thresh = __shfl_sync(kFull, mine, tl);
      } else {
        // the victim: the first way holding the largest age
        int mx = -1;
#pragma unroll
        for (int g = 0; g < G; ++g) mx = max(mx, a[g]);
        mx = __reduce_max_sync(kFull, mx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const unsigned m = __ballot_sync(kFull, own[g] && a[g] == mx);
          if (tg < 0 && m) {
            tg = g;
            tl = __ffs(m) - 1;
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
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (!own[g]) continue;
    const long long i = static_cast<long long>(set) * W + g * 32 + lane;
    tags[i] = t[g];
    age[i] = a[g];
  }
}

template <int G>
cudaError_t launch(const long long* seg_ptr, const long long* tag,
                   const int* pos, long long* tags, long long* age,
                   unsigned char* hit, int U, int W, cudaStream_t stream) {
  const int blocks = (U + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cache_lookup_kernel<G><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      seg_ptr, tag, pos, tags, age, hit, U, W);
  return cudaGetLastError();
}

}  // namespace

// The largest associativity the kernel takes (32 register slots a lane).
extern "C" int repro_cache_lookup_max_ways() { return 32 * 32; }

extern "C" int repro_cache_lookup(const void* seg_ptr, const void* tag,
                                  const void* pos, void* tags, void* age,
                                  void* hit, int U, int W, void* stream) {
  if (U <= 0) return 0;
  auto* sp = static_cast<const long long*>(seg_ptr);
  auto* tg = static_cast<const long long*>(tag);
  auto* ps = static_cast<const int*>(pos);
  auto* ts = static_cast<long long*>(tags);
  auto* ag = static_cast<long long*>(age);
  auto* ht = static_cast<unsigned char*>(hit);
  auto* st = static_cast<cudaStream_t>(stream);
  const int G = (W + 31) / 32;
  cudaError_t err;
  if (G <= 1) err = launch<1>(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (G <= 2) err = launch<2>(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (G <= 4) err = launch<4>(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (G <= 8) err = launch<8>(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (G <= 16) err = launch<16>(sp, tg, ps, ts, ag, ht, U, W, st);
  else if (G <= 32) err = launch<32>(sp, tg, ps, ts, ag, ht, U, W, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
