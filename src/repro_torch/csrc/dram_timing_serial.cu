// Per-channel DRAM timing scan of one phase, one lane a channel: the
// serial route of csrc/dram_timing.cu (wrapper dram_timing_serial), kept
// as the kernel the chunked scan is held against on the paths' full
// phases.  No path calls it.
//
// Replaces the Pallas TPU kernel dram_timing_kernel
// (src/repro/kernels/dram_timing/kernel.py:117, body _kernel at :51).
// Its semantics are the JAX scan step _request_step
// (src/repro/core/vectorized.py:227-276), followed here literally and
// bit-exactly, with int32 arithmetic that wraps as XLA's does.  Unlike
// the Pallas kernel, which always starts cold, this one takes the
// channel carry in and returns it, because VectorizedDRAM.run_phase
// chains phases on one memory timeline.
//
// What it computes.  Each channel is an independent bank-state machine
// serving its [L] request stream in order.  Per valid slot: hit/empty
// from the bank's open row; the ACT time under tRP/tRAS and the rank's
// tRRD/tFAW window (the 4-deep ACT history ring); col = hit ? base :
// act + tRCD; finish = max(col + tCL, bus_free) + tBL.  Invalid slots
// leave the state untouched and emit (finish 0, kind -1).
//
// What bounds it.  By bytes: 13 B in (issue, bank, row, valid) and 5 B
// out (finish, kind) per slot, plus the carry, over 3.35 TB/s: well under
// a millisecond for the largest dynamic-path phase.  In practice: the
// dependent chain of one request (bank state, rank history, bus) times
// L, because slot l+1 reads the state slot l wrote; within a channel
// nothing lets two requests overlap.
//
// What the design does about it.  One CTA (one warp) per channel, so the
// channels run side by side on separate SMs.  The channel's bank and
// rank state lives in shared memory for the whole stream and the bus
// time in a register of lane 0, which walks the slots in order.  The
// warp stages TILE slots at a time into shared memory with coalesced
// loads, and writes the tile's finishes and kinds back the same way, so
// lane 0's chain touches only shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;
constexpr int WARP = 32;

// int32 add that wraps like XLA's (signed overflow is undefined in C++,
// so the arithmetic goes through unsigned).
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void dram_timing_serial_kernel(
    const int* __restrict__ issue, const int* __restrict__ bank,
    const int* __restrict__ row, const unsigned char* __restrict__ valid,
    const int* __restrict__ timing,
    const int* __restrict__ open_in, const int* __restrict__ act_in,
    const int* __restrict__ avail_in, const int* __restrict__ bus_in,
    const int* __restrict__ hist_in, const int* __restrict__ ptr_in,
    const int* __restrict__ last_in,
    int* __restrict__ finish, signed char* __restrict__ kind,
    int* __restrict__ open_out, int* __restrict__ act_out,
    int* __restrict__ avail_out, int* __restrict__ bus_out,
    int* __restrict__ hist_out, int* __restrict__ ptr_out,
    int* __restrict__ last_out, long long L, int B, int R,
    int banks_per_rank) {
  extern __shared__ int smem[];
  int* s_open = smem;             // [B]
  int* s_act = s_open + B;        // [B]
  int* s_avail = s_act + B;       // [B]
  int* s_hist = s_avail + B;      // [R, 4]
  int* s_ptr = s_hist + R * 4;    // [R]
  int* s_last = s_ptr + R;        // [R]
  __shared__ int t_issue[TILE], t_bank[TILE], t_row[TILE], t_fin[TILE];
  __shared__ unsigned char t_valid[TILE];
  __shared__ signed char t_kind[TILE];

  const int c = blockIdx.x;
  const int lane = threadIdx.x;
  for (int i = lane; i < B; i += WARP) {
    s_open[i] = open_in[c * B + i];
    s_act[i] = act_in[c * B + i];
    s_avail[i] = avail_in[c * B + i];
  }
  for (int i = lane; i < R * 4; i += WARP) s_hist[i] = hist_in[c * R * 4 + i];
  for (int i = lane; i < R; i += WARP) {
    s_ptr[i] = ptr_in[c * R + i];
    s_last[i] = last_in[c * R + i];
  }
  const int tCL = timing[0], tRCD = timing[1], tRP = timing[2];
  const int tRAS = timing[3], tBL = timing[4], tRRD = timing[5];
  const int tFAW = timing[6];
  int bus = bus_in[c];
  __syncwarp();

  const long long base = static_cast<long long>(c) * L;
  for (long long t0 = 0; t0 < L; t0 += TILE) {
    const int n = static_cast<int>(L - t0 < TILE ? L - t0 : TILE);
    for (int i = lane; i < n; i += WARP) {
      const long long o = base + t0 + i;
      t_issue[i] = issue[o];
      t_bank[i] = bank[o];
      t_row[i] = row[o];
      t_valid[i] = valid[o];
    }
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        if (!t_valid[i]) {
          t_fin[i] = 0;
          t_kind[i] = -1;
          continue;
        }
        const int b = t_bank[i];
        const int r = t_row[i];
        const int rank = b / banks_per_rank;
        const int o = s_open[b];
        const int at = s_act[b];
        const bool hit = o == r;
        const bool empty = o == -1;
        const int bse = max(t_issue[i], s_avail[b]);
        // ACT rate limits per rank (tRRD, tFAW over the 4th-last ACT)
        const int p = s_ptr[rank];
        const int act_floor =
            max(wadd(s_last[rank], tRRD), wadd(s_hist[rank * 4 + p], tFAW));
        const int act =
            empty ? max(bse, act_floor)
                  : max(wadd(max(bse, wadd(at, tRAS)), tRP), act_floor);
        const int col = hit ? bse : wadd(act, tRCD);
        const int fin = wadd(max(wadd(col, tCL), bus), tBL);
        if (!hit) {
          s_open[b] = r;
          s_act[b] = act;
          s_hist[rank * 4 + p] = act;
          s_ptr[rank] = (p + 1) & 3;
          s_last[rank] = act;
        }
        s_avail[b] = wadd(col, tBL);
        bus = fin;
        t_fin[i] = fin;
        t_kind[i] = hit ? 0 : (empty ? 1 : 2);
      }
    }
    __syncwarp();
    for (int i = lane; i < n; i += WARP) {
      finish[base + t0 + i] = t_fin[i];
      kind[base + t0 + i] = t_kind[i];
    }
    __syncwarp();
  }

  for (int i = lane; i < B; i += WARP) {
    open_out[c * B + i] = s_open[i];
    act_out[c * B + i] = s_act[i];
    avail_out[c * B + i] = s_avail[i];
  }
  for (int i = lane; i < R * 4; i += WARP) hist_out[c * R * 4 + i] = s_hist[i];
  for (int i = lane; i < R; i += WARP) {
    ptr_out[c * R + i] = s_ptr[i];
    last_out[c * R + i] = s_last[i];
  }
  if (lane == 0) bus_out[c] = bus;
}

}  // namespace

extern "C" int repro_dram_timing_serial(
    const void* issue, const void* bank, const void* row, const void* valid,
    const void* timing, const void* open_in, const void* act_in,
    const void* avail_in, const void* bus_in, const void* hist_in,
    const void* ptr_in, const void* last_in, void* finish, void* kind,
    void* open_out, void* act_out, void* avail_out, void* bus_out,
    void* hist_out, void* ptr_out, void* last_out, int C, long long L, int B,
    int R, int banks_per_rank, void* stream) {
  const size_t smem = static_cast<size_t>(3 * B + 6 * R) * sizeof(int);
  if (smem > 32 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        dram_timing_serial_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dram_timing_serial_kernel<<<C, WARP, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(issue), static_cast<const int*>(bank),
      static_cast<const int*>(row), static_cast<const unsigned char*>(valid),
      static_cast<const int*>(timing), static_cast<const int*>(open_in),
      static_cast<const int*>(act_in), static_cast<const int*>(avail_in),
      static_cast<const int*>(bus_in), static_cast<const int*>(hist_in),
      static_cast<const int*>(ptr_in), static_cast<const int*>(last_in),
      static_cast<int*>(finish), static_cast<signed char*>(kind),
      static_cast<int*>(open_out), static_cast<int*>(act_out),
      static_cast<int*>(avail_out), static_cast<int*>(bus_out),
      static_cast<int*>(hist_out), static_cast<int*>(ptr_out),
      static_cast<int*>(last_out), L, B, R, banks_per_rank);
  return static_cast<int>(cudaGetLastError());
}
