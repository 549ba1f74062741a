"""The DRAM-timing model's carry, stream formats and serves.

The entry points, as in the JAX package:

* :func:`simulate_packed` — one phase over per-channel ``[C, L]``
  streams, one request per channel per slot, carry in and out (the
  per-phase path behind ``VectorizedDRAM.run_phase``);
* :func:`fused_scan` — a whole multi-phase program over blocked
  ``[S, C, K]`` lockstep streams: a step retires up to K row hits per
  channel, or one miss, and phase barriers are honored inside the serve
  by re-basing the carry at each segment boundary;
* :func:`simulate_trace_device` — a whole trace from a cold carry, the
  drop-in counterpart of :func:`repro_torch.core.timing.simulate_trace`
  (one :func:`simulate_packed` call);
* :func:`fused_scan_batch` — M cases of one shape from cold carries (M
  stacked programs, or one shared program against M timing vectors), the
  sweep's batched serve.

Each runs as one launch of a hand-written CUDA kernel on the card, or as
its plain torch version on the CPU (see
``repro_torch.kernels.dram_timing``); which one is decided by the device
the streams are put on.

Cycle math is int32: each *phase* must satisfy ``max_cycles < 2**31``
(asserted); the serve re-bases at every barrier, so whole runs of
arbitrary length are fine.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import timing as timing_mod
from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig, DRAMTiming
from repro_torch.core.trace import Trace, group_ranks
from repro_torch.device import resolve_device, wait

NEG_INF32 = -(1 << 30)

#: per-phase relative issue cycles must stay below this (int32 headroom)
MAX_PHASE_ISSUE = 2**31 - 2**26

TIMING_FIELDS = ("tCL", "tRCD", "tRP", "tRAS", "tBL", "tRRD", "tFAW")

#: lanes per block in the fused serve (requests per channel per step);
#: hit-heavy programs use wide blocks, conflict-heavy ones serialize.
BLOCK_LANES = 8


def choose_block_lanes(n_miss: int, n: int) -> int:
    """Block-width rule (exact integer threshold): hit-dominated streams
    (<1/2 misses) get 8 lanes, conflict-heavy ones serialize."""
    return BLOCK_LANES if 2 * n_miss < n else 1


def timing_params(t: DRAMTiming) -> np.ndarray:
    """Timing parameters as the int32[7] the serve consumes."""
    return np.array([getattr(t, f) for f in TIMING_FIELDS], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class PackedChannels:
    """Per-channel padded request streams + scatter metadata."""

    issue: np.ndarray        # int32[C, L]
    bank: np.ndarray         # int32[C, L]
    row: np.ndarray          # int32[C, L]
    valid: np.ndarray        # bool[C, L]
    scatter_index: np.ndarray  # int64[C, L] -> position in original trace


def pack_streams(ch: np.ndarray, issue: np.ndarray, bank: np.ndarray,
                 row: np.ndarray, channels: int, length: int):
    """Scatter program-order request components into padded per-channel
    streams (one stable argsort).

    Returns ``(issue[C, L] int32, bank[C, L] int32, row[C, L] int32,
    valid[C, L] bool, slot[n] int64)`` where ``slot`` is each request's
    position within its channel stream.
    """
    counts = np.bincount(ch, minlength=channels)
    slot = group_ranks(counts, ch)
    issue_p = np.zeros((channels, length), dtype=np.int32)
    bank_p = np.zeros((channels, length), dtype=np.int32)
    row_p = np.zeros((channels, length), dtype=np.int32)
    valid_p = np.zeros((channels, length), dtype=bool)
    issue_p[ch, slot] = issue
    bank_p[ch, slot] = bank
    row_p[ch, slot] = row
    valid_p[ch, slot] = True
    return issue_p, bank_p, row_p, valid_p, slot


def pack_channels(trace: Trace, cfg: DRAMConfig) -> PackedChannels:
    """Split a program-order trace into per-channel padded streams."""
    comps = cfg.decode_lines(trace.line_addr)
    ch = comps["channel"]
    C = cfg.channels
    counts = np.bincount(ch, minlength=C)
    L = max(int(counts.max()) if len(trace) else 0, 1)
    if np.any(trace.issue < 0) or np.any(trace.issue >= MAX_PHASE_ISSUE):
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    issue, bank, row, valid, slot = pack_streams(
        ch, trace.issue, comps["bank_in_channel"], comps["row"], C, L)
    scatter = np.zeros((C, L), dtype=np.int64)
    scatter[ch, slot] = np.arange(len(trace), dtype=np.int64)
    return PackedChannels(issue, bank, row, valid, scatter)


def simulate_packed(issue, bank, row, valid, timing, carry):
    """Serve one phase of per-channel ``[C, L]`` streams from ``carry``
    (the 7-tuple :func:`init_channel_carry` builds, on the streams'
    device): NumPy or torch inputs go to ``carry``'s device and through
    one ``dram_timing`` call — the CUDA kernel on the card, the plain
    version on the CPU.  Returns ``(finish int32[C, L], kind int8[C, L],
    carry)`` on that device; invalid slots give ``(0, -1)``."""
    from repro_torch.kernels.dram_timing.ops import dram_timing
    device = carry[0].device

    def to(a, dtype):
        return torch.as_tensor(a, device=device).to(dtype).contiguous()

    return dram_timing(to(issue, torch.int32), to(bank, torch.int32),
                       to(row, torch.int32), to(valid, torch.bool),
                       to(timing, torch.int32), tuple(carry))


def init_channel_carry(channels: int, n_banks: int, banks_per_rank: int,
                       device):
    """Cold per-channel DRAM state, leading channel axis: ``(open_row,
    act_time, bank_avail, bus_free, act_hist, act_ptr, last_act_rank)``."""
    n_ranks = n_banks // banks_per_rank
    C = channels
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.full((C, n_banks), -1, **i32),               # open_row
        torch.full((C, n_banks), NEG_INF32, **i32),        # act_time
        torch.zeros((C, n_banks), **i32),                  # bank_avail
        torch.zeros((C,), **i32),                          # bus_free
        torch.full((C, n_ranks, 4), NEG_INF32, **i32),     # act_hist
        torch.zeros((C, n_ranks), **i32),                  # act_ptr
        torch.full((C, n_ranks), NEG_INF32, **i32),        # last_act_rank
    )


def rebase_carry(carry, shift: int):
    """Shift all time-like carry components ``shift`` cycles into the past,
    clamped at ``NEG_INF32`` (overflow-safe: ``max(t, shift + NEG_INF32) -
    shift``).  The service recurrence is shift-equivariant, so a re-based
    carry is bit-equivalent to an absolute-time one."""
    (open_row, act_time, bank_avail, bus_free,
     act_hist, act_ptr, last_act_rank) = carry
    shift = torch.tensor(shift, dtype=torch.int32, device=act_time.device)

    def sh(x):
        return torch.maximum(x, shift + NEG_INF32) - shift

    return (open_row, sh(act_time), sh(bank_avail), sh(bus_free),
            sh(act_hist), act_ptr, sh(last_act_rank))


def init_lean_carry(channels: int, n_banks: int, banks_per_rank: int,
                    device):
    """Cold fused-serve carry: ``(avail[C,B], act[C,B], bus[C],
    act_hist[C,R,4], act_ptr[C,R])``.  ``last_act`` is not carried — it is
    always ``act_hist[ptr - 1]`` (the most recent push)."""
    n_ranks = n_banks // banks_per_rank
    C = channels
    i32 = dict(dtype=torch.int32, device=device)
    return (
        torch.zeros((C, n_banks), **i32),                  # bank_avail
        torch.full((C, n_banks), NEG_INF32, **i32),        # act_time
        torch.zeros((C,), **i32),                          # bus_free
        torch.full((C, n_ranks, 4), NEG_INF32, **i32),     # act_hist
        torch.zeros((C, n_ranks), **i32),                  # act_ptr
    )


def lean_from_full(carry):
    """Per-channel carry -> fused-serve carry (drops ``open_row`` —
    tracked by the pack — and ``last_act_rank`` — derivable from the history)."""
    (open_row, act_time, bank_avail, bus_free,
     act_hist, act_ptr, last_act_rank) = carry
    return (bank_avail, act_time, bus_free, act_hist,
            act_ptr.to(torch.int32))


def full_from_lean(lean, open_row):
    """Inverse of :func:`lean_from_full`; ``open_row`` is the int[C, B]
    row state the pack tracked (a host array, or a device pack's
    tensor)."""
    avail, act, bus, hist, ptr = lean
    last = torch.gather(hist, 2, torch.remainder(ptr + 3, 4)[..., None]
                        .long())[..., 0]
    open_row = torch.as_tensor(open_row, device=avail.device).to(
        torch.int32)
    return (open_row, act, avail, bus, hist, ptr, last)


#: bit layout of the packed per-request metadata word (``meta`` stream):
#: bits 0..7 bank-in-channel, 8 miss, 9 conflict, 10 valid,
#: 11..15 bank-rank within the block (for the in-step hit chain).
META_MISS, META_CONFL, META_VALID = 1 << 8, 1 << 9, 1 << 10
META_RB_SHIFT = 11
META_RB_MASK = 0x1F


def pack_meta(bank: np.ndarray, miss: np.ndarray, confl: np.ndarray,
              valid: np.ndarray, bank_rank=None) -> np.ndarray:
    """Fuse the per-request metadata into one int32 stream."""
    meta = np.asarray(bank, dtype=np.int32).copy()
    meta |= np.asarray(miss, dtype=np.int32) << 8
    meta |= np.asarray(confl, dtype=np.int32) << 9
    meta |= np.asarray(valid, dtype=np.int32) << 10
    if bank_rank is not None:
        meta |= np.asarray(bank_rank, dtype=np.int32) << META_RB_SHIFT
    return meta


#: the JAX package's scan-chunk sizes.  The port serves a program in one
#: launch, but pads programs to the same lengths so that packed programs
#: (and the carry after the padded tail) equal the JAX package's.
CHUNK_LADDER = (1 << 13, 1 << 17)


def plan_chunks(n_steps: int):
    """Greedy chunk plan covering ``n_steps``: large chunks, then small
    ones (the tail pads to at most ``CHUNK_LADDER[0]`` wasted steps)."""
    small, large = CHUNK_LADDER
    n_large, rem = divmod(n_steps, large)
    n_small = -(-rem // small) if rem else 0
    return [large] * n_large + [small] * n_small


# ---------------------------------------------------------------------------
# Device-resident program packing: address decode, row-kind
# classification, block decomposition and the lockstep scatter as torch
# code on the streams' device, equal to the host packer
# (``repro_torch.core.accel.pack_program``) array for array.
#
# Requests pad to the next power of two and phases to the next power of
# two, as in the JAX package, so the per-phase reductions keep its shapes.
# Everything is int32 (line addresses and issue cycles are range-checked on
# the host first).  Where the JAX code scatters with ``mode="drop"``, each
# target here has one spare bin past its end that takes the dropped
# updates and is sliced off; a negative index wraps, as it does in JAX.
# ---------------------------------------------------------------------------

def _decode_device(line, spec, banks):
    """Shift/mask decode of int32 line addresses (pow2 sizes only;
    mirrors ``DRAMConfig.decode_lines``)."""
    comps = {}
    for comp, shift, mask in spec:
        comps[comp] = (line >> shift) & mask
    comps["bank_in_channel"] = comps["rank"] * banks + comps["bank"]
    return comps


def _shift1(x, fill):
    """``x`` moved one place later, ``fill`` in front."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def _cumsum32(x):
    return torch.cumsum(x, 0, dtype=torch.int32)


def _carry_forward(flag, values):
    """At each position, ``values`` at the latest position at or before it
    where ``flag`` holds (``flag[0]`` must hold): the running max the JAX
    package takes with ``cummax``, as one gather and one scatter."""
    seg = (_cumsum32(flag.to(torch.int32)) - 1).long()
    n = flag.shape[0]
    at_start = torch.empty(n + 1, dtype=values.dtype, device=values.device)
    at_start[torch.where(flag, seg, n)] = values
    return at_start[seg]


def _range_sums(x, offsets):
    """``x[offsets[p]:offsets[p + 1]].sum()`` for each ``p`` (int32)."""
    c = torch.cat([x.new_zeros(1), _cumsum32(x)])
    return c[offsets[1:].long()] - c[offsets[:-1].long()]


def _set_drop(size: int, index, values, fill=0, dtype=torch.int32):
    """``full(size, fill).at[index].set(values, mode="drop")``: indices at
    or past ``size`` go to a spare bin that is cut off; a negative index
    wraps."""
    index = torch.where(index < 0, index + size, index).clamp(max=size)
    out = torch.full((size + 1,), fill, dtype=dtype, device=values.device)
    out[index.long()] = values.to(dtype)
    return out[:size]


def _device_pack_core(line, issue, offsets, n, open_row, spec, C, B,
                      banks):
    """Classify + block-decompose a padded program on its device.

    ``line``/``issue`` are int32[Npad] (padded past ``n``), ``offsets``
    int32[P_pad + 1] phase offsets (padded with the total length),
    ``open_row`` the int32[C, B] row state entering the program.  Returns
    the grouped-order streams the scatter consumes, the per-phase
    reductions, the program-order kinds, the row state after the program,
    and the step count ``S`` and block width ``K`` as 0-d tensors."""
    dev = line.device
    Npad = line.shape[0]
    P_pad = offsets.shape[0] - 1
    i32 = dict(dtype=torch.int32, device=dev)
    idx = torch.arange(Npad, **i32)
    valid = idx < n
    comps = _decode_device(line, spec, banks)
    ch = comps["channel"]
    bank_in_ch = comps["bank_in_channel"]
    row = comps["row"]
    bank_global = ch * B + bank_in_ch
    # ---- row-kind classification (mirrors classify_rows) --------------
    sort_key = torch.where(valid, bank_global, C * B)
    order1 = torch.sort(sort_key, stable=True).indices
    gbo = sort_key[order1]
    rows_o = row[order1]
    valid_o = valid[order1]
    change = gbo[1:] != gbo[:-1]
    first = torch.cat([change.new_ones(1), change])
    last = torch.cat([change, change.new_ones(1)])
    open_flat = torch.cat([open_row.reshape(-1), open_row.new_full((1,), -1)])
    prev = torch.where(first, open_flat[gbo.long()], _shift1(rows_o, 0))
    kind_o = torch.where(prev == rows_o, 0,
                         torch.where(prev == -1, 1, 2)).to(torch.int8)
    kind_o = torch.where(valid_o, kind_o, 0).to(torch.int8)
    kind = torch.empty(Npad, dtype=torch.int8, device=dev)
    kind[order1] = kind_o
    # each bank's last access leaves its row open (others: the spare bin)
    open_out = torch.cat([open_row.reshape(-1), open_row.new_zeros(1)])
    open_out[torch.where(last & valid_o, gbo, C * B).long()] = rows_o
    open_out = open_out[:C * B].reshape(C, B)
    # ---- K selection (the tensor form of choose_block_lanes) ----------
    n_miss = (valid & (kind != 0)).sum(dtype=torch.int32)
    K = torch.where(2 * n_miss < n, BLOCK_LANES, 1).to(torch.int32)
    # ---- per-phase request ids + hit/conflict reductions --------------
    phase = (torch.searchsorted(offsets, idx, right=True, out_int32=True)
             - 1)
    # a phase is a contiguous range of requests, so its counts are
    # differences of one prefix sum at its offsets (no atomics)
    hits_p = _range_sums(((kind == 0) & valid).to(torch.int32), offsets)
    confl_p = _range_sums(((kind == 2) & valid).to(torch.int32), offsets)
    # ---- block decomposition within (phase, channel) streams ----------
    key = torch.where(valid, phase * C + ch, P_pad * C)
    order2 = torch.sort(key, stable=True).indices
    key_s = key[order2]
    kind_s = kind[order2]
    miss_s = kind_s != 0
    valid_s = valid[order2]
    bank_s = bank_in_ch[order2]
    change = key_s[1:] != key_s[:-1]
    group_first = torch.cat([change.new_ones(1), change])
    run_start = group_first | miss_s | _shift1(miss_s, False)
    # position within the run: runs are contiguous, so its offset is the
    # latest run start at or before each element
    pos = idx - _carry_forward(run_start, idx)
    lane = torch.remainder(pos, K)
    # the JAX package's block_off[run_id] + pos // K: blocks start at
    # every K-th element of a run, so a block's id counts the block starts
    block_id = _cumsum32((lane == 0).to(torch.int32)) - 1
    # first block of the current group, carried forward (block_id is
    # non-decreasing in grouped order)
    fb = _carry_forward(group_first, block_id)
    block_rank = block_id - fb
    # bank-rank within (block, bank): BLOCK_LANES - 1 shifted comparisons;
    # blocks never span K lanes, so pairs across blocks compare unequal
    # block ids (which is why the widest loop is safe for any K)
    rb = torch.zeros(Npad, **i32)
    kb = block_id * B + bank_s
    for j in range(1, BLOCK_LANES):
        rb[j:] += (kb[j:] == kb[:-j]).to(torch.int32)
    group_last = torch.cat([change, change.new_ones(1)])
    n_blocks = _set_drop(P_pad * C,
                         torch.where(group_last & valid_s, key_s, P_pad * C),
                         block_rank + 1)
    L_p = n_blocks.reshape(P_pad, C).amax(dim=1)
    step_starts = _cumsum32(L_p) - L_p
    S = L_p.sum(dtype=torch.int32)
    phase_s = torch.minimum(torch.div(key_s, C, rounding_mode="floor"),
                            torch.tensor(P_pad - 1, **i32))
    r_idx = step_starts[phase_s.long()] + block_rank
    issue_s = issue[order2]
    meta_s = (bank_s
              | (miss_s.to(torch.int32) << 8)
              | ((kind_s == 2).to(torch.int32) << 9)
              | (valid_s.to(torch.int32) << 10)
              | (rb << META_RB_SHIFT))
    return (r_idx, ch[order2], lane, issue_s, meta_s, valid_s,
            L_p, hits_p, confl_p, kind, open_out, S, K)


def _device_pack_scatter(r_idx, c_idx, lane, issue_s, meta_s, valid_s,
                         L_p, S_pad: int, C: int, K: int):
    """Scatter the grouped streams into the blocked lockstep
    ``[S_pad, C, K]`` arrays and the phase-boundary markers."""
    tgt = torch.where(valid_s, r_idx, S_pad).long()
    c_idx, lane = c_idx.long(), lane.long()
    dev = issue_s.device
    issue = torch.zeros((S_pad + 1, C, K), dtype=torch.int32, device=dev)
    meta = torch.zeros((S_pad + 1, C, K), dtype=torch.int32, device=dev)
    issue[tgt, c_idx, lane] = issue_s
    meta[tgt, c_idx, lane] = meta_s
    boundary = _set_drop(S_pad, _cumsum32(L_p) - 1,
                         torch.ones_like(L_p, dtype=torch.bool),
                         fill=False, dtype=torch.bool)
    return issue[:S_pad], meta[:S_pad], boundary


def _device_phase_durations(fin, L_p):
    """Per-phase makespans from the serve's finishes: the segmented max
    of the per-step maxima over the phase step ranges (the device
    counterpart of ``finalize_program``'s ``maximum.reduceat``)."""
    P_pad = L_p.shape[0]
    step_max = fin.amax(dim=(1, 2))
    ends = _cumsum32(L_p)
    steps = torch.arange(fin.shape[0], dtype=torch.int32, device=fin.device)
    phase = torch.searchsorted(ends, steps, right=True).clamp(max=P_pad)
    out = torch.zeros(P_pad + 1, dtype=fin.dtype, device=fin.device)
    return out.scatter_reduce_(0, phase, step_max, "amax")[:P_pad]


class StreamTimer:
    """Seconds of the work enqueued on ``device``'s current stream between
    construction and :meth:`stop`: CUDA events on the card, the host
    clock on the CPU.  :meth:`seconds` does not wait: read it once a wait
    has passed the stop (:meth:`wait`, or a later copy to the host)."""

    def __init__(self, device: torch.device):
        self.device = device
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(device))
        else:
            self._start = time.perf_counter()

    def stop(self) -> None:
        if self.device.type == "cuda":
            self._end.record(torch.cuda.current_stream(self.device))
        else:
            self._end = time.perf_counter()

    def wait(self) -> None:
        """Block until the card has passed the stop (a counted wait)."""
        wait(self._end if self.device.type == "cuda" else self.device)

    def seconds(self) -> float:
        if self.device.type == "cuda":
            return self._start.elapsed_time(self._end) / 1e3
        return self._end - self._start


def run_timed(fn, device: torch.device):
    """``(fn(), seconds)``: a :class:`StreamTimer` around ``fn``, waited
    for."""
    timer = StreamTimer(device)
    out = fn()
    timer.stop()
    timer.wait()
    return out, timer.seconds()


def fused_scan(issue, meta, boundary, timing, carry, device,
               stage_seconds: Optional[Dict[str, float]] = None):
    """Serve a whole packed program from ``carry`` (the 5-tuple lean
    carry, on ``device``): the streams (host arrays, or tensors a device
    pack left on ``device``, which are used as they are) go through one
    ``dram_serve`` call — the CUDA kernel on the card, the plain version
    on the CPU.  Returns ``(finish[S, C, K], carry)`` on ``device``, the
    serve enqueued and not waited for.  ``stage_seconds``, when given,
    receives the ``h2d`` time (the copy of host streams, or the cast of a
    device pack's boolean ``boundary``) and the ``serve`` time (CUDA
    events on the card), each bought with a wait on the card."""
    from repro_torch.kernels.dram_timing.ops import dram_serve
    device = torch.device(device)
    t0 = time.perf_counter()
    streams = [as_int32(a, device) for a in (issue, meta, boundary, timing)]
    if stage_seconds is not None:
        wait(device)
        stage_seconds["h2d"] = (stage_seconds.get("h2d", 0.0)
                                + time.perf_counter() - t0)
    C = issue.shape[1]
    state = tuple(carry) + (torch.zeros((C,), dtype=torch.int32,
                                        device=device),)
    if stage_seconds is None:
        fin, state = dram_serve(*streams, state)
    else:
        (fin, state), serve = run_timed(lambda: dram_serve(*streams, state),
                                        device)
        stage_seconds["serve"] = stage_seconds.get("serve", 0.0) + serve
    return fin, state[:5]


def _cold_batch_state(M: int, C: int, n_banks: int, banks_per_rank: int,
                      device):
    """The cold in-serve carry (the lean carry and a zero phase makespan)
    for each of M cases, case axis first."""
    single = init_lean_carry(C, n_banks, banks_per_rank, device) + (
        torch.zeros((C,), dtype=torch.int32, device=device),)
    return tuple(x.expand((M,) + x.shape).contiguous() for x in single)


def as_int32(a, device) -> torch.Tensor:
    """A host array or a tensor as a contiguous int32 tensor on
    ``device`` (the tensor itself when it already is one)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
        device)


def fused_scan_batch(issue, meta, boundary, timing, n_banks: int,
                     banks_per_rank: int, device):
    """Serve M cases of one shape, case m against ``timing[m]`` (``[M,
    7]``), each from a cold lean carry, on ``device``: M stacked programs
    (``issue``/``meta`` ``[M, S, C, K]``, ``boundary[M, S]``), or ONE
    program (``[S, C, K]``, ``boundary[S]``) that every case reads and
    that is never copied M times (the cache-hit path of a geometry-shared
    memory grid).  One ``dram_serve_batch`` call (two launches on the
    card, the plain version on the CPU), the whole program at once.
    Returns ``(finish[M, S, C, K], lean carries)``, the carries with a
    leading case axis (``sweep(batch_memories=True)``)."""
    from repro_torch.kernels.dram_timing.ops import dram_serve_batch
    device = torch.device(device)
    streams = [as_int32(a, device) for a in (issue, meta, boundary, timing)]
    state = _cold_batch_state(len(timing), issue.shape[-2], n_banks,
                              banks_per_rank, device)
    fin, state = dram_serve_batch(*streams, state)
    return fin, state[:5]


def simulate_trace_device(trace: Trace, cfg: DRAMConfig,
                          keep_finish: bool = False,
                          device=None) -> timing_mod.TraceResult:
    """Drop-in counterpart of :func:`repro_torch.core.timing.
    simulate_trace` on ``device`` (default the card): the trace split by
    :func:`pack_channels` and served from a cold carry by one
    :func:`simulate_packed` call (one ``dram_timing`` launch on the card,
    the plain version on the CPU).  An empty trace goes through
    ``simulate_trace``.  Where the int32 scan would wrap, the card raises
    ``ValueError`` (the chunked scan's one departure)."""
    if len(trace) == 0:
        return timing_mod.simulate_trace(trace.line_addr, trace.issue, cfg)
    device = resolve_device(device)
    packed = pack_channels(trace, cfg)
    carry = init_channel_carry(cfg.channels, cfg.banks_per_channel,
                               cfg.org.banks, device)
    finish, kind, _ = simulate_packed(
        packed.issue, packed.bank, packed.row, packed.valid,
        timing_params(cfg.timing), carry)
    finish = finish.cpu().numpy()
    kind = kind.cpu().numpy()
    v = packed.valid
    finish_flat = np.zeros(len(trace), dtype=np.int64)
    finish_flat[packed.scatter_index[v]] = finish[v]
    cycles = int(finish_flat.max())
    ns = cycles / cfg.clock_ghz
    total_bytes = len(trace) * CACHE_LINE_BYTES
    per_channel = {
        c: (int(finish[c][v[c]].max()) if v[c].any() else 0)
        for c in range(cfg.channels)
    }
    return timing_mod.TraceResult(
        cycles=cycles,
        ns=ns,
        total_requests=len(trace),
        total_bytes=total_bytes,
        row_hits=int((kind == 0).sum()),
        row_empty=int((kind == 1).sum()),
        row_conflicts=int((kind == 2).sum()),
        achieved_gbps=(total_bytes / ns) if ns > 0 else 0.0,
        peak_gbps=cfg.peak_gbps,
        per_channel_cycles=per_channel,
        finish=finish_flat if keep_finish else None,
    )
