"""The DRAM-timing model's carry, stream formats and serves.

Two entry points, as in the JAX package:

* :func:`simulate_packed` — one phase over per-channel ``[C, L]``
  streams, one request per channel per slot, carry in and out (the
  per-phase path behind ``VectorizedDRAM.run_phase``);
* :func:`fused_scan` — a whole multi-phase program over blocked
  ``[S, C, K]`` lockstep streams: a step retires up to K row hits per
  channel, or one miss, and phase barriers are honored inside the serve
  by re-basing the carry at each segment boundary.

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

from repro_torch.core.dram import DRAMConfig, DRAMTiming
from repro_torch.core.trace import Trace, group_ranks

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
    host-tracked — and ``last_act_rank`` — derivable from the history)."""
    (open_row, act_time, bank_avail, bus_free,
     act_hist, act_ptr, last_act_rank) = carry
    return (bank_avail, act_time, bus_free, act_hist,
            act_ptr.to(torch.int32))


def full_from_lean(lean, open_row):
    """Inverse of :func:`lean_from_full`; ``open_row`` is the host-tracked
    int[C, B] row state."""
    avail, act, bus, hist, ptr = lean
    last = torch.gather(hist, 2, torch.remainder(ptr + 3, 4)[..., None]
                        .long())[..., 0]
    open_row = torch.as_tensor(np.asarray(open_row), dtype=torch.int32,
                               device=avail.device)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_timed(fn, device: torch.device):
    """``(fn(), seconds)``: CUDA events around ``fn`` on the card (it
    synchronises on the end event), the host clock on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3


def fused_scan(issue, meta, boundary, timing, carry, device,
               stage_seconds: Optional[Dict[str, float]] = None):
    """Serve a whole packed program from ``carry`` (the 5-tuple lean
    carry, on ``device``): the host streams go to ``device`` and through
    one ``dram_serve`` call — the CUDA kernel on the card, the plain
    version on the CPU.  Returns ``(finish[S, C, K], carry)`` on
    ``device``.  ``stage_seconds``, when given, receives the ``h2d``
    transfer time and the ``serve`` time (CUDA events on the card)."""
    from repro_torch.kernels.dram_timing.ops import dram_serve
    device = torch.device(device)
    t0 = time.perf_counter()
    streams = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
               .to(device) for a in (issue, meta, boundary, timing)]
    _sync(device)
    t1 = time.perf_counter()
    C = issue.shape[1]
    state = tuple(carry) + (torch.zeros((C,), dtype=torch.int32,
                                        device=device),)
    (fin, state), serve = run_timed(lambda: dram_serve(*streams, state),
                                    device)
    if stage_seconds is not None:
        stage_seconds["h2d"] = stage_seconds.get("h2d", 0.0) + (t1 - t0)
        stage_seconds["serve"] = stage_seconds.get("serve", 0.0) + serve
    return fin, state[:5]
