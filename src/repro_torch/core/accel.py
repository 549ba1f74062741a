"""Shared machinery for the vectorized accelerator trace models.

``VectorizedDRAM`` serves phases and whole-run programs while carrying
per-channel DRAM state across them — the equivalent of the paper's
controller "waiting on all memory requests to finish before switching
phases".  Two execution modes share one statistics surface and one
carry:

* :meth:`VectorizedDRAM.run_program` — a
  :class:`~repro_torch.core.trace.SegmentedTrace` (every phase of the
  simulation, emitted up front by the trace models) is packed once and
  served by the fused serve, which honors the phase barriers internally
  — one CUDA kernel launch per run on the card;
* :meth:`VectorizedDRAM.run_phase` — one phase over per-channel
  ``[C, L]`` streams through the per-channel scan (one launch of the
  ``dram_timing`` kernel on the card); the dynamic-graph path serves its
  ``ep{e}_apply`` rewrites this way.

Packing has two routes, equal array for array: the *device* pack
(:func:`pack_program_device` — decode, row-kind classification and the
block decomposition as torch code on the card, fed the int32 trace, its
blocked streams left on the card for the serve) and the NumPy *host*
pack (:func:`pack_program`).  :func:`pack_program_auto` packs on the
card when the run is on the card and :func:`device_pack_supported`
allows it, as the JAX package does on an accelerator, and on the host
otherwise.  Packing depends only on DRAM
*geometry* (``DRAMConfig.geometry_key``) and the program, never on
timing.

When the device carries an on-chip hierarchy level (``DRAMConfig.cache``)
both modes first run the requests through the cache filter
(:mod:`repro_torch.core.cache`): hits are dropped *before* packing and the
prefetcher shapes issue lower bounds, with the lookup state persisting
across phases and programs.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import cache as cache_mod
from repro_torch.core import vectorized as vec
from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.device import resolve_device

#: programs packed by each route since the last
#: :func:`zero_pack_route_counts` (``device_pack``: the torch pack on the
#: streams' device; ``host_pack``: the NumPy packer)
PACK_ROUTES = {"device_pack": 0, "host_pack": 0}
_ROUTES_LOCK = threading.Lock()


def _count_route(route: str) -> None:
    with _ROUTES_LOCK:
        PACK_ROUTES[route] += 1


def pack_route_counts() -> Dict[str, int]:
    with _ROUTES_LOCK:
        return dict(PACK_ROUTES)


def zero_pack_route_counts() -> None:
    with _ROUTES_LOCK:
        for route in PACK_ROUTES:
            PACK_ROUTES[route] = 0


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


@dataclasses.dataclass
class PhaseStats:
    name: str
    requests: int
    bytes: int
    start_cycle: int
    end_cycle: int
    row_hits: int
    row_conflicts: int


@dataclasses.dataclass(frozen=True)
class PackedProgram:
    """A :class:`SegmentedTrace` packed for the fused serve: blocked
    lockstep ``[S, C, K]`` per-channel streams with phase boundary
    markers and host-precomputed row-buffer kinds.

    A block (one step of one channel) is up to K consecutive row hits —
    whose per-bank chains the serve step resolves internally — or a
    single row miss."""

    issue: np.ndarray        # int32[S, C, K] (phase-relative)
    meta: np.ndarray         # int32[S, C, K] packed bank/kind/rank word
    boundary: np.ndarray     # bool[S]
    timing: np.ndarray       # int32[7]
    n_banks: int
    banks_per_rank: int
    names: List[str]
    requests: np.ndarray     # int64[P] per-phase request counts
    offsets: np.ndarray      # int64[P+1] per-phase request offsets
    kind: np.ndarray         # int8[N] per-request row kind, program order
    step_starts: np.ndarray  # int64[P] first lockstep step of each phase
    n_steps: int             # S before padding
    open_row_final: np.ndarray  # int[C, B] row state after the program

    @property
    def n_phases(self) -> int:
        return len(self.names)

    @property
    def signature(self):
        """Serve-shape signature: programs with equal signatures can be
        served together in one batched serve (``fused_scan_batch``)."""
        return (tuple(self.issue.shape), self.n_banks, self.banks_per_rank)


def classify_rows(bank_global: np.ndarray, row: np.ndarray,
                  open_row: np.ndarray):
    """Row-buffer kinds (0 hit / 1 empty / 2 conflict) for a program-order
    stream, given the per-bank open-row state entering the stream.

    The classification depends only on each bank's row *sequence* — never
    on timing — which is what lets the fused serve skip row tracking.
    Returns ``(kind int8[N], open_row_after flat int64[C*B])``.
    """
    flat = np.asarray(open_row, dtype=np.int64).ravel().copy()
    if len(flat) < (1 << 15):
        # small key range: radix argsort (~5x over int64 mergesort)
        order = np.argsort(bank_global.astype(np.int16), kind="stable")
    else:
        order = np.argsort(bank_global, kind="stable")
    gbo = bank_global[order]
    rows_o = row[order]
    prev = np.empty(len(order), dtype=np.int64)
    first = np.empty(len(order), dtype=bool)
    first[:1] = True
    first[1:] = gbo[1:] != gbo[:-1]
    prev[1:] = rows_o[:-1]
    prev[first] = flat[gbo[first]]
    kind_o = np.where(prev == rows_o, 0,
                      np.where(prev == -1, 1, 2)).astype(np.int8)
    kind = np.empty(len(order), dtype=np.int8)
    kind[order] = kind_o
    last = np.empty(len(order), dtype=bool)
    last[:-1] = gbo[:-1] != gbo[1:]
    last[-1:] = True
    flat[gbo[last]] = rows_o[last]
    return kind, flat


def pack_program(program: SegmentedTrace, cfg: DRAMConfig,
                 open_row: Optional[np.ndarray] = None
                 ) -> Optional[PackedProgram]:
    """Pack a whole-run program for the fused serve (one decode + one
    stable argsort; no per-phase or per-channel Python loops).

    ``open_row`` is the int[C, B] row state entering the program
    (default: all banks closed)."""
    P = program.n_phases
    if P == 0 or len(program) == 0:
        return None
    if np.any(program.issue < 0) or np.any(
            program.issue >= vec.MAX_PHASE_ISSUE):
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    comps = cfg.decode_lines(program.line_addr)
    ch = comps["channel"]
    C = cfg.channels
    B = cfg.banks_per_channel
    if B > 256:
        raise ValueError(
            f"banks_per_channel={B} exceeds the fused serve's 8-bit bank "
            f"field")
    if open_row is None:
        open_row = np.full((C, B), -1, dtype=np.int64)
    _count_route("host_pack")
    kind, open_flat = classify_rows(comps["bank_global"], comps["row"],
                                    open_row)
    requests = np.diff(program.offsets)
    phase = np.repeat(np.arange(P, dtype=np.int64), requests)
    key = phase * C + ch
    # hit-dominated streams get wide blocks; conflict-heavy ones (where
    # almost every block would be a singleton miss anyway) serialize.
    K = vec.choose_block_lanes(int((kind != 0).sum()), len(kind))
    # ---- block decomposition within each (phase, channel) stream ------
    # grouped order: phase-major, channel, then program order
    order = np.argsort(key, kind="stable")
    miss_g = kind[order] != 0
    group_first = np.empty(len(order), dtype=bool)
    group_first[:1] = True
    group_first[1:] = key[order][1:] != key[order][:-1]
    run_start = group_first | miss_g
    run_start[1:] |= miss_g[:-1]
    run_id = np.cumsum(run_start) - 1
    run_len = np.bincount(run_id)
    run_off = np.cumsum(run_len) - run_len
    pos = np.arange(len(order), dtype=np.int64) - run_off[run_id]
    lane = pos % K
    blocks_per_run = (run_len + K - 1) // K
    block_off = np.cumsum(blocks_per_run) - blocks_per_run
    block_id = block_off[run_id] + pos // K      # global, grouped order
    # block rank within its (phase, channel) group
    first_block = block_id[group_first]
    gid = np.cumsum(group_first) - 1
    block_rank = block_id - first_block[gid]
    # bank-rank within (block, bank): K-1 shifted comparisons on the
    # fused (block, bank) key
    bank_g = comps["bank_in_channel"][order]
    rb = np.zeros(len(order), dtype=np.int32)
    if K > 1:
        kb = block_id * B + bank_g
        for j in range(1, K):
            rb[j:] += kb[j:] == kb[:-j]
    # steps per phase = max block count over channels (block_rank is
    # non-decreasing within a group, so each group's last element has it)
    group_last = np.empty(len(order), dtype=bool)
    group_last[:-1] = group_first[1:]
    group_last[-1:] = True
    n_blocks_g = np.zeros(P * C, dtype=np.int64)
    n_blocks_g[key[order][group_last]] = block_rank[group_last] + 1
    L_p = n_blocks_g.reshape(P, C).max(axis=1)
    step_starts = np.cumsum(L_p) - L_p
    S = int(L_p.sum())
    S_pad = sum(vec.plan_chunks(S))
    r_idx = step_starts[phase[order]] + block_rank
    c_idx = ch[order]
    issue = np.zeros((S_pad, C, K), dtype=np.int32)
    meta = np.zeros((S_pad, C, K), dtype=np.int32)
    issue[r_idx, c_idx, lane] = program.issue[order]
    meta[r_idx, c_idx, lane] = vec.pack_meta(
        bank_g, miss_g, kind[order] == 2,
        np.ones(len(order), dtype=bool), bank_rank=rb)
    boundary = np.zeros(S_pad, dtype=bool)
    boundary[np.cumsum(L_p) - 1] = True
    return PackedProgram(
        issue=issue, meta=meta, boundary=boundary,
        timing=vec.timing_params(cfg.timing),
        n_banks=B, banks_per_rank=cfg.org.banks,
        names=list(program.names), requests=requests,
        offsets=np.asarray(program.offsets), kind=kind,
        step_starts=step_starts, n_steps=S,
        open_row_final=open_flat.reshape(C, B))


@dataclasses.dataclass(frozen=True)
class DevicePackedProgram:
    """A program packed on its device by :func:`pack_program_device`: the
    blocked ``[S, C, K]`` streams stay there and feed the fused serve
    without a copy.  Equal to :class:`PackedProgram` array for array, with
    the per-request row kinds also reduced to per-phase hit and conflict
    counts, so finalizing moves ``O(P)`` integers to the host."""

    issue: torch.Tensor      # int32[S, C, K]
    meta: torch.Tensor       # int32[S, C, K]
    boundary: torch.Tensor   # bool[S]
    timing: np.ndarray       # int32[7] (host)
    n_banks: int
    banks_per_rank: int
    names: List[str]
    requests: np.ndarray     # int64[P]
    offsets: np.ndarray      # int64[P+1]
    kind: torch.Tensor       # int8[Npad] program order (padded past N)
    L_p: torch.Tensor        # int32[P_pad] steps per phase
    hits_p: torch.Tensor     # int32[P_pad] row hits per phase
    confl_p: torch.Tensor    # int32[P_pad] row conflicts per phase
    n_steps: int             # S before padding
    K: int                   # block width (lanes per step)
    open_row_final: torch.Tensor  # int32[C, B] row state after the run

    @property
    def n_phases(self) -> int:
        return len(self.names)

    @property
    def signature(self):
        return (tuple(self.issue.shape), self.n_banks, self.banks_per_rank)


def device_pack_supported(program: SegmentedTrace,
                          cfg: DRAMConfig) -> bool:
    """Whether the device pack can serve this program: pow2 address
    components, <= 256 banks a channel, and every index and address in
    int32 range (the host packer covers the rest)."""
    if cfg.decode_spec() is None:
        return False
    if cfg.banks_per_channel > 256:
        return False
    n = len(program)
    if n == 0:
        return True
    # kb = block_id * B + bank must stay in int32 (block_id < n)
    if n * cfg.banks_per_channel >= 2**31:
        return False
    return int(program.line_addr.max()) < 2**31


def pack_program_device(program: SegmentedTrace, cfg: DRAMConfig,
                        open_row=None, device=None
                        ) -> Optional[DevicePackedProgram]:
    """Pack a whole-run program on ``device`` (default the card): the
    trace goes over once and is narrowed to int32 there, classification
    and block decomposition run there, and one read of four scalars (the
    step count, the block width, and whether any issue cycle or line
    address left the int32 range) sizes the scatter or raises.
    ``open_row`` may be a host array or a tensor."""
    P = program.n_phases
    N = len(program)
    if P == 0 or N == 0:
        return None
    C = cfg.channels
    B = cfg.banks_per_channel
    if cfg.decode_spec() is None or B > 256 or N * B >= 2**31:
        raise ValueError(
            "program/device not eligible for the device pack (non-pow2 "
            "geometry, >256 banks, or more than 2**31 request-banks)")
    device = resolve_device(device)
    N_pad = _bucket(N)
    P_pad = _bucket(P)
    i32 = dict(dtype=torch.int32, device=device)
    line64, issue64 = (torch.from_numpy(a).to(device)
                       for a in (program.line_addr, program.issue))
    out_of_range = torch.stack([
        (issue64.min() < 0) | (issue64.max() >= vec.MAX_PHASE_ISSUE),
        line64.max() >= 2**31])
    line, issue = torch.zeros(N_pad, **i32), torch.zeros(N_pad, **i32)
    line[:N] = line64
    issue[:N] = issue64
    del line64, issue64
    offsets = torch.full((P_pad + 1,), N, **i32)
    offsets[:P + 1] = torch.from_numpy(program.offsets).to(device)
    if open_row is None:
        open_row = torch.full((C, B), -1, **i32)
    else:
        open_row = torch.as_tensor(open_row, device=device).to(torch.int32)
    _count_route("device_pack")
    (r_idx, c_idx, lane, issue_s, meta_s, valid_s, L_p, hits_p, confl_p,
     kind, open_out, S, K) = vec._device_pack_core(
        line, issue, offsets, N, open_row, spec=cfg.decode_spec(), C=C,
        B=B, banks=cfg.org.banks)
    S, K, bad_issue, bad_line = torch.cat(
        [torch.stack([S, K]), out_of_range.to(torch.int32)]).tolist()
    if bad_issue:
        raise ValueError("issue cycles out of int32 range; chunk the trace")
    if bad_line:
        raise ValueError("line addresses beyond int32; the device pack "
                         "does not apply (use the host pack)")
    issue, meta, boundary = vec._device_pack_scatter(
        r_idx, c_idx, lane, issue_s, meta_s, valid_s, L_p,
        S_pad=sum(vec.plan_chunks(S)), C=C, K=K)
    return DevicePackedProgram(
        issue=issue, meta=meta, boundary=boundary,
        timing=vec.timing_params(cfg.timing),
        n_banks=B, banks_per_rank=cfg.org.banks,
        names=list(program.names), requests=np.diff(program.offsets),
        offsets=np.asarray(program.offsets), kind=kind, L_p=L_p,
        hits_p=hits_p, confl_p=confl_p, n_steps=S, K=K,
        open_row_final=open_out)


def _auto_pack_prefers_device(device: torch.device) -> bool:
    """Pack on the device when it is the card (the blocked streams then
    never cross to the card; only the int32 trace does).  On the CPU the
    NumPy packer serves."""
    return device.type == "cuda"


def pack_program_auto(program: SegmentedTrace, cfg: DRAMConfig,
                      open_row=None, device=None):
    """Pack on ``device`` (default the card) with the torch pack when
    :func:`_auto_pack_prefers_device` holds and
    :func:`device_pack_supported` allows it, else with the NumPy pack."""
    device = resolve_device(device)
    if (_auto_pack_prefers_device(device)
            and device_pack_supported(program, cfg)):
        return pack_program_device(program, cfg, open_row=open_row,
                                   device=device)
    if isinstance(open_row, torch.Tensor):
        open_row = open_row.cpu().numpy()
    return pack_program(program, cfg, open_row=open_row)


@dataclasses.dataclass
class ProgramStats:
    """Accumulated DRAM statistics of one executed program — the surface
    :class:`SimReport` assembly reads.  The cache fields describe the
    on-chip level the program passed through before packing (zero when
    no cache is configured)."""

    phases: List[PhaseStats]
    now: int
    total_requests: int
    total_row_hits: int
    total_row_conflicts: int
    cache_lookups: int = 0
    cache_hits: int = 0
    prefetch_hits: int = 0

    def attach_cache(self, cs) -> "ProgramStats":
        """Fold a :class:`~repro_torch.core.cache.CacheStats` into this
        surface."""
        if cs is not None:
            self.cache_lookups += cs.lookups
            self.cache_hits += cs.hits
            self.prefetch_hits += cs.prefetch_hits
        return self


def finalize_program(packed: PackedProgram, finish,
                     origin: int = 0) -> ProgramStats:
    """Turn the fused serve's per-step finishes (a NumPy array or a torch
    tensor on any device) into phase statistics.

    ``finish[s, c]`` is relative to the owning phase's start (0 on
    invalid lanes), so each phase's makespan is a segmented max (the
    per-step max is taken where ``finish`` lives); row hits/conflicts
    reduce from the host-precomputed kinds.  The absolute clock is the
    running (int64, overflow-free) sum of makespans."""
    fin = torch.as_tensor(finish)[:packed.n_steps].amax(dim=(1, 2))
    fin = fin.cpu().numpy()
    dur = np.maximum.reduceat(fin, packed.step_starts).astype(np.int64)
    off = packed.offsets[:-1]
    hits = np.add.reduceat((packed.kind == 0).astype(np.int64), off)
    confl = np.add.reduceat((packed.kind == 2).astype(np.int64), off)
    return _program_stats(packed, dur, hits, confl, origin)


def _program_stats(packed, dur, hits, confl, origin: int) -> ProgramStats:
    """Phase statistics from per-phase makespans and row counts (int64
    host arrays); the absolute clock is the running sum of makespans."""
    P = packed.n_phases
    ends = origin + np.cumsum(dur)
    starts = ends - dur
    phases = [
        PhaseStats(
            name=packed.names[p], requests=int(packed.requests[p]),
            bytes=int(packed.requests[p]) * CACHE_LINE_BYTES,
            start_cycle=int(starts[p]), end_cycle=int(ends[p]),
            row_hits=int(hits[p]), row_conflicts=int(confl[p]),
        )
        for p in range(P)
    ]
    return ProgramStats(
        phases=phases, now=int(ends[-1]) if P else origin,
        total_requests=int(packed.requests.sum()),
        total_row_hits=int(hits.sum()),
        total_row_conflicts=int(confl.sum()),
    )


def finalize_program_device(packed: DevicePackedProgram, finish,
                            origin: int = 0) -> ProgramStats:
    """Device-pack counterpart of :func:`finalize_program`: the per-phase
    makespans reduce where ``finish`` lives, and only ``3 P`` integers
    cross to the host."""
    P = packed.n_phases
    dur = vec._device_phase_durations(finish, packed.L_p)
    dur, hits, confl = torch.stack(
        [dur[:P], packed.hits_p[:P], packed.confl_p[:P]]).cpu().numpy(
    ).astype(np.int64)
    return _program_stats(packed, dur, hits, confl, origin)


def serve_packed(packed, timing=None, carry=None, origin: int = 0,
                 device=None,
                 stage_seconds: Optional[Dict[str, float]] = None):
    """Run one packed program (host- or device-packed) through the fused
    serve on ``device`` (a device pack's own device by default) from the
    given lean carry (default: cold DRAM state) and reduce it to
    :class:`ProgramStats`.  Returns ``(stats, lean_carry)``.

    ``timing`` overrides the timing vector packed with the program (the
    pack never depends on timing)."""
    on_device = isinstance(packed, DevicePackedProgram)
    if device is None and on_device:
        device = packed.issue.device
    device = resolve_device(device)
    if timing is None:
        timing = packed.timing
    C = packed.issue.shape[1]
    if carry is None:
        carry = vec.init_lean_carry(C, packed.n_banks,
                                    packed.banks_per_rank, device)
    fin, lean = vec.fused_scan(packed.issue, packed.meta, packed.boundary,
                               timing, carry, device,
                               stage_seconds=stage_seconds)
    t0 = time.perf_counter()
    if on_device:
        stats = finalize_program_device(packed, fin, origin=origin)
    else:
        stats = finalize_program(packed, fin, origin=origin)
    if stage_seconds is not None:
        stage_seconds["finalize"] = (stage_seconds.get("finalize", 0.0)
                                     + time.perf_counter() - t0)
    return stats, lean


class VectorizedDRAM:
    """Stateful multi-program DRAM simulation on ``device`` (default the
    card; raises when CUDA is absent).

    :meth:`run_program` packs through :func:`pack_program_auto`: on the
    card when the run is there and the program allows it, NumPy
    otherwise; both give the same serve and statistics.

    ``stage_seconds`` accumulates the wall time of the cache filter
    (``cache``), the pack (``pack``, synchronised), the host-to-device copy
    (``h2d``), the serve and the finalize of programs, and of the pack
    (``phase_pack``, copy included), the scan (``phase_serve``, CUDA
    events on the card) and the reductions (``phase_finalize``) of single
    phases."""

    def __init__(self, cfg: DRAMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._timing = vec.timing_params(cfg.timing)
        # on-chip hierarchy level: requests are filtered through it (hits
        # dropped, prefetch issue shaping) before they reach the packer;
        # the lookup state lives on ``device`` and persists across phases
        # and programs.
        self.cache = cfg.effective_cache
        self._cache_state = cache_mod.init_state(self.cache, self.device)
        self.cache_stats = cache_mod.CacheStats()
        self._reset_carry()
        # Device-side cycle math is int32; ``_origin`` (host int) anchors
        # the device-relative clock so runs can exceed the int32 range.
        self._origin = 0
        self._rel_now = 0
        self.phases: List[PhaseStats] = []
        self.total_requests = 0
        self.total_row_hits = 0
        self.total_row_conflicts = 0
        self.stage_seconds: Dict[str, float] = {}

    def _reset_carry(self) -> None:
        self.carry = vec.init_channel_carry(
            self.cfg.channels, self.cfg.banks_per_channel,
            self.cfg.org.banks, self.device)

    def _add_seconds(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = (self.stage_seconds.get(stage, 0.0)
                                     + seconds)

    @property
    def now(self) -> int:
        """Current absolute memory-clock cycle."""
        return self._origin + self._rel_now

    # the SimReport assembly reads these off any stats surface
    @property
    def cache_lookups(self) -> int:
        return self.cache_stats.lookups

    @property
    def cache_hits(self) -> int:
        return self.cache_stats.hits

    @property
    def prefetch_hits(self) -> int:
        return self.cache_stats.prefetch_hits

    def invalidate_lines(self, line_ranges) -> int:
        """Drop every on-chip line inside any ``(first_line, n_lines)``
        range (regions the host rewrote); returns the lines dropped (0
        without a cache level)."""
        return cache_mod.invalidate_lines(self._cache_state, self.cache,
                                          line_ranges)

    def run_phase(self, trace: Trace, name: str = "phase") -> int:
        """Simulate one phase starting at the current clock (one
        per-channel scan: the ``dram_timing`` kernel on the card); returns
        its makespan (absolute memory cycle)."""
        if self.cache is not None:
            t0 = time.perf_counter()
            trace, cs, self._cache_state = cache_mod.filter_trace(
                trace, self.cache, self._cache_state, device=self.device)
            self.cache_stats.merge(cs)
            self._add_seconds("cache", time.perf_counter() - t0)
        if len(trace) == 0:
            return self.now
        t0 = time.perf_counter()
        start_rel = self._rel_now
        issue = trace.issue + start_rel
        if issue.max() >= vec.MAX_PHASE_ISSUE:
            # Re-base the device clock as the JAX package does: flush the
            # carry (open rows are forgotten, a <1% effect at this
            # magnitude); the statistics and the absolute clock are kept.
            self._origin += self._rel_now
            self._rel_now = 0
            self._reset_carry()
            start_rel = 0
            issue = trace.issue
        cfg = self.cfg
        comps = cfg.decode_lines(trace.line_addr)
        ch = comps["channel"]
        C = cfg.channels
        L = _bucket(int(np.bincount(ch, minlength=C).max()))
        streams = vec.pack_streams(ch, issue, comps["bank_in_channel"],
                                   comps["row"], C, L)[:4]
        streams = [torch.from_numpy(a).to(self.device)
                   for a in streams + (self._timing,)]
        vec._sync(self.device)
        self._add_seconds("phase_pack", time.perf_counter() - t0)
        (finish, kind, self.carry), serve = vec.run_timed(
            lambda: vec.simulate_packed(*streams, self.carry), self.device)
        self._add_seconds("phase_serve", serve)
        t1 = time.perf_counter()
        end_rel = int(finish[streams[3]].max())
        hits, confl = (int(x) for x in torch.stack(
            [(kind == 0).sum(), (kind == 2).sum()]).tolist())
        self._add_seconds("phase_finalize", time.perf_counter() - t1)
        self.phases.append(PhaseStats(
            name=name, requests=len(trace),
            bytes=len(trace) * CACHE_LINE_BYTES,
            start_cycle=self._origin + start_rel,
            end_cycle=self._origin + end_rel,
            row_hits=hits, row_conflicts=confl))
        self.total_requests += len(trace)
        self.total_row_hits += hits
        self.total_row_conflicts += confl
        self._rel_now = max(self._rel_now, end_rel)
        return self._origin + end_rel

    def run_program(self, program: SegmentedTrace) -> int:
        """Serve a whole multi-phase program (cache filter, pack, and one
        fused serve with the phase barriers honored inside it); returns
        the final absolute makespan."""
        if self.cache is not None:
            t0 = time.perf_counter()
            program, cs, self._cache_state = cache_mod.filter_program(
                program, self.cache, self._cache_state, device=self.device)
            self.cache_stats.merge(cs)
            self._add_seconds("cache", time.perf_counter() - t0)
        t0 = time.perf_counter()
        packed = pack_program_auto(program, self.cfg, open_row=self.carry[0],
                                   device=self.device)
        vec._sync(self.device)
        self._add_seconds("pack", time.perf_counter() - t0)
        if packed is None:
            return self.now
        if self._rel_now:
            # Fold the running clock into the origin (exact shift, no
            # flush) so the program's phase-relative issues line up.
            self.carry = vec.rebase_carry(self.carry, self._rel_now)
            self._origin += self._rel_now
            self._rel_now = 0
        stats, lean = serve_packed(packed, timing=self._timing,
                                   carry=vec.lean_from_full(self.carry),
                                   origin=self._origin, device=self.device,
                                   stage_seconds=self.stage_seconds)
        self.carry = vec.full_from_lean(lean, packed.open_row_final)
        self.phases.extend(stats.phases)
        self.total_requests += stats.total_requests
        self.total_row_hits += stats.total_row_hits
        self.total_row_conflicts += stats.total_row_conflicts
        # the serve re-bases at every barrier: the carry is relative to
        # the final makespan, which becomes the new origin.
        self._origin = stats.now
        self._rel_now = 0
        return self.now


@dataclasses.dataclass
class SimReport:
    """Result of one accelerator simulation run.

    ``stage_seconds`` is the wall time of each pipeline stage
    (``algorithm``, ``model``, ``trace``, ``pack``, ``h2d``, ``serve``,
    ``finalize``; the dynamic path adds its own) and ``kernel_launches``
    the CUDA kernel launches of the run, by kernel, where it is recorded
    (the dynamic path's epochs); both describe how the run went, not what
    it computed."""

    system: str
    problem: str
    graph: str
    runtime_ns: float
    iterations: int
    edges: int
    vertices: int
    total_requests: int
    total_bytes: int
    row_hit_rate: float
    phases: List[PhaseStats]
    # on-chip hierarchy level (all zero when no cache is configured);
    # ``total_requests`` counts what reached DRAM *after* filtering.
    cache_lookups: int = 0
    cache_hits: int = 0
    prefetch_hits: int = 0
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False)
    kernel_launches: Dict[str, int] = dataclasses.field(
        default_factory=dict, compare=False)

    TIMING_ONLY_FIELDS = {
        "stage_seconds": "wall-clock seconds of this run's stages — a "
                         "measurement of the host, never part of the "
                         "simulated result",
        "kernel_launches": "the kernels this run launched — where the "
                           "result was computed (the CPU's plain "
                           "versions launch none), not what it is",
    }

    @property
    def cache_hit_rate(self) -> float:
        """On-chip hit rate over the reads that probed the cache."""
        return self.cache_hits / max(self.cache_lookups, 1)

    @property
    def runtime_s(self) -> float:
        return self.runtime_ns * 1e-9

    @property
    def runtime_ms(self) -> float:
        return self.runtime_ns * 1e-6

    @property
    def reps(self) -> float:
        """Read edges per second = m * iterations / runtime (the paper's
        renamed REPS; the originals call it TEPS)."""
        if self.runtime_ns <= 0:
            return 0.0
        return self.edges * self.iterations / (self.runtime_ns * 1e-9)

    @property
    def teps(self) -> float:
        """Graph500 TEPS: m / runtime."""
        if self.runtime_ns <= 0:
            return 0.0
        return self.edges / (self.runtime_ns * 1e-9)
