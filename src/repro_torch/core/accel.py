"""Shared machinery for the vectorized accelerator trace models.

``VectorizedDRAM`` serves phases and whole-run programs while carrying
per-channel DRAM state across them — the equivalent of the paper's
controller "waiting on all memory requests to finish before switching
phases".  Two execution modes share one statistics surface and one
carry:

* :meth:`VectorizedDRAM.run_program` — a
  :class:`~repro_torch.core.trace.SegmentedTrace` (every phase of the
  simulation, emitted up front by the trace models) is packed once on
  the host (:func:`pack_program`, NumPy) and served by the fused serve,
  which honors the phase barriers internally — one CUDA kernel launch
  per run on the card;
* :meth:`VectorizedDRAM.run_phase` — one phase over per-channel
  ``[C, L]`` streams through the per-channel scan (one launch of the
  ``dram_timing`` kernel on the card); the dynamic-graph path serves its
  ``ep{e}_apply`` rewrites this way.

The JAX package packs on the device when it runs on an accelerator; the
port packs on the host and copies the packed arrays to the card.  A
device pack is queued in ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import vectorized as vec
from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.device import resolve_device


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


@dataclasses.dataclass
class ProgramStats:
    """Accumulated DRAM statistics of one executed program — the surface
    :class:`SimReport` assembly reads."""

    phases: List[PhaseStats]
    now: int
    total_requests: int
    total_row_hits: int
    total_row_conflicts: int


def finalize_program(packed: PackedProgram, finish,
                     origin: int = 0) -> ProgramStats:
    """Turn the fused serve's per-step finishes (a NumPy array or a torch
    tensor on any device) into phase statistics.

    ``finish[s, c]`` is relative to the owning phase's start (0 on
    invalid lanes), so each phase's makespan is a segmented max (the
    per-step max is taken where ``finish`` lives); row hits/conflicts
    reduce from the host-precomputed kinds.  The absolute clock is the
    running (int64, overflow-free) sum of makespans."""
    P = packed.n_phases
    fin = torch.as_tensor(finish)[:packed.n_steps].amax(dim=(1, 2))
    fin = fin.cpu().numpy()
    dur = np.maximum.reduceat(fin, packed.step_starts).astype(np.int64)
    off = packed.offsets[:-1]
    hits = np.add.reduceat((packed.kind == 0).astype(np.int64), off)
    confl = np.add.reduceat((packed.kind == 2).astype(np.int64), off)
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


def serve_packed(packed: PackedProgram, timing=None, carry=None,
                 origin: int = 0, device=None,
                 stage_seconds: Optional[Dict[str, float]] = None):
    """Run one packed program through the fused serve on ``device`` from
    the given lean carry (default: cold DRAM state) and reduce it to
    :class:`ProgramStats`.  Returns ``(stats, lean_carry)``.

    ``timing`` overrides the timing vector packed with the program (the
    pack never depends on timing)."""
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
    stats = finalize_program(packed, fin, origin=origin)
    if stage_seconds is not None:
        stage_seconds["finalize"] = (stage_seconds.get("finalize", 0.0)
                                     + time.perf_counter() - t0)
    return stats, lean


class VectorizedDRAM:
    """Stateful multi-program DRAM simulation on ``device`` (default the
    card; raises when CUDA is absent).

    ``stage_seconds`` accumulates the wall time of the host pack, the
    host-to-device copy, the serve and the finalize of programs, and of
    the pack (``phase_pack``, copy included), the scan (``phase_serve``,
    CUDA events on the card) and the reductions (``phase_finalize``) of
    single phases."""

    def __init__(self, cfg: DRAMConfig, device=None):
        if cfg.effective_cache is not None:
            raise NotImplementedError(
                "the on-chip cache filter is not ported yet; see "
                "ROADMAP.md")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._timing = vec.timing_params(cfg.timing)
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

    def run_phase(self, trace: Trace, name: str = "phase") -> int:
        """Simulate one phase starting at the current clock (one
        per-channel scan: the ``dram_timing`` kernel on the card); returns
        its makespan (absolute memory cycle)."""
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
        """Serve a whole multi-phase program (host pack + one fused
        serve with the phase barriers honored inside it); returns the
        final absolute makespan."""
        t0 = time.perf_counter()
        packed = pack_program(program, self.cfg,
                              open_row=self.carry[0].cpu().numpy())
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
    cache_lookups: int = 0
    cache_hits: int = 0
    prefetch_hits: int = 0
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=dict, compare=False)
    kernel_launches: Dict[str, int] = dataclasses.field(
        default_factory=dict, compare=False)
