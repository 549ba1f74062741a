"""HitGraph [Zh19] — edge-centric scatter/gather accelerator model.

Faithful to paper Sect. 3.2 / Fig. 7:

* p horizontal partitions (by source vertex), stored as dst-sorted edge
  lists; partitions statically assigned to memory channels, one PE per
  channel (4 channels, DDR3-1600K, 2 ranks, Tab. 2).
* Per iteration: **scatter** (prefetch partition values -> read edges
  rate-limited to 8 pipelines -> produce updates through a per-partition
  crossbar + cache-line buffers into per-partition update queues), then a
  phase barrier, then **gather** (prefetch values -> read update queues ->
  semi-random value writes through a cache-line buffer).
* Optimizations of the original system (all modelled): dst-sorted update
  *merging* (u < n x p), active-bitmap update *filtering*, and partition
  *skipping* (unchanged / no-update partitions).

Vectorized realization: per-iteration statistics come from the
edge-centric engine; the whole run's request streams are emitted up front
by vectorized NumPy builders (segment-offset constructions over all
partitions at once — no per-partition or per-(k, j) Python loops, and the
per-iteration update merge is an adjacent-dedup over a once-sorted key
array instead of an ``np.unique`` sort) into one
:class:`~repro_torch.core.trace.SegmentedTrace`, which is packed on the
host and served by the fused DRAM serve with the inter-phase barriers
carried inside it.  The emitted program depends on the DRAM device only
through its geometry and clock — never its timing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.algorithms import edge_centric
from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core.accel import SimReport, VectorizedDRAM
from repro_torch.core.dram import (CACHE_LINE_BYTES, CONTIGUOUS_ORDER,
                                   DRAMConfig, MemoryLayout, ddr3_1600k)
from repro_torch.core.trace import (SegmentedTrace, ragged_bulk,
                                    ragged_spans, ragged_spread,
                                    span_counts)
from repro_torch.graphs.formats import Graph, partition_intervals


@dataclasses.dataclass(frozen=True)
class HitGraphConfig:
    """Tab. 4 'HitGraph' row (reproducibility defaults)."""

    n_pes: int = 4                    # == memory channels
    pipelines: int = 8                # edges/cycle per PE
    partition_elements: int = 256_000  # q
    acc_ghz: float = 0.2
    edge_bytes: int = 8               # 64 bit/edge (paper Sect. 4.2)
    update_bytes: int = 8             # (dst, value)
    value_bytes: int = 4              # 32-bit values (Tab. 3)
    update_merging: bool = True
    update_filtering: bool = True
    partition_skipping: bool = True
    dram: Optional[DRAMConfig] = None

    def dram_config(self) -> DRAMConfig:
        if self.dram is not None:
            return self.dram
        base = ddr3_1600k(channels=self.n_pes, ranks=2)
        return dataclasses.replace(base, order=CONTIGUOUS_ORDER)


def _spread(n: int, start: int, end: int) -> np.ndarray:
    """Issue lower bounds spread uniformly over a producing window."""
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1 or end <= start:
        return np.full(n, start, dtype=np.int64)
    return (start + (np.arange(n, dtype=np.float64) * (end - start) / n)
            ).astype(np.int64)


def _line_span(byte_start: int, nbytes: int) -> np.ndarray:
    """All lines of a sequential region (cache-line buffered)."""
    if nbytes <= 0:
        return np.empty(0, dtype=np.int64)
    first = byte_start // CACHE_LINE_BYTES
    last = (byte_start + nbytes - 1) // CACHE_LINE_BYTES
    return np.arange(first, last + 1, dtype=np.int64)


class HitGraphModel:
    """Builds the whole-run request program and simulates it."""

    def __init__(self, g: Graph, cfg: HitGraphConfig = HitGraphConfig()):
        self.cfg = cfg
        self.g = g.with_unit_weights() if g.weights is None else g
        self.dram = cfg.dram_config()
        q = cfg.partition_elements
        self.q = q
        self.intervals = partition_intervals(g.n, q)
        self.p = len(self.intervals)
        # partition-major, dst-sorted edge order: ONE stable argsort of
        # the composite (spart, dst) key — equivalent to the paper's
        # stable dst sort followed by a stable partition sort, and the
        # sorted key doubles as the update-merge key
        key = (self.g.src // q) * np.int64(g.n) + self.g.dst
        order = np.argsort(key, kind="stable")
        self.e_src = self.g.src[order]
        self.e_dst = self.g.dst[order]
        self.edge_key = key[order]                       # sorted
        self.e_spart = self.edge_key // g.n
        self.e_dpart = self.e_dst // q
        self.m_k = np.bincount(self.e_spart, minlength=self.p)
        self._layout()
        self._precompute_streams()

    # ------------------------------------------------------------------
    def _chan(self, k: int) -> int:
        return k % self.cfg.n_pes

    def _layout(self) -> None:
        """Per-channel contiguous arrays (channel = MSBs of the address)."""
        cfg, g = self.cfg, self.g
        cap_ch = self.dram.capacity_bytes // self.dram.channels
        self.layouts = [MemoryLayout(base=c * cap_ch)
                        for c in range(self.dram.channels)]
        self.val_base: List[int] = []
        self.edge_base: List[int] = []
        self.queue_base: List[int] = []
        in_counts = np.bincount(self.e_dpart, minlength=self.p)
        for k, (s, e) in enumerate(self.intervals):
            lay = self.layouts[self._chan(k)]
            n_k = e - s
            self.val_base.append(
                lay.allocate(f"values_{k}", n_k * cfg.value_bytes))
            self.edge_base.append(
                lay.allocate(f"edges_{k}",
                             int(self.m_k[k]) * cfg.edge_bytes))
            cap = int(min(in_counts[k], (n_k) * self.p)) + self.p
            self.queue_base.append(
                lay.allocate(f"queue_{k}", cap * cfg.update_bytes))
        for lay in self.layouts:
            if lay.total_bytes > cap_ch:
                raise ValueError(
                    "graph does not fit the per-channel capacity; use a "
                    "scaled dataset instance")

    def _precompute_streams(self) -> None:
        """Static per-partition stream extents (vectorized builders read
        these instead of re-deriving them every iteration)."""
        cfg = self.cfg
        starts = np.array([s for s, _ in self.intervals], dtype=np.int64)
        ends = np.array([e for _, e in self.intervals], dtype=np.int64)
        self._interval_start = starts
        self._val_base = np.asarray(self.val_base, dtype=np.int64)
        self._edge_base = np.asarray(self.edge_base, dtype=np.int64)
        self._queue_base = np.asarray(self.queue_base, dtype=np.int64)
        self._pre_first, self._pre_cnt = span_counts(
            self._val_base, (ends - starts) * cfg.value_bytes)
        self._edge_first, self._edge_cnt = span_counts(
            self._edge_base, self.m_k * cfg.edge_bytes)
        self._ratio = self.dram.clock_ghz / cfg.acc_ghz
        self._win = (np.ceil(self.m_k / cfg.pipelines)
                     * self._ratio).astype(np.int64)

    def _channel_cursor(self, w: np.ndarray) -> np.ndarray:
        """Exclusive per-channel cumulative PE cursor over partitions."""
        t0 = np.zeros(self.p, dtype=np.int64)
        for c in range(self.cfg.n_pes):
            sl = slice(c, None, self.cfg.n_pes)
            t0[sl] = np.cumsum(w[sl]) - w[sl]
        return t0

    # ------------------------------------------------------------------
    def _iteration_pairs(self, active: np.ndarray):
        """Merged updates per (src partition, dst): unique active pairs.

        ``O(m)`` per iteration: ``edge_key`` is sorted by construction,
        so this is a select + adjacent-dedup (replaces the per-iteration
        ``np.unique`` sort)."""
        if self.cfg.update_filtering:
            keys = self.edge_key[active[self.e_src]]
        else:
            keys = self.edge_key
        if self.cfg.update_merging and len(keys):
            keep = np.empty(len(keys), dtype=bool)
            keep[0] = True
            np.not_equal(keys[1:], keys[:-1], out=keep[1:])
            keys = keys[keep]
        k_part = keys // self.g.n
        dsts = keys % self.g.n
        return k_part, dsts

    def _scatter_phase(self, stationary: bool, active: np.ndarray,
                       u_count: np.ndarray, q_off: np.ndarray):
        """One iteration's scatter phase, all partitions vectorized."""
        cfg, p = self.cfg, self.p
        ub = cfg.update_bytes
        if cfg.partition_skipping and not stationary:
            proc = np.logical_or.reduceat(active, self._interval_start)
        else:
            proc = np.ones(p, dtype=bool)
        w = np.where(proc, np.maximum(self._win, 1), 0)
        t0 = self._channel_cursor(w)
        blk = p + 2                       # sub-stream id stride per k
        pk = np.nonzero(proc)[0]
        # 1. value prefetch (bulk, cache-line buffered)
        c0_lines = ragged_spans(self._pre_first[pk], self._pre_cnt[pk])
        c0_issue = ragged_bulk(t0[pk], self._pre_cnt[pk])
        c0_block = np.repeat(pk * blk, self._pre_cnt[pk])
        # 2. edge reads, rate-limited to `pipelines` edges/cycle
        c1_lines = ragged_spans(self._edge_first[pk], self._edge_cnt[pk])
        c1_issue = ragged_spread(t0[pk], self._win[pk], self._edge_cnt[pk])
        c1_block = np.repeat(pk * blk + 1, self._edge_cnt[pk])
        # 3. update writes through the crossbar to each queue j
        kk, jj = np.nonzero(u_count)      # row-major: k-major, j ascending
        sel = proc[kk]
        kk, jj = kk[sel], jj[sel]
        cnt = u_count[kk, jj]
        byte0 = self._queue_base[jj] + q_off[kk, jj] * ub
        w_first, w_cnt = span_counts(byte0, cnt * ub)
        c2_lines = ragged_spans(w_first, w_cnt)
        c2_issue = ragged_spread(t0[kk], self._win[kk], w_cnt)
        c2_block = np.repeat(kk * blk + 2 + jj, w_cnt)
        lines = np.concatenate([c0_lines, c1_lines, c2_lines])
        issue = np.concatenate([c0_issue, c1_issue, c2_issue])
        wr = np.zeros(len(lines), dtype=bool)
        wr[len(c0_lines) + len(c1_lines):] = True
        block = np.concatenate([c0_block, c1_block, c2_block])
        # PE-order concat, then the priority merge (stable sort by issue)
        order = np.argsort(block, kind="stable")
        order = order[np.argsort(issue[order], kind="stable")]
        return lines[order], wr[order], issue[order]

    def _gather_phase(self, changed: np.ndarray, dsts: np.ndarray,
                      dpart: np.ndarray, u_count: np.ndarray):
        """One iteration's gather phase, all partitions vectorized."""
        cfg, p = self.cfg, self.p
        ub, vb = cfg.update_bytes, cfg.value_bytes
        U = u_count.sum(axis=0)
        proc = (U > 0) if cfg.partition_skipping else np.ones(p, dtype=bool)
        win = (np.ceil(U / cfg.pipelines) * self._ratio).astype(np.int64)
        w = np.where(proc, np.maximum(win, 1), 0)
        t0 = self._channel_cursor(w)
        jk = np.nonzero(proc)[0]
        # 1. value prefetch
        c0_lines = ragged_spans(self._pre_first[jk], self._pre_cnt[jk])
        c0_issue = ragged_bulk(t0[jk], self._pre_cnt[jk])
        c0_block = np.repeat(jk * 3, self._pre_cnt[jk])
        # 2. update-queue reads, pipeline paced
        q_first, q_cnt = span_counts(self._queue_base, U * ub)
        c1_lines = ragged_spans(q_first[jk], q_cnt[jk])
        c1_issue = ragged_spread(t0[jk], win[jk], q_cnt[jk])
        c1_block = np.repeat(jk * 3 + 1, q_cnt[jk])
        # 3. semi-random value writes (changed only, line-buffered):
        #    per-partition unique lines via one lexsort + adjacent dedup
        sel = changed[dsts]
        jd, dd = dpart[sel], dsts[sel]
        line = (self._val_base[jd]
                + (dd - self._interval_start[jd]) * vb) // CACHE_LINE_BYTES
        order = np.lexsort((line, jd))
        jd, line = jd[order], line[order]
        if len(jd):
            keep = np.empty(len(jd), dtype=bool)
            keep[0] = True
            keep[1:] = (jd[1:] != jd[:-1]) | (line[1:] != line[:-1])
            jd, line = jd[keep], line[keep]
        w_cnt = np.bincount(jd, minlength=p)
        jp = np.nonzero(w_cnt)[0]
        c2_lines = line
        c2_issue = ragged_spread(t0[jp], win[jp], w_cnt[jp])
        c2_block = np.repeat(jp * 3 + 2, w_cnt[jp])
        lines = np.concatenate([c0_lines, c1_lines, c2_lines])
        issue = np.concatenate([c0_issue, c1_issue, c2_issue])
        wr = np.zeros(len(lines), dtype=bool)
        wr[len(c0_lines) + len(c1_lines):] = True
        block = np.concatenate([c0_block, c1_block, c2_block])
        order = np.argsort(block, kind="stable")
        order = order[np.argsort(issue[order], kind="stable")]
        return lines[order], wr[order], issue[order]

    # ------------------------------------------------------------------
    def build_program(self, problem: Problem,
                      run: RunResult) -> SegmentedTrace:
        """Emit every phase of the whole run up front as one segmented
        trace (scatter/gather per iteration, phase-relative issues)."""
        p = self.p
        phases = []
        for it, st in enumerate(run.per_iter):
            active = (st.active_before if not problem.stationary
                      else np.ones(self.g.n, dtype=bool))
            kp, dsts = self._iteration_pairs(active)
            dpart = dsts // self.q
            # updates grouped by (src part k, dst part j)
            u_count = np.bincount(
                kp * p + dpart, minlength=p * p).reshape(p, p)
            q_off = np.zeros((p, p), dtype=np.int64)
            q_off[1:] = np.cumsum(u_count, axis=0)[:-1]
            phases.append((f"it{it}_scatter", *self._scatter_phase(
                problem.stationary, active, u_count, q_off)))
            phases.append((f"it{it}_gather", *self._gather_phase(
                st.changed, dsts, dpart, u_count)))
        return SegmentedTrace.from_phases(phases)

    def make_report(self, problem: Problem, run: RunResult,
                    stats) -> SimReport:
        """Assemble the report from any executed DRAM-stats surface."""
        total_bytes = sum(ph.bytes for ph in stats.phases)
        return SimReport(
            system="hitgraph", problem=problem.value, graph=self.g.name,
            runtime_ns=stats.now / self.dram.clock_ghz,
            iterations=run.iterations, edges=self.g.m, vertices=self.g.n,
            total_requests=stats.total_requests, total_bytes=total_bytes,
            row_hit_rate=(stats.total_row_hits
                          / max(stats.total_requests, 1)),
            phases=stats.phases,
            cache_lookups=getattr(stats, "cache_lookups", 0),
            cache_hits=getattr(stats, "cache_hits", 0),
            prefetch_hits=getattr(stats, "prefetch_hits", 0),
        )

    def simulate(self, problem: Problem, root: int = 0,
                 fixed_iters: Optional[int] = None,
                 run: Optional[RunResult] = None,
                 memory_system=None, device=None) -> SimReport:
        """Simulate on ``device`` (default the card); ``memory_system``
        injects a DRAM backend (any object with the
        :class:`VectorizedDRAM` program interface)."""
        if run is None:
            run = edge_centric.run(self.g, problem, root=root,
                                   fixed_iters=fixed_iters,
                                   device=device)
        dram = (memory_system if memory_system is not None
                else VectorizedDRAM(self.dram, device=device))
        t0 = time.perf_counter()
        program = self.build_program(problem, run)
        trace_s = time.perf_counter() - t0
        dram.run_program(program)
        report = self.make_report(problem, run, dram)
        report.stage_seconds = {"trace": trace_s,
                                **getattr(dram, "stage_seconds", {})}
        return report


def simulate(g: Graph, problem: Problem,
             cfg: HitGraphConfig = HitGraphConfig(), root: int = 0,
             fixed_iters: Optional[int] = None, device=None) -> SimReport:
    """Simulate ``problem`` on HitGraph with ``cfg`` on ``device`` (default
    the card) through :func:`repro_torch.sim.simulate`, the one entry
    point for all accelerators, memories and backends, as a
    :class:`~repro_torch.sim.scenario.ScenarioSpec`."""
    from repro_torch import sim
    return sim.simulate(sim.ScenarioSpec(
        g, problem, accelerator="hitgraph", config=cfg, root=root,
        fixed_iters=fixed_iters), device=device)
