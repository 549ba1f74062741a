"""AccuGraph [Ya18] — vertex-centric pull accelerator model.

Faithful to paper Sect. 3.3 / Fig. 8:

* inverse-CSR blocks per source interval (values of the interval resident
  in BRAM while the block is processed); single DDR4-2400R channel.
* Per block: sequential *prefetch* of the interval's values; *destination
  value + pointer* streams (values filtered by BRAM residency, merged
  round-robin with pointers, paced by 8 vertex pipelines); *neighbor*
  stream (sequential CSR, paced by 16 edge pipelines **and stalled by
  vertex-cache bank conflicts** — 16 BRAM banks, one value per cycle
  each); changed-only value *writes* (highest priority).
* Asynchronous accumulation: value changes apply directly to BRAM, which
  is why AccuGraph needs fewer iterations than HitGraph (Fig. 12b) — the
  iteration structure comes from the asynchronous sweep engine.

Sect. 5 enhancements (both modelled, default off to match the baseline):
*prefetch skipping* (skip re-prefetch when the previous processed block is
the same) and *partition skipping* (dirty-bit per interval).

Vectorized realization: a block's destination-value / pointer / neighbor
streams are *static* across iterations, so they are built (and
priority-sorted) once at model construction; each iteration only computes
the changed-value write lines and splices them into the pre-sorted static
stream with a stable two-pointer merge (``searchsorted``), emitting the
whole run as one :class:`~repro_torch.core.trace.SegmentedTrace` that is
packed on the host and served by the fused DRAM serve.  Like HitGraph,
the emitted program is a function of the DRAM geometry and clock only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.algorithms import vertex_centric
from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core.accel import SimReport, VectorizedDRAM
from repro_torch.core.dram import (CACHE_LINE_BYTES, DRAMConfig,
                                   MemoryLayout, ddr4_2400r)
from repro_torch.core.hitgraph import CONTIGUOUS_ORDER, _line_span, _spread
from repro_torch.core.trace import SegmentedTrace, bulk_issue
from repro_torch.graphs.formats import CSRPartitions, Graph


@dataclasses.dataclass(frozen=True)
class AccuGraphConfig:
    """Tab. 4 'AccuGraph' row (reproducibility defaults)."""

    vertex_pipelines: int = 8
    edge_pipelines: int = 16
    partition_elements: Optional[int] = None    # None -> all in BRAM
    acc_ghz: float = 0.2
    value_bytes: int = 4          # 1 for BFS (Tab. 3: 8-bit values)
    pointer_bytes: int = 4
    neighbor_bytes: int = 4
    vertex_cache_banks: int = 16
    vertex_cache_ports: int = 2       # BRAM is dual-ported
    model_stalls: bool = True
    prefetch_skipping: bool = False             # paper Sect. 5 (ours)
    partition_skipping: bool = False            # paper Sect. 5 (ours)
    dram: Optional[DRAMConfig] = None
    dram_density: str = "4Gb"

    def dram_config(self) -> DRAMConfig:
        if self.dram is not None:
            return self.dram
        base = ddr4_2400r(channels=1, ranks=1, density=self.dram_density)
        return dataclasses.replace(base, order=CONTIGUOUS_ORDER)


class AccuGraphModel:
    def __init__(self, g: Graph, cfg: AccuGraphConfig = AccuGraphConfig()):
        self.cfg = cfg
        self.g = g
        self.dram = cfg.dram_config()
        self.q = (cfg.partition_elements if cfg.partition_elements
                  else g.n)
        self.parts = CSRPartitions.build(g, self.q)
        self.p = self.parts.p
        self._layout()
        self._stall_cycles = [self._block_stalls(k) for k in range(self.p)]
        self._precompute_streams()

    def _layout(self) -> None:
        cfg = self.cfg
        lay = MemoryLayout()
        self.values_base = lay.allocate(
            "values", self.g.n * cfg.value_bytes)
        self.ptr_base: List[int] = []
        self.nbr_base: List[int] = []
        for k in range(self.p):
            blk = self.parts.blocks[k]
            self.ptr_base.append(lay.allocate(
                f"pointers_{k}", (self.g.n + 1) * cfg.pointer_bytes))
            self.nbr_base.append(lay.allocate(
                f"neighbors_{k}", blk.m * cfg.neighbor_bytes))
        if lay.total_bytes > self.dram.capacity_bytes:
            raise ValueError("graph does not fit DRAM capacity; scale down")
        self.layout = lay

    def _block_stalls(self, k: int) -> int:
        """Vertex-cache bank-conflict-adjusted cycles to stream block k's
        neighbors (paper Sect. 3.3: 16 BRAM banks; a neighbor's value
        request stalls until its bank can serve it).

        Hardware detail (AccuGraph's data-conflict management): identical
        ids within a group are served by a single broadcast read, banks
        are dual-ported, and requests queue per bank rather than stalling
        the whole front per cycle — so the block's neighbor stream takes
        ``max(ideal, max_b ceil(total_distinct_requests_b / ports))``
        cycles.  Stalls therefore only bite when bank *totals* are skewed
        (hot id residues), matching the original article's observation
        that stalls matter yet throughput stays near 16 edges/cycle on
        well-behaved graphs."""
        cfg = self.cfg
        nbrs = self.parts.blocks[k].neighbors
        m_k = len(nbrs)
        ep = cfg.edge_pipelines
        ideal = int(np.ceil(m_k / ep))
        if not cfg.model_stalls or m_k == 0:
            return ideal
        banks = cfg.vertex_cache_banks
        pad = (-m_k) % ep
        ids = np.concatenate(
            [nbrs, np.full(pad, -1, dtype=np.int64)])
        groups = ids.reshape(-1, ep)
        rows = np.repeat(np.arange(len(groups), dtype=np.int64), ep)
        flat = groups.ravel()
        valid = flat >= 0
        # broadcast: only *distinct* ids per (group, bank) occupy a port
        keys = (rows[valid] << 32) + flat[valid]
        uniq = np.unique(keys)
        u_banks = (uniq & 0xFFFFFFFF) % banks
        per_bank = np.bincount(u_banks, minlength=banks)
        queued = int(np.ceil(per_bank.max() / cfg.vertex_cache_ports))
        return max(ideal, queued)

    def _precompute_streams(self) -> None:
        """Per-block streams that do not change across iterations: the
        prefetch trace and the priority-sorted (dv + pointer + neighbor)
        read stream.  Built once; iterations only merge in the
        changed-value writes."""
        cfg, n = self.cfg, self.g.n
        vb, pb, nb = cfg.value_bytes, cfg.pointer_bytes, cfg.neighbor_bytes
        ratio = self.dram.clock_ghz / cfg.acc_ghz
        self._ratio = ratio
        v_window = int(np.ceil(n / cfg.vertex_pipelines) * ratio)
        self._prefetch: List[np.ndarray] = []
        self._static_line: List[np.ndarray] = []
        self._static_issue: List[np.ndarray] = []
        self._e_window: List[int] = []
        for k in range(self.p):
            s, e = self.parts.intervals[k]
            self._prefetch.append(
                _line_span(self.values_base + s * vb, (e - s) * vb))
            # destination value stream (filtered by BRAM residency)
            # + pointer stream, vertex-pipeline paced
            dv_lines = np.concatenate([
                _line_span(self.values_base, s * vb),
                _line_span(self.values_base + e * vb, (n - e) * vb),
            ])
            dv_issue = _spread(len(dv_lines), 0, v_window)
            ptr_lines = _line_span(self.ptr_base[k], (n + 1) * pb)
            ptr_issue = _spread(len(ptr_lines), 0, v_window)
            # neighbor stream, edge-pipeline paced + cache stalls
            m_k = self.parts.blocks[k].m
            nl = _line_span(self.nbr_base[k], m_k * nb)
            e_window = int(self._stall_cycles[k] * ratio)
            nl_issue = _spread(len(nl), 0, max(e_window, 1))
            line = np.concatenate([dv_lines, ptr_lines, nl])
            issue = np.concatenate([dv_issue, ptr_issue, nl_issue])
            order = np.argsort(issue, kind="stable")  # priority merge
            self._static_line.append(line[order])
            self._static_issue.append(issue[order])
            self._e_window.append(e_window)

    def _block_phase(self, k: int, changed_k: np.ndarray):
        """One block's phase trace: splice this iteration's changed-value
        writes (highest priority on ties is *not* reordered — the static
        streams registered first win equal issue cycles, exactly like the
        legacy concat + stable sort) into the pre-sorted static stream."""
        cfg = self.cfg
        wdst = np.nonzero(changed_k)[0]
        w_line = (self.values_base
                  + wdst * cfg.value_bytes) // CACHE_LINE_BYTES
        if len(w_line):                       # ascending -> adjacent dedup
            keep = np.empty(len(w_line), dtype=bool)
            keep[0] = True
            np.not_equal(w_line[1:], w_line[:-1], out=keep[1:])
            w_line = w_line[keep]
        w_issue = _spread(len(w_line), 0, max(self._e_window[k], 1))
        s_line, s_issue = self._static_line[k], self._static_issue[k]
        n_s, n_w = len(s_line), len(w_line)
        # stable merge (static side wins ties, matching concat order)
        pos_w = np.searchsorted(s_issue, w_issue, side="right") \
            + np.arange(n_w, dtype=np.int64)
        pos_s = np.searchsorted(w_issue, s_issue, side="left") \
            + np.arange(n_s, dtype=np.int64)
        line = np.empty(n_s + n_w, dtype=np.int64)
        issue = np.empty(n_s + n_w, dtype=np.int64)
        wr = np.zeros(n_s + n_w, dtype=bool)
        line[pos_s] = s_line
        line[pos_w] = w_line
        issue[pos_s] = s_issue
        issue[pos_w] = w_issue
        wr[pos_w] = True
        return line, wr, issue

    # ------------------------------------------------------------------
    def build_program(self, problem: Problem,
                      run: RunResult) -> SegmentedTrace:
        """Emit every phase of the whole run up front (prefetch + block
        phases per iteration, phase-relative issues)."""
        cfg = self.cfg
        phases = []
        last_prefetched = -1
        for it, st in enumerate(run.per_iter):
            for k in range(self.p):
                changed_k = (st.changed_per_block[k]
                             if st.changed_per_block is not None else None)
                if changed_k is None:
                    continue        # block skipped (partition skipping)
                # 1. prefetch interval values into BRAM.  The block body
                #    *pulls from BRAM*, so it waits for the prefetch to
                #    complete — this serial latency is exactly what the
                #    paper's prefetch-skipping enhancement removes.
                if not (cfg.prefetch_skipping and last_prefetched == k):
                    pre = self._prefetch[k]
                    phases.append((f"it{it}_b{k}_prefetch", pre,
                                   np.zeros(len(pre), dtype=bool),
                                   bulk_issue(len(pre), 0)))
                last_prefetched = k
                phases.append((f"it{it}_b{k}",
                               *self._block_phase(k, changed_k)))
        return SegmentedTrace.from_phases(phases)

    def make_report(self, problem: Problem, run: RunResult,
                    stats) -> SimReport:
        """Assemble the report from any executed DRAM-stats surface."""
        total_bytes = sum(ph.bytes for ph in stats.phases)
        return SimReport(
            system="accugraph", problem=problem.value, graph=self.g.name,
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
        cfg = self.cfg
        if run is None:
            run = vertex_centric.run(
                self.g, problem, q=self.q, root=root,
                fixed_iters=fixed_iters,
                block_skipping=cfg.partition_skipping, device=device,
            )
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
             cfg: AccuGraphConfig = AccuGraphConfig(), root: int = 0,
             fixed_iters: Optional[int] = None, device=None) -> SimReport:
    """Simulate ``problem`` on AccuGraph with ``cfg`` on ``device`` (default
    the card) through :func:`repro_torch.sim.simulate`, the one entry
    point for all accelerators, memories and backends, as a
    :class:`~repro_torch.sim.scenario.ScenarioSpec`."""
    from repro_torch import sim
    return sim.simulate(sim.ScenarioSpec(
        g, problem, accelerator="accugraph", config=cfg, root=root,
        fixed_iters=fixed_iters), device=device)
