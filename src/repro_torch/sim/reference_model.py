"""Event-driven reference accelerator (element granularity).

A deliberately simple vertex-centric pull machine expressed directly in
the paper's Fig. 6 abstraction graph (``core/abstractions.py``): per
iteration it

1. *prefetches* all vertex values sequentially (bulk producer through a
   cache-line buffer),
2. streams the CSR *pointer* array (vertex-pipeline paced) and the
   *neighbor* array (edge-pipeline paced), each through its own
   cache-line buffer — neighbor **value** accesses are BRAM-resident
   (everything fits on chip in this model) and are served by a request
   filter, i.e. on-chip, generating no DRAM traffic,
3. *writes back* changed values (bulk, cache-line buffered).

The iteration structure comes from the asynchronous vertex-centric
engine with a single block (``vertex_centric.run(g, problem, q=g.n)``, the
round sweep on the card), so results are exact; the DRAM is the
event-driven two-clock :class:`Engine` on the host.

This is the fidelity reference of the subsystem: every request is an
individual event through the producer/merger/mapper graph, which makes it
orders of magnitude slower than the vectorized trace models — use it on
small instances to sanity-check new accelerator or memory models.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.algorithms import vertex_centric
from repro_torch.algorithms.common import Problem, RunResult
from repro_torch.core.abstractions import (CacheLineBuffer, Engine,
                                           RequestFilter)
from repro_torch.core.accel import PhaseStats, SimReport
from repro_torch.core.dram import (CACHE_LINE_BYTES, CONTIGUOUS_ORDER,
                                   DRAMConfig, MemoryLayout, ddr4_2400r)
from repro_torch.graphs.formats import CSRPartitions, Graph


@dataclasses.dataclass(frozen=True)
class ReferenceConfig:
    """Configuration of the event-driven reference machine."""

    vertex_pipelines: int = 8
    edge_pipelines: int = 16
    acc_ghz: float = 0.2
    value_bytes: int = 4
    pointer_bytes: int = 4
    neighbor_bytes: int = 4
    dram: Optional[DRAMConfig] = None

    def dram_config(self) -> DRAMConfig:
        if self.dram is not None:
            return self.dram
        base = ddr4_2400r(channels=1, ranks=1)
        return dataclasses.replace(base, order=CONTIGUOUS_ORDER)


class ReferenceModel:
    """Single-block pull model over the event-driven abstraction graph."""

    def __init__(self, g: Graph, cfg: ReferenceConfig = ReferenceConfig()):
        self.cfg = cfg
        self.g = g
        self.dram = cfg.dram_config()
        parts = CSRPartitions.build(g, g.n)      # one block: all in BRAM
        self.block = parts.blocks[0]
        lay = MemoryLayout()
        self.values_base = lay.allocate("values", g.n * cfg.value_bytes)
        self.ptr_base = lay.allocate("pointers",
                                     (g.n + 1) * cfg.pointer_bytes)
        self.nbr_base = lay.allocate("neighbors",
                                     self.block.m * cfg.neighbor_bytes)
        if lay.total_bytes > self.dram.capacity_bytes:
            raise ValueError("graph does not fit DRAM capacity; scale down")

    # ------------------------------------------------------------------
    def _elem_stream(self, base: int, count: int, width: int):
        for i in range(count):
            yield (base + i * width) // CACHE_LINE_BYTES, False, None

    def _run_producer(self, eng: Engine, name: str, stream, rate,
                      write: bool = False) -> PhaseStats:
        start = eng.t_mem
        served0 = eng.dram.served
        hits0, _, confl0 = eng.dram.row_kind_counts
        prod = eng.producer(name, CacheLineBuffer(eng.dram), rate=rate)
        if write:
            stream = ((line, True, None) for (line, _, _) in stream)
        prod.trigger(stream, eng.t_mem)
        eng.run()
        hits1, _, confl1 = eng.dram.row_kind_counts
        return PhaseStats(
            name=name, requests=eng.dram.served - served0,
            bytes=(eng.dram.served - served0) * CACHE_LINE_BYTES,
            start_cycle=start, end_cycle=eng.dram.last_finish,
            row_hits=hits1 - hits0, row_conflicts=confl1 - confl0,
        )

    def simulate(self, problem: Problem, root: int = 0,
                 fixed_iters: Optional[int] = None,
                 run: Optional[RunResult] = None,
                 memory_system=None, device=None) -> SimReport:
        """Simulate; the algorithm runs on ``device`` (default the card)
        when ``run`` is not given, the engine on the host.
        ``memory_system`` is accepted for interface compatibility but
        must be ``None``: this model *is* the event-driven backend."""
        if memory_system is not None:
            raise ValueError("ReferenceModel is inherently event-driven; "
                             "it does not take an injected DRAM backend")
        cfg = self.cfg
        if run is None:
            run = vertex_centric.run(self.g, problem, q=self.g.n,
                                     root=root, fixed_iters=fixed_iters,
                                     device=device)
        t0 = time.perf_counter()
        eng = Engine(self.dram, acc_ghz=cfg.acc_ghz)
        # neighbor VALUE accesses are BRAM-resident -> filtered on-chip
        value_filter = RequestFilter(eng.dram, keep=lambda r: False)
        phases: List[PhaseStats] = []
        n, vb = self.g.n, cfg.value_bytes

        for it, st in enumerate(run.per_iter):
            # 1. sequential value prefetch (bulk)
            phases.append(self._run_producer(
                eng, f"it{it}_prefetch",
                self._elem_stream(self.values_base, n, vb), rate=None))
            # 2. pointer + neighbor streams, pipeline paced
            start = eng.t_mem
            served0 = eng.dram.served
            hits0, _, confl0 = eng.dram.row_kind_counts
            pp = eng.producer(
                f"it{it}_pointers", CacheLineBuffer(eng.dram),
                rate=cfg.vertex_pipelines)
            np_ = eng.producer(
                f"it{it}_neighbors", CacheLineBuffer(eng.dram),
                rate=cfg.edge_pipelines)
            pp.trigger(self._elem_stream(self.ptr_base, n + 1,
                                         cfg.pointer_bytes), eng.t_mem)
            np_.trigger(self._elem_stream(self.nbr_base, self.block.m,
                                          cfg.neighbor_bytes), eng.t_mem)
            # per-neighbor source-value accesses: all on-chip (Fig. 6f)
            vp = eng.producer(f"it{it}_values", value_filter,
                              rate=cfg.edge_pipelines)
            vp.trigger(
                ((int(self.values_base + v * vb) // CACHE_LINE_BYTES,
                  False, None) for v in self.block.neighbors), eng.t_mem)
            eng.run()
            hits1, _, confl1 = eng.dram.row_kind_counts
            phases.append(PhaseStats(
                name=f"it{it}_streams",
                requests=eng.dram.served - served0,
                bytes=(eng.dram.served - served0) * CACHE_LINE_BYTES,
                start_cycle=start, end_cycle=eng.dram.last_finish,
                row_hits=hits1 - hits0, row_conflicts=confl1 - confl0))
            # 3. changed-only value write-back (bulk)
            wdst = np.nonzero(st.changed)[0]
            lines = np.unique(
                (self.values_base + wdst * vb) // CACHE_LINE_BYTES)
            phases.append(self._run_producer(
                eng, f"it{it}_writes",
                ((int(l), False, None) for l in lines),
                rate=None, write=True))

        served = eng.dram.served
        hits = eng.dram.row_kind_counts[0]
        makespan = max(eng.dram.last_finish, eng.t_mem)
        return SimReport(
            system="reference", problem=problem.value, graph=self.g.name,
            runtime_ns=makespan / self.dram.clock_ghz,
            iterations=run.iterations, edges=self.g.m, vertices=self.g.n,
            total_requests=served,
            total_bytes=served * CACHE_LINE_BYTES,
            row_hit_rate=hits / max(served, 1),
            phases=phases,
            stage_seconds={"replay": time.perf_counter() - t0},
        )
