"""DRAM simulation backends behind one program-level interface.

A backend exposes the :class:`~repro_torch.core.accel.VectorizedDRAM`
surface the trace models and the dynamic path drive (``run_program``,
``run_phase``, ``invalidate_lines`` and the accumulated statistics).

* ``"vectorized"`` is the fused serve: the CUDA kernel on the card, its
  plain version on the CPU.
* ``"event"`` is the element-granularity replay through
  :class:`~repro_torch.core.timing.ChannelState` on the host, the
  fidelity reference the serve is held to (the two are bit-equivalent on
  integer cycle counts).  Its on-chip cache filter runs as the vectorized
  backend's does, with the lookup state on the run's device (the
  ``cache_lookup`` kernel on the card).  It is slower: one request at a
  time in Python.
"""

from __future__ import annotations

import time
from typing import Dict, List

from repro_torch.core import cache as cache_mod
from repro_torch.core.accel import PhaseStats, VectorizedDRAM
from repro_torch.core.dram import CACHE_LINE_BYTES, DRAMConfig
from repro_torch.core.timing import ROW_CONFLICT, ROW_HIT, ChannelState
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.device import resolve_device


class EventDRAM:
    """Event-driven multi-phase DRAM backend (the host reference path).

    Applies the same on-chip cache filter (``cfg.cache``) as the
    vectorized backend — per phase, with the lookup state chained across
    phases and kept on ``device`` (default the card) — so the two
    backends stay bit-equivalent under filtering.  ``stage_seconds``
    accumulates the filter's (``cache``) and the replay's (``replay``)
    wall time."""

    def __init__(self, cfg: DRAMConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.channels = [
            ChannelState(timing=cfg.timing, n_banks=cfg.banks_per_channel,
                         banks_per_rank=cfg.org.banks)
            for _ in range(cfg.channels)
        ]
        self.cache = cfg.effective_cache
        self._cache_state = cache_mod.init_state(self.cache, self.device)
        self.cache_stats = cache_mod.CacheStats()
        self.now = 0                     # memory-clock cycles
        self.phases: List[PhaseStats] = []
        self.total_requests = 0
        self.total_row_hits = 0
        self.total_row_conflicts = 0
        self.stage_seconds: Dict[str, float] = {}

    def _add_seconds(self, stage: str, seconds: float) -> None:
        self.stage_seconds[stage] = (self.stage_seconds.get(stage, 0.0)
                                     + seconds)

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
        range; returns the lines dropped (0 without a cache level)."""
        return cache_mod.invalidate_lines(self._cache_state, self.cache,
                                          line_ranges)

    def run_phase(self, trace: Trace, name: str = "phase") -> int:
        """Serve one phase in program order per channel, starting at the
        current clock; returns its makespan (absolute memory cycle)."""
        if self.cache is not None:
            t0 = time.perf_counter()
            trace, cs, self._cache_state = cache_mod.filter_trace(
                trace, self.cache, self._cache_state, device=self.device)
            self.cache_stats.merge(cs)
            self._add_seconds("cache", time.perf_counter() - t0)
        if len(trace) == 0:
            return self.now
        t0 = time.perf_counter()
        start = self.now
        issue = trace.issue + start
        comps = self.cfg.decode_lines(trace.line_addr)
        ch = comps["channel"]
        end = start
        hits = confl = 0
        for c in range(self.cfg.channels):
            m = ch == c
            if not m.any():
                continue
            fin, kind = self.channels[c].serve_many(
                issue[m].tolist(), comps["bank_in_channel"][m].tolist(),
                comps["row"][m].tolist())
            end = max(end, max(fin))
            hits += kind.count(ROW_HIT)
            confl += kind.count(ROW_CONFLICT)
        self.phases.append(PhaseStats(
            name=name, requests=len(trace),
            bytes=len(trace) * CACHE_LINE_BYTES,
            start_cycle=start, end_cycle=end,
            row_hits=hits, row_conflicts=confl,
        ))
        self.total_requests += len(trace)
        self.total_row_hits += hits
        self.total_row_conflicts += confl
        self.now = max(self.now, end)
        self._add_seconds("replay", time.perf_counter() - t0)
        return end

    def run_program(self, program: SegmentedTrace) -> int:
        """Serve a whole program phase by phase (element granularity)."""
        for p in range(program.n_phases):
            self.run_phase(program.phase(p), program.names[p])
        return self.now


BACKENDS: Dict[str, type] = {
    "vectorized": VectorizedDRAM,
    "event": EventDRAM,
}


def make_backend(backend: str, cfg: DRAMConfig, device=None):
    """Instantiate a DRAM backend by name for device ``cfg``, with its
    serve (``"vectorized"``) or its cache lookup (``"event"``) on
    ``device`` (default the card)."""
    try:
        cls = BACKENDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend {backend!r}; available: "
            f"{sorted(BACKENDS)}") from None
    return cls(cfg, device=device)
