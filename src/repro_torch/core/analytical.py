"""Analytical performance model (the paper's §7 future work, built).

Closed-form runtime estimate per (accelerator, problem, graph) without
trace simulation: each phase's duration is the max of

* the producer window (pipeline rate limits),
* the DRAM service bound: ``bytes / achievable_bandwidth``, where the
  achievable bandwidth is derived from the *stream mix* — sequential
  streams approach the bus peak, interleaved k-way stream mixes and
  random writes degrade by a row-conflict model calibrated against the
  trace simulator.

Use cases: O(1) design-space sweeps (partition size, pipeline counts,
DRAM type) before running the trace simulator on the shortlist.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.algorithms.common import Problem
from repro_torch.core.accugraph import AccuGraphConfig
from repro_torch.core.dram import DRAMConfig
from repro_torch.core.hitgraph import HitGraphConfig
from repro_torch.graphs.formats import Graph, partition_intervals


def _achievable_fraction(cfg: DRAMConfig, n_streams: int,
                         random_frac: float) -> float:
    """Calibrated achievable-bandwidth fraction for a stream mix.

    ``n_streams`` concurrently interleaved sequential streams cause a row
    switch roughly every ``lines_per_row / n_streams`` lines when streams
    collide in a bank; fully random traffic pays the ACT-rate limits
    (tRRD/tFAW) — the same effects the trace simulator resolves exactly.
    """
    t = cfg.timing
    lines_per_row = cfg.org.lines_per_row
    # sequential component: amortized row-switch overhead
    switch_every = max(lines_per_row / max(n_streams, 1), 1.0)
    seq_cost = t.tBL + (t.tRP + t.tRCD) / switch_every
    # random component: ACT rate floor over banks of all ranks
    act_spacing = max(t.tFAW / 4.0, t.tRRD) / cfg.org.ranks
    rnd_cost = max(t.tBL, act_spacing)
    cost = (1 - random_frac) * seq_cost + random_frac * rnd_cost
    return t.tBL / cost


@dataclasses.dataclass
class AnalyticalEstimate:
    runtime_ns: float
    iterations: int
    bytes_total: int
    bound: str                      # "pipeline" | "memory"


def estimate_hitgraph(
    g: Graph, problem: Problem, cfg: HitGraphConfig = HitGraphConfig(),
    iterations: Optional[int] = None, activity: float = 1.0,
    update_ratio: float = 0.5,
) -> AnalyticalEstimate:
    """HitGraph runtime: per iteration, scatter + gather over p partitions
    spread over ``n_pes`` channels.

    ``activity``: mean fraction of iterations' partitions active;
    ``update_ratio``: merged updates per edge (u/m, < 1 by merging and
    filtering).  Defaults model stationary problems; pass measured values
    (e.g. from a converged run) for non-stationary ones.
    """
    dram = cfg.dram_config()
    if iterations is None:
        iterations = 1 if problem.stationary else 10
    q = cfg.partition_elements
    p = len(partition_intervals(g.n, q))
    ratio = dram.clock_ghz / cfg.acc_ghz
    per_ch_peak = dram.peak_gbps / dram.channels

    vals_bytes = g.n * cfg.value_bytes * activity
    edge_bytes = g.m * cfg.edge_bytes * activity
    upd_bytes = g.m * update_ratio * cfg.update_bytes * activity
    # scatter: prefetch + edges + update writes; gather: prefetch +
    # update reads + value writes
    scatter_bytes = vals_bytes + edge_bytes + upd_bytes
    gather_bytes = vals_bytes + upd_bytes + vals_bytes * update_ratio
    frac = _achievable_fraction(dram, n_streams=3, random_frac=0.1)
    bw = per_ch_peak * frac * min(cfg.n_pes, p)

    mem_ns = (scatter_bytes + gather_bytes) / bw
    pipe_cycles = (g.m * activity / cfg.pipelines            # edge reads
                   + g.m * update_ratio * activity / cfg.pipelines)
    pipe_ns = pipe_cycles / min(cfg.n_pes, p) / cfg.acc_ghz
    per_iter = max(mem_ns, pipe_ns)
    return AnalyticalEstimate(
        runtime_ns=per_iter * iterations,
        iterations=iterations,
        bytes_total=int((scatter_bytes + gather_bytes) * iterations),
        bound="memory" if mem_ns >= pipe_ns else "pipeline",
    )


def estimate_accugraph(
    g: Graph, problem: Problem, cfg: AccuGraphConfig = AccuGraphConfig(),
    iterations: Optional[int] = None, stall_factor: float = 1.05,
    changed_ratio: float = 0.3,
) -> AnalyticalEstimate:
    dram = cfg.dram_config()
    if iterations is None:
        iterations = 1 if problem.stationary else 6
    q = cfg.partition_elements or g.n
    p = int(np.ceil(g.n / q))
    vb, pb, nb = cfg.value_bytes, cfg.pointer_bytes, cfg.neighbor_bytes

    prefetch = g.n * vb                                   # once per iter
    dst_vals = (g.n * p - g.n) * vb                       # BRAM-filtered
    pointers = (g.n + 1) * p * pb
    nbrs = g.m * nb
    writes = g.n * changed_ratio * vb
    total = prefetch + dst_vals + pointers + nbrs + writes
    frac = _achievable_fraction(dram, n_streams=4, random_frac=0.05)
    mem_ns = total / (dram.peak_gbps * frac)

    pipe_cycles = p * (g.n / cfg.vertex_pipelines)
    pipe_cycles = max(pipe_cycles,
                      g.m * stall_factor / cfg.edge_pipelines)
    pipe_ns = pipe_cycles / cfg.acc_ghz
    per_iter = max(mem_ns, pipe_ns)
    return AnalyticalEstimate(
        runtime_ns=per_iter * iterations,
        iterations=iterations,
        bytes_total=int(total * iterations),
        bound="memory" if mem_ns >= pipe_ns else "pipeline",
    )
