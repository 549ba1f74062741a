"""Rapid accelerator prototyping on the PyTorch/CUDA port (the paper's §5
workflow, extended): sweep partition sizes, pipeline counts, DRAM types
and on-chip caches for AccuGraph in simulation, and sanity-check the
shortlist against the O(1) analytical model (§7 future work).

The same study as ``examples/graph_accelerator_study.py`` (the JAX
package's), with the same graph, design points and table, through
``repro_torch.sim``: design axes are plain config overrides, DRAM types
are ``memory=`` selectors, and ``sweep()`` deduplicates the shared WCC
executions across all design points.  Every run is on the CUDA device
unless ``--device cpu`` asks for the host; with no card and no
``--device cpu`` it raises.

Run:  PYTHONPATH=src python examples/torch_graph_accelerator_study.py
      [--device cpu] [--scale 13]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.core import analytical
from repro_torch.device import resolve_device
from repro_torch.graphs.generators import rmat
from repro_torch.sim import (SimSession, SweepCase, Sweeper, get_accelerator,
                             sweep)

EDGE_PIPELINES = (8, 16, 32)
MEMORIES = (("ddr4", None), ("hbm2-interleaved", "hbm2"))
CACHES = (None, "vertex-64k", "vertex-256k", "vertex-1m", "default")


def run(scale: int = 13, device=None, out=print) -> dict:
    """The study on ``rmat(scale, 16)`` on ``device``: prints the table and
    returns its rows and reports by part (``partitions``: ``(q, row,
    estimate)``, ``pipelines``: rows, ``memories`` and ``caches``: label
    -> report)."""
    g = rmat(scale, 16, seed=1).undirected_view()
    out(f"graph: n={g.n} m={g.m}\n")

    spec = get_accelerator("accugraph")
    sweeper = Sweeper(device=device)  # shared: one WCC run reused where q coincides

    out("== partition size sweep (WCC) ==")
    qs = (1024, 2048, 4096, g.n)
    rows = sweep(cases=[
        SweepCase(graph=g, problem="wcc", accelerator="accugraph",
                  config=spec.make_config(partition_elements=q))
        for q in qs
    ], sweeper=sweeper)
    partitions = []
    for q, row in zip(qs, rows):
        est = analytical.estimate_accugraph(g, row.case.problem,
                                            row.case.config,
                                            iterations=row.report.iterations)
        partitions.append((q, row, est))
        out(f"  q={q:6d}: sim {row.report.runtime_ms:7.3f} ms  "
            f"analytical {est.runtime_ns/1e6:7.3f} ms ({est.bound})")

    out("\n== edge pipelines sweep ==")
    pipelines = sweep(cases=[
        SweepCase(graph=g, problem="wcc", accelerator="accugraph",
                  config=spec.make_config(edge_pipelines=ep))
        for ep in EDGE_PIPELINES
    ], sweeper=sweeper)
    for ep, row in zip(EDGE_PIPELINES, pipelines):
        out(f"  pipelines={ep:2d}: {row.report.runtime_ms:7.3f} ms "
            f"greps={row.report.reps/1e9:.2f}")

    out("\n== DRAM type (paper §7 future work) ==")
    session = SimSession(g)
    memories = {}
    for name, memory in MEMORIES:
        r = session.run("wcc", "accugraph", edge_pipelines=64, memory=memory,
                        device=device)
        memories[name] = r
        out(f"  {name:18s}: {r.runtime_ms:7.3f} ms greps={r.reps/1e9:.2f}")
    out("\n(64 pipelines + HBM shows the bandwidth headroom the 16-pipe")
    out(" design cannot use — the [Gh19]-style DRAM/workload interaction)")

    out("\n== on-chip cache hierarchy (vertex BRAM sweep, WCC) ==")
    # the hierarchy layer is one more sweep axis: cache hits are dropped
    # before they reach DRAM, so a BRAM-budget ladder directly charts how
    # much of the working set each budget keeps on chip.
    caches = {}
    for cache in CACHES:
        r = session.run("wcc", "accugraph", cache=cache, device=device)
        label = cache or "no-cache"
        caches[label] = r
        out(f"  {label:18s}: {r.runtime_ms:7.3f} ms "
            f"hit-rate={r.cache_hit_rate:5.1%} "
            f"dram-requests={r.total_requests}")
    out("\n('default' is AccuGraph's declared vertex BRAM; HitGraph's")
    out(" default is a stream prefetcher — see repro_torch.sim.CACHE_PRESETS)")
    return {"partitions": partitions, "pipelines": pipelines,
            "memories": memories, "caches": caches}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=13,
                    help="R-MAT scale of the graph (2^scale vertices)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)
    return run(args.scale, resolve_device(args.device))


if __name__ == "__main__":
    main()
