"""Quickstart on the PyTorch/CUDA port: the paper's pipeline end to end,
through the unified ``repro_torch.sim`` API.

The same walk as ``examples/quickstart.py`` (the JAX package's), with the
same graphs, configurations and table, on the port:

    from repro_torch.sim import simulate, sweep, list_accelerators

    simulate(g, "wcc", accelerator="hitgraph")          # one run
    simulate(g, "wcc", accelerator="accugraph",
             memory="hbm2")                             # any memory
    simulate(g, "wcc", accelerator="accugraph",
             backend="event")                           # fidelity check
    sweep(graphs=[g], problems=["wcc"],
          accelerators=["hitgraph", "accugraph"])       # grids, deduped

1. build a graph, 2. run WCC on both vectorized trace models, 3. compare
runtime/REPS, 4. sweep the paper's §5 optimization variants, 5. peek at
the per-phase DRAM statistics, 6. cross-check the event-driven backend on
a small graph.  Every entry point runs on the CUDA device unless
``--device cpu`` asks for the host; with no card and no ``--device cpu``
it raises.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--scale 13]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.device import resolve_device
from repro_torch.graphs.generators import rmat
from repro_torch.sim import (get_accelerator, list_accelerators, simulate,
                             sweep)

#: the optimization variants of the paper's §5 (AccuGraph, WCC)
VARIANTS = ("baseline", "prefetch_skip", "partition_skip", "both")
#: the R-MAT scale of the event-driven cross-check's graph
SMALL_SCALE = 9


def run(scale: int = 13, device=None, out=print) -> dict:
    """The quickstart on ``rmat(scale, 8)`` on ``device``: prints the
    table and returns its reports (``hitgraph``, ``accugraph``), the
    variant rows (``variants``) and the cross-check's reports
    (``cross_check``: backend -> report)."""
    g = rmat(scale, 8, seed=0).undirected_view()
    out(f"graph: n={g.n}, m={g.m}, avg degree {g.avg_degree:.1f}")
    out(f"registered accelerators: {list_accelerators()}\n")

    hg = simulate(g, "wcc", accelerator="hitgraph", partition_elements=2048,
                  device=device)
    ag = simulate(g, "wcc", accelerator="accugraph", partition_elements=2048,
                  device=device)

    out("   system    runtime     iters   GREPS   row-hit-rate")
    for r in (hg, ag):
        out(f"{r.system:>9s}  {r.runtime_ms:8.3f} ms  {r.iterations:5d} "
            f"  {r.reps / 1e9:5.2f}   {r.row_hit_rate:.3f}")
    out("\nNote: HitGraph has 4 DDR3 channels vs AccuGraph's single DDR4"
        "\nchannel here (the papers' own configs).\n")

    out("paper §5 optimizations (AccuGraph, WCC), one sweep() call:")
    ag_cfg = get_accelerator("accugraph").make_config(
        partition_elements=2048)
    rows = sweep(graphs=[g], problems=["wcc"], accelerators=["accugraph"],
                 variants=list(VARIANTS), configs={"accugraph": ag_cfg},
                 device=device)
    base = rows[0].report.runtime_ns
    for row in rows:
        out(f"  {row.variant:15s} {row.report.runtime_ms:8.3f} ms "
            f"({base / max(row.report.runtime_ns, 1e-9):.2f}x)")

    out("\nper-phase DRAM statistics (AccuGraph, first 4 phases):")
    for ph in ag.phases[:4]:
        out(f"  {ph.name:18s} reqs={ph.requests:6d} "
            f"hits={ph.row_hits:6d} conflicts={ph.row_conflicts:4d} "
            f"cycles=[{ph.start_cycle}, {ph.end_cycle}]")

    out("\nevent-driven cross-check (small graph, element granularity):")
    gs = rmat(SMALL_SCALE, 4, seed=0).undirected_view()
    cross = {}
    for backend in ("vectorized", "event"):
        cross[backend] = simulate(gs, "wcc", accelerator="accugraph",
                                  backend=backend, device=device)
        out(f"  {backend:11s} {cross[backend].runtime_ms:8.4f} ms")
    return {"hitgraph": hg, "accugraph": ag, "variants": rows,
            "cross_check": cross}


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=13,
                    help="R-MAT scale of the main graph (2^scale vertices)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the host (default: the card)")
    args = ap.parse_args(argv)
    return run(args.scale, resolve_device(args.device))


if __name__ == "__main__":
    main()
