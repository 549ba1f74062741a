#!/usr/bin/env python3
"""The scale ladders behind ``chip_smoke.py``'s ``REFERENCE_SCALE`` and
``STUDY_SCALE``, on one GPU.

    python3 tools/event_scales.py

For each step of ``REFERENCE_LADDER`` it runs WCC and BFS (from the
vertex of highest degree, as ``chip_smoke.py`` does) on the reference
machine over ``instantiate("wt", scale)``, and for each step of
``STUDY_LADDER`` AccuGraph's ``run_study`` (WCC, the Fig. 13 partition
size); a ladder stops at the first step past ``BUDGET_S`` seconds by the
host clock.  The largest step within the budget is the one
``chip_smoke.py`` pins.  Prints one JSON line per step, then the card's
name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

REFERENCE_LADDER = (0.01, 0.02, 0.05, 0.1, 0.2)
STUDY_LADDER = (0.1, 0.2, 0.5, 1.0)
BUDGET_S = 60.0


def main() -> int:
    if not torch.cuda.is_available():
        print("event_scales: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms.common import Problem
    from repro_torch.core import optimizations
    from repro_torch.core.accugraph import AccuGraphConfig
    from repro_torch.graphs.datasets import TABLE1, instantiate
    from repro_torch.sim import SimSession
    from repro_torch.sim.policy import scaled_q

    for scale in REFERENCE_LADDER:
        g = instantiate("wt", scale).undirected_view()
        root = int(np.argmax(g.out_degrees()))
        sess = SimSession(g)
        row = {"ladder": "reference", "scale": scale, "vertices": g.n,
               "edges": g.m, "root": root}
        t0 = time.perf_counter()
        for prob in ("wcc", "bfs"):
            t = time.perf_counter()
            r = sess.run(prob, "reference", root=root)
            row[prob] = {"seconds": time.perf_counter() - t,
                         "iterations": r.iterations,
                         "requests": r.total_requests}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if row["seconds"] > BUDGET_S:
            break
    for scale in STUDY_LADDER:
        g = instantiate("wt", scale).undirected_view()
        base = AccuGraphConfig(partition_elements=scaled_q(
            1_024_000, TABLE1["wt"].vertices, g.n))
        t0 = time.perf_counter()
        res = optimizations.run_study(g, Problem.WCC, base)
        seconds = time.perf_counter() - t0
        print(json.dumps({"ladder": "study", "scale": scale,
                          "vertices": g.n, "edges": g.m,
                          "seconds": seconds,
                          "speedups": {r.variant: r.speedup for r in res}}),
              flush=True)
        if seconds > BUDGET_S:
            break
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
