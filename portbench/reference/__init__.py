"""The plain reference the comparison holds the program to.

It imports nothing of the program.  From the benchmark's own graph arrays
and the configuration's numbers it runs the graph problem again, builds
the accelerator's request program again, serves it under each timing
vector of the grid, and assembles the report fields the program's
``SimReport`` carries.  The accelerator's model is found by name:
``portbench/reference/<accelerator>.py``, with ``run_algorithm`` and
``Model``.  The timing of the grid's points runs in a pool of processes,
one a point, as it is plain Python a request.
"""

from __future__ import annotations

import importlib
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

from portbench.reference import dram

#: report fields the comparison holds equal, in the program's order
REPORT_FIELDS = ("system", "problem", "graph", "runtime_ns", "iterations",
                 "edges", "vertices", "total_requests", "total_bytes",
                 "row_hit_rate", "phases", "cache_lookups", "cache_hits",
                 "prefetch_hits")
PHASE_FIELDS = ("name", "requests", "bytes", "start_cycle", "end_cycle",
                "row_hits", "row_conflicts")


def model_module(accelerator: str):
    return importlib.import_module(f"portbench.reference.{accelerator}")


def point_timing(config: dict, point: dict) -> Dict[str, int]:
    """The timing vector of a grid point: its own, or the configuration's
    memory's for the point that names none."""
    timing = point.get("timing") or config["memory"]["timing"]
    return {f: int(timing[f]) for f in dram.TIMING_FIELDS}


def _serve(args):
    device, program, timing, carry_state = args
    return dram.serve_program(device, program, timing, carry_state)


def report(config: dict, graph, run, device: dram.Device,
           served: List[dram.PhaseResult]) -> dict:
    phases = [{"name": ph.name, "requests": ph.requests,
               "bytes": ph.requests * dram.LINE_BYTES,
               "start_cycle": ph.start, "end_cycle": ph.end,
               "row_hits": ph.hits, "row_conflicts": ph.conflicts}
              for ph in served]
    total = sum(ph.requests for ph in served)
    hits = sum(ph.hits for ph in served)
    now = served[-1].end if served else 0
    return {"system": config["accelerator"], "problem": config["problem"],
            "graph": graph.name, "runtime_ns": now / device.clock_ghz,
            "iterations": run.iterations, "edges": graph.m,
            "vertices": graph.n, "total_requests": total,
            "total_bytes": sum(p["bytes"] for p in phases),
            "row_hit_rate": hits / max(total, 1), "phases": phases,
            "cache_lookups": 0, "cache_hits": 0, "prefetch_hits": 0}


def expected_reports(config: dict, graph, points: List[dict],
                     carry_state: bool = True,
                     processes: Optional[int] = None,
                     seconds: Optional[Dict[str, float]] = None
                     ) -> List[dict]:
    """One report a grid point, in the grid's order.  ``processes``: the
    pool's size (default one a point, at most the host's cores; 1 serves
    in this process); ``carry_state``: see :func:`dram.serve_program`;
    ``seconds``, when given, receives each stage's host seconds."""
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(stage):
        now = time.perf_counter()
        seconds[stage] = now - clock[0]
        clock[0] = now

    mod = model_module(config["accelerator"])
    acc = config["accelerator_config"]
    device = dram.Device.from_spec(config["memory"])
    run = mod.run_algorithm(graph, acc, config["problem"],
                            int(config.get("root", 0)))
    lap("algorithm")
    model = mod.Model(graph, acc, device)
    lap("model")
    program = dram.decode_program(device,
                                  model.phases(config["problem"], run))
    lap("trace")
    jobs = [(device, program, point_timing(config, pt), carry_state)
            for pt in points]
    if processes is None:
        processes = min(len(jobs), os.cpu_count() or 1)
    if processes <= 1:
        served = [_serve(j) for j in jobs]
    else:
        with ProcessPoolExecutor(
                max_workers=processes,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            served = list(pool.map(_serve, jobs))
    lap("timing")
    return [report(config, graph, run, device, s) for s in served]
