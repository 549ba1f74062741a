#!/usr/bin/env python3
"""Where one benchmark cell's time goes, by the program's spans.

    python3 tools/sweep_spans.py --workload <cell> --seed <n> \\
        [--seconds 12] [--ab 0] [--device cuda] [--root .]

Runs the cell's set-up as ``portbench/run.py`` does (the graph from the
seed, the grid, a cold and a warm call), with the cold call under the
program's span recorder (``repro_torch.spans.recording``), then a
closed-loop window of ``--seconds`` under ``torch.profiler`` with the
benchmark's ``portbench.window`` / ``portbench.call`` spans around it.
With ``--ab N`` it then runs N pairs of untraced windows of the same
length, the recorder closed in the first of each pair and open in the
second.  Prints one JSON line:

- ``cold``: ``cold_call_s``, and the recorder's seconds by span
  (``total_s``) and self seconds by span and thread (``self_s``,
  ``main`` or ``worker``), as ``portbench/spantrace.py::cold_split``;
- ``window``: ``portbench/spantrace.py::window_summary`` (device idle
  time by innermost program span, device time by launching span, the
  per-point figures), ``host_waits_per_point`` (the program's host-wait
  counter over the window, over its points) and ``host_ops_us`` (the
  outermost host ops inside ``sweep.serve``, ``sweep.pool`` and
  ``sweep.finalize``, by name) and ``serve_routes`` (the window's serve
  calls by route, ``kernels/dram_timing/ops.py::serve_routes``);
- ``span_cost_us``: a span's host cost with nothing recording, timed
  (``timed=True``), and with the recorder open;
- ``ab``: points per second of each untraced window, recorder off / on;
  ``warm``: the recorder's self seconds a point by span and thread
  (``cold_split`` over the recorder's windows, the workers' spans
  included, which the profiler does not see);
- ``card``: the card's name and power limit.

Nothing of the benchmark's result line is produced: no comparison with
the reference is made.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]


def _span_cost_us(spans, n: int = 200_000) -> dict:
    def per(make) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with make():
                pass
        return (time.perf_counter() - t0) / n * 1e6

    out = {"off": per(lambda: spans.span("sweep.report")),
           "timed": per(lambda: spans.span("sweep.prepare", timed=True))}
    with spans.recording(capacity=n + 1):
        out["recorder"] = per(lambda: spans.span("sweep.report"))
    return out


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--ab", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import bench, graphgen, spantrace
    from repro_torch import device as device_mod
    from repro_torch import spans
    from repro_torch.kernels.dram_timing.ops import serve_routes

    cell = bench.load_cell(args.workload, args.root)
    dev = torch.device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels.build import library
        torch.cuda.init()
        library()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    graph = graphgen.make_graph(cell.config["graph"], args.seed)
    grid = cell.traffic["grid"]
    grid = [grid[i] for i in graphgen.rng_for(args.seed, 1).permutation(
        len(grid))]
    program = bench.Program(cell, graph, grid, dev)
    t0 = time.perf_counter()
    with spans.recording() as rec:
        program.call()
        sync()
    cold_call_s = time.perf_counter() - t0
    program.call()
    sync()
    setup_s = time.perf_counter() - T_START
    cold = {"cold_call_s": cold_call_s, "setup_s": setup_s,
            "dropped": rec.dropped, **spantrace.cold_split(rec.spans())}

    def window(seconds: float, mark):
        points = 0
        w0 = time.perf_counter()
        with mark("portbench.window"):
            while True:
                with mark("portbench.call"):
                    points += len(program.call())
                if time.perf_counter() >= w0 + seconds:
                    break
        sync()
        return points, time.perf_counter() - w0

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    waits0 = device_mod.host_wait_count()
    routes0 = serve_routes()
    sync()
    prof.start()
    points, _ = window(args.seconds, torch.profiler.record_function)
    prof.stop()
    waits = device_mod.host_wait_count() - waits0
    routes = {k: v - routes0[k] for k, v in serve_routes().items()}
    events = spantrace.read_events(prof)
    del prof
    marks = spantrace.host_spans(events, ("portbench.",))
    lo, hi = next((s.start, s.end) for s in marks
                  if s.name == "portbench.window")
    calls = [(s.start, s.end) for s in marks if s.name == "portbench.call"]
    summary = spantrace.window_summary(events, lo, hi, points, calls)
    summary["host_waits_per_point"] = waits / points
    summary["serve_routes"] = routes
    summary["host_ops_us"] = {
        name: spantrace.host_ops_within(events, name)
        for name in ("sweep.serve", "sweep.pool", "sweep.finalize")}
    del events

    def untraced() -> float:
        p, s = window(args.seconds, lambda _n: contextlib.nullcontext())
        return p / s

    ab, warm, warm_points = [], [], 0
    for _ in range(args.ab):
        off = untraced()
        with spans.recording() as rec:
            p, s = window(args.seconds, lambda _n: contextlib.nullcontext())
        ab.append([off, p / s])
        warm.extend(rec.spans())
        warm_points += p
    warm_split = None
    if warm:
        own = spantrace.cold_split(warm)["self_s"]
        warm_split = {k: v / warm_points for k, v in own.items()}

    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "cold": cold, "window": summary,
                      "span_cost_us": _span_cost_us(spans), "ab": ab,
                      "warm_s_per_point": warm_split,
                      "card": _card() if on_card else "cpu"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
