"""One run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the accelerator,
its parameters, the memory device, the graph) and a traffic mix
(``traffic/<name>.json``: how the grid is driven and its timing
vectors); its metrics are found by name, a per-layer metric's reader in
``metrics/<name>.py``.  A run:

1. set-up: loads the program's kernel library (built once a checkout, in
   its ``build/`` directory), makes the graph from the seed, builds the
   program's grid and calls it twice, cold and warm;
2. the window: a closed loop of one client, one call of the whole grid
   after another for ``--seconds``; with ``--trace 1`` under
   ``torch.profiler``;
3. the comparison: once the window has closed and the program's state is
   freed, the plain reference works out every grid point's report again
   and every report of the window is held to it.

The program is the PyTorch and CUDA port, ``src/repro_torch``; nothing
here imports the JAX package or JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

from portbench import compare, graphgen
from portbench.reference import expected_reports

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in the process that prints
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class BenchError(RuntimeError):
    """A cell that cannot run here; the run prints no result."""


@dataclasses.dataclass
class Cell:
    name: str
    folder: Path         # the benchmark's folder: configs, traffic, metrics
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    folder = root / bench["paths"][0]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads(
        (folder / "traffic" / f"{w['traffic']}.json").read_text())
    if traffic["memory_standard"] != config["memory"]["standard"]:
        raise BenchError(
            f"traffic {w['traffic']!r} sweeps {traffic['memory_standard']} "
            f"timings, configuration {w['config']!r} has "
            f"{config['memory']['standard']}")
    return Cell(name, folder, int(w["chips"]), config, traffic,
                [m for m in bench["end_to_end"] if _in_cell(m, name)],
                [m for m in bench["per_layer"] if _in_cell(m, name)])


def load_reader(metric: str, folder: Path = HERE) -> Callable:
    """``read(reading) -> float | None`` of ``metrics/<metric>.py``."""
    path = folder / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def import_program():
    """The port, from the checkout's ``src`` (and from nowhere else)."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    try:
        import repro_torch
    except ImportError as e:
        raise BenchError(f"the program is not in {src}: {e}") from e
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT):
        raise BenchError(f"repro_torch loaded from {repro_torch.__file__}, "
                         f"outside the checkout {ROOT}")
    return repro_torch


class Program:
    """The program's side of a cell: the graph handed over, the grid
    built, one call a grid of reports."""

    def __init__(self, cell: Cell, graph: graphgen.GraphArrays,
                 grid: List[dict], device):
        from repro_torch.core.dram import DRAMTiming
        from repro_torch.graphs.formats import Graph
        from repro_torch.sim.registry import get_accelerator
        cfg, traffic = cell.config, cell.traffic
        self.graph = Graph(graph.n, graph.src.copy(), graph.dst.copy(),
                           directed=graph.directed, name=graph.name)
        spec = get_accelerator(cfg["accelerator"])
        self.acc = spec.config_cls(**cfg["accelerator_config"])
        base = self.acc.dram_config()
        self.memories = [
            None if "timing" not in pt else dataclasses.replace(
                base, timing=DRAMTiming(**pt["timing"]),
                name=f"{base.name}@{pt['name']}-timing")
            for pt in grid]
        self.problem, self.accelerator = cfg["problem"], cfg["accelerator"]
        self.root, self.device = int(cfg.get("root", 0)), device
        entry = traffic["entry"]
        if entry == "sweeper":
            from repro_torch.sim.sweep import SweepCase, Sweeper
            self.cases = [SweepCase(graph=self.graph, problem=self.problem,
                                    accelerator=self.accelerator, memory=m,
                                    config=self.acc, root=self.root)
                          for m in self.memories]
            self.sweeper = Sweeper(
                batch_memories=bool(traffic["batch_memories"]),
                workers=int(traffic["workers"]), device=device)
            self.call = self._sweep
        elif entry == "session":
            from repro_torch.sim.session import SimSession
            self.session = SimSession(self.graph)
            self.call = self._session
        else:
            raise BenchError(f"unknown traffic entry {entry!r}")

    def _sweep(self):
        return [row.report for row in self.sweeper.run(self.cases)]

    def _session(self):
        return [self.session.run(self.problem, self.accelerator,
                                 config=self.acc, memory=m, root=self.root,
                                 device=self.device)
                for m in self.memories]


def serve_recorder(calls: List[dict]):
    """Wrap the program's two serve entries (``fused_scan_batch``, one
    ``dram_serve_batch`` a signature group; ``fused_scan``, one
    ``dram_serve`` a case) so that each call records its shapes and runs
    under a ``portbench.serve`` span; returns the undo."""
    import torch
    from repro_torch.core import vectorized as vec
    batch, single = vec.fused_scan_batch, vec.fused_scan

    def fused_scan_batch(issue, meta, boundary, timing, n_banks,
                         banks_per_rank, device):
        S, C, K = (int(x) for x in issue.shape[-3:])
        calls.append(dict(S=S, C=C, K=K, B=int(n_banks),
                          R=int(n_banks) // int(banks_per_rank),
                          M=len(timing), shared=len(issue.shape) == 3))
        with torch.profiler.record_function("portbench.serve"):
            return batch(issue, meta, boundary, timing, n_banks,
                         banks_per_rank, device)

    def fused_scan(issue, meta, boundary, timing, carry, device,
                   stage_seconds=None):
        S, C, K = (int(x) for x in issue.shape)
        calls.append(dict(S=S, C=C, K=K, B=int(carry[0].shape[-1]),
                          R=int(carry[4].shape[-1]), M=1, shared=True))
        with torch.profiler.record_function("portbench.serve"):
            return single(issue, meta, boundary, timing, carry, device,
                          stage_seconds=stage_seconds)

    vec.fused_scan_batch, vec.fused_scan = fused_scan_batch, fused_scan

    def undo():
        vec.fused_scan_batch, vec.fused_scan = batch, single
    return undo


def power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def p90(values: List[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=10, method="inclusive")[-1]


def log(**kw) -> None:
    print("portbench " + json.dumps(kw), file=sys.stderr, flush=True)


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", root: Path = ROOT,
        reference_processes: Optional[int] = None) -> dict:
    """One run of cell ``workload`` of ``root/BENCHMARK.json``; returns
    the result line's object.  ``t_start`` is the process's start by
    ``time.perf_counter``; ``device="cpu"`` runs the program's plain
    versions (the tests' path: no card is looked for)."""
    cell = load_cell(workload, root)
    marks = {"start": time.perf_counter() - t_start}
    import torch
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("no CUDA device")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"cell {workload} needs {cell.chips} "
                             f"devices, {torch.cuda.device_count()} here")
    import_program()
    from repro_torch.kernels import launch_counts
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from repro_torch.kernels.build import library
        torch.cuda.init()
        marks["torch"] = time.perf_counter() - t_start
        library()
    marks["program"] = time.perf_counter() - t_start

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---- set-up -------------------------------------------------------
    graph = graphgen.make_graph(cell.config["graph"], seed)
    grid = cell.traffic["grid"]
    grid = [grid[i] for i in graphgen.rng_for(seed, 1).permutation(
        len(grid))]
    program = Program(cell, graph, grid, dev)
    t0 = time.perf_counter()
    marks["graph"] = t0 - t_start
    cold = program.call()
    sync()
    cold_call_s = time.perf_counter() - t0
    marks["cold"] = time.perf_counter() - t_start
    program.call()
    sync()
    setup_s = time.perf_counter() - t_start
    marks["warm"] = setup_s
    log(setup_marks_s=marks, cold_call_s=cold_call_s,
        cold_stage_seconds=[r.stage_seconds for r in cold])

    # ---- the window ---------------------------------------------------
    serve_calls: List[dict] = []
    prof = undo = None
    if trace:
        undo = serve_recorder(serve_calls)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    launches0 = launch_counts()
    calls: List[Optional[list]] = []
    latency: List[float] = []
    n_points = len(grid)
    span = (torch.profiler.record_function if trace
            else lambda _name: contextlib.nullcontext())
    sync()
    w0 = time.perf_counter()
    deadline = w0 + seconds
    try:
        with span("portbench.window"):
            while True:
                c0 = time.perf_counter()
                try:
                    with span("portbench.call"):
                        reports = program.call()
                except Exception:
                    traceback.print_exc(file=sys.stderr)
                    reports = None
                c1 = time.perf_counter()
                latency.append(c1 - c0)
                calls.append(None if reports is None
                             else [compare.as_fields(r) for r in reports])
                if c1 >= deadline:
                    break
    finally:
        sync()
        w1 = time.perf_counter()
        if prof is not None:
            prof.stop()
            undo()
    launches1 = launch_counts()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        log(card=power_limit())
    done = sum(len(c) for c in calls if c is not None)
    reading = {
        "points": done, "window_s": w1 - w0, "cold_call_s": cold_call_s,
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "serve_calls": serve_calls,
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu"}
    busy = None
    breakdown = None
    if prof is not None:
        from portbench import devicetrace
        iv = devicetrace.profile_intervals(prof)
        marks = [(a, b) for n, a, b in iv["host"]
                 if n == "portbench.window"]
        lo, hi = marks[0] if marks else (0.0, 0.0)
        reading["device"] = devicetrace.clip(iv["device"], lo, hi)
        reading["traced_window_us"] = (lo, hi)
        busy = devicetrace.busy_us(reading["device"]) / 1e6
        traced_s = (hi - lo) / 1e6
        breakdown = {
            "device_ops": devicetrace.top_ops(reading["device"]),
            "idle_gaps": devicetrace.idle_gaps(
                reading["device"], devicetrace.clip(iv["host"], lo, hi),
                lo, hi)}
        del prof, iv

    # ---- metrics --------------------------------------------------------
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = load_reader(m["name"], cell.folder)(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"points_per_s": done / (w1 - w0),
               "call_p90_ms": p90(latency) * 1e3, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]],
                                  "unit": m["unit"]}
    log(window_s=w1 - w0, calls=len(calls), points=done,
        latency_ms_min=min(latency) * 1e3,
        latency_ms_median=statistics.median(latency) * 1e3,
        latency_ms_max=max(latency) * 1e3, launches=reading["launches"],
        serve_calls=len(serve_calls))

    # ---- the comparison, the program's state freed ---------------------
    del program, cold
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    stages: Dict[str, float] = {}
    expected = expected_reports(cell.config, graph, grid,
                                processes=reference_processes,
                                seconds=stages)
    verdict = compare.judge(calls, expected)
    log(reference_s=time.perf_counter() - r0, reference_stages_s=stages,
        reports=verdict.reports,
        mismatched_reports=verdict.mismatched_reports,
        first_diffs=verdict.first_diffs)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": reading["kind"],
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    if trace:
        device_info["busy_s"] = busy
        device_info["window_s"] = traced_s
    result = {"correct": verdict.correct,
              "attempted": len(calls) * n_points,
              "failed": verdict.failed_points,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict.checks()
    return result
