"""``repro_torch`` stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card or raise."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
print(" ".join(names))
"""

#: the modules of the dynamic-graph slice, which the probe must reach
_DYNAMIC_MODULES = {"repro_torch.graphs.updates",
                    "repro_torch.algorithms.incremental",
                    "repro_torch.core.delta", "repro_torch.sim.dynamic",
                    "repro_torch.kernels.dram_timing.ops"}

#: the modules of the stationary slice (PR/SpMV)
_STATIONARY_MODULES = {"repro_torch.kernels.segment_reduce.ops",
                       "repro_torch.kernels.edge_scatter.ops",
                       "repro_torch.kernels.spmv_ell.ops"}

#: the modules of the cache slice (the on-chip filter and its lookup)
_CACHE_MODULES = {"repro_torch.core.cache",
                  "repro_torch.kernels.cache_lookup.ops",
                  "repro_torch.kernels.cache_lookup.ref"}

#: the modules of the event-driven slice (the element-granular timing
#: oracle, the abstraction graph, the reference machine) and of the
#: analytic and study modules
_EVENT_MODULES = {"repro_torch.core.timing", "repro_torch.core.abstractions",
                  "repro_torch.sim.reference_model",
                  "repro_torch.core.analytical",
                  "repro_torch.core.optimizations",
                  "repro_torch.algorithms.reference"}

#: the modules of the sweep slice (the sweep engine)
_SWEEP_MODULES = {"repro_torch.sim.sweep"}

#: the modules of the corpus slice (the corpus, the file parsers, the
#: scenario form)
_CORPUS_MODULES = {"repro_torch.graphs.corpus", "repro_torch.graphs.formats",
                   "repro_torch.graphs.generators",
                   "repro_torch.graphs.datasets", "repro_torch.sim.scenario",
                   "repro_torch.interop"}

#: the modules of the service slice (the service, chaos and the tuner)
_SERVICE_MODULES = {"repro_torch.serve", "repro_torch.serve.chaos",
                    "repro_torch.serve.engine", "repro_torch.tune",
                    "repro_torch.tune.space", "repro_torch.tune.sampler",
                    "repro_torch.tune.pareto", "repro_torch.tune.halving"}

#: the modules of the analysis slice (the lock witness and the static
#: checks)
_ANALYSIS_MODULES = {"repro_torch.analysis", "repro_torch.analysis.locks",
                     "repro_torch.analysis.framework",
                     "repro_torch.analysis.baseline",
                     "repro_torch.analysis.__main__",
                     "repro_torch.analysis.rules",
                     "repro_torch.analysis.rules.cache_keys",
                     "repro_torch.analysis.rules.determinism",
                     "repro_torch.analysis.rules.dtype_drift",
                     "repro_torch.analysis.rules.exception_hygiene",
                     "repro_torch.analysis.rules.jax_hazards",
                     "repro_torch.analysis.rules.kernel_parity",
                     "repro_torch.analysis.rules.quarantine",
                     "repro_torch.analysis.rules.scenario",
                     "repro_torch.kernels.sweep_min.ref"}

#: an import statement naming jax or the JAX package (not repro_torch)
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)


def test_import_leaves_jax_and_repro_out():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.strip().split("\n")
    n, bad = counts.split(" ", 1)
    assert int(n) >= 24
    assert bad == "[]", bad
    assert (_DYNAMIC_MODULES | _STATIONARY_MODULES | _CACHE_MODULES
            | _EVENT_MODULES | _SWEEP_MODULES | _CORPUS_MODULES
            | _SERVICE_MODULES | _ANALYSIS_MODULES
            <= set(names.split())), names


def test_no_jax_or_repro_import_in_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _IMPORT.search(f.read_text())]
    assert not offenders, offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.core.accel import VectorizedDRAM
    from repro_torch.core.dram import ddr4_2400r
    from repro_torch.graphs.generators import rmat
    from repro_torch.sim import SimSession, run_dynamic, simulate

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = rmat(5, 2, seed=0).undirected_view()
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(g, "wcc")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(g, "wcc", accelerator="accugraph", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        SimSession(g).run("bfs", "hitgraph")
    with pytest.raises(RuntimeError, match="CUDA"):
        VectorizedDRAM(ddr4_2400r())
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dynamic(g, "wcc", updates="pa-growth")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(g, "bfs", updates="uniform-churn")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(g, "wcc", backend="event")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(g, "wcc", accelerator="reference")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dynamic(g, "wcc", updates="pa-growth", backend="event")
    from repro_torch.core import optimizations
    from repro_torch.core.trace import Trace
    from repro_torch.core.vectorized import simulate_trace_device
    from repro_torch.sim.backends import EventDRAM
    with pytest.raises(RuntimeError, match="CUDA"):
        EventDRAM(ddr4_2400r())
    with pytest.raises(RuntimeError, match="CUDA"):
        optimizations.run_study(g, "wcc")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_trace_device(Trace([1, 2], [False, False], [0, 0]),
                              ddr4_2400r())
    from repro_torch.sim import Sweeper, sweep
    with pytest.raises(RuntimeError, match="CUDA"):
        Sweeper(batch_memories=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        sweep(graphs=[g], problems=["wcc"])
    from repro_torch.sim import ScenarioSpec
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate("karate", "wcc")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(ScenarioSpec("karate", "wcc", updates="pa-growth"))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_dynamic("karate", "wcc", updates="pa-growth")
    from repro_torch.serve import SimService
    from repro_torch.sim import get_accelerator
    from repro_torch.tune import SearchDriver
    with pytest.raises(RuntimeError, match="CUDA"):
        SimService()
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchDriver(get_accelerator("hitgraph").design_space())


def test_later_slices_raise_not_implemented(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    from repro_torch.graphs.generators import rmat
    from repro_torch.sim import run_dynamic, simulate

    g = rmat(5, 2, seed=0).undirected_view()
    # the event backend and the reference machine are ported: they run
    for kw in ({"backend": "event"},
               {"backend": "event", "updates": "pa-growth"},
               {"accelerator": "reference"}):
        r = simulate(g, "wcc", device="cpu", **kw)
        assert r.total_requests > 0 and r.runtime_ns > 0
    # the on-chip cache is ported: cache= runs on every entry point
    for kw in ({"cache": "vertex-1m"},
               {"cache": "vertex-1m", "updates": "pa-growth"}):
        r = simulate(g, "wcc", device="cpu", **kw)
        assert r.cache_lookups > 0 and r.runtime_ns > 0
    res = run_dynamic(g, "wcc", updates="pa-growth", cache="default",
                      device="cpu")
    assert res.report.prefetch_hits > 0 and res.n_epochs == 4
    # corpus names and ScenarioSpec are ported: every entry point takes them
    from repro_torch.sim import ScenarioSpec, sweep
    r = simulate("karate", "wcc", device="cpu")
    assert r.graph == "karate" and r.runtime_ns > 0
    assert simulate(ScenarioSpec("karate", "wcc"), device="cpu") == r
    res = run_dynamic("karate", "wcc", updates="pa-growth", device="cpu")
    assert res.n_epochs == 4
    rows = sweep(graphs=["karate"], problems=["wcc"], device="cpu")
    assert [row.graph_name for row in rows] == ["karate", "karate"]
    # the service and the tuner are ported: they run on the CPU when asked
    from repro_torch.serve import SimService
    from repro_torch.sim import SweepCase, get_accelerator
    from repro_torch.tune import HalvingBudget, SearchDriver
    with SimService(device="cpu") as svc:
        rows = svc.result(svc.submit(SweepCase("karate", "wcc")), timeout=60)
    assert rows[0].report == simulate("karate", "wcc", device="cpu")
    space = get_accelerator("hitgraph").design_space().restrict(
        memory=["ddr4"], cache=["none"])
    res = SearchDriver(space, budget=HalvingBudget(rungs=(2,), initial=2),
                       device="cpu").search("karate", "bfs")
    assert res.front and res.stats.case_evals == 2
    # no serve_backend knob: the device picks the serve (ROADMAP.md §3)
    with pytest.raises(TypeError, match="serve_backend"):
        simulate("karate", "wcc", serve_backend="scan", device="cpu")
    # devices=N is ported: a one-device host runs what it does not shard,
    # and its first sharded serve raises, naming the visible count
    from repro_torch.launch.mesh import HOST_DEVICES_ENV
    from repro_torch.sim import timing_variants
    monkeypatch.delenv(HOST_DEVICES_ENV, raising=False)
    base = sweep(graphs=["karate"], problems=["wcc"], device="cpu")
    rows = sweep(graphs=["karate"], problems=["wcc"], devices=2,
                 device="cpu")
    assert [r.report for r in rows] == [r.report for r in base]
    with pytest.raises(ValueError, match="exceeds the 1 visible"):
        sweep(graphs=["karate"], problems=["wcc"], accelerators=["hitgraph"],
              memories=timing_variants("ddr3", kinds=("ddr3", "ddr4")),
              batch_memories=True, devices=2, device="cpu")
