"""The port's public surface against ``repro``'s.

* The last helpers ported (``SimReport.teps``, ``Trace.total_bytes``,
  ``DRAMConfig.banks_total`` / ``bytes_to_lines``, ``MemoryLayout.offset``
  / ``nbytes`` / ``element_lines`` / ``sequential_lines`` and the
  ``ModelConfig`` re-export of ``configs``) equal ``repro``'s exactly on
  NumPy inputs made from a seed: ``teps`` on the golden reports
  (``tests/goldens/simreports.json``'s keys) carried across by
  ``interop``.
* A walk of every ``src/repro`` module by ``ast`` (no JAX import): each
  public module-level function and class, each public method, each
  ``__init__`` re-export and each parameter of a public function or
  method has a counterpart of the same name in the matching
  ``repro_torch`` module, or a row in the table of departures below,
  which gives its reason and its entry in ``ROADMAP.md`` §3.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import inspect
import json
from pathlib import Path

import numpy as np
import pytest

from repro.core import dram as r_dram
from repro.core import trace as r_trace
from repro.graphs.corpus import GRAPH_PRESETS as R_GRAPH_PRESETS
from repro.graphs.generators import rmat as r_rmat
from repro.models.config import ModelConfig as RModelConfig
from repro.sim import simulate as r_simulate

from repro_torch import interop
from repro_torch.core import dram
from repro_torch.core import trace

ROOT = Path(__file__).resolve().parents[1]
REPRO = ROOT / "src" / "repro"
ROADMAP = (ROOT / "ROADMAP.md").read_text()

#: ROADMAP.md §3's entries the departures below cite
SURFACE = "Departures (slice 20): the public surface."
SERVE_BACKEND = "Departure (slice 11): no `serve_backend` knob."
MESH = "Departures (slice 13): the case mesh and the distributed engine."
GENERATOR = "the LM weights' generator."
LM_MESH = "Departures (slice 16): the LM on a mesh"

PALLAS = ("a Pallas kernel; ported by hand for Hopper as the csrc/*.cu "
          "source its ops.py wrapper launches", SURFACE)
COUNTERS = ("repro counts serve dispatches by route (scan, pallas); the "
            "port counts each kernel's launches (kernels.count_launch, "
            "launch_counts, zero_launch_counts)", SURFACE)
BLOCKS = ("a Pallas block shape; each CUDA kernel picks its own launch "
          "shape", SURFACE)
BANKS = ("read from the carry's shapes (the port's carries are tuples of "
         "tensors)", SURFACE)
CARRY = ("the carry is one tuple, state=, as the wrapper takes it",
         SURFACE)
BACKEND = ("repro chooses an implementation (JAX, NumPy, Pallas); the "
           "port chooses by device: the kernel on the card, the plain "
           "version on the CPU", SURFACE)

#: repro's public names (``file`` for a whole module, ``file::name``)
#: with no counterpart in the port: (reason, ROADMAP.md §3 entry)
DEPARTED_NAMES = {
    "kernels/dram_timing/kernel.py": PALLAS,
    "kernels/edge_scatter/kernel.py": PALLAS,
    "kernels/segment_reduce/kernel.py": PALLAS,
    "kernels/spmv_ell/kernel.py": PALLAS,
    "core/vectorized.py::count_dispatch": COUNTERS,
    "core/vectorized.py::dispatch_counts": COUNTERS,
    "core/vectorized.py::reset_dispatch_counts": COUNTERS,
    "core/vectorized.py::resolve_serve_backend": (
        "no serve_backend knob: the device picks the serve",
        SERVE_BACKEND),
    "core/vectorized.py::make_serve_step": (
        "the step of repro's lax.scan serve; the port's plain serve is "
        "kernels/dram_timing/ref.py dram_serve_ref", SURFACE),
    "core/vectorized.py::fused_scan_batch_shared": (
        "fused_scan_batch serves a shared program (one program, M timing "
        "rows) itself", SURFACE),
    "core/vectorized.py::simulate_trace_jax": (
        "core/vectorized.py simulate_trace_device", SURFACE),
    "kernels/dram_timing/ops.py::resolve_interpret": (
        "Pallas's interpret mode; a wrapper runs its plain version on a "
        "CPU tensor", SURFACE),
    "kernels/dram_timing/ops.py::simulate_trace_kernel": (
        "core/vectorized.py simulate_trace_device", SURFACE),
}

#: repro's parameter names the port's counterpart lacks, where a function
#: or method of both packages has them: ``name`` anywhere, or
#: ``file::function:name``: (reason, ROADMAP.md §3 entry)
DEPARTED_PARAMS = {
    "key": ("LM weights are drawn from a torch.Generator (generator=)",
            GENERATOR),
    "mesh": ("the distributed engine takes a process group (group=)",
             MESH),
    "serve_backend": ("no serve_backend knob: the device picks the serve",
                      SERVE_BACKEND),
    "backend": BACKEND,
    "pack_backend": BACKEND,
    "sim/backends.py::make_backend:kwargs": (
        "the port's backends take device= alone (no pack_backend=)",
        SURFACE),
    "as_numpy": ("the port returns tensors on the run's device",
                 SURFACE),
    "interpret": ("Pallas's interpret mode", SURFACE),
    "chunk": BLOCKS, "tile": BLOCKS, "bn": BLOCKS, "bm": BLOCKS,
    "be": BLOCKS, "bq": BLOCKS, "bx": BLOCKS,
    "n_banks": BANKS, "banks_per_rank": BANKS,
    "avail": CARRY, "act": CARRY, "bus": CARRY, "hist": CARRY,
    "ptr": CARRY, "pmf": CARRY,
    "check_vma": ("shard_map has no check_vma: JAX's varying-manual-axes "
                  "check has no torch counterpart", LM_MESH),
    "models/layers.py::attention:cache": (
        "unused in repro (decode reads layer_cache)", SURFACE),
}


def _module(path: Path) -> str:
    parts = list(path.relative_to(REPRO).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(["repro_torch", *parts])


def _public(tree: ast.Module, init: bool):
    """``(name, node)`` of each public module-level function and class,
    each public method (``Class.name``; ``__init__`` for its parameters)
    and, in an ``__init__``, each name it imports."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if not node.name.startswith("_"):
                yield node.name, node
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            yield node.name, None
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and (not b.name.startswith("_")
                             or b.name == "__init__"):
                    yield f"{node.name}.{b.name}", b
        elif init and isinstance(node, ast.ImportFrom):
            for a in node.names:
                name = a.asname or a.name
                if not name.startswith("_") and name != "*":
                    yield name, None


def _params(node) -> list:
    a = node.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _lookup(mod, dotted: str):
    obj = mod
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


def _surface_gaps():
    """The walk: repro's names and parameters without a counterpart or a
    departure, and the departures never used."""
    gaps, used = [], set()
    for path in sorted(REPRO.rglob("*.py")):
        rel = path.relative_to(REPRO).as_posix()
        if path.name == "__main__.py":
            continue
        if rel in DEPARTED_NAMES:
            used.add(rel)
            continue
        mod = importlib.import_module(_module(path))
        tree = ast.parse(path.read_text())
        for name, node in _public(tree, path.name == "__init__.py"):
            where = f"{rel}::{name}"
            try:
                obj = _lookup(mod, name)
            except AttributeError:
                if where in DEPARTED_NAMES:
                    used.add(where)
                else:
                    gaps.append(where)
                continue
            if node is None or isinstance(obj, property):
                continue
            try:
                theirs = set(inspect.signature(obj).parameters)
            except (TypeError, ValueError):
                continue
            for p in _params(node):
                if p in theirs:
                    continue
                full = f"{rel}::{name.split('.')[-1]}:{p}"
                key = full if full in DEPARTED_PARAMS else p
                if key in DEPARTED_PARAMS:
                    used.add(key)
                else:
                    gaps.append(f"{where}({p})")
    unused = (set(DEPARTED_NAMES) | set(DEPARTED_PARAMS)) - used
    return gaps, unused


def test_every_public_name_of_repro_has_a_counterpart_or_a_departure():
    gaps, unused = _surface_gaps()
    assert not gaps, gaps
    assert not unused, f"departures no name of repro needs: {unused}"


@pytest.mark.parametrize("table", ["names", "params"])
def test_every_departure_gives_its_reason_and_roadmap_entry(table):
    rows = DEPARTED_NAMES if table == "names" else DEPARTED_PARAMS
    section = ROADMAP[ROADMAP.index("### 3. Faults in the port"):]
    for name, (reason, entry) in rows.items():
        assert reason.strip(), name
        assert entry in section, (name, entry)


# ---------------------------------------------------------------------------
# the helpers
# ---------------------------------------------------------------------------

GOLDEN = json.loads((ROOT / "tests" / "goldens" / "simreports.json")
                    .read_text())
MEMORIES = {"hitgraph": ("ddr3", "hbm2"),
            "accugraph": ("ddr4", "ddr4-8gb", "hbm2")}


@pytest.fixture(scope="module")
def golden_reports():
    """``repro``'s reports of the golden keys on the vectorized
    accelerators, each held to its golden runtime."""
    graphs = {"rmat7": r_rmat(7, 4, seed=101).undirected_view(),
              "rmat8": r_rmat(8, 5, seed=102).undirected_view(),
              "karate": R_GRAPH_PRESETS["karate"].build()}
    out = {}
    for gname, g in graphs.items():
        for acc, mems in MEMORIES.items():
            for mem in mems:
                for prob in ("wcc", "bfs"):
                    key = f"{gname}/{acc}/{mem}/{prob}"
                    r = r_simulate(g, prob, accelerator=acc, memory=mem,
                                   partition_elements=64)
                    assert r.runtime_ns == GOLDEN[key]["runtime_ns"], key
                    out[key] = r
    return out


def test_teps_equals_repro_on_the_golden_reports(golden_reports):
    assert len(golden_reports) == 30
    for key, r in golden_reports.items():
        mine = interop.sim_report(r)
        assert mine.teps == r.teps and mine.reps == r.reps, key
        assert mine.teps > 0, key


@pytest.mark.parametrize("runtime_ns", [0.0, -1.0, -2.5e6])
def test_teps_is_zero_without_a_runtime(golden_reports, runtime_ns):
    r = dataclasses.replace(golden_reports["rmat7/hitgraph/ddr3/wcc"],
                            runtime_ns=runtime_ns)
    assert interop.sim_report(r).teps == r.teps == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_trace_total_bytes_equals_repro(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 5000))
    arrays = (rng.integers(0, 1 << 30, n), rng.random(n) < 0.3,
              np.sort(rng.integers(0, 1 << 20, n)))
    got, want = trace.Trace(*arrays), r_trace.Trace(*arrays)
    assert got.total_bytes == want.total_bytes == n * dram.CACHE_LINE_BYTES
    assert trace.Trace.empty().total_bytes == 0


@pytest.mark.parametrize("preset", sorted(r_dram.PRESETS))
def test_dram_config_helpers_equal_repro(preset):
    got, want = dram.PRESETS[preset](), r_dram.PRESETS[preset]()
    assert got.banks_total == want.banks_total
    assert got.banks_total == got.channels * got.banks_per_channel
    rng = np.random.default_rng(len(preset))
    addrs = rng.integers(0, 1 << 40, 1000)
    for a in (addrs, addrs.astype(np.int32) & 0x7fffffff, list(addrs[:7]),
              int(addrs[0])):
        g, w = got.bytes_to_lines(a), want.bytes_to_lines(a)
        assert g.dtype == w.dtype == np.int64
        assert np.array_equal(g, w)


def _layouts(rng, n):
    """The port's and repro's ``MemoryLayout`` with the same ``n`` seeded
    allocations (sizes from 0 to a few KiB, a base not aligned to a
    line), and the names."""
    base = int(rng.integers(0, 1 << 20))
    ours, theirs = dram.MemoryLayout(base=base), r_dram.MemoryLayout(base=base)
    names = [f"a{i}" for i in range(n)]
    for name in names:
        nbytes = int(rng.integers(0, 5000))
        assert ours.allocate(name, nbytes) == theirs.allocate(name, nbytes)
    return ours, theirs, names


@pytest.mark.parametrize("seed", range(6))
def test_memory_layout_helpers_equal_repro(seed):
    rng = np.random.default_rng(100 + seed)
    ours, theirs, names = _layouts(rng, int(rng.integers(1, 12)))
    assert ours.total_bytes == theirs.total_bytes
    for name in names:
        assert ours.offset(name) == theirs.offset(name)
        assert ours.nbytes(name) == theirs.nbytes(name)
        for _ in range(8):
            width = int(rng.choice([1, 2, 4, 8, 12, 16, 64, 100]))
            count = int(rng.integers(-3, 400))
            start = int(rng.integers(0, 300))
            g = ours.sequential_lines(name, count, width, start)
            w = theirs.sequential_lines(name, count, width, start)
            assert g.dtype == w.dtype == np.int64
            assert np.array_equal(g, w), (name, count, width, start)
            idx = rng.integers(0, 1000, int(rng.integers(0, 50)))
            g = ours.element_lines(name, idx, width)
            w = theirs.element_lines(name, idx, width)
            assert g.dtype == w.dtype == np.int64
            assert np.array_equal(g, w)
        for count in (0, -1):
            assert ours.sequential_lines(name, count, 4).size == 0
        assert ours.sequential_lines(name, 1, 4).tolist() == \
            theirs.sequential_lines(name, 1, 4).tolist()
    with pytest.raises(KeyError):
        ours.offset("absent")


def test_configs_reexports_model_config():
    import repro_torch.configs as configs
    from repro_torch.models.config import ModelConfig
    assert configs.ModelConfig is ModelConfig
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(RModelConfig)]
    assert isinstance(configs.get_config("qwen3_0_6b", smoke=True),
                      configs.ModelConfig)
    with pytest.raises(AttributeError):
        configs.NoSuchName
