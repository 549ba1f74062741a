"""The port's event-driven reference machine and NumPy oracles against the
JAX package, on the CPU.

* ``simulate(..., accelerator="reference")`` and ``ReferenceModel``
  against ``repro``'s on seeded graphs, every ``SimReport`` field equal
  (phases included), with configs carried across by field;
* its algorithm run equal to AccuGraph's ``q = n`` run, iteration by
  iteration, and its request count equal to what the streams imply
  (value, pointer and neighbor lines an iteration plus the unique written
  lines), the count ``chip_smoke.py`` checks on the card;
* ``ReferenceSpec``'s refusals (``tests/test_sim_api.py:183,321``), its
  ``algorithm_key`` and ``list_accelerators``;
* the NumPy oracles of ``algorithms/reference.py`` against ``repro``'s.
"""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import reference as r_oracles
from repro.algorithms.common import Problem as RProblem
from repro.graphs.corpus import GRAPH_PRESETS
from repro.graphs.generators import rmat as r_rmat
from repro.sim import get_accelerator as r_get_accelerator
from repro.sim import list_accelerators as r_list_accelerators
from repro.sim import simulate as r_simulate
from repro.sim.reference_model import ReferenceConfig as RReferenceConfig
from repro.sim.reference_model import ReferenceModel as RReferenceModel

from repro_torch import interop
from repro_torch.algorithms import reference as oracles
from repro_torch.algorithms import vertex_centric
from repro_torch.algorithms.common import Problem
from repro_torch.core.dram import CACHE_LINE_BYTES, hbm2
from repro_torch.sim import (ReferenceConfig, ReferenceModel, SimSession,
                             get_accelerator, list_accelerators, simulate)


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, r_g in (("rmat7", r_rmat(7, 4, seed=101).undirected_view()),
                      ("rmat9", r_rmat(9, 6, seed=3).undirected_view()),
                      ("karate", GRAPH_PRESETS["karate"].build())):
        out[name] = (r_g, interop.graph(r_g))
    return out


def stream_requests(g, run, cfg=ReferenceConfig()) -> int:
    """The requests the reference machine must issue for ``run``: every
    iteration reads the value, pointer and neighbor arrays once (one
    request a line after the cache-line buffers) and writes the unique
    lines of the values it changed."""
    def lines(nbytes):
        return -(-nbytes // CACHE_LINE_BYTES)

    per_iter = (lines(g.n * cfg.value_bytes)
                + lines((g.n + 1) * cfg.pointer_bytes)
                + lines(g.m * cfg.neighbor_bytes))
    writes = sum(len(np.unique(np.flatnonzero(st.changed) * cfg.value_bytes
                               // CACHE_LINE_BYTES))
                 for st in run.per_iter)
    return run.iterations * per_iter + writes


@pytest.mark.parametrize("gname", ["rmat7", "rmat9", "karate"])
@pytest.mark.parametrize("problem", ["wcc", "bfs", "sssp"])
def test_reference_vs_jax(graphs, gname, problem):
    r_g, g = graphs[gname]
    got = simulate(g, problem, accelerator="reference", device="cpu")
    want = interop.sim_report(r_simulate(r_g, problem,
                                         accelerator="reference"))
    assert got == want
    assert got.system == "reference" and got.total_requests > 0
    assert "replay" in got.stage_seconds


@pytest.mark.parametrize("problem", ["pr", "spmv"])
def test_reference_stationary_vs_jax(graphs, problem):
    r_g, g = graphs["rmat7"]
    got = simulate(g, problem, accelerator="reference", fixed_iters=2,
                   device="cpu")
    want = r_simulate(r_g, problem, accelerator="reference", fixed_iters=2)
    assert got == interop.sim_report(want)
    assert got.iterations == 2


def test_reference_model_config_vs_jax(graphs):
    """A non-default config carried across by field: other pipeline
    counts, 8-bit values and an explicit HBM2 device."""
    from repro.core.dram import hbm2 as r_hbm2
    r_g, g = graphs["rmat9"]
    r_cfg = RReferenceConfig(vertex_pipelines=4, edge_pipelines=8,
                             value_bytes=1, acc_ghz=0.25, dram=r_hbm2())
    cfg = interop.reference_config(r_cfg)
    assert cfg == ReferenceConfig(vertex_pipelines=4, edge_pipelines=8,
                                  value_bytes=1, acc_ghz=0.25, dram=hbm2())
    got = ReferenceModel(g, cfg).simulate(Problem.BFS, root=3,
                                          device="cpu")
    want = RReferenceModel(r_g, r_cfg).simulate(RProblem.BFS, root=3)
    assert got == interop.sim_report(want)
    got = simulate(g, "wcc", accelerator="reference", config=cfg,
                   device="cpu")
    assert got == interop.sim_report(r_simulate(
        r_g, "wcc", accelerator="reference", config=r_cfg))


@pytest.mark.parametrize("problem", ["wcc", "bfs"])
def test_reference_run_and_requests(graphs, problem):
    """The machine's algorithm run is AccuGraph's ``q = n`` run, and its
    request count is what the streams imply."""
    _, g = graphs["rmat9"]
    p = Problem(problem)
    spec = get_accelerator("reference")
    run = spec.run_algorithm(g, p, ReferenceConfig(), device="cpu")
    acc = get_accelerator("accugraph")
    acc_cfg = acc.make_config()
    assert acc_cfg.partition_elements is None
    want = acc.run_algorithm(g, p, acc_cfg, device="cpu")
    assert run.iterations == want.iterations
    np.testing.assert_array_equal(run.values, want.values)
    for a, b in zip(run.per_iter, want.per_iter):
        np.testing.assert_array_equal(a.active_before, b.active_before)
        np.testing.assert_array_equal(a.changed, b.changed)
    r = SimSession(g).run(p, "reference", device="cpu")
    assert r.total_requests == stream_requests(g, run)
    assert r.iterations == run.iterations
    assert len(r.phases) == 3 * run.iterations


def test_reference_rejects_vectorized_and_cache(graphs):
    _, g = graphs["rmat7"]
    with pytest.raises(ValueError, match="supports backends"):
        simulate(g, "wcc", accelerator="reference", backend="vectorized",
                 device="cpu")
    with pytest.raises(ValueError, match="cache= is not supported"):
        simulate(g, "wcc", accelerator="reference", cache="vertex-1m",
                 device="cpu")
    r = simulate(g, "wcc", accelerator="reference", cache="none",
                 device="cpu")
    assert r.system == "reference"
    r = simulate(g, "wcc", accelerator="reference", backend="event",
                 device="cpu")
    assert r.system == "reference"
    with pytest.raises(ValueError, match="injected DRAM backend"):
        ReferenceModel(g).simulate(Problem.WCC, memory_system=object(),
                                   device="cpu")


def test_reference_spec_surface(graphs):
    r_g, g = graphs["rmat7"]
    assert list_accelerators() == ["accugraph", "hitgraph", "reference"]
    assert list_accelerators() == r_list_accelerators()
    spec, r_spec = get_accelerator("reference"), r_get_accelerator(
        "reference")
    assert spec.backends == r_spec.backends == ("event",)
    assert spec.preferred_backend() == r_spec.preferred_backend() == "event"
    assert spec.description == r_spec.description
    key = spec.algorithm_key(g, Problem.BFS, ReferenceConfig(), root=2,
                             fixed_iters=None)
    r_key = r_spec.algorithm_key(r_g, RProblem.BFS, RReferenceConfig(),
                                 root=2, fixed_iters=None)
    assert key[0] == r_key[0] == "vertex"
    assert key[1][1:] == r_key[1][1:]          # (n, m, name, unweighted)
    assert key[2].value == r_key[2].value
    assert key[3:] == r_key[3:] == (g.n, False, 2, None)
    # the reference machine's run key equals AccuGraph's at q = n
    acc = get_accelerator("accugraph")
    assert acc.algorithm_key(g, Problem.BFS, acc.make_config(), root=2) \
        == key


@pytest.mark.parametrize("gname", ["rmat7", "rmat9", "karate"])
def test_oracles_vs_jax(graphs, gname):
    r_g, g = graphs[gname]
    np.testing.assert_array_equal(oracles.bfs(g, 1), r_oracles.bfs(r_g, 1))
    np.testing.assert_array_equal(oracles.wcc(g), r_oracles.wcc(r_g))
    np.testing.assert_array_equal(oracles.sssp(g, 0),
                                  r_oracles.sssp(r_g, 0))
    wg, r_wg = (dataclasses.replace(
        x, weights=np.random.default_rng(4).integers(1, 9, x.m))
        for x in (g, r_g))
    np.testing.assert_array_equal(oracles.sssp(wg, 0),
                                  r_oracles.sssp(r_wg, 0))
    x = np.random.default_rng(5).random(g.n)
    np.testing.assert_array_equal(oracles.spmv(g, x, 3),
                                  r_oracles.spmv(r_g, x, 3))
    np.testing.assert_array_equal(oracles.pagerank(g, 4),
                                  r_oracles.pagerank(r_g, 4))
    assert oracles.INF == r_oracles.INF


def test_engines_agree_with_oracles(graphs):
    """The port's engines against its own oracles on the CPU: WCC labels
    and BFS levels exactly, PR within the engines' float tolerance."""
    _, g = graphs["rmat9"]
    run = vertex_centric.run(g, Problem.WCC, q=128, device="cpu")
    np.testing.assert_array_equal(run.values, oracles.wcc(g))
    run = vertex_centric.run(g, Problem.BFS, q=g.n, root=1, device="cpu")
    want = oracles.bfs(g, 1)
    reached = want < oracles.INF
    np.testing.assert_array_equal(run.values[reached], want[reached])
    run = vertex_centric.run(g, Problem.PR, fixed_iters=3, device="cpu")
    np.testing.assert_allclose(run.values, oracles.pagerank(g, 3),
                               rtol=1e-5)
