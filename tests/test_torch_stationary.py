"""The stationary problems (PR, SpMV) and weighted SSSP in the port against
the JAX package, on the CPU: the engines' values to rtol 1e-5 (the float
sums run in another order; ``tests/test_algorithms.py`` holds the JAX
package to the same tolerance) with iterations and every ``IterStats``
field equal, and ``simulate``'s ``SimReport`` equal field for field."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import edge_centric as r_edge
from repro.algorithms import vertex_centric as r_vertex
from repro.algorithms.common import Problem as RProblem
from repro.graphs import generators as r_gen
from repro.graphs.corpus import GRAPH_PRESETS
from repro.sim import run_dynamic as r_run_dynamic
from repro.sim import simulate as r_simulate

from repro_torch import interop
from repro_torch.algorithms import edge_centric, vertex_centric
from repro_torch.algorithms.common import Problem
from repro_torch.sim import run_dynamic, simulate

GRAPHS = {
    "rmat7": lambda: r_gen.rmat(7, 4, seed=101).undirected_view(),
    "rmat8": lambda: r_gen.rmat(8, 5, seed=102).undirected_view(),
    "karate": lambda: GRAPH_PRESETS["karate"].build(),
}

#: the accelerator/memory pairs of tests/goldens/simreports.json
PAIRS = [("hitgraph", "ddr3"), ("hitgraph", "hbm2"), ("accugraph", "ddr4"),
         ("accugraph", "ddr4-8gb"), ("accugraph", "hbm2")]

#: (problem, fixed_iters, weights) of the engine comparisons
CASES = [("pr", 1, None), ("pr", 3, None), ("spmv", 2, "unit"),
         ("spmv", 2, "int")]


def _weighted(r_g, weights):
    if weights == "unit":
        return r_g.with_unit_weights()
    if weights == "int":
        rng = np.random.default_rng(r_g.m)
        return dataclasses.replace(
            r_g, weights=rng.integers(1, 10, r_g.m).astype(np.int32))
    return r_g


def _assert_stats_equal(run, r_run):
    assert run.iterations == r_run.iterations
    assert len(run.per_iter) == len(r_run.per_iter)
    for a, b in zip(run.per_iter, r_run.per_iter):
        np.testing.assert_array_equal(a.active_before, b.active_before)
        np.testing.assert_array_equal(a.changed, b.changed)
        if b.changed_per_block is None:
            assert a.changed_per_block is None
            continue
        assert len(a.changed_per_block) == len(b.changed_per_block)
        for x, y in zip(a.changed_per_block, b.changed_per_block):
            np.testing.assert_array_equal(x, y)


def _assert_runs_close(run, r_run):
    want = np.asarray(r_run.values)
    assert run.values.dtype == want.dtype == np.float32
    np.testing.assert_allclose(run.values, want, rtol=1e-5)
    _assert_stats_equal(run, r_run)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("problem,iters,weights", CASES)
def test_edge_centric_stationary_vs_jax(gname, problem, iters, weights):
    r_g = _weighted(GRAPHS[gname](), weights or "unit")
    r_run = r_edge.run(r_g, RProblem(problem), fixed_iters=iters)
    run = edge_centric.run(interop.graph(r_g), Problem(problem),
                           fixed_iters=iters, device="cpu")
    _assert_runs_close(run, r_run)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("problem,iters,weights", CASES)
def test_vertex_centric_stationary_vs_jax(gname, problem, iters, weights):
    """Several blocks (q = 16): ``changed_per_block`` holds one all-true
    array per block, as AccuGraph's trace model needs."""
    r_g = _weighted(GRAPHS[gname](), weights)
    r_run = r_vertex.run(r_g, RProblem(problem), q=16, fixed_iters=iters)
    run = vertex_centric.run(interop.graph(r_g), Problem(problem), q=16,
                             fixed_iters=iters, device="cpu")
    assert len(run.per_iter[0].changed_per_block) > 1
    _assert_runs_close(run, r_run)


def test_edge_centric_spmv_x0_and_default_iterations():
    """SpMV starts from ``x0`` on the edge-centric engine; without
    ``fixed_iters`` both packages run one iteration."""
    r_g = GRAPHS["rmat8"]().with_unit_weights()
    x0 = np.random.default_rng(3).random(r_g.n).astype(np.float32)
    r_run = r_edge.run(r_g, RProblem.SPMV, x0=x0)
    run = edge_centric.run(interop.graph(r_g), Problem.SPMV, x0=x0,
                           device="cpu")
    assert run.iterations == 1
    _assert_runs_close(run, r_run)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("accelerator,memory", PAIRS)
@pytest.mark.parametrize("problem", ["pr", "spmv"])
def test_simulate_stationary_vs_jax(gname, accelerator, memory, problem):
    r_g = GRAPHS[gname]()
    kw = dict(accelerator=accelerator, memory=memory,
              partition_elements=64, fixed_iters=2)
    want = r_simulate(r_g, problem, **kw)
    got = simulate(interop.graph(r_g), problem, device="cpu", **kw)
    assert got == interop.sim_report(want)
    assert got.iterations == 2


@pytest.mark.parametrize("accelerator", ["hitgraph", "accugraph"])
def test_pr_report_equals_spmv_report(accelerator):
    """The stationary trace depends only on the all-true statistics, so
    PR's report is SpMV's on every field but ``problem``."""
    g = interop.graph(r_gen.rmat(9, 6, seed=3).undirected_view())
    kw = dict(accelerator=accelerator, fixed_iters=2, device="cpu")
    pr, spmv = simulate(g, "pr", **kw), simulate(g, "spmv", **kw)
    assert pr.problem == "pr" and spmv.problem == "spmv"
    assert dataclasses.replace(pr, problem="spmv") == spmv


@pytest.mark.parametrize("accelerator,memory", PAIRS)
def test_simulate_weighted_sssp_vs_jax(accelerator, memory):
    """SSSP on a weighted rmat (weights 1-9, int32); AccuGraph keeps the
    JAX package's +1 relaxation (its vertex_centric.py:98)."""
    r_g = _weighted(r_gen.rmat(8, 5, seed=102), "int")
    kw = dict(accelerator=accelerator, memory=memory,
              partition_elements=64, root=3)
    want = r_simulate(r_g, "sssp", **kw)
    got = simulate(interop.graph(r_g), "sssp", device="cpu", **kw)
    assert got == interop.sim_report(want)


@pytest.mark.parametrize("engine", ["edge", "vertex"])
def test_weighted_sssp_engines_vs_jax(engine):
    r_g = _weighted(r_gen.rmat(8, 5, seed=102), "int")
    g = interop.graph(r_g)
    if engine == "edge":
        r_run = r_edge.run(r_g, RProblem.SSSP, root=3)
        run = edge_centric.run(g, Problem.SSSP, root=3, device="cpu")
    else:
        r_run = r_vertex.run(r_g, RProblem.SSSP, q=64, root=3)
        run = vertex_centric.run(g, Problem.SSSP, q=64, root=3,
                                 device="cpu")
    np.testing.assert_array_equal(run.values, np.asarray(r_run.values))
    _assert_stats_equal(run, r_run)


def test_run_dynamic_pr_raises_as_jax_package():
    r_g = r_gen.rmat(7, 4, seed=101).undirected_view()
    with pytest.raises(ValueError, match="incremental") as want:
        r_run_dynamic(r_g, "pr", updates="pa-growth")
    with pytest.raises(ValueError, match="incremental") as got:
        run_dynamic(interop.graph(r_g), "pr", updates="pa-growth",
                    device="cpu")
    assert str(got.value) == str(want.value)
