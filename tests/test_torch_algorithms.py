"""The port's algorithm engines and graph generators against the JAX
package's, on the golden graphs.  Values, iteration counts and every
per-iteration statistic must be equal."""

import numpy as np
import pytest
import torch

from repro.algorithms import edge_centric as r_edge
from repro.algorithms import vertex_centric as r_vertex
from repro.algorithms.common import Problem as RProblem
from repro.graphs import generators as r_gen
from repro.graphs.corpus import GRAPH_PRESETS
from repro.graphs.datasets import instantiate as r_instantiate

from repro_torch import interop
from repro_torch.algorithms import edge_centric, vertex_centric
from repro_torch.algorithms.common import Problem
from repro_torch.graphs import generators as gen
from repro_torch.graphs.datasets import instantiate
from repro_torch.kernels.sweep_min.ops import sweep_min, sweep_min_ref

GRAPHS = {
    "rmat7": lambda: r_gen.rmat(7, 4, seed=101).undirected_view(),
    "rmat8": lambda: r_gen.rmat(8, 5, seed=102).undirected_view(),
    "karate": lambda: GRAPH_PRESETS["karate"].build(),
}


def _assert_runs_equal(run, r_run):
    np.testing.assert_array_equal(run.values, np.asarray(r_run.values))
    assert run.values.dtype == np.asarray(r_run.values).dtype
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
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("problem", ["wcc", "bfs"])
def test_edge_centric_vs_jax(gname, problem):
    r_g = GRAPHS[gname]().with_unit_weights()
    r_run = r_edge.run(r_g, RProblem(problem))
    run = edge_centric.run(interop.graph(r_g), Problem(problem),
                           device="cpu")
    _assert_runs_equal(run, r_run)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("problem", ["wcc", "bfs"])
def test_edge_centric_device_step_vs_jax(gname, problem):
    """The card's step loop (gather + ``scatter_reduce_("amin")``), run on
    CPU tensors, against the JAX package."""
    r_g = GRAPHS[gname]().with_unit_weights()
    r_run = r_edge.run(r_g, RProblem(problem))
    g = interop.graph(r_g)
    n = g.n
    if problem == "wcc":
        values = np.arange(n, dtype=np.int32)
        active = np.ones(n, dtype=bool)
    else:
        values = np.full(n, 2**31 - 2**24, dtype=np.int32)
        values[0] = 0
        active = np.zeros(n, dtype=bool)
        active[0] = True
    run = edge_centric._min_run_torch(
        g, Problem(problem), np.ones(g.m, dtype=np.int32), values, active,
        10_000, torch.device("cpu"))
    _assert_runs_equal(run, r_run)


@pytest.mark.parametrize("gname", sorted(GRAPHS))
@pytest.mark.parametrize("problem", ["wcc", "bfs"])
@pytest.mark.parametrize("q", [64, None])
@pytest.mark.parametrize("block_skipping", [False, True])
def test_vertex_centric_vs_jax(gname, problem, q, block_skipping):
    """Asynchronous in-place sweeps, one block (q = n) or several
    (q = 64), with and without partition skipping."""
    r_g = GRAPHS[gname]()
    r_run = r_vertex.run(r_g, RProblem(problem), q=q,
                         block_skipping=block_skipping)
    run = vertex_centric.run(interop.graph(r_g), Problem(problem), q=q,
                             block_skipping=block_skipping, device="cpu")
    _assert_runs_equal(run, r_run)


def test_sweep_min_order_matters():
    """The plain sweep relaxes in edge order against current values: a
    chain 0 -> 1 -> 2 listed in order converges in one sweep, listed in
    reverse it does not."""
    vals = torch.tensor([0, 9, 9], dtype=torch.int32)
    sweep_min(vals, torch.tensor([0, 1], dtype=torch.int32),
              torch.tensor([1, 2], dtype=torch.int32), 1)
    assert vals.tolist() == [0, 1, 2]
    vals = torch.tensor([0, 9, 9], dtype=torch.int32)
    sweep_min_ref(vals, torch.tensor([1, 0], dtype=torch.int32),
                  torch.tensor([2, 1], dtype=torch.int32), 1)
    assert vals.tolist() == [0, 1, 9]


def test_sweep_min_rejects_bad_edges():
    vals = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        sweep_min(vals, torch.tensor([0, 4], dtype=torch.int32),
                  torch.tensor([1, 2], dtype=torch.int32), 0)
    with pytest.raises(TypeError):
        sweep_min(vals, torch.tensor([0], dtype=torch.int64),
                  torch.tensor([1], dtype=torch.int64), 0)


@pytest.mark.parametrize("scale,deg,seed", [(7, 4, 101), (8, 5, 102),
                                            (10, 3, 0)])
def test_rmat_equals_jax_package(scale, deg, seed):
    g, r_g = gen.rmat(scale, deg, seed=seed), r_gen.rmat(scale, deg,
                                                         seed=seed)
    assert (g.n, g.name) == (r_g.n, r_g.name)
    np.testing.assert_array_equal(g.src, r_g.src)
    np.testing.assert_array_equal(g.dst, r_g.dst)


@pytest.mark.parametrize("skew", [0.0, 1.15])
def test_degree_matched_equals_jax_package(skew):
    g = gen.degree_matched(3000, 9000, skew=skew, seed=4)
    r_g = r_gen.degree_matched(3000, 9000, skew=skew, seed=4)
    np.testing.assert_array_equal(g.src, r_g.src)
    np.testing.assert_array_equal(g.dst, r_g.dst)


def test_wiki_talk_stand_in_equals_jax_package():
    """The main path's graph, at a small scale: same Tab. 1 stand-in."""
    g, r_g = instantiate("wt", 0.002), r_instantiate("wt", 0.002)
    assert (g.n, g.m, g.name, g.directed) == (r_g.n, r_g.m, r_g.name,
                                              r_g.directed)
    np.testing.assert_array_equal(g.src, r_g.src)
    np.testing.assert_array_equal(g.dst, r_g.dst)
