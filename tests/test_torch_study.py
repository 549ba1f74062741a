"""The port's analytic and study modules and the models' module-level
``simulate`` against the JAX package, on the CPU.

* ``core.analytical``: ``estimate_hitgraph`` / ``estimate_accugraph`` and
  ``_achievable_fraction`` equal to ``repro``'s with ``==`` (the same
  NumPy arithmetic on the same integers);
* ``core.optimizations``: ``accugraph_variants`` field for field and
  ``run_study`` report for report (every field exact, speedups ``==``);
  the stationary problems' values of every variant's run within rtol
  1e-5 of ``repro``'s;
* ``hitgraph.simulate`` / ``accugraph.simulate`` against ``repro``'s,
  and the qualitative claims of ``tests/test_accelerators.py`` on the
  port at a small size.
"""

import dataclasses

import numpy as np
import pytest

from repro.algorithms.common import Problem as RProblem
from repro.core import accugraph as r_accugraph
from repro.core import analytical as r_analytical
from repro.core import hitgraph as r_hitgraph
from repro.core import optimizations as r_optimizations
from repro.core.dram import PRESETS as R_PRESETS
from repro.graphs.generators import rmat as r_rmat
from repro.sim import get_accelerator as r_get_accelerator

from repro_torch import interop
from repro_torch.algorithms.common import Problem
from repro_torch.core import accugraph, analytical, hitgraph, optimizations
from repro_torch.core.dram import CONTIGUOUS_ORDER, ddr4_2400r
from repro_torch.sim import get_accelerator


@pytest.fixture(scope="module")
def graphs():
    r_g = r_rmat(9, 6, seed=3).undirected_view()
    return r_g, interop.graph(r_g)


@pytest.mark.parametrize("preset", sorted(R_PRESETS))
def test_achievable_fraction_vs_jax(preset):
    r_cfg = R_PRESETS[preset]()
    cfg = interop.dram_config(r_cfg)
    for n_streams in (0, 1, 3, 4, 64):
        for frac in (0.0, 0.05, 0.1, 1.0):
            assert analytical._achievable_fraction(cfg, n_streams, frac) \
                == r_analytical._achievable_fraction(r_cfg, n_streams, frac)


@pytest.mark.parametrize("problem", ["wcc", "bfs", "pr", "spmv"])
def test_estimates_vs_jax(graphs, problem):
    r_g, g = graphs
    p, r_p = Problem(problem), RProblem(problem)
    for kw in ({}, {"iterations": 7, "activity": 0.4,
                    "update_ratio": 0.3}):
        got = analytical.estimate_hitgraph(g, p, **kw)
        want = r_analytical.estimate_hitgraph(r_g, r_p, **kw)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for r_cfg in (r_hitgraph.HitGraphConfig(partition_elements=64),
                  r_hitgraph.HitGraphConfig(n_pes=1, partition_elements=100,
                                            dram=R_PRESETS["hbm2"]())):
        got = analytical.estimate_hitgraph(
            g, p, interop.hitgraph_config(r_cfg))
        want = r_analytical.estimate_hitgraph(r_g, r_p, r_cfg)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
    for r_cfg in (r_accugraph.AccuGraphConfig(),
                  r_accugraph.AccuGraphConfig(partition_elements=100,
                                              dram=R_PRESETS["hbm2"]())):
        for kw in ({}, {"iterations": 3, "stall_factor": 1.2,
                        "changed_ratio": 0.7}):
            got = analytical.estimate_accugraph(
                g, p, interop.accugraph_config(r_cfg), **kw)
            want = r_analytical.estimate_accugraph(r_g, r_p, r_cfg, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.bound in ("memory", "pipeline") and got.runtime_ns > 0


def test_variants_vs_jax():
    r_base = r_accugraph.AccuGraphConfig(partition_elements=128)
    got = optimizations.accugraph_variants(
        interop.accugraph_config(r_base))
    want = r_optimizations.accugraph_variants(r_base)
    assert list(got) == list(want)
    for name in want:
        assert got[name] == interop.accugraph_config(want[name]), name


@pytest.mark.parametrize("problem,base", [
    ("wcc", {"partition_elements": 128}),
    ("bfs", {"partition_elements": 128}),
    ("wcc", {}),
    ("pr", {"partition_elements": 200}),
])
def test_run_study_vs_jax(graphs, problem, base):
    r_g, g = graphs
    r_base = r_accugraph.AccuGraphConfig(**base)
    fixed = 2 if Problem(problem).stationary else None
    got = optimizations.run_study(g, Problem(problem),
                                  interop.accugraph_config(r_base),
                                  fixed_iters=fixed, device="cpu")
    want = r_optimizations.run_study(r_g, RProblem(problem), r_base,
                                     fixed_iters=fixed)
    assert [r.variant for r in got] == [r.variant for r in want] == [
        "baseline", "prefetch_skip", "partition_skip", "both", "hbm"]
    for a, b in zip(got, want):
        assert a.report == interop.sim_report(b.report), a.variant
        assert a.speedup == b.speedup, a.variant
    assert got[0].speedup == 1.0


def test_run_study_subset_and_values(graphs):
    """A named subset of variants, and each variant's algorithm values:
    the same as the baseline's (the optimisations change the traffic,
    never the result), PR within rtol 1e-5 of ``repro``'s."""
    r_g, g = graphs
    base = accugraph.AccuGraphConfig(partition_elements=128)
    res = optimizations.run_study(g, Problem.WCC, base,
                                  variants=["partition_skip"],
                                  device="cpu")
    assert [r.variant for r in res] == ["baseline", "partition_skip"]
    spec, r_spec = get_accelerator("accugraph"), r_get_accelerator(
        "accugraph")
    for problem in (Problem.WCC, Problem.PR):
        cfgs = optimizations.accugraph_variants(base)
        runs = {name: spec.run_algorithm(g, problem, cfg, fixed_iters=2
                                         if problem.stationary else None,
                                         device="cpu")
                for name, cfg in cfgs.items()}
        for name, run in runs.items():
            np.testing.assert_array_equal(run.values,
                                          runs["baseline"].values)
        r_run = r_spec.run_algorithm(
            r_g, RProblem(problem.value),
            r_accugraph.AccuGraphConfig(partition_elements=128),
            fixed_iters=2 if problem.stationary else None)
        np.testing.assert_allclose(runs["baseline"].values,
                                   np.asarray(r_run.values), rtol=1e-5)


@pytest.mark.parametrize("problem", ["wcc", "bfs", "pr"])
def test_module_simulate_vs_jax(graphs, problem):
    r_g, g = graphs
    fixed = 2 if Problem(problem).stationary else None
    r_hg = r_hitgraph.HitGraphConfig(partition_elements=128)
    r_ag = r_accugraph.AccuGraphConfig(partition_elements=128,
                                       prefetch_skipping=True)
    got = hitgraph.simulate(g, Problem(problem),
                            interop.hitgraph_config(r_hg),
                            fixed_iters=fixed, device="cpu")
    assert got == interop.sim_report(r_hitgraph.simulate(
        r_g, RProblem(problem), r_hg, fixed_iters=fixed))
    got = accugraph.simulate(g, Problem(problem),
                             interop.accugraph_config(r_ag), root=5,
                             fixed_iters=fixed, device="cpu")
    assert got == interop.sim_report(r_accugraph.simulate(
        r_g, RProblem(problem), r_ag, root=5, fixed_iters=fixed))


class TestPaperClaims:
    """``tests/test_accelerators.py``'s claims, on the port."""

    HG = hitgraph.HitGraphConfig(partition_elements=128)
    AG = accugraph.AccuGraphConfig(partition_elements=128)

    def test_stationary_iterations(self, graphs):
        _, g = graphs
        r1 = hitgraph.simulate(g, Problem.PR, self.HG, fixed_iters=1,
                               device="cpu")
        r2 = hitgraph.simulate(g, Problem.PR, self.HG, fixed_iters=2,
                               device="cpu")
        assert r1.iterations == 1
        assert 1.5 * r1.runtime_ns < r2.runtime_ns < 3 * r1.runtime_ns

    def test_update_filtering_reduces_requests(self, graphs):
        _, g = graphs
        on = hitgraph.simulate(g, Problem.WCC, self.HG, device="cpu")
        off = hitgraph.simulate(g, Problem.WCC, dataclasses.replace(
            self.HG, update_filtering=False, update_merging=False),
            device="cpu")
        assert on.total_requests < off.total_requests

    def test_accugraph_fewer_iterations(self, graphs):
        _, g = graphs
        ra = accugraph.simulate(g, Problem.WCC, self.AG, device="cpu")
        rh = hitgraph.simulate(g, Problem.WCC, self.HG, device="cpu")
        assert ra.iterations <= rh.iterations

    def test_optimizations_never_regress(self, graphs):
        _, g = graphs
        for problem in (Problem.WCC, Problem.BFS):
            res = optimizations.run_study(
                g, problem, self.AG, device="cpu",
                variants=["prefetch_skip", "partition_skip", "both"])
            for r in res[1:]:
                assert r.report.runtime_ns <= res[0].report.runtime_ns \
                    * 1.01, r.variant

    def test_prefetch_skip_single_partition(self, graphs):
        _, g = graphs
        by = {r.variant: r for r in optimizations.run_study(
            g, Problem.WCC, accugraph.AccuGraphConfig(), device="cpu",
            variants=["prefetch_skip", "partition_skip"])}
        assert by["prefetch_skip"].speedup > 1.0
        assert by["partition_skip"].speedup == pytest.approx(1.0, rel=0.05)

    def test_accugraph_wins_equal_config(self, graphs):
        _, g = graphs
        dram = dataclasses.replace(ddr4_2400r(channels=1, density="8Gb"),
                                   order=CONTIGUOUS_ORDER)
        rh = hitgraph.simulate(g, Problem.WCC, hitgraph.HitGraphConfig(
            n_pes=1, pipelines=16, partition_elements=128, dram=dram),
            device="cpu")
        ra = accugraph.simulate(g, Problem.WCC, accugraph.AccuGraphConfig(
            partition_elements=128, dram=dram), device="cpu")
        assert ra.runtime_ns < rh.runtime_ns

    def test_estimates_track_simulation(self, graphs):
        """The closed form lands within an order of magnitude of the
        simulated runtime of both accelerators."""
        _, g = graphs
        for est, sim in (
                (analytical.estimate_hitgraph(g, Problem.PR, self.HG),
                 hitgraph.simulate(g, Problem.PR, self.HG, fixed_iters=1,
                                   device="cpu")),
                (analytical.estimate_accugraph(g, Problem.PR, self.AG),
                 accugraph.simulate(g, Problem.PR, self.AG, fixed_iters=1,
                                    device="cpu"))):
            assert 0.1 < est.runtime_ns / sim.runtime_ns < 10
