"""The port's design-space tuner (``repro_torch.tune``) against the JAX
package's (``repro.tune``), on the CPU.

The 24 tests of ``tests/test_tune.py``, each run through both packages
with the same space, seed and budget (the port's sweeps, services and
drivers with ``device="cpu"``): the space grammar and the accelerators'
default spaces, the seeded sampler, the Pareto reduction, and the
halving search directly and through the service, under chaos too.  What
is compared, exactly: design-point keys, sizes and violated constraints;
sampled, mutated and crossed points for one seed (the port keeps
NumPy's PCG64 generator); fronts (``front_keys()``, objective vectors,
the rows behind them: ``as_dict`` minus ``wall_s`` and every
``SimReport`` field); rung reports and ``SearchStats`` (minus
``wall_s``); and the exhaustive top-fidelity vectors.  Where chaos
retries depend on scheduling, the port is held to the JAX test's bound.

The rows carry no float ``values``, so no tolerance applies (it would be
the rtol 1e-5 of ``test_torch_sweep_engine.py``).  Graphs come from the
corpus with the disk store off (``REPRO_GRAPH_CACHE=0``).
"""

import dataclasses
import importlib
import random

import pytest

import repro.tune as r_tune
from repro.serve import chaos as r_chaos
from repro.serve import engine as r_engine
from repro.sim import policy as r_policy
from repro.sim import registry as r_registry

import repro_torch.tune as t_tune
from repro_torch import interop
from repro_torch.serve import chaos as t_chaos
from repro_torch.serve import engine as t_engine
from repro_torch.sim import policy as t_policy
from repro_torch.sim import registry as t_registry

r_sweep = importlib.import_module("repro.sim.sweep")
t_sweep = importlib.import_module("repro_torch.sim.sweep")


class Pkg:
    """One package's tuner surface; ``kw`` goes to every constructor that
    takes a device (the port's: ``device="cpu"``)."""

    def __init__(self, tune, chaos, engine, policy, registry, sweep, **kw):
        self.tune, self.chaos, self.engine = tune, chaos, engine
        self.policy, self.registry, self.sweep = policy, registry, sweep
        self.kw = kw
        self.FAST_RETRY = engine.RetryPolicy(retries=6, backoff_base_s=0.001,
                                             backoff_cap_s=0.01)
        self.NO_TRIP = engine.BreakerConfig(threshold=10_000)

    def space(self, name="hitgraph"):
        return self.registry.get_accelerator(name).design_space()

    def small_space(self):
        """A 16-point exhaustively-checkable slice of the hitgraph
        space."""
        return self.space().restrict(
            n_pes=["1", "4"], pipelines=["8"],
            partition_elements=["parts4", "parts16"],
            memory=["ddr3", "hbm2"], cache=["none", "prefetch-8"])

    def sweeper(self, **kw):
        return self.sweep.Sweeper(**kw, **self.kw)

    def driver(self, space, **kw):
        if "sweeper" not in kw and "service" not in kw:
            kw.update(self.kw)
        return self.tune.SearchDriver(space, **kw)

    def service(self):
        return self.engine.SimService(workers=1, retry=self.FAST_RETRY,
                                      breaker=self.NO_TRIP, **self.kw)


R = Pkg(r_tune, r_chaos, r_engine, r_policy, r_registry, r_sweep)
T = Pkg(t_tune, t_chaos, t_engine, t_policy, t_registry, t_sweep,
        device="cpu")


@pytest.fixture(autouse=True)
def _no_leftover_chaos(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    r_chaos.deactivate()
    t_chaos.deactivate()
    yield
    r_chaos.deactivate()
    t_chaos.deactivate()


def _both(fn):
    """``fn(pkg)`` through the JAX package, then through the port."""
    return fn(R), fn(T)


def _row(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def assert_rows_equal(rows, r_rows):
    assert [_row(r) for r in rows] == [_row(r) for r in r_rows]
    assert [r.report for r in rows] == [interop.sim_report(r.report)
                                        for r in r_rows]


def _stats(res):
    d = dataclasses.asdict(res.stats)
    d.pop("wall_s")
    return d


def assert_results_equal(res, r_res):
    """Two ``SearchResult`` values: front keys, objective vectors, the
    rows behind the front, rung reports and stats."""
    assert res.front_keys() == r_res.front_keys()
    assert ([e.objectives for e in res.front]
            == [e.objectives for e in r_res.front])
    assert_rows_equal([e.row for e in res.front],
                      [e.row for e in r_res.front])
    assert ([dataclasses.asdict(r) for r in res.rungs]
            == [dataclasses.asdict(r) for r in r_res.rungs])
    assert _stats(res) == _stats(r_res)
    assert (res.scenario, res.seed) == (r_res.scenario, r_res.seed)


# ---------------------------------------------------------------------------
# space grammar
# ---------------------------------------------------------------------------

class TestSpace:
    def test_builtin_specs_declare_spaces(self):
        def run(p):
            out = {}
            for name in ("hitgraph", "accugraph"):
                space = p.space(name)
                assert space is not None and space.accelerator == name
                assert space.size() < space.grid_size
                out[name] = (space.names, space.grid_size, space.size(),
                             [pt.key for pt in space.enumerate()],
                             [c.name for c in space.constraints])
            assert p.space("reference") is None
            return out
        got, want = _both(run)[::-1]
        assert got == want

    def test_constraint_prunes_pes_beyond_channels(self):
        def run(p):
            space = p.space()
            bad = {d.name: d.values[0] for d in space.dimensions}
            bad.update(n_pes=8, memory="ddr4")
            violated = space.violated(bad)
            with pytest.raises(p.tune.InvalidPoint, match="pes-within"):
                space.point(**bad)
            bad["memory"] = "hbm2"
            return violated, space.valid(bad)
        got, want = _both(run)[::-1]
        assert got == want == (["pes-within-channels"], True)

    def test_accugraph_bram_budget_excludes_4m_cache(self):
        def run(p):
            space = p.space("accugraph")
            over = {d.name: d.values[0] for d in space.dimensions}
            over["cache"] = space.dimension("cache").values[-1]
            violated = space.violated(over)
            over["cache"] = "vertex-2m"
            return violated, space.valid(over)
        got, want = _both(run)[::-1]
        assert got == want == (["bram-budget"], True)

    def test_point_rejects_unknown_dimensions_and_values(self):
        def run(p):
            space = p.small_space()
            good = {d.name: d.values[0] for d in space.dimensions}
            bad = dict(good)
            bad.pop("memory")
            msgs = []
            for assignment in ({**good, "bogus": 1}, bad,
                               {**good, "memory": "hbm2e"}):
                with pytest.raises(p.tune.InvalidPoint) as exc:
                    space.point(**assignment)
                msgs.append(str(exc.value))
            return msgs, space.point(**good).key
        got, want = _both(run)[::-1]
        assert got == want

    def test_enumerate_matches_grid_minus_constraints(self):
        def run(p):
            space = p.small_space()
            pts = space.enumerate()
            assert len(pts) == space.size() == 16
            narrower = space.restrict(memory=["ddr3"])
            with pytest.raises(KeyError):
                space.restrict(memory=["no-such-device"])
            with pytest.raises(KeyError):
                space.restrict(bogus_dim=["x"])
            return ([pt.key for pt in pts],
                    [pt.key for pt in narrower.enumerate()])
        got, want = _both(run)[::-1]
        assert got == want and len(got[1]) == 8

    def test_keys_are_canonical_and_graph_relative(self):
        def run(p):
            pt = p.small_space().point(
                n_pes=4, pipelines=8,
                partition_elements=p.policy.PartitionPolicy(count=16),
                memory="hbm2", cache="prefetch-8")
            c = pt.to_case("karate", "bfs", fixed_iters=2)
            assert c.config.partition_elements == -(-c.graph.n // 16)
            return (pt.key, p.sweep.case_chaos_key(c),
                    dataclasses.asdict(c.config)["partition_elements"],
                    c.config.n_pes, c.config.pipelines)
        got, want = _both(run)[::-1]
        assert got == want
        assert got[0] == ("hitgraph|n_pes=4|pipelines=8|"
                          "partition_elements=parts16|memory=hbm2|"
                          "cache=prefetch-8")

    def test_duplicate_dimension_values_rejected(self):
        def run(p):
            with pytest.raises(ValueError, match="duplicate") as exc:
                p.tune.Dimension("memory", ("ddr3", "ddr3"))
            return str(exc.value)
        got, want = _both(run)[::-1]
        assert got == want


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

class TestSampler:
    def test_sampling_is_seed_deterministic(self):
        def run(p):
            space = p.space()
            a = [pt.key for pt in p.tune.sample(space, 12,
                                                p.tune.make_rng(42))]
            b = [pt.key for pt in p.tune.sample(space, 12,
                                                p.tune.make_rng(42))]
            c = [pt.key for pt in p.tune.sample(space, 12,
                                                p.tune.make_rng(43))]
            assert a == b and len(set(a)) == 12 and a != c
            return a, c
        got, want = _both(run)[::-1]
        assert got == want

    def test_samples_are_valid_and_dedup_respects_seen(self):
        def run(p):
            space = p.small_space()
            seen = set()
            stats = p.tune.SampleStats()
            first = p.tune.sample(space, 10, p.tune.make_rng(0), seen=seen,
                                  stats=stats)
            second = p.tune.sample(space, 10, p.tune.make_rng(1), seen=seen,
                                   stats=stats)
            keys = [pt.key for pt in first + second]
            assert len(set(keys)) == len(keys) <= space.size()
            assert all(space.valid(pt.values) for pt in first + second)
            return keys, sorted(seen), dataclasses.asdict(stats)
        got, want = _both(run)[::-1]
        assert got == want

    def test_exhausting_a_tiny_space_returns_fewer(self):
        def run(p):
            space = p.small_space().restrict(n_pes=["1"], memory=["ddr3"],
                                             cache=["none"])
            return [pt.key for pt in p.tune.sample(space, 50,
                                                   p.tune.make_rng(0))]
        got, want = _both(run)[::-1]
        assert got == want and len(got) == 2

    def test_mutate_changes_exactly_one_dimension(self):
        def run(p):
            space = p.small_space()
            rng = p.tune.make_rng(3)
            parent = p.tune.sample(space, 1, rng)[0]
            child = p.tune.mutate(parent, rng, seen={parent.key})
            diffs = [n for n in space.names
                     if str(child.values[n]) != str(parent.values[n])]
            assert len(diffs) == 1 and space.valid(child.values)
            return parent.key, child.key
        got, want = _both(run)[::-1]
        assert got == want

    def test_crossover_mixes_parent_values(self):
        def run(p):
            space = p.small_space()
            pts = space.enumerate()
            a, b = pts[0], pts[-1]
            child = p.tune.crossover(a, b, p.tune.make_rng(4),
                                     seen={a.key, b.key})
            for name in space.names:
                assert str(child.values[name]) in (str(a.values[name]),
                                                   str(b.values[name]))
            return child.key
        got, want = _both(run)[::-1]
        assert got == want


# ---------------------------------------------------------------------------
# pareto reduction
# ---------------------------------------------------------------------------

class TestPareto:
    def test_dominates_is_strict(self):
        pairs = [((1, 1, 1), (2, 2, 2)), ((1, 2, 2), (2, 2, 2)),
                 ((1, 1, 1), (1, 1, 1)), ((1, 3, 1), (2, 2, 2))]
        for p in (R, T):
            assert ([p.tune.dominates(a, b) for a, b in pairs]
                    == [True, True, False, False])
            with pytest.raises(ValueError):
                p.tune.dominates((1, 2), (1, 2, 3))

    def test_front_drops_dominated_keeps_ties(self):
        vectors = {"worse": (2.0, 2.0, 2.0), "best-a": (1.0, 2.0, 2.0),
                   "best-a-twin": (1.0, 2.0, 2.0),
                   "tradeoff": (2.0, 1.0, 2.0)}
        got, want = _both(lambda p: p.tune.pareto_front(vectors))[::-1]
        assert got == want == ["best-a", "best-a-twin", "tradeoff"]

    def test_front_is_insertion_order_invariant(self):
        rnd = random.Random(1234)
        vectors = {f"p{i}": (rnd.randint(0, 5), rnd.randint(0, 5),
                             rnd.randint(0, 5)) for i in range(60)}
        base = t_tune.pareto_front(vectors)
        assert base == r_tune.pareto_front(vectors)
        for _ in range(10):
            items = list(vectors.items())
            rnd.shuffle(items)
            assert t_tune.pareto_front(dict(items)) == base
        for key in vectors:
            dominated = any(t_tune.dominates(v, vectors[key])
                            for k, v in vectors.items() if k != key)
            assert (key in base) == (not dominated)

    def test_bram_objective_charges_cache_and_prefetch(self):
        def run(p):
            space = p.space("accugraph").restrict(
                edge_pipelines=["8"], vertex_pipelines=["4"],
                partition_elements=["none"], memory=["ddr4"],
                cache=["none", "vertex-256k"])
            none_pt, cache_pt = space.enumerate()
            rows = p.sweeper(batch_memories=True).run(
                [none_pt.to_case("karate", "pr", fixed_iters=2),
                 cache_pt.to_case("karate", "pr", fixed_iters=2)])
            return rows, [p.tune.bram_bytes_of(r) for r in rows], [
                p.tune.objectives_of(r) for r in rows]
        (r_rows, r_bram, r_obj), (rows, bram, obj) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (bram, obj) == (r_bram, r_obj)
        assert bram == [0, 4096 * 64] and obj[1][2] == 4096 * 64


# ---------------------------------------------------------------------------
# search driver: determinism, optimality, budget
# ---------------------------------------------------------------------------

class TestSearch:
    @staticmethod
    def budget(p, **kw):
        kw.setdefault("rungs", (1, 2))
        kw.setdefault("initial", 6)
        kw.setdefault("keep", 0.5)
        return p.tune.HalvingBudget(**kw)

    def _search(self, p, workers, seed=7):
        driver = p.driver(p.small_space(), seed=seed, budget=self.budget(p),
                          sweeper=p.sweeper(workers=workers,
                                            batch_memories=True))
        return driver.search("karate", "bfs")

    def test_front_is_seed_deterministic_and_worker_invariant(self):
        base = self._search(T, workers=1)
        assert_results_equal(base, self._search(R, workers=1))
        for other in (self._search(T, workers=1), self._search(T, workers=2)):
            assert other.front_keys() == base.front_keys()
            assert ([e.objectives for e in other.front]
                    == [e.objectives for e in base.front])
            assert ([e.row.report for e in other.front]
                    == [e.row.report for e in base.front])
        assert self._search(T, workers=1, seed=8).stats.sampled == 6

    def test_front_only_contains_top_fidelity_rows(self):
        res = self._search(T, workers=1)
        assert_results_equal(res, self._search(R, workers=1))
        assert res.front
        for entry in res.front:
            assert entry.row.case.fixed_iters == 2

    def test_front_nondominated_against_exhaustive_space(self):
        def run(p):
            space = p.small_space()
            res = p.driver(space, seed=7,
                           budget=self.budget(p)).search("karate", "bfs")
            pts = space.enumerate()
            rows = p.sweeper(batch_memories=True).run(
                [pt.to_case("karate", "bfs", fixed_iters=2) for pt in pts])
            vectors = {pt.key: p.tune.objectives_of(r)
                       for pt, r in zip(pts, rows)}
            for entry in res.front:
                assert not any(p.tune.dominates(v, entry.objectives)
                               for v in vectors.values()), entry.key
                assert vectors[entry.key] == entry.objectives
            return res, rows, vectors
        (r_res, r_rows, r_vec), (res, rows, vectors) = _both(run)
        assert_results_equal(res, r_res)
        assert_rows_equal(rows, r_rows)
        assert vectors == r_vec

    def test_halving_promotes_survivor_fraction(self):
        res = self._search(T, workers=1)
        assert_results_equal(res, self._search(R, workers=1))
        assert [r.fixed_iters for r in res.rungs] == [1, 2]
        assert [(r.evaluated, r.survivors) for r in res.rungs][0] == (6, 3)
        assert res.rungs[1].evaluated == 3

    def test_budget_truncates_dispatch_tail(self):
        def run(p):
            budget = self.budget(p, max_case_evals=8)
            return p.driver(p.small_space(), seed=7,
                            budget=budget).search("karate", "bfs")
        r_res, res = _both(run)
        assert_results_equal(res, r_res)
        assert res.stats.case_evals <= 8
        assert res.stats.budget_truncations == 1
        assert res.rungs[1].evaluated == 2

    def test_budget_holds_under_service_retries(self):
        def run(p):
            budget = self.budget(p, initial=4, max_case_evals=6)
            cfg = p.chaos.ChaosConfig(seed=7, sites={
                "dram.serve": p.chaos.SiteConfig(rate=1.0,
                                                 max_attempts=2)})
            with p.chaos.scope(cfg):
                with p.service() as svc:
                    res = p.driver(p.small_space(), seed=7, budget=budget,
                                   service=svc).search("karate", "bfs")
                    return res, svc.service_stats.retries
        (r_res, r_retries), (res, retries) = _both(run)
        assert_results_equal(res, r_res)
        # one FIFO worker and one prep thread: the same faults, retried
        assert retries == r_retries > 0
        assert res.stats.case_evals <= 6
        assert res.stats.case_evals == sum(r.evaluated for r in res.rungs)
        assert res.front

    def test_service_quarantine_drops_candidate_not_search(self):
        def run(p):
            cfg = p.chaos.ChaosConfig(seed=3, sites={
                "dram.serve": p.chaos.SiteConfig(rate=0.3,
                                                 permanent_rate=1.0)})
            budget = self.budget(p, initial=5, keep=0.6)
            with p.chaos.scope(cfg):
                with p.service() as svc:
                    return p.driver(p.small_space(), seed=3, budget=budget,
                                    service=svc).search("karate", "bfs")
        r_res, res = _both(run)
        assert_results_equal(res, r_res)
        assert res.stats.failed_candidates > 0
        assert res.front

    def test_evolutionary_refinement_spends_same_budget(self):
        def run(p):
            budget = self.budget(p, initial=4, max_case_evals=10)
            return p.driver(p.small_space(), seed=11, budget=budget,
                            evolve_rounds=3,
                            evolve_children=3).search("karate", "bfs")
        r_res, res = _both(run)
        assert_results_equal(res, r_res)
        assert res.stats.case_evals <= 10 and res.stats.evolved >= 1
        for entry in res.front:
            assert entry.row.case.fixed_iters == 2
