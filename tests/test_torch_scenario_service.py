"""The scenario form on the port's service and tuner entry points, against
the JAX package's, on the CPU.

The 10 tests of ``tests/test_scenario.py`` that need the service or the
tuner (``TestServeEntryPoint`` and ``TestSearchEntryPoint``), each run
through both packages on the same graph (``repro``'s ``rmat(9, 6,
seed=7)``, converted through ``interop``), the port's services and drivers
with ``device="cpu"``.  Compared exactly: every row (``as_dict`` minus
``wall_s``, every ``SimReport`` field), every ``EpochReport`` of a
resident graph, job states, ``graph_info``, errors' messages, and the
tuner's fronts (keys, objective vectors).  No float ``values`` are
compared, so no tolerance applies (it would be the rtol 1e-5 of
``test_torch_sweep_engine.py``).  The disk store is off
(``REPRO_GRAPH_CACHE=0``).
"""

import dataclasses

import pytest

from repro.graphs.generators import rmat as r_rmat
from repro.serve import engine as r_engine
from repro.sim import ScenarioSpec as RScenarioSpec
from repro.sim import registry as r_registry
from repro.sim.dynamic import run_dynamic as r_run_dynamic
from repro.tune import halving as r_halving

from repro_torch import interop
from repro_torch.serve import engine as t_engine
from repro_torch.sim import ScenarioSpec
from repro_torch.sim import registry as t_registry
from repro_torch.sim.dynamic import run_dynamic
from repro_torch.tune import halving as t_halving


class Pkg:
    def __init__(self, engine, spec, registry, halving, g, **kw):
        self.engine, self.Spec, self.registry = engine, spec, registry
        self.halving, self.g, self.kw = halving, g, kw

    def service(self):
        return self.engine.SimService(**self.kw)

    def space(self):
        return self.registry.get_accelerator("hitgraph").design_space(
        ).restrict(memory=["ddr4"], cache=["none"])

    def budget(self, **kw):
        return self.halving.HalvingBudget(**kw)

    def driver(self, **kw):
        return self.halving.SearchDriver(self.space(), **kw, **self.kw)


@pytest.fixture(autouse=True)
def _no_disk_store(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")


@pytest.fixture(scope="module")
def pkgs():
    """``g`` of tests/test_scenario.py, in both packages."""
    r_g = r_rmat(9, 6, seed=7).undirected_view()
    return (Pkg(r_engine, RScenarioSpec, r_registry, r_halving, r_g),
            Pkg(t_engine, ScenarioSpec, t_registry, t_halving,
                interop.graph(r_g), device="cpu"))


def _row(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def assert_rows_equal(rows, r_rows):
    assert [_row(r) for r in rows] == [_row(r) for r in r_rows]
    assert [r.report for r in rows] == [interop.sim_report(r.report)
                                        for r in r_rows]


def assert_epochs_equal(eps, r_eps):
    want = [interop.epoch_report(e) for e in r_eps]
    assert len(eps) == len(want)
    for ep, w in zip(eps, want):
        for f in dataclasses.fields(ep):
            assert getattr(ep, f.name) == getattr(w, f.name), f.name


def _front(res):
    return res.front_keys(), [e.objectives for e in res.front]


class TestServeEntryPoint:
    def test_submit_accepts_bare_spec(self, pkgs):
        def run(p):
            with p.service() as svc:
                job = svc.submit(p.Spec(p.g, "wcc"))
                rows = svc.result(job, timeout=60)
                return rows, svc.poll(job)
        (r_rows, r_state), (rows, state) = map(run, pkgs)
        assert len(rows) == 1 and state == r_state == "done"
        assert_rows_equal(rows, r_rows)

    def test_resident_graph_lifecycle(self, pkgs):
        def run(p):
            spec = p.Spec(p.g, "wcc", updates="uniform-churn")
            with p.service() as svc:
                rid = svc.open_graph(spec, tenant="dyn")
                eps = [svc.result(svc.graph_job(rid), timeout=60),
                       svc.result(svc.submit_update(rid), timeout=60),
                       svc.result(svc.submit_update(rid), timeout=60)]
                info = svc.graph_info(rid)
                svc.close_graph(rid)
                with pytest.raises(KeyError, match="resident") as exc:
                    svc.graph_info(rid)
                return eps, info, str(exc.value)
        (r_eps, r_info, r_msg), (eps, info, msg) = map(run, pkgs)
        assert [e.epoch for e in eps] == [0, 1, 2]
        assert_epochs_equal(eps, r_eps)
        assert info == r_info and info["epoch"] == 2 and info["open"]
        assert msg == r_msg

    def test_update_jobs_serialize_fifo(self, pkgs):
        def run(p):
            spec = p.Spec(p.g, "wcc", updates="pa-growth")
            with p.service() as svc:
                rid = svc.open_graph(spec)
                jobs = [svc.submit_update(rid) for _ in range(3)]
                return [svc.result(j, timeout=60) for j in jobs]
        r_eps, eps = map(run, pkgs)
        assert [e.epoch for e in eps] == [1, 2, 3]
        assert_epochs_equal(eps, r_eps)

    def test_update_against_failed_open_fails(self, pkgs):
        def run(p):
            with p.service() as svc:
                with pytest.raises(ValueError, match="incremental") as exc:
                    svc.open_graph(p.Spec(p.g, "pr", updates="pa-growth"))
                return str(exc.value)
        r_msg, msg = map(run, pkgs)
        assert msg == r_msg

    def test_resident_matches_run_dynamic(self, pkgs):
        def run(p):
            spec = p.Spec(p.g, "wcc", updates="uniform-churn")
            with p.service() as svc:
                rid = svc.open_graph(spec)
                eps = [svc.result(svc.graph_job(rid), timeout=60)]
                for _ in range(spec.to_case().updates.epochs):
                    eps.append(svc.result(svc.submit_update(rid),
                                          timeout=60))
            return eps
        r_pkg, t_pkg = pkgs
        r_eps, eps = map(run, pkgs)
        local = run_dynamic(t_pkg.g, "wcc", updates="uniform-churn",
                            device="cpu")
        r_local = r_run_dynamic(r_pkg.g, "wcc", updates="uniform-churn")
        assert_epochs_equal(eps, r_eps)
        assert_epochs_equal(local.epochs, r_local.epochs)
        assert [e.report for e in eps] == [e.report for e in local.epochs]


class TestSearchEntryPoint:
    def test_driver_accepts_spec(self, pkgs):
        def run(p):
            driver = p.driver(seed=1, budget=p.budget(rungs=(4,), initial=4))
            return driver.search(p.Spec(p.g, "wcc"))
        r_res, res = map(run, pkgs)
        assert res.front and _front(res) == _front(r_res)
        assert_rows_equal([e.row for e in res.front],
                          [e.row for e in r_res.front])

    def test_driver_spec_plus_problem_rejected(self, pkgs):
        def run(p):
            with pytest.raises(ValueError, match="inside the spec") as exc:
                p.driver().search(p.Spec(p.g, "wcc"), "bfs")
            return str(exc.value)
        r_msg, msg = map(run, pkgs)
        assert msg == r_msg

    def test_submit_search_streams_front(self, pkgs):
        def run(p):
            with p.service() as svc:
                sid = svc.submit_search(
                    p.space(), p.budget(rungs=(4,), initial=4),
                    scenario=p.Spec(p.g, "wcc"), seed=1)
                res = svc.search_result(sid, timeout=180)
                assert svc.poll(sid) == "done"
                return res, [e.key for e in svc.search_front(sid)]
        (r_res, r_streamed), (res, streamed) = map(run, pkgs)
        assert res.front and _front(res) == _front(r_res)
        assert streamed == r_streamed == res.front_keys()

    def test_submit_search_cancel_keeps_partial(self, pkgs):
        def run(p):
            with p.service() as svc:
                sid = svc.submit_search(
                    p.space(), p.budget(rungs=(2, 4, 8), initial=8),
                    scenario=p.Spec(p.g, "wcc"))
                assert svc.cancel(sid)
                try:
                    res = svc.search_result(sid, timeout=180)
                except p.engine.ServiceError:
                    res = None   # raced to the first boundary, no front
                return svc.poll(sid), res
        (r_state, r_res), (state, res) = map(run, pkgs)
        assert state in ("cancelled", "done")
        assert r_state in ("cancelled", "done")
        # how far a cancelled search got is scheduling; what it found is
        # the JAX package's front at the same depth when both ran through
        if res is not None and r_res is not None and (
                [r.fixed_iters for r in res.rungs]
                == [r.fixed_iters for r in r_res.rungs]):
            assert _front(res) == _front(r_res)

    def test_search_matches_direct_driver(self, pkgs):
        def run(p):
            budget = p.budget(rungs=(4,), initial=4)
            direct = p.driver(seed=3, budget=budget).search(
                p.Spec(p.g, "wcc"))
            with p.service() as svc:
                sid = svc.submit_search(p.space(), budget,
                                        scenario=p.Spec(p.g, "wcc"), seed=3)
                served = svc.search_result(sid, timeout=180)
            return direct, served
        (r_direct, r_served), (direct, served) = map(run, pkgs)
        assert _front(served) == _front(direct) == _front(r_direct)
        assert _front(r_served) == _front(r_direct)
