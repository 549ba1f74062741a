"""The port's scenario form (``repro_torch.sim.scenario``) and its typed
preset errors against the JAX package's, on the CPU.

The 13 tests of ``tests/test_scenario.py`` that need neither the service
nor the tuner, each run through both packages with the same inputs:
``ScenarioSpec`` (``to_case``, the axis validation, ``ordering``,
``replace``), the ``simulate`` and ``sweep`` entry points on a spec, and
the deprecation adapter (``coerce_scenario``: the same warning text,
pointing at the caller's line).  Then the 7 tests of
``tests/test_preset_errors.py`` against the port's resolvers, the graph
axis included.
"""

import warnings

import pytest

from repro.errors import UnknownPresetError as RUnknownPresetError
from repro.graphs.generators import rmat as r_rmat
from repro.sim import ScenarioSpec as RScenarioSpec
from repro.sim import SweepCase as RSweepCase
from repro.sim import simulate as r_simulate
from repro.sim import sweep as r_sweep
from repro.sim.scenario import coerce_scenario as r_coerce_scenario

from repro_torch import interop
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs.corpus import resolve_graph
from repro_torch.graphs.updates import resolve_updates
from repro_torch.sim import (PartitionPolicy, ScenarioSpec, SweepCase,
                             simulate, sweep)
from repro_torch.sim.memory import resolve_cache, resolve_memory
from repro_torch.sim.registry import get_accelerator
from repro_torch.sim.scenario import (_AXIS_DEFAULTS, DEPRECATION_THRESHOLD,
                                      coerce_scenario)

CPU = "cpu"


@pytest.fixture(autouse=True)
def _no_disk_store(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")


@pytest.fixture(scope="module")
def graphs():
    """``g`` of tests/test_scenario.py, in both packages."""
    r_g = r_rmat(9, 6, seed=7).undirected_view()
    return r_g, interop.graph(r_g)


def _key(report):
    return (report.runtime_ns, report.total_requests,
            report.row_hit_rate, report.cache_hits)


def _deprecations(caught):
    return [w for w in caught if issubclass(w.category, DeprecationWarning)]


# ---- the spec ---------------------------------------------------------------


def test_to_case_round_trip(graphs):
    r_g, g = graphs
    kw = dict(accelerator="accugraph", memory="hbm2", cache="default",
              root=3)
    case = ScenarioSpec(g, "wcc", **kw).to_case()
    r_case = RScenarioSpec(r_g, "wcc", **kw).to_case()
    assert isinstance(case, SweepCase)
    assert case.accelerator == "accugraph" and case.root == 3
    assert (case.memory, case.cache, case.problem.value, case.updates) == (
        r_case.memory, r_case.cache, r_case.problem.value, r_case.updates)
    assert case.graph.fingerprint == r_case.graph.fingerprint


@pytest.mark.parametrize("kw, axis", [
    (dict(accelerator="hitgrpah"), "accelerator"),
    (dict(updates="pa-growht"), "updates"),
    (dict(memory="dddr4"), "memory"),
    (dict(cache="vetrex-64k"), "cache"),
    (dict(graph="karatee"), "graph"),
])
def test_axis_typos_raise_named_axis(graphs, kw, axis):
    r_g, g = graphs
    args = {"graph": g, "problem": "wcc", **kw}
    with pytest.raises(UnknownPresetError, match=axis) as got:
        ScenarioSpec(**args).to_case()
    r_args = dict(args, graph=kw.get("graph", r_g))
    with pytest.raises(RUnknownPresetError) as want:
        RScenarioSpec(**r_args).to_case()
    assert str(got.value) == str(want.value)
    assert (got.value.axis, got.value.suggestion) == (want.value.axis,
                                                      want.value.suggestion)


def test_ordering_folds_into_preset_name():
    for ordering in ("degree", "bfs", "shuffle"):
        spec = ScenarioSpec("powerlaw-social", "wcc", ordering=ordering)
        assert spec.resolved_graph() == RScenarioSpec(
            "powerlaw-social", "wcc", ordering=ordering).resolved_graph()
    assert spec.resolved_graph() == "powerlaw-social:shuffle"
    assert ScenarioSpec("karate", "wcc").resolved_graph() == "karate"
    with pytest.raises(ValueError, match="already names a transform"):
        ScenarioSpec("karate:bfs", "wcc", ordering="degree").resolved_graph()


def test_ordering_on_materialized_graph_rejected(graphs):
    r_g, g = graphs
    with pytest.raises(ValueError, match="materialized") as got:
        ScenarioSpec(g, "wcc", ordering="degree").resolved_graph()
    with pytest.raises(ValueError) as want:
        RScenarioSpec(r_g, "wcc", ordering="degree").resolved_graph()
    assert str(got.value) == str(want.value)


def test_replace(graphs):
    _, g = graphs
    spec = ScenarioSpec(g, "wcc")
    dyn = spec.replace(updates="pa-growth")
    assert spec.updates is None and dyn.updates == "pa-growth"
    assert [f for f in ScenarioSpec.__dataclass_fields__] == [
        f for f in RScenarioSpec.__dataclass_fields__]


def test_policy_folds_into_config(graphs):
    from repro.sim import PartitionPolicy as RPartitionPolicy
    r_g, g = graphs
    r_spec = RScenarioSpec(r_g, "wcc", accelerator="accugraph",
                           policy=RPartitionPolicy(count=4))
    spec = interop.scenario_spec(r_spec)
    assert spec == ScenarioSpec(g, "wcc", accelerator="accugraph",
                                policy=PartitionPolicy(count=4))
    assert spec.resolved_config().partition_elements == PartitionPolicy(
        count=4)
    assert simulate(spec, device=CPU) == interop.sim_report(
        r_simulate(r_spec))


# ---- simulate ---------------------------------------------------------------


def test_spec_equals_kwargs(graphs):
    r_g, g = graphs
    by_spec = simulate(ScenarioSpec(g, "wcc", accelerator="accugraph",
                                    cache="default"), device=CPU)
    by_kw = simulate(g, "wcc", accelerator="accugraph", cache="default",
                     device=CPU)
    assert by_spec == by_kw
    assert by_spec == interop.sim_report(r_simulate(RScenarioSpec(
        r_g, "wcc", accelerator="accugraph", cache="default")))
    assert _key(by_spec) == _key(by_kw)


def test_spec_plus_axes_rejected(graphs):
    r_g, g = graphs
    for args, kw, match in (((), {"memory": "hbm2"}, "spec.replace"),
                            (("bfs",), {}, "problem")):
        with pytest.raises(ValueError, match=match) as got:
            simulate(ScenarioSpec(g, "wcc"), *args, device=CPU, **kw)
        with pytest.raises(ValueError) as want:
            r_simulate(RScenarioSpec(r_g, "wcc"), *args, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="needs a problem") as got:
        simulate(g, device=CPU)
    with pytest.raises(TypeError) as want:
        r_simulate(r_g)
    assert str(got.value) == str(want.value)


def test_legacy_kwargs_deprecation_warning(graphs):
    r_g, g = graphs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        simulate(g, "wcc", accelerator="accugraph", memory="hbm2",
                 cache="default", device=CPU)
    with warnings.catch_warnings(record=True) as r_caught:
        warnings.simplefilter("always")
        r_simulate(r_g, "wcc", accelerator="accugraph", memory="hbm2",
                   cache="default")
    deps, r_deps = _deprecations(caught), _deprecations(r_caught)
    assert len(deps) == 1 and "ScenarioSpec" in str(deps[0].message)
    assert [str(w.message) for w in deps] == [str(w.message)
                                              for w in r_deps]
    # it points at the caller's line, as the JAX package's does
    assert deps[0].filename == __file__ == r_deps[0].filename


def test_below_threshold_no_warning(graphs):
    _, g = graphs
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        simulate(g, "wcc", accelerator="accugraph", device=CPU)
    assert not _deprecations(caught)


def test_coerce_counts_non_default_axes_only(graphs):
    r_g, g = graphs
    kw = dict(accelerator="hitgraph", memory=None, cache="default", root=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        spec = coerce_scenario("simulate", g, "wcc", **kw)
    assert spec.cache == "default" and not caught
    assert DEPRECATION_THRESHOLD == 3
    from repro.sim.scenario import _AXIS_DEFAULTS as R_AXIS_DEFAULTS
    assert _AXIS_DEFAULTS == R_AXIS_DEFAULTS
    r_spec = r_coerce_scenario("simulate", r_g, "wcc", **kw)
    assert spec == interop.scenario_spec(r_spec)


def test_dynamic_spec_routes_to_timeline(graphs):
    r_g, g = graphs
    report = simulate(ScenarioSpec(g, "wcc", updates="pa-growth"),
                      device=CPU)
    assert report.graph.endswith("+pa-growth")
    assert report == interop.sim_report(r_simulate(RScenarioSpec(
        r_g, "wcc", updates="pa-growth")))


# ---- sweep ------------------------------------------------------------------


def test_single_spec_positional(graphs):
    r_g, g = graphs
    rows = sweep(ScenarioSpec(g, "wcc", accelerator="hitgraph"), device=CPU)
    assert len(rows) == 1
    grid = sweep(graphs=[g], problems=["wcc"], accelerators=["hitgraph"],
                 device=CPU)
    assert _key(rows[0].report) == _key(grid[0].report)
    r_rows = r_sweep(RScenarioSpec(r_g, "wcc", accelerator="hitgraph"))
    assert rows[0].report == interop.sim_report(r_rows[0].report)


def test_cases_mixes_specs_and_sweepcases(graphs):
    r_g, g = graphs
    rows = sweep(cases=[ScenarioSpec(g, "wcc", accelerator="hitgraph"),
                        SweepCase(g, "wcc", accelerator="accugraph")],
                 device=CPU)
    assert [r.case.accelerator for r in rows] == ["hitgraph", "accugraph"]
    r_rows = r_sweep(cases=[RScenarioSpec(r_g, "wcc",
                                          accelerator="hitgraph"),
                            RSweepCase(r_g, "wcc", accelerator="accugraph")])
    assert [r.report for r in rows] == [interop.sim_report(r.report)
                                        for r in r_rows]


def test_models_module_simulate_goes_through_the_spec(graphs):
    from repro.core import accugraph as r_accugraph
    from repro_torch.core import accugraph, hitgraph
    r_g, g = graphs
    assert hitgraph.simulate(g, "bfs", device=CPU) == simulate(
        g, "bfs", device=CPU)
    assert accugraph.simulate(g, "wcc", device=CPU) == interop.sim_report(
        r_accugraph.simulate(r_g, "wcc"))


# ---- typed preset errors (tests/test_preset_errors.py) ----------------------


def test_unknown_preset_error_is_keyerror():
    err = UnknownPresetError("memory", "ddr5", ["ddr3", "ddr4"])
    assert isinstance(err, KeyError)
    assert (err.axis, err.available) == ("memory", ["ddr3", "ddr4"])
    assert str(err) == str(RUnknownPresetError("memory", "ddr5",
                                               ["ddr3", "ddr4"]))


@pytest.mark.parametrize("resolver, axis, bad, near", [
    (resolve_memory, "memory", "dddr4", "ddr4"),
    (resolve_cache, "cache", "vetrex-64k", "vertex-64k"),
    (resolve_graph, "graph", "karatee", "karate"),
    (resolve_updates, "updates", "pa-growht", "pa-growth"),
    (get_accelerator, "accelerator", "hitgrpah", "hitgraph"),
])
def test_resolvers_raise_typed_error(resolver, axis, bad, near):
    with pytest.raises(UnknownPresetError) as ei:
        resolver(bad)
    assert ei.value.axis == axis
    assert ei.value.suggestion == near
    assert axis in str(ei.value) and near in str(ei.value)


def test_unknown_graph_transform_is_typed():
    with pytest.raises(UnknownPresetError) as ei:
        resolve_graph("karate:degre")
    assert ei.value.axis == "graph transform"
    assert ei.value.suggestion == "degree"


def test_unknown_variant_is_typed():
    spec = get_accelerator("hitgraph")
    with pytest.raises(UnknownPresetError) as ei:
        spec.apply_variant(spec.make_config(None), "no_mergin")
    assert ei.value.axis == "variant"
    assert ei.value.suggestion == "no_merging"


@pytest.mark.parametrize("kwargs, axis", [
    (dict(memory="dddr4"), "memory"),
    (dict(cache="vertex-63k"), "cache"),
    (dict(variant="no_mergin"), "variant"),
    (dict(accelerator="hitgrpah"), "accelerator"),
    (dict(updates="pa-growht"), "updates"),
])
def test_sweepcase_validates_axes_at_construction(kwargs, axis):
    with pytest.raises(UnknownPresetError) as ei:
        SweepCase(graph="karate", problem="wcc", **kwargs)
    assert ei.value.axis == axis
    with pytest.raises(RUnknownPresetError) as want:
        RSweepCase(graph="karate", problem="wcc", **kwargs)
    assert str(ei.value) == str(want.value)


def test_sweepcase_still_accepts_valid_names():
    case = SweepCase(graph="karate", problem="wcc", memory="ddr4",
                     cache="vertex-64k", variant="no_merging")
    assert case.memory == "ddr4" and case.graph.name == "karate"


def test_sweepcase_accepts_default_cache_sentinel():
    case = SweepCase(graph="karate", problem="wcc", cache="default")
    assert case.cache == "default"
