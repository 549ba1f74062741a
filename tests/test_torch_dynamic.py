"""The port's dynamic-graph path against the JAX package's, on the graph
of tests/test_dynamic.py: update batches, repair plans, delta phases,
``run_dynamic`` (every ``EpochReport`` field, the aggregate report, the
final values), ``simulate(updates=...)`` and ``DynamicTimeline.step``.
Every value is an integer or the same float operation on equal integers:
all comparisons are exact."""

import dataclasses

import numpy as np
import pytest

from repro.algorithms import incremental as r_incremental
from repro.core import delta as r_delta
from repro.graphs.generators import rmat as r_rmat
from repro.graphs.updates import UPDATE_PRESETS as R_UPDATE_PRESETS
from repro.graphs.updates import UpdateBatch as RUpdateBatch
from repro.graphs.updates import apply_batch as r_apply_batch
from repro.graphs.updates import touched_partitions as r_touched_partitions
from repro.sim import get_accelerator as r_get_accelerator
from repro.sim import simulate as r_simulate
from repro.sim.dynamic import DynamicTimeline as RDynamicTimeline
from repro.sim.dynamic import run_dynamic as r_run_dynamic
from repro.sim.session import resolve_run_config as r_resolve_run_config

from repro_torch import interop
from repro_torch.algorithms import incremental
from repro_torch.algorithms.common import Problem
from repro_torch.core import delta
from repro_torch.graphs.updates import (UPDATE_PRESETS, UpdateBatch,
                                        UpdateStream, apply_batch,
                                        resolve_updates, touched_partitions,
                                        updates_name)
from repro_torch.sim import (DynamicTimeline, SimSession, get_accelerator,
                             run_dynamic, simulate)
from repro_torch.sim.session import resolve_run_config

ACCELERATORS = ("hitgraph", "accugraph")
PROBLEMS = ("wcc", "bfs")


@pytest.fixture(scope="module")
def graphs():
    r_g = r_rmat(9, 6, seed=7).undirected_view()
    return r_g, interop.graph(r_g)


_JAX_RUNS = {}


def _jax_run(r_g, problem, preset, accelerator):
    key = (problem, preset, accelerator)
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = r_run_dynamic(r_g, problem, updates=preset,
                                       accelerator=accelerator)
    return _JAX_RUNS[key]


def _assert_result_equal(res, r_res):
    want = interop.dynamic_result(r_res)
    assert len(res.epochs) == len(want.epochs)
    for ep, w in zip(res.epochs, want.epochs):
        for f in dataclasses.fields(ep):
            assert getattr(ep, f.name) == getattr(w, f.name), (ep.epoch,
                                                               f.name)
    assert res.report == want.report
    np.testing.assert_array_equal(res.final_values, want.final_values)
    assert res.final_values.dtype == want.final_values.dtype
    assert res.final_graph.name == want.final_graph.name
    np.testing.assert_array_equal(res.final_graph.src, want.final_graph.src)
    np.testing.assert_array_equal(res.final_graph.dst, want.final_graph.dst)


@pytest.mark.parametrize("accelerator", ACCELERATORS)
@pytest.mark.parametrize("problem", PROBLEMS)
@pytest.mark.parametrize("preset", sorted(UPDATE_PRESETS))
def test_run_dynamic_vs_jax(graphs, accelerator, problem, preset):
    r_g, g = graphs
    res = run_dynamic(g, problem, updates=preset, accelerator=accelerator,
                      device="cpu")
    _assert_result_equal(res, _jax_run(r_g, problem, preset, accelerator))
    assert res.n_epochs == UPDATE_PRESETS[preset].epochs + 1
    for ep in res.epochs[1:]:
        if ep.touched_partitions:
            assert ep.report.phases[0].name == f"ep{ep.epoch}_apply"
        assert {"plan", "algorithm", "model", "apply", "trace"} <= set(
            ep.report.stage_seconds)
        assert ep.report.kernel_launches == {}      # the CPU launches none


@pytest.mark.parametrize("preset", sorted(UPDATE_PRESETS))
def test_update_batches_equal(graphs, preset):
    """Both packages draw identical batches from the same seeded stream,
    epoch after epoch on the evolving graph."""
    r_g, g = graphs
    r_stream = R_UPDATE_PRESETS[preset]
    stream = interop.update_stream(r_stream)
    assert stream == resolve_updates(preset)
    assert updates_name(preset) == updates_name(stream) == preset
    for (b, g1), (rb, r_g1) in zip(stream.materialize(g),
                                   r_stream.materialize(r_g)):
        want = interop.update_batch(rb)
        for f in ("insert_src", "insert_dst", "delete_idx"):
            np.testing.assert_array_equal(getattr(b, f), getattr(want, f))
        assert b.epoch == want.epoch
        np.testing.assert_array_equal(g1.src, r_g1.src)
        np.testing.assert_array_equal(g1.dst, r_g1.dst)
        assert g1.name == r_g1.name


@pytest.mark.parametrize("problem", PROBLEMS)
def test_plan_repair_and_closure_vs_jax(graphs, problem):
    r_g, g = graphs
    stream = UpdateStream("t", "churn", rate=0.05, seed=3)
    b = stream.batch(g, 1)
    g1 = apply_batch(g, b)
    rb = RUpdateBatch(1, b.insert_src, b.insert_dst, b.delete_idx)
    r_g1 = r_apply_batch(r_g, rb)
    values = get_accelerator("hitgraph").run_algorithm(
        g, Problem(problem), None, device="cpu").values
    plan = incremental.plan_repair(g, g1, b, Problem(problem), values)
    want = r_incremental.plan_repair(r_g, r_g1, rb, problem, values)
    for f in ("x0", "active0", "reset"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(want, f))
    assert plan.n_reset > 0 and plan.n_active > 0
    seeds = np.array([0, 5, 5, 100])
    np.testing.assert_array_equal(
        incremental.forward_closure(g1, seeds),
        r_incremental.forward_closure(r_g1, seeds))


@pytest.mark.parametrize("accelerator", ACCELERATORS)
def test_delta_phase_vs_jax(graphs, accelerator):
    """Touched partitions, regions, line ranges and the ``ep{e}_apply``
    phase equal the JAX package's on a partitioned layout."""
    r_g, g = graphs
    r_spec = r_get_accelerator(accelerator)
    r_cfg = r_resolve_run_config(r_spec, partition_elements=32)
    spec = get_accelerator(accelerator)
    cfg = resolve_run_config(spec, partition_elements=32)
    b = UpdateStream("t", "churn", rate=0.0005, seed=1).batch(g, 2)
    rb = RUpdateBatch(2, b.insert_src, b.insert_dst, b.delete_idx)
    model = spec.build_model(apply_batch(g, b), cfg)
    r_model = r_spec.build_model(r_apply_batch(r_g, rb), r_cfg)
    touched = delta.structural_partitions(b, g, model.q, model.p)
    np.testing.assert_array_equal(
        touched, r_delta.structural_partitions(rb, r_g, r_model.q,
                                               r_model.p))
    assert 0 < len(touched) < model.p
    np.testing.assert_array_equal(
        touched_partitions(b, g, model.q, g.n),
        r_touched_partitions(rb, r_g, r_model.q, r_g.n))
    assert delta.delta_regions(model, touched) == \
        r_delta.delta_regions(r_model, touched)
    assert delta.delta_line_ranges(model, touched) == \
        r_delta.delta_line_ranges(r_model, touched)
    got, want = delta.delta_phase(model, 2, touched), \
        r_delta.delta_phase(r_model, 2, touched)
    assert got[0] == want[0] == "ep2_apply"
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, w)
    assert delta.delta_phase(model, 2, touched[:0]) is None


def test_verify_and_checkpoint(graphs):
    r_g, g = graphs
    res = run_dynamic(g, "bfs", updates="uniform-churn",
                      accelerator="accugraph", verify=True, device="cpu")
    r_res = r_run_dynamic(r_g, "bfs", updates="uniform-churn",
                          accelerator="accugraph", verify=True)
    np.testing.assert_array_equal(res.checkpoint, res.final_values)
    np.testing.assert_array_equal(res.checkpoint, r_res.checkpoint)


@pytest.mark.parametrize("accelerator", ACCELERATORS)
def test_simulate_with_updates_vs_jax(graphs, accelerator):
    r_g, g = graphs
    got = simulate(g, "wcc", accelerator=accelerator, updates="pa-growth",
                   device="cpu")
    want = r_simulate(r_g, "wcc", accelerator=accelerator,
                      updates="pa-growth")
    assert got == interop.sim_report(want)
    assert got.graph.endswith("+pa-growth")


@pytest.mark.parametrize("accelerator", ACCELERATORS)
def test_timeline_step_with_explicit_batch(graphs, accelerator):
    """An explicit batch (drawn by the JAX package, carried across by
    field) steps both timelines to equal epochs; an empty batch is a
    no-op that skips the invalidation."""
    r_g, g = graphs
    r_tl = RDynamicTimeline(r_g, "wcc", accelerator=accelerator)
    tl = DynamicTimeline(g, "wcc", accelerator=accelerator, device="cpu")
    rb = R_UPDATE_PRESETS["sliding-window"].batch(r_g, 1)
    ep = tl.step(interop.update_batch(rb))
    assert ep == interop.epoch_report(r_tl.step(rb))
    assert tl._session.invalidations == 1 and tl._session.graph is tl.graph
    empty = UpdateBatch(epoch=2, insert_src=[], insert_dst=[],
                        delete_idx=[])
    before = tl.values.copy()
    ep2 = tl.step(empty)
    assert ep2 == interop.epoch_report(r_tl.step(
        RUpdateBatch(2, [], [], [])))
    assert ep2.touched_partitions == 0
    assert tl._session.invalidation_skips == 1
    np.testing.assert_array_equal(tl.values, before)
    assert tl.aggregate_report() == interop.sim_report(
        r_tl.aggregate_report())


def test_epoch0_matches_static_simulate(graphs):
    _, g = graphs
    tl = DynamicTimeline(g, "wcc", updates="pa-growth",
                         accelerator="accugraph", device="cpu")
    assert tl.epochs[0].report == simulate(g, "wcc",
                                           accelerator="accugraph",
                                           device="cpu")


def test_shared_session_untouched(graphs):
    _, g = graphs
    sess = SimSession(g)
    res = run_dynamic(g, "wcc", updates="uniform-churn", session=sess,
                      device="cpu")
    assert sess.graph is g and sess.invalidations == 0
    assert res.final_graph is not g


def r_run_dynamic_report(name):
    return interop.sim_report(
        r_run_dynamic(name, "wcc", updates="pa-growth").report)


def test_rejected_inputs(graphs, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    _, g = graphs
    with pytest.raises(ValueError, match="incremental"):
        run_dynamic(g, "sssp", updates="pa-growth", device="cpu")
    with pytest.raises(KeyError, match="updates"):
        run_dynamic(g, "wcc", updates="pa-growht", device="cpu")
    # the on-chip cache is ported: a cached dynamic run goes through
    res = run_dynamic(g, "wcc", updates="pa-growth", cache="vertex-1m",
                      device="cpu")
    assert res.report.cache_lookups > 0
    assert res.n_epochs == 4 and res.epochs[0].cache_lines_invalidated == 0
    # the event backend is ported: a dynamic run through it goes through
    # and equals the vectorized run
    assert simulate(g, "wcc", updates="pa-growth", backend="event",
                    device="cpu") == simulate(g, "wcc", updates="pa-growth",
                                              device="cpu")
    # corpus names are ported: the name form runs the preset's graph
    by_name = run_dynamic("karate", "wcc", updates="pa-growth", device="cpu")
    assert by_name.report == r_run_dynamic_report("karate")
    with pytest.raises(KeyError, match="graph"):
        run_dynamic("karatee", "wcc", updates="pa-growth", device="cpu")
    with pytest.raises(IndexError, match="delete_idx"):
        apply_batch(g, UpdateBatch(epoch=1, insert_src=[], insert_dst=[],
                                   delete_idx=[g.m + 5]))


_JAX_PLACEMENT_ROWS = []


@pytest.mark.parametrize("workers,devices", [(1, 1), (4, 1), (2, 2)])
def test_sweep_bit_identical_across_placement(graphs, monkeypatch, workers,
                                              devices):
    """``test_dynamic.py``'s placement grid: dynamic cases are never
    sharded, so ``devices=2`` runs on a one-device host, every row equal
    to the JAX package's ``(1, 1)`` rows."""
    from repro.sim import sweep as r_sweep
    from repro_torch.sim import sweep
    monkeypatch.delenv("REPRO_TORCH_HOST_DEVICES", raising=False)
    r_g, g = graphs
    kw = dict(problems=["wcc"], accelerators=["hitgraph", "accugraph"],
              updates=["uniform-churn"])
    if not _JAX_PLACEMENT_ROWS:
        _JAX_PLACEMENT_ROWS.extend(r_sweep(graphs=[r_g], **kw))
    rows = sweep(graphs=[g], workers=workers, devices=devices, device="cpu",
                 **kw)
    assert len(rows) == len(_JAX_PLACEMENT_ROWS)
    for row, r_row in zip(rows, _JAX_PLACEMENT_ROWS):
        assert row.report == interop.sim_report(r_row.report)
        assert row.epochs == [interop.epoch_report(e) for e in r_row.epochs]
