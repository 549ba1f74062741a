"""The port's sweep engine (``repro_torch.sim.sweep``: ``Sweeper``,
``sweep``, the geometry-keyed pack cache, ``workers=N``, the ``updates=``
axis) against the JAX package's, on the CPU.

Each grid mirrors one of the JAX package's own sweep tests
(``test_sim_api.py``, ``test_fused_pipeline.py``, ``test_device_pack.py``,
``test_sweep_stats.py``, ``test_dynamic.py``), with ``Graph`` objects
built by ``repro``'s seeded generators and converted through ``interop``
in place of corpus names.  Rows are held to ``repro``'s exactly: every
``as_dict`` value but ``wall_s``, every ``SimReport`` field and phase,
every epoch of a dynamic case; and the cache counters of ``SweepStats``
to ``repro``'s for the same grid.  Also: the batched serve's plain
version against ``repro``'s ``fused_scan_batch`` /
``fused_scan_batch_shared``, ``Graph.fingerprint``, ``timing_variants``
and ``memory_name``, and the inputs that are not in this slice raising.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import vectorized as r_vec
from repro.core.accel import pack_program as r_pack_program
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.graphs.generators import rmat as r_rmat
from repro.graphs.updates import UPDATE_PRESETS as R_UPDATE_PRESETS
from repro.sim import ScenarioSpec as RScenarioSpec
from repro.sim import SweepCase as RSweepCase
from repro.sim import Sweeper as RSweeper
from repro.sim import get_accelerator as r_get_accelerator
from repro.sim import memory_name as r_memory_name
from repro.sim import sweep as r_sweep
from repro.sim import timing_variants as r_timing_variants
from repro.sim.memory import MemoryConfig as RMemoryConfig
from repro.sim.memory import TIMING_PRESETS as R_TIMING_PRESETS
from repro.sim.memory import cache_variants as r_cache_variants
from repro.sim.session import resolve_run_config as r_resolve_run_config

from repro_torch import interop
from repro_torch.algorithms.common import Problem
from repro_torch.core import accel
from repro_torch.core import vectorized as vec
from repro_torch.core.cache import CacheConfig
from repro_torch.kernels.dram_timing import ops
from repro_torch.sim import (CACHE_PRESETS, MemoryConfig, SimSession,
                             SweepCase, SweepError, SweepInterrupted,
                             Sweeper, cache_variants, get_accelerator,
                             memory_name, simulate, sweep, timing_variants)
from repro_torch.sim.session import _dram_cfg_key, resolve_run_config

CPU = "cpu"
STATS = ("cases", "algo_runs", "algo_cache_hits", "pack_cache_hits",
         "pack_cache_misses", "batched_cases", "batch_dispatches")


def _pair(scale, edge_factor, seed):
    r_g = r_rmat(scale, edge_factor, seed=seed).undirected_view()
    return r_g, interop.graph(r_g)


@pytest.fixture(scope="module")
def small():
    """``g_small`` of tests/test_sim_api.py."""
    return _pair(8, 4, 4)


def _row_dict(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def _assert_rows_equal(rows, r_rows):
    assert len(rows) == len(r_rows)
    for row, r_row in zip(rows, r_rows):
        assert _row_dict(row) == _row_dict(r_row)
        assert row.report == interop.sim_report(r_row.report)
        if r_row.epochs is None:
            assert row.epochs is None
        else:
            want = [interop.epoch_report(e) for e in r_row.epochs]
            assert len(row.epochs) == len(want)
            for ep, w in zip(row.epochs, want):
                for f in dataclasses.fields(ep):
                    assert getattr(ep, f.name) == getattr(w, f.name), f.name


def _assert_stats_equal(sw, r_sw):
    got = {k: getattr(sw.stats, k) for k in STATS}
    want = {k: getattr(r_sw.stats, k) for k in STATS}
    assert got == want


def _cases(cls, g, **kw):
    return cls(graph=g, problem="wcc", **kw)


# ---- the pieces the sweeper stands on -----------------------------------

@pytest.mark.parametrize("make", ["undirected", "directed", "weighted"])
def test_fingerprint_vs_jax(make):
    r_g = r_rmat(7, 4, seed=5)
    if make == "undirected":
        r_g = r_g.undirected_view()
    elif make == "weighted":
        r_g = r_g.with_unit_weights()
    g = interop.graph(r_g)
    assert g.fingerprint == r_g.fingerprint
    assert g.fingerprint is g.fingerprint                 # cached
    other = interop.graph(r_rmat(7, 4, seed=6))
    assert other.fingerprint != g.fingerprint


@pytest.mark.parametrize("base", ["ddr4-8gb", "ddr4", "ddr3", "hitgraph",
                                  "accugraph"])
@pytest.mark.parametrize("kinds", [("ddr3", "ddr4", "hbm2"),
                                   ("ddr3", "hbm2", "ddr4-3200"),
                                   ("ddr3-1066", "hbm-1gbps", "hbm2e")])
def test_timing_variants_and_names_vs_jax(base, kinds):
    if base in R_PRESETS:
        r_base = R_PRESETS[base]()
        p_base = interop.dram_config(r_base)
    else:
        r_base = p_base = base
    got = timing_variants(p_base, kinds=kinds)
    want = r_timing_variants(r_base, kinds=kinds)
    assert got == [interop.dram_config(m) for m in want]
    assert [memory_name(m) for m in got] == [r_memory_name(m) for m in want]
    assert len({m.geometry_key for m in got}) == 1
    for sel, r_sel in ((None, None), ("hbm2", "hbm2"),
                       (MemoryConfig(kind="ddr3"),
                        RMemoryConfig(kind="ddr3"))):
        assert memory_name(sel) == r_memory_name(r_sel)


def test_cache_variants_vs_jax():
    kinds = ("none", "vertex-64k", "default", "prefetch-8")
    got = cache_variants(kinds)
    want = r_cache_variants(kinds)
    assert got == [w if isinstance(w, str) else interop.cache_config(w)
                   for w in want]
    assert cache_variants() == [interop.cache_config(w)
                                for w in r_cache_variants()]


def _program(seed, hit_heavy, n_phases):
    rng = np.random.default_rng(seed)
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, 300))
        lines = rng.integers(0, 64 if hit_heavy else 1 << 16, n)
        if hit_heavy:
            lines = np.sort(lines)
        issue = np.sort(rng.integers(0, 4 * n, n))
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return RSegmentedTrace.from_phases(phases)


def _timings(M, seed):
    """M seeded timing vectors (positive, tBL small, as devices have)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(1, 40, size=(M, 7)).astype(np.int32)
    t[:, 4] = rng.integers(1, 5, size=M)
    return t


@pytest.mark.parametrize("preset", ["hitgraph", "accugraph", "hbm2"])
@pytest.mark.parametrize("hit_heavy", [False, True])
def test_batched_serve_plain_vs_jax(preset, hit_heavy):
    """``fused_scan_batch`` on one shared program (M timings; ``repro``'s
    ``fused_scan_batch_shared``) and on M stacked programs whose phase
    boundaries fall on different steps, on the CPU path against
    ``repro``'s, finishes and carries exactly."""
    cfg = R_PRESETS[preset]()
    B, bpr = cfg.banks_per_channel, cfg.org.banks
    timing = _timings(3, seed=len(preset))
    p0 = r_pack_program(_program(1, hit_heavy, 4), cfg)
    want_f, want_c = r_vec.fused_scan_batch_shared(
        p0.issue, p0.meta, p0.boundary, timing, B, bpr)
    got_f, got_c = vec.fused_scan_batch(
        p0.issue, p0.meta, p0.boundary, timing, B, bpr, CPU)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    for a, b in zip(got_c, want_c):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    packs = [p0] + [r_pack_program(_program(seed, hit_heavy, n), cfg)
                    for seed, n in ((2, 3), (3, 5))]
    packs = [p for p in packs if p.issue.shape == p0.issue.shape]
    assert len(packs) >= 2
    assert len({tuple(np.flatnonzero(p.boundary)) for p in packs}) == len(
        packs)
    streams = [np.stack([getattr(p, f) for p in packs])
               for f in ("issue", "meta", "boundary")]
    timing = timing[:len(packs)]
    want_f, want_c = r_vec.fused_scan_batch(*streams, timing, B, bpr)
    got_f, got_c = vec.fused_scan_batch(*streams, timing, B, bpr, CPU)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    for a, b in zip(got_c, want_c):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dram_serve_batch_checks_inputs():
    cfg = interop.dram_config(R_PRESETS["hitgraph"]())
    p = r_pack_program(_program(4, False, 2), R_PRESETS["hitgraph"]())
    issue, meta, bnd = (torch.from_numpy(np.asarray(a, dtype=np.int32))
                        for a in (p.issue, p.meta, p.boundary))
    timing = torch.from_numpy(_timings(2, 0))
    state = vec._cold_batch_state(2, cfg.channels, cfg.banks_per_channel,
                                  cfg.org.banks, CPU)
    fin, _ = ops.dram_serve_batch(issue, meta, bnd, timing, state)
    assert fin.shape == (2,) + tuple(issue.shape)
    with pytest.raises(ValueError, match="cases"):
        ops.dram_serve_batch(issue[None].repeat(3, 1, 1, 1).contiguous(),
                             meta[None].repeat(3, 1, 1, 1).contiguous(),
                             bnd[None].repeat(3, 1).contiguous(), timing,
                             state)
    bad = issue.clone()
    bad[0, 0, 0] = -1
    with pytest.raises(ValueError, match="int32 range"):
        ops.dram_serve_batch(bad, meta, bnd, timing, state)
    low = tuple(x.clone() for x in state)
    low[0][1, 0, 0] = vec.NEG_INF32 - 1
    with pytest.raises(ValueError, match="NEG_INF32"):
        ops.dram_serve_batch(issue, meta, bnd, timing, low)
    ptr = tuple(x.clone() for x in state)
    ptr[4][1, 0, 0] = 4
    with pytest.raises(ValueError, match="pointers"):
        ops.dram_serve_batch(issue, meta, bnd, timing, ptr)
    with pytest.raises(ValueError, match=r"\[M, 7\]"):
        ops.dram_serve_batch(issue, meta, bnd, timing[0], state)
    with pytest.raises(TypeError, match="int32"):
        ops.dram_serve_batch(issue.long(), meta, bnd, timing, state)


def test_pack_cache_key_cap_and_invalidate(small):
    _, g = small
    spec = get_accelerator("accugraph")
    base = resolve_run_config(spec)
    # memory=None and a timing variant of the default share the pack key
    tv = resolve_run_config(
        spec, memory=timing_variants(base.dram_config(), ("hbm2",))[0])
    assert (_dram_cfg_key("accugraph", base, include_cache=True)
            == _dram_cfg_key("accugraph", tv, include_cache=True))
    cached = resolve_run_config(spec, cache="vertex-64k")
    assert (_dram_cfg_key("accugraph", base, include_cache=False)
            == _dram_cfg_key("accugraph", cached, include_cache=False))
    assert (_dram_cfg_key("accugraph", base, include_cache=True)
            != _dram_cfg_key("accugraph", cached, include_cache=True))
    sess = SimSession(g)
    sess.PACK_CACHE_CAP = 1
    model = sess.model_for(spec, base)
    for problem in (Problem.WCC, Problem.BFS, Problem.WCC):
        run = sess.algorithm_run(spec, problem, base, 0, None, CPU)
        sess.packed_program_for(spec, problem, base, model, run,
                                base.dram_config(), device=CPU)
    assert (sess.pack_cache_misses, sess.pack_cache_hits) == (3, 0)
    assert len(sess._packs) == 1
    assert sess.invalidate([]) == 0
    assert sess.invalidate([0]) == 2 + 1 + 1


# ---- test_sim_api.py::TestSweep -----------------------------------------

def test_one_row_per_grid_point(small):
    r_small, g_small = small
    r_g, g = _pair(9, 5, 3)
    kw = dict(problems=["wcc", "bfs"], accelerators=["hitgraph", "accugraph"])
    rows = sweep(graphs=[g_small, g], device=CPU, **kw)
    assert len(rows) == 2 * 2 * 2
    assert rows[0].case.graph is g_small
    assert rows[0].report.system == "hitgraph"
    assert rows[1].report.system == "accugraph"
    assert rows[-1].case.graph is g
    assert all(r.as_dict()["memory"] == "default" for r in rows)
    _assert_rows_equal(rows, r_sweep(graphs=[r_small, r_g], **kw))


def test_dedup_of_algorithm_runs(small):
    r_g, g = small
    kw = dict(problems=["wcc"], accelerators=["accugraph"],
              memories=[None, "hbm2", "ddr4-8gb"])
    sw, r_sw = Sweeper(device=CPU), RSweeper()
    rows = sweep(graphs=[g], sweeper=sw, **kw)
    _assert_rows_equal(rows, r_sweep(graphs=[r_g], sweeper=r_sw, **kw))
    assert (sw.stats.algo_runs, sw.stats.algo_cache_hits) == (1, 2)
    _assert_stats_equal(sw, r_sw)


def test_sweep_matches_simulate(small):
    _, g = small
    rows = sweep(graphs=[g], problems=["wcc"], accelerators=["hitgraph"],
                 device=CPU)
    assert rows[0].report == simulate(g, "wcc", accelerator="hitgraph",
                                      device=CPU)


def test_explicit_cases_and_variants(small):
    r_g, g = small
    variants = (None, "prefetch_skip", "both")
    rows = sweep(cases=[_cases(SweepCase, g, accelerator="accugraph",
                               variant=v) for v in variants], device=CPU)
    assert [r.variant for r in rows] == ["baseline", "prefetch_skip",
                                        "both"]
    _assert_rows_equal(rows, r_sweep(cases=[
        _cases(RSweepCase, r_g, accelerator="accugraph", variant=v)
        for v in variants]))


# ---- test_sim_api.py::TestSweepErrors -----------------------------------

def _poisoned(cls, g):
    good = _cases(cls, g, accelerator="accugraph")
    # passes admission, dies in the worker (a registry entry vanishing
    # between construction and execution)
    poisoned = _cases(cls, g, accelerator="accugraph")
    object.__setattr__(poisoned, "accelerator", "graphicionado")
    return [good, poisoned, good]


@pytest.mark.parametrize("kw", [dict(workers=1), dict(workers=2),
                                dict(workers=4),
                                dict(batch_memories=True, workers=2),
                                dict(backend="event")],
                         ids=["workers1", "workers2", "workers4", "batched",
                              "event"])
def test_poisoned_case_raises_with_case_id(small, kw):
    r_g, g = small
    sw = Sweeper(device=CPU, **kw)
    with pytest.raises(SweepError, match=r"case #1") as exc:
        sw.run(_poisoned(SweepCase, g))
    with pytest.raises(Exception) as r_exc:
        RSweeper(**kw).run(_poisoned(RSweepCase, r_g))
    assert exc.value.index == r_exc.value.index == 1
    assert exc.value.case.accelerator == "graphicionado"
    assert "graphicionado" in str(exc.value)
    assert isinstance(exc.value.__cause__, KeyError)
    assert type(r_exc.value).__name__ == "SweepError"
    # the sweeper survives the failure: a clean grid still runs
    rows = sw.run([_cases(SweepCase, g, accelerator="accugraph")])
    assert rows[0].report.runtime_ns > 0


# ---- test_sim_api.py::TestCacheAxis (the sweep tests) -------------------

def test_same_geometry_cache_names_share_packs(small):
    r_g, g = small
    a = CACHE_PRESETS["vertex-2m"]
    b = CacheConfig(lines=a.lines, ways=a.ways, name="other-name")
    assert a == b and hash(a) == hash(b)
    sw, r_sw = Sweeper(device=CPU), RSweeper()
    rows = sw.run([_cases(SweepCase, g, accelerator="accugraph", cache=c)
                   for c in (a, b)])
    r_a = r_cache_variants(("vertex-2m",))[0]
    r_b = dataclasses.replace(r_a, name="other-name")
    r_rows = r_sw.run([_cases(RSweepCase, r_g, accelerator="accugraph",
                              cache=c) for c in (r_a, r_b)])
    _assert_rows_equal(rows, r_rows)
    assert (sw.stats.pack_cache_misses, sw.stats.pack_cache_hits) == (1, 1)
    _assert_stats_equal(sw, r_sw)


def test_sweep_cache_axis_grid_order(small):
    r_g, g = small
    kw = dict(problems=["wcc"], accelerators=["accugraph"],
              caches=[None, "vertex-256k"])
    rows = sweep(graphs=[g], device=CPU, **kw)
    assert [r.cache for r in rows] == ["none", "vertex-256k"]
    assert rows[1].report.cache_hits > 0
    _assert_rows_equal(rows, r_sweep(graphs=[r_g], **kw))
    solo = simulate(g, "wcc", accelerator="accugraph", cache="vertex-256k",
                    device=CPU)
    assert rows[1].report == solo


def test_models_shared_across_cache_variants(small):
    r_g, g = small
    caches = (None, "vertex-256k", "default")
    sw, r_sw = Sweeper(workers=2, device=CPU), RSweeper(workers=2)
    for _ in range(2):                     # the warm pass: all pack hits
        rows = sw.run([_cases(SweepCase, g, accelerator="accugraph",
                              cache=c) for c in caches])
        r_rows = r_sw.run([_cases(RSweepCase, r_g, accelerator="accugraph",
                                  cache=c) for c in caches])
        _assert_rows_equal(rows, r_rows)
        _assert_stats_equal(sw, r_sw)
    assert (sw.stats.pack_cache_misses, sw.stats.pack_cache_hits) == (3, 3)
    assert len(sw._session(g)._models) == 1


# ---- test_fused_pipeline.py: the batched sweep --------------------------

def test_batched_matches_sequential():
    r_g, g = _pair(9, 5, 3)
    kw = dict(problems=["wcc"], accelerators=["hitgraph", "accugraph"],
              memories=[None, "hbm2"])
    sw, r_sw = Sweeper(batch_memories=True, device=CPU), RSweeper(
        batch_memories=True)
    batched = sweep(graphs=[g], sweeper=sw, **kw)
    _assert_rows_equal(batched, r_sweep(graphs=[r_g], sweeper=r_sw, **kw))
    _assert_stats_equal(sw, r_sw)
    seq = sweep(graphs=[g], device=CPU, **kw)
    assert [r.report for r in batched] == [r.report for r in seq]


def test_reference_accelerator_falls_back():
    r_g, g = _pair(7, 4, 1)
    kw = dict(problems=["wcc"], accelerators=["reference"],
              batch_memories=True)
    rows = sweep(graphs=[g], device=CPU, **kw)
    assert rows[0].report.system == "reference"
    _assert_rows_equal(rows, r_sweep(graphs=[r_g], **kw))


def test_batched_sweep_single_dispatch(monkeypatch):
    """One batched serve for the two memories (the stacked path: the two
    densities pack apart), no per-case serve; on the CPU the plain calls
    stand in for the launches."""
    r_g, g = _pair(8, 5, 7)
    calls = {"batch": 0, "single": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ops, "dram_serve_batch_ref",
                        counting("batch", ops.dram_serve_batch_ref))
    monkeypatch.setattr(ops, "dram_serve_ref",
                        counting("single", ops.dram_serve_ref))
    cases = [_cases(SweepCase, g, accelerator="accugraph", memory=m)
             for m in (None, "ddr4-8gb")]
    sw = Sweeper(batch_memories=True, device=CPU)
    rows = sweep(cases=cases, sweeper=sw)
    assert sw.stats.batched_cases == 2
    assert sw.stats.batch_dispatches == calls["batch"] == 1
    assert calls["single"] == 0
    r_sw = RSweeper(batch_memories=True)
    _assert_rows_equal(rows, r_sweep(cases=[
        _cases(RSweepCase, r_g, accelerator="accugraph", memory=m)
        for m in (None, "ddr4-8gb")], sweeper=r_sw))
    _assert_stats_equal(sw, r_sw)


def _slower_grade(acc):
    """The accelerator's default memory at DDR3-1333H's clock and timing
    (``repro``'s and the port's): the same structure, so it packs apart
    from the default (the pack key holds the clock) with the same shape."""
    r_dram = r_resolve_run_config(r_get_accelerator(acc)).dram_config()
    r_dram = dataclasses.replace(r_dram, clock_ghz=2 / 3,
                                 timing=R_TIMING_PRESETS["ddr3-1333"],
                                 name=f"{r_dram.name}@ddr3-1333")
    return r_dram, interop.dram_config(r_dram)


@pytest.mark.parametrize("acc", ["hitgraph", "accugraph"])
def test_batched_sweep_stacks_a_clock_pair(acc):
    """The default memory and a slower speed grade of it (the pair that
    takes the stacked path at full size on the card): two packs of one
    signature with different issue cycles, one batched serve; rows and
    stats equal ``repro``'s."""
    r_g, g = _pair(9, 6, 5)
    r_mem, mem = _slower_grade(acc)
    sw = Sweeper(batch_memories=True, device=CPU)
    rows = sw.run([_cases(SweepCase, g, accelerator=acc, memory=m)
                   for m in (None, mem)])
    assert sw.stats.pack_cache_misses == 2
    assert sw.stats.batched_cases == 2 and sw.stats.batch_dispatches == 1
    packs = [f.result()[0] for f in sw._session(g)._packs.values()]
    assert len(packs) == 2 and packs[0].signature == packs[1].signature
    assert not np.array_equal(packs[0].issue, packs[1].issue)
    r_sw = RSweeper(batch_memories=True)
    _assert_rows_equal(rows, r_sw.run([
        _cases(RSweepCase, r_g, accelerator=acc, memory=m)
        for m in (None, r_mem)]))
    _assert_stats_equal(sw, r_sw)


def test_batched_group_of_device_and_host_packs(monkeypatch):
    """A signature group may hold a device pack beside a host pack (each
    memory packs where its decode allows): it is stacked and served as
    one, each row equal to its case served alone."""
    _, g = _pair(9, 6, 5)
    _, mem = _slower_grade("hitgraph")
    routes = iter([True, False])
    monkeypatch.setattr(accel, "_auto_pack_prefers_device",
                        lambda d: next(routes, False))
    cases = [_cases(SweepCase, g, accelerator="hitgraph", memory=m)
             for m in (None, mem)]
    accel.zero_pack_route_counts()
    sw = Sweeper(batch_memories=True, device=CPU)
    rows = sw.run(cases)
    assert accel.pack_route_counts() == {"device_pack": 1, "host_pack": 1}
    assert sw.stats.batch_dispatches == 1
    assert [r.report for r in rows] == [
        simulate(g, "wcc", accelerator="hitgraph", memory=m, device=CPU)
        for m in (None, mem)]


# ---- test_device_pack.py: workers and the pack cache --------------------

def test_identical_rows_any_worker_count():
    pairs = [_pair(8, 5, 11), _pair(7, 6, 12)]

    def cases(cls, k):
        return [cls(graph=p[k], problem="wcc", accelerator=a, memory=m)
                for p in pairs for a in ("hitgraph", "accugraph")
                for m in (None, "hbm2")]

    want = RSweeper().run(cases(RSweepCase, 0))
    for w in (1, 2, 4):
        sw = Sweeper(workers=w, device=CPU)
        rows = sw.run(cases(SweepCase, 1))
        _assert_rows_equal(rows, want)
        assert sw.stats.workers == w
        assert sw.stats.cases == len(want)


def test_workers_validation():
    with pytest.raises(ValueError):
        Sweeper(workers=0, device=CPU)
    with pytest.raises(ValueError):
        sweep(cases=[], workers=4, sweeper=Sweeper(workers=2, device=CPU))
    with pytest.raises(ValueError, match="batch_memories"):
        sweep(cases=[], batch_memories=True, sweeper=Sweeper(device=CPU))


def test_timing_grid_packs_once_per_point():
    r_g, g = _pair(8, 5, 21)
    kinds = ("ddr3", "ddr4", "hbm2")
    mems = timing_variants("ddr4-8gb", kinds=kinds)
    sw = Sweeper(batch_memories=True, workers=2, device=CPU)
    r_sw = RSweeper(batch_memories=True, workers=2)
    kw = dict(problems=["wcc"], accelerators=["hitgraph", "accugraph"])
    rows = sweep(graphs=[g], memories=mems, sweeper=sw, **kw)
    _assert_rows_equal(rows, r_sweep(
        graphs=[r_g], memories=r_timing_variants("ddr4-8gb", kinds=kinds),
        sweeper=r_sw, **kw))
    _assert_stats_equal(sw, r_sw)
    assert sw.stats.pack_cache_misses == 2        # one per accelerator
    assert sw.stats.pack_cache_hits == 4
    assert sw.stats.batched_cases == 6
    runtimes = {r.memory: r.report.runtime_ns for r in rows
                if r.report.system == "accugraph"}
    assert len(set(runtimes.values())) > 1
    before = sw.stats.pack_cache_misses
    sw.run([SweepCase(graph=g, problem="wcc", accelerator=a, memory=m)
            for a in ("hitgraph", "accugraph") for m in mems])
    assert sw.stats.pack_cache_misses == before


def test_batched_matches_sequential_on_timing_grid():
    r_g, g = _pair(8, 5, 31)
    kinds = ("ddr3", "ddr4", "hbm2e")
    kw = dict(problems=["wcc"], accelerators=["accugraph"])
    batched = sweep(graphs=[g], memories=timing_variants("ddr4", kinds),
                    batch_memories=True, workers=2, device=CPU, **kw)
    _assert_rows_equal(batched, r_sweep(
        graphs=[r_g], memories=r_timing_variants("ddr4", kinds),
        batch_memories=True, workers=2, **kw))
    seq = sweep(graphs=[g], memories=timing_variants("ddr4", kinds),
                device=CPU, **kw)
    assert [r.report for r in batched] == [r.report for r in seq]


# ---- test_sweep_stats.py: the stats-sync contract -----------------------

def _stats_cases(cls, g):
    return [cls(g, "pr"), cls(g, "bfs"), cls(g, "sssp"),
            cls(g, "pr", root=5)]


@pytest.fixture()
def counted(monkeypatch):
    """A batched Sweeper whose ``_sync_stats`` calls are counted."""
    calls = []
    orig = Sweeper._sync_stats

    def counting(self):
        calls.append(1)
        return orig(self)

    monkeypatch.setattr(Sweeper, "_sync_stats", counting)
    return Sweeper(batch_memories=True, device=CPU), calls


def test_stats_sync_runs_once_per_run(small, counted):
    r_g, g = small
    sweeper, calls = counted
    rows = sweeper.run(_stats_cases(SweepCase, g))
    assert len(calls) == 1
    sweeper.run(_stats_cases(SweepCase, g))
    assert len(calls) == 2
    r_sw = RSweeper(batch_memories=True)
    _assert_rows_equal(rows, r_sw.run(_stats_cases(RSweepCase, r_g)))


def test_sync_once_per_run_on_event_path_too(small, counted):
    r_g, g = small
    sweeper, calls = counted
    rows = sweeper.run([SweepCase(g, p, accelerator="reference")
                        for p in ("bfs", "pr")])
    assert len(calls) == 1
    _assert_rows_equal(rows, RSweeper(batch_memories=True).run(
        [RSweepCase(r_g, p, accelerator="reference")
         for p in ("bfs", "pr")]))


def test_run_case_defers_sync_to_the_caller(small, counted):
    _, g = small
    sweeper, calls = counted
    row = sweeper.run_case(_stats_cases(SweepCase, g)[0])
    assert row.report.runtime_ns > 0
    assert sweeper.stats.cases == 1
    assert calls == []


def test_totals_match_sessions_after_run(small):
    r_g, g = small
    sweeper = Sweeper(batch_memories=True, device=CPU)
    sweeper.run(_stats_cases(SweepCase, g))
    sessions = list(sweeper._sessions.values())
    assert sessions
    for k in ("algo_runs", "algo_cache_hits", "pack_cache_hits",
              "pack_cache_misses"):
        assert getattr(sweeper.stats, k) == sum(getattr(s, k)
                                                for s in sessions)
    assert sweeper.stats.algo_runs > 0
    assert sweeper.stats.cases == 4
    r_sw = RSweeper(batch_memories=True)
    r_sw.run(_stats_cases(RSweepCase, r_g))
    _assert_stats_equal(sweeper, r_sw)


def test_interrupted_run_still_syncs(small, counted):
    _, g = small
    sweeper, calls = counted
    fired = []

    def cancel_after_first():
        if fired:
            return "cancelled"
        fired.append(1)
        return None

    with pytest.raises(SweepInterrupted) as exc:
        sweeper.run(_stats_cases(SweepCase, g), control=cancel_after_first)
    assert exc.value.reason == "cancelled"
    assert len(calls) == 1
    assert sweeper.stats.algo_runs > 0


# ---- test_dynamic.py::TestDynamicSweep ----------------------------------

@pytest.fixture(scope="module")
def dyn_graphs():
    """``g`` of tests/test_dynamic.py."""
    return _pair(9, 6, 7)


def test_dynamic_grid_axis_and_row_schema(dyn_graphs):
    r_g, g = dyn_graphs
    kw = dict(problems=["wcc"], accelerators=["hitgraph"],
              updates=[None, "pa-growth"])
    sw, r_sw = Sweeper(device=CPU), RSweeper()
    rows = sweep(graphs=[g], sweeper=sw, **kw)
    static, dyn = rows
    assert static.updates == "static" and static.epochs is None
    assert dyn.updates == "pa-growth"
    d = dyn.as_dict()
    assert d["epochs"] == R_UPDATE_PRESETS["pa-growth"].epochs + 1
    assert d["edges_inserted"] > 0
    assert "cache_lines_invalidated" in d
    _assert_rows_equal(rows, r_sweep(graphs=[r_g], sweeper=r_sw, **kw))
    _assert_stats_equal(sw, r_sw)


@pytest.mark.parametrize("workers", [1, 4])
def test_dynamic_rows_identical_across_workers(dyn_graphs, workers):
    r_g, g = dyn_graphs
    kw = dict(problems=["wcc"], accelerators=["hitgraph", "accugraph"],
              updates=["uniform-churn"])
    rows = sweep(graphs=[g], workers=workers, device=CPU, **kw)
    _assert_rows_equal(rows, r_sweep(graphs=[r_g], **kw))


# ---- not in this slice ----------------------------------------------------

def test_out_of_slice_inputs_raise(small, monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    r_g, g = small
    # corpus names and ScenarioSpec cases are ported: they run, equal to
    # the JAX package's rows
    case = SweepCase("karate", "wcc")
    assert case.graph is SweepCase("karate", "bfs").graph
    assert case.graph.fingerprint == interop.graph(
        RSweepCase("karate", "wcc").graph).fingerprint
    spec = RScenarioSpec(r_g, "wcc", accelerator="accugraph")
    _assert_rows_equal(sweep(cases=[interop.scenario_spec(spec)],
                             device=CPU), r_sweep(cases=[spec]))
    # devices > 1 is ported too: on a one-device host the sweeper
    # constructs and runs what it does not shard, equal to the JAX
    # package's rows; the devices= checks are the JAX package's
    monkeypatch.delenv("REPRO_TORCH_HOST_DEVICES", raising=False)
    assert Sweeper(devices=2, device=CPU).stats.devices == 2
    _assert_rows_equal(sweep(graphs=[g], problems=["wcc"], devices=2,
                             device=CPU),
                       r_sweep(graphs=[r_g], problems=["wcc"], devices=1))
    with pytest.raises(ValueError, match="devices= conflicts"):
        sweep(cases=[], devices=2, sweeper=Sweeper(device=CPU))
    with pytest.raises(ValueError, match="devices must be >= 1"):
        Sweeper(devices=0, device=CPU)
    assert Sweeper(devices=1, device=CPU).stats.devices == 1
    assert Sweeper(device=CPU).stats.sharded_dispatches == 0


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert Sweeper().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Sweeper()
        with pytest.raises(RuntimeError, match="CUDA"):
            sweep(cases=[])
