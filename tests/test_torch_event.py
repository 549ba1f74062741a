"""The port's event-driven side against the JAX package, on the CPU.

* the abstraction graph (``repro_torch.core.abstractions``): the cases of
  ``tests/test_abstractions.py`` (mappers, mergers, the two-clock engine,
  the same-cycle event chain, the oracle check), each also run through
  ``repro``'s graph with the same inputs and held to its clocks, counts
  and callback times;
* ``EventDRAM`` against ``repro``'s on randomized multi-phase programs
  (every preset, traced timing, conflict-heavy, mixed phase and program
  calls), as in ``tests/test_fused_pipeline.py``, and against the port's
  own ``VectorizedDRAM``;
* ``simulate(..., backend="event")`` against the vectorized backend and
  ``repro`` on HitGraph and AccuGraph, with and without a cache
  (``tests/test_cache_model.py``'s cross-backend cases);
* ``run_dynamic(..., backend="event")`` against ``repro``, with caches
  so that the per-epoch invalidation runs.

Every field is exact.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import abstractions as r_abs
from repro.core.dram import PRESETS as R_PRESETS
from repro.core.dram import ddr4_2400r as r_ddr4
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.graphs.generators import rmat as r_rmat
from repro.sim import run_dynamic as r_run_dynamic
from repro.sim import simulate as r_simulate
from repro.sim.backends import EventDRAM as REventDRAM

from repro_torch import interop
from repro_torch.core import abstractions as ab
from repro_torch.core.accel import VectorizedDRAM
from repro_torch.core.cache import CacheConfig
from repro_torch.core.dram import ddr4_2400r
from repro_torch.core.timing import simulate_trace
from repro_torch.sim import make_backend, run_dynamic, simulate
from repro_torch.sim.backends import BACKENDS, EventDRAM

BOTH = ((ab, lambda: ddr4_2400r()), (r_abs, lambda: r_ddr4()))


def _engine(mod, make_cfg):
    return mod.Engine(make_cfg(), acc_ghz=0.2)


# ---------------------------------------------------------------------------
# the abstraction graph
# ---------------------------------------------------------------------------

def _dedup(mod, make_cfg):
    eng = _engine(mod, make_cfg)
    buf = mod.CacheLineBuffer(eng.dram)
    fired = []
    for line in (5, 5, 5, 6, 5, 7, 7):
        buf.push(mod.Request(line, False,
                             [lambda t, l=line: fired.append((l, t))]), 0)
    buf.flush(0)
    end = eng.run()
    return eng.dram.served, end, fired, eng.dram.row_kind_counts


def test_cacheline_buffer_vs_jax():
    got, want = (_dedup(*x) for x in BOTH)
    assert got == want
    assert got[0] == 4                  # 5,5,5 -> one; 6; 5 again; 7,7
    assert len(got[2]) == 7             # every callback rides along


def _filter(mod, make_cfg):
    eng = _engine(mod, make_cfg)
    fired = []
    filt = mod.RequestFilter(eng.dram, keep=lambda r: r.line % 2 == 0)
    for line in range(6):
        filt.push(mod.Request(line, False,
                              [lambda t, l=line: fired.append((l, t))]), 0)
    end = eng.run()
    return eng.dram.served, filt.filtered, sorted(fired), end


def test_filter_vs_jax():
    got, want = (_filter(*x) for x in BOTH)
    assert got == want
    assert got[:2] == (3, 3) and [f[0] for f in got[2]] == list(range(6))


class _Spy:
    def __init__(self):
        self.order = []

    def push(self, req, t):
        self.order.append(req.line)

    def flush(self, t):
        pass


@pytest.mark.parametrize("kind", ["direct", "round_robin", "priority"])
def test_mergers_vs_jax(kind):
    def order(mod):
        spy = _Spy()
        m = {"direct": lambda: mod.DirectMerger(3, spy),
             "round_robin": lambda: mod.RoundRobinMerger(3, spy),
             "priority": lambda: mod.PriorityMerger([2, 0, 1], spy)}[kind]()
        for port, lines in ((0, (1, 2, 3)), (1, (100,)), (2, (200, 201))):
            for line in lines:
                m.port(port).push(mod.Request(line, False), 0)
        m.emit(0)
        return spy.order

    assert order(ab) == order(r_abs)
    assert order(ab) == {"direct": [1, 2, 3, 100, 200, 201],
                         "round_robin": [1, 100, 200, 2, 201, 3],
                         "priority": [100, 200, 201, 1, 2, 3]}[kind]


def test_direct_merger_into_dram_vs_jax():
    def run(mod, make_cfg):
        eng = _engine(mod, make_cfg)
        m = eng.register_merger(mod.DirectMerger(2, eng.dram))
        prods = [eng.producer(f"p{i}", m.port(i), rate=1.0)
                 for i in range(2)]
        prods[0].trigger(((i, False, None) for i in range(40)), 0)
        prods[1].trigger(((5000 + 3 * i, True, None) for i in range(25)), 0)
        return eng.run(), eng.dram.served, eng.dram.row_kind_counts

    assert run(*BOTH[0]) == run(*BOTH[1])


@pytest.mark.parametrize("rate", [None, 0.25, 1.0, 2.5, 16])
def test_rate_limited_producer_vs_jax(rate):
    """The credit arithmetic (Python floats) and ``int(t_mem + ratio)``
    clock steps: the same makespan, request counts and completion
    cycles."""
    def run(mod, make_cfg):
        eng = _engine(mod, make_cfg)
        done = []
        prod = eng.producer("p", mod.CacheLineBuffer(eng.dram), rate=rate)
        prod.on_produced.append(done.append)
        prod.trigger(((i // 3, False, None) for i in range(600)), 0)
        return eng.run(), eng.dram.served, done, eng.t_mem

    got, want = run(*BOTH[0]), run(*BOTH[1])
    assert got == want


def test_rate_limited_slower_than_bulk():
    def run(rate):
        eng = _engine(*BOTH[0])
        prod = eng.producer("p", ab.CacheLineBuffer(eng.dram), rate=rate)
        prod.trigger(((i, False, None) for i in range(256)), 0)
        return eng.run()

    assert run(0.25) > run(None)


def _chain(mod, make_cfg):
    """Producer B triggered when A completes (control-flow edge)."""
    eng = _engine(mod, make_cfg)
    buf = mod.CacheLineBuffer(eng.dram)
    a = eng.producer("a", buf, rate=1.0)
    b = eng.producer("b", buf, rate=1.0)
    seen = {}

    def start_b(t):
        seen["b_start"] = t
        b.trigger(((100 + i, False, None) for i in range(8)), t)

    a.on_produced.append(start_b)
    a.trigger(((i, False, None) for i in range(8)), 0)
    end = eng.run()
    return a.produced, b.produced, seen, end


def test_producer_chain_vs_jax():
    got = _chain(*BOTH[0])
    assert got == _chain(*BOTH[1])
    assert got[:2] == (8, 8) and got[2]["b_start"] > 0


def _same_cycle_chain(mod, make_cfg):
    eng = _engine(mod, make_cfg)
    prod = eng.producer("p", mod.CacheLineBuffer(eng.dram), rate=1.0)
    done_at, fired = [], []

    def on_done(t):
        done_at.append(t)

        def link3(t3):
            fired.append(t3)

        def link2(t2):
            fired.append(t2)
            eng.schedule(t2, link3)

        def link1(t1):
            fired.append(t1)
            eng.schedule(t1, link2)

        eng.schedule(t, link1)

    prod.on_produced.append(on_done)
    prod.trigger(((i, False, None) for i in range(4)), 0)
    end = eng.run()
    return done_at, fired, end


def test_same_cycle_event_chain_vs_jax():
    """The fast-forward is clamped to the pending event's time: a chain
    of same-cycle events fires at the cycle each was scheduled for
    (``tests/test_abstractions.py:130``)."""
    done_at, fired, end = _same_cycle_chain(*BOTH[0])
    assert (done_at, fired, end) == _same_cycle_chain(*BOTH[1])
    assert fired == [done_at[0]] * 3


def _barrier(mod, make_cfg):
    eng = _engine(mod, make_cfg)
    prod = eng.producer("p", mod.CacheLineBuffer(eng.dram), rate=None)
    fired = []
    prod.on_produced.append(lambda t: eng.barrier(fired.append))
    prod.trigger(((7 * i, False, None) for i in range(50)), 0)
    return eng.run(), fired, eng.dram.last_finish


def test_barrier_vs_jax():
    got = _barrier(*BOTH[0])
    assert got == _barrier(*BOTH[1])
    assert got[1] == [got[2]]


@pytest.mark.parametrize("rate", [None, 1.0])
def test_engine_matches_trace_oracle(rate):
    """Event-driven end to end equals the trace-level oracle for a bulk
    sequential stream (``tests/test_abstractions.py:174``), and the JAX
    package's engine on the same stream."""
    lines = np.arange(64)

    def run(mod, make_cfg):
        eng = _engine(mod, make_cfg)
        prod = eng.producer("p", mod.CacheLineBuffer(eng.dram), rate=rate)
        prod.trigger(((int(l), False, None) for l in lines), 0)
        return eng.run(), list(eng.dram.row_kind_counts), eng.runtime_ns()

    got = run(*BOTH[0])
    assert got == run(*BOTH[1])
    if rate is None:
        oracle = simulate_trace(lines, np.zeros(64, np.int64), ddr4_2400r())
        assert got[0] == oracle.cycles
        assert got[1][0] == oracle.row_hits


# ---------------------------------------------------------------------------
# EventDRAM
# ---------------------------------------------------------------------------

def _random_program(rng, n_phases=6, span=1 << 18, max_n=400,
                    sorted_issue=True):
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(1, max_n))
        lines = rng.integers(0, span, n)
        issue = rng.integers(0, 4 * n, n)
        if sorted_issue:
            issue = np.sort(issue)
        phases.append((f"p{p}", lines, np.zeros(n, dtype=bool), issue))
    return RSegmentedTrace.from_phases(phases)


def _stats(backend):
    return (backend.now, backend.total_requests, backend.total_row_hits,
            backend.total_row_conflicts,
            [dataclasses.astuple(p) for p in backend.phases])


def test_event_backend_registered():
    assert sorted(BACKENDS) == ["event", "vectorized"]
    assert isinstance(make_backend("event", ddr4_2400r(), device="cpu"),
                      EventDRAM)
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("events", ddr4_2400r(), device="cpu")


@pytest.mark.parametrize("preset", sorted(R_PRESETS))
def test_event_dram_vs_jax_all_presets(preset):
    r_cfg = R_PRESETS[preset]()
    cfg = interop.dram_config(r_cfg)
    r_prog = _random_program(np.random.default_rng(len(preset) * 13))
    prog = interop.segmented_trace(r_prog)
    got = EventDRAM(cfg, device="cpu")
    got.run_program(prog)
    want = REventDRAM(r_cfg)
    want.run_program(r_prog)
    assert _stats(got) == _stats(want)
    fused = VectorizedDRAM(cfg, device="cpu")
    fused.run_program(prog)
    assert _stats(fused) == _stats(got)
    assert set(got.stage_seconds) == {"replay"}


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       span=st.sampled_from([1 << 8, 1 << 14, 1 << 20]),
       tRRD=st.integers(1, 8), tFAW=st.integers(4, 40))
def test_property_traced_timing_vs_jax(seed, span, tRRD, tFAW):
    base = r_ddr4()
    r_cfg = dataclasses.replace(base, timing=dataclasses.replace(
        base.timing, tRRD=tRRD, tFAW=tFAW))
    r_prog = _random_program(np.random.default_rng(seed), n_phases=4,
                             span=span, max_n=200)
    got = EventDRAM(interop.dram_config(r_cfg), device="cpu")
    got.run_program(interop.segmented_trace(r_prog))
    want = REventDRAM(r_cfg)
    want.run_program(r_prog)
    assert _stats(got) == _stats(want)


def test_conflict_heavy_unsorted_vs_jax():
    r_cfg = r_ddr4()
    r_prog = _random_program(np.random.default_rng(99), n_phases=5,
                             span=1 << 22, sorted_issue=False)
    got = EventDRAM(interop.dram_config(r_cfg), device="cpu")
    got.run_program(interop.segmented_trace(r_prog))
    want = REventDRAM(r_cfg)
    want.run_program(r_prog)
    assert _stats(got) == _stats(want)


def test_mixed_phase_and_program_calls_vs_jax():
    """run_phase and run_program interleave on one backend; the carry
    flows across both."""
    r_cfg = R_PRESETS["hitgraph"]()
    cfg = interop.dram_config(r_cfg)
    rng = np.random.default_rng(5)
    r_p1, r_p2 = _random_program(rng, 3), _random_program(rng, 3)
    got = EventDRAM(cfg, device="cpu")
    want = REventDRAM(r_cfg)
    vec = VectorizedDRAM(cfg, device="cpu")
    for be, conv in ((got, interop.segmented_trace),
                     (want, lambda p: p), (vec, interop.segmented_trace)):
        be.run_program(conv(r_p1))
        p2 = conv(r_p2)
        for p in range(p2.n_phases):
            be.run_phase(p2.phase(p), p2.names[p])
    assert _stats(got) == _stats(want) == _stats(vec)


def test_event_dram_with_cache_vs_jax():
    """The cache filter chained phase by phase, its state on the CPU, and
    the invalidation hook: hits, state and the lines dropped as
    ``repro``'s."""
    from repro.core import cache as r_cache
    from repro.core.cache import CacheConfig as RCacheConfig
    r_c = RCacheConfig(lines=512, ways=4, prefetch_degree=4)
    r_cfg = dataclasses.replace(r_ddr4(), cache=r_c)
    cfg = interop.dram_config(r_cfg)
    rng = np.random.default_rng(17)
    r_progs = [_random_program(rng, 4, span=1 << 11) for _ in range(2)]
    got = EventDRAM(cfg, device="cpu")
    want = REventDRAM(r_cfg)
    ranges = [(100, 300), (1500, 40)]
    got.run_program(interop.segmented_trace(r_progs[0]))
    want.run_program(r_progs[0])
    n_got = got.invalidate_lines(ranges)
    n_want = r_cache.invalidate_lines(want._cache_state, want.cache, ranges)
    assert n_got == n_want > 0
    got.run_program(interop.segmented_trace(r_progs[1]))
    want.run_program(r_progs[1])
    assert _stats(got) == _stats(want)
    assert (got.cache_lookups, got.cache_hits, got.prefetch_hits) == \
        (want.cache_lookups, want.cache_hits, want.prefetch_hits)
    assert got.cache_hits > 0 and got.prefetch_hits > 0
    state = interop.cache_state(want._cache_state)
    np.testing.assert_array_equal(got._cache_state.tags.numpy(),
                                  state.tags.numpy())
    np.testing.assert_array_equal(got._cache_state.age.numpy(),
                                  state.age.numpy())
    assert {"cache", "replay"} <= set(got.stage_seconds)
    assert EventDRAM(ddr4_2400r(), device="cpu").invalidate_lines(
        ranges) == 0


# ---------------------------------------------------------------------------
# simulate and run_dynamic through backend="event"
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    r_g = r_rmat(8, 5, seed=2).undirected_view()
    return r_g, interop.graph(r_g)


def _r_cache_config(c):
    from repro.core.cache import CacheConfig as RCacheConfig
    return RCacheConfig(**dataclasses.asdict(c))


_CACHES = (None, CacheConfig(lines=512, ways=4, prefetch_degree=4,
                             name="parity-cache"), "default")


@pytest.mark.parametrize("accel", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("problem", ["wcc", "bfs", "pr"])
@pytest.mark.parametrize("cache", range(len(_CACHES)))
def test_event_vs_vectorized_and_jax(graphs, accel, problem, cache):
    r_g, g = graphs
    c = _CACHES[cache]
    r_c = c if not isinstance(c, CacheConfig) else _r_cache_config(c)
    kw = dict(accelerator=accel, partition_elements=64)
    ev = simulate(g, problem, backend="event", cache=c, device="cpu", **kw)
    vec = simulate(g, problem, cache=c, device="cpu", **kw)
    want = interop.sim_report(r_simulate(r_g, problem, backend="event",
                                         cache=r_c, **kw))
    assert ev == vec == want
    assert ev.total_requests > 0
    if c is not None:
        assert ev.cache_hits + ev.prefetch_hits > 0
    assert "replay" in ev.stage_seconds and "serve" in vec.stage_seconds


@pytest.mark.parametrize("accel,preset", [("hitgraph", "uniform-churn"),
                                          ("accugraph", "pa-growth")])
@pytest.mark.parametrize("cache", [None, "vertex-1m"])
def test_run_dynamic_event_vs_jax(graphs, accel, preset, cache):
    """Every EpochReport field as ``repro``'s event run and as the port's
    vectorized run; with a cache, each epoch invalidates lines."""
    r_g, g = graphs
    res = run_dynamic(g, "wcc", updates=preset, accelerator=accel,
                      backend="event", cache=cache, device="cpu")
    want = interop.dynamic_result(r_run_dynamic(
        r_g, "wcc", updates=preset, accelerator=accel, backend="event",
        cache=cache))
    vec = run_dynamic(g, "wcc", updates=preset, accelerator=accel,
                      cache=cache, device="cpu")
    assert len(res.epochs) == len(want.epochs) == len(vec.epochs)
    for ep, w, v in zip(res.epochs, want.epochs, vec.epochs):
        for f in dataclasses.fields(ep):
            assert getattr(ep, f.name) == getattr(w, f.name) == \
                getattr(v, f.name), (ep.epoch, f.name)
    assert res.report == want.report
    np.testing.assert_array_equal(res.final_values, want.final_values)
    if cache is not None:
        assert all(ep.cache_lines_invalidated > 0 for ep in res.epochs[1:])
        assert res.report.cache_hits > 0
