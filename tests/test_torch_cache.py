"""The port's on-chip cache layer against the JAX package's.

* the lookup's plain version (``cache_lookup_ref``, what ``lookup_reads``
  runs for a state on the CPU) against ``repro``'s NumPy column loop
  ``_lookup_numpy`` and its jitted ``_lookup_scan``: hit masks and the
  chained state, over sets, ways (1, 16, 64), hot-set skew and a warm
  state (hypothesis);
* ``filter_trace`` / ``filter_program``, ``_prefetch_issue``,
  ``invalidate_lines`` and ``stale_line_ranges`` against ``repro``;
* ``simulate(..., cache=c, device="cpu")`` against
  ``repro.sim.simulate(..., cache=c)`` on the golden graphs, every
  ``SimReport`` field equal, the cache counters included;
* ``run_dynamic(..., cache="default")`` on both accelerators against
  ``repro``, every ``EpochReport`` field equal, the invalidated lines
  included.

Every value is an integer (or the same float operation on equal
integers): all comparisons are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import cache as r_cache
from repro.core import delta as r_delta
from repro.core.trace import SegmentedTrace as RSegmentedTrace
from repro.core.trace import Trace as RTrace
from repro.graphs.corpus import GRAPH_PRESETS
from repro.graphs.generators import rmat as r_rmat
from repro.sim import get_accelerator as r_get_accelerator
from repro.sim import run_dynamic as r_run_dynamic
from repro.sim import simulate as r_simulate
from repro.sim.memory import CACHE_PRESETS as R_CACHE_PRESETS

from repro_torch import interop
from repro_torch.core import cache
from repro_torch.core.delta import stale_line_ranges
from repro_torch.core.trace import SegmentedTrace, Trace
from repro_torch.kernels.cache_lookup.ops import cache_lookup
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref
from repro_torch.sim import get_accelerator, run_dynamic, simulate
from repro_torch.sim.memory import CACHE_PRESETS, cache_name, resolve_cache

MEMORIES = {"hitgraph": ["ddr3", "hbm2"],
            "accugraph": ["ddr4", "ddr4-8gb", "hbm2"]}
CACHES = ("default", "vertex-64k", "direct-256k", "prefetch-4",
          "vertex-1m+prefetch")


def _stream(rng, n, sets, ways, hot):
    """Line stream with ``hot`` of the reads on one set (the skew), the
    rest spread over ~6x the capacity, and short sequential runs."""
    span = sets * ways * 6
    lines = rng.integers(0, span, n)
    on_hot = rng.random(n) < hot
    lines[on_hot] = (rng.integers(0, 4 * ways, int(on_hot.sum())) * sets
                     + 3 % sets)
    run_at = rng.random(n) < 0.2
    lines[1:][run_at[1:]] = lines[:-1][run_at[1:]] + 1
    return lines


def _r_state(st_t):
    return r_cache.CacheState(tags=st_t.tags.numpy().copy(),
                              age=st_t.age.numpy().copy())


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**16), sets_log=st.integers(0, 5),
       ways=st.sampled_from([1, 16, 64]), n=st.integers(0, 400),
       hot=st.sampled_from([0.0, 0.5, 0.95]), warm=st.booleans())
def test_lookup_vs_numpy_and_scan(seed, sets_log, ways, n, hot, warm):
    rng = np.random.default_rng(seed)
    sets = 1 << sets_log
    cfg = cache.CacheConfig(lines=sets * ways, ways=ways)
    state = cache.init_state(cfg, "cpu")
    if warm:                              # a state other streams left
        lines = _stream(rng, 300, sets, ways, 0.3)
        cache.lookup_reads(state, lines % sets, lines // sets)
    st_host, st_scan = _r_state(state), _r_state(state)
    lines = _stream(rng, n, sets, ways, hot)
    set_idx, tag = lines % sets, lines // sets
    got = cache.lookup_reads(state, set_idx, tag)
    want = r_cache.lookup_reads(st_host, set_idx, tag, backend="host")
    assert np.array_equal(got, want)
    assert np.array_equal(state.tags.numpy(), st_host.tags)
    assert np.array_equal(state.age.numpy(), st_host.age)
    if n:
        assert np.array_equal(
            got, r_cache.lookup_reads(st_scan, set_idx, tag,
                                      backend="device"))
        assert np.array_equal(state.tags.numpy(), st_scan.tags)
        assert np.array_equal(state.age.numpy(), st_scan.age)


def test_lookup_ref_on_segments_vs_numpy_columns():
    """``cache_lookup_ref`` (and the wrapper on CPU tensors) on CSR
    segments against ``_lookup_numpy`` on ``_columns``' matrices, with
    tags past int32 (the port's tags are int64 end to end)."""
    rng = np.random.default_rng(3)
    U, W = 5, 16
    row = rng.integers(0, U, 600)
    tag = rng.integers(2**31, 2**31 + 40, 600)
    tag_m, valid_m, slot = r_cache._columns(U, row, tag)
    tags0 = np.full((U, W), -1, dtype=np.int64)
    age0 = np.broadcast_to(np.arange(W), (U, W)).copy()
    tags_np, age_np = tags0.copy(), age0.copy()
    want = r_cache._lookup_numpy(tags_np, age_np, tag_m, valid_m)[row, slot]
    order = np.argsort(row, kind="stable")
    seg_ptr = torch.as_tensor(np.concatenate(
        [[0], np.cumsum(np.bincount(row, minlength=U))]))
    args = (seg_ptr, torch.as_tensor(tag[order]),
            torch.as_tensor(order.astype(np.int32)))
    for fn in (cache_lookup_ref, cache_lookup):
        tags_t, age_t = torch.tensor(tags0), torch.tensor(age0)
        got = fn(*args, tags_t, age_t)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(tags_t.numpy(), tags_np)
        assert np.array_equal(age_t.numpy(), age_np)


def _random_program(rng, n_phases=4, span=1 << 12, max_n=200):
    """The generator of tests/test_cache_model.py, writes included."""
    phases = []
    for p in range(n_phases):
        n = int(rng.integers(8, max_n))
        hot = rng.integers(0, max(span // 16, 1), n)
        lines = np.where(rng.random(n) < 0.5, hot, rng.integers(0, span, n))
        run_at = rng.random(n) < 0.3
        lines[1:][run_at[1:]] = lines[:-1][run_at[1:]] + 1
        phases.append((f"p{p}", lines, rng.random(n) < 0.2,
                       np.sort(rng.integers(0, 4 * n, n))))
    return phases


def _same_program(got: SegmentedTrace, want) -> None:
    assert got.names == list(want.names)
    for f in ("line_addr", "is_write", "issue", "offsets"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**16),
       geometry=st.sampled_from([(64, 4, 3), (0, 1, 4), (256, 16, 0),
                                 (16, 1, 8)]))
def test_filter_program_and_trace_vs_repro(seed, geometry):
    lines, ways, degree = geometry
    rng = np.random.default_rng(seed)
    phases = _random_program(rng)
    cfg = cache.CacheConfig(lines=lines, ways=ways, prefetch_degree=degree)
    r_cfg = r_cache.CacheConfig(lines=lines, ways=ways,
                                prefetch_degree=degree)
    prog = SegmentedTrace.from_phases(phases)
    r_prog = RSegmentedTrace.from_phases(phases)
    got, gs, state = cache.filter_program(prog, cfg, device="cpu")
    want, ws, r_state = r_cache.filter_program(r_prog, r_cfg,
                                               backend="host")
    _same_program(got, want)
    assert dataclasses.asdict(gs) == dataclasses.asdict(ws)
    if lines:
        assert np.array_equal(state.tags.numpy(), r_state.tags)
        assert np.array_equal(state.age.numpy(), r_state.age)
    # phase by phase through filter_trace, the state chained, from the
    # states the whole programs left
    for p in range(prog.n_phases):
        tr, ts, state = cache.filter_trace(prog.phase(p), cfg, state,
                                           device="cpu")
        r_tr, rs, r_state = r_cache.filter_trace(r_prog.phase(p), r_cfg,
                                                 r_state, backend="host")
        for f in ("line_addr", "is_write", "issue"):
            assert np.array_equal(getattr(tr, f), getattr(r_tr, f))
        assert dataclasses.asdict(ts) == dataclasses.asdict(rs)


def test_all_hit_phase_dropped():
    """A phase whose every request hits leaves the filtered program."""
    cfg = cache.CacheConfig(lines=64, ways=4)
    lines = np.arange(10)
    prog = SegmentedTrace.from_phases(
        [("a", lines, np.zeros(10, bool), np.arange(10)),
         ("b", lines, np.zeros(10, bool), np.arange(10)),
         ("c", lines + 100, np.zeros(10, bool), np.arange(10))])
    got, stats, _ = cache.filter_program(prog, cfg, device="cpu")
    assert got.names == ["a", "c"]
    assert (stats.lookups, stats.hits) == (30, 10)
    want, _, _ = r_cache.filter_program(
        RSegmentedTrace.from_phases([(n, prog.phase(i)) for i, n in
                                     enumerate(prog.names)]),
        r_cache.CacheConfig(lines=64, ways=4), backend="host")
    _same_program(got, want)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), degree=st.integers(0, 9),
       n=st.integers(0, 300))
def test_prefetch_issue_vs_repro(seed, degree, n):
    rng = np.random.default_rng(seed)
    line = np.cumsum(rng.integers(0, 3, n))
    wr = rng.random(n) < 0.2
    issue = np.sort(rng.integers(0, 4 * n + 1, n))
    got = cache._prefetch_issue(line, wr, issue, degree)
    want = r_cache._prefetch_issue(line, wr, issue, degree)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    # a phase break ends every run, as separate calls do
    cut = n // 2
    phase = (np.arange(n) >= cut).astype(np.int64)
    got = cache._prefetch_issue(line, wr, issue, degree, phase)
    a = r_cache._prefetch_issue(line[:cut], wr[:cut], issue[:cut], degree)
    b = r_cache._prefetch_issue(line[cut:], wr[cut:], issue[cut:], degree)
    assert np.array_equal(got[0], np.concatenate([a[0], b[0]]))
    assert got[1] == a[1] + b[1]


@pytest.mark.parametrize("ways", [1, 4, 16])
def test_invalidate_lines_vs_repro(ways):
    rng = np.random.default_rng(ways)
    sets = 8
    cfg = cache.CacheConfig(lines=sets * ways, ways=ways)
    r_cfg = r_cache.CacheConfig(lines=sets * ways, ways=ways)
    state = cache.init_state(cfg, "cpu")
    lines = rng.integers(0, sets * ways * 4, 500)
    cache.lookup_reads(state, lines % sets, lines // sets)
    r_state = _r_state(state)
    ranges = [(int(f), int(c)) for f, c in zip(
        rng.integers(0, sets * ways * 4, 6), rng.integers(0, 40, 6))]
    ranges += [(3, 0), (10, 50), (30, 5)]       # empty and overlapping
    got = cache.invalidate_lines(state, cfg, ranges)
    want = r_cache.invalidate_lines(r_state, r_cfg, ranges)
    assert got == want and got > 0
    assert np.array_equal(state.tags.numpy(), r_state.tags)
    assert np.array_equal(state.age.numpy(), r_state.age)
    assert cache.invalidate_lines(None, cfg, ranges) == 0
    assert cache.invalidate_lines(state, cfg, []) == 0


@pytest.mark.parametrize("acc", ["hitgraph", "accugraph"])
def test_stale_line_ranges_vs_repro(acc):
    """Stale ranges of a layout rebuild after an update batch."""
    from repro.graphs.updates import apply_batch, resolve_updates
    from repro_torch.sim.session import resolve_run_config

    g = r_rmat(8, 5, seed=4).undirected_view()
    stream = resolve_updates("pa-growth")
    batch = stream.batch(g, 1)
    g_new = apply_batch(g, batch)
    r_spec = r_get_accelerator(acc)
    cfg = r_spec.make_config(None, partition_elements=32)
    old, new = r_spec.build_model(g, cfg), r_spec.build_model(g_new, cfg)
    touched = r_delta.structural_partitions(batch, g, new.q, new.p)
    want = r_delta.stale_line_ranges(old, new, touched)
    spec = get_accelerator(acc)
    t_cfg = resolve_run_config(spec, partition_elements=32)
    got = stale_line_ranges(spec.build_model(interop.graph(g), t_cfg),
                            spec.build_model(interop.graph(g_new), t_cfg),
                            touched)
    assert got == want and len(got) > 0


def test_presets_and_names():
    assert {k: dataclasses.astuple(v) for k, v in CACHE_PRESETS.items()} == \
        {k: dataclasses.astuple(v) for k, v in R_CACHE_PRESETS.items()}
    for acc in ("hitgraph", "accugraph"):
        got = resolve_cache("default", get_accelerator(acc))
        want = r_get_accelerator(acc).default_cache()
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.display_name() == want.display_name()
    assert cache_name(None) == "none"
    assert cache_name(cache.CacheConfig(lines=1024, ways=8,
                                        prefetch_degree=2)) == "64KiB/8w+pf2"
    assert resolve_cache("vertex-1m").sets == 1024
    with pytest.raises(ValueError, match="spec"):
        resolve_cache("default")
    with pytest.raises(KeyError):
        resolve_cache("vertex-3m")
    with pytest.raises(ValueError):
        cache.CacheConfig(lines=10, ways=4)


def _graphs():
    return {"karate": GRAPH_PRESETS["karate"].build(),
            "rmat7": r_rmat(7, 4, seed=101).undirected_view(),
            "rmat8": r_rmat(8, 5, seed=102).undirected_view()}


@pytest.mark.parametrize("c", CACHES)
@pytest.mark.parametrize("acc", ["hitgraph", "accugraph"])
@pytest.mark.parametrize("gname", ["karate", "rmat7", "rmat8"])
def test_simulate_cache_vs_repro(gname, acc, c):
    g = _graphs()[gname]
    gt = interop.graph(g)
    for mem in MEMORIES[acc]:
        for prob in ("wcc", "bfs"):
            want = interop.sim_report(r_simulate(
                g, prob, accelerator=acc, memory=mem, cache=c,
                partition_elements=64))
            got = simulate(gt, prob, accelerator=acc, memory=mem, cache=c,
                           partition_elements=64, device="cpu")
            assert got == want, (mem, prob)
            assert got.cache_hit_rate == want.cache_hits / max(
                want.cache_lookups, 1)
            if c != "prefetch-4" and (c, acc) != ("default", "hitgraph"):
                assert got.cache_lookups > 0


@pytest.mark.parametrize("acc, updates", [("hitgraph", "uniform-churn"),
                                          ("accugraph", "pa-growth")])
def test_run_dynamic_cache_default_vs_repro(acc, updates):
    g = r_rmat(9, 6, seed=7).undirected_view()
    want = interop.dynamic_result(r_run_dynamic(
        g, "wcc", updates=updates, accelerator=acc, cache="default"))
    got = run_dynamic(interop.graph(g), "wcc", updates=updates,
                      accelerator=acc, cache="default", device="cpu",
                      verify=True)
    assert len(got.epochs) == len(want.epochs) == 4
    for a, b in zip(got.epochs, want.epochs):
        assert a == b, a.epoch
    assert got.report == want.report
    assert np.array_equal(got.final_values, want.final_values)
    if acc == "accugraph":
        assert all(ep.cache_lines_invalidated > 0 for ep in got.epochs[1:])
    else:
        assert got.report.prefetch_hits > 0


@pytest.mark.parametrize("degree, fits", [(6, True), (8, False)])
def test_default_bram_cliff_vs_repro(degree, fits):
    """AccuGraph's 2 MiB 16-way BRAM (``cache="default"``, 32,768 lines)
    below and above its capacity: rmat(15, 6) reads 28,673 lines an
    iteration, rmat(15, 8) 36,865.  Each line is read once an iteration,
    so the LRU keeps the first footprint (every iteration after the first
    hits) and thrashes on the second (no hit at all), in the port as in
    ``repro``."""
    g = r_rmat(15, degree, seed=0).undirected_view()
    want = interop.sim_report(r_simulate(g, "wcc", accelerator="accugraph",
                                         cache="default"))
    got = simulate(interop.graph(g), "wcc", accelerator="accugraph",
                   cache="default", device="cpu")
    assert got == want
    lines = get_accelerator("accugraph").default_cache().lines
    per_iter, rem = divmod(got.cache_lookups, got.iterations)
    assert rem == 0
    if fits:
        assert per_iter < lines
        assert got.cache_hits == per_iter * (got.iterations - 1) > 0
    else:
        assert per_iter > lines
        assert got.cache_hits == 0


def test_backend_invalidate_lines():
    """``VectorizedDRAM.invalidate_lines`` drops the lines of its own
    state, as ``invalidate_lines`` does on a copy of it; without a cache
    level it drops nothing."""
    from repro_torch.core.accel import VectorizedDRAM
    from repro_torch.sim.memory import resolve_memory

    cfg = dataclasses.replace(resolve_memory("ddr4"),
                              cache=cache.CacheConfig(lines=64, ways=4))
    rng = np.random.default_rng(9)
    lines = rng.integers(0, 512, 300)
    prog = SegmentedTrace.from_phases(
        [("p", lines, np.zeros(300, bool), np.arange(300))])
    mem = VectorizedDRAM(cfg, device="cpu")
    mem.run_program(prog)
    copy = cache.CacheState(tags=mem._cache_state.tags.clone(),
                            age=mem._cache_state.age.clone())
    ranges = [(0, 100), (250, 40)]
    n = mem.invalidate_lines(ranges)
    assert n == cache.invalidate_lines(copy, mem.cache, ranges) > 0
    assert torch.equal(mem._cache_state.tags, copy.tags)
    assert torch.equal(mem._cache_state.age, copy.age)
    plain = VectorizedDRAM(resolve_memory("ddr4"), device="cpu")
    assert plain.invalidate_lines(ranges) == 0
