"""The port's lock witness (``repro_torch.analysis.locks``) and the
lock-instrumented concurrency stress of the port, on the CPU.

The 17 cases of ``tests/test_concurrency_stress.py``, run on
``repro_torch``: the witness's unit tests, then 8 threads hammering one
``SimSession`` / one ``Sweeper`` / one ``SimService`` (``device="cpu"``,
karate) with mixed cases, and 8 threads saving one graph file, all under
``REPRO_ANALYSIS_LOCKS=1``, asserting zero recorded hazards and results
bit-identical to serial execution.  One more case feeds the same scripted
lock sequence to both packages' witnesses and asserts equal findings.

``REPRO_STRESS_ITERS`` multiplies the per-thread iteration count, as in
the JAX package's stress test.  Graphs come from the corpus with the disk
store off (``REPRO_GRAPH_CACHE=0``).
"""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro.analysis import locks as r_locks

from repro_torch.analysis import locks
from repro_torch.errors import UnknownPresetError
from repro_torch.graphs.corpus import load_graph_binary, save_graph_binary
from repro_torch.graphs.generators import rmat
from repro_torch.kernels import count_launch
from repro_torch.serve import chaos
from repro_torch.serve.engine import DONE, SimService
from repro_torch.sim.session import SimSession
from repro_torch.sim.sweep import Sweeper, SweepCase

THREADS = 8
ITERS = max(1, int(os.environ.get("REPRO_STRESS_ITERS", "1")))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _instrumented(monkeypatch):
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    locks.reset()
    yield
    locks.reset()


# ---------------------------------------------------------------------------
# locks.py unit tests
# ---------------------------------------------------------------------------

class TestTrackedLock:
    def test_basic_mutex_semantics(self):
        lk = locks.make_lock("a")
        with lk:
            assert lk.locked() and lk.held_by_current_thread()
        assert not lk.locked()
        locks.assert_clean()

    def test_lock_order_inversion_detected(self):
        a, b = locks.make_lock("outer"), locks.make_lock("inner")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        kinds = [f.kind for f in locks.findings()]
        assert "lock-order-inversion" in kinds

    def test_consistent_order_is_clean(self):
        a, b = locks.make_lock("outer"), locks.make_lock("inner")
        for _ in range(3):
            with a:
                with b:
                    pass
        locks.assert_clean()

    def test_nested_same_role_detected(self):
        a, b = locks.make_lock("session"), locks.make_lock("session")
        with a:
            with b:
                pass
        kinds = [f.kind for f in locks.findings()]
        assert "nested-same-role" in kinds

    def test_reacquire_detected_without_deadlock(self):
        lk = locks.make_lock("a")
        lk.acquire()
        # record-then-block: a non-blocking re-acquire on this thread is
        # logged before it fails
        assert not lk.acquire(blocking=False)
        lk.release()
        kinds = [f.kind for f in locks.findings()]
        assert "reacquire" in kinds

    def test_disabled_records_nothing(self, monkeypatch):
        monkeypatch.setenv(locks.ENV_FLAG, "0")
        a, b = locks.make_lock("x"), locks.make_lock("y")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        assert locks.findings() == []


class TestGuardedDict:
    def test_guarded_access_clean(self):
        lk = locks.make_lock("g")
        d = locks.make_dict("d", lk)
        with lk:
            d["k"] = 1
            assert d.get("k") == 1
            assert "k" in d and len(d) == 1
        locks.assert_clean()

    def test_unguarded_write_detected(self):
        d = locks.make_dict("d", locks.make_lock("g"))
        d["k"] = 1
        kinds = [f.kind for f in locks.findings()]
        assert kinds == ["unguarded-access"]
        assert "d" in locks.findings()[0].detail

    def test_unguarded_read_detected(self):
        lk = locks.make_lock("g")
        d = locks.make_dict("d", lk)
        with lk:
            d["k"] = 1
        d.get("k")
        assert [f.kind for f in locks.findings()] == ["unguarded-access"]

    def test_guard_held_by_other_thread_detected(self):
        lk = locks.make_lock("g")
        d = locks.make_dict("d", lk)
        lk.acquire()
        t = threading.Thread(target=lambda: d.get("k"))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        lk.release()
        assert [f.kind for f in locks.findings()] == ["unguarded-access"]


class TestWitnessWrite:
    def test_serial_writes_clean(self, tmp_path):
        with locks.witness_write(tmp_path / "f"):
            pass
        with locks.witness_write(tmp_path / "f"):
            pass
        locks.assert_clean()

    def test_concurrent_same_path_detected(self, tmp_path):
        enter = threading.Barrier(2)

        def writer():
            with locks.witness_write(tmp_path / "f"):
                enter.wait(timeout=10)

        ts = [threading.Thread(target=writer) for _ in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert [f.kind for f in locks.findings()] == ["concurrent-write"]


# ---------------------------------------------------------------------------
# both witnesses on one scripted sequence
# ---------------------------------------------------------------------------

def _scripted_hazards(mod, path):
    """One of each hazard, driven through ``mod``'s public surface."""
    outer, inner = mod.make_lock("outer"), mod.make_lock("inner")
    with outer:
        with inner:
            pass
    with inner:                                  # lock-order-inversion
        with outer:
            pass
    s1, s2 = mod.make_lock("session"), mod.make_lock("session")
    with s1:                                     # nested-same-role
        with s2:
            pass
    solo = mod.make_lock("solo")
    solo.acquire()
    assert not solo.acquire(blocking=False)      # reacquire
    solo.release()
    d = mod.make_dict("SimSession._runs", solo)
    with solo:
        d["k"] = 1
    d.get("k")                                   # unguarded-access (read)
    d["j"] = 2                                   # unguarded-access (write)
    enter = threading.Barrier(2)

    def writer():
        with mod.witness_write(path):            # concurrent-write
            enter.wait(timeout=10)

    ts = [threading.Thread(target=writer) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    return [(f.kind, f.detail) for f in mod.findings()]


def test_same_findings_as_the_jax_package_witness(tmp_path):
    assert locks.ENV_FLAG == r_locks.ENV_FLAG
    r_locks.reset()
    try:
        want = _scripted_hazards(r_locks, tmp_path / "g.bin")
    finally:
        r_locks.reset()
    got = _scripted_hazards(locks, tmp_path / "g.bin")
    assert got == want
    assert sorted({k for k, _ in got}) == [
        "concurrent-write", "lock-order-inversion", "nested-same-role",
        "reacquire", "unguarded-access"]


# ---------------------------------------------------------------------------
# the kernels' launch counters, bumped from many threads
# ---------------------------------------------------------------------------

def test_launch_counts_lose_no_update():
    """``count_launch`` from more threads than cores, with the
    interpreter switching threads as often as it can: not one count is
    lost, and the witness records nothing."""
    def wrapper():
        pass

    wrapper.launches = 0
    threads, per_thread = 4 * (os.cpu_count() or 4), 2000 * ITERS
    start = threading.Barrier(threads)

    def bump():
        start.wait(timeout=30)
        for _ in range(per_thread):
            count_launch(wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=bump) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert wrapper.launches == threads * per_thread
    locks.assert_clean()


# ---------------------------------------------------------------------------
# instrumented stress: SimSession / Sweeper / corpus store / SimService
# ---------------------------------------------------------------------------

def _mixed_cases():
    """A case mix that exercises every single-flight cache: shared
    algorithm runs, distinct memory/cache variants, both accelerators."""
    out = []
    for problem in ("pr", "bfs", "spmv"):
        for memory, cache in (("ddr4", None),
                              ("ddr4", "vertex-64k"),
                              ("hbm2", None)):
            out.append(dict(problem=problem, accelerator="hitgraph",
                            memory=memory, cache=cache))
    return out


def _report_key(report):
    """Canonical, bit-exact identity of one simulation result."""
    return (report.system, report.problem, report.runtime_ns,
            report.iterations, report.total_requests, report.total_bytes,
            report.row_hit_rate, report.cache_lookups, report.cache_hits)


class TestSessionStress:
    def test_eight_threads_bit_identical_to_serial(self):
        cases = _mixed_cases() * ITERS

        serial = SimSession("karate")
        expect = [_report_key(serial.run(**c, device=CPU)) for c in cases]

        shared = SimSession("karate")
        with ThreadPoolExecutor(THREADS) as pool:
            got = list(pool.map(
                lambda c: _report_key(shared.run(**c, device=CPU)), cases))

        assert got == expect
        locks.assert_clean()
        # the mixed case set must actually share work across threads
        assert shared.algo_cache_hits > 0

    def test_sweeper_workers_match_serial(self):
        cases = [SweepCase("karate", p, memory=m)
                 for p in ("pr", "wcc") for m in ("ddr4", "hbm2")
                 for _ in range(ITERS)]
        serial_rows = Sweeper(workers=1, device=CPU).run(cases)
        threaded_rows = Sweeper(workers=THREADS, device=CPU).run(cases)

        def strip(row):
            d = row.as_dict()
            d.pop("wall_s")
            return d

        assert list(map(strip, threaded_rows)) == \
            list(map(strip, serial_rows))
        locks.assert_clean()


class TestCorpusStoreStress:
    def test_parallel_saves_one_path_no_tmp_collision(self, tmp_path):
        g = rmat(scale=7, avg_degree=6, seed=0)
        path = tmp_path / "g.bin"
        start = threading.Barrier(THREADS)

        def save():
            start.wait(timeout=30)
            for _ in range(3 * ITERS):
                save_graph_binary(path, g)

        with ThreadPoolExecutor(THREADS) as pool:
            for f in [pool.submit(save) for _ in range(THREADS)]:
                f.result()

        locks.assert_clean()
        loaded = load_graph_binary(path)
        assert loaded.n == g.n and loaded.m == g.m
        assert list(tmp_path.iterdir()) == [path]   # no tmp litter


class TestSimServiceStress:
    def test_concurrent_submitters_fifo_deterministic(self):
        with SimService(device=CPU) as svc:
            cases = [[SweepCase("karate", p)] for p in ("pr", "bfs")]
            with ThreadPoolExecutor(4) as pool:
                ids = list(pool.map(svc.submit, cases * (2 * ITERS)))
            rows = [svc.result(i, timeout=300) for i in ids]
            assert all(svc.poll(i) == DONE for i in ids)
        # same submission -> bit-identical rows, regardless of timing
        key = lambda r: _report_key(r[0].report)       # noqa: E731
        assert key(rows[0]) == key(rows[2])
        assert key(rows[1]) == key(rows[3])
        locks.assert_clean()

    def test_failure_isolated_per_job(self):
        # a preset typo fails eagerly at SweepCase construction, so a
        # *runtime* failure needs an injected permanent fault; one
        # quarantine stays below the breaker threshold, so the good job on
        # the same geometry still runs
        with pytest.raises(UnknownPresetError):
            SweepCase("karate", "pr", accelerator="no-such")
        cfg = chaos.ChaosConfig(seed=2, sites={
            "dram.serve": chaos.SiteConfig(rate=1.0, permanent_rate=1.0)})
        with SimService(device=CPU) as svc:
            with chaos.scope(cfg):
                bad = svc.submit([SweepCase("karate", "pr")])
                with pytest.raises(Exception):
                    svc.result(bad, timeout=300)
            good = svc.submit([SweepCase("karate", "pr")])
            assert len(svc.result(good, timeout=300)) == 1
        locks.assert_clean()
