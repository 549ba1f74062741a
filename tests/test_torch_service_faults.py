"""Fault-injection recovery of the port's service (``repro_torch.serve``)
against the JAX package's, on the CPU.

The 20 tests of ``tests/test_service_faults.py``, each run through both
packages with the same submissions and the same chaos model (the port's
service with ``device="cpu"``).  The two packages keep their chaos state
apart (``repro_torch.serve.chaos`` is the port's own copy), so every test
arms each package with its own ``chaos.scope``.  What is compared:

* exactly: every surviving row (``as_dict`` minus ``wall_s``, every
  ``SimReport`` field and phase), each job's terminal state, the
  quarantined indices and their causes' types, ``ServiceStats`` where the
  JAX test pins it, ``case_chaos_key`` strings, ``chaos.plan`` outcomes
  and the injection log where scheduling cannot change it;
* where the JAX test leaves a count to scheduling (retries, worker
  crashes under several workers), the port is held to the JAX test's own
  bound, and its surviving rows to the JAX package's at those indices.

Then the port's one departure: a ``KernelError`` (a kernel that failed to
build, load or launch) is never transient, so its case fails at once.
The rows carry no float ``values``, so no tolerance applies (it would be
the rtol 1e-5 of ``test_torch_sweep_engine.py``).  Graphs come from the
corpus with the disk store off (``REPRO_GRAPH_CACHE=0``) or from a store
of each package's own in ``tmp_path``.
"""

import importlib
import time

import pytest

from repro.serve import chaos as r_chaos
from repro.serve import engine as r_engine

from repro_torch import interop
from repro_torch.errors import KernelError
from repro_torch.serve import chaos as t_chaos
from repro_torch.serve import engine as t_engine

r_sweep = importlib.import_module("repro.sim.sweep")
t_sweep = importlib.import_module("repro_torch.sim.sweep")
r_corpus = importlib.import_module("repro.graphs.corpus")
t_corpus = importlib.import_module("repro_torch.graphs.corpus")


class Pkg:
    """One package's service, chaos and sweep surface; ``kw`` goes to
    every constructor that takes a device (the port's: ``"cpu"``)."""

    def __init__(self, engine, chaos, sweep, corpus, **kw):
        self.engine, self.chaos, self.sweep = engine, chaos, sweep
        self.corpus, self.kw = corpus, kw
        self.FAST = engine.RetryPolicy(retries=6, backoff_base_s=0.001,
                                       backoff_cap_s=0.01)
        self.NO_TRIP = engine.BreakerConfig(threshold=10_000)

    def service(self, **kw):
        kw.setdefault("retry", self.FAST)
        kw.setdefault("breaker", self.NO_TRIP)
        return self.engine.SimService(**kw, **self.kw)

    def cases(self):
        """``CASES`` of tests/test_service_faults.py."""
        c = self.sweep.SweepCase
        return [c("karate", "pr"), c("karate", "bfs"), c("karate", "sssp"),
                c("karate", "pr", root=5), c("karate", "bfs", root=7),
                c("karate", "sssp", root=9)]

    def config(self, seed, **sites):
        """A chaos model; each site is ``SiteConfig`` keywords."""
        return self.chaos.ChaosConfig(seed=seed, sites={
            name.replace("_", "."): self.chaos.SiteConfig(**kw)
            for name, kw in sites.items()})

    def baseline(self):
        return self.sweep.Sweeper(workers=1, **self.kw).run(self.cases())


R = Pkg(r_engine, r_chaos, r_sweep, r_corpus)
T = Pkg(t_engine, t_chaos, t_sweep, t_corpus, device="cpu")


@pytest.fixture(autouse=True)
def _no_leftover_chaos(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")
    r_chaos.deactivate()
    t_chaos.deactivate()
    yield
    r_chaos.deactivate()
    t_chaos.deactivate()


def _row(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def assert_rows_equal(rows, r_rows):
    assert [_row(r) for r in rows] == [_row(r) for r in r_rows]
    assert [r.report for r in rows] == [interop.sim_report(r.report)
                                        for r in r_rows]


def _causes(svc, job):
    quarantined = svc._jobs[job].quarantined
    return {i: type(e).__name__ for i, e in quarantined.items()}


def _both(fn):
    """``fn(pkg)`` through the JAX package, then through the port."""
    return fn(R), fn(T)


# ---------------------------------------------------------------------------
# per-site recovery paths
# ---------------------------------------------------------------------------

class TestTransientRecovery:
    def test_prepare_faults_are_retried_to_success(self):
        def run(p):
            cfg = p.config(7, sweep_prepare=dict(rate=1.0, max_attempts=2))
            with p.chaos.scope(cfg):
                with p.service(workers=2) as svc:
                    rows = svc.result(svc.submit(p.cases()), timeout=240)
                log = p.chaos.injected_log()
            return rows, svc.service_stats, log
        (r_rows, r_st, r_log), (rows, st, log) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert any(site == "sweep.prepare" for site, *_ in log)
        assert st.retries > 0 and st.quarantined == r_st.quarantined == 0

    def test_dram_serve_faults_are_retried_to_success(self):
        def run(p):
            cfg = p.config(5, dram_serve=dict(rate=1.0, max_attempts=1))
            with p.chaos.scope(cfg):
                with p.service(workers=1) as svc:
                    rows = svc.result(svc.submit(p.cases()), timeout=240)
                log = sorted(p.chaos.injected_log())
            return rows, vars(svc.service_stats), log
        (r_rows, r_st, r_log), (rows, st, log) = _both(run)
        assert_rows_equal(rows, r_rows)
        # one worker: the same faults in the same order, the same retries
        assert (st, log) == (r_st, r_log) and st["retries"] > 0

    def test_transient_rows_match_no_fault_run(self):
        def run(p):
            cfg = p.config(3, sweep_prepare=dict(rate=0.7, max_attempts=3),
                           dram_serve=dict(rate=0.5, max_attempts=2))
            with p.chaos.scope(cfg):
                with p.service(workers=2) as svc:
                    return svc.result(svc.submit(p.cases()), timeout=240)
        r_rows, rows = _both(run)
        assert_rows_equal(rows, r_rows)
        assert_rows_equal(rows, T.baseline())


class TestPermanentQuarantine:
    def test_permanent_fault_quarantines_with_structured_cause(self):
        def run(p):
            cfg = p.config(2, dram_serve=dict(rate=1.0, permanent_rate=1.0))
            with p.chaos.scope(cfg):
                with p.service(workers=1) as svc:
                    job = svc.submit(p.cases())
                    with pytest.raises(p.engine.JobFailed) as exc:
                        svc.result(job, timeout=240)
                    info = svc.info(job)
            cause = exc.value.__cause__
            assert isinstance(cause, p.sweep.SweepError)
            assert isinstance(cause.__cause__, p.chaos.InjectedFault)
            assert cause.__cause__.permanent
            return (info["quarantined"], exc.value.rows, _causes(svc, job),
                    vars(svc.service_stats))
        got, want = _both(run)[::-1]
        assert got == want
        assert got[0] == list(range(6)) and got[1] == []
        assert got[3]["retries"] == 0

    def test_mixed_permanent_keeps_surviving_rows(self):
        def run(p):
            cfg = p.config(9, sweep_prepare=dict(rate=0.5,
                                                 permanent_rate=1.0))
            with p.chaos.scope(cfg):
                with p.service(workers=2) as svc:
                    job = svc.submit(p.cases())
                    with pytest.raises(p.engine.JobFailed):
                        svc.result(job, timeout=240)
                    return (svc.partial_rows(job),
                            svc.info(job)["quarantined"], _causes(svc, job))
        (r_rows, r_q, r_causes), (rows, q, causes) = _both(run)
        assert 0 < len(rows) < 6 and len(rows) + len(q) == 6
        assert (q, causes) == (r_q, r_causes)
        assert_rows_equal(rows, r_rows)
        assert_rows_equal(rows, [r for i, r in enumerate(T.baseline())
                                 if i not in q])


class TestWorkerCrashSupervision:
    def test_transient_crash_requeues_and_completes(self):
        def run(p):
            cfg = p.config(1, worker_crash=dict(rate=1.0, max_attempts=1,
                                                crash=True))
            with p.chaos.scope(cfg):
                with p.service(workers=1) as svc:
                    job = svc.submit(p.cases())
                    rows = svc.result(job, timeout=240)
                    assert svc.poll(job) == p.engine.DONE
            return rows, svc.service_stats
        (r_rows, r_st), (rows, st) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert st.worker_crashes >= 1 and r_st.worker_crashes >= 1
        assert st.quarantined == r_st.quarantined == 0

    def test_permanent_crash_quarantines_and_service_survives(self):
        def run(p):
            case0, case1 = p.cases()[:2]
            cfg = p.config(1, worker_crash=dict(rate=1.0, permanent_rate=1.0,
                                                crash=True))
            with p.chaos.scope(cfg):
                with p.service(workers=1) as svc:
                    job = svc.submit([case0])
                    with pytest.raises(p.engine.JobFailed) as exc:
                        svc.result(job, timeout=240)
                    quarantined = svc.info(job)["quarantined"]
                    crashes = svc.service_stats.worker_crashes
                    cause = exc.value.__cause__
                    assert isinstance(cause, p.chaos.WorkerCrash)
                    p.chaos.deactivate()
                    rows = svc.result(svc.submit([case1]), timeout=240)
            return (quarantined, crashes >= 1, cause.key,
                    p.sweep.case_chaos_key(case0)), rows
        (r_out, r_rows), (out, rows) = _both(run)
        assert out == r_out and out[:2] == ([0], True)
        assert out[2] == out[3]
        assert_rows_equal(rows, r_rows)


class TestGraphStoreFaults:
    def test_read_faults_take_rebuild_path(self, tmp_path):
        def run(p):
            store = p.corpus.GraphStore(root=tmp_path / p.corpus.__name__)
            builds = []

            def build():
                builds.append(1)
                return p.corpus.resolve_graph("karate")

            g0 = store.get("k", build)
            store.get("k", build)
            assert len(builds) == 1
            cfg = p.config(1, graphstore_read=dict(rate=1.0, max_attempts=1))
            with p.chaos.scope(cfg):
                g1 = store.get("k", build)       # fault -> rebuild
                store.get("k", build)            # prefix spent -> hit
                log = p.chaos.injected_log()
            assert g1.fingerprint == g0.fingerprint
            return len(builds), g1.fingerprint, log
        got, want = _both(run)[::-1]
        assert got == want and got[0] == 2

    def test_sweep_completes_under_read_faults(self):
        def run(p):
            cfg = p.config(4, graphstore_read=dict(rate=1.0,
                                                   max_attempts=2))
            with p.chaos.scope(cfg):
                with p.service(workers=1) as svc:
                    return svc.result(svc.submit(p.cases()[:3]),
                                      timeout=240)
        r_rows, rows = _both(run)
        assert len(rows) == 3
        assert_rows_equal(rows, r_rows)


class TestCircuitBreaker:
    def test_breaker_trips_and_fails_fast(self):
        def run(p):
            cfg = p.config(2, dram_serve=dict(rate=1.0, permanent_rate=1.0))
            with p.chaos.scope(cfg):
                breaker = p.engine.BreakerConfig(threshold=2,
                                                 cooldown_s=60.0)
                with p.service(workers=1, breaker=breaker) as svc:
                    job = svc.submit(p.cases())
                    with pytest.raises(p.engine.JobFailed):
                        svc.result(job, timeout=240)
                    return (svc.info(job)["quarantined"], _causes(svc, job),
                            vars(svc.service_stats))
        got, want = _both(run)[::-1]
        assert got == want
        assert got[0] == list(range(6))
        assert got[2]["breaker_trips"] >= 1
        assert got[2]["breaker_fastfails"] >= 1

    def test_breaker_half_opens_after_cooldown(self):
        def run(p):
            case0 = p.cases()[0]
            cfg = p.config(2, dram_serve=dict(rate=1.0, permanent_rate=1.0))
            breaker = p.engine.BreakerConfig(threshold=1, cooldown_s=0.05)
            with p.service(workers=1, breaker=breaker) as svc:
                with p.chaos.scope(cfg):
                    job = svc.submit([case0])
                    with pytest.raises(p.engine.JobFailed):
                        svc.result(job, timeout=240)
                    trips = svc.service_stats.breaker_trips
                time.sleep(0.1)
                rows = svc.result(svc.submit([case0]), timeout=240)
            return trips, rows
        (r_trips, r_rows), (trips, rows) = _both(run)
        assert trips == r_trips == 1
        assert_rows_equal(rows, r_rows)


# ---------------------------------------------------------------------------
# global invariants
# ---------------------------------------------------------------------------

class TestEveryJobTerminates:
    def test_no_job_stuck_under_mixed_chaos(self):
        def run(p):
            cfg = p.config(
                13,
                sweep_prepare=dict(rate=0.5, max_attempts=2,
                                   permanent_rate=0.2),
                dram_serve=dict(rate=0.3, max_attempts=1,
                                permanent_rate=0.3),
                worker_crash=dict(rate=0.25, permanent_rate=0.5, crash=True))
            cases = p.cases()
            with p.chaos.scope(cfg):
                with p.service(workers=2) as svc:
                    jobs = [svc.submit([c]) for c in cases]
                    jobs.append(svc.submit(cases[:3]))
                    for j in jobs:
                        try:
                            svc.result(j, timeout=240)
                        except p.engine.ServiceError:
                            pass
                    return ([svc.poll(j) for j in jobs],
                            [svc.partial_rows(j) for j in jobs])
        (r_states, r_rows), (states, rows) = _both(run)
        assert all(s in t_engine.TERMINAL for s in states), states
        # one-case jobs: the outcome of each case is the chaos plan's
        assert states == r_states
        for got, want in zip(rows, r_rows):
            assert_rows_equal(got, want)


class TestDeterminism:
    SITES = dict(
        sweep_prepare=dict(rate=0.5, max_attempts=2),
        dram_serve=dict(rate=0.3, max_attempts=1, permanent_rate=0.3),
        worker_crash=dict(rate=0.2, permanent_rate=0.5, crash=True))

    def _run(self, p, workers, seed):
        with p.chaos.scope(p.config(seed, **self.SITES)):
            with p.service(workers=workers) as svc:
                job = svc.submit(p.cases())
                try:
                    svc.result(job, timeout=240)
                except p.engine.JobFailed:
                    pass
                return (svc.partial_rows(job), svc.info(job)["quarantined"],
                        _causes(svc, job))

    @pytest.mark.parametrize("seed", [3, 11])
    def test_rows_bit_identical_across_worker_counts(self, seed):
        rows1, q1, c1 = self._run(T, 1, seed)
        rows4, q4, c4 = self._run(T, 4, seed)
        r_rows, r_q, r_c = self._run(R, 4, seed)
        assert q1 == q4 == r_q and c1 == c4 == r_c
        assert_rows_equal(rows1, rows4)
        assert_rows_equal(rows4, r_rows)
        assert_rows_equal(rows1, [r for i, r in enumerate(T.baseline())
                                  if i not in q1])

    def test_retry_budget_must_cover_chaos_prefix(self):
        def run(p):
            cfg = p.config(0, sweep_prepare=dict(rate=0.5, max_attempts=4),
                           dram_serve=dict(rate=0.5, max_attempts=3))
            with p.chaos.scope(cfg):
                with pytest.raises(ValueError) as exc:
                    p.service(workers=1,
                              retry=p.engine.RetryPolicy(retries=6))
            return cfg.max_transient_attempts(), str(exc.value)
        (r_n, r_msg), (n, msg) = _both(run)
        assert n == r_n == 7
        assert msg.replace("repro_torch.", "repro.") == r_msg


# ---------------------------------------------------------------------------
# chaos model unit surface
# ---------------------------------------------------------------------------

class TestChaosModel:
    def test_plan_is_pure_and_prefix_shaped(self):
        def run(p):
            cfg = p.config(1, s=dict(rate=1.0, max_attempts=3))
            assert p.chaos.plan("s", "k", cfg) == p.chaos.plan("s", "k", cfg)
            return [p.chaos.plan(site, key, cfg) for site in ("s", "t")
                    for key in ("k", "k2", "karate|pr")]
        got, want = _both(run)[::-1]
        assert got == want
        kind, k = got[0]
        assert kind == "transient" and 1 <= k <= 3

    def test_maybe_inject_consumes_prefix_then_passes(self):
        def run(p):
            cfg = p.config(1, s=dict(rate=1.0, max_attempts=2))
            with p.chaos.scope(cfg):
                kind, k = p.chaos.plan("s", "k")
                for _ in range(k):
                    with pytest.raises(p.chaos.InjectedFault):
                        p.chaos.maybe_inject("s", "k")
                p.chaos.maybe_inject("s", "k")
                return k, p.chaos.injected_log()
        (r_k, r_log), (k, log) = _both(run)
        assert (k, log) == (r_k, r_log) and len(log) == k

    def test_config_from_env_grammar(self):
        def run(p):
            cfg = p.chaos.config_from_env({
                p.chaos.ENV_SEED: "9",
                p.chaos.ENV_SITES: ("sweep.prepare=0.3,dram.serve=0.2:3,"
                                    "worker.crash=0.05:1:1.0")})
            assert p.chaos.config_from_env({}) is None
            return cfg.seed, {k: vars(v) for k, v in cfg.sites.items()}
        got, want = _both(run)[::-1]
        assert got == want
        assert (T.chaos.ENV_SEED, T.chaos.ENV_SITES) == (
            R.chaos.ENV_SEED, R.chaos.ENV_SITES)
        assert got[0] == 9 and got[1]["worker.crash"]["crash"] is True

    def test_config_from_env_rejects_malformed(self):
        for raw in ("no-equals-sign", "a=1:2:3:4"):
            for p in (R, T):
                with pytest.raises(ValueError):
                    p.chaos.config_from_env({p.chaos.ENV_SITES: raw})

    def test_service_arms_chaos_from_env(self, monkeypatch):
        monkeypatch.setenv(r_chaos.ENV_SEED, "7")
        monkeypatch.setenv(r_chaos.ENV_SITES, "sweep.prepare=1.0:1")

        def run(p):
            with p.service(workers=1) as svc:
                assert p.chaos.active() is not None
                rows = svc.result(svc.submit(p.cases()[:1]), timeout=240)
            p.chaos.deactivate()
            return rows, vars(svc.service_stats)
        (r_rows, r_st), (rows, st) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert st == r_st and st["retries"] > 0

    def test_is_transient_classification(self):
        def run(p):
            c = p.chaos
            root = c.InjectedFault("s", "k", 0)
            try:
                raise p.sweep.SweepError(0, p.cases()[0], root) from root
            except p.sweep.SweepError as e:
                wrapped = e
            return [c.is_transient(x) for x in (
                c.InjectedFault("s", "k", 0, permanent=False),
                c.InjectedFault("s", "k", 0, permanent=True),
                OSError("disk hiccup"), MemoryError(),
                RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
                ValueError("bad config"), wrapped)]
        got, want = _both(run)[::-1]
        assert got == want == [True, False, True, True, True, False, True]


# ---------------------------------------------------------------------------
# the port's departure: a kernel error is never transient
# ---------------------------------------------------------------------------

class TestKernelErrorNeverTransient:
    @staticmethod
    def _wrapped(case, cause):
        """``cause`` as the sweep raises it: a chained ``SweepError``."""
        try:
            raise t_sweep.SweepError(0, case, cause) from cause
        except t_sweep.SweepError as e:
            return e

    def test_kernel_error_on_the_chain_is_not_transient(self):
        case = T.cases()[0]
        # the SweepError quotes its cause, "out of memory" included: the
        # KernelError below it decides
        oom = KernelError("dram_serve launch failed: CUDA error 2 "
                          "(out of memory)")
        assert not t_chaos.is_transient(self._wrapped(case, oom))
        assert r_chaos.is_transient(r_sweep.SweepError(0, R.cases()[0], oom))
        # the ctypes OSError of a library that does not load, wrapped
        try:
            try:
                raise OSError("cannot open shared object file")
            except OSError as e:
                raise KernelError("the kernel library did not load") from e
        except KernelError as e:
            load = e
        assert not t_chaos.is_transient(self._wrapped(case, load))
        assert t_chaos.is_transient(load.__cause__)
        # the smallest input: a SweepError whose cause is a KernelError
        assert not t_chaos.is_transient(
            self._wrapped(case, KernelError("nvcc failed")))

    def test_kernel_error_in_prepare_fails_after_one_attempt(self,
                                                             monkeypatch):
        calls = []

        def broken(self, case):
            calls.append(case)
            raise KernelError("sweep_min_rounds launch failed: CUDA error "
                              "209 (no kernel image is available)")

        monkeypatch.setattr(t_sweep.Sweeper, "_prepare_case", broken)
        with T.service(workers=1) as svc:
            job = svc.submit(T.cases()[:1])
            with pytest.raises(t_engine.JobFailed) as exc:
                svc.result(job, timeout=60)
            assert svc.poll(job) == t_engine.FAILED
            info = svc.info(job)
        assert len(calls) == 1
        assert info["quarantined"] == [0] and info["retries"] == 0
        assert svc.service_stats.retries == 0
        assert isinstance(exc.value.__cause__.__cause__, KernelError)

    def test_injected_transient_fault_still_retried(self):
        cfg = T.config(5, dram_serve=dict(rate=1.0, max_attempts=1))
        with t_chaos.scope(cfg):
            with T.service(workers=1) as svc:
                job = svc.submit(T.cases()[:1])
                rows = svc.result(job, timeout=60)
                assert svc.poll(job) == t_engine.DONE
        assert svc.service_stats.retries == 1
        assert_rows_equal(rows, R.baseline()[:1])
