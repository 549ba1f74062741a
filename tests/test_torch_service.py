"""The port's simulation service (``repro_torch.serve.engine``) against the
JAX package's (``repro.serve.engine``), on the CPU.

The 22 tests of ``tests/test_service.py``, each run through both packages
with the same submissions, the port's service with ``device="cpu"``: the
job state machine, cancel / close edges, concurrent clients, admission
control.  What is compared:

* exactly: every surviving row (``as_dict`` minus ``wall_s``, every
  ``SimReport`` field and phase), each job's terminal state, its
  ``info`` (minus the absolute deadline), the quarantined indices and the
  types of their causes, ``ServiceStats`` where the JAX test pins it, and
  the admission estimates and shed messages (minus the retry-after hint,
  which reads a wall-clock EWMA);
* where a result depends on scheduling (a job cancelled mid-flight), each
  row the port kept equals the JAX package's row for the same case.

The rows carry no float ``values``, so no tolerance is needed here: the
rtol 1e-5 of ``test_torch_sweep_engine.py`` would apply to them.  Graphs
come from the corpus with the disk store off (``REPRO_GRAPH_CACHE=0``), so
neither package reads a graph the other built.
"""

import importlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from repro.serve import engine as r_engine

from repro_torch import interop
from repro_torch.serve import engine as t_engine

# the modules, not the ``sweep`` functions their packages export
r_sweep = importlib.import_module("repro.sim.sweep")
t_sweep = importlib.import_module("repro_torch.sim.sweep")


class Pkg:
    """One package's service surface; ``kw`` goes to every constructor
    that takes a device (the port's: ``device="cpu"``)."""

    def __init__(self, engine, sweep, **kw):
        self.engine, self.sweep, self.kw = engine, sweep, kw
        self.FAST_RETRY = engine.RetryPolicy(retries=2, backoff_base_s=0.001,
                                             backoff_cap_s=0.01)

    def service(self, **kw):
        kw.setdefault("retry", self.FAST_RETRY)
        return self.engine.SimService(**kw, **self.kw)

    def case(self, *args, **kw):
        return self.sweep.SweepCase(*args, **kw)

    def cases(self):
        """``CASES`` of tests/test_service.py."""
        return [self.case("karate", "pr"), self.case("karate", "bfs"),
                self.case("karate", "sssp")]

    def poisoned(self, problem):
        """A case that passes construction-time validation but fails in
        the worker (its accelerator forged after construction)."""
        case = self.case("karate", problem)
        object.__setattr__(case, "accelerator", "no-such-accel")
        return case

    def sweeper(self, **kw):
        return self.sweep.Sweeper(**kw, **self.kw)


R = Pkg(r_engine, r_sweep)
T = Pkg(t_engine, t_sweep, device="cpu")


@pytest.fixture(autouse=True)
def _no_disk_store(monkeypatch):
    monkeypatch.setenv("REPRO_GRAPH_CACHE", "0")


def _row(row):
    d = row.as_dict()
    d.pop("wall_s")
    return d


def assert_rows_equal(rows, r_rows):
    assert [_row(r) for r in rows] == [_row(r) for r in r_rows]
    assert [r.report for r in rows] == [interop.sim_report(r.report)
                                        for r in r_rows]


def _info(svc, job):
    info = svc.info(job)
    info.pop("deadline")
    return info


def _shed_text(exc):
    return str(exc).split(" (retry after")[0]


def _both(fn):
    """``fn(pkg)`` through the JAX package, then through the port."""
    return fn(R), fn(T)


# ---------------------------------------------------------------------------
# lifecycle state machine
# ---------------------------------------------------------------------------

class TestLifecycle:
    def test_submit_runs_to_done(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit(p.cases())
                rows = svc.result(job, timeout=120)
                assert svc.poll(job) == p.engine.DONE
                return rows, _info(svc, job), svc.service_stats
        (r_rows, r_info, r_stats), (rows, info, stats) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert info == r_info and info["quarantined"] == []
        assert vars(stats) == vars(r_stats) and stats.done == 1

    def test_states_are_disjoint_and_terminal_is_terminal(self):
        for name in ("QUEUED", "RUNNING", "DONE", "FAILED", "CANCELLED",
                     "EXPIRED"):
            assert getattr(t_engine, name) == getattr(r_engine, name)
        assert t_engine.TERMINAL == r_engine.TERMINAL

        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit([p.case("karate", "pr")])
                rows = svc.result(job, timeout=120)
                return rows, svc.cancel(job), svc.poll(job)
        (r_rows, r_cancel, r_state), (rows, cancel, state) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (cancel, state) == (r_cancel, r_state) == (False, "done")

    def test_failed_job_raises_fresh_jobfailed_with_cause(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit([p.poisoned("pr")])
                with pytest.raises(p.engine.JobFailed) as e1:
                    svc.result(job, timeout=120)
                with pytest.raises(p.engine.JobFailed) as e2:
                    svc.result(job, timeout=5)
                assert e1.value is not e2.value
                assert e1.value.__cause__ is e2.value.__cause__
                cause = e1.value.__cause__
                return (svc.poll(job), type(cause).__name__,
                        type(cause.__cause__).__name__, cause.index,
                        _info(svc, job))
        got, want = _both(run)[::-1]
        assert got == want
        assert got[:3] == ("failed", "SweepError", "UnknownPresetError")

    def test_partial_failure_keeps_surviving_rows(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit([p.case("karate", "pr"), p.poisoned("pr"),
                                  p.case("karate", "bfs")])
                with pytest.raises(p.engine.JobFailed) as exc:
                    svc.result(job, timeout=120)
                assert svc.partial_rows(job) == exc.value.rows
                return exc.value.rows, _info(svc, job)
        (r_rows, r_info), (rows, info) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert [r.case.problem.value for r in rows] == ["pr", "bfs"]
        assert info == r_info and info["quarantined"] == [1]

    def test_deadline_expires_job(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit(p.cases(), deadline=0.0)
                with pytest.raises(p.engine.JobExpired) as exc:
                    svc.result(job, timeout=120)
                return (svc.poll(job), len(exc.value.rows),
                        vars(svc.service_stats))
        got, want = _both(run)[::-1]
        assert got == want
        assert got[0] == "expired" and got[2]["expired"] == 1

    def test_result_timeout_raises_timeouterror(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit([p.case("karate", "pr")
                                  for _ in range(8)])
                with pytest.raises(TimeoutError):
                    svc.result(job, timeout=0.0)
                return svc.result(job, timeout=120)
        r_rows, rows = _both(run)
        assert len(rows) == 8
        assert_rows_equal(rows, r_rows)

    def test_unknown_job_id(self):
        def run(p):
            with p.service(workers=2) as svc:
                with pytest.raises(KeyError) as exc:
                    svc.poll(12345)
                return str(exc.value)
        r_msg, msg = _both(run)
        assert msg == r_msg


# ---------------------------------------------------------------------------
# cancel / close edges
# ---------------------------------------------------------------------------

class TestCancelClose:
    def test_cancel_queued_job_is_immediate(self):
        def run(p):
            with p.service(workers=1) as svc:
                hog = svc.submit([p.case("karate", "pr") for _ in range(4)])
                victim = svc.submit([p.case("karate", "bfs")])
                assert svc.cancel(victim) is True
                state = svc.poll(victim)
                with pytest.raises(p.engine.JobCancelled) as exc:
                    svc.result(victim, timeout=5)
                return (state, str(exc.value), exc.value.rows,
                        svc.result(hog, timeout=120))
        (r_state, r_msg, r_vrows, r_rows), (state, msg, vrows, rows) = \
            _both(run)
        assert (state, msg, vrows) == (r_state, r_msg, r_vrows)
        assert state == "cancelled" and vrows == []
        assert len(rows) == 4
        assert_rows_equal(rows, r_rows)

    def test_cancel_running_job_keeps_partial_rows(self):
        def run(p):
            with p.service(workers=1) as svc:
                job = svc.submit([p.case("karate", "pr") for _ in range(6)])
                while svc.poll(job) == p.engine.QUEUED:
                    time.sleep(0.001)
                svc.cancel(job)
                with pytest.raises(p.engine.JobCancelled) as exc:
                    svc.result(job, timeout=120)
                return svc.poll(job), exc.value.rows
        (r_state, r_rows), (state, rows) = _both(run)
        assert state == r_state == "cancelled"
        # how far each got depends on scheduling: every row the port kept
        # equals the JAX package's row of the same (identical) case
        assert len(rows) < 6
        want = R.sweeper().run([R.case("karate", "pr")])
        assert_rows_equal(rows, want * len(rows))

    def test_close_fails_queued_jobs_instead_of_stranding(self):
        def run(p):
            svc = p.service(workers=1)
            jobs = [svc.submit([p.case("karate", "pr")]) for _ in range(5)]
            svc.close(timeout=120)
            states = [svc.poll(j) for j in jobs]
            assert all(s in p.engine.TERMINAL for s in states)
            cancelled, rows = 0, []
            for j in jobs:
                try:
                    rows += svc.result(j, timeout=1)
                except p.engine.JobCancelled:
                    cancelled += 1
            return cancelled, rows
        (r_cancelled, r_rows), (cancelled, rows) = _both(run)
        # the still-queued tail is cancelled (its length is scheduling)
        assert cancelled >= 1 and r_cancelled >= 1
        want = R.sweeper().run([R.case("karate", "pr")])
        assert_rows_equal(rows, want * len(rows))

    def test_submit_after_close_raises(self):
        def run(p):
            svc = p.service(workers=1)
            svc.close()
            with pytest.raises(RuntimeError) as exc:
                svc.submit([p.case("karate", "pr")])
            return str(exc.value)
        r_msg, msg = _both(run)
        assert msg == r_msg == "SimService is closed"

    def test_close_is_idempotent_and_context_manager(self):
        def run(p):
            svc = p.service(workers=1)
            svc.close()
            svc.close()
            with p.service(workers=1) as s2:
                return s2.result(s2.submit([p.case("karate", "pr")]),
                                 timeout=120)
        r_rows, rows = _both(run)
        assert len(rows) == 1
        assert_rows_equal(rows, r_rows)


# ---------------------------------------------------------------------------
# concurrency + determinism
# ---------------------------------------------------------------------------

class TestConcurrency:
    def test_concurrent_submit_poll_result(self):
        def run(p):
            cases = p.cases()
            with p.service(workers=2) as svc:
                def client(i):
                    job = svc.submit([cases[i % len(cases)]])
                    while svc.poll(job) not in p.engine.TERMINAL:
                        time.sleep(0.001)
                    return svc.result(job, timeout=120)[0]

                with ThreadPoolExecutor(max_workers=8) as pool:
                    rows = list(pool.map(client, range(16)))
                return rows, vars(svc.service_stats)
        (r_rows, r_stats), (rows, stats) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert stats == r_stats and stats["done"] == 16

    def test_results_bit_identical_to_direct_sweeper(self):
        def run(p):
            with p.service(workers=2) as svc:
                got = svc.result(svc.submit(p.cases()), timeout=120)
            return got, p.sweeper(workers=1).run(p.cases())
        (r_got, r_want), (got, want) = _both(run)
        assert_rows_equal(got, want)
        assert_rows_equal(got, r_got)
        assert_rows_equal(want, r_want)

    def test_many_threads_share_one_terminal_event(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit(p.cases())
                out, lock = [], threading.Lock()

                def wait():
                    rows = svc.result(job, timeout=120)
                    with lock:
                        out.append(rows)

                threads = [threading.Thread(target=wait) for _ in range(6)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=120)
                    assert not t.is_alive()
                return out
        r_out, out = _both(run)
        assert len(out) == len(r_out) == 6
        for rows in out:
            assert_rows_equal(rows, r_out[0])


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

class TestAdmission:
    def test_tenant_quota_sheds_with_retry_after(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_tenant_jobs=1)
            with p.service(workers=1, admission=adm) as svc:
                first = svc.submit([p.case("karate", "pr")
                                    for _ in range(3)], tenant="t")
                with pytest.raises(p.engine.AdmissionError) as exc:
                    svc.submit([p.case("karate", "pr")], tenant="t")
                assert exc.value.retry_after > 0
                other = svc.submit([p.case("karate", "bfs")],
                                   tenant="other")
                rows = svc.result(first, timeout=120)
                rows += svc.result(other, timeout=120)
                shed = svc.service_stats.shed
                rows += svc.result(svc.submit([p.case("karate", "pr")],
                                              tenant="t"), timeout=120)
                return rows, shed, _shed_text(exc.value)
        (r_rows, r_shed, r_msg), (rows, shed, msg) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (shed, msg) == (r_shed, r_msg) and shed == 1

    def test_global_quota_sheds(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_inflight_jobs=1)
            with p.service(workers=1, admission=adm) as svc:
                job = svc.submit([p.case("karate", "pr") for _ in range(3)])
                with pytest.raises(p.engine.AdmissionError) as exc:
                    svc.submit([p.case("karate", "pr")], tenant="b")
                return _shed_text(exc.value), svc.result(job, timeout=120)
        (r_msg, r_rows), (msg, rows) = _both(run)
        assert msg == r_msg
        assert_rows_equal(rows, r_rows)

    def test_cost_budget_sheds_without_opt_in(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_queued_cost=0.5)
            with p.service(workers=1, admission=adm) as svc:
                with pytest.raises(p.engine.AdmissionError) as exc:
                    svc.submit([p.case("karate", "pr")])
                return _shed_text(exc.value), vars(svc.service_stats)
        got, want = _both(run)[::-1]
        assert got == want
        assert "allow_degraded" in got[0]

    def test_degraded_arm_caps_iterations(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_queued_cost=0.5,
                                           degraded_iter_cap=3)
            with p.service(workers=1, admission=adm) as svc:
                job = svc.submit([p.case("karate", "pr")],
                                 allow_degraded=True)
                rows = svc.result(job, timeout=120)
                return rows, _info(svc, job), vars(svc.service_stats)
        (r_rows, r_info, r_stats), (rows, info, stats) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (info, stats) == (r_info, r_stats)
        assert info["degraded"] is True and stats["degraded"] == 1
        assert rows[0].case.fixed_iters == 3
        assert rows[0].report.iterations <= 3

    def test_cost_scales_with_iterations_unclamped(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_queued_cost=2.0)
            with p.service(workers=1, admission=adm) as svc:
                ok = svc.submit([p.case("karate", "pr", fixed_iters=32)])
                rows = svc.result(ok, timeout=120)
                with pytest.raises(p.engine.AdmissionError) as exc:
                    svc.submit([p.case("karate", "pr", fixed_iters=500)])
                return rows, _shed_text(exc.value), svc.service_stats.shed
        (r_rows, r_msg, r_shed), (rows, msg, shed) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (msg, shed) == (r_msg, r_shed) and shed == 1
        assert "cost budget exceeded" in msg

    def test_degraded_arm_reprices_with_proportional_rule(self):
        def run(p):
            adm = p.engine.AdmissionConfig(max_queued_cost=2.0,
                                           degraded_iter_cap=4)
            with p.service(workers=1, admission=adm) as svc:
                job = svc.submit([p.case("karate", "pr", fixed_iters=500)],
                                 allow_degraded=True)
                rows = svc.result(job, timeout=120)
                return rows, _info(svc, job), svc._jobs[job].estimate
        (r_rows, r_info, r_est), (rows, info, est) = _both(run)
        assert_rows_equal(rows, r_rows)
        assert (info, est) == (r_info, r_est)
        assert info["degraded"] is True and est < 0.5
        assert rows[0].case.fixed_iters == 4

    def test_load_snapshot_shape(self):
        def run(p):
            with p.service(workers=2) as svc:
                job = svc.submit([p.case("karate", "pr")])
                load = svc.load()
                assert load["retry_after_hint"] > 0
                rows = svc.result(job, timeout=120)
                return sorted(load), svc.load()["inflight_jobs"], rows
        (r_keys, r_left, r_rows), (keys, left, rows) = _both(run)
        assert keys == r_keys == sorted(
            {"inflight_jobs", "queued_cost", "tenants", "ewma_case_s",
             "retry_after_hint"})
        assert left == r_left == 0
        assert_rows_equal(rows, r_rows)
