"""``SimService`` — a supervised, multi-tenant resident sweep service.

One long-lived :class:`~repro_torch.sim.sweep.Sweeper` (and therefore
its per-graph sessions, algorithm runs, models and geometry-keyed pack
caches) stays warm across many submitted sweep jobs, on one ``device``
(the card unless the caller asks for the CPU).  Jobs run strictly
FIFO on a single supervised worker thread, so two overlapping clients
can never race the sweeper's stats surface and results for a given
submission order are deterministic regardless of submission timing.

The contract:

* **Job lifecycle** — per-job deadlines (``submit(deadline=...)``) and
  client-driven :meth:`SimService.cancel`, both enforced cooperatively
  at case boundaries inside the resident sweeper (a running grid stops
  at the next case, keeping its partial rows); terminal states
  ``CANCELLED`` / ``EXPIRED`` join ``DONE`` / ``FAILED``, and
  :meth:`close` fails every still-queued job instead of stranding it.
* **Retry + supervision** — transient failures (injected faults, OOM,
  interrupted calls, ``GraphStore`` I/O; see
  :func:`repro_torch.serve.chaos.is_transient`) retry with capped exponential
  backoff plus deterministic jitter; a failure that exhausts its budget
  (or is permanent) **quarantines** that case so the rest of the job
  still finishes, surfacing a structured
  :class:`~repro_torch.sim.sweep.SweepError` naming the poisoned case.  A
  worker thread killed outright
  (:class:`~repro_torch.serve.chaos.WorkerCrash` or any other
  ``BaseException``) is caught by the supervisor wrapper, which
  quarantines the killing case when it is poisonous (a transient
  injected crash only costs a requeue — its crashing prefix is finite),
  requeues the job for continuation, and spawns a replacement worker.
  A per-(graph, accelerator) circuit breaker trips after repeated
  quarantines so one bad geometry fails fast instead of starving other
  tenants.
* **Admission control** — a bounded queue with per-tenant in-flight
  quotas and cost estimates (case count x graph scale).  Over budget,
  ``submit`` sheds with a typed :class:`AdmissionError` carrying a
  retry-after hint derived from the service's observed per-case EWMA
  (:class:`~repro_torch.serve.chaos.StragglerMonitor`), or — when the client
  opts in with ``allow_degraded=True`` — admits a reduced-fidelity arm
  (vectorized backend, capped iteration count; the job is marked
  ``degraded``).

Determinism under failure: fault decisions are a pure function of the
chaos seed and the case identity (see :mod:`repro_torch.serve.chaos`), so
the same submissions with the same fault seed yield bit-identical
surviving rows for any sweep worker count.  A kernel that fails to build,
load or launch (:class:`~repro_torch.errors.KernelError`) is never
retried: its case is quarantined at once.
``tests/test_torch_service_faults.py`` holds every recovery path to the
JAX package's; ``chip_smoke.py``'s service phase drives the service on
the card, clean and under faults.

    with SimService(workers=2) as svc:                 # on the card
        job = svc.submit([SweepCase("karate", "pr")], deadline=30.0)
        rows = svc.result(job)            # blocks until done
    with SimService(device="cpu") as svc: ...          # the plain versions
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.analysis import locks
from repro_torch.serve import chaos
from repro_torch.sim.sweep import (SweepCase, SweepError, SweepInterrupted,
                             SweepRow, SweepStats, Sweeper,
                             case_chaos_key)

#: job lifecycle states: QUEUED -> RUNNING -> one terminal state (a
#: supervised continuation may bounce RUNNING -> QUEUED -> RUNNING)
QUEUED, RUNNING = "queued", "running"
DONE, FAILED, CANCELLED, EXPIRED = ("done", "failed", "cancelled",
                                    "expired")
TERMINAL = frozenset({DONE, FAILED, CANCELLED, EXPIRED})


class ServiceError(RuntimeError):
    """Base of the service's typed failures.  ``rows`` carries whatever
    surviving :class:`SweepRow` results the job produced before the
    failure (empty for admission-time errors)."""

    def __init__(self, message: str, rows: Optional[List[SweepRow]] = None):
        super().__init__(message)
        self.rows = rows if rows is not None else []


class JobFailed(ServiceError):
    """Raised by :meth:`SimService.result` for a FAILED job.  A *fresh*
    instance per call — the stored worker-side exception is chained via
    ``__cause__``, never re-raised directly (re-raising one shared
    exception object mutates its traceback across callers)."""

    def __init__(self, job_id: int, message: str,
                 rows: Optional[List[SweepRow]] = None):
        super().__init__(f"job #{job_id} failed: {message}", rows)
        self.job_id = job_id


class JobCancelled(ServiceError):
    def __init__(self, job_id: int, note: str = "",
                 rows: Optional[List[SweepRow]] = None):
        super().__init__(
            f"job #{job_id} cancelled" + (f" ({note})" if note else ""),
            rows)
        self.job_id = job_id


class JobExpired(ServiceError):
    def __init__(self, job_id: int,
                 rows: Optional[List[SweepRow]] = None):
        super().__init__(f"job #{job_id} missed its deadline", rows)
        self.job_id = job_id


class AdmissionError(ServiceError):
    """``submit`` shed this job (queue depth, tenant quota, or cost
    budget).  ``retry_after`` is the service's best-effort hint, in
    seconds, for when capacity should free up."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(f"{message} (retry after ~{retry_after:.2f}s)")
        self.retry_after = retry_after


class CircuitOpenError(ServiceError):
    """A case was failed fast because its (graph, accelerator) geometry
    tripped the circuit breaker."""

    def __init__(self, geometry: Tuple[str, str]):
        super().__init__(
            f"circuit open for geometry (graph={geometry[0][:12]}..., "
            f"accelerator={geometry[1]}) after repeated failures")
        self.geometry = geometry


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff for transient per-case failures: attempt ``k`` waits
    ``min(cap, base * 2**(k-1))`` scaled by a deterministic jitter in
    ``[1 - jitter, 1]`` (hashed from the case identity and attempt, so
    reruns of one submission back off identically)."""

    retries: int = 4                 # transient attempts per case
    backoff_base_s: float = 0.02
    backoff_cap_s: float = 1.0
    jitter: float = 0.5

    def delay(self, key: str, attempt: int) -> float:
        raw = min(self.backoff_cap_s,
                  self.backoff_base_s * 2.0 ** max(attempt - 1, 0))
        scale = 1.0 - self.jitter * chaos.uniform01("backoff", key,
                                                    attempt)
        return raw * scale


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission-control budgets.  Costs are in *case-equivalents*:
    ``(1 + edges/1e6) * fixed_iters/32`` per case (unscaled when
    ``fixed_iters`` is None) — a coarse but monotone proxy for sweep
    time.  The iteration factor is unclamped, so long fixed-iteration
    jobs are charged proportionally instead of at flat cost."""

    max_inflight_jobs: int = 256     # queued + running, all tenants
    max_tenant_jobs: int = 64        # queued + running, one tenant
    max_queued_cost: float = 1e6     # case-equivalents across the queue
    degraded_iter_cap: int = 4       # fixed_iters cap for degraded jobs
    min_retry_after_s: float = 0.05


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Per-(graph, accelerator) circuit breaker: after ``threshold``
    quarantined cases the geometry fails fast for ``cooldown_s``; the
    first case after cooldown is a half-open trial (success closes the
    breaker, failure re-trips it)."""

    threshold: int = 3
    cooldown_s: float = 30.0


@dataclasses.dataclass
class ServiceStats:
    """Cumulative service-level counters (the sweeper's cache counters
    stay on :meth:`SimService.stats`)."""

    submitted: int = 0
    done: int = 0
    failed: int = 0
    cancelled: int = 0
    expired: int = 0
    shed: int = 0                    # AdmissionError at submit
    degraded: int = 0                # jobs admitted on the degraded arm
    retries: int = 0                 # transient per-case retry attempts
    quarantined: int = 0             # cases permanently excluded
    worker_crashes: int = 0          # supervisor-replaced workers
    breaker_trips: int = 0
    breaker_fastfails: int = 0       # cases shed by an open breaker


@dataclasses.dataclass
class SimJob:
    """One submitted batch of sweep cases and its eventual outcome.

    ``rows_by_index`` accumulates surviving rows (input-case order keys);
    ``quarantined`` maps case index -> the exception that condemned it;
    ``attempts`` counts observed transient failures per case.  All three
    survive a supervised worker replacement, so a continuation resumes
    with the crash history intact.

    A *work job* (``work`` set, ``cases`` empty) runs one closure on the
    same FIFO worker instead of a case grid — the resident-graph
    open/update jobs; it shares admission accounting, deadlines,
    cancellation, and transient retries, and ``result`` returns its
    ``result_value``.
    """

    id: int
    cases: List[SweepCase]
    work: Optional[Any] = None
    result_value: Any = None
    tenant: str = "default"
    deadline: Optional[float] = None          # absolute time.monotonic()
    degraded: bool = False
    backend_override: Optional[str] = None
    estimate: float = 0.0
    status: str = QUEUED
    error: Optional[BaseException] = None
    note: str = ""
    created_s: float = 0.0
    started_s: Optional[float] = None
    finished_s: Optional[float] = None
    retries: int = 0
    attempts: Dict[int, int] = dataclasses.field(default_factory=dict)
    quarantined: Dict[int, BaseException] = dataclasses.field(
        default_factory=dict)
    rows_by_index: Dict[int, SweepRow] = dataclasses.field(
        default_factory=dict)
    _cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _finished: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def surviving_rows(self) -> List[SweepRow]:
        return [self.rows_by_index[i]
                for i in sorted(self.rows_by_index)]


def _geometry(case: SweepCase) -> Tuple[str, str]:
    return (case.graph.fingerprint, case.accelerator)


@dataclasses.dataclass
class _ResidentGraph:
    """A long-lived dynamic graph resident in the service: the
    :class:`~repro_torch.sim.dynamic.DynamicTimeline` its update jobs mutate.
    ``timeline`` is None until the epoch-0 build job runs (and again
    after :meth:`SimService.close_graph`)."""

    id: int
    tenant: str
    case: SweepCase
    timeline: Optional[Any] = None
    open_job_id: int = -1


@dataclasses.dataclass
class _SearchJob:
    """One tenant design-space search: runs on its own thread (the FIFO
    worker executes its rung jobs, so the driver must not occupy it),
    sharing the sweep jobs' lifecycle states and id space."""

    id: int
    tenant: str
    deadline: Optional[float] = None          # absolute time.monotonic()
    status: str = QUEUED
    result: Any = None
    error: Optional[BaseException] = None
    front: List[Any] = dataclasses.field(default_factory=list)
    _cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _finished: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _thread: Optional[threading.Thread] = dataclasses.field(
        default=None, repr=False)


class _CircuitBreaker:
    """Failure accounting behind :class:`BreakerConfig`; thread-safe,
    though in practice only the single worker thread mutates it."""

    def __init__(self, config: BreakerConfig, stats: ServiceStats):
        self.config = config
        self._stats = stats
        self._lock = threading.Lock()
        self._counts: Dict[Tuple[str, str], int] = {}
        self._opened_at: Dict[Tuple[str, str], float] = {}

    def allow(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            if self._counts.get(key, 0) < self.config.threshold:
                return True
            elapsed = time.monotonic() - self._opened_at[key]
            if elapsed >= self.config.cooldown_s:
                # half-open trial: let one case through; a failure
                # re-trips (record_quarantine resets the clock), a
                # success closes (record_success clears the entry)
                self._opened_at[key] = time.monotonic()
                return True
            self._stats.breaker_fastfails += 1
            return False

    def record_quarantine(self, key: Tuple[str, str]) -> None:
        with self._lock:
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            if n >= self.config.threshold:
                self._opened_at[key] = time.monotonic()
                if n == self.config.threshold:
                    self._stats.breaker_trips += 1

    def record_success(self, key: Tuple[str, str]) -> None:
        with self._lock:
            self._counts.pop(key, None)
            self._opened_at.pop(key, None)

    def is_open(self, key: Tuple[str, str]) -> bool:
        with self._lock:
            return self._counts.get(key, 0) >= self.config.threshold


class SimService:
    """Supervised FIFO job queue in front of one resident
    :class:`Sweeper`.

    Thread-safe: ``submit`` / ``poll`` / ``result`` / ``cancel`` may be
    called from any thread; execution happens on the service's single
    (supervised, replaceable) worker thread so the sweeper — and the
    launches underneath it — is never entered concurrently.  Everything
    runs on ``device`` (default the card; raises when CUDA is absent).
    ``devices=N`` shards the sweeper's batched serves over N devices, as
    on :class:`Sweeper`.
    """

    def __init__(self, backend: Optional[str] = None,
                 batch_memories: bool = False, workers: int = 1, *,
                 devices: int = 1,
                 retry: RetryPolicy = RetryPolicy(),
                 admission: AdmissionConfig = AdmissionConfig(),
                 breaker: BreakerConfig = BreakerConfig(),
                 device=None):
        self._sweeper = Sweeper(backend=backend,
                                batch_memories=batch_memories,
                                workers=workers, devices=devices,
                                device=device)
        self.retry = retry
        self.admission = admission
        self.service_stats = ServiceStats()
        self._breaker = _CircuitBreaker(breaker, self.service_stats)
        self._monitor = chaos.StragglerMonitor()
        # ordering discipline: _lock may nest the queue condition, never
        # reverse; _jobs and _tenant_jobs are guarded by _lock
        self._lock = locks.make_lock("service")
        self._jobs: Dict[int, SimJob] = \
            locks.make_dict("SimService._jobs", self._lock)
        self._tenant_jobs: Dict[str, int] = \
            locks.make_dict("SimService._tenant_jobs", self._lock)
        self._qcond = threading.Condition()
        self._queue: "deque[Optional[SimJob]]" = deque()
        self._queued_cost = 0.0
        self._inflight_jobs = 0
        self._ids = itertools.count()
        self._residents: Dict[int, _ResidentGraph] = {}
        self._searches: Dict[int, _SearchJob] = {}
        self._closed = False
        self._active_job: Optional[SimJob] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_seq = itertools.count()
        # a chaos model configured via REPRO_CHAOS_SEED/SITES arms
        # itself for service runs (CI's fault-enabled smoke path)
        if chaos.active() is None:
            env_cfg = chaos.config_from_env()
            if env_cfg is not None:
                chaos.activate(env_cfg)
        active_cfg = chaos.active()
        if (active_cfg is not None
                and retry.retries < active_cfg.max_transient_attempts()):
            raise ValueError(
                f"retry budget {retry.retries} is below the chaos "
                f"model's max transient attempts "
                f"{active_cfg.max_transient_attempts()} — surviving-row "
                "determinism across worker counts needs the budget to "
                "cover the failing prefix (see repro_torch.serve.chaos)")
        self._spawn_worker()

    # ---- client surface ----------------------------------------------
    def _estimate(self, cases: Sequence[SweepCase]) -> float:
        # Proportional in fixed_iters with NO clamp: a 500-iteration job
        # really is ~16x a 32-iteration one, and clamping at 32 used to
        # admit long jobs at flat cost — they blew straight through
        # max_queued_cost.  The degraded arm stays consistent for free:
        # it caps fixed_iters at degraded_iter_cap and re-estimates, so
        # its cost shrinks with the same proportional rule.
        cost = 0.0
        for c in cases:
            unit = 1.0 + c.graph.m / 1e6
            if c.fixed_iters is not None:
                unit *= c.fixed_iters / 32.0
            if c.updates is not None:
                # a dynamic case serves its static prefix plus one
                # (cheaper, but conservatively full-priced) phase per
                # update epoch
                unit *= 1 + c.updates.epochs
            cost += unit
        return cost

    def _retry_after(self) -> float:
        per_case = self._monitor.ewma or 0.1
        return max(self.admission.min_retry_after_s,
                   self._queued_cost * per_case)

    def submit(self, cases, *,
               tenant: str = "default",
               deadline: Optional[float] = None,
               allow_degraded: bool = False) -> int:
        """Enqueue a batch of cases; returns the job id immediately.

        ``cases`` is a sequence of :class:`SweepCase` and/or
        :class:`~repro_torch.sim.scenario.ScenarioSpec` values — or a single
        one of either (a one-case job).  Dynamic scenarios
        (``updates`` set) run their whole epoch timeline as one case.

        ``deadline`` is seconds from now: a job past its deadline stops
        at the next case boundary (state EXPIRED, partial rows kept).
        ``allow_degraded=True`` opts in to the reduced-fidelity arm when
        the cost budget would otherwise shed the job.  Raises
        :class:`AdmissionError` when over budget and
        ``RuntimeError`` after :meth:`close`.
        """
        from repro_torch.sim.scenario import ScenarioSpec
        if isinstance(cases, (ScenarioSpec, SweepCase)):
            cases = [cases]
        cases = [c.to_case() if isinstance(c, ScenarioSpec) else c
                 for c in cases]
        adm = self.admission
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            estimate = self._estimate(cases)
            if (self._inflight_jobs >= adm.max_inflight_jobs
                    or self._tenant_jobs.get(tenant, 0)
                    >= adm.max_tenant_jobs):
                self.service_stats.shed += 1
                raise AdmissionError(
                    f"job quota exceeded (service "
                    f"{self._inflight_jobs}/{adm.max_inflight_jobs}, "
                    f"tenant {tenant!r} "
                    f"{self._tenant_jobs.get(tenant, 0)}"
                    f"/{adm.max_tenant_jobs})", self._retry_after())
            degraded = False
            if self._queued_cost + estimate > adm.max_queued_cost:
                if not allow_degraded:
                    self.service_stats.shed += 1
                    raise AdmissionError(
                        f"cost budget exceeded (queued "
                        f"{self._queued_cost:.1f} + job {estimate:.1f} "
                        f"> {adm.max_queued_cost:.1f} case-equivalents; "
                        "pass allow_degraded=True to accept the "
                        "reduced-fidelity arm)", self._retry_after())
                cases = [dataclasses.replace(
                    c, fixed_iters=(adm.degraded_iter_cap
                                    if c.fixed_iters is None
                                    else min(c.fixed_iters,
                                             adm.degraded_iter_cap)))
                    for c in cases]
                estimate = self._estimate(cases)
                degraded = True
                if self._queued_cost + estimate > adm.max_queued_cost:
                    self.service_stats.shed += 1
                    raise AdmissionError(
                        "cost budget exceeded even for the degraded "
                        f"arm (queued {self._queued_cost:.1f} + "
                        f"{estimate:.1f} > {adm.max_queued_cost:.1f})",
                        self._retry_after())
                self.service_stats.degraded += 1
            now = time.monotonic()
            job = SimJob(
                id=next(self._ids), cases=cases, tenant=tenant,
                deadline=None if deadline is None else now + deadline,
                degraded=degraded,
                backend_override=("vectorized" if degraded
                                  and self._sweeper.backend == "event"
                                  else None),
                estimate=estimate, created_s=now)
            self._jobs[job.id] = job
            self._tenant_jobs[tenant] = \
                self._tenant_jobs.get(tenant, 0) + 1
            self._inflight_jobs += 1
            self._queued_cost += estimate
            self.service_stats.submitted += 1
            with self._qcond:
                self._queue.append(job)
                self._qcond.notify()
        return job.id

    def _submit_work(self, work, *, tenant: str,
                     deadline: Optional[float], estimate: float,
                     kind: str) -> int:
        """Admission-controlled enqueue of one closure job (the
        resident-graph open/update path); same quota/cost budgets,
        deadline, cancellation, and FIFO worker as case jobs."""
        adm = self.admission
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            if (self._inflight_jobs >= adm.max_inflight_jobs
                    or self._tenant_jobs.get(tenant, 0)
                    >= adm.max_tenant_jobs):
                self.service_stats.shed += 1
                raise AdmissionError(
                    f"job quota exceeded (service "
                    f"{self._inflight_jobs}/{adm.max_inflight_jobs}, "
                    f"tenant {tenant!r} "
                    f"{self._tenant_jobs.get(tenant, 0)}"
                    f"/{adm.max_tenant_jobs})", self._retry_after())
            if self._queued_cost + estimate > adm.max_queued_cost:
                self.service_stats.shed += 1
                raise AdmissionError(
                    f"cost budget exceeded (queued "
                    f"{self._queued_cost:.1f} + job {estimate:.1f} "
                    f"> {adm.max_queued_cost:.1f} case-equivalents)",
                    self._retry_after())
            now = time.monotonic()
            job = SimJob(
                id=next(self._ids), cases=[], work=work, tenant=tenant,
                deadline=None if deadline is None else now + deadline,
                estimate=estimate, created_s=now, note=kind)
            self._jobs[job.id] = job
            self._tenant_jobs[tenant] = \
                self._tenant_jobs.get(tenant, 0) + 1
            self._inflight_jobs += 1
            self._queued_cost += estimate
            self.service_stats.submitted += 1
            with self._qcond:
                self._queue.append(job)
                self._qcond.notify()
        return job.id

    # ---- resident dynamic graphs -------------------------------------
    def open_graph(self, scenario, *, tenant: str = "default",
                   deadline: Optional[float] = None) -> int:
        """Open a long-lived dynamic graph: one
        :class:`~repro_torch.sim.dynamic.DynamicTimeline` resident in the
        service, against which clients submit update batches
        (:meth:`submit_update`).  ``scenario`` is a
        :class:`~repro_torch.sim.scenario.ScenarioSpec` (its ``updates``
        stream, if any, becomes the default batch source).

        Returns the resident id immediately; the epoch-0 static build
        runs as an admission-controlled work job on the FIFO worker, so
        update jobs submitted right after queue behind it in order.
        Await it via ``result(graph_job(rid))``."""
        from repro_torch.sim.scenario import ScenarioSpec
        if not isinstance(scenario, ScenarioSpec):
            raise TypeError(
                "open_graph takes a ScenarioSpec (got "
                f"{type(scenario).__name__}); wrap the axes in one")
        case = scenario.to_case()      # axis names validate here
        from repro_torch.algorithms.incremental import INCREMENTAL_PROBLEMS
        if case.problem not in INCREMENTAL_PROBLEMS:
            raise ValueError(
                "a resident graph exists to take update batches, which "
                f"need an incremental algorithm variant; problem "
                f"{case.problem.value!r} has none (supported: "
                f"{[p.value for p in INCREMENTAL_PROBLEMS]})")
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            rid = next(self._ids)
            resident = _ResidentGraph(id=rid, tenant=tenant, case=case)
            self._residents[rid] = resident

        def build():
            from repro_torch.sim.dynamic import DynamicTimeline
            resident.timeline = DynamicTimeline(
                case.graph, case.problem, updates=case.updates,
                accelerator=case.accelerator, config=case.config,
                memory=case.memory, cache=case.cache,
                backend=self._sweeper.backend, variant=case.variant,
                root=case.root, fixed_iters=case.fixed_iters,
                device=self._sweeper.device)
            return resident.timeline.epochs[0]

        resident.open_job_id = self._submit_work(
            build, tenant=tenant, deadline=deadline,
            estimate=1.0 + case.graph.m / 1e6, kind=f"open_graph:{rid}")
        return rid

    def submit_update(self, resident_id: int, batch=None, *,
                      tenant: Optional[str] = None,
                      deadline: Optional[float] = None) -> int:
        """Apply one update batch to a resident graph: an
        admission-controlled job whose ``result`` is the epoch's
        :class:`~repro_torch.sim.dynamic.EpochReport`.  ``batch=None`` draws
        the next seeded batch from the scenario's bound stream.  Jobs
        run FIFO on the service worker, so concurrent clients' updates
        serialize deterministically in submission order."""
        resident = self._resident(resident_id)

        def step():
            if resident.timeline is None:
                raise RuntimeError(
                    f"resident graph #{resident_id} is not open "
                    "(its epoch-0 job failed or was cancelled)")
            return resident.timeline.step(batch)

        return self._submit_work(
            step, tenant=tenant or resident.tenant, deadline=deadline,
            estimate=1.0 + resident.case.graph.m / 1e6,
            kind=f"update:{resident_id}")

    def graph_job(self, resident_id: int) -> int:
        """Job id of a resident graph's epoch-0 build."""
        return self._resident(resident_id).open_job_id

    def graph_info(self, resident_id: int) -> Dict[str, Any]:
        """Observability snapshot of one resident graph."""
        r = self._resident(resident_id)
        tl = r.timeline
        return {
            "id": r.id, "tenant": r.tenant, "open": tl is not None,
            "graph": r.case.graph.name,
            "problem": r.case.problem.value,
            "accelerator": r.case.accelerator,
            "epoch": tl.epoch if tl is not None else None,
            "edges": tl.graph.m if tl is not None else r.case.graph.m,
        }

    def close_graph(self, resident_id: int) -> None:
        """Drop a resident graph (queued update jobs against it fail
        with the not-open error when they run)."""
        with self._lock:
            r = self._residents.pop(resident_id, None)
        if r is not None:
            r.timeline = None

    def _resident(self, resident_id: int) -> "_ResidentGraph":
        with self._lock:
            try:
                return self._residents[resident_id]
            except KeyError:
                raise KeyError(
                    f"unknown resident graph id {resident_id}") from None

    # ---- design-space search tenancy ---------------------------------
    def submit_search(self, space, budget=None, *, scenario=None,
                      graph=None, problem=None, tenant: str = "autotune",
                      seed: int = 0, deadline: Optional[float] = None,
                      evolve_rounds: int = 0) -> int:
        """Run a design-space search as a tenant of this service: every
        rung dispatch goes through :meth:`submit` (same admission
        costing, retries, and quarantine as any sweep job), and the
        search itself is a pollable/cancellable job — same lifecycle
        states, observed via :meth:`poll` / :meth:`cancel` /
        :meth:`search_result`, with :meth:`search_front` streaming the
        best-known Pareto front while rungs are still running.

        ``space`` is a :class:`~repro_torch.tune.space.DesignSpace`,
        ``budget`` a :class:`~repro_torch.tune.halving.HalvingBudget`
        (default ladder when ``None``); the scenario is a
        :class:`~repro_torch.sim.scenario.ScenarioSpec` (``scenario=``) or
        legacy ``graph=``/``problem=``.  ``deadline``/:meth:`cancel`
        stop the search at the next generation boundary, keeping the
        front found so far."""
        from repro_torch.tune.halving import HalvingBudget, SearchDriver
        target = scenario if scenario is not None else graph
        if target is None:
            raise TypeError("submit_search needs scenario= (or "
                            "graph= and problem=)")
        with self._lock:
            if self._closed:
                raise RuntimeError("SimService is closed")
            sid = next(self._ids)
            sj = _SearchJob(
                id=sid, tenant=tenant,
                deadline=(None if deadline is None
                          else time.monotonic() + deadline))
            self._searches[sid] = sj

        def control() -> Optional[str]:
            if sj._cancel.is_set():
                return "cancelled"
            if (sj.deadline is not None
                    and time.monotonic() >= sj.deadline):
                return "expired"
            return None

        def on_front(front):
            sj.front = list(front)

        driver = SearchDriver(
            space, seed=seed,
            budget=budget if budget is not None else HalvingBudget(),
            service=self, tenant=tenant, evolve_rounds=evolve_rounds,
            control=control, front_cb=on_front)

        def run():
            sj.status = RUNNING
            try:
                res = driver.search(target, problem)
                sj.result = res
                sj.front = list(res.front)
                reason = control()
                sj.status = (CANCELLED if reason == "cancelled"
                             else EXPIRED if reason == "expired"
                             else DONE)
            # search-thread supervisor: _finished MUST be set on any
            # exit or search_result() blocks forever
            except BaseException as e:  # repro: noqa[bare-base-exception]
                sj.error = e
                sj.status = FAILED
            finally:
                sj._finished.set()

        sj._thread = threading.Thread(
            target=run, name=f"sim-search-{sid}", daemon=True)
        sj._thread.start()
        return sid

    def search_front(self, search_id: int) -> List[Any]:
        """The streaming Pareto front of a search job: best known
        top-fidelity front so far (non-raising, any state)."""
        return list(self._search(search_id).front)

    def search_result(self, search_id: int, timeout: Optional[float]
                      = None):
        """Block until a search job finishes; returns its
        :class:`~repro_torch.tune.halving.SearchResult`.  A cancelled/expired
        search returns its partial result (the front found so far) when
        one exists, else raises the matching typed error; FAILED raises
        :class:`JobFailed`."""
        sj = self._search(search_id)
        if not sj._finished.wait(timeout):
            raise TimeoutError(
                f"search #{search_id} still {sj.status} "
                f"after {timeout}s")
        if sj.status == FAILED:
            raise JobFailed(search_id, str(sj.error)) from sj.error
        if sj.result is not None:
            return sj.result
        if sj.status == CANCELLED:
            raise JobCancelled(search_id, "search cancelled")
        raise JobExpired(search_id)

    def _search(self, search_id: int) -> "_SearchJob":
        with self._lock:
            try:
                return self._searches[search_id]
            except KeyError:
                raise KeyError(
                    f"unknown search id {search_id}") from None

    def poll(self, job_id: int) -> str:
        """Non-blocking status: queued | running | done | failed |
        cancelled | expired.  Search jobs share the same states."""
        with self._lock:
            sj = self._searches.get(job_id)
        if sj is not None:
            return sj.status
        return self._job(job_id).status

    def cancel(self, job_id: int) -> bool:
        """Cancel a job: a queued job finishes CANCELLED immediately; a
        running one stops cooperatively at its next case boundary,
        keeping the rows completed so far.  Returns False if the job had
        already reached a terminal state.  A search job stops at its
        next generation boundary, keeping the front found so far."""
        with self._lock:
            sj = self._searches.get(job_id)
        if sj is not None:
            if sj.status in TERMINAL:
                return False
            sj._cancel.set()
            return True
        job = self._job(job_id)
        with self._lock:
            if job.status in TERMINAL:
                return False
            removed = False
            with self._qcond:
                try:
                    self._queue.remove(job)
                    removed = True
                except ValueError:
                    pass             # dequeued already: it is running
            job._cancel.set()
            if removed:
                self._finish_locked(job, CANCELLED,
                                    note="cancelled while queued")
            return True

    def result(self, job_id: int,
               timeout: Optional[float] = None) -> List[SweepRow]:
        """Block until the job reaches a terminal state.  DONE returns
        the rows; FAILED raises a fresh :class:`JobFailed` chained to
        the stored cause; CANCELLED / EXPIRED raise their typed errors.
        All three carry the surviving partial rows on ``.rows``."""
        job = self._job(job_id)
        if not job._finished.wait(timeout):
            raise TimeoutError(
                f"job #{job_id} still {job.status} after {timeout}s")
        rows = job.surviving_rows()
        if job.status == DONE:
            return job.result_value if job.work is not None else rows
        if job.status == FAILED:
            raise JobFailed(job_id, str(job.error), rows) from job.error
        if job.status == CANCELLED:
            raise JobCancelled(job_id, job.note, rows)
        raise JobExpired(job_id, rows)

    def partial_rows(self, job_id: int) -> List[SweepRow]:
        """Surviving rows of any job, whatever its state (the
        non-raising accessor for FAILED/CANCELLED/EXPIRED jobs)."""
        return self._job(job_id).surviving_rows()

    def info(self, job_id: int) -> Dict[str, Any]:
        """Observability snapshot of one job."""
        job = self._job(job_id)
        return {
            "id": job.id, "tenant": job.tenant, "status": job.status,
            "cases": len(job.cases),
            "rows_done": len(job.rows_by_index),
            "quarantined": sorted(job.quarantined),
            "retries": job.retries, "degraded": job.degraded,
            "estimate": job.estimate,
            "deadline": job.deadline, "note": job.note,
        }

    def load(self) -> Dict[str, Any]:
        """Service-level load snapshot (what admission control sees)."""
        with self._lock:
            return {
                "inflight_jobs": self._inflight_jobs,
                "queued_cost": self._queued_cost,
                "tenants": dict(self._tenant_jobs),
                "ewma_case_s": self._monitor.ewma,
                "retry_after_hint": self._retry_after(),
            }

    def stats(self) -> SweepStats:
        """Cumulative cache/worker stats of the resident sweeper."""
        return self._sweeper.stats

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the service (idempotent): every still-queued job
        finishes CANCELLED (so ``result`` raises instead of blocking
        forever), the in-flight job is cancelled cooperatively, and the
        worker is joined."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            with self._qcond:
                drained = [j for j in self._queue if j is not None]
                self._queue.clear()
                self._queue.append(None)   # wake + stop sentinel
                self._qcond.notify_all()
            for job in drained:
                job._cancel.set()
                self._finish_locked(job, CANCELLED,
                                    note="service closed")
            if self._active_job is not None:
                self._active_job._cancel.set()
            searches = list(self._searches.values())
            self._residents.clear()
        for sj in searches:
            sj._cancel.set()
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        for sj in searches:
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            sj._finished.wait(remaining)
        while True:
            worker = self._worker
            if worker is None or not worker.is_alive():
                return
            remaining = (None if deadline is None
                         else max(0.0, deadline - time.monotonic()))
            worker.join(remaining)
            if remaining is not None and remaining <= 0:
                return
            # a supervised replacement may have taken over mid-join;
            # loop to join the current worker
            if worker is self._worker and not worker.is_alive():
                return

    def __enter__(self) -> "SimService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- worker + supervisor -----------------------------------------
    def _job(self, job_id: int) -> SimJob:
        with self._lock:
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"unknown job id {job_id}") from None

    def _spawn_worker(self) -> None:
        self._worker = threading.Thread(
            target=self._worker_main,
            name=f"sim-service-{next(self._worker_seq)}", daemon=True)
        self._worker.start()

    def _worker_main(self) -> None:
        try:
            self._run_loop()
        # The supervisor: a BaseException here means the worker thread is
        # dying (injected WorkerCrash or a genuine interpreter-level
        # failure), and the whole point is to replace it instead of
        # silently losing the service.
        except BaseException as e:  # repro: noqa[bare-base-exception]
            self._supervise_crash(e)

    def _run_loop(self) -> None:
        while True:
            with self._qcond:
                while not self._queue:
                    self._qcond.wait()
                job = self._queue.popleft()
            if job is None:
                return
            with self._lock:
                self._active_job = job
            # No ``finally`` here: on an escaping BaseException the job
            # must STAY in ``_active_job`` so the supervisor can
            # attribute the crash and requeue the job.
            self._execute(job)
            with self._lock:
                self._active_job = None

    def _supervise_crash(self, exc: BaseException) -> None:
        """Supervisor: the worker thread died.  Attribute the crash,
        quarantine the killing case when it is poisonous (a permanent
        injected crash — a transient one only costs a requeue, its
        crashing prefix is finite), requeue the job for continuation,
        and spawn a replacement worker (unless the service is closed,
        in which case the job finishes CANCELLED like any other queued
        work)."""
        with self._lock:
            job = self._active_job
            self._active_job = None
            self.service_stats.worker_crashes += 1
            closed = self._closed
            if job is not None:
                if isinstance(exc, chaos.WorkerCrash):
                    idx = (self._index_for_key(job, exc.key)
                           if exc.permanent else None)
                    if idx is not None:
                        job.quarantined[idx] = exc
                        self.service_stats.quarantined += 1
                        self._breaker.record_quarantine(
                            _geometry(job.cases[idx]))
                    if closed:
                        self._finish_locked(job, CANCELLED,
                                            note="service closed")
                    else:
                        # continuation: front of the queue, so FIFO
                        # order for everyone else is preserved
                        job.status = QUEUED
                        with self._qcond:
                            self._queue.appendleft(job)
                            self._qcond.notify()
                else:
                    job.error = exc
                    self._finish_locked(job, FAILED,
                                        note="worker crashed")
            if not closed:
                self._spawn_worker()

    @staticmethod
    def _index_for_key(job: SimJob, key: str) -> Optional[int]:
        for i, c in enumerate(job.cases):
            if i in job.quarantined or i in job.rows_by_index:
                continue
            if case_chaos_key(c) == key:
                return i
        return None

    def _control_for(self, job: SimJob):
        def probe() -> Optional[str]:
            if job._cancel.is_set():
                return "cancelled"
            if (job.deadline is not None
                    and time.monotonic() >= job.deadline):
                return "expired"
            return None
        return probe

    def _execute(self, job: SimJob) -> None:
        """Run one job to a terminal state (modulo worker crashes, which
        escape to the supervisor).  The retry loop re-runs the job's
        non-quarantined cases — the resident caches make repeats of the
        already-successful ones cheap replays, and re-running the whole
        remainder keeps row production in deterministic case order."""
        control = self._control_for(job)
        reason = control()
        if reason:
            self._finish(job,
                         CANCELLED if reason == "cancelled" else EXPIRED)
            return
        with self._lock:
            job.status = RUNNING
            if job.started_s is None:
                job.started_s = time.monotonic()
        if job.work is not None:
            self._execute_work(job, control)
            return
        while True:
            active: List[Tuple[int, SweepCase]] = []
            for i, c in enumerate(job.cases):
                if i in job.quarantined:
                    continue
                geom = _geometry(c)
                if not self._breaker.allow(geom):
                    job.quarantined[i] = CircuitOpenError(geom)
                    with self._lock:
                        self.service_stats.quarantined += 1
                    continue
                active.append((i, c))
            if not active:
                break
            t0 = time.perf_counter()
            try:
                rows = self._sweeper.run(
                    [c for _, c in active], control=control,
                    backend=job.backend_override)
            except SweepInterrupted as e:
                for (gi, _), row in zip(active, e.rows):
                    if row is not None:
                        job.rows_by_index[gi] = row
                self._finish(job, CANCELLED if e.reason == "cancelled"
                             else EXPIRED)
                return
            except SweepError as e:
                gi, case = active[e.index]
                job.attempts[gi] = job.attempts.get(gi, 0) + 1
                if (chaos.is_transient(e)
                        and job.attempts[gi] <= self.retry.retries):
                    job.retries += 1
                    with self._lock:
                        self.service_stats.retries += 1
                    delay = self.retry.delay(case_chaos_key(case),
                                             job.attempts[gi])
                    job._cancel.wait(delay)   # interruptible backoff
                    continue
                job.quarantined[gi] = e
                self._breaker.record_quarantine(_geometry(case))
                with self._lock:
                    self.service_stats.quarantined += 1
                continue
            wall = time.perf_counter() - t0
            for (gi, _), row in zip(active, rows):
                job.rows_by_index[gi] = row
            for geom in dict.fromkeys(_geometry(c) for _, c in active):
                self._breaker.record_success(geom)
            self._monitor.observe(job.id, wall / max(1, len(active)))
            break
        if job.quarantined:
            job.error = job.quarantined[min(job.quarantined)]
            self._finish(job, FAILED)
        else:
            self._finish(job, DONE)

    def _execute_work(self, job: SimJob, control) -> None:
        """Run one closure job with the same transient-retry contract
        as a case grid (no quarantine arm — a single closure either
        eventually succeeds or fails the job)."""
        attempt = 0
        while True:
            reason = control()
            if reason:
                self._finish(job, CANCELLED if reason == "cancelled"
                             else EXPIRED)
                return
            t0 = time.perf_counter()
            try:
                job.result_value = job.work()
            except Exception as e:
                attempt += 1
                if chaos.is_transient(e) and attempt <= self.retry.retries:
                    job.retries += 1
                    with self._lock:
                        self.service_stats.retries += 1
                    job._cancel.wait(
                        self.retry.delay(f"work:{job.id}", attempt))
                    continue
                job.error = e
                self._finish(job, FAILED)
                return
            self._monitor.observe(job.id, time.perf_counter() - t0)
            self._finish(job, DONE)
            return

    def _finish(self, job: SimJob, status: str, note: str = "") -> None:
        with self._lock:
            self._finish_locked(job, status, note)

    def _finish_locked(self, job: SimJob, status: str,
                       note: str = "") -> None:
        """Terminal-state bookkeeping; caller holds ``_lock``."""
        if job.status in TERMINAL:
            return
        job.status = status
        job.note = note or job.note
        job.finished_s = time.monotonic()
        self._inflight_jobs -= 1
        self._queued_cost = max(0.0, self._queued_cost - job.estimate)
        left = self._tenant_jobs.get(job.tenant, 1) - 1
        if left <= 0:
            self._tenant_jobs.pop(job.tenant, None)
        else:
            self._tenant_jobs[job.tenant] = left
        s = self.service_stats
        if status == DONE:
            s.done += 1
        elif status == FAILED:
            s.failed += 1
        elif status == CANCELLED:
            s.cancelled += 1
        elif status == EXPIRED:
            s.expired += 1
        job._finished.set()
