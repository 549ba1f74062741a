"""Successive-halving search driver over the sweep engine.

The fidelity knob is the one the repo already meters, caps, and charges
for: ``fixed_iters``.  A :class:`HalvingBudget` declares the rung ladder
(e.g. iterations 2 -> 8 -> 32) and the starting population; every rung
evaluates its surviving candidates as ONE batched
:class:`~repro_torch.sim.sweep.SweepCase` group, so structurally
compatible candidates ride the existing ``batch_memories`` serves (one
``dram_serve_batch`` a signature group on the card) — and, when
dispatched through a :class:`~repro_torch.serve.engine.SimService`, its
admission control charges
each rung proportionally to its iteration count (the same unclamped
cost rule long jobs pay) while retries/quarantine recover failing
candidates without the driver re-dispatching (the eval budget is spent
at dispatch, exactly once per (candidate, rung)).

Ranking between rungs is Pareto-aware: candidates sort by
non-domination layer over the canonical objective vector
(:data:`~repro_torch.tune.pareto.OBJECTIVES`), then by the vector itself,
then by design-point key — fully deterministic.  The reported front is
computed ONLY from top-rung evaluations (mixing fidelities would
compare apples to oranges) and inherits the sweep engine's
bit-identical-rows guarantee, so one seed yields one front for any
worker count — the JAX package's front for the same seed.

An optional evolutionary refinement loop mutates/crosses the top-rung
survivors for a few rounds — useful when the sampled population is
sparse in a large space; it spends from the same eval budget.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.sim.sweep import SweepCase, SweepRow, Sweeper
from repro_torch.tune import sampler as _sampler
from repro_torch.tune.pareto import (OBJECTIVES, FrontEntry, dominates,
                                     front_of_rows, objectives_of)
from repro_torch.tune.space import DesignPoint, DesignSpace


@dataclasses.dataclass(frozen=True)
class HalvingBudget:
    """Search budget semantics.

    ``rungs``           the ``fixed_iters`` fidelity ladder, ascending;
    ``initial``         candidates sampled at the lowest rung;
    ``keep``            survivor fraction per promotion (eta = 1/keep);
    ``max_case_evals``  hard cap on simulator case evaluations across
                        the whole search, refinement included.  A
                        dispatch is truncated rather than exceeded; the
                        cap counts *dispatched* cases, so service-side
                        retries never multiply the spend.
    """

    rungs: Tuple[int, ...] = (2, 8, 32)
    initial: int = 16
    keep: float = 1 / 3
    max_case_evals: Optional[int] = None

    def __post_init__(self) -> None:
        rungs = tuple(int(r) for r in self.rungs)
        object.__setattr__(self, "rungs", rungs)
        if not rungs or any(r < 1 for r in rungs):
            raise ValueError(f"rungs must be positive, got {rungs}")
        if list(rungs) != sorted(rungs):
            raise ValueError(f"rungs must ascend, got {rungs}")
        if self.initial < 1:
            raise ValueError("initial population must be >= 1")
        if not 0 < self.keep <= 1:
            raise ValueError(f"keep must be in (0, 1], got {self.keep}")

    def survivors_after(self, n: int) -> int:
        """Population promoted out of a rung of ``n`` candidates."""
        return max(1, math.ceil(n * self.keep))


@dataclasses.dataclass
class SearchStats:
    """Accounting of one :meth:`SearchDriver.search` call."""

    case_evals: int = 0          # SweepCases dispatched (the budget)
    dispatches: int = 0          # batched groups sent to the engine
    generations: int = 0         # rungs + refinement rounds run
    sampled: int = 0             # points drawn by the sampler
    evolved: int = 0             # points from mutate/crossover
    rejected_invalid: int = 0    # constraint-violating draws
    budget_truncations: int = 0  # dispatches clipped by max_case_evals
    failed_candidates: int = 0   # candidates lost to service failures
    wall_s: float = 0.0


@dataclasses.dataclass
class RungReport:
    fixed_iters: int
    evaluated: int
    survivors: int


@dataclasses.dataclass
class SearchResult:
    """Outcome of one scenario search: the Pareto front at top
    fidelity, plus the trajectory that produced it."""

    scenario: str                        # "<graph>/<problem>"
    front: List[FrontEntry]
    rungs: List[RungReport]
    stats: SearchStats
    seed: int

    def front_keys(self) -> List[str]:
        return [e.key for e in self.front]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "scenario": self.scenario, "seed": self.seed,
            "front": [e.as_dict() for e in self.front],
            "rungs": [dataclasses.asdict(r) for r in self.rungs],
            "stats": dataclasses.asdict(self.stats),
        }


def _rank(entries: List[Tuple[str, Tuple[float, ...]]]) -> List[str]:
    """Deterministic Pareto-aware ranking: non-domination layer, then
    objective vector, then key."""
    remaining = dict(entries)
    layers: Dict[str, int] = {}
    layer = 0
    while remaining:
        front = [k for k, v in remaining.items()
                 if not any(dominates(w, v)
                            for w in remaining.values())]
        if not front:            # defensive: cannot happen (finite set)
            front = list(remaining)
        for k in front:
            layers[k] = layer
            del remaining[k]
        layer += 1
    return sorted(layers,
                  key=lambda k: (layers[k], dict(entries)[k], k))


class SearchDriver:
    """Runs the halving (+ optional evolutionary) search for a space on
    one or more (graph, problem) scenarios.

    Dispatch goes through a caller-provided resident
    :class:`~repro_torch.sim.sweep.Sweeper` (shared caches across rungs),
    a :class:`~repro_torch.serve.engine.SimService` (``service=``) for
    admission-controlled, retrying, multi-tenant execution, or, when
    neither is given, a batched ``Sweeper`` of its own on ``device``
    (default the card; raises when CUDA is absent).  The sweeper or the
    service it is given decides the device.
    """

    def __init__(self, space: DesignSpace, *, seed: int = 0,
                 budget: HalvingBudget = HalvingBudget(),
                 sweeper: Optional[Sweeper] = None,
                 service=None, tenant: str = "autotune",
                 evolve_rounds: int = 0, evolve_children: int = 4,
                 result_timeout_s: float = 600.0,
                 control=None, front_cb=None, device=None):
        self.space = space
        self.seed = int(seed)
        self.budget = budget
        if service is not None and sweeper is not None:
            raise ValueError("pass either sweeper= or service=, "
                             "not both")
        if device is not None and (service is not None
                                   or sweeper is not None):
            raise ValueError("device= is for the driver's own sweeper; "
                             "the given sweeper or service decides the "
                             "device")
        self._service = service
        self._sweeper = sweeper
        if service is None and sweeper is None:
            self._sweeper = Sweeper(batch_memories=True, device=device)
        self.tenant = tenant
        self.evolve_rounds = evolve_rounds
        self.evolve_children = evolve_children
        self.result_timeout_s = result_timeout_s
        #: cooperative stop probe (same contract as the sweep engine's
        #: ``control``): returning a reason string stops the search at
        #: the next generation boundary, keeping the front so far —
        #: the service's submit_search wires cancel/deadline through it
        self._control = control
        #: streaming-front hook: called with the current top-fidelity
        #: Pareto front after every generation that adds top-rung rows
        self._front_cb = front_cb

    # ---- dispatch ----------------------------------------------------
    def _remaining(self, stats: SearchStats) -> Optional[int]:
        cap = self.budget.max_case_evals
        if cap is None:
            return None
        return max(0, cap - stats.case_evals)

    def _evaluate(self, points: Sequence[DesignPoint], graph, problem,
                  fixed_iters: int, stats: SearchStats,
                  rows_out: Dict[str, SweepRow]) -> List[DesignPoint]:
        """Evaluate ``points`` at one fidelity as a single batched case
        group; fills ``rows_out`` (point key -> row) and returns the
        points actually evaluated (the budget may truncate the tail,
        service failures may drop candidates)."""
        remaining = self._remaining(stats)
        if remaining is not None and len(points) > remaining:
            stats.budget_truncations += 1
            points = list(points)[:remaining]
        if not points:
            return []
        cases = [p.to_case(graph, problem, fixed_iters=fixed_iters,
                           **getattr(self, "_case_kw", {}))
                 for p in points]
        stats.case_evals += len(cases)
        stats.dispatches += 1
        if self._service is not None:
            rows = self._submit_service(cases)
        else:
            rows = self._sweeper.run(cases)
        evaluated = []
        for p, row in zip(points, rows):
            if row is None:
                stats.failed_candidates += 1
                continue
            rows_out[p.key] = row
            evaluated.append(p)
        return evaluated

    def _submit_service(self, cases) -> List[Optional[SweepRow]]:
        """One admission-controlled job; quarantined candidates come
        back as ``None`` (the search drops them) instead of failing the
        whole generation."""
        from repro_torch.serve.engine import ServiceError
        job = self._service.submit(cases, tenant=self.tenant)
        try:
            return self._service.result(job,
                                        timeout=self.result_timeout_s)
        except ServiceError:
            by_case = {id(r.case): r
                       for r in self._service.partial_rows(job)}
            # surviving rows keep their case object identity (cases
            # pass through the service untouched), so align by it
            return [by_case.get(id(c)) for c in cases]

    # ---- search ------------------------------------------------------
    def _stopped(self) -> Optional[str]:
        return self._control() if self._control is not None else None

    def search(self, graph, problem=None) -> SearchResult:
        """One scenario: sample, halve up the rung ladder, optionally
        refine, reduce to the top-fidelity Pareto front.

        The scenario is ``(graph, problem)`` — or a single
        :class:`~repro_torch.sim.scenario.ScenarioSpec` as the first argument,
        whose graph/ordering/updates/root axes all apply (``fixed_iters``
        is the search's own fidelity knob and is ignored; a dynamic
        ``updates`` axis scores each candidate on the whole epoch
        timeline's aggregate report)."""
        from repro_torch.sim.scenario import ScenarioSpec
        case_kw = {}
        if isinstance(graph, ScenarioSpec):
            if problem is not None:
                raise ValueError(
                    "search() got a ScenarioSpec plus a problem; put "
                    "the problem inside the spec")
            spec = graph
            graph, problem = spec.resolved_graph(), spec.problem
            case_kw = dict(root=spec.root, graph_scale=spec.graph_scale,
                           graph_seed=spec.graph_seed,
                           updates=spec.updates)
        elif problem is None:
            raise TypeError("search() needs a problem (or a "
                            "ScenarioSpec as its first argument)")
        self._case_kw = case_kw
        budget = self.budget
        stats = SearchStats()
        t0 = time.perf_counter()
        rng = _sampler.make_rng(self.seed)
        sample_stats = _sampler.SampleStats()
        seen: set = set()
        population = _sampler.sample(self.space, budget.initial, rng,
                                     seen=seen, stats=sample_stats)
        stats.sampled = len(population)
        top_iters = budget.rungs[-1]
        #: evaluations at top fidelity only — the front's input
        top_rows: Dict[str, SweepRow] = {}
        rung_reports: List[RungReport] = []

        for fixed_iters in budget.rungs:
            if self._stopped():
                break
            rows: Dict[str, SweepRow] = {}
            evaluated = self._evaluate(population, graph, problem,
                                       fixed_iters, stats, rows)
            stats.generations += 1
            if fixed_iters == top_iters:
                top_rows.update(rows)
                if self._front_cb is not None and top_rows:
                    self._front_cb(front_of_rows(top_rows))
            ranked = _rank([(p.key, objectives_of(rows[p.key]))
                            for p in evaluated])
            n_keep = (len(evaluated)
                      if fixed_iters == top_iters
                      else budget.survivors_after(len(evaluated)))
            by_key = {p.key: p for p in evaluated}
            population = [by_key[k] for k in ranked[:n_keep]]
            rung_reports.append(RungReport(
                fixed_iters=fixed_iters, evaluated=len(evaluated),
                survivors=len(population)))
            if not population:
                break

        for _ in range(self.evolve_rounds if population else 0):
            if self._stopped():
                break
            children: List[DesignPoint] = []
            parents = population
            for i in range(self.evolve_children):
                if len(parents) >= 2 and rng.integers(2):
                    a = parents[int(rng.integers(len(parents)))]
                    b = parents[int(rng.integers(len(parents)))]
                    child = (_sampler.crossover(a, b, rng, seen=seen,
                                                stats=sample_stats)
                             if a.key != b.key else None)
                else:
                    child = None
                if child is None:
                    parent = parents[int(rng.integers(len(parents)))]
                    child = _sampler.mutate(parent, rng, seen=seen,
                                            stats=sample_stats)
                if child is not None:
                    children.append(child)
            if not children:
                break
            rows: Dict[str, SweepRow] = {}
            evaluated = self._evaluate(children, graph, problem,
                                       top_iters, stats, rows)
            stats.generations += 1
            stats.evolved += len(evaluated)
            top_rows.update(rows)
            if self._front_cb is not None and top_rows:
                self._front_cb(front_of_rows(top_rows))
            # refreshed parent pool: best of everything at top fidelity
            ranked = _rank([(k, objectives_of(r))
                            for k, r in top_rows.items()])
            pool = {p.key: p for p in population + evaluated}
            population = [pool[k] for k in ranked if k in pool][
                :max(len(population), 2)]

        stats.rejected_invalid = sample_stats.rejected_invalid
        stats.wall_s = time.perf_counter() - t0
        scenario = f"{getattr(graph, 'name', graph)}/{problem}"
        return SearchResult(scenario=scenario,
                            front=front_of_rows(top_rows),
                            rungs=rung_reports, stats=stats,
                            seed=self.seed)
