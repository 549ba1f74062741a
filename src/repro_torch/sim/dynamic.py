"""Dynamic-graph simulation: update streams through the full pipeline.

:func:`run_dynamic` interleaves an
:class:`~repro_torch.graphs.updates.UpdateStream` with incremental
algorithm phases over one long-lived memory timeline:

* **epoch 0** is the static pipeline, verbatim — the algorithm run,
  model and trace emission go through the shared
  :class:`~repro_torch.sim.session.SimSession` caches, so the static
  prefix of a dynamic run is bit-identical to a plain ``simulate()`` of
  the same case;
* each **epoch e >= 1** draws the stream's seeded batch, repairs the
  labelling incrementally (``spec.incremental_run`` — the warm-started
  WCC/BFS variants of :mod:`repro_torch.algorithms.incremental`,
  bit-identical to a static recompute on the mutated graph), rebuilds
  the model on the new graph, and serves the epoch's ``ep{e}_apply``
  delta rewrite (:mod:`repro_torch.core.delta`, one ``run_phase``: the
  ``dram_timing`` kernel on the card) plus the incremental iteration
  phases (one ``run_program``: the ``dram_serve`` kernel) through the
  *same* DRAM backend — clock, bank state and on-chip residency persist
  across epochs;
* before each epoch's traffic, the on-chip lookup state is invalidated
  for exactly the line ranges the rewrite made stale
  (:func:`repro_torch.core.cache.invalidate_lines` over
  :func:`repro_torch.core.delta.stale_line_ranges`) — untouched
  partitions keep their residency.

The per-epoch :class:`EpochReport` rows carry each epoch's own
:class:`~repro_torch.core.accel.SimReport` plus update-phase counters;
the aggregate report sums the whole timeline.  Each epoch's report also
records, outside its compared fields, the wall time by stage
(``stage_seconds``) and the CUDA kernel launches (``kernel_launches``).
Everything else is a pure function of ``(graph, stream spec, case
axes)`` and equals the JAX package's ``repro.sim.run_dynamic``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.algorithms import incremental
from repro_torch.core import delta
from repro_torch.core.accel import SimReport
from repro_torch.core.trace import Trace
from repro_torch.device import resolve_device
from repro_torch.graphs.corpus import GraphLike, resolve_graph
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.updates import (UpdatesLike, apply_batch,
                                        resolve_updates)
from repro_torch.kernels import launch_counts
from repro_torch.sim.backends import make_backend
from repro_torch.sim.memory import CacheLike, MemoryLike
from repro_torch.sim.registry import get_accelerator
from repro_torch.sim.session import (SimSession, _coerce_problem,
                                     resolve_run_config)


@dataclasses.dataclass
class EpochReport:
    """One epoch of a dynamic run: its own simulation report plus the
    update-phase counters (epoch 0 is the static prefix)."""

    epoch: int
    report: SimReport
    inserted: int
    deleted: int
    touched_partitions: int
    total_partitions: int
    cache_lines_invalidated: int
    reset_vertices: int
    frontier_vertices: int
    iterations: int

    def as_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "runtime_ns": self.report.runtime_ns,
            "iterations": self.iterations,
            "edges": self.report.edges,
            "total_requests": self.report.total_requests,
            "row_hit_rate": self.report.row_hit_rate,
            "cache_hits": self.report.cache_hits,
            "inserted": self.inserted,
            "deleted": self.deleted,
            "touched_partitions": self.touched_partitions,
            "total_partitions": self.total_partitions,
            "cache_lines_invalidated": self.cache_lines_invalidated,
            "reset_vertices": self.reset_vertices,
            "frontier_vertices": self.frontier_vertices,
        }


@dataclasses.dataclass
class DynamicResult:
    """A whole dynamic run: per-epoch rows, the aggregate report over
    the full timeline, and the final labelling/graph."""

    epochs: List[EpochReport]
    report: SimReport
    final_values: np.ndarray
    final_graph: Graph
    checkpoint: Optional[np.ndarray] = None   # static recompute (verify=)

    @property
    def n_epochs(self) -> int:
        return len(self.epochs)


_COUNTERS = ("total_requests", "total_row_hits", "cache_lookups",
             "cache_hits", "prefetch_hits")


@dataclasses.dataclass
class _EpochStats:
    """Delta view of the shared backend since a mark — the stats surface
    ``model.make_report`` consumes for one epoch's report."""

    phases: list
    now: int
    total_requests: int
    total_row_hits: int
    cache_lookups: int
    cache_hits: int
    prefetch_hits: int


def _mark(mem) -> dict:
    mark = {c: getattr(mem, c, 0) for c in _COUNTERS}
    mark.update(n_phases=len(mem.phases), now=mem.now)
    return mark


def _since(mem, mark: dict) -> _EpochStats:
    return _EpochStats(
        phases=mem.phases[mark["n_phases"]:], now=mem.now - mark["now"],
        **{c: getattr(mem, c, 0) - mark[c] for c in _COUNTERS})


def _diff(after: Dict, before: Dict) -> Dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class DynamicTimeline:
    """A resident dynamic-graph scenario: one scenario point bound to
    one long-lived memory timeline, advanced one update batch at a time.

    Epoch 0 (the static prefix) runs at construction through the shared
    :class:`SimSession` caches; each :meth:`step` applies one
    :class:`~repro_torch.graphs.updates.UpdateBatch` — drawn from the
    bound stream by default — and appends its :class:`EpochReport`.
    :func:`run_dynamic` is the batch wrapper that steps a whole stream.

    When the timeline *owns* its session (``session=None``), every step
    rebinds it to the mutated graph (:meth:`SimSession.rebind` — a no-op
    for empty batches); a caller-shared session stays bound to the base
    graph.  ``graph`` is a :class:`Graph` or a corpus preset name (built
    at ``graph_scale`` / ``graph_seed``).  Everything runs on ``device``
    (default the card; raises without CUDA).
    """

    def __init__(self, graph: GraphLike, problem, *,
                 updates: UpdatesLike = None,
                 accelerator: str = "hitgraph", config=None,
                 memory: MemoryLike = None, cache: CacheLike = None,
                 backend: Optional[str] = None,
                 variant: Optional[str] = None,
                 root: int = 0, fixed_iters: Optional[int] = None,
                 graph_scale: float = 1.0, graph_seed: int = 0,
                 session: Optional[SimSession] = None, device=None,
                 **overrides):
        self.device = resolve_device(device)
        graph = resolve_graph(graph, scale=graph_scale, seed=graph_seed)
        self.problem = _coerce_problem(problem)
        self.stream = resolve_updates(updates)
        self._spec = get_accelerator(accelerator)
        self._cfg = resolve_run_config(self._spec, config, memory=memory,
                                       cache=cache, variant=variant,
                                       **overrides)
        if self.stream is not None and self.problem not in \
                incremental.INCREMENTAL_PROBLEMS:
            raise ValueError(
                f"dynamic update streams need an incremental algorithm "
                f"variant; problem {self.problem.value!r} has none "
                f"(supported: "
                f"{[p.value for p in incremental.INCREMENTAL_PROBLEMS]})")
        self._owns_session = session is None
        self._session = (SimSession(graph) if session is None
                         else session)
        self.base_graph = self._session.graph
        self._root = root
        self._fixed_iters = fixed_iters
        self._dram_cfg = self._cfg.dram_config()
        be = (backend if backend is not None
              else self._spec.preferred_backend())
        #: ONE memory timeline for all epochs: clock, bank state and
        #: on-chip residency persist across update batches
        self.mem = make_backend(be, self._dram_cfg, device=self.device)

        # ---- epoch 0: the static prefix, via the session caches ----
        launches0 = launch_counts()
        t0 = time.perf_counter()
        run0 = self._session.algorithm_run(self._spec, self.problem,
                                           self._cfg, root, fixed_iters,
                                           self.device)
        t1 = time.perf_counter()
        model = self._session.model_for(self._spec, self._cfg)
        t2 = time.perf_counter()
        report0 = model.simulate(self.problem, root=root,
                                 fixed_iters=fixed_iters, run=run0,
                                 memory_system=self.mem,
                                 device=self.device)
        report0.stage_seconds = {"algorithm": t1 - t0, "model": t2 - t1,
                                 **report0.stage_seconds}
        report0.kernel_launches = _diff(launch_counts(), launches0)
        self.epochs: List[EpochReport] = [EpochReport(
            epoch=0, report=report0, inserted=0, deleted=0,
            touched_partitions=0, total_partitions=model.p,
            cache_lines_invalidated=0, reset_vertices=0,
            frontier_vertices=0, iterations=run0.iterations)]
        self.graph = self.base_graph
        self.values = np.asarray(run0.values)
        self._model = model
        self._system = report0.system

    @property
    def epoch(self) -> int:
        return len(self.epochs) - 1

    def step(self, batch=None) -> EpochReport:
        """Advance one epoch: apply ``batch`` (default: the bound
        stream's next seeded batch), repair the labelling incrementally,
        stream the delta rewrite, and serve the repair phases — all on
        the resident timeline."""
        e = len(self.epochs)
        if self.problem not in incremental.INCREMENTAL_PROBLEMS:
            raise ValueError(
                f"problem {self.problem.value!r} has no incremental "
                "variant; the timeline cannot accept update batches")
        if batch is None and self.stream is None:
            raise ValueError("no update stream bound; pass an UpdateBatch")
        launches0 = launch_counts()
        mem_s0 = dict(self.mem.stage_seconds)
        clock = [time.perf_counter()]

        def lap() -> float:
            t, clock[0] = clock[0], time.perf_counter()
            return clock[0] - t

        if batch is None:
            batch = self.stream.batch(self.graph, e)
        g_prev, values = self.graph, self.values
        g_new = apply_batch(g_prev, batch)
        plan = incremental.plan_repair(g_prev, g_new, batch,
                                       self.problem, values, self._root)
        stages = {"plan": lap()}         # batch, mutation, repair plan
        run_e = self._spec.incremental_run(
            g_prev, g_new, batch, self.problem, values, self._cfg,
            root=self._root, plan=plan, device=self.device)
        stages["algorithm"] = lap()
        model_new = self._spec.build_model(g_new, self._cfg)
        stages["model"] = lap()
        touched = delta.structural_partitions(batch, g_prev,
                                              model_new.q, model_new.p)
        # drop exactly the stale on-chip lines (rewritten or relocated
        # regions); untouched partitions keep their residency
        invalidated = self.mem.invalidate_lines(
            delta.stale_line_ranges(self._model, model_new, touched))
        stages["invalidate"] = lap()
        mark = _mark(self.mem)
        dphase = delta.delta_phase(model_new, e, touched)
        if dphase is not None:
            name, line, wr, iss = dphase
            self.mem.run_phase(Trace(line, wr, iss), name=name)
        stages["apply"] = lap()
        program = model_new.build_program(self.problem, run_e)
        stages["trace"] = lap()
        self.mem.run_program(program)
        report_e = model_new.make_report(self.problem, run_e,
                                         _since(self.mem, mark))
        stages.update(_diff(self.mem.stage_seconds, mem_s0))
        report_e.stage_seconds = stages
        report_e.kernel_launches = _diff(launch_counts(), launches0)
        ep = EpochReport(
            epoch=e, report=report_e,
            inserted=batch.n_inserted, deleted=batch.n_deleted,
            touched_partitions=len(touched),
            total_partitions=model_new.p,
            cache_lines_invalidated=invalidated,
            reset_vertices=plan.n_reset,
            frontier_vertices=plan.n_active,
            iterations=run_e.iterations)
        self.epochs.append(ep)
        self.graph, self.values = g_new, np.asarray(run_e.values)
        self._model = model_new
        if self._owns_session:
            # resident-graph semantics: the session follows the mutation
            # (an empty batch keeps every entry and counts a skip)
            self._session.rebind(g_new, touched)
        return ep

    def aggregate_report(self) -> SimReport:
        """One report over the whole timeline so far."""
        mem = self.mem
        total_bytes = sum(ph.bytes for ph in mem.phases)
        suffix = (f"+{self.stream.name}" if self.stream is not None
                  else ("+updates" if self.epoch else ""))
        return SimReport(
            system=self._system, problem=self.problem.value,
            graph=self.base_graph.name + suffix,
            runtime_ns=mem.now / self._dram_cfg.clock_ghz,
            iterations=sum(ep.iterations for ep in self.epochs),
            edges=self.graph.m, vertices=self.base_graph.n,
            total_requests=mem.total_requests, total_bytes=total_bytes,
            row_hit_rate=(mem.total_row_hits
                          / max(mem.total_requests, 1)),
            phases=list(mem.phases),
            cache_lookups=getattr(mem, "cache_lookups", 0),
            cache_hits=getattr(mem, "cache_hits", 0),
            prefetch_hits=getattr(mem, "prefetch_hits", 0))

    def verify(self) -> np.ndarray:
        """Static recompute on the current graph; raises on divergence
        from the incrementally-maintained labelling."""
        ref = self._spec.run_algorithm(
            self.graph, self.problem, self._cfg, root=self._root,
            fixed_iters=self._fixed_iters if self.epoch == 0 else None,
            device=self.device)
        checkpoint = np.asarray(ref.values)
        if not np.array_equal(checkpoint, self.values):
            raise AssertionError(
                "incremental repair diverged from the static recompute "
                f"on {self.graph.name} ({self.problem.value})")
        return checkpoint

    def result(self, verify: bool = False) -> DynamicResult:
        return DynamicResult(
            epochs=list(self.epochs), report=self.aggregate_report(),
            final_values=self.values, final_graph=self.graph,
            checkpoint=self.verify() if verify else None)


def run_dynamic(graph: GraphLike, problem, *, updates: UpdatesLike,
                accelerator: str = "hitgraph", config=None,
                memory: MemoryLike = None, cache: CacheLike = None,
                backend: Optional[str] = None,
                variant: Optional[str] = None,
                root: int = 0, fixed_iters: Optional[int] = None,
                graph_scale: float = 1.0, graph_seed: int = 0,
                session: Optional[SimSession] = None,
                verify: bool = False, device=None,
                **overrides) -> DynamicResult:
    """Simulate ``problem`` over ``graph`` while ``updates`` mutates it
    (see module docstring), on ``device`` (default the card).
    ``updates=None`` degenerates to the static pipeline wrapped in a
    single epoch-0 row.  ``session`` shares the static-prefix caches with
    other runs on the same graph; ``verify`` recomputes the final graph
    statically and checks bit-identity.  ``graph`` is a :class:`Graph` or
    a corpus preset name, built at ``graph_scale`` / ``graph_seed``."""
    device = resolve_device(device)
    graph = resolve_graph(graph, scale=graph_scale, seed=graph_seed)
    # a shared-or-fresh session is passed through explicitly, so the
    # timeline never rebinds a caller's per-graph session
    timeline = DynamicTimeline(
        graph, problem, updates=updates, accelerator=accelerator,
        config=config, memory=memory, cache=cache, backend=backend,
        variant=variant, root=root, fixed_iters=fixed_iters,
        session=(session if session is not None
                 else SimSession(graph)),
        device=device, **overrides)
    n_epochs = timeline.stream.epochs if timeline.stream is not None \
        else 0
    for _ in range(n_epochs):
        timeline.step()
    return timeline.result(verify=verify)
