"""Batched sweep engine: one call, a grid of simulations, shared work
deduplicated.

``sweep()`` expands a (graph x problem x accelerator x memory x cache x
variant x updates) grid, or takes an explicit case list, and returns one
:class:`SweepRow` per grid point, in grid order.  It runs on the card
unless ``device`` says otherwise.

What is shared and what is not:

* **Algorithm runs** (the engine executions that produce per-iteration
  statistics) are deduplicated across all grid points whose
  ``algorithm_key`` matches: every memory and every variant that does not
  change the execution reuses one run per (graph, problem).
* **Models and packed programs** are cached by DRAM *geometry + clock*
  (``DRAMConfig.geometry_key``): neither the trace a model emits nor the
  packed lockstep streams depend on timing parameters, so a timing grid
  (``memory.timing_variants``) packs each (graph, accelerator) point once
  and serves it against every timing vector.
  ``SweepStats.pack_cache_hits`` / ``pack_cache_misses`` count the reuse.
* **Preparation is sharded**: ``workers=N`` threads prepare cases
  (algorithm run, trace build, pack) while the serving loop serves them
  in deterministic case order, so rows are identical for any worker
  count.  With ``batch_memories=True``, cases whose packed programs share
  a shape are served together by one batched serve
  (``dram_serve_batch``: one CTA a case on the card).

Graphs are :class:`Graph` values or corpus preset names, resolved when a
case is built; cases may be :class:`~repro_torch.sim.scenario.ScenarioSpec`
values.  ``devices=N`` shards each batched serve's cases over a 1-D case
mesh of N devices (:func:`repro_torch.launch.mesh.make_sweep_mesh`), with
rows bit-identical for any (workers, devices).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import spans
from repro_torch.algorithms.common import Problem
from repro_torch.analysis import locks
from repro_torch.core import vectorized as vec
from repro_torch.core.accel import (ProgramStats, SimReport, finalize_any,
                                    serve_finishes)
from repro_torch.device import resolve_device
from repro_torch.graphs.corpus import GraphLike, resolve_graph
from repro_torch.graphs.formats import Graph
from repro_torch.graphs.updates import (UpdatesLike, resolve_updates,
                                        updates_name)
from repro_torch.serve import chaos
from repro_torch.sim.memory import (CacheLike, MemoryLike, cache_name,
                                    memory_name, resolve_cache,
                                    resolve_memory)
from repro_torch.sim.policy import resolve_partitioned_config
from repro_torch.sim.registry import get_accelerator
from repro_torch.sim.scenario import ScenarioSpec
from repro_torch.sim.session import SimSession, _coerce_problem


@dataclasses.dataclass(frozen=True)
class SweepCase:
    """One grid point of a sweep.

    ``graph`` is a :class:`Graph` or a corpus preset name (resolved here,
    at ``graph_scale`` / ``graph_seed``, through the memoized corpus
    cache, so every case naming one scenario shares one graph object and
    one session).  ``config`` may carry a
    :class:`~repro_torch.sim.policy.PartitionPolicy` in its
    ``partition_elements`` field; it resolves against the graph here, so
    every downstream consumer sees a concrete config.

    Every string axis validates at construction: an unknown accelerator,
    memory, cache, variant or updates preset raises
    :class:`~repro_torch.errors.UnknownPresetError` naming the axis and
    the nearest valid name, instead of surfacing later from a worker
    thread.  A non-``None`` ``updates`` (an ``UPDATE_PRESETS`` name or an
    ``UpdateStream``) makes the case dynamic: it runs
    :func:`repro_torch.sim.dynamic.run_dynamic` and yields one aggregate
    row with the per-epoch reports attached (:attr:`SweepRow.epochs`)."""

    graph: GraphLike
    problem: Problem
    accelerator: str = "hitgraph"
    memory: MemoryLike = None
    cache: CacheLike = None
    variant: Optional[str] = None
    config: Any = None
    root: int = 0
    fixed_iters: Optional[int] = None
    graph_scale: float = 1.0
    graph_seed: int = 0
    updates: UpdatesLike = None

    def __post_init__(self):
        object.__setattr__(self, "problem", _coerce_problem(self.problem))
        object.__setattr__(
            self, "graph",
            resolve_graph(self.graph, scale=self.graph_scale,
                          seed=self.graph_seed))
        object.__setattr__(
            self, "config",
            resolve_partitioned_config(self.config, self.graph))
        # fail-fast axis validation (each resolver raises a typed
        # UnknownPresetError naming the axis + nearest preset); only the
        # updates stream is kept resolved
        spec = get_accelerator(self.accelerator)
        if self.variant is not None and self.variant not in spec.variants():
            spec.apply_variant(spec.make_config(None), self.variant)
        resolve_memory(self.memory)
        resolve_cache(self.cache, spec)
        object.__setattr__(self, "updates", resolve_updates(self.updates))


def case_chaos_key(case: "SweepCase") -> str:
    """Stable identity of one grid point, used for deterministic fault
    injection and supervisor crash attribution: everything that *names*
    the case, nothing that depends on object identity or scheduling.
    Equal to the JAX package's string for the same case."""
    return "|".join((case.graph.fingerprint, case.problem.value,
                     case.accelerator, memory_name(case.memory),
                     cache_name(case.cache), case.variant or "baseline",
                     str(case.root), str(case.fixed_iters),
                     updates_name(case.updates)))


class SweepInterrupted(RuntimeError):
    """A sweep stopped cooperatively at a case boundary.  ``rows`` is the
    input-aligned row list at the moment of interruption: completed cases
    carry their :class:`SweepRow`, unserved ones ``None``."""

    def __init__(self, reason: str, rows: Sequence[Optional["SweepRow"]]):
        self.reason = reason
        self.rows = list(rows)
        done = sum(r is not None for r in self.rows)
        super().__init__(f"sweep interrupted ({reason}) after "
                         f"{done}/{len(self.rows)} cases")


class SweepError(RuntimeError):
    """A sweep case failed; carries *which* case, so a failure raised on a
    worker thread stays attributable."""

    def __init__(self, index: int, case: SweepCase, cause: BaseException):
        self.index = index
        self.case = case
        super().__init__(
            f"sweep case #{index} (graph={case.graph.name!r}, "
            f"problem={case.problem.value}, "
            f"accelerator={case.accelerator!r}, "
            f"memory={memory_name(case.memory)}, "
            f"cache={cache_name(case.cache)}, "
            f"variant={case.variant or 'baseline'}) failed: {cause!r}")


@dataclasses.dataclass
class SweepRow:
    """One simulated grid point.  A dynamic case stays 1:1 with its grid
    point: ``report`` aggregates the whole update timeline and ``epochs``
    carries the per-epoch :class:`~repro_torch.sim.dynamic.EpochReport`
    rows (``None`` for static cases).  A static case served by the sweep
    records in ``report.stage_seconds`` its ``prepare`` seconds (the
    ``sweep.prepare`` span on a worker: algorithm run, model, trace and
    pack, or cache hits) and its ``serve`` seconds: on the per-case path
    the host's wall time from the serve's enqueue to the report, the
    finalize's wait on the card included; in a batched serve the group
    serve's device seconds (CUDA events around ``fused_scan_batch``,
    the host clock on the CPU) over its cases.  ``run_case`` keeps the
    session's stages."""

    case: SweepCase
    report: SimReport
    wall_s: float
    epochs: Optional[List] = None

    @property
    def graph_name(self) -> str:
        return self.case.graph.name

    @property
    def memory(self) -> str:
        return memory_name(self.case.memory)

    @property
    def cache(self) -> str:
        return cache_name(self.case.cache)

    @property
    def variant(self) -> str:
        return self.case.variant or "baseline"

    @property
    def updates(self) -> str:
        return updates_name(self.case.updates)

    def as_dict(self) -> Dict[str, Any]:
        r = self.report
        out = {
            "graph": self.graph_name, "problem": self.case.problem.value,
            "accelerator": r.system, "memory": self.memory,
            "cache": self.cache, "variant": self.variant,
            "updates": self.updates,
            "runtime_ms": r.runtime_ms,
            "iterations": r.iterations, "reps": r.reps,
            "row_hit_rate": r.row_hit_rate,
            "cache_hit_rate": r.cache_hit_rate,
            "total_requests": r.total_requests, "wall_s": self.wall_s,
        }
        if self.epochs is not None:
            out["epochs"] = len(self.epochs)
            out["edges_inserted"] = sum(e.inserted for e in self.epochs)
            out["edges_deleted"] = sum(e.deleted for e in self.epochs)
            out["cache_lines_invalidated"] = sum(
                e.cache_lines_invalidated for e in self.epochs)
            out["reset_vertices"] = sum(e.reset_vertices
                                        for e in self.epochs)
        return out


@dataclasses.dataclass
class SweepStats:
    cases: int = 0
    algo_runs: int = 0
    algo_cache_hits: int = 0
    pack_cache_hits: int = 0
    pack_cache_misses: int = 0
    batched_cases: int = 0
    batch_dispatches: int = 0
    sharded_dispatches: int = 0
    workers: int = 1
    devices: int = 1


class Sweeper:
    """Executes sweep cases with per-graph algorithm/model/pack caching, on
    ``device`` (default the card; raises when CUDA is absent).

    ``workers=N`` shards case *preparation* (algorithm run, trace build,
    pack) over N threads; the serving loop serves the prepared cases in
    deterministic case order, so results are identical for any worker
    count.  With ``batch_memories=True``, cases whose packed programs share
    a shape (same steps x channels x lanes x banks x ranks: e.g. one
    accelerator and graph across timing variants) are served by ONE
    batched serve; the remaining cases take the per-case path.
    ``devices=N`` additionally shards each batched serve of more than one
    case over a 1-D case mesh (:func:`repro_torch.launch.mesh.
    make_sweep_mesh`, built at the first such serve): each device serves
    its slice of the batch with the same per-case math, so rows stay
    bit-identical for any (workers, devices).  A host with fewer devices
    still runs per-case, dynamic and one-case groups; only a sharded serve
    raises."""

    def __init__(self, backend: Optional[str] = None,
                 batch_memories: bool = False, workers: int = 1,
                 devices: int = 1, device=None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.device = resolve_device(device)
        self.backend = backend
        self.batch_memories = batch_memories
        self.workers = workers
        self.devices = devices
        self._mesh = None  # built at the first sharded serve
        self._sessions_lock = locks.make_lock("sweeper-sessions")
        self._sessions: Dict[str, SimSession] = \
            locks.make_dict("Sweeper._sessions", self._sessions_lock)
        self.stats = SweepStats(workers=workers, devices=devices)

    def _sweep_mesh(self):
        """The 1-D case mesh for ``devices > 1``, built once, at the first
        sharded serve, so that a sweeper on a host with fewer devices runs
        everything that is not sharded."""
        if self._mesh is None:
            from repro_torch.launch.mesh import make_sweep_mesh
            self._mesh = make_sweep_mesh(self.devices, self.device)
        return self._mesh

    def _group_mesh(self, items):
        """The case mesh a signature group is served over, counted in
        ``stats.sharded_dispatches``, or None when the group is not sharded
        (``devices == 1`` or one case).  Called on the serving thread
        before any group of a batch is served."""
        if self.devices == 1 or len(items) == 1:
            return None
        mesh = self._sweep_mesh()
        self.stats.sharded_dispatches += 1
        return mesh

    def _session(self, g: Graph) -> SimSession:
        # worker threads race here via _prepare_case; two sessions for one
        # graph would fork the single-flight caches.  Keyed by content
        # fingerprint (not id()), so equal graphs built apart share
        # algorithm runs, models and packed programs.
        key = g.fingerprint
        with self._sessions_lock:
            sess = self._sessions.get(key)
            if sess is None:
                sess = self._sessions[key] = SimSession(g)
            return sess

    def _sync_stats(self) -> None:
        """Mirror the sessions' cache counters onto the stats surface.
        Called once a :meth:`run`, in a ``finally`` (interrupted sweeps
        surface their partial counters too), not once a case."""
        with self._sessions_lock:
            sessions = list(self._sessions.values())
        s = self.stats
        s.workers = self.workers
        s.devices = self.devices
        s.algo_runs = sum(x.algo_runs for x in sessions)
        s.algo_cache_hits = sum(x.algo_cache_hits for x in sessions)
        s.pack_cache_hits = sum(x.pack_cache_hits for x in sessions)
        s.pack_cache_misses = sum(x.pack_cache_misses for x in sessions)

    def run_case(self, case: SweepCase,
                 backend: Optional[str] = None) -> SweepRow:
        """One case through ``SimSession.run`` (one serve a case), or
        ``run_dynamic`` for a dynamic case, on this sweeper's sessions;
        the stats sync is left to the caller."""
        chaos.maybe_inject("dram.serve", case_chaos_key(case))
        sess = self._session(case.graph)
        backend = self.backend if backend is None else backend
        t0 = time.perf_counter()
        if case.updates is not None:
            # dynamic case: one long-lived memory timeline over the update
            # epochs; a pure function of the case (the stream is seeded,
            # the session only serves the static prefix), so rows stay
            # identical for any worker count
            from repro_torch.sim.dynamic import run_dynamic
            result = run_dynamic(
                case.graph, case.problem, updates=case.updates,
                accelerator=case.accelerator, config=case.config,
                memory=case.memory, cache=case.cache, backend=backend,
                variant=case.variant, root=case.root,
                fixed_iters=case.fixed_iters, session=sess,
                device=self.device)
            self.stats.cases += 1
            return SweepRow(case=case, report=result.report,
                            wall_s=time.perf_counter() - t0,
                            epochs=result.epochs)
        report = sess.run(
            case.problem, case.accelerator, config=case.config,
            memory=case.memory, cache=case.cache, backend=backend,
            variant=case.variant, root=case.root,
            fixed_iters=case.fixed_iters, device=self.device)
        wall = time.perf_counter() - t0
        self.stats.cases += 1
        return SweepRow(case=case, report=report, wall_s=wall)

    @staticmethod
    def _guard(index: int, case: SweepCase, fn):
        """Run one case-scoped step; failures re-raise as
        :class:`SweepError` naming the case, so errors raised on worker
        threads stay attributable when they surface at drain time."""
        try:
            return fn()
        except SweepError:
            raise
        except Exception as e:
            raise SweepError(index, case, e) from e

    @staticmethod
    def _check_control(control, rows) -> None:
        """Cooperative cancellation checkpoint: ``control`` (a callable
        returning ``None`` to continue or a reason string to stop) is
        polled at every case boundary; tripping raises
        :class:`SweepInterrupted` carrying the rows completed so far."""
        if control is None:
            return
        reason = control()
        if reason:
            raise SweepInterrupted(reason, rows)

    def run(self, cases: Sequence[SweepCase], *, control=None,
            backend: Optional[str] = None) -> List[SweepRow]:
        """Run all cases; rows come back in input order.  ``control`` is
        an optional cancellation probe checked between cases; ``backend``
        overrides the sweeper's backend for this run only."""
        cases = list(cases)
        backend = self.backend if backend is None else backend
        try:
            if backend in (None, "vectorized"):
                with spans.span("sweep.run") as run:
                    if self.batch_memories:
                        rows = self._run_batched(cases, control, run)
                    else:
                        rows = self._run_pipelined(cases, control, run)
            else:
                # the event backend and the reference machine: one case
                # at a time, grouped by (accelerator, graph)
                order = sorted(
                    range(len(cases)),
                    key=lambda i: (cases[i].accelerator,
                                   cases[i].graph.fingerprint))
                rows = [None] * len(cases)
                for i in order:
                    self._check_control(control, rows)
                    rows[i] = self._guard(
                        i, cases[i],
                        lambda: self.run_case(cases[i], backend=backend))
        finally:
            self._sync_stats()
        return rows

    def _prepare_timed(self, i: int, case: SweepCase, run):
        """``(prepared, seconds)`` of :meth:`_prepare_case` on a worker,
        under a ``sweep.prepare`` span that is a child of ``run``."""
        with spans.adopt(run), spans.span("sweep.prepare", timed=True) as s:
            out = self._guard(i, case, lambda: self._prepare_case(case))
        return out, s.seconds

    def _prepare_case(self, case: SweepCase):
        """Build ``(model, run, packed, cache_stats, dram)`` for a
        batchable case, or ``None`` for a case that is served through
        :meth:`run_case` (a dynamic case, or an accelerator with no
        program form such as the reference machine).  Thread-safe: every
        expensive product goes through the session's single-flight
        caches, the packed program through the geometry-keyed pack cache.

        On the card the workers launch work (the algorithm engine, the
        device pack) while other threads serve, so a row's ``prepare``
        and ``serve`` seconds may include other threads' work.  Those
        timings are not sweep fields."""
        if case.updates is not None:
            # dynamic cases go through run_case on the serving thread in
            # every mode: their epochs share one mutating memory timeline
            return None
        key = case_chaos_key(case)
        chaos.maybe_inject("worker.crash", key)
        chaos.maybe_inject("sweep.prepare", key)
        sess = self._session(case.graph)
        spec = get_accelerator(case.accelerator)
        cfg = spec.make_config(case.config,
                               memory=resolve_memory(case.memory))
        cfg = spec.apply_variant(cfg, case.variant)
        cache_cfg = resolve_cache(case.cache, spec)
        if cache_cfg is not None:
            # after variants, so dram-overriding variants keep the cache
            cfg = spec.make_config(cfg, cache=cache_cfg)
        model = sess.model_for(spec, cfg)
        if not hasattr(model, "build_program"):
            return None
        run = sess.algorithm_run(spec, case.problem, cfg, case.root,
                                 case.fixed_iters, self.device)
        dram = (cfg.dram_config() if hasattr(cfg, "dram_config")
                else model.dram)
        packed, cstats = sess.packed_program_for(
            spec, case.problem, cfg, model, run, dram, root=case.root,
            fixed_iters=case.fixed_iters, device=self.device)
        return model, run, packed, cstats, dram

    def _run_pipelined(self, cases: Sequence[SweepCase],
                       control=None, run=None) -> List[SweepRow]:
        """Sharded per-case execution: ``workers`` threads prepare cases
        while this thread serves them in deterministic case order."""
        order = sorted(
            range(len(cases)),
            key=lambda i: (cases[i].accelerator, cases[i].graph.fingerprint))
        rows: List[Optional[SweepRow]] = [None] * len(cases)
        pending = deque()
        it = iter(order)

        def submit_next():
            i = next(it, None)
            if i is not None:
                pending.append((i, pool.submit(self._prepare_timed, i,
                                               cases[i], run)))

        with spans.span("sweep.pool"):
            pool = ThreadPoolExecutor(max_workers=self.workers)
            # bound the in-flight window so prepared programs don't pile
            # up in memory ahead of the serving loop
            for _ in range(self.workers + 2):
                submit_next()
        try:
            while pending:
                self._check_control(control, rows)
                i, fut = pending.popleft()
                with spans.span("sweep.pool"):
                    prepped, prep_s = fut.result()
                submit_next()
                case = cases[i]
                if prepped is None:
                    rows[i] = self._guard(
                        i, case, lambda: self.run_case(case))
                    continue
                self.stats.cases += 1
                model, run_, packed, cstats, dram = prepped
                t0 = time.perf_counter()

                def _serve():
                    chaos.maybe_inject("dram.serve", case_chaos_key(case))
                    if packed is None:
                        return ProgramStats([], 0, 0, 0, 0)
                    with spans.span("sweep.serve"):
                        fin, _ = serve_finishes(
                            packed, timing=vec.timing_params(dram.timing),
                            device=self.device)
                    with spans.span("sweep.finalize"):
                        return finalize_any(packed, fin)
                stats = self._guard(i, case, _serve)
                stats.attach_cache(cstats)
                with spans.span("sweep.report"):
                    report = model.make_report(case.problem, run_, stats)
                serve_s = time.perf_counter() - t0
                report.stage_seconds = {"prepare": prep_s, "serve": serve_s}
                rows[i] = SweepRow(case, report, prep_s + serve_s)
        except BaseException:
            # stop at this case boundary: drop queued preps (running ones
            # finish under the join below) and let the interruption or
            # error propagate with the rows so far
            pool.shutdown(wait=False, cancel_futures=True)
            raise
        finally:
            with spans.span("sweep.pool"):
                pool.shutdown()
        return rows

    def _serve_group(self, items, rows, mesh=None) -> None:
        """One batched serve for a signature group: one shared pack (by
        identity) is served against the whole timing batch, never
        replicated; distinct packs are stacked (device or host packs, as
        each memory's decode allows).  With a ``mesh`` the batch is
        sharded over it, the shared pack copied once a device.  The serve
        is timed on the card's stream and read after the first finalize's
        copy, so the timing adds no wait."""
        with spans.span("sweep.serve"):
            packs = [it[4] for it in items]
            timings = np.stack([vec.timing_params(it[6].timing)
                                for it in items])
            first = packs[0]
            shared = len({id(p) for p in packs}) == 1
            if shared:
                streams = (first.issue, first.meta, first.boundary)
            else:
                streams = tuple(
                    torch.stack([vec.as_int32(getattr(p, f), self.device)
                                 for p in packs])
                    for f in ("issue", "meta", "boundary"))
            geometry = (first.n_banks, first.banks_per_rank)
            timer = vec.StreamTimer(self.device)
            if mesh is None:
                fins, _ = vec.fused_scan_batch(*streams, timings, *geometry,
                                               self.device)
            else:
                from repro_torch.distributed.sharding import (
                    sharded_fused_scan_batch, sharded_fused_scan_batch_shared)
                serve = (sharded_fused_scan_batch_shared if shared
                         else sharded_fused_scan_batch)
                fins, _ = serve(*streams, timings, *geometry, mesh,
                                self.device)
            timer.stop()
        share = None
        for m, (i, case, model, run_, packed, cstats, _dram,
                wall) in enumerate(items):
            with spans.span("sweep.finalize"):
                stats = finalize_any(packed, fins[m])
            if share is None:
                share = timer.seconds() / len(items)
            stats.attach_cache(cstats)
            with spans.span("sweep.report"):
                report = model.make_report(case.problem, run_, stats)
            report.stage_seconds = {"prepare": wall, "serve": share}
            rows[i] = SweepRow(case, report, wall + share)

    def _run_batched(self, cases: Sequence[SweepCase],
                     control=None, run=None) -> List[SweepRow]:
        rows: List[Optional[SweepRow]] = [None] * len(cases)
        self._check_control(control, rows)
        with spans.span("sweep.pool"), \
                ThreadPoolExecutor(max_workers=self.workers) as pool:
            preps = list(pool.map(
                lambda i: self._prepare_timed(i, cases[i], run),
                range(len(cases))))
        groups = defaultdict(list)
        for i, (prepped, prep_s) in enumerate(preps):
            if prepped is None:
                rows[i] = self._guard(i, cases[i],
                                      lambda: self.run_case(cases[i]))
                continue
            self.stats.cases += 1
            model, run_, packed, cstats, dram = prepped
            sig = packed.signature if packed is not None else None
            groups[sig].append((i, cases[i], model, run_, packed, cstats,
                                dram, prep_s))
        for i, case, model, run_, _p, cstats, _d, wall in groups.pop(None,
                                                                     []):
            stats = ProgramStats([], 0, 0, 0, 0).attach_cache(cstats)
            with spans.span("sweep.report"):
                report = model.make_report(case.problem, run_, stats)
            rows[i] = SweepRow(case, report, wall)
        # independent signature groups serve concurrently (their serves
        # share no state; rows land at disjoint indices)
        group_items = list(groups.values())
        self.stats.batch_dispatches += len(group_items)
        self.stats.batched_cases += sum(len(g) for g in group_items)
        if self.workers > 1 and len(group_items) > 1:
            self._check_control(control, rows)
            meshes = [self._group_mesh(items) for items in group_items]

            def serve(items, mesh):
                with spans.adopt(run):
                    self._serve_group(items, rows, mesh)
            with spans.span("sweep.pool"), \
                    ThreadPoolExecutor(max_workers=self.workers) as pool:
                list(pool.map(serve, group_items, meshes))
        else:
            for items in group_items:
                self._check_control(control, rows)
                self._serve_group(items, rows, self._group_mesh(items))
        return rows

def sweep(graphs: Iterable[GraphLike] = (), problems: Iterable = (),
          accelerators: Iterable[str] = ("hitgraph", "accugraph"),
          memories: Iterable[MemoryLike] = (None,),
          caches: Iterable[CacheLike] = (None,),
          variants: Iterable[Optional[str]] = (None,),
          updates: Iterable[UpdatesLike] = (None,),
          configs: Optional[Dict[str, Any]] = None,
          root: int = 0, fixed_iters: Optional[int] = None,
          backend: Optional[str] = None,
          cases: Optional[Sequence] = None,
          batch_memories: bool = False, workers: int = 1,
          devices: int = 1,
          graph_scale: float = 1.0, graph_seed: int = 0,
          sweeper: Optional[Sweeper] = None, device=None) -> List[SweepRow]:
    """Run a simulation grid on ``device`` (default the card; raises when
    CUDA is absent); returns one row per grid point.

    Either pass the axes (``graphs x problems x accelerators x memories
    x caches x variants x updates``, expanded as an outer product in that
    order) or an explicit ``cases`` list — of :class:`SweepCase` and/or
    :class:`~repro_torch.sim.scenario.ScenarioSpec` values — for
    irregular grids; a single ``ScenarioSpec`` as the first positional
    argument runs a one-case sweep.  ``graphs`` entries are
    :class:`Graph` instances or corpus preset names (``"karate"``,
    ``"powerlaw-social:degree"``, ... — see
    :data:`~repro_torch.graphs.corpus.GRAPH_PRESETS`), resolved through
    the content-addressed corpus cache at ``graph_scale`` /
    ``graph_seed``.
    ``configs`` maps accelerator name -> config dataclass for the grid
    form.  ``caches`` sweeps the on-chip hierarchy axis (``None`` /
    preset names / ``"default"`` / ``CacheConfig``; see
    :func:`~repro_torch.sim.memory.cache_variants`).  ``updates`` sweeps
    the dynamic-graph mutation axis (``None`` = static, or
    ``UPDATE_PRESETS`` names / ``UpdateStream`` values; one aggregate row
    per dynamic case, per-epoch reports on ``row.epochs``).
    ``workers=N`` shards case preparation over N threads (results
    identical for any N; a failing case raises :class:`SweepError` naming
    it).  ``batch_memories=True`` serves cases whose packed programs
    share a shape (typically the memory axis of one accelerator and graph)
    in one batched serve.  Pass a :class:`Sweeper` to share its caches
    and stats across calls or to read ``sweeper.stats`` afterwards (it
    then decides the device).  ``devices=N`` shards each batched serve's
    cases over N devices (see :class:`Sweeper`)."""
    if cases is None and isinstance(graphs, ScenarioSpec):
        cases = [graphs]
    if cases is None:
        configs = configs or {}
        cases = [
            SweepCase(graph=g, problem=p, accelerator=a, memory=m,
                      cache=c, variant=v, config=configs.get(a),
                      root=root, fixed_iters=fixed_iters,
                      graph_scale=graph_scale, graph_seed=graph_seed,
                      updates=u)
            for g, p, a, m, c, v, u in itertools.product(
                graphs, problems, accelerators, memories, caches,
                variants, updates)
        ]
    else:
        cases = [c.to_case() if isinstance(c, ScenarioSpec) else c
                 for c in cases]
    if sweeper is None:
        sweeper = Sweeper(backend=backend, batch_memories=batch_memories,
                          workers=workers, devices=devices, device=device)
    else:
        if batch_memories and not sweeper.batch_memories:
            raise ValueError(
                "batch_memories=True conflicts with the provided sweeper "
                "(construct it with Sweeper(batch_memories=True))")
        if workers != 1 and workers != sweeper.workers:
            raise ValueError(
                "workers= conflicts with the provided sweeper "
                f"(it was constructed with workers={sweeper.workers})")
        if devices != 1 and devices != sweeper.devices:
            raise ValueError(
                "devices= conflicts with the provided sweeper "
                f"(it was constructed with devices={sweeper.devices})")
    return sweeper.run(cases)
